"""The port's kernel wrappers against the JAX package's Pallas kernels.

On this CPU-only host the port's wrappers run their plain PyTorch
versions and the reference's run their Pallas kernels in interpret mode
(exactly as the JAX tests run them); both see the same numpy inputs.
Tolerances: one SpMM layer ``rtol=1e-5, atol=1e-6`` (f32, summation
order differs); a fused stack ``rtol=1e-4, atol=1e-6`` on activations
plus exact category equality (the contract of tests/test_challenge.py).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dnn as jdnn
from repro.data import radixnet as jrx
from repro.kernels import ops as jops
from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro.sparse.bsr import BlockSparseMatrix as JBSR
from repro_torch import convert
from repro_torch.data import radixnet as rx
from repro_torch.kernels import ops

SPMM_TOL = dict(rtol=1e-5, atol=1e-6)
STACK_TOL = dict(rtol=1e-4, atol=1e-6)


def _weight(rng, m, k, bs):
    """ELL weight with pad slots (pad_to past the widest row) and one
    empty block-row, as reference and port layouts of the same arrays."""
    d = rng.uniform(-1.0, 3.0, (m, k)).astype(np.float32)
    keep = rng.random((m // bs, k // bs)) < 0.5
    keep[0, :2] = True
    keep[1] = False  # empty block-row
    d *= np.kron(keep, np.ones((bs, bs), np.float32))
    ref = JBSR.from_dense(d, (bs, bs), pad_to=k // bs)
    assert not np.asarray(ref.block_mask).all()  # ELL pad slots present
    return ref, convert.layout(ref)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("bs", [8, 16])
def test_bsr_spmm_matches_reference(bs, fuse):
    rng = np.random.default_rng(bs + fuse)
    ref_a, a = _weight(rng, 4 * bs, 5 * bs, bs)
    y = rng.random((5 * bs, 21), dtype=np.float32)  # ragged n, ReLU-range inputs
    bias = rng.standard_normal(4 * bs).astype(np.float32)
    want = np.asarray(jops.bsr_spmm(ref_a, jnp.asarray(y), jnp.asarray(bias),
                                    fuse_bias_relu=fuse))
    got = ops.bsr_spmm(a, torch.from_numpy(y), torch.from_numpy(bias), fuse_bias_relu=fuse)
    assert got.shape == (4 * bs, 21)
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("bs", [8, 16])
def test_bcsr_spmm_matches_reference_with_empty_row_and_tail(bs, fuse):
    rng = np.random.default_rng(20 + bs + fuse)
    ref_bsr, _ = _weight(rng, 4 * bs, 5 * bs, bs)
    nnz = int(np.asarray(ref_bsr.block_mask).sum())
    ref_a = JBCSR.from_bsr(ref_bsr, pad_to=nnz + 2)  # invalid tail slots
    a = convert.layout(ref_a)
    y = rng.random((5 * bs, 13), dtype=np.float32)  # ragged n, ReLU-range inputs
    bias = rng.standard_normal(4 * bs).astype(np.float32)
    want = np.asarray(jops.bcsr_spmm(ref_a, jnp.asarray(y), jnp.asarray(bias),
                                     fuse_bias_relu=fuse))
    got = ops.bcsr_spmm(a, torch.from_numpy(y), torch.from_numpy(bias), fuse_bias_relu=fuse)
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)
    # the empty block-row is the epilogue of the semiring zero
    fill = np.maximum(bias[bs:2 * bs], 0) if fuse else np.zeros(bs, np.float32)
    np.testing.assert_array_equal(got.numpy()[bs:2 * bs], np.repeat(fill[:, None], 13, 1))


def test_spmm_wrappers_reject_other_semirings_and_missing_bias():
    rng = np.random.default_rng(0)
    _, a = _weight(rng, 16, 16, 8)
    y = torch.zeros(16, 4)
    with pytest.raises(NotImplementedError, match="GraphBLAS slice"):
        ops.bsr_spmm(a, y, semiring_name="min_plus")
    with pytest.raises(ValueError, match="requires bias"):
        ops.bsr_spmm(a, y, fuse_bias_relu=True)


def _stacks(neurons, layers):
    spec = jrx.RadixNetSpec(neurons, layers)
    jw, jb = jrx.radixnet_weights(spec)
    sw = convert.layout(jdnn.stack_bsr(jw))
    sb = convert.bias(np.stack([np.asarray(b) for b in jb]))
    y0 = jrx.radixnet_input_panel(neurons, 24, density=0.3, seed=11)
    return spec, jw, jb, sw, sb, y0


@pytest.mark.parametrize("neurons,layers", [(64, 4), (256, 7)], ids=["64x4", "256x7"])
@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
def test_fused_pair_matches_reference(neurons, layers, tiled):
    spec, jw, jb, sw, sb, y0 = _stacks(neurons, layers)
    jfn = jops.fused_mlp_tiled_forward if tiled else jops.fused_mlp_forward
    fn = ops.fused_mlp_tiled_forward if tiled else ops.fused_mlp_forward
    want = np.asarray(jfn(jdnn.stack_bsr(jw), jnp.stack(jb), jnp.asarray(y0)))
    got = fn(sw, sb, torch.from_numpy(y0)).numpy()
    np.testing.assert_allclose(got, want, **STACK_TOL)
    cats = rx.reference_categories(got)
    assert np.array_equal(cats, jrx.reference_categories(want))
    assert np.array_equal(cats, rx.radixnet_reference(spec, y0)[1])


def test_fused_bf16_panels_match_reference():
    """bf16 panels: both round the f32 layer output to bf16 the same way;
    compared in bf16 terms (one bf16 ulp of the output's scale)."""
    _, jw, jb, sw, sb, y0 = _stacks(64, 4)
    want = np.asarray(jops.fused_mlp_forward(
        jdnn.stack_bsr(jw), jnp.stack(jb), jnp.asarray(y0), panel_dtype=jnp.bfloat16))
    got = ops.fused_mlp_forward(sw, sb, torch.from_numpy(y0), panel_dtype="bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -8 * np.abs(want).max())
    tiled = ops.fused_mlp_tiled_forward(sw, sb, torch.from_numpy(y0), panel_dtype="bfloat16")
    assert torch.equal(tiled, got)  # one plain version serves both kernels


@pytest.mark.parametrize("fn", [ops.fused_mlp_forward, ops.fused_mlp_tiled_forward])
def test_fused_wrappers_refuse_autograd(fn):
    *_, sw, sb, y0 = _stacks(64, 2)
    y = torch.from_numpy(y0).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        fn(sw, sb, y)
    with torch.no_grad():  # inference under no_grad is fine
        assert fn(sw, sb, y).shape == y.shape


def test_launch_counters_ignore_cpu_calls():
    *_, sw, sb, y0 = _stacks(64, 2)
    ops.reset_launch_counts()
    ops.fused_mlp_forward(sw, sb, torch.from_numpy(y0))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cuda_launchers_validate_inputs_before_building():
    """The launchers refuse what the kernels do not take — before any
    library is built or loaded, so this runs without a GPU."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    from repro_torch.kernels.fused_mlp import fused_mlp_cuda

    rng = np.random.default_rng(1)
    _, a = _weight(rng, 32, 32, 16)
    y = torch.ones(32, 32)
    bias = torch.zeros(32)
    with pytest.raises(ValueError, match="contiguous"):
        bsr_spmm_cuda(a, y[:, ::2], bias, fuse_bias_relu=True, block_n=16)
    with pytest.raises(ValueError, match="f32"):
        bsr_spmm_cuda(a, y.double(), bias, fuse_bias_relu=True, block_n=16)
    with pytest.raises(ValueError, match="n % 16"):
        bsr_spmm_cuda(a, y[:, :24].contiguous(), bias, fuse_bias_relu=True, block_n=16)
    *_, sw, sb, y0 = _stacks(64, 2)
    with pytest.raises(ValueError, match=r"y0 \(64, n\)"):
        fused_mlp_cuda(sw, sb, torch.ones(128, 16), tiled=True, block_n=16)
