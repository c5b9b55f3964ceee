"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips, with its reason, on a host
without an NVIDIA GPU. The file imports neither JAX nor the reference, so
it runs on a GPU host that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: one SpMM layer ``rtol=1e-5, atol=1e-6`` (f32, the summation
order differs); an f32 stack ``rtol=1e-4, atol=1e-6`` plus exact
categories; bf16 panels within 4 bf16 ulps of the output's scale.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.dnn import stack_bsr
from repro_torch.data import radixnet as rx
from repro_torch.kernels import build, ops
from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain
from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
from repro_torch.kernels.fused_mlp import fused_mlp_plain
from repro_torch.serve import run_challenge
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix

pytestmark = pytest.mark.cuda

SPMM_TOL = dict(rtol=1e-5, atol=1e-6)
STACK_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on this host")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weight(rng, m, k, bs, device):
    """ELL weight with pad slots and one empty block-row."""
    d = rng.uniform(-1.0, 3.0, (m, k)).astype(np.float32)
    keep = rng.random((m // bs, k // bs)) < 0.5
    keep[0, :2] = True
    keep[1] = False
    d *= np.kron(keep, np.ones((bs, bs), np.float32))
    return BlockSparseMatrix.from_dense(d, (bs, bs), pad_to=k // bs, device=device)


@pytest.mark.parametrize("bs", [8, 16])
def test_spmm_kernels_match_plain(cuda, bs):
    rng = np.random.default_rng(bs)
    a = _weight(rng, 8 * bs, 6 * bs, bs, cuda)
    c = BlockCSRMatrix.from_bsr(a, pad_to=a.nnz_blocks() + 2)  # tail slots
    y = torch.from_numpy(rng.random((6 * bs, 37), dtype=np.float32)).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(8 * bs).astype(np.float32)).to(cuda)
    ops.reset_launch_counts()
    for kern, plain, w in ((ops.bsr_spmm, bsr_spmm_plain, a), (ops.bcsr_spmm, bcsr_spmm_plain, c)):
        for fuse in (True, False):
            got = kern(w, y, bias, fuse_bias_relu=fuse)
            want = plain(w, y, bias, fuse_bias_relu=fuse)
            torch.testing.assert_close(got, want, **SPMM_TOL)
    counts = ops.launch_counts()
    assert counts["bsr_spmm"] == 2 and counts["bcsr_spmm"] == 2


@pytest.mark.parametrize("panel_dtype", [None, "bfloat16"])
def test_fused_kernels_match_plain(cuda, panel_dtype):
    spec = rx.RadixNetSpec(256, 7)
    w, b = rx.radixnet_weights(spec, device=cuda)
    sw, sb = stack_bsr(w), torch.stack(b)
    y0 = torch.from_numpy(rx.radixnet_input_panel(256, 40, density=0.3, seed=11)).to(cuda)
    want = fused_mlp_plain(sw, sb, y0, panel_dtype=panel_dtype)
    for fn in (ops.fused_mlp_forward, ops.fused_mlp_tiled_forward):
        got = fn(sw, sb, y0, panel_dtype=panel_dtype)
        if panel_dtype is None:
            torch.testing.assert_close(got, want, **STACK_TOL)
        else:
            assert float((got - want).abs().max()) <= 4 * 2.0 ** -8 * float(want.abs().max())
        assert np.array_equal(rx.reference_categories(got.cpu().numpy()),
                              rx.reference_categories(want.cpu().numpy()))


def test_nan_columns_stay_nan_through_the_kernels(cuda):
    """The epilogue keeps NaN (like jnp.maximum), which the engine's
    per-column quarantine relies on."""
    w, b = rx.radixnet_weights(rx.RadixNetSpec(64, 3), device=cuda)
    y0 = torch.ones(64, 8, device=cuda)
    y0[5, 3] = float("nan")
    out = ops.fused_mlp_forward(stack_bsr(w), torch.stack(b), y0)
    col_ok = torch.isfinite(out).all(dim=0).tolist()
    assert col_ok == [True, True, True, False, True, True, True, True]


def test_oversized_resident_panel_is_refused(cuda):
    w, b = rx.radixnet_weights(rx.RadixNetSpec(4096, 1), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_mlp_forward(stack_bsr(w), torch.stack(b), torch.ones(4096, 16, device=cuda))


def test_challenge_routes_match_on_the_card(cuda):
    spec = rx.RadixNetSpec(256, 6)
    _, ref = rx.radixnet_reference(spec, rx.radixnet_input_panel(256, 50, density=0.3, seed=5))
    for resident, route, kernels in ((None, "fused", ("fused_mlp_forward",)),
                                     (False, "layered", ("bsr_spmm", "bcsr_spmm"))):
        ops.reset_launch_counts()
        res = run_challenge(spec, n_inputs=50, panel_width=24, batch_align=8, seed=5,
                            use_resident=resident, device=cuda)
        assert res.routes == (route,)
        assert np.array_equal(res.categories, ref)
        assert all(ops.launch_counts()[k] > 0 for k in kernels)
    assert all(build.library_path(n).exists() for n in build.SOURCES)
