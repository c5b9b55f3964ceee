"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips, with its reason, on a host
without an NVIDIA GPU. The file imports neither JAX nor the reference, so
it runs on a GPU host that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: one SpMM layer ``rtol=1e-5, atol=1e-6`` (f32, the summation
order differs); an f32 stack ``rtol=1e-4, atol=1e-6`` plus exact
categories; bf16 panels within 4 bf16 ulps of the output's scale. The
three semiring kernels see integer-valued inputs in all eight
semirings: exact, except ``log_plus`` within 1e-5 (its reductions run in
another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.dnn import stack_bsr
from repro_torch.core.semiring import REGISTRY
from repro_torch.data import radixnet as rx
from repro_torch.kernels import bcsr_spmm as kbcsr
from repro_torch.kernels import build, fused_mlp, ops
from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain
from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
from repro_torch.kernels.fused_mlp import fused_mlp_plain
from repro_torch.kernels.semiring_matmul import semiring_matmul_plain
from repro_torch.kernels.semirings import kernel_zero
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


FUSED = (ops.fused_mlp_forward, ops.fused_mlp_tiled_forward)


def _fused_close(got, want, panel_dtype):
    if panel_dtype is None:
        torch.testing.assert_close(got, want, **STACK_TOL)
    else:
        assert float((got - want).abs().max()) <= 4 * 2.0 ** -8 * float(want.abs().max())
    assert np.array_equal(rx.reference_categories(got.cpu().numpy()),
                          rx.reference_categories(want.cpu().numpy()))


@pytest.mark.parametrize("panel_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("neurons, layers, n", [
    (256, 7, 40),  # padded to 48 columns: six 8-column stripes
    (256, 7, 16),  # two stripes, fewer than the cluster's CTAs
    (64, 3, 16),  # four block-rows for clusters of up to 8 CTAs
    (1024, 4, 96),  # masked slots: the stride-1 phase stores 2 of 32
])
def test_fused_kernels_match_plain(cuda, panel_dtype, neurons, layers, n):
    spec = rx.RadixNetSpec(neurons, layers)
    w, b = rx.radixnet_weights(spec, device=cuda)
    sw, sb = stack_bsr(w), torch.stack(b)
    y0 = torch.from_numpy(rx.radixnet_input_panel(neurons, n, density=0.3, seed=11)).to(cuda)
    want = fused_mlp_plain(sw, sb, y0, panel_dtype=panel_dtype)
    ops.reset_launch_counts()
    for fn in FUSED:
        _fused_close(fn(sw, sb, y0, panel_dtype=panel_dtype), want, panel_dtype)
    assert all(ops.launch_counts()[fn.__name__] == 1 for fn in FUSED)


@pytest.mark.parametrize("panel_dtype", [None, "bfloat16"])
def test_tiled_kernel_on_a_4096_stack(cuda, panel_dtype):
    """Past the shared-memory budget; 40 columns leave the last 32-column
    tile of every block-row part empty."""
    w, b = rx.radixnet_weights(rx.RadixNetSpec(4096, 6), device=cuda)
    sw, sb = stack_bsr(w), torch.stack(b)
    y0 = torch.from_numpy(rx.radixnet_input_panel(4096, 40, density=0.35, seed=3)).to(cuda)
    got = ops.fused_mlp_tiled_forward(sw, sb, y0, panel_dtype=panel_dtype)
    _fused_close(got, fused_mlp_plain(sw, sb, y0, panel_dtype=panel_dtype), panel_dtype)


@pytest.mark.parametrize("fn", FUSED, ids=lambda f: f.__name__)
def test_nan_columns_stay_nan_through_the_kernels(cuda, fn):
    """The epilogue keeps NaN (like jnp.maximum), which the engine's
    per-column quarantine relies on."""
    w, b = rx.radixnet_weights(rx.RadixNetSpec(64, 3), device=cuda)
    y0 = torch.ones(64, 8, device=cuda)
    y0[5, 3] = float("nan")
    out = fn(stack_bsr(w), torch.stack(b), y0)
    col_ok = torch.isfinite(out).all(dim=0).tolist()
    assert col_ok == [True, True, True, False, True, True, True, True]


def test_oversized_resident_panel_is_refused(cuda):
    w, b = rx.radixnet_weights(rx.RadixNetSpec(4096, 1), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_mlp_forward(stack_bsr(w), torch.stack(b), torch.ones(4096, 16, device=cuda))


@pytest.mark.parametrize("tiled", [False, True])
def test_oversized_cluster_or_grid_launch_raises(cuda, tiled):
    """The C entries refuse a cluster of 16 CTAs (past the portable 8) and
    a cooperative grid past what the card holds at once, with no
    fallback; the refusal leaves no error behind for the next launch."""
    w, b = rx.radixnet_weights(rx.RadixNetSpec(256, 2), device=cuda)
    sw, sb = stack_bsr(w), torch.stack(b)
    y0 = torch.ones(256, 16, device=cuda)
    n_layers, nrb, mbpr = sw.col_idx.shape
    geo, _ = fused_mlp.card_geometry(sw, 16, tiled=tiled, device=cuda)
    lib = build.load("fused_mlp", fused_mlp.SIGNATURES)
    p = build.pointer
    out = torch.empty_like(y0)
    head = (p(sw.blocks), p(sw.col_idx), p(sw.block_mask), p(y0), p(sb), p(out))
    shape = (n_layers, nrb, mbpr, 16, 16, 0)
    stream = build.stream_handle(y0.device)
    if tiled:
        scratch = torch.empty((2, 256, 16), device=cuda)
        err = lib.fused_mlp_tiled(*head, p(scratch), *shape, 64 * geo.ctas, stream)
    else:
        err = lib.fused_mlp_resident(*head, *shape, 16, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib, err, "fused MLP")
    torch.cuda.synchronize()
    fn = ops.fused_mlp_tiled_forward if tiled else ops.fused_mlp_forward
    _fused_close(fn(sw, sb, y0), fused_mlp_plain(sw, sb, y0), None)


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
    # the libraries these launches used were built from csrc (whatever ran first)
    assert all(build.library_path(n).exists() for n in ("fused_mlp", "bsr_spmm", "bcsr_spmm"))


def _semiring_operands(rng, device):
    """Integer-valued ELL (pad slots, empty block-row 1), its block-CSR
    form with tail slots, a dense matrix with ragged k, and a panel."""
    d = rng.integers(-3, 4, (64, 48)).astype(np.float32)
    keep = rng.random((4, 3)) < 0.6
    keep[0] = True
    keep[1] = False
    d *= np.kron(keep, np.ones((16, 16), np.float32))
    a = BlockSparseMatrix.from_dense(d, (16, 16), pad_to=3, device=device)
    c = BlockCSRMatrix.from_bsr(a, pad_to=a.nnz_blocks() + 2)
    dense = torch.from_numpy(rng.integers(-3, 4, (40, 37)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(-3, 4, (48, 37)).astype(np.float32)).to(device)
    return a, c, dense, y


def _close(name, got, want):
    if name == "log_plus":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want), float((got - want).abs().nan_to_num().max())


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_semiring_kernels_match_plain(cuda, name):
    rng = np.random.default_rng(7)
    a, c, dense, y = _semiring_operands(rng, cuda)
    ops.reset_launch_counts()
    for kern, plain, w, panel in ((ops.bsr_spmm, bsr_spmm_plain, a, y),
                                  (ops.bcsr_spmm, bcsr_spmm_plain, c, y),
                                  (ops.semiring_matmul, semiring_matmul_plain, dense, y[:37])):
        got = kern(w, panel, semiring_name=name)
        _close(name, got, plain(w, panel, semiring_name=name))
        if w is not dense:  # the empty block-row holds the semiring's init
            assert torch.all(got[16:32] == kernel_zero(name))
    assert all(ops.launch_counts()[k] == 1 for k in ("bsr_spmm", "bcsr_spmm", "semiring_matmul"))


@pytest.mark.parametrize("name", ["max_plus", "min_plus", "max_min", "min_max"])
def test_max_and_min_keep_nan_in_every_kernel(cuda, name):
    """jnp.maximum/minimum propagate NaN; CUDA's fmaxf/fminf would drop it."""
    rng = np.random.default_rng(8)
    a, c, dense, y = _semiring_operands(rng, cuda)
    y[3, 5] = float("nan")  # feeds block-column 0 (every stored row) and dense k=3
    for kern, w, panel in ((ops.bsr_spmm, a, y), (ops.bcsr_spmm, c, y),
                           (ops.semiring_matmul, dense, y[:37])):
        got = kern(w, panel, semiring_name=name)
        assert torch.isnan(got[:16, 5]).all() and not torch.isnan(got[:, :5]).any()


def test_log_plus_of_two_minus_infinities_is_minus_infinity(cuda):
    inf = float("inf")
    a = torch.full((16, 16), -inf, device=cuda)
    b = torch.full((16, 8), -inf, device=cuda)
    got = ops.semiring_matmul(a, b, semiring_name="log_plus")
    assert torch.all(got == -inf)
    w = BlockSparseMatrix.from_dense(np.ones((16, 16), np.float32), (16, 16), device=cuda)
    w.blocks.fill_(-inf)
    assert torch.all(ops.bsr_spmm(w, b, semiring_name="log_plus") == -inf)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "max_plus"])
def test_empty_bcsr_row_writes_the_epilogue_of_init(cuda, name):
    rng = np.random.default_rng(9)
    _, c, _, y = _semiring_operands(rng, cuda)
    bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(cuda)
    got = ops.bcsr_spmm(c, y, bias, semiring_name=name, fuse_bias_relu=True)
    want = torch.clamp_min(kernel_zero(name) + bias[16:32], 0)[:, None].expand(16, 37)
    assert torch.equal(got[16:32], want)
    assert torch.equal(got, bcsr_spmm_plain(c, y, bias, semiring_name=name, fuse_bias_relu=True))


RAGGED_NS = (1, 8, 37, 200, 700)  # none a multiple of the kernels' CTA tiles


def _ragged_operands(rng, bs, ints=True):
    """An 80 × 48 ELL weight at block ``bs`` (block-row 1 fully masked,
    pad slots in every other row), the same values dense, a bias, and a
    (48, 700) panel: integers in [-3, 3], or f32 drawn as
    ``test_spmm_kernels_match_plain`` draws them (weights U[-1, 3), panel
    U[0, 1), bias standard normal)."""
    def draw(*shape, panel=False):
        if ints:
            return rng.integers(-3, 4, shape).astype(np.float32)
        if panel:
            return rng.random(shape, dtype=np.float32)
        return rng.uniform(-1.0, 3.0, shape).astype(np.float32)

    d = draw(80, 48)
    keep = rng.random((80 // bs, 48 // bs)) < 0.6
    keep[:, 0] = True
    keep[1] = False
    d *= np.kron(keep, np.ones((bs, bs), np.float32))
    a = BlockSparseMatrix.from_dense(d, (bs, bs), pad_to=48 // bs + 1)
    assert not a.block_mask[1].any() and not a.block_mask.all()
    bias = draw(80) if ints else rng.standard_normal(80).astype(np.float32)
    return a, d, bias, draw(48, max(RAGGED_NS), panel=True)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_redesigned_kernels_match_plain_on_ragged_shapes(cuda, name, bs):
    """The three semiring kernels on m = 80, k = 48 and panels that fill
    no CTA tile exactly, narrow and wide, epilogue on and off: exact on
    integer operands, log_plus within 1e-5·(1+|x|). The masked block-row
    holds the epilogue of the semiring's init."""
    a, d, bias, y = _ragged_operands(np.random.default_rng(bs), bs)
    a, d, bias = a.to(cuda), torch.from_numpy(d).to(cuda), torch.from_numpy(bias).to(cuda)
    c = BlockCSRMatrix.from_bsr(a, pad_to=a.nnz_blocks() + 2)
    y = torch.from_numpy(y).to(cuda)
    for n in RAGGED_NS:
        panel = y[:, :n]
        for fuse in (False, True):
            for kern, plain, w in ((ops.semiring_matmul, semiring_matmul_plain, d),
                                   (ops.bsr_spmm, bsr_spmm_plain, a),
                                   (ops.bcsr_spmm, bcsr_spmm_plain, c)):
                got = kern(w, panel, bias, semiring_name=name, fuse_bias_relu=fuse)
                assert got.shape == (80, n)
                _close(name, got, plain(w, panel, bias, semiring_name=name,
                                        fuse_bias_relu=fuse))
            init = torch.full((bs, n), kernel_zero(name), device=cuda)
            if fuse:
                init = torch.clamp_min(init + bias[bs:2 * bs, None], 0)
            assert torch.equal(got[bs:2 * bs], init)


@pytest.mark.parametrize("bs", [8, 16])
def test_redesigned_kernels_match_plain_on_random_f32(cuda, bs):
    a, d, bias, y = _ragged_operands(np.random.default_rng(10 + bs), bs, ints=False)
    a, d, bias = a.to(cuda), torch.from_numpy(d).to(cuda), torch.from_numpy(bias).to(cuda)
    c = BlockCSRMatrix.from_bsr(a, pad_to=a.nnz_blocks() + 2)
    y = torch.from_numpy(y).to(cuda)
    ops.reset_launch_counts()
    for n in RAGGED_NS:
        for fuse in (False, True):
            for kern, plain, w in ((ops.semiring_matmul, semiring_matmul_plain, d),
                                   (ops.bsr_spmm, bsr_spmm_plain, a),
                                   (ops.bcsr_spmm, bcsr_spmm_plain, c)):
                got = kern(w, y[:, :n], bias, fuse_bias_relu=fuse)
                torch.testing.assert_close(
                    got, plain(w, y[:, :n], bias, fuse_bias_relu=fuse), **SPMM_TOL)
    counts = ops.launch_counts()
    assert counts["semiring_matmul"] == counts["bsr_spmm"] == counts["bcsr_spmm"] == (
        2 * len(RAGGED_NS))


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_ell_pad_slots_are_never_folded(cuda, name, bs):
    """Pad slots point at block-column 0 (rows 0..bs_c-1 of the panel),
    which here hold NaN while no stored block reads them: a folded pad
    would put NaN in every row of its block-row."""
    rng = np.random.default_rng(20 + bs)
    d = rng.integers(-3, 4, (80, 48)).astype(np.float32)
    keep = rng.random((80 // bs, 48 // bs)) < 0.5
    keep[:, 0] = False
    keep[0, 1:] = True
    keep[1] = False
    d *= np.kron(keep, np.ones((bs, bs), np.float32))
    a = BlockSparseMatrix.from_dense(d, (bs, bs), pad_to=48 // bs).to(cuda)
    assert int(a.col_idx[~a.block_mask].max()) == 0 and not a.block_mask.all()
    clean = torch.from_numpy(rng.integers(-3, 4, (48, 200)).astype(np.float32)).to(cuda)
    y = clean.clone()
    y[:bs] = float("nan")
    for n in (8, 200):
        got = ops.bsr_spmm(a, y[:, :n], semiring_name=name)
        assert not torch.isnan(got).any()
        # the plain version multiplies a plus_times pad's zero block by the
        # rows it gathers (0 · NaN = NaN), so it is held on the clean panel
        _close(name, got, bsr_spmm_plain(a, clean[:, :n], semiring_name=name))


def test_log_plus_fold_keeps_the_special_values(cuda):
    """The redesigned kernels fold log_plus as a running log-sum-exp; it
    keeps jnp.logaddexp's answers for -inf (the semiring zero), +inf, +inf
    meeting +inf, and NaN, on narrow and wide panels."""
    inf, nan = float("inf"), float("nan")
    rng = np.random.default_rng(30)
    a = rng.integers(-3, 4, (32, 32)).astype(np.float32)
    a[rng.random(a.shape) < 0.3] = -inf
    a[5] = -inf  # every product of row 5 is -inf
    a[6, 3] = inf
    y = rng.integers(-3, 4, (32, 70)).astype(np.float32)
    y[rng.random(y.shape) < 0.3] = -inf
    y[:, 7] = -inf
    y[3, 9] = inf  # +inf + +inf at (6, 9); -inf + +inf = NaN where a[:, 3] is -inf
    y[4, 11] = nan
    ell = BlockSparseMatrix.from_dense(a, (16, 16)).to(cuda)
    d, y = torch.from_numpy(a).to(cuda), torch.from_numpy(y).to(cuda)
    for n in (16, 70):
        for kern, plain, w in ((ops.semiring_matmul, semiring_matmul_plain, d),
                               (ops.bsr_spmm, bsr_spmm_plain, ell)):
            got = kern(w, y[:, :n], semiring_name="log_plus")
            want = plain(w, y[:, :n], semiring_name="log_plus")
            assert torch.isinf(want).any() and torch.isnan(want).any()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)


def _cut_operands(rng, device, ints=True, bs=16):
    """Block-CSR with rows the piece table cuts into 2 and 5 pieces
    (``S + 7`` and ``4·S + 9`` stored blocks, S = PIECE_SLOTS), short rows,
    an empty block-row 1 and two tail slots; values integers in [-3, 3]
    (every stored block with a nonzero) or U[-1, 3); a panel drawn alike
    (U[0, 1) for f32) and a bias."""
    s = kbcsr.PIECE_SLOTS
    lengths = [3, 0, s + 7, 1, 4 * s + 9, 17]
    ncb = max(lengths) + 3
    d = np.zeros((len(lengths) * bs, ncb * bs), np.float32)
    for i, n_blocks in enumerate(lengths):
        for col in np.sort(rng.choice(ncb, n_blocks, replace=False)):
            if ints:
                blk = rng.integers(-3, 4, (bs, bs)).astype(np.float32)
                blk[0, 0] = 1.0
            else:
                blk = rng.uniform(-1.0, 3.0, (bs, bs)).astype(np.float32)
            d[i * bs:(i + 1) * bs, col * bs:(col + 1) * bs] = blk
    c = BlockCSRMatrix.from_dense(d, (bs, bs), pad_to=sum(lengths) + 2, device=device)
    table = kbcsr.piece_table(c)
    assert sorted(count for _, count in table.cuts.tolist()) == [2, 5]
    k, m = ncb * bs, len(lengths) * bs
    if ints:
        y = rng.integers(-3, 4, (k, 256)).astype(np.float32)
        bias = rng.integers(-3, 4, m).astype(np.float32)
    else:
        y = rng.random((k, 256), dtype=np.float32)
        bias = rng.standard_normal(m).astype(np.float32)
    return c, torch.from_numpy(y).to(device), torch.from_numpy(bias).to(device)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_bcsr_cut_rows_match_plain(cuda, name):
    """Rows cut into pieces, both tiles, epilogue on and off: exact on
    integer operands (log_plus within 1e-5); the empty block-row holds
    the epilogue of init, and the tail slots are never folded."""
    c, y, bias = _cut_operands(np.random.default_rng(50), cuda)
    ops.reset_launch_counts()
    for n in (8, 37, 256):
        for fuse in (False, True):
            got = ops.bcsr_spmm(c, y[:, :n], bias, semiring_name=name, fuse_bias_relu=fuse)
            _close(name, got, bcsr_spmm_plain(c, y[:, :n], bias, semiring_name=name,
                                              fuse_bias_relu=fuse))
            init = torch.full((16, n), kernel_zero(name), device=cuda)
            if fuse:
                init = torch.clamp_min(init + bias[16:32, None], 0)
            assert torch.equal(got[16:32], init)
    assert ops.launch_counts()["bcsr_spmm"] == 6


def test_nan_passes_through_a_cut_row(cuda):
    """A zero weight inside one piece of a cut row meets an inf panel
    entry: 0 · inf = NaN in that row and column, as the plain version
    (and the reference) gives it, and the fix-up carries it out."""
    c, y, bias = _cut_operands(np.random.default_rng(51), cuda)
    table = kbcsr.piece_table(c)
    first, count = max(table.cuts.tolist(), key=lambda fc: fc[1])
    row, lo, hi, _ = table.pieces[first + 2].tolist()  # the third of five pieces
    t = (lo + hi) // 2
    values = c.values.clone()
    values[t, 5, 3] = 0.0
    c = BlockCSRMatrix(values, c.row_ptr, c.row_id, c.col_idx, c.valid, c.shape, c.block_shape)
    y = y.clone()
    y[int(c.col_idx[t]) * 16 + 3, 11] = float("inf")
    got = ops.bcsr_spmm(c, y, bias, fuse_bias_relu=True)
    want = bcsr_spmm_plain(c, y, bias, fuse_bias_relu=True)
    assert bool(torch.isnan(got[row * 16 + 5, 11]))
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(nan=0.0, posinf=float("inf"), neginf=float("-inf")),
                       want.nan_to_num(nan=0.0, posinf=float("inf"), neginf=float("-inf")))


@pytest.mark.parametrize("name", ["plus_times", "log_plus"])
def test_cut_rows_fold_the_same_way_every_call(cuda, name):
    """The fix-up folds partials in piece order, not in the order the
    pieces finish: two calls on f32 operands are bit-equal, and within
    the f32 tolerance of the plain version."""
    c, y, bias = _cut_operands(np.random.default_rng(52), cuda, ints=False)
    for n in (8, 256):
        first = ops.bcsr_spmm(c, y[:, :n], bias, semiring_name=name)
        for _ in range(3):
            assert torch.equal(ops.bcsr_spmm(c, y[:, :n], bias, semiring_name=name), first)
        torch.testing.assert_close(first, bcsr_spmm_plain(c, y[:, :n], bias, semiring_name=name),
                                   **SPMM_TOL)


def test_radixnet_layer_is_one_launch_without_workspace(cuda):
    """No RadiX-net row is cut: a layer's call is the output allocation and
    one launch, with no workspace and no zeroed counters."""
    w, b = rx.radixnet_weights(rx.RadixNetSpec(1024, 1), device=cuda)
    c = BlockCSRMatrix.from_bsr(w[0])
    assert kbcsr.piece_table(c).n_cut_rows == 0
    y = torch.rand((1024, 512), device=cuda)
    ops.bcsr_spmm(c, y, b[0], fuse_bias_relu=True)  # builds and caches the piece table
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = ops.bcsr_spmm(c, y, b[0], fuse_bias_relu=True)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1  # the output
    assert ops.launch_counts()["bcsr_spmm"] == 1
    torch.testing.assert_close(got, bcsr_spmm_plain(c, y, b[0], fuse_bias_relu=True), **SPMM_TOL)


# --- block shapes the kernels refuse, re-tiled by the wrappers -------------


def _big_block_stack(rng, device, layers=3, m=512, bs=128, bpr=2):
    """A square stack of 128 x 128 blocks (the paper's grid), ELL, and its
    block-CSR form."""
    ws = []
    for _ in range(layers):
        keep = np.zeros((m // bs, m // bs), bool)
        for i in range(m // bs):
            keep[i, rng.choice(m // bs, size=bpr, replace=False)] = True
        d = (rng.uniform(-0.1, 0.1, (m, m)) * np.kron(keep, np.ones((bs, bs)))).astype(np.float32)
        ws.append(BlockSparseMatrix.from_dense(d, (bs, bs), device=device))
    return ws


def test_a_128_block_stack_serves_through_split_blocks(cuda):
    from repro_torch.serve import SparseDNNEngine

    rng = np.random.default_rng(60)
    ws = _big_block_stack(rng, cuda)
    bs = [torch.from_numpy(rng.uniform(0, 0.1, 512).astype(np.float32)).to(cuda) for _ in ws]
    y0 = torch.rand((512, 64), device=cuda)
    ops.reset_launch_counts()
    out, stats = SparseDNNEngine(ws, bs, batch_align=64, device=cuda).infer(y0)
    assert stats["plan"]["route"] == "layered"
    counts = ops.launch_counts()
    assert counts["bsr_spmm"] + counts["bcsr_spmm"] == 3
    assert {s for v in ops.launched_block_shapes().values() for s in v} == {(64, 64)}
    want = y0
    for w, b in zip(ws, bs):
        want = bsr_spmm_plain(w, want, b, fuse_bias_relu=True)
    torch.testing.assert_close(out, want, **STACK_TOL)


def test_backward_through_a_16x128_block_csr_layer(cuda):
    """The forward launches 16 x 128 blocks as they are; dX launches the
    transpose's 128 x 16 blocks split to 64 x 16. The card's gradients
    match the plain versions', and dX rows of empty rows of Aᵀ are 0."""
    from repro_torch.core import dnn

    rng = np.random.default_rng(61)
    m, k = 256, 1024
    keep = rng.random((m // 16, k // 128)) < 0.4
    keep[:, 3] = False  # an empty block-column: 128 empty rows of Aᵀ
    keep[2] = False  # an empty block-row
    # positive values: no cancellation, so every entry holds to the f32 tolerance
    d = (rng.random((m, k)) * np.kron(keep, np.ones((16, 128)))).astype(np.float32)
    c = BlockCSRMatrix.from_bsr(BlockSparseMatrix.from_dense(d, (16, 128), device=cuda))
    c = BlockCSRMatrix.from_bsr(c.to_bsr(), pad_to=c.nnz_blocks() + 3)  # tail slots
    y = torch.rand((k, 96), device=cuda, requires_grad=True)
    bias = torch.rand(m, device=cuda)
    targets = torch.rand((m, 96), device=cuda)
    ops.reset_launch_counts()
    vals = c.values.detach().clone().requires_grad_()
    out = ops.bcsr_spmm(dataclasses.replace(c, values=vals), y, bias, c.transpose_plan(),
                        fuse_bias_relu=True)
    (0.5 * ((out - targets) ** 2).mean()).backward()
    assert ops.launch_counts()["bcsr_spmm"] == 2
    assert ops.launched_block_shapes()["bcsr_spmm"] == [(16, 128), (64, 16)]
    assert bool((y.grad[3 * 128:4 * 128] == 0).all()) and float(y.grad.abs().max()) > 0
    assert float(vals.grad[~c.valid].abs().max()) == 0.0
    y2 = y.detach().clone().requires_grad_()
    vals2 = c.values.detach().clone().requires_grad_()
    ref = dnn.dnn_forward_trainable([dataclasses.replace(c, values=vals2)], [bias], y2,
                                    use_kernel=False)
    (0.5 * ((ref - targets) ** 2).mean()).backward()
    torch.testing.assert_close(out, ref.detach(), **SPMM_TOL)
    torch.testing.assert_close(y.grad, y2.grad, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(vals.grad, vals2.grad, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("layout", ["ell", "bcsr"])
def test_backward_gives_the_same_bits_on_every_call(cuda, layout):
    """dX, dW and db of one SpMM layer, computed again from the same
    inputs, are bit-identical: a restored or resumed training run replays
    the unfailed run's losses only if they are. Every block-column holds
    many stored blocks, so a scatter that adds them in arrival order shows."""
    rng = np.random.default_rng(63)
    a = _weight(rng, 1024, 1024, 16, cuda)
    w = a if layout == "ell" else BlockCSRMatrix.from_bsr(a)
    tp = None if layout == "ell" else w.transpose_plan()
    values = w.blocks if layout == "ell" else w.values
    field = "blocks" if layout == "ell" else "values"
    y = torch.rand((1024, 512), device=cuda)
    bias = torch.rand(1024, device=cuda) - 0.5
    targets = torch.rand((1024, 512), device=cuda)

    def grads():
        v = values.detach().clone().requires_grad_()
        yy, bb = y.clone().requires_grad_(), bias.clone().requires_grad_()
        wv = dataclasses.replace(w, **{field: v})
        out = (ops.bsr_spmm(wv, yy, bb, fuse_bias_relu=True) if layout == "ell"
               else ops.bcsr_spmm(wv, yy, bb, tp, fuse_bias_relu=True))
        return torch.autograd.grad(0.5 * ((out - targets) ** 2).mean(), (yy, v, bb))

    first = grads()
    for _ in range(3):
        for got, want in zip(grads(), first):
            assert torch.equal(got, want)


def test_sparse_train_step_on_the_card_matches_plain(cuda):
    """Three SGD steps through the kernels in both passes against the plain
    versions on the same card, on an ELL + block-CSR + dense stack."""
    from repro_torch.plan import build_plan
    from repro_torch.train import make_sparse_train_step, sgd
    from repro_torch.train.checkpoint import leaves
    from repro_torch.train.sparse import init_sparse_mlp_state

    rng = np.random.default_rng(62)
    a = _weight(rng, 128, 128, 16, cuda)
    ws = [a, BlockCSRMatrix.from_bsr(_weight(rng, 128, 128, 16, cuda), pad_to=40),
          torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32) * 0.05).to(cuda)]
    ws[0] = BlockSparseMatrix(a.blocks * 0.05, a.col_idx, a.block_mask, a.shape, a.block_shape)
    ws[1] = dataclasses.replace(ws[1], values=ws[1].values * 0.05)
    bs = [torch.full((128,), 0.01, device=cuda) for _ in ws]
    batch = {"y0": torch.rand((128, 64), device=cuda),
             "targets": torch.rand((128, 64), device=cuda)}
    plan = build_plan(ws, bs, 64, differentiable=True)
    states = {}
    for use_kernel in (True, False):
        opt = sgd(0.5)
        step = make_sparse_train_step(opt, use_kernel=use_kernel, plan=plan)
        state = init_sparse_mlp_state(ws, bs, opt)
        ops.reset_launch_counts()
        for _ in range(3):
            state, _ = step(state, batch)
        states[use_kernel] = (state, ops.launch_counts())
    (kstate, kcounts), (pstate, pcounts) = states[True], states[False]
    assert kcounts["bsr_spmm"] == 3 and kcounts["bcsr_spmm"] == 6
    assert pcounts["bsr_spmm"] == pcounts["bcsr_spmm"] == 0
    for got, want in zip(leaves(kstate.params), leaves(pstate.params)):
        if got.dtype.is_floating_point:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
        else:
            assert torch.equal(got, want)


# --- plans captured as CUDA graphs ---------------------------------------


def _route_plan(route, device):
    """A plan of the given route on RadiX-net weights: fused 1024 x 12,
    fused-tiled 4096 x 4, layered 1024 x 12 (ELL and block-CSR layers),
    dense 1024 x 4 (every layer densified)."""
    from repro_torch.plan import build_plan

    neurons, layers = {"fused-tiled": (4096, 4), "dense": (1024, 4)}.get(route, (1024, 12))
    w, b = rx.radixnet_weights(rx.RadixNetSpec(neurons, layers), device=device)
    if route == "dense":
        dense = {id(x): x.to_dense() for x in w}
        w = [dense[id(x)] for x in w]
    plan = build_plan(w, b, 64, use_resident=False if route in ("layered", "dense") else None)
    assert plan.route == ("layered" if route == "dense" else route)
    return plan


def _panels(neurons, device, count, n=64):
    panel = rx.radixnet_input_panel(neurons, count * n, density=0.35, seed=9)
    return [torch.from_numpy(np.ascontiguousarray(panel[:, i * n:(i + 1) * n])).to(device)
            for i in range(count)]


@pytest.mark.parametrize("route", ["fused", "fused-tiled", "layered", "dense"])
def test_replay_is_bit_identical_to_the_eager_forward(cuda, route):
    plan = _route_plan(route, cuda)
    panels = _panels(plan.weights[0].shape[1], cuda, 3)
    assert plan.describe()["executable"] == "cuda-graph"
    first = plan.forward(panels[0])  # the warm-up, then the capture
    assert plan.compile_count == 1 and plan.warmups == 1 and plan.replays == 0
    for y in panels:
        got = plan.forward(y)
        want = plan._run(y)  # the same wrappers, called eagerly
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(first, plan._run(panels[0]))
    assert plan.compile_count == 1 and plan.replays == 3


@pytest.mark.parametrize("route", ["fused", "layered"])
def test_launch_counts_are_the_launches_that_ran(cuda, route):
    plan = _route_plan(route, cuda)
    y = _panels(1024, cuda, 1)[0]
    ops.reset_launch_counts()
    for _ in range(5):
        plan.forward(y)
    per_replay = plan.captured_launches
    assert sum(per_replay.values()) == plan.kernel_launches
    counts = ops.launch_counts()
    assert counts == {k: (1 + 4) * v for k, v in per_replay.items()}  # a warm-up, 4 replays
    if route == "layered":
        assert ops.launched_block_shapes() == {"bsr_spmm": [(16, 16)], "bcsr_spmm": [(16, 16)]}


def test_a_held_result_is_unchanged_by_the_next_replay(cuda):
    plan = _route_plan("fused", cuda)
    a, b = _panels(1024, cuda, 2)
    plan.forward(a)  # warm-up
    held = plan.forward(a)  # a replay
    kept = held.clone()
    col = held[:, 3]  # a view, as the batcher keeps per request
    plan.forward(b)
    torch.cuda.synchronize()
    assert torch.equal(held, kept) and torch.equal(col, kept[:, 3])
    assert not torch.equal(plan.forward(b), kept)


@pytest.mark.parametrize("route", ["fused", "layered"])
def test_an_in_place_change_captures_again_with_the_new_values(cuda, route):
    plan = _route_plan(route, cuda)
    y = _panels(1024, cuda, 1)[0]
    plan.forward(y)
    before = plan.forward(y)
    bias = plan.stacked[1] if route == "fused" else plan.biases[0]
    bias.add_(0.25)
    got = plan.forward(y)  # warm-up on the new values, then a second capture
    assert plan.compile_count == 2 and plan.warmups == 2
    again = plan.forward(y)
    want = plan._run(y)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert not torch.equal(got, before)


def test_a_differentiable_plan_stays_eager_and_its_gradients_match(cuda):
    from repro_torch.core import dnn
    from repro_torch.plan import build_plan

    w, b = rx.radixnet_weights(rx.RadixNetSpec(256, 4), device=cuda)
    w = [BlockCSRMatrix.from_bsr(x) if i % 2 else x for i, x in enumerate(w)]
    w = [dnn.with_values(x, dnn.values_of(x) * 0.5) for x in w]
    plan = build_plan(w, b, 32, differentiable=True)
    y0 = torch.from_numpy(rx.radixnet_input_panel(256, 32, density=0.3, seed=4)).to(cuda)
    targets = torch.rand((256, 32), device=cuda)
    assert plan.describe()["executable"] == "eager"
    assert "autograd" in plan.describe()["eager_because"]
    ops.reset_launch_counts()
    plan.forward(y0)
    plan.forward(y0)
    assert plan.compile_count == 1 and plan.replays == 0
    assert ops.launch_counts()["bsr_spmm"] == 4 and ops.launch_counts()["bcsr_spmm"] == 4
    loss_k, (dw_k, db_k) = dnn.dnn_value_and_grad(w, b, y0, targets, plan=plan)
    loss_p, (dw_p, db_p) = dnn.dnn_value_and_grad(w, b, y0, targets, use_kernel=False)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=1e-7)
    for got, want in zip([dnn.values_of(g) for g in dw_k] + list(db_k),
                         [dnn.values_of(g) for g in dw_p] + list(db_p)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_a_call_that_autograd_records_runs_eagerly(cuda):
    plan = _route_plan("layered", cuda)
    y = _panels(1024, cuda, 1)[0]
    plan.forward(y)
    want = plan.forward(y)  # a replay
    replays = plan.replays
    yg = y.clone().requires_grad_()
    out = plan.forward(yg)  # autograd records the wrappers: no replay
    out.sum().backward()
    assert plan.replays == replays and plan.compile_count == 1
    assert yg.grad is not None and bool(torch.isfinite(yg.grad).all())
    assert torch.equal(out.detach(), want)


def test_the_plans_of_one_stack_share_one_graph_pool(cuda):
    from repro_torch.plan import PlanCache

    w, b = rx.radixnet_weights(rx.RadixNetSpec(1024, 4), device=cuda)
    cache = PlanCache()
    p64, p128 = cache.get(w, b, 64), cache.get(w, b, 128)
    assert p64.pool is not None and p128.pool is p64.pool
    assert cache.get(w, b, 64, differentiable=True).pool is None  # stays eager
    other = cache.get(w, b, 64, use_resident=False)  # another key: another pool
    assert other.pool is not None and other.pool != p64.pool
    for plan in (p64, p128, other):
        plan.forward(_panels(1024, cuda, 1)[0])
        plan.forward(_panels(1024, cuda, 1)[0])
        assert plan.compile_count == 1 and plan.replays == 1


@pytest.mark.parametrize("panel_dtype", ["float32", "bfloat16"])
def test_dnn_forward_resident_runs_a_stack_no_fused_route_takes_on_the_spmm_kernels(
        cuda, panel_dtype):
    from repro_torch.core import dnn
    from repro_torch.plan import default_cache, reset_default_cache

    w, b = rx.radixnet_weights(rx.RadixNetSpec(1024, 4), device=cuda)
    mixed = [BlockCSRMatrix.from_bsr(x) if i % 2 else x for i, x in enumerate(w)]
    y = _panels(1024, cuda, 1)[0]
    reset_default_cache()
    ops.reset_launch_counts()
    got = dnn.dnn_forward_resident(mixed, b, y, panel_dtype=panel_dtype)
    counts = ops.launch_counts()
    (plan,) = default_cache().plans()
    paths = [lp.path for lp in plan.layers]
    assert plan.route == "layered" and plan.key.tuned == f"panel_dtype={panel_dtype}"
    assert counts["bsr_spmm"] == paths.count("kernel-ell")
    assert counts["bcsr_spmm"] == paths.count("kernel-bcsr")
    assert counts["bsr_spmm"] + counts["bcsr_spmm"] == 4  # every layer on a kernel
    assert counts["fused_mlp_forward"] == counts["fused_mlp_tiled_forward"] == 0
    want = dnn.dnn_forward(mixed, b, y, fused=True)
    torch.testing.assert_close(got, want, **STACK_TOL)
    reset_default_cache()


@pytest.mark.parametrize("route", ["fused", "fused-tiled", "layered", "dense"])
def test_a_replay_runs_the_kernels_its_capture_recorded(cuda, route):
    plan = _route_plan(route, cuda)
    y = _panels(plan.weights[0].shape[1], cuda, 1)[0]
    plan.forward(y)  # warm-up and capture
    ops.reset_launch_counts()
    plan.forward(y)
    assert plan.replays == 1
    nonzero = lambda counts: {k: v for k, v in counts.items() if v}  # noqa: E731
    in_graph = nonzero(plan.graph_launches)  # the graph's kernel nodes, read by libcuda
    assert in_graph == nonzero(plan.captured_launches) == nonzero(ops.launch_counts())
    assert sum(in_graph.values()) == plan.kernel_launches


# --- tuned plans and resilient training ----------------------------------


def _skewed_stack(device):
    """The reference tune tests' skewed rectangular stack (layered route)."""
    specs = [((128, 256), 100), ((128, 128), 55), ((64, 128), 28)]
    ws = [BlockCSRMatrix.random_skewed(i, shape, (16, 16), tb, skew=0.3, device=device).to_bsr()
          for i, (shape, tb) in enumerate(specs)]
    return ws, [torch.zeros(s[0], device=device) for s, _ in specs]


@pytest.mark.parametrize("knob, tol", [({"layout": "bcsr"}, dict(rtol=1e-6, atol=0.0)),
                                       ({"block_size": 32}, dict(rtol=1e-4, atol=1e-4))])
def test_tuned_plans_match_the_default_plan(cuda, knob, tol):
    """A tuned plan on the card against the default plan, at the reference
    tune tests' tolerances; the tuned layouts and blocks are launched."""
    from repro_torch.plan import build_plan
    from repro_torch.tune import TunedConfig

    ws, bs = _skewed_stack(cuda)
    x = torch.from_numpy(np.random.default_rng(64).standard_normal((256, 32)).astype(
        np.float32)).to(cuda)
    p0 = build_plan(ws, bs, 32)
    p1 = build_plan(ws, bs, 32, tuned=TunedConfig(**knob))
    want = p0.forward(x)
    ops.reset_launch_counts()
    got = p1.forward(x)
    counts, shapes = ops.launch_counts(), ops.launched_block_shapes()
    if "layout" in knob:
        assert p1.layouts == ("bcsr",) * 3 and counts["bcsr_spmm"] == 3
    else:
        assert all(w.block_shape == (32, 32) for w in p1.weights)
        assert all(s == (32, 32) for v in shapes.values() for s in v)
    torch.testing.assert_close(got, want, **tol)


def _resilient_setup(device):
    """An ELL, a block-CSR and an ELL layer whose block-columns hold many
    stored blocks, a differentiable plan, and seeded batches."""
    from repro_torch.plan import build_plan
    from repro_torch.train import init_sparse_mlp_state, sgd

    rng = np.random.default_rng(65)
    ws = [_weight(rng, 512, 512, 16, device) for _ in range(3)]
    ws = [dataclasses.replace(w, blocks=w.blocks * 0.02) for w in ws]
    ws[1] = BlockCSRMatrix.from_bsr(ws[1])
    bs = [torch.full((512,), 0.01, device=device) for _ in ws]
    plan = build_plan(ws, bs, 64, differentiable=True)
    batches = [{"y0": torch.from_numpy(rng.random((512, 64), dtype=np.float32)),
                "targets": torch.from_numpy(rng.random((512, 64), dtype=np.float32))}
               for _ in range(8)]
    return (lambda: init_sparse_mlp_state(ws, bs, sgd(0.05))), plan, batches.__getitem__


def test_resilient_training_replays_the_clean_losses_after_a_nan_fault(cuda, tmp_path):
    """A NaN loss at step 3 is restored from the step-2 checkpoint and
    replayed; a run killed at step 5 resumes. Both give the clean run's
    losses bit for bit: every kernel of the step adds in a fixed order."""
    from repro_torch.testing import SITE_TRAIN_NAN_LOSS, FaultInjector
    from repro_torch.train import run_resilient_training, sgd

    state, plan, batch = _resilient_setup(cuda)
    kw = dict(ckpt_interval=2, plan=plan, device=cuda)
    ops.reset_launch_counts()
    _, clean = run_resilient_training(state(), batch, sgd(0.05), 8, str(tmp_path / "clean"), **kw)
    assert ops.launch_counts()["bcsr_spmm"] > 0 and ops.launch_counts()["bsr_spmm"] > 0
    inj = FaultInjector()
    inj.schedule(SITE_TRAIN_NAN_LOSS, 3)
    _, faulted = run_resilient_training(state(), batch, sgd(0.05), 8, str(tmp_path / "nan"),
                                        fault_injector=inj, **kw)
    assert faulted["skipped"] == [3] and len(faulted["restarts"]) == 1
    assert faulted["losses"] == clean["losses"]
    _, part = run_resilient_training(state(), batch, sgd(0.05), 5, str(tmp_path / "kill"), **kw)
    _, rest = run_resilient_training(state(), batch, sgd(0.05), 8, str(tmp_path / "kill"), **kw)
    assert rest["start_step"] == 5
    assert {**part["losses"], **rest["losses"]} == clean["losses"]


# --- the sharded stack ----------------------------------------------------


def _sharded_stack(device, layers=3, m=512, shards=4):
    """A seeded block-CSR stack of width ``m`` (pad slots and an empty
    block-row in each layer's source) and a mesh of ``shards`` on the card."""
    from repro_torch.launch.mesh import make_row_blocks_mesh

    rng = np.random.default_rng(66)
    ws = [BlockCSRMatrix.from_bsr(dataclasses.replace(w, blocks=w.blocks * 0.05))
          for w in (_weight(rng, m, m, 16, device) for _ in range(layers))]
    bs = [torch.full((m,), 0.01 * i, device=device) for i in range(layers)]
    return ws, bs, make_row_blocks_mesh(shards, device=device)


def test_a_sharded_replay_is_bit_identical_to_its_eager_forward(cuda):
    from repro_torch.plan import build_sharded_plan

    ws, bs, mesh = _sharded_stack(cuda)
    plan = build_sharded_plan(ws, bs, 64, mesh)
    ys = _panels(512, cuda, 3)
    eager = [plan._eager(y) for y in ys]
    ops.reset_launch_counts()
    got = [plan.forward(y) for y in ys]  # warm-up and capture, then replays
    assert plan.describe()["executable"] == "cuda-graph" and plan.compile_count == 1
    assert plan.replays == 2 and plan.warmups == 1
    for g, e in zip(got, eager):
        assert torch.equal(g, e)
    assert ops.launch_counts()["bcsr_spmm"] == 3 * plan.kernel_launches == 3 * 4 * 3
    nonzero = {k: v for k, v in plan.graph_launches.items() if v}
    assert nonzero == {"bcsr_spmm": plan.kernel_launches}
    want = ys[0]
    for w, b in zip(ws, bs):
        want = bcsr_spmm_plain(w, want, b, fuse_bias_relu=True)
    torch.testing.assert_close(got[0], want, **STACK_TOL)


def test_a_rectangular_sharded_stack_runs_on_the_card(cuda):
    """The tune arm's skewed shapes, 256 -> 128 -> 128 -> 64 rows: every
    shard launch takes a bias of its layer's rows; the replay matches the
    plain layers."""
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.plan import build_sharded_plan

    rng = np.random.default_rng(67)
    ws = [BlockCSRMatrix.from_bsr(dataclasses.replace(w, blocks=w.blocks * 0.05))
          for w in (_weight(rng, m, k, 16, cuda) for m, k in ((128, 256), (128, 128),
                                                               (64, 128)))]
    bs = [torch.full((w.shape[0],), 0.01 * i, device=cuda) for i, w in enumerate(ws)]
    plan = build_sharded_plan(ws, bs, 64, make_row_blocks_mesh(4, device=cuda))
    y = torch.from_numpy(rng.random((256, 64), dtype=np.float32)).to(cuda)
    ops.reset_launch_counts()
    got = [plan.forward(y) for _ in range(2)]  # warm-up and capture, then a replay
    assert plan.compile_count == 1 and plan.replays == 1
    assert ops.launch_counts()["bcsr_spmm"] == 2 * plan.kernel_launches == 2 * 4 * 3
    assert torch.equal(got[0], got[1])
    want = y
    for w, b in zip(ws, bs):
        want = bcsr_spmm_plain(w, want, b, fuse_bias_relu=True)
    torch.testing.assert_close(got[1], want, **STACK_TOL)


def test_an_empty_shard_launch_gives_exact_zeros(cuda):
    """The reference's ``degenerate8`` topology: 2 stored blocks over 8
    shards, 6 shards empty; each empty shard's launch (no epilogue) is
    exactly 0, and the sharded forward is the unsharded one."""
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.plan import build_sharded_plan

    m = 64
    dense = torch.zeros((m, m))
    dense[:16, :32] = 0.25
    tiny = [BlockCSRMatrix.from_dense(dense, (16, 16), device=cuda)]
    plan = build_sharded_plan(tiny, [torch.zeros(m, device=cuda)], 8,
                              make_row_blocks_mesh(8, device=cuda))
    assert plan.layers[0].nnz_per_shard.count(0) == 6
    y = torch.rand((m, 8), device=cuda) + 1.0
    ops.reset_launch_counts()
    for local, nnz in zip(plan.layers[0].shards, plan.layers[0].nnz_per_shard):
        part = ops.bcsr_spmm(local, y, torch.full((m,), 3.0, device=cuda))
        if nnz == 0:
            assert not bool(part.any())
    assert ops.launch_counts()["bcsr_spmm"] == 8
    out = plan.forward(y)
    torch.testing.assert_close(out, torch.relu(dense.to(cuda) @ y), **SPMM_TOL)


def test_two_sharded_backward_passes_give_the_same_bits(cuda):
    from repro_torch.core import dnn
    from repro_torch.plan import build_sharded_plan

    ws, bs, mesh = _sharded_stack(cuda)
    plan = build_sharded_plan(ws, bs, 64, mesh, differentiable=True)
    y = _panels(512, cuda, 1)[0]
    targets = torch.rand((512, 64), generator=torch.Generator(device=cuda).manual_seed(3),
                         device=cuda)
    ops.reset_launch_counts()
    runs = [dnn.dnn_value_and_grad(ws, bs, y, targets, plan=plan) for _ in range(2)]
    # forward: a launch per shard per layer; backward: dX on each shard's
    # transpose for every layer but the first
    assert ops.launch_counts()["bcsr_spmm"] == 2 * (4 * 3 + 4 * 2)
    (l1, (dw1, db1)), (l2, (dw2, db2)) = runs
    assert torch.equal(l1, l2)
    for a, b in zip(dw1, dw2):
        assert torch.equal(a.values, b.values)
    for a, b in zip(db1, db2):
        assert torch.equal(a, b)
    lp, (dwp, dbp) = dnn.dnn_value_and_grad(ws, bs, y, targets, use_kernel=False)
    torch.testing.assert_close(l1, lp, rtol=1e-5, atol=0)
    for a, b in zip(dw1, dwp):
        torch.testing.assert_close(a.values, b.values, rtol=1e-4, atol=1e-6)


def test_a_shard_failure_demotes_and_the_categories_still_match(cuda):
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.serve import SparseDNNEngine
    from repro_torch.testing import SITE_SHARD_FAILURE, FaultInjector

    spec = rx.RadixNetSpec(1024, 24)
    weights, biases = rx.radixnet_weights(spec, device=cuda)
    inj = FaultInjector()
    inj.schedule(SITE_SHARD_FAILURE, 1)
    engine = SparseDNNEngine(weights, biases, batch_align=32, mesh=make_row_blocks_mesh(
        4, device=cuda), fault_injector=inj)
    panel = rx.radixnet_input_panel(1024, 384, density=0.3, seed=0)
    _, want = rx.radixnet_reference(spec, panel)
    levels, active = [], []
    for i in range(3):
        out, stats = engine.infer(torch.from_numpy(panel[:, 128 * i:128 * (i + 1)]).to(cuda))
        levels.append(stats["plan"]["level"])
        active.append((out > 0).any(dim=0).cpu().numpy())
    assert levels == ["sharded", "layered", "layered"]
    assert [e.level for e in engine.ladder.events] == ["sharded"]
    np.testing.assert_array_equal(np.flatnonzero(np.concatenate(active)), want)


# --- the model stack on the card ------------------------------------------------


def _sparse_ffn_weight(rng, d_out, d_in, bs, bpr, device, csr=False):
    from repro_torch.core import pruning

    w = torch.from_numpy(rng.standard_normal((d_out, d_in)).astype(np.float32)).to(device)
    a = pruning.block_prune(w, bs, blocks_per_row=bpr)
    return BlockCSRMatrix.from_bsr(a) if csr else a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("csr", [False, True], ids=["bsr", "bcsr"])
@pytest.mark.parametrize("bs", [(16, 16), (128, 128)])
def test_linear_runs_sparse_weights_on_the_spmm_kernels(cuda, dtype, csr, bs):
    """``linear`` on a sparse FFN weight launches the SpMM kernel (bf16
    weights and panels read as f32, the result cast back) and matches the
    plain product of the same operands."""
    from repro_torch.models.layers import linear

    rng = np.random.default_rng(11)
    w = _sparse_ffn_weight(rng, 512, 256, bs, 2, cuda, csr).astype(dtype)
    x = torch.from_numpy(rng.standard_normal((2, 7, 256)).astype(np.float32)).to(cuda, dtype)
    name = "bcsr_spmm" if csr else "bsr_spmm"
    ops.reset_launch_counts()
    got = linear(w, x)
    assert ops.launch_counts()[name] == 1 and got.dtype == dtype and got.shape == (2, 7, 512)
    want = linear(w.astype(torch.float32), x.float(), use_kernel=False)
    assert ops.launch_counts()[name] == 1
    # normal weights and inputs cancel: f32 orders are held to the output's
    # scale (the SPMM rtol of max|want|), bf16 to one rounding of the f32 sum
    scale = float(want.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=SPMM_TOL["rtol"], atol=SPMM_TOL["rtol"] * scale)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=SPMM_TOL["rtol"] * scale)


def _numpy_tree(tree):
    from repro_torch.models.layers import tree_map

    def leaf(t):
        if isinstance(t, (BlockSparseMatrix, BlockCSRMatrix)):
            return dataclasses.replace(t, **{f.name: getattr(t, f.name).cpu().numpy()
                                             for f in dataclasses.fields(t)
                                             if isinstance(getattr(t, f.name), torch.Tensor)})
        return t.cpu().numpy()

    return tree_map(leaf, tree)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "graphblas-mlp"])
def test_model_params_on_the_card_match_the_cpu_forward(cuda, arch):
    """A numpy params tree (the reference's format) converted onto the card
    and onto the CPU: the card's forward (sparse FFNs on the kernels) within
    1e-4 of each row's max |CPU logit| at f32 compute."""
    from repro_torch import convert
    from repro_torch.configs import get_config, graphblas_mlp
    from repro_torch.models import Model

    if arch == "graphblas-mlp":
        cfg = graphblas_mlp.make_config(m=256, num_layers=3, inverse_sparsity=4, block=32)
    else:
        cfg = dataclasses.replace(get_config(arch).scaled_down(), compute_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    if cfg.sparsity is not None:
        params = model.sparsify(params)
    tree = _numpy_tree(params)
    rng = np.random.default_rng(1)
    if cfg.input_mode == "tokens":
        inp = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32))
    else:
        inp = torch.from_numpy(rng.random((8, cfg.d_model), dtype=np.float32))
    ops.reset_launch_counts()
    got = model.forward(convert.model_params(tree, device=cuda), inp.to(cuda)).cpu()
    want = model.forward(convert.model_params(tree, device="cpu"), inp)
    if cfg.sparsity is not None:
        assert ops.launch_counts()["bsr_spmm"] == cfg.num_layers
    scale = want.abs().amax(dim=-1, keepdim=True)
    assert bool(((got - want).abs().amax(dim=-1, keepdim=True) <= 1e-4 * scale).all())


def test_a_scaled_down_engine_on_the_card_is_deterministic(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine

    cfg = get_config("llama3.2-1b").scaled_down()
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
    engine = Engine(model, params, batch_size=3, cache_len=64)
    assert engine.device.type == "cuda"
    prompts = torch.randint(0, cfg.vocab_size, (3, 8), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(1))
    out1, stats = engine.generate(prompts, 12)
    out2, _ = engine.generate(prompts, 12)
    assert out1.shape == (3, 12) and out1.is_cuda and bool((out1 == out2).all())
    first = torch.argmax(model.forward(engine.params, prompts)[:, -1], dim=-1)
    assert bool((out1[:, 0] == first).all())
    assert stats["cache_bytes"] > 0


def _to_device(params, device):
    """A params tree moved to ``device`` (sparse matrices through ``.to``)."""
    from repro_torch.models.layers import tree_map

    return tree_map(lambda leaf: leaf.to(device), params)


def _sparse_ffn_model(arch: str):
    """(model, plain model, params on the CPU) with sparse FFN weights at f32
    compute: the paper's MLP, or scaled-down Llama with its FFNs pruned to
    2 of 4 or 8 blocks of 16 x 16 a block-row."""
    from repro_torch.configs import SparsityConfig, get_config, graphblas_mlp
    from repro_torch.models import Model

    if arch == "graphblas-mlp":
        cfg = graphblas_mlp.make_config(m=256, num_layers=3, inverse_sparsity=4, block=32)
    else:
        cfg = dataclasses.replace(get_config(arch).scaled_down(), compute_dtype="float32",
                                  sparsity=SparsityConfig((16, 16), blocks_per_row=2,
                                                          targets=("ffn",)))
    model = Model(cfg)
    params = model.sparsify(model.init(torch.Generator().manual_seed(0), device="cpu"))
    return model, Model(cfg, use_kernel=False), params


def _train_batch(cfg, device):
    rng = np.random.default_rng(2)
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    else:
        inputs = rng.random((8, cfg.d_model), dtype=np.float32)
        labels = rng.integers(0, cfg.vocab_size, (8, 1)).astype(np.int32)
    return {"inputs": torch.from_numpy(inputs).to(device),
            "labels": torch.from_numpy(labels).to(device)}


@pytest.mark.parametrize("arch", ["graphblas-mlp", "llama3.2-1b"])
def test_a_sparse_ffn_model_train_step_on_the_card_matches_its_plain_step(cuda, arch):
    """One SGD step of ``make_train_step`` with sparse FFN weights: on the
    SpMM kernels forward and backward (a ``bsr_spmm`` a projection, a
    ``bcsr_spmm`` dX for each whose input needs a gradient) against the
    same step on the plain products, on the card: loss within 1e-5, each
    gradient and updated leaf within 1e-4 of its max |plain|, topology
    the same tensors."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.sparse.bsr import BlockSparseMatrix as BSR
    from repro_torch.train import checkpoint, sgd
    from repro_torch.train.trainer import TrainState, loss_and_grads, make_train_step

    model, plain, params = _sparse_ffn_model(arch)
    params = _to_device(params, cuda)
    batch = _train_batch(model.cfg, cuda)
    n_sparse = sum(leaf.blocks.shape[0] if leaf.blocks.dim() == 5 else 1
                   for leaf in tree_leaves(params) if isinstance(leaf, BSR))
    ops.reset_launch_counts()
    loss, _, grads = loss_and_grads(model, params, batch)
    counts = ops.launch_counts()
    first_input_is_data = model.cfg.input_mode == "features"
    assert counts["bsr_spmm"] == n_sparse
    assert counts["bcsr_spmm"] == n_sparse - int(first_input_is_data)
    want_loss, _, want = loss_and_grads(plain, params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for g, w in zip(grads, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
    opt = sgd(1e-2, momentum=0.0)
    state = TrainState(params, opt.init(checkpoint.leaves(params)))
    got_state, _ = make_train_step(model, opt)(state, batch)
    want_state, _ = make_train_step(plain, opt)(state, batch)
    for old, g, w in zip(checkpoint.leaves(params), checkpoint.leaves(got_state.params),
                         checkpoint.leaves(want_state.params)):
        if not old.is_floating_point():
            assert g is old and w is old
        else:
            assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)


def test_two_identical_model_train_steps_give_the_same_bits(cuda):
    from repro_torch.train import adamw, checkpoint
    from repro_torch.train.trainer import TrainState, make_train_step

    model, _, params = _sparse_ffn_model("llama3.2-1b")
    params = _to_device(params, cuda)
    batch = _train_batch(model.cfg, cuda)
    opt = adamw(1e-3)
    state = TrainState(params, opt.init(checkpoint.leaves(params)))
    step = make_train_step(model, opt, microbatches=2)
    (a, ma), (b, mb) = step(state, batch), step(state, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    for x, y in zip(checkpoint.leaves(a), checkpoint.leaves(b)):
        assert torch.equal(x, y)


def test_ell_pad_slots_of_a_model_weight_get_zero_gradient_on_the_card(cuda):
    """Pad slots (mask False, a zero block at column 0) of a sparse FFN
    weight: the kernels' backward gives them exactly 0, and the stored
    slots the plain products' gradient."""
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import loss_and_grads

    model, plain, params = _sparse_ffn_model("graphblas-mlp")
    w = params["stack"]["period"][0]["ffn"]["w"]
    mask = w.block_mask.clone()
    mask[:, ::3, -1] = False  # some block-rows' last slot becomes padding
    blocks = torch.where(mask[..., None, None], w.blocks, torch.zeros(()))
    col_idx = torch.where(mask, w.col_idx, torch.zeros((), dtype=w.col_idx.dtype))
    params["stack"]["period"][0]["ffn"]["w"] = dataclasses.replace(
        w, blocks=blocks, col_idx=col_idx.contiguous(), block_mask=mask)
    params = _to_device(params, cuda)
    batch = _train_batch(model.cfg, cuda)
    leaves = checkpoint.leaves(params)
    i = next(k for k, leaf in enumerate(leaves)
             if leaf is params["stack"]["period"][0]["ffn"]["w"].blocks)
    got = loss_and_grads(model, params, batch)[2][i]
    want = loss_and_grads(plain, params, batch)[2][i]
    pad = ~params["stack"]["period"][0]["ffn"]["w"].block_mask
    assert int(pad.sum()) > 0 and bool((got[pad] == 0).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_a_donated_decode_writes_in_place_on_the_card(cuda):
    """The serve fns' donated decode (``make_serve_fns``) on the card: the
    out-of-place decode's logits and cache bit for bit, in the caller's
    cache storages."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve.engine import make_serve_fns

    model = Model(get_config("gemma3-4b").scaled_down())
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(gen, device=cuda)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 81), generator=gen, device=cuda,
                         dtype=torch.int32)
    prefill_fn, decode_fn = make_serve_fns(model)
    _, cache = prefill_fn(params, toks[:, :80], model.init_cache(2, 96, device=cuda))
    pos = torch.tensor(80, dtype=torch.int32)
    want, want_cache = model.decode_step(params, toks[:, 80], cache, pos)
    ptrs = [t.untyped_storage().data_ptr() for t in tree_leaves(cache)]
    got, got_cache = decode_fn(params, toks[:, 80], cache, pos)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_cache), tree_leaves(want_cache)))
    assert [t.untyped_storage().data_ptr() for t in tree_leaves(got_cache)] == ptrs


def test_a_small_cells_peak_and_flops_on_the_card_are_the_dry_runs(cuda):
    """Llama-3.2-1B's ``decode_32k`` cut to 2 sequences: the FLOPs
    ``FlopCounterMode`` counts on the card equal the meta trace's, and the
    peak the call adds to what the process held besides its arguments lies
    within 10% of the trace's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh

    (rec,) = dryrun.run_cell("llama3.2-1b", "decode_32k", meshes=("card",), global_batch=2)
    plan = specs.make_plan("llama3.2-1b", "decode_32k", make_production_mesh(device="meta"),
                           global_batch=2)
    args = dryrun.materialize(plan, device=cuda,
                              generator=torch.Generator(device=cuda).manual_seed(0))
    w = torch.ones((64, 64), device=cuda)
    _ = (w @ w, w.bfloat16() @ w.bfloat16())  # cuBLAS's workspaces, outside the peak
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - dryrun.live_bytes(args, "cuda")
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        plan.fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    assert counter.get_total_flops() == rec["flops_per_device"]
    assert abs(peak / rec["memory"]["peak_per_device_bytes"] - 1) <= 0.10


# --- the sharded stack across cards ------------------------------------------


def _cards(n):
    """The first ``n`` cards, skipping when the host has fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPUs: this host has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    torch.backends.cuda.matmul.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(n)]


def test_cards_a_launch_on_card_1_gives_card_0s_bits():
    """With card 0 current, each kernel's wrapper on tensors of card 1
    launches there (the shared-memory attribute, the fused kernels'
    geometry and the stream are card 1's) and gives the bits of the same
    launch on card 0; operands on two cards are refused."""
    c0, c1 = _cards(2)
    rng = np.random.default_rng(70)
    w = _weight(rng, 1024, 1024, 16, "cpu")
    csr = BlockCSRMatrix.from_bsr(w)
    stacked = stack_bsr([w, w])
    y = torch.from_numpy(rng.random((1024, 64), dtype=np.float32))
    b = torch.full((1024,), 0.01)
    calls = {
        "bsr_spmm": lambda d: ops.bsr_spmm(w.to(d), y.to(d), b.to(d), fuse_bias_relu=True),
        "bcsr_spmm": lambda d: ops.bcsr_spmm(csr.to(d), y.to(d), b.to(d), fuse_bias_relu=True),
        "semiring_matmul": lambda d: ops.semiring_matmul(w.to_dense().to(d), y.to(d), b.to(d),
                                                         fuse_bias_relu=True),
        "fused_mlp_forward": lambda d: ops.fused_mlp_forward(
            stacked.to(d), torch.stack([b, b]).to(d), y.to(d)),
    }
    torch.cuda.set_device(c0)
    ops.reset_launch_counts()
    for name, call in calls.items():
        on0, on1 = call(c0), call(c1)
        assert on1.device == c1 and torch.cuda.current_device() == 0
        assert torch.equal(on0.cpu(), on1.cpu()), name
    assert ops.launch_counts(c1) == ops.launch_counts(c0) == {
        **dict.fromkeys(ops.KERNELS, 0), **dict.fromkeys(calls, 1)}
    with pytest.raises(ValueError, match="contiguous tensors on"):
        ops.bcsr_spmm(csr.to(c0), y.to(c1))


def _radix_cards(layers=120):
    from repro_torch.launch.mesh import make_row_blocks_mesh

    cards = _cards(4)
    weights, biases = rx.radixnet_weights(rx.RadixNetSpec(1024, layers), device=cards[0])
    return weights, biases, make_row_blocks_mesh(devices=cards), cards


def test_cards_a_4_card_forward_is_the_one_card_4_shard_route_bit_for_bit():
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.plan import build_sharded_plan

    weights, biases, mesh, cards = _radix_cards()
    one = build_sharded_plan(weights, biases, 128, make_row_blocks_mesh(4, device=cards[0]))
    plan = build_sharded_plan(weights, biases, 128, mesh)
    desc = plan.describe()
    assert desc["devices"] == [str(c) for c in cards] and desc["cards"] == 4
    assert desc["executable"] == "eager" and "4 cards" in desc["eager_because"]
    assert all(local.values.device == c for lp in plan.layers
               for local, c in zip(lp.shards, cards))
    y = torch.from_numpy(rx.radixnet_input_panel(1024, 128, density=0.3, seed=0)).to(cards[0])
    want = [one.forward(y) for _ in range(2)][1]  # a replay of the captured graph
    ops.reset_launch_counts()
    got = plan.forward(y)
    assert got.device == cards[0] and torch.equal(got, want)
    for c in cards:
        assert ops.launch_counts(c) == {**dict.fromkeys(ops.KERNELS, 0), "bcsr_spmm": 120}


def test_cards_two_4_card_backward_passes_give_the_same_bits():
    from repro_torch.core import dnn
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.plan import build_sharded_plan

    cards = _cards(4)
    ws, bs, _ = _sharded_stack(cards[0])
    plan = build_sharded_plan(ws, bs, 64, make_row_blocks_mesh(devices=cards),
                              differentiable=True)
    y = _panels(512, cards[0], 1)[0]
    targets = torch.rand((512, 64), generator=torch.Generator(device=cards[0]).manual_seed(3),
                         device=cards[0])
    ops.reset_launch_counts()
    runs = [dnn.dnn_value_and_grad(ws, bs, y, targets, plan=plan) for _ in range(2)]
    for c in cards:  # forward a launch a layer, backward one a layer but the first
        assert ops.launch_counts(c)["bcsr_spmm"] == 2 * (3 + 2)
    (l1, (dw1, db1)), (l2, (dw2, db2)) = runs
    assert torch.equal(l1, l2)
    for a, b in zip(dw1, dw2):
        assert torch.equal(a.values, b.values)
    for a, b in zip(db1, db2):
        assert torch.equal(a, b)
    lone, (dwone, _) = dnn.dnn_value_and_grad(ws, bs, y, targets, plan=build_sharded_plan(
        ws, bs, 64, make_row_blocks_mesh(4, device=cards[0]), differentiable=True))
    assert torch.equal(l1, lone)  # the forward is the one-card route's, bit for bit
    for a, b in zip(dw1, dwone):
        torch.testing.assert_close(a.values, b.values, rtol=1e-5, atol=1e-6)


def test_cards_a_shard_failure_on_4_cards_demotes_with_the_same_categories():
    from repro_torch.serve import SparseDNNEngine
    from repro_torch.testing import SITE_SHARD_FAILURE, FaultInjector

    weights, biases, mesh, cards = _radix_cards(24)
    inj = FaultInjector()
    inj.schedule(SITE_SHARD_FAILURE, 1)
    engine = SparseDNNEngine(weights, biases, batch_align=32, mesh=mesh, fault_injector=inj)
    panel = rx.radixnet_input_panel(1024, 384, density=0.3, seed=0)
    _, want = rx.radixnet_reference(rx.RadixNetSpec(1024, 24), panel)
    levels, active = [], []
    for i in range(3):
        out, stats = engine.infer(torch.from_numpy(panel[:, 128 * i:128 * (i + 1)]).to(cards[0]))
        assert out.device == cards[0]
        levels.append(stats["plan"]["level"])
        active.append((out > 0).any(dim=0).cpu().numpy())
    assert levels == ["sharded", "layered", "layered"]
    assert engine.ladder.describe()["home_device"] == str(cards[0])
    np.testing.assert_array_equal(np.flatnonzero(np.concatenate(active)), want)


# --- the model API on a data mesh ---------------------------------------------


def _data_mesh_model(sparse: bool):
    """Scaled-down Llama-3.2-1B at f32 compute (every FFN block-sparse, 2
    blocks of 16 a row, when ``sparse``), a seeded batch of 8 × 16 tokens."""
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("llama3.2-1b").scaled_down(), compute_dtype="float32")
    if sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig((16, 16), blocks_per_row=2,
                                                               targets=("ffn",)))
    rng = np.random.default_rng(80)
    batch = {"inputs": torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32))}
    batch["labels"][6:] = -1
    return Model(cfg), batch


def _data_step(model, batch, mesh, *, microbatches=2, params=None, opt=None):
    """One step of ``opt`` (AdamW 1e-3 by default) on ``mesh`` from seeded
    weights (drawn on card 0): (new state, metrics as floats, each card's
    launches)."""
    from repro_torch.distribution.sharding import param_pspecs, place, shardings_for
    from repro_torch.train import adamw, checkpoint, make_train_step
    from repro_torch.train.optimizer import init_placed
    from repro_torch.train.trainer import TrainState

    if params is None:
        params = model.init(torch.Generator(device="cuda:0").manual_seed(0), device="cuda:0")
        if model.cfg.sparsity is not None:
            params = model.sparsify(params)
    opt = opt or adamw(1e-3)
    placed = place(params, shardings_for(None, mesh, param_pspecs(None, params, mesh)))
    ops.reset_launch_counts()
    state, metrics = make_train_step(model, opt, microbatches=microbatches)(
        TrainState(placed, init_placed(opt, checkpoint.leaves(placed))), batch)
    for d in mesh.cards:
        torch.cuda.synchronize(d)
    return state, {k: float(v) for k, v in metrics.items()}, \
        {str(d): ops.launch_counts(d) for d in mesh.cards}


def test_a_4_position_step_on_the_card_matches_one_position(cuda):
    """4 positions on one card against one position, the sparse FFNs on the
    SpMM kernels: loss within 1e-5, each updated leaf within 1e-4 of its
    max; 4 positions × 2 microbatches × each projection's launches."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint

    model, batch = _data_mesh_model(sparse=True)
    s4, m4, l4 = _data_step(model, batch, make_local_mesh(4, device="cuda"))
    s1, m1, l1 = _data_step(model, batch, make_local_mesh(1, device="cuda"))
    assert abs(m4["loss"] - m1["loss"]) <= 1e-5 * abs(m1["loss"])
    n = 2 * 3 * model.cfg.num_layers
    assert l1["cuda:0"]["bsr_spmm"] == l1["cuda:0"]["bcsr_spmm"] == n
    assert l4["cuda:0"]["bsr_spmm"] == l4["cuda:0"]["bcsr_spmm"] == 4 * n
    for a, b in zip(checkpoint.leaves(s4.params), checkpoint.leaves(s1.params)):
        want = b.gather("cuda:0").float()
        err = float((a.gather("cuda:0").float() - want).abs().max())
        assert err <= 1e-4 * max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("sparse", [False, True])
def test_cards_a_4_card_train_step_is_the_4_position_one_card_step_bit_for_bit(sparse):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint

    cards = _cards(4)
    model, batch = _data_mesh_model(sparse)
    s1, m1, _ = _data_step(model, batch, make_local_mesh(4, device=cards[0]))
    s4, m4, _ = _data_step(model, batch, make_local_mesh(devices=cards))
    assert m1 == m4
    for tree1, tree4 in ((s1.params, s4.params), (s1.opt.mu, s4.opt.mu), (s1.opt.nu, s4.opt.nu)):
        for x, y in zip(checkpoint.leaves(tree1), checkpoint.leaves(tree4)):
            assert [c.device for c in y.chunks] == cards
            for a, b in zip(x.chunks, y.chunks):
                assert torch.equal(a.to(b.device), b)


def test_cards_the_sparse_models_launches_split_by_card():
    from repro_torch.launch.mesh import make_local_mesh

    cards = _cards(4)
    model, batch = _data_mesh_model(sparse=True)
    _, _, launches = _data_step(model, batch, make_local_mesh(devices=cards))
    n = 2 * 3 * model.cfg.num_layers  # a position's projections, forward and dX, 2 microbatches
    assert launches == {str(c): {**dict.fromkeys(ops.KERNELS, 0), "bsr_spmm": n, "bcsr_spmm": n}
                        for c in cards}


def test_cards_each_card_stores_its_chunks():
    """Placing a state puts each position's chunks on its card and nothing
    more: card c's allocation grows by its chunks' bytes (the allocator
    rounds each block up to 512 bytes)."""
    from repro_torch.distribution.sharding import param_pspecs, place, shardings_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import adamw, checkpoint
    from repro_torch.train.optimizer import init_placed
    from repro_torch.train.trainer import TrainState

    cards = _cards(4)
    mesh = make_local_mesh(devices=cards)
    model, _ = _data_mesh_model(sparse=True)
    params = model.sparsify(model.init(torch.Generator(device="cpu").manual_seed(0),
                                       device="cpu"))
    before = [torch.cuda.memory_allocated(c) for c in cards]
    placed = place(params, shardings_for(None, mesh, param_pspecs(None, params, mesh)))
    state = TrainState(placed, init_placed(adamw(1e-3), checkpoint.leaves(placed)))
    leaves = [x for x in checkpoint.leaves(checkpoint.state_tree(state)) if hasattr(x, "chunks")]
    assert any(x.sharding.dim is not None for x in leaves)
    for i, c in enumerate(cards):
        chunks = [x.chunks[i] for x in leaves]
        assert all(ch.device == c for ch in chunks)
        want = sum(ch.numel() * ch.element_size() for ch in chunks)
        grew = torch.cuda.memory_allocated(c) - before[i]
        assert want <= grew <= want + 512 * len(chunks), (c, want, grew)


def test_a_model_mesh_sparse_step_launches_the_spmm_kernels_on_each_group_home_card(cuda):
    """A 2 × 2 mesh on one card: each group runs its block-sparse FFNs once,
    on its home card (card 0 for both), 2 groups × 2 microbatches × each
    projection's forward and dX launches; against one position, the loss
    within 1e-5 and each updated leaf within 1e-4 of its max."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint

    model, batch = _data_mesh_model(sparse=True)
    s4, m4, l4 = _data_step(model, batch, make_local_mesh(2, model=2, device="cuda"))
    s1, m1, _ = _data_step(model, batch, make_local_mesh(1, device="cuda"))
    assert abs(m4["loss"] - m1["loss"]) <= 1e-5 * abs(m1["loss"])
    n = 2 * 3 * model.cfg.num_layers
    assert l4["cuda:0"]["bsr_spmm"] == l4["cuda:0"]["bcsr_spmm"] == 2 * n
    assert any(x.sharding.model_dim is not None for x in checkpoint.leaves(s4.params))
    for a, b in zip(checkpoint.leaves(s4.params), checkpoint.leaves(s1.params)):
        want = b.gather("cuda:0").float()
        err = float((a.gather("cuda:0").float() - want).abs().max())
        assert err <= 1e-4 * max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("sparse", [False, True])
def test_cards_a_2x2_model_mesh_step_is_the_2x2_one_card_step_bit_for_bit(sparse):
    """The 2 × 2 ``data`` × ``model`` step on 4 cards (groups on cards 0-1
    and 2-3) against the same mesh on card 0: the same metrics and every
    chunk of the new state bit for bit; a sparse model's launches on the
    groups' home cards, 0 and 2, only."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint

    cards = _cards(4)
    model, batch = _data_mesh_model(sparse)
    s1, m1, _ = _data_step(model, batch, make_local_mesh(2, model=2, device=cards[0]))
    s4, m4, l4 = _data_step(model, batch, make_local_mesh(2, model=2, devices=cards))
    assert m1 == m4
    for tree1, tree4 in ((s1.params, s4.params), (s1.opt.mu, s4.opt.mu), (s1.opt.nu, s4.opt.nu)):
        for x, y in zip(checkpoint.leaves(tree1), checkpoint.leaves(tree4)):
            assert [c.device for c in y.chunks] == cards
            for a, b in zip(x.chunks, y.chunks):
                assert torch.equal(a.to(b.device), b)
    n = 2 * 3 * model.cfg.num_layers if sparse else 0
    assert {d: (c["bsr_spmm"], c["bcsr_spmm"]) for d, c in l4.items()} == {
        str(c): (n, n) if i % 2 == 0 else (0, 0) for i, c in enumerate(cards)}


# --- MLA, Mamba and RWKV-6 on the model axis -----------------------------------

MIXER_ARCHS = ("deepseek-v2-236b", "jamba-v0.1-52b", "rwkv6-3b")


def _mixer_model(arch: str):
    """A scaled-down arch at f32 compute and a seeded batch of 8 rows (128
    tokens a row for a MoE arch, so each group keeps the 256-token MoE
    groups of the 2 × 2 mesh's microbatches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch).scaled_down(), compute_dtype="float32")
    s = 128 if cfg.moe is not None else 16
    rng = np.random.default_rng(81)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, s)).astype(np.int32))
             for k in ("inputs", "labels")}
    batch["labels"][6:] = -1
    return Model(cfg), batch


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_a_model_mesh_mixer_step_on_the_card_matches_the_data_mesh(cuda, arch):
    """The 2 × 2 mesh on one card with MLA, Mamba or RWKV-6 split over
    ``model`` against the data mesh of the same groups (2 × 1: the same
    rows in each product, no model split): the loss within 1e-5, each leaf
    updated by SGD (its gradient's image; AdamW's first step is ~lr·sign(g))
    within 1e-4 of its max. Against one position RWKV-6's f32 gradients
    move by ~1e-3 on the card with the rows a product takes together,
    with or without the model split."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint, sgd

    model, batch = _mixer_model(arch)
    opt = sgd(1e-2, momentum=0.0)
    s4, m4, _ = _data_step(model, batch, make_local_mesh(2, model=2, device="cuda"), opt=opt)
    s1, m1, _ = _data_step(model, batch, make_local_mesh(2, model=1, device="cuda"), opt=opt)
    assert abs(m4["loss"] - m1["loss"]) <= 1e-5 * abs(m1["loss"])
    assert any(x.sharding.model_dim is not None for x in checkpoint.leaves(s4.params))
    for a, b in zip(checkpoint.leaves(s4.params), checkpoint.leaves(s1.params)):
        want = b.gather("cuda:0").float()
        if want.numel():
            err = float((a.gather("cuda:0").float() - want).abs().max())
            assert err <= 1e-4 * max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_cards_a_2x2_mixer_step_is_the_2x2_one_card_step_bit_for_bit(arch):
    """MLA, Mamba or RWKV-6 split over ``model`` on 4 cards (groups on cards
    0-1 and 2-3) against the same mesh on card 0: the same metrics and
    every chunk of the new state bit for bit."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint

    cards = _cards(4)
    model, batch = _mixer_model(arch)
    s1, m1, _ = _data_step(model, batch, make_local_mesh(2, model=2, device=cards[0]))
    s4, m4, _ = _data_step(model, batch, make_local_mesh(2, model=2, devices=cards))
    assert m1 == m4
    for tree1, tree4 in ((s1.params, s4.params), (s1.opt.mu, s4.opt.mu), (s1.opt.nu, s4.opt.nu)):
        for x, y in zip(checkpoint.leaves(tree1), checkpoint.leaves(tree4)):
            assert [c.device for c in y.chunks] == cards
            for a, b in zip(x.chunks, y.chunks):
                assert torch.equal(a.to(b.device), b)


# --- serving over the model's mesh ----------------------------------------------

SERVE_ARCHS = ("llama3.2-1b", "deepseek-v2-236b", "jamba-v0.1-52b", "rwkv6-3b", "gemma3-4b")


def _serve_on(model, params, mesh, prompts, new_tokens: int, cache_len: int = 32):
    """A prefill and ``new_tokens - 1`` greedy decode steps through
    ``make_serve_fns`` over ``params`` and a fresh cache placed on ``mesh``:
    (each call's logits, the greedy tokens, the placed cache, each card's
    launches over the calls)."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.serve.engine import make_serve_fns

    cfg = model.cfg
    pp = sh.place(params, sh.shardings_for(None, mesh, sh.param_pspecs(cfg, params, mesh)))
    cache = model.init_cache(prompts.shape[0], cache_len, device=mesh.device)
    cache = sh.place(cache, sh.shardings_for(None, mesh, sh.cache_pspecs(cfg, cache, mesh)))
    prefill_fn, decode_fn = make_serve_fns(model)
    ops.reset_launch_counts()
    logits, _ = prefill_fn(pp, prompts.to(mesh.device), cache)
    calls = [logits[:, -1]]
    for i in range(new_tokens - 1):
        tok = torch.argmax(calls[-1], -1).to(torch.int32)
        calls.append(decode_fn(pp, tok, cache, prompts.shape[1] + i)[0])
    for d in mesh.cards:
        torch.cuda.synchronize(d)
    tokens = torch.stack([torch.argmax(c, -1).to(torch.int32) for c in calls], 1)
    return calls, tokens, cache, {str(d): ops.launch_counts(d) for d in mesh.cards}


def _serve_model(arch: str, sparse: bool = False):
    """A scaled-down arch at f32 compute (Llama's FFNs pruned to 2 blocks
    of 16 a row when ``sparse``), seeded weights on card 0 and 4 prompts
    of 12 tokens (80 for Gemma-3, past its scaled-down window of 64)."""
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch).scaled_down(), compute_dtype="float32")
    if sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig((16, 16), blocks_per_row=2,
                                                               targets=("ffn",)))
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda:0").manual_seed(0), device="cuda:0")
    if sparse:
        params = model.sparsify(params)
    s = 80 if arch == "gemma3-4b" else 12
    prompts = torch.from_numpy(np.random.default_rng(90).integers(
        0, cfg.vocab_size, (4, s)).astype(np.int32)).to("cuda:0")
    return model, params, prompts, (128 if arch == "gemma3-4b" else 32)


def test_a_2x2_serve_on_the_card_is_the_one_position_engine(cuda):
    """Llama on the 2 × 2 mesh of card 0, 32 slots (16 a model position), a
    decode across the boundary: the greedy tokens ``Engine.generate``'s and
    every call's logits within 1e-4 of each row's max of the one-device
    path's."""
    from repro_torch.serve.engine import Engine
    from repro_torch.launch.mesh import make_local_mesh

    model, params, prompts, cache_len = _serve_model("llama3.2-1b")
    calls, tokens, _, _ = _serve_on(model, params, make_local_mesh(2, model=2, device="cuda"),
                                    prompts, 10, cache_len)
    want, _ = Engine(model, params, batch_size=4, cache_len=cache_len).generate(prompts, 10)
    assert torch.equal(tokens, want)
    one = model.init_cache(4, cache_len, device="cuda")
    logits, one = model.prefill(params, prompts, one)
    ref = [logits[:, -1]]
    for i in range(9):
        logits, one = model.decode_step(params, want[:, i], one, prompts.shape[1] + i)
        ref.append(logits)
    for got, r in zip(calls, ref):
        err = (got - r).abs().amax(-1) / r.abs().amax(-1)
        assert float(err.max()) <= 1e-4


def test_a_pruned_ffn_serve_launches_bsr_spmm_on_each_group_home_card(cuda):
    """Llama's FFNs pruned on the 2 × 2 mesh of card 0: each group runs its
    block-sparse FFNs once a call on its home card (both card 0), 3
    projections a layer; the tokens those of the one-device path."""
    from repro_torch.serve.engine import Engine
    from repro_torch.launch.mesh import make_local_mesh

    model, params, prompts, cache_len = _serve_model("llama3.2-1b", sparse=True)
    _, tokens, _, launches = _serve_on(model, params, make_local_mesh(2, model=2, device="cuda"),
                                       prompts, 4, cache_len)
    n = 3 * model.cfg.num_layers
    assert launches == {"cuda:0": {**{k: 0 for k in launches["cuda:0"]}, "bsr_spmm": 4 * 2 * n}}
    want, _ = Engine(model, params, batch_size=4, cache_len=cache_len).generate(prompts, 4)
    assert torch.equal(tokens, want)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_cards_a_2x2_serve_is_the_2x2_one_card_serve_bit_for_bit(arch):
    """The 2 × 2 serve on 4 cards (groups on cards 0-1 and 2-3) against the
    same mesh on card 0: every call's logits, the tokens and every chunk
    of the cache bit for bit. A MoE arch's token groups cross data indices
    there (each MoE layer runs on group 0's home card over both groups'
    rows); it is also served on 1 × 2 (cards 0-1), its experts split over
    ``model`` and its groups its own."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint

    cards = _cards(4)
    model, params, prompts, cache_len = _serve_model(arch)
    moe = any(s.ffn == "moe" for s in model.cfg.layer_specs())
    for data in (1, 2) if moe else (2,):
        runs = [_serve_on(model, params, make_local_mesh(data, model=2, **where), prompts, 6,
                          cache_len)
                for where in ({"device": cards[0]}, {"devices": cards[:2 * data]})]
        (c1, t1, k1, _), (c4, t4, k4, _) = runs
        assert torch.equal(t1, t4.to(t1.device))
        assert all(torch.equal(a, b.to(a.device)) for a, b in zip(c1, c4))
        for x, y in zip(checkpoint.leaves(k1), checkpoint.leaves(k4)):
            assert [c.device for c in y.chunks] == cards[:2 * data]
            for a, b in zip(x.chunks, y.chunks):
                assert torch.equal(a.to(b.device), b)
