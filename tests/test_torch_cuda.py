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
