"""Launch geometry of the dense and ELL kernels, checked on the CPU.

``kernels/semiring_matmul.py`` and ``kernels/bsr_spmm.py`` mirror the tile
constants of ``csrc/semiring_matmul.cu`` and ``csrc/bsr_spmm.cu`` in
``TILES``. These tests hold the mirrors to the sources and the launches
to the kernels' limits: the CTAs cover the output exactly, a CTA has at
most 1024 threads (and no more than the kernel's launch bounds), its
dynamic shared memory fits the 227 KB a Hopper block can hold, panels of
at most 16 columns run the narrow tile, and the bill counts block
products in ``DEFAULT_BLOCK_N``-wide tiles whatever width a CTA covers.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import bsr_spmm as kbsr
from repro_torch.kernels import semiring_matmul as ksmm
from repro_torch.kernels.fused_mlp import SMEM_LIMIT_BYTES
from repro_torch.kernels.ops import dense_block_sizes, effective_block_n
from repro_torch.plan import cost
from repro_torch.sparse import BlockSparseMatrix

CSRC = Path(ksmm.__file__).resolve().parent.parent / "csrc"
NS = (1, 7, 8, 9, 16, 17, 37, 64, 128, 200, 512, 700, 1000)


def _pad(x: int, b: int) -> int:
    return -(-x // b) * b


def _cu_tiles(source: str) -> dict[str, tuple[int, ...]]:
    """``using Wide = Tile<...>;`` and ``using Narrow = ...`` of a source."""
    text = (CSRC / source).read_text()
    found = re.findall(r"using (Wide|Narrow) = Tile<([\d, ]+)>;", text)
    return {name.lower(): tuple(int(v) for v in args.split(",")) for name, args in found}


def test_tile_mirrors_match_the_cuda_sources():
    dense = {name: (t.bm, t.bn, t.bk, t.tm, t.tn, t.stages) for name, t in ksmm.TILES.items()}
    assert _cu_tiles("semiring_matmul.cu") == dense
    ell = {name: (t.cn, t.tm, t.tn, t.stages) for name, t in kbsr.TILES.items()}
    assert _cu_tiles("bsr_spmm.cu") == ell
    assert [t.id for t in ksmm.TILES.values()] == [t.id for t in kbsr.TILES.values()] == [0, 1]
    text = (CSRC / "bsr_spmm.cu").read_text()
    assert f"constexpr int kMaxThreads = {kbsr.MAX_THREADS};" in text


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m, k", [(1, 1), (8, 8), (40, 21), (80, 48), (1000, 300), (1024, 1024)])
def test_dense_geometry_covers_the_output(m, k, n):
    bm, bn, bk = dense_block_sizes(m, n, k)
    mp, np_, kp = _pad(m, bm), _pad(n, bn), _pad(k, bk)
    (gx, gy), (threads,) = ksmm.launch_geometry(mp, np_)
    tile = ksmm.tile_for(np_)
    assert (tile is ksmm.TILES["narrow"]) == (np_ <= 16)
    assert (gx - 1) * tile.bm < mp <= gx * tile.bm
    assert (gy - 1) * tile.bn < np_ <= gy * tile.bn
    assert threads == tile.threads <= 1024
    assert tile.smem_bytes <= SMEM_LIMIT_BYTES
    # the wrapper's pads keep 16-byte rows for the copies
    assert np_ % 4 == 0 and kp % 4 == 0
    # the bill: the wrapper's bm × bn output tiles the CTAs cover, times
    # the k-steps of each (a CTA covers whole tiles or parts of one)
    covered = sum(min(tile.bm, mp - i * tile.bm) * min(tile.bn, np_ - j * tile.bn)
                  for i in range(gx) for j in range(gy))
    assert covered == mp * np_
    bill = cost.layer_grid_steps(torch.zeros(m, k), n)
    assert bill == covered // (bm * bn) * (kp // bk)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("bs", [(4, 4), (8, 8), (16, 16), (32, 32), (16, 8), (8, 16)])
def test_ell_geometry_covers_the_output(bs, n):
    bs_r, bs_c = bs
    nrb, mbpr = 6, 3
    a = BlockSparseMatrix(torch.zeros(nrb, mbpr, bs_r, bs_c),
                          torch.zeros(nrb, mbpr, dtype=torch.int32),
                          torch.ones(nrb, mbpr, dtype=torch.bool), (nrb * bs_r, 4 * bs_c), bs)
    bn = effective_block_n(n)
    np_ = _pad(n, bn)
    (gx, gy), (threads,) = kbsr.launch_geometry(a, np_)
    tile = kbsr.tile_for(np_)
    assert (tile is kbsr.TILES["narrow"]) == (np_ <= 16)
    assert gx == nrb and (gy - 1) * tile.cn < np_ <= gy * tile.cn
    assert threads == tile.threads(bs_r) <= kbsr.MAX_THREADS <= 1024
    assert -(-bs_r // tile.tm) * tile.tm >= bs_r  # the thread rows cover the block rows
    assert tile.smem_bytes(bs_r, bs_c) <= SMEM_LIMIT_BYTES
    # the bill: every CTA folds every slot of its block-row for the bn-wide
    # tiles it covers
    covered = sum(min(tile.cn, np_ - j * tile.cn) for j in range(gy))
    assert covered == np_
    assert kbsr.grid_steps(a, n, bn) == gx * mbpr * covered // bn
    if np_ % tile.cn == 0 and tile.cn % DEFAULT_BLOCK_N == 0:
        assert kbsr.grid_steps(a, n, bn) == gx * gy * mbpr * (tile.cn // DEFAULT_BLOCK_N)


def test_ell_bill_at_the_serving_shape():
    """RadiX-net 1024, stride-32 layer, 512-column panel: 64 × 4 CTAs of
    128 columns, each folding 32 slots for 8 sixteen-wide tiles."""
    a = BlockSparseMatrix(torch.zeros(64, 32, 16, 16), torch.zeros(64, 32, dtype=torch.int32),
                          torch.ones(64, 32, dtype=torch.bool), (1024, 1024), (16, 16))
    (gx, gy), (threads,) = kbsr.launch_geometry(a, 512)
    assert (gx, gy, threads) == (64, 4, 128)
    assert kbsr.grid_steps(a, 512) == 64 * 4 * 32 * (128 // 16) == 64 * 32 * 32
    (gx, gy), (threads,) = ksmm.launch_geometry(1024, 512)
    assert (gx, gy, threads) == (16, 8, 256)  # 128 CTAs on the card's 132 SMs


def test_launchers_refuse_what_the_kernels_cannot_take():
    """Checked before any library is built, so this runs without a GPU."""
    rng = np.random.default_rng(0)

    def ell(bs_r, bs_c):
        d = rng.random((2 * bs_r, 2 * bs_c), dtype=np.float32)
        return BlockSparseMatrix.from_dense(d, (bs_r, bs_c))

    def call(a, n):
        y = torch.ones(a.shape[1], n)
        return kbsr.bsr_spmm_cuda(a, y, torch.zeros(a.shape[0]), fuse_bias_relu=False)

    with pytest.raises(ValueError, match="multiples of 4"):
        call(ell(8, 6), 32)
    with pytest.raises(ValueError, match="threads"):
        call(ell(128, 8), 32)  # 32 thread rows x 32 columns of threads
    with pytest.raises(ValueError, match="shared memory"):
        call(ell(32, 256), 32)
    with pytest.raises(ValueError, match="n and k multiples of 4"):
        ksmm.semiring_matmul_cuda(torch.ones(8, 8), torch.ones(8, 6), torch.zeros(8),
                                  fuse_bias_relu=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.ones(8 * 8 + 1)
        ksmm.semiring_matmul_cuda(flat[1:].view(8, 8), torch.ones(8, 8), torch.zeros(8),
                                  fuse_bias_relu=False)
