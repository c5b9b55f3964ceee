"""Launch geometry of the two fused kernels, checked on the CPU.

``kernels/fused_mlp.py`` mirrors the constants of ``csrc/fused_mlp.cu``
(warps, stages, thread rows, the warp tiles, the block sizes built).
These tests hold the mirror to the source, the resident clusters and the
tiled grid to the card, the shared-memory bill to what the kernel
allocates, and the work split (block-rows over a cluster's CTAs and
warps; (block-row, column tile) items over the grid's warps) to cover
every output exactly once.
"""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.core.dnn import stack_bsr
from repro_torch.data import radixnet as rx
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import fused_mlp as kf
from repro_torch.kernels.ops import effective_block_n
from repro_torch.plan import fused_route
from repro_torch.sparse import BlockSparseMatrix

SOURCE = (Path(kf.__file__).resolve().parent.parent / "csrc" / "fused_mlp.cu").read_text()


def _stack(m, bs=16, layers=2, mbpr=2):
    nrb = m // bs
    return BlockSparseMatrix(torch.zeros(layers, nrb, mbpr, bs, bs),
                             torch.zeros(layers, nrb, mbpr, dtype=torch.int32),
                             torch.ones(layers, nrb, mbpr, dtype=torch.bool), (m, m), (bs, bs))


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_mirror_matches_the_cuda_source():
    assert _constant("kStages") == kf.STAGES
    assert _constant("kWarps") == kf.WARPS
    assert _constant("kWideBlockWarps") == kf.WIDE_BLOCK_WARPS
    assert _constant("kRows") == kf.ROWS
    found = re.findall(r"using (Resident|Tiled) = Tile<(\d+), (\d+), (true|false)>;", SOURCE)
    tiles = {name.lower(): kf.Tile(int(cn), int(tn), staged == "true")
             for name, cn, tn, staged in found}
    assert tiles == kf.TILES
    cases = tuple(int(v) for v in re.findall(r"case (\d+): return fn\(", SOURCE))
    assert cases == kf.BLOCK_SIZES
    # a tile is ROWS thread rows x cn / tn thread columns; a warp holds whole tiles
    assert (kf.TILES["resident"].lanes, kf.TILES["resident"].per_warp) == (16, 2)
    assert (kf.TILES["tiled"].lanes, kf.TILES["tiled"].per_warp) == (32, 1)
    assert kf.STRIPE == kf.TILES["resident"].cn == 8
    for bs in kf.BLOCK_SIZES:
        assert bs % kf.ROWS == 0 and bs % 4 == 0  # TM rows a lane, 16-byte block rows


# The clusters an H100 80GB HBM3 holds at once at a 184 KB CTA
# (tools/torch_fused_sweep.py): 132 of one CTA, 66 of 2, 30 of 4, 15 of 8
# (the SMs of a GPC do not split into fours evenly).
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


@pytest.mark.parametrize("n, cluster, ctas", [(16, 8, 16), (96, 8, 96), (256, 2, 64),
                                              (512, 2, 128), (528, 2, 132), (2048, 1, 256)])
def test_resident_cluster_fills_the_card(n, cluster, ctas):
    """RadiX-net 1024 (64 block-rows): 8-column stripes x cluster near 132
    SMs, every cluster in one wave (n = 256: 32 clusters of 4 would not
    fit, so 2)."""
    sw = _stack(1024)
    assert n % effective_block_n(n) == 0
    geo = kf.launch_geometry(sw, n, tiled=False, max_clusters=H100_CLUSTERS.get)
    assert (geo.cluster, geo.ctas) == (cluster, ctas)
    assert geo.ctas <= kf.H100_SMS or geo.cluster == 1
    assert geo.ctas // geo.cluster <= H100_CLUSTERS[geo.cluster] or geo.cluster == 1
    assert geo.threads == 32 * kf.WARPS == 512
    assert geo.smem_bytes == kf.fused_mlp_smem_bytes(1024)


@pytest.mark.parametrize("stripes, nrb, sms, cluster", [
    (1, 2, 132, 2), (1, 4, 132, 4), (1, 64, 132, 8), (32, 64, 132, 4), (33, 64, 132, 4),
    (34, 64, 132, 2), (66, 64, 132, 2), (67, 64, 132, 1), (500, 64, 132, 1), (8, 64, 114, 8),
    (32, 64, 114, 2),
])
def test_cluster_size_rule(stripes, nrb, sms, cluster):
    assert kf.cluster_size(stripes, nrb, sms) == cluster
    # a card that holds fewer clusters halves the size until they fit in one wave
    few = kf.cluster_size(stripes, nrb, sms, max_clusters=lambda c: sms // (2 * c))
    assert few <= cluster and (few == 1 or stripes <= sms // (2 * few))


@pytest.mark.parametrize("sms, per_sm", [(132, 1), (132, 2), (114, 1)])
@pytest.mark.parametrize("bs", kf.BLOCK_SIZES)
def test_tiled_grid_is_the_co_resident_grid(bs, sms, per_sm):
    sw = _stack(64 * bs, bs=bs)
    geo = kf.launch_geometry(sw, 512, tiled=True, sms=sms, blocks_per_sm=per_sm)
    assert geo.ctas == sms * per_sm and geo.cluster == 1
    assert geo.threads == 32 * kf.warps(bs) <= 1024
    assert geo.smem_bytes == kf.ring_bytes(bs, kf.TILES["tiled"]) <= kf.SMEM_LIMIT_BYTES
    bf16 = kf.launch_geometry(sw, 512, tiled=True, panel_dtype="bfloat16")
    assert bf16.smem_bytes == kf.ring_bytes(bs, kf.TILES["tiled"], "bfloat16") < geo.smem_bytes


@pytest.mark.parametrize("panel_dtype, itemsize", [(None, 4), ("bfloat16", 2)])
@pytest.mark.parametrize("bs", kf.BLOCK_SIZES)
@pytest.mark.parametrize("block_n", [8, 16])
def test_smem_bill_is_panel_pair_plus_rings(block_n, bs, panel_dtype, itemsize):
    warps = 16 if bs <= 16 else 4
    ring = warps * 2 * 3 * bs * (bs + 4) * 4  # two tiles a warp, three stages a tile
    eligible = []
    for m in range(bs, 8192 + 1, bs):
        want = 2 * m * 8 * itemsize + ring  # the (2, m, 8) panel, whatever block_n
        assert kf.fused_mlp_smem_bytes(m, panel_dtype, bs) == want
        if kf.fused_mlp_eligible(_stack(m, bs, layers=1, mbpr=1), block_n,
                                 panel_dtype=panel_dtype):
            assert want <= kf.SMEM_LIMIT_BYTES
            eligible.append(m)
        else:
            assert want > kf.SMEM_LIMIT_BYTES
    assert eligible and eligible == list(range(bs, eligible[-1] + 1, bs))


@pytest.mark.parametrize("neurons, resident", [(1024, True), (4096, False), (16384, False),
                                               (65536, False)])
def test_challenge_stacks_at_the_default_tile(neurons, resident):
    sw = _stack(neurons, layers=1, mbpr=1)
    assert DEFAULT_BLOCK_N == 16
    assert kf.fused_mlp_eligible(sw) == resident
    assert kf.fused_mlp_tiled_eligible(sw)


@pytest.mark.parametrize("bs", [12, 64])
def test_unbuilt_block_sizes_are_not_eligible(bs):
    """Block sizes the kernels are not built for have no fused route (the
    reference would route them fused-tiled): the plan serves them layered."""
    sw = _stack(4 * bs, bs=bs, layers=1, mbpr=1)
    assert not kf.fused_mlp_eligible(sw) and not kf.fused_mlp_tiled_eligible(sw)
    layer = BlockSparseMatrix(sw.blocks[0], sw.col_idx[0], sw.block_mask[0], sw.shape,
                              sw.block_shape)
    assert fused_route([layer, layer]) is None


@pytest.mark.parametrize("nrb, cluster, warps", [(64, 2, 16), (64, 8, 16), (6, 8, 16),
                                                 (1024, 1, 16), (130, 2, 4), (65, 2, 16)])
def test_resident_split_covers_every_block_row_once(nrb, cluster, warps):
    """Tile ``g = 2w + h`` (half-warp h of warp w) of CTA ``rank`` folds
    block-rows rank + cluster·(g + 2·warps·j), as the kernel's loop walks
    them: a warp's loop runs while its first tile has a row."""
    tpw = kf.TILES["resident"].per_warp
    seen = []
    for rank in range(cluster):
        for w in range(warps):
            for i0 in range(rank + cluster * w * tpw, nrb, cluster * warps * tpw):
                seen += [i for i in (i0 + cluster * h for h in range(tpw)) if i < nrb]
    assert sorted(seen) == list(range(nrb))


@pytest.mark.parametrize("n", [8, 16, 40, 96, 512, 520])
@pytest.mark.parametrize("nrb, ctas, warps", [(64, 132, 16), (1024, 132, 16), (3, 2, 4)])
def test_tiled_items_cover_every_tile_once(nrb, ctas, warps, n):
    """Warp ``g`` of the grid folds items g, g + ctas·warps, ... of
    nrb × ⌈n / 32⌉; a lane's 4 columns lie wholly inside n or past it."""
    tile = kf.TILES["tiled"]
    n_ct = -(-n // tile.cn)
    seen = [item for g in range(ctas * warps) for item in range(g, nrb * n_ct, ctas * warps)]
    assert sorted(seen) == list(range(nrb * n_ct))
    assert n % 8 == 0  # the wrappers pad to block_n 8 or 16
    for c0 in range(0, n_ct * tile.cn, tile.cn):
        for tx in range(8):
            col = c0 + tx * tile.tn
            assert col + tile.tn <= n or col >= n


def test_launch_geometry_of_the_radixnet_stack():
    w, _ = rx.radixnet_weights(rx.RadixNetSpec(1024, 2), device="cpu")
    sw = stack_bsr(w)
    geo = kf.launch_geometry(sw, 512, tiled=False)
    assert geo == kf.Geometry(ctas=128, cluster=2, threads=512,
                              smem_bytes=2 * 1024 * 8 * 4 + 16 * 2 * 3 * 16 * 20 * 4)
    assert kf.grid_steps(sw, 512) == 2 * 64 * 32 * 32


def test_launcher_refuses_what_the_kernels_do_not_take():
    """Checked before any library is built, so this runs without a GPU."""
    def call(sw, n, **kw):
        m = sw.shape[0]
        kf.fused_mlp_cuda(sw, torch.zeros(sw.col_idx.shape[0], m), torch.ones(m, n),
                          tiled=kw.pop("tiled", False), **kw)

    with pytest.raises(ValueError, match="block size"):
        call(_stack(48, bs=12), 16, block_n=16)
    with pytest.raises(ValueError, match="block_n 8 or 16"):
        call(_stack(64), 8, block_n=4, tiled=True)
    with pytest.raises(ValueError, match="shared memory"):
        call(_stack(4096), 16, block_n=16)
