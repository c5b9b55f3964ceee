"""GraphBLAS ``mxm``/``mxv`` plans and the dense launch bill.

``plan.mxm`` keys a plan by (topology fingerprint, exact width,
semiring), reuses it only for the same operand object, relayouts a
wasteful ELL operand to block-CSR once, and bills both layouts; the
dense ``semiring_matmul`` bill is pinned to the grid its launch walks.
Sparse bills are compared with the reference's cost model at the port's
tile width (``DEFAULT_BLOCK_N`` 16; the reference's default is 128).
"""

import numpy as np
import torch

from repro.plan import cost as jcost
from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro_torch.core import graphblas as gb
from repro_torch.core import semiring as sr
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import semiring_matmul as ksmm
from repro_torch.kernels.ops import dense_block_sizes, effective_block_n
from repro_torch.plan import PlanKey, build_plan, cost, routes
from repro_torch.plan import mxm as pmxm
from repro_torch.sparse.bcsr import BlockCSRMatrix


def _skewed_ell():
    csr = BlockCSRMatrix.random_skewed(5, (256, 256), (16, 16), 56, skew=0.8, device="cpu")
    return csr, csr.to_bsr()


def test_plans_are_keyed_by_topology_width_and_semiring():
    _, adj = _skewed_ell()
    y = torch.ones(256, 8)
    pmxm.reset_mxm_cache()
    gb.mxm(adj, y)  # build plus_times
    gb.mxm(adj, y)  # hit
    gb.mxm(adj, y, sr.MIN_PLUS)  # another semiring: its own build
    gb.mxm(adj, torch.ones(256, 9))  # another exact width: its own build
    plan = pmxm.mxm_plan(adj, 8, "min_plus")  # hit
    assert pmxm.mxm_cache_stats() == {"lookups": 5, "hits": 2, "builds": 3, "evictions": 0}
    assert plan.key.semiring == "min_plus" and plan.key.width == 8
    assert PlanKey("f", 8, None) == PlanKey("f", 8, None, "plus_times")
    # same topology, new object (values may differ): rebuilt, not served stale
    twin = type(adj)(adj.blocks * 2, adj.col_idx, adj.block_mask, adj.shape, adj.block_shape)
    assert pmxm.mxm_plan(twin, 8).source is twin
    assert pmxm.mxm_cache_stats()["builds"] == 4
    torch.testing.assert_close(gb.mxm(twin, y), 2 * gb.mxm(adj, y))
    pmxm.reset_mxm_cache()
    assert pmxm.mxm_cache_stats()["lookups"] == 0


def test_cache_is_bounded():
    _, adj = _skewed_ell()
    pmxm.reset_mxm_cache()
    for n in range(1, pmxm._MAX_PLANS + 4):
        pmxm.mxm_plan(adj, n)
    assert pmxm.mxm_cache_stats()["evictions"] == 3
    pmxm.reset_mxm_cache()


def test_plan_relayouts_and_bills_both_layouts():
    csr, adj = _skewed_ell()
    jcsr = JBCSR.random_skewed(seed=5, shape=(256, 256), block_shape=(16, 16),
                               total_blocks=56, skew=0.8)
    plan = pmxm.mxm_plan(adj, 32)
    assert (plan.source_layout, plan.layout) == ("ell", "bcsr")
    assert plan.grid_steps == 56 * 2  # valid blocks × two 16-wide tiles
    assert plan.xla_equiv_grid_steps == cost.layer_grid_steps(adj, 32)
    assert plan.grid_steps < plan.xla_equiv_grid_steps
    assert plan.grid_steps == jcost.layer_grid_steps(jcsr, 32, block_n=DEFAULT_BLOCK_N)
    assert plan.xla_equiv_grid_steps == jcost.layer_grid_steps(
        jcsr.to_bsr(), 32, block_n=DEFAULT_BLOCK_N)
    assert pmxm.mxm_plan(csr, 32).layout == "bcsr"  # already CSR: kept


def test_mxv_bills_one_eight_wide_stripe():
    _, adj = _skewed_ell()
    assert effective_block_n(1) == 8
    plan = pmxm.mxm_plan(adj, 1)
    assert plan.grid_steps == cost.mxv_grid_steps(plan.weight) == 56
    assert cost.mxv_grid_steps(adj) == cost.layer_grid_steps(adj, 8)
    assert cost.layer_grid_steps(adj, 9) > cost.mxv_grid_steps(adj)  # 9 columns: 16-wide tile


def test_dense_bill_is_the_launch_grid():
    """kernel-dense bills (m/bm)·(n/bn)·(k/bk) at the wrapper's clamped
    tiles — the output tiles the launch's CTAs cover, times the k-steps
    each walks, whatever tile a CTA owns."""
    for m, k, n in ((1024, 1024, 512), (40, 21, 13), (8, 8, 1)):
        w = torch.zeros(m, k)
        bm, bn, bk = dense_block_sizes(m, n, k)
        pad = lambda x, b: -(-x // b) * b  # noqa: E731
        (gx, gy), (threads,) = ksmm.launch_geometry(pad(m, bm), pad(n, bn))
        tile = ksmm.tile_for(pad(n, bn))
        assert threads == tile.threads <= 256
        assert gx == -(-pad(m, bm) // tile.bm) and gy == -(-pad(n, bn) // tile.bn)
        assert cost.layer_grid_steps(w, n) == (pad(m, bm) // bm) * (pad(n, bn) // bn) * (
            pad(k, bk) // bk)
    # the reference tiles m and k at its 128-lane width, the port at 16
    assert cost.layer_grid_steps(torch.zeros(1024, 1024), 512) == 64 * 32 * 64


def test_dense_layers_route_kernel_dense():
    ws = [torch.eye(64), torch.eye(64)]
    bs = [torch.zeros(64), torch.zeros(64)]
    plan = build_plan(ws, bs, 32)
    assert plan.route == routes.ROUTE_LAYERED
    assert [lp.path for lp in plan.layers] == ["kernel-dense"] * 2
    assert [lp.layout for lp in plan.layers] == ["dense"] * 2
    assert plan.grid_steps == 2 * cost.layer_grid_steps(ws[0], 32)
    y = torch.from_numpy(np.random.default_rng(0).random((64, 20), dtype=np.float32))
    torch.testing.assert_close(plan.forward(y), y)
