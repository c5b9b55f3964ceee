"""The port's plans: routes at its own shared-memory boundary, the layout
choice, the launch bill against the launch geometry, the plan cache and
the degradation ladder."""

import numpy as np
import pytest
import torch

import repro.plan as JP
from repro.data import radixnet as jrx
from repro_torch import plan as P
from repro_torch.core.dnn import stack_bsr
from repro_torch.data import radixnet as rx
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import bcsr_spmm as kbcsr
from repro_torch.kernels import bsr_spmm as kbsr
from repro_torch.kernels import fused_mlp as kfused
from repro_torch.kernels.ops import effective_block_n
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix


def _square_stack(m, bs=16, layers=2, mbpr=2):
    """A homogeneous square ELL stack of height m (values irrelevant)."""
    nrb = m // bs
    w = BlockSparseMatrix(
        torch.zeros(nrb, mbpr, bs, bs),
        torch.zeros(nrb, mbpr, dtype=torch.int32),
        torch.zeros(nrb, mbpr, dtype=torch.bool),
        (m, m),
        (bs, bs),
    )
    return [w] * layers


@pytest.mark.parametrize("neurons,route", [
    (1024, P.ROUTE_FUSED),
    (4096, P.ROUTE_FUSED_TILED),
    (16384, P.ROUTE_FUSED_TILED),
])
def test_challenge_sizes_route_at_the_shared_memory_budget(neurons, route):
    ws, _ = rx.radixnet_weights(rx.RadixNetSpec(neurons, 2), device="cpu")
    assert DEFAULT_BLOCK_N == 16
    assert P.fused_route(ws) == route
    assert P.resident_eligible(ws) == (route == P.ROUTE_FUSED)


def test_resident_boundary_is_exact():
    limit = kfused.SMEM_LIMIT_BYTES
    assert limit == 227 * 1024
    last = (limit // (2 * DEFAULT_BLOCK_N * 4)) // 16 * 16  # last resident m, f32
    assert kfused.fused_mlp_smem_bytes(last) <= limit < kfused.fused_mlp_smem_bytes(last + 16)
    assert P.fused_route(_square_stack(last)) == P.ROUTE_FUSED
    assert P.fused_route(_square_stack(last + 16)) == P.ROUTE_FUSED_TILED
    # bf16 panels halve the bill and move the boundary
    assert P.fused_route(_square_stack(2 * last), panel_dtype="bfloat16") == P.ROUTE_FUSED
    assert kfused.fused_mlp_smem_bytes(1024) == 2 * 1024 * 16 * 4  # 128 KB
    # non-square or heterogeneous stacks have no fused route
    rect = BlockSparseMatrix(torch.zeros(2, 1, 16, 16), torch.zeros(2, 1, dtype=torch.int32),
                             torch.ones(2, 1, dtype=torch.bool), (32, 48), (16, 16))
    assert P.fused_route([rect]) is None
    assert P.fused_route(_square_stack(64, mbpr=2)[:1] + _square_stack(64, mbpr=3)[:1]) is None


@pytest.mark.parametrize("neurons", [256, 1024])
def test_layered_plan_relayouts_the_stride1_phase_like_the_reference(neurons):
    """The stride-1 phase uses 2 of 32 ELL slots at block 16 — past the
    ELL waste threshold, so it runs block-CSR; the other phases stay ELL."""
    spec = rx.RadixNetSpec(neurons, rx.num_phases(neurons) + 1)
    ws, bs = rx.radixnet_weights(spec, device="cpu")
    plan = P.build_plan(ws, bs, 32, use_resident=False)
    jws, jbs = jrx.radixnet_weights(jrx.RadixNetSpec(neurons, spec.layers))
    jplan = JP.build_plan(jws, jbs, 32, use_resident=False)
    assert plan.route == jplan.route == P.ROUTE_LAYERED
    assert plan.layouts == jplan.layouts
    assert plan.layouts[0] == "bcsr" and "ell" in plan.layouts
    assert [lp.path for lp in plan.layers] == [lp.path for lp in jplan.layers]
    # one relayout per distinct layer object
    phases = rx.num_phases(neurons)
    assert plan.weights[0] is plan.weights[phases]
    assert P.preferred_layout(ws[0]) == "bcsr"


@pytest.mark.parametrize("n", [1, 8, 24, 512, 700])
def test_cost_bills_the_launch_geometry(n):
    """plan.cost bills exactly the block products the launches walk: the
    grid the kernel modules launch, times the slots each CTA visits."""
    ws, _ = rx.radixnet_weights(rx.RadixNetSpec(1024, 2), device="cpu")
    ell, csr = ws[1], BlockCSRMatrix.from_bsr(ws[0])
    bn = effective_block_n(n)
    n_pad = -(-n // bn) * bn
    (gx, gy), (bx, by) = kbsr.launch_geometry(ell, n_pad, bn)
    assert (bx, by) == (bn, 16) and bx * by <= 1024
    assert P.layer_grid_steps(ell, n) == gx * gy * ell.max_blocks_per_row
    (gx, gy), _ = kbcsr.launch_geometry(csr, n_pad, bn)
    row_slots = (csr.row_ptr[1:] - csr.row_ptr[:-1]).tolist()
    assert gx == len(row_slots)
    assert P.layer_grid_steps(csr, n) == sum(row_slots) * gy
    stacked = stack_bsr(ws)
    (g,), _ = kfused.launch_geometry(n_pad, bn)
    assert kfused.grid_steps(stacked, n, bn) == g * 2 * 64 * 32 == P.stack_grid_steps(ws, n)
    # the ELL and (unpadded) CSR bills equal the reference's at the same tile
    jws, _ = jrx.radixnet_weights(jrx.RadixNetSpec(1024, 2))
    jcsr = JP.to_preferred_layout(jws[0])
    assert P.layer_grid_steps(ell, n) == JP.layer_grid_steps(jws[1], n, block_n=DEFAULT_BLOCK_N)
    assert P.layer_grid_steps(csr, n) == JP.layer_grid_steps(jcsr, n, block_n=DEFAULT_BLOCK_N)


def test_bcsr_bill_skips_tail_padding():
    ws, _ = rx.radixnet_weights(rx.RadixNetSpec(64, 1), device="cpu")
    tight = BlockCSRMatrix.from_bsr(ws[0])
    padded = BlockCSRMatrix.from_bsr(ws[0], pad_to=tight.total_blocks + 5)
    assert P.layer_grid_steps(padded, 32) == P.layer_grid_steps(tight, 32)


def test_plan_cache_hits_and_shares_fused_stack_across_widths():
    ws, bs = rx.radixnet_weights(rx.RadixNetSpec(64, 3), device="cpu")
    cache = P.PlanCache(max_size=2)
    p32 = cache.get(ws, bs, 32)
    assert cache.get(ws, bs, 32) is p32 and cache.hits == 1
    p64 = cache.get(ws, bs, 64)
    assert p64.stacked is p32.stacked  # donor: one weight stack per topology
    assert p64.route == P.ROUTE_FUSED and p64.grid_steps == 2 * p32.grid_steps
    cache.get(ws, bs, 16)
    assert cache.evictions == 1 and len(cache) == 2
    # same topology, other bias objects: rebuild, never stale numbers
    other = [b.clone() for b in bs]
    assert cache.get(ws, other, 16) is not cache.get(ws, bs, 16)
    assert P.topology_fingerprint(ws) == P.topology_fingerprint(
        rx.radixnet_weights(rx.RadixNetSpec(64, 3), device="cpu")[0])


def test_plan_forward_pads_to_width_and_rejects_wider_panels():
    ws, bs = rx.radixnet_weights(rx.RadixNetSpec(64, 3), device="cpu")
    y0 = torch.from_numpy(rx.radixnet_input_panel(64, 10, density=0.3, seed=1))
    fused = P.build_plan(ws, bs, 16)
    layered = P.build_plan(ws, bs, 16, use_resident=False)
    a, b = fused.forward(y0), layered.forward(y0)
    assert a.shape == b.shape == (64, 10)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    assert fused.kernel_launches == 1 and layered.kernel_launches == 3
    with pytest.raises(ValueError, match="exceeds"):
        fused.forward(torch.zeros(64, 17))
    with pytest.raises(ValueError, match="not eligible"):
        P.build_plan([BlockCSRMatrix.from_bsr(ws[0])], bs[:1], 16, use_resident=True)


def test_ladder_demotes_a_failing_resident_level():
    ws, bs = rx.radixnet_weights(rx.RadixNetSpec(64, 2), device="cpu")
    hetero = [BlockCSRMatrix.from_bsr(ws[0]), ws[1]]  # no fused route
    ladder = P.DegradationLadder(P.PlanCache(), use_resident=True)
    assert ladder.preferred_level == P.LEVEL_RESIDENT and ladder.demotion is None
    plan, level, hit = ladder.get_plan(hetero, bs, 16)
    assert level == P.LEVEL_LAYERED and plan.route == P.ROUTE_LAYERED and not hit
    assert "ValueError" in ladder.demotion
    # the demotion sticks: an eligible stack is served layered from now on
    plan, level, hit = ladder.get_plan(ws, bs, 16)
    assert level == P.LEVEL_LAYERED and plan.route == P.ROUTE_LAYERED
    # the floor's own failure propagates
    with pytest.raises(ValueError):
        ladder.get_plan(hetero, bs[:1], 16)


def test_quantize_width_matches_reference():
    for n in (1, 8, 9, 100, 512, 513, 2000):
        assert P.quantize_width(n, P.DEFAULT_WIDTH_CLASSES) == JP.quantize_width(
            n, JP.DEFAULT_WIDTH_CLASSES)
    assert P.quantize_width(77) == 77
    assert np.all(np.diff(P.DEFAULT_WIDTH_CLASSES) > 0)
