"""The port's serving slice end to end against the JAX package.

``repro_torch.serve.run_challenge(device="cpu")`` (plain PyTorch versions
of the kernels) against ``repro.serve.run_challenge`` (Pallas kernels in
interpret mode) on the same seeded inputs: same answer set, routes,
ladder levels, steps, width classes, columns served and launch bill.
"""

import numpy as np
import pytest
import torch

from repro.data import radixnet as jrx
from repro.serve import run_challenge as j_run_challenge
from repro_torch.data import radixnet as rx
from repro_torch.serve import SparseDNNEngine, run_challenge
from repro_torch.sparse import BlockCSRMatrix

FIELDS = ("routes", "levels", "steps", "width_classes", "served", "grid_steps", "n_inputs")


@pytest.mark.parametrize("neurons,layers,n_inputs,panel,resident", [
    (256, 6, 50, 24, None),
    (64, 3, 20, 16, False),
], ids=["256x6-fused", "64x3-layered"])
def test_run_challenge_matches_reference(neurons, layers, n_inputs, panel, resident):
    kw = dict(n_inputs=n_inputs, panel_width=panel, batch_align=8, seed=5,
              use_resident=resident)
    want = j_run_challenge(jrx.RadixNetSpec(neurons, layers), **kw)
    got = run_challenge(rx.RadixNetSpec(neurons, layers), device="cpu", **kw)
    assert np.array_equal(got.categories, want.categories)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    _, ref_cats = rx.radixnet_reference(
        rx.RadixNetSpec(neurons, layers),
        rx.radixnet_input_panel(neurons, n_inputs, density=0.3, seed=5))
    assert np.array_equal(got.categories, ref_cats)
    assert got.routes == (("fused",) if resident is None else ("layered",))
    assert got.edge_inputs_per_sec > 0


def _engine(**kw):
    ws, bs = rx.radixnet_weights(rx.RadixNetSpec(64, 3), device="cpu")
    return SparseDNNEngine(ws, bs, batch_align=8, device="cpu", **kw)


def test_engine_without_device_raises_on_a_host_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    ws, bs = rx.radixnet_weights(rx.RadixNetSpec(64, 2), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseDNNEngine(ws, bs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_challenge(rx.RadixNetSpec(64, 2), n_inputs=8)


def test_engine_step_api_splits_chunks_fifo_and_reuses_plans():
    eng = _engine()
    cols = torch.from_numpy(rx.radixnet_input_panel(64, 30, density=0.3, seed=2))
    ids = eng.submit(cols[:, :20])
    eng.submit(cols[:, 20:], request_ids=[f"r{i}" for i in range(10)])
    assert eng.staged == 30 and ids == list(range(20))
    out, st = eng.step(limit=12)
    assert out.shape == (64, 12) and st["request_ids"] == list(range(12))
    assert st["padded_batch"] == 16 and st["pad_slots"] == 4
    assert st["plan"]["route"] == "fused" and st["plan"]["level"] == "resident"
    assert st["kernel_launches"] == 1 and not st["plan"]["cache_hit"]
    out2, st2 = eng.step(limit=12, pad_to=16)
    assert st2["plan"]["cache_hit"] and st2["request_ids"][-4:] == ["r0", "r1", "r2", "r3"]
    rest = eng.drain()
    assert len(rest) == 1 and rest[0][1]["batch"] == 6 and eng.staged == 0
    assert eng.step() == (None, eng._idle_stats())
    full, _ = _engine().infer(cols)
    got = torch.cat([out, out2, rest[0][0]], dim=1)
    torch.testing.assert_close(got, full)


def test_engine_quarantines_nonfinite_columns_only():
    eng = _engine()
    cols = torch.from_numpy(rx.radixnet_input_panel(64, 6, density=0.5, seed=4))
    cols[3, 2] = float("nan")
    out, st = eng.infer(cols)
    assert st["quarantined_request_ids"] == [2]
    keep = [0, 1, 3, 4, 5]
    assert torch.isfinite(out[:, keep]).all()
    clean, _ = _engine().infer(cols[:, keep])
    torch.testing.assert_close(out[:, keep], clean)


def test_engine_layered_and_residency_rules():
    eng = _engine(use_resident=False)
    out, st = eng.infer(torch.ones(64, 5))
    assert st["plan"]["route"] == "layered" and st["kernel_launches"] == 3
    ws, bs = rx.radixnet_weights(rx.RadixNetSpec(64, 2), device="cpu")
    hetero = [BlockCSRMatrix.from_bsr(ws[0]), ws[1]]
    with pytest.raises(ValueError, match="not eligible"):
        SparseDNNEngine(hetero, bs, use_resident=True, device="cpu")
    eng = SparseDNNEngine(hetero, bs, device="cpu")
    assert eng.infer(torch.ones(64, 3))[1]["plan"]["route"] == "layered"
    with pytest.raises(RuntimeError, match="drain"):
        eng.submit(torch.ones(64, 1))
        eng.infer(torch.ones(64, 1))


def test_engine_validates_weights_at_construction():
    ws, bs = rx.radixnet_weights(rx.RadixNetSpec(64, 1), device="cpu")
    bad = ws[0].to("cpu")
    bad.blocks = bad.blocks.clone()
    bad.blocks[0, 0, 0, 0] = float("inf")
    with pytest.raises(ValueError, match="non-finite"):
        SparseDNNEngine([bad], bs, device="cpu")
