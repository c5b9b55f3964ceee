"""The sharded sparse stack's multi-card machinery, on the CPU.

A mesh of distinct cards is only a description on this host: its shape,
home device, cards and fingerprint; refusals of mixed meshes and of more
cards than the host has. The code that runs across cards runs here on an
8-position one-device mesh, where every peer copy is a slice: the
band-owner sum is held bit for bit to the shard-order sum written out,
and the forward within 1e-5 (the reference tests' tolerance) of the
reference's own 8-device ``forward8`` (a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on inputs written
to an ``.npz``). The scatter Function's backward is held bit for bit to
the card-order sum of the cards' gradients, on repeated calls.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import BlockCSRMatrix as JBCSR
from repro.sparse import BlockSparseMatrix as JBSR
from repro_torch import convert
from repro_torch import plan as PL
from repro_torch.core import dnn
from repro_torch.distribution import peer
from repro_torch.distribution.sharding import row_bands, shard_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_row_blocks_mesh
from repro_torch.serve import SparseDNNEngine
from repro_torch.sparse.partition import (
    place_shard,
    place_shard_transpose,
    shard_transpose_plan,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARDS = tuple(torch.device("cuda", i) for i in range(4))


def _stack(seed, layers, m, bpr=4, block=16):
    """(reference block-CSR stack, the port's conversion of it)."""
    ws = []
    for k in jax.random.split(jax.random.PRNGKey(seed), layers):
        w = JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr, minval=-0.5, maxval=0.5)
        ws.append(JBCSR.from_bsr(w.map_blocks(lambda x: x / (bpr * block) ** 0.5)))
    bs = [jnp.full((m,), 0.01 * i, jnp.float32) for i in range(layers)]
    return (ws, bs), ([convert.layout(w) for w in ws], [convert.bias(b) for b in bs])


def test_a_mesh_of_cards_is_a_description_here():
    cards = Mesh(("row_blocks",), (4,), CARDS)
    assert cards.shape == {"row_blocks": 4} and cards.size == 4
    assert cards.device == torch.device("cuda", 0) and cards.cards == CARDS
    assert [shard_device(cards, s) for s in range(4)] == list(CARDS)
    one = Mesh(("row_blocks",), (4,), (CARDS[0],) * 4)
    assert one.cards == (CARDS[0],) and shard_device(one, 3) == CARDS[0]
    fps = {PL.mesh_fingerprint(m) for m in (cards, one, make_row_blocks_mesh(4, device="cpu"))}
    assert len(fps) == 3
    assert PL.mesh_fingerprint(cards) == (
        "row_blocks[row_blocks=4]@devices[cuda:0,cuda:1,cuda:2,cuda:3]")


def test_mixed_meshes_and_missing_cards_are_refused():
    with pytest.raises(ValueError, match="mixing shared and distinct"):
        Mesh(("row_blocks",), (3,), (CARDS[0], CARDS[0], CARDS[1]))
    with pytest.raises(ValueError, match="multi-card mesh"):
        Mesh(("row_blocks",), (2,), (torch.device("cpu"), CARDS[1]))
    too_many = [f"cuda:{i}" for i in range(torch.cuda.device_count() + 1)]
    with pytest.raises(RuntimeError, match="this host has"):
        make_row_blocks_mesh(devices=too_many)
    with pytest.raises(ValueError, match="shards=3 but 2 devices"):
        make_row_blocks_mesh(3, devices=CARDS[:2])
    with pytest.raises(ValueError, match="not both"):
        make_row_blocks_mesh(device="cpu", devices=CARDS)
    with pytest.raises(ValueError, match="4 devices do not make a mesh of model=3"):
        make_local_mesh(model=3, devices=CARDS)
    with pytest.raises(RuntimeError, match="this host has"):
        make_local_mesh(data=1, model=len(too_many), devices=too_many)


@pytest.mark.parametrize("n_row_blocks, n_bands", [(64, 4), (64, 8), (7, 3), (2, 4), (1, 1)])
def test_the_band_map_covers_each_row_block_once(n_row_blocks, n_bands):
    bands = row_bands(n_row_blocks, n_bands)
    assert len(bands) == n_bands
    owned = [blk for a, b in bands for blk in range(a, b)]
    assert owned == list(range(n_row_blocks))
    sizes = [b - a for a, b in bands]
    assert max(sizes) - min(sizes) <= 1


def test_band_owner_sum_is_the_shard_order_sum():
    _, (ws, bs) = _stack(3, 3, 128)
    plan = PL.build_sharded_plan(ws, bs, 8, make_row_blocks_mesh(8, device="cpu"))
    assert plan.describe()["bands"] == [[a, b] for a, b in row_bands(8, 8)]
    assert plan.describe()["devices"] == ["cpu"] * 8 and plan.describe()["cards"] == 1
    y = torch.from_numpy(np.random.default_rng(0).random((128, 8), dtype=np.float32))
    want = y
    for i, b in enumerate(bs):
        parts = plan.layer_partials(i, want)
        z = parts[0]
        for part in parts[1:]:
            z = z + part
        got = plan.layer_forward(i, want)
        want = torch.relu(z + b[:, None])  # the shard-order sum before the bands
        assert torch.equal(got, want)
    assert torch.equal(plan.forward(y), want)


_REFERENCE_8 = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro.launch.mesh import make_row_blocks_mesh
    from repro.plan import build_sharded_plan
    from repro.sparse import BlockCSRMatrix

    d = np.load(sys.argv[1])
    f = ("values", "row_ptr", "row_id", "col_idx", "valid")
    L = int(d["layers"])
    ws = [BlockCSRMatrix(*(jnp.asarray(d[f"w{i}_{k}"]) for k in f),
                         tuple(int(x) for x in d[f"w{i}_shape"]),
                         tuple(int(x) for x in d[f"w{i}_block"])) for i in range(L)]
    bs = [jnp.asarray(d[f"b{i}"]) for i in range(L)]
    plan = build_sharded_plan(ws, bs, 8, make_row_blocks_mesh(8))
    np.savez(sys.argv[2], forward8=np.asarray(plan.forward(jnp.asarray(d["y0"]))))
    print("reference8 OK")
    """
)


def test_band_owner_forward_matches_the_reference_eight_device_run(tmp_path):
    (jws, jbs), (ws, bs) = _stack(0, 3, 64)
    y0 = np.random.default_rng(19).random((64, 8), dtype=np.float32)
    arrays = {"layers": np.asarray(len(jws)), "y0": y0}
    for i, (w, b) in enumerate(zip(jws, jbs)):
        for k in ("values", "row_ptr", "row_id", "col_idx", "valid"):
            arrays[f"w{i}_{k}"] = np.asarray(getattr(w, k))
        arrays[f"w{i}_shape"], arrays[f"w{i}_block"] = np.asarray(w.shape), np.asarray(
            w.block_shape)
        arrays[f"b{i}"] = np.asarray(b)
    src, dst = tmp_path / "inputs.npz", tmp_path / "reference8.npz"
    np.savez(src, **arrays)
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REFERENCE_8, str(src), str(dst)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0 and "reference8 OK" in r.stdout, r.stderr[-3000:]
    plan = PL.build_sharded_plan(ws, bs, 8, make_row_blocks_mesh(8, device="cpu"))
    np.testing.assert_allclose(plan.forward(torch.from_numpy(y0)).numpy(),
                               np.load(dst)["forward8"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_bands", [1, 3])
def test_scatter_backward_is_the_card_order_sum(n_bands):
    rng = np.random.default_rng(n_bands)
    y = torch.from_numpy(rng.standard_normal((12, 5), dtype=np.float32))
    weights = [torch.from_numpy(rng.standard_normal((12, 5), dtype=np.float32))
               for _ in range(4)]
    rows = [slice(a, b) for a, b in row_bands(12, n_bands)]
    grads = []
    for _ in range(3):
        leaf = y.clone().requires_grad_(True)
        bands = [leaf[r] * 1.0 for r in rows]
        panels = peer.spread(bands, rows, ["cpu"] * 4)
        assert all(torch.equal(p, y) for p in panels)
        sum((p * w).sum() for p, w in zip(panels, weights)).backward()
        grads.append(leaf.grad)
    want = weights[0].clone()
    for w in weights[1:]:
        want = want + w  # the card order, written out
    assert all(torch.equal(g, want) for g in grads)
    backwards = weights[3] + weights[2] + weights[1] + weights[0]
    assert not torch.equal(backwards, want)  # the order shows in the bits


def _plain_grads(ws, bs, y0, cot):
    """d/dy0 and d/db of ``<plain forward, cot>``: the unsharded plain layers."""
    leaf = y0.clone().requires_grad_(True)
    biases = [b.clone().requires_grad_(True) for b in bs]
    (dnn.dnn_forward_trainable(ws, biases, leaf, use_kernel=False) * cot).sum().backward()
    return leaf.grad, [b.grad for b in biases]


def test_the_sharded_forward_stays_differentiable():
    _, (ws, bs) = _stack(4, 3, 64)
    rng = np.random.default_rng(4)
    y0 = torch.from_numpy(rng.random((64, 8), dtype=np.float32))
    cot = torch.from_numpy(rng.standard_normal((64, 8), dtype=np.float32))
    want_y, want_b = _plain_grads(ws, bs, y0, cot)
    mesh = make_row_blocks_mesh(4, device="cpu")
    leaf = y0.clone().requires_grad_(True)
    biases = [b.clone().requires_grad_(True) for b in bs]
    (dnn.dnn_forward(ws, biases, leaf, mesh=mesh) * cot).sum().backward()
    torch.testing.assert_close(leaf.grad, want_y, rtol=1e-5, atol=1e-6)
    for got, want in zip(biases, want_b):
        torch.testing.assert_close(got.grad, want, rtol=1e-5, atol=1e-6)
    plan = PL.build_sharded_plan(ws, bs, 8, mesh)
    leaf = y0.clone().requires_grad_(True)
    (plan.layer_forward(0, leaf) * cot).sum().backward()
    assert leaf.grad is not None and bool(leaf.grad.abs().sum() > 0)


def test_the_trainable_forward_runs_the_band_path_on_one_device(monkeypatch):
    _, (ws, bs) = _stack(5, 3, 128)
    mesh = make_row_blocks_mesh(8, device="cpu")
    plan = PL.build_sharded_plan(ws, bs, 8, mesh, differentiable=True)
    spread, calls = peer.spread, []
    monkeypatch.setattr(peer, "spread", lambda bands, rows, cards: (
        calls.append(len(bands)), spread(bands, rows, cards))[1])
    rng = np.random.default_rng(5)
    y0 = torch.from_numpy(rng.random((128, 8), dtype=np.float32))
    cot = torch.from_numpy(rng.standard_normal((128, 8), dtype=np.float32))
    grads = []
    for _ in range(2):
        leaf = y0.clone().requires_grad_(True)
        out = plan.forward_trainable(ws, bs, leaf)
        (out * cot).sum().backward()
        grads.append(leaf.grad)
    assert calls == [1, 8, 8, 8] * 2  # the panel out, then the 8 bands of every layer
    assert torch.equal(out.detach(), PL.build_sharded_plan(ws, bs, 8, mesh).forward(y0))
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], _plain_grads(ws, bs, y0, cot)[0],
                               rtol=1e-5, atol=1e-6)


def test_shards_placed_on_their_own_device_stay_views():
    _, (ws, bs) = _stack(1, 1, 64)
    plan = PL.build_sharded_plan(ws, bs, 8, make_row_blocks_mesh(4, device="cpu"),
                                 differentiable=True)
    lp = plan.layers[0]
    for s, (local, tp) in enumerate(zip(lp.shards, lp.shard_transposes)):
        placed = place_shard(lp.sharded, s, "cpu")
        assert placed.row_ptr.data_ptr() == local.row_ptr.data_ptr() == lp.sharded.row_ptr[
            s].data_ptr()
        assert torch.equal(place_shard_transpose(lp.transpose, s, "cpu").order,
                           shard_transpose_plan(lp.transpose, s).order)
        assert torch.equal(tp.row_ptr, shard_transpose_plan(lp.transpose, s).row_ptr)


def test_launch_counts_split_by_card():
    kernel_ops.reset_launch_counts()
    record = kernel_ops.LaunchRecord()
    for card, k in (("cuda:0", 2), ("cuda:3", 5)):
        record.counts["bcsr_spmm"] += k
        record.by_device.setdefault(card, dict.fromkeys(kernel_ops.KERNELS, 0))["bcsr_spmm"] = k
    kernel_ops.add_replayed(record)
    kernel_ops.add_replayed(record)
    try:
        assert kernel_ops.launch_counts()["bcsr_spmm"] == 14
        assert kernel_ops.launch_counts("cuda:0")["bcsr_spmm"] == 4
        assert kernel_ops.launch_counts(CARDS[3])["bcsr_spmm"] == 10
        assert kernel_ops.launch_counts("cuda:1") == dict.fromkeys(kernel_ops.KERNELS, 0)
    finally:
        kernel_ops.reset_launch_counts()
    assert kernel_ops.launch_counts("cuda:3")["bcsr_spmm"] == 0


def test_engine_reports_the_shard_devices_and_the_ladder_home():
    _, (ws, bs) = _stack(2, 2, 64)
    engine = SparseDNNEngine(ws, bs, batch_align=8, mesh=make_row_blocks_mesh(
        4, device="cpu"), device="cpu")
    _, stats = engine.infer(torch.ones((64, 3)))
    assert stats["plan"]["devices"] == ["cpu"] * 4
    assert engine.ladder.describe()["home_device"] == "cpu"
