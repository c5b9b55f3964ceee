"""The port's checkpoints, supervisor and resilient training against the
reference's.

Every case of the reference's ``tests/test_train_resilience.py`` and
``tests/test_fault_tolerance.py`` runs on the port, with the reference's
states (``jax.random`` layouts converted through numpy) and batches (its
``jax.random`` panels, per step, converted the same way); where a case
trains, the port's losses are held to the reference's within the
training slice's tolerance (``rtol=1e-5``), and its own replays to its
unfailed run bit for bit. Then checkpoint interchange: a checkpoint the
reference writes is restored by the port and one the port writes by the
reference, with equal keys, dtypes and values, for SGD and AdamW states.
"""

import dataclasses
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import BlockCSRMatrix as JBCSR
from repro.sparse import BlockSparseMatrix as JBSR
from repro.testing import FaultInjector as JFaultInjector
from repro.train import checkpoint as jcheckpoint
from repro.train.optimizer import adamw as jadamw
from repro.train.optimizer import sgd as jsgd
from repro.train.resilience import run_resilient_training as jrun
from repro.train.sparse import init_sparse_mlp_state as jinit
from repro_torch import convert
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix
from repro_torch.testing import SITE_TRAIN_NAN_LOSS, FaultInjector
from repro_torch.train import (
    NonFiniteLossError,
    StragglerPolicy,
    Supervisor,
    checkpoint,
    run_resilient_training,
    validate_sparse_state,
)
from repro_torch.train.optimizer import adamw, sgd
from repro_torch.train.sparse import SparseMLPState, init_sparse_mlp_state

LOSS_RTOL = 1e-5


def _jlayers(seed, m=32, block=8, bpr=2):
    kw = dict(blocks_per_row=bpr, minval=-0.5, maxval=0.5)
    return [JBSR.random(jax.random.PRNGKey(seed), (m, m), (block, block), **kw),
            JBCSR.from_bsr(JBSR.random(jax.random.PRNGKey(seed + 1), (m, m), (block, block),
                                       **kw))]


def _state(seed=0, m=32, opt=None):
    """The reference tests' ``_state`` on both packages: (port, reference, m)."""
    jws = _jlayers(seed, m)
    jbs = [jnp.zeros((m,), jnp.float32) for _ in jws]
    popt, jopt = opt or (_opt(), _jopt())
    port = init_sparse_mlp_state([convert.layout(w) for w in jws],
                                 [convert.bias(b) for b in jbs], popt)
    return port, jinit(jws, jbs, jopt), m


def _opt():
    return sgd(0.5, momentum=0.0)


def _jopt():
    return jsgd(0.5, momentum=0.0)


def _jbatch_fn(m):
    def fn(step):
        y0 = jax.random.uniform(jax.random.PRNGKey(1000 + step), (m, 8), jnp.float32)
        return {"y0": y0, "targets": 0.3 * y0}

    return fn


def _batch_fn(m):
    """The reference's batches, deterministic in ``step``, as torch tensors."""
    jfn = _jbatch_fn(m)

    def fn(step):
        return {k: torch.from_numpy(np.array(v)) for k, v in jfn(step).items()}

    return fn


def _leaves(state) -> dict:
    return checkpoint._flatten(state)


def _assert_same_state(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


def _close_losses(port: dict, ref: dict):
    assert sorted(port) == sorted(ref)
    np.testing.assert_allclose([port[s] for s in sorted(port)], [ref[s] for s in sorted(ref)],
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------------------
# tests/test_train_resilience.py
# ---------------------------------------------------------------------


def test_sparse_state_checkpoints_exactly():
    """ELL and block-CSR layouts round-trip bit for bit: f32 values exact,
    integer and bool topology dtypes kept, under the reference's keys."""
    state, jstate, _ = _state()
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 7, state)
        restored, manifest = checkpoint.restore(d, state)
        assert manifest["step"] == 7
        _assert_same_state(state, restored)
        assert manifest["keys"] == sorted(jcheckpoint._flatten(jstate))
        validate_sparse_state(restored)
        assert isinstance(restored.weights[1], BlockCSRMatrix)
        assert isinstance(restored.weights[0], BlockSparseMatrix)
        assert restored.weights[1].row_ptr.dtype == torch.int32
        assert restored.weights[0].block_mask.dtype == torch.bool


def test_validate_sparse_state_catches_corruption():
    state, _, _ = _state()
    bad_col = state.weights[1].col_idx.clone()
    bad_col[0] = 10_000
    bad = SparseMLPState((state.weights[0], dataclasses.replace(state.weights[1],
                                                                col_idx=bad_col)),
                         state.biases, state.opt)
    with pytest.raises(ValueError, match="layer 1"):
        validate_sparse_state(bad)
    nan_bias = state.biases[0].clone()
    nan_bias[0] = float("nan")
    with pytest.raises(ValueError, match="bias"):
        validate_sparse_state(SparseMLPState(state.weights, (nan_bias, state.biases[1]),
                                             state.opt))


def test_nan_loss_restores_and_skips():
    state, jstate, m = _state(seed=2)
    inj, jinj = FaultInjector(), JFaultInjector()
    inj.schedule(SITE_TRAIN_NAN_LOSS, 3)
    jinj.schedule(SITE_TRAIN_NAN_LOSS, 3)
    with tempfile.TemporaryDirectory() as d:
        final, report = run_resilient_training(
            state, _batch_fn(m), _opt(), 6, d, ckpt_interval=2, use_kernel=False,
            fault_injector=inj, device="cpu")
        _, jreport = jrun(jstate, _jbatch_fn(m), _jopt(), 6, os.path.join(d, "ref"),
                          ckpt_interval=2, use_kernel=False, fault_injector=jinj)
        assert report["skipped"] == jreport["skipped"] == [3]
        assert len(report["restarts"]) == 1
        assert report["restarts"][0][1] == "fault: NonFiniteLossError"
        assert sorted(report["losses"]) == [0, 1, 2, 3, 4, 5]
        assert all(np.isfinite(v) for v in report["losses"].values())
        _close_losses(report["losses"], jreport["losses"])
        clean, clean_report = run_resilient_training(
            _state(seed=2)[0], _batch_fn(m), _opt(), 6, os.path.join(d, "clean"),
            ckpt_interval=2, use_kernel=False, device="cpu")
        _assert_same_state(final, clean)
        assert clean_report["losses"] == report["losses"]


def test_kill_and_resume_replays_bit_identical_losses():
    state, _, m = _state(seed=3)
    with tempfile.TemporaryDirectory() as d:
        _, ref = run_resilient_training(
            _state(seed=3)[0], _batch_fn(m), _opt(), 8, os.path.join(d, "ref"),
            ckpt_interval=2, use_kernel=False, device="cpu")
        run_a = os.path.join(d, "killed")
        _, part = run_resilient_training(state, _batch_fn(m), _opt(), 5, run_a,
                                         ckpt_interval=2, use_kernel=False, device="cpu")
        assert checkpoint.latest_step(run_a) == 5  # the final step's save
        # resumed from the directory with a FRESH initial state: the
        # checkpoint, not the caller's tensors, carries the run
        _, rest = run_resilient_training(_state(seed=3)[0], _batch_fn(m), _opt(), 8, run_a,
                                         ckpt_interval=2, use_kernel=False, device="cpu")
        assert rest["start_step"] == 5
        assert {**part["losses"], **rest["losses"]} == ref["losses"]  # bit-identical
        _, jref = jrun(_state(seed=3)[1], _jbatch_fn(m), _jopt(), 8,
                       os.path.join(d, "jref"), ckpt_interval=2, use_kernel=False)
        _close_losses(ref["losses"], jref["losses"])


def test_resilient_training_with_kernels_in_path():
    """The kernel wrappers (their plain versions on the CPU) and their
    autograd Functions survive the same restore path, through a
    differentiable plan, replaying the unfailed run's losses exactly."""
    from repro_torch.plan import build_plan

    state, jstate, m = _state(seed=4)
    plan = build_plan(state.weights, state.biases, 8, differentiable=True)
    inj = FaultInjector()
    inj.schedule(SITE_TRAIN_NAN_LOSS, 1)
    with tempfile.TemporaryDirectory() as d:
        _, report = run_resilient_training(state, _batch_fn(m), _opt(), 3, d, ckpt_interval=1,
                                           use_kernel=True, plan=plan, fault_injector=inj,
                                           device="cpu")
        assert report["skipped"] == [1]
        assert sorted(report["losses"]) == [0, 1, 2]
        assert all(np.isfinite(v) for v in report["losses"].values())
        _, clean = run_resilient_training(_state(seed=4)[0], _batch_fn(m), _opt(), 3,
                                          os.path.join(d, "clean"), ckpt_interval=1,
                                          use_kernel=True, plan=plan, device="cpu")
        assert clean["losses"] == report["losses"]
        _, jreport = jrun(jstate, _jbatch_fn(m), _jopt(), 3, os.path.join(d, "ref"),
                          ckpt_interval=1, use_kernel=False)
        _close_losses(report["losses"], jreport["losses"])


def test_restore_validation_rejects_corrupt_checkpoint():
    state, _, m = _state(seed=5)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 2, state)
        path = os.path.join(d, "step_00000002", "arrays.npz")
        arrays = dict(np.load(path))
        arrays["biases//0"] = np.full_like(arrays["biases//0"], np.nan)
        np.savez(path, **arrays)
        with pytest.raises(ValueError, match="restored SparseMLPState"):
            run_resilient_training(state, _batch_fn(m), _opt(), 4, d, use_kernel=False,
                                   device="cpu")


def test_a_non_finite_loss_is_the_error_the_supervisor_restores_from():
    state, _, m = _state(seed=6)
    inj = FaultInjector()
    for _ in range(2):
        inj.schedule(SITE_TRAIN_NAN_LOSS, 0)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="exceeded 0 restarts") as err:
            run_resilient_training(state, _batch_fn(m), _opt(), 2, d, use_kernel=False,
                                   fault_injector=inj, max_restarts=0, device="cpu")
        assert isinstance(err.value.__cause__, NonFiniteLossError)


# ---------------------------------------------------------------------
# tests/test_fault_tolerance.py
# ---------------------------------------------------------------------


def test_straggler_warmup_never_fires():
    p = StragglerPolicy(deadline_factor=2.0, evict_after=1)
    assert p.observe(1.0) is False
    assert p.observe(1000.0) is False
    assert p.observe(1000.0) is False


def test_straggler_consecutive_resets_on_fast_step():
    p = StragglerPolicy(deadline_factor=2.0, evict_after=2)
    for _ in range(6):
        p.observe(1.0)
    assert p.observe(10.0) is False
    assert p.observe(1.0) is False
    assert p.observe(10.0) is False
    assert p.observe(10.0) is True


def test_straggler_window_eviction_shifts_median():
    p = StragglerPolicy(deadline_factor=2.0, evict_after=1, window=4)
    for _ in range(4):
        p.observe(1.0)
    assert p.observe(10.0) is True
    for _ in range(4):
        p.observe(10.0)
    assert p.observe(10.0) is False


def test_straggler_evict_after_one_fires_immediately():
    p = StragglerPolicy(deadline_factor=3.0, evict_after=1)
    for _ in range(4):
        p.observe(1.0)
    assert p.observe(3.01) is True


def _counting_supervisor(d, fail_at, *, ckpt_interval=2, max_restarts=3):
    calls = []

    def step_fn(state, step):
        calls.append(step)
        if step == fail_at and calls.count(step) == 1:
            raise RuntimeError("boom")
        return {"x": state["x"] + 1.0}

    sup = Supervisor(step_fn=step_fn, save_state=lambda s: s, load_state=lambda s: s,
                     ckpt_dir=d, ckpt_interval=ckpt_interval, max_restarts=max_restarts)
    return sup, calls


def test_supervisor_replays_from_manifest_step():
    with tempfile.TemporaryDirectory() as d:
        state = {"x": torch.zeros(())}
        checkpoint.save(d, 0, state)
        sup, calls = _counting_supervisor(d, fail_at=5)
        out = sup.run(state, 8)
        assert float(out["x"]) == 8.0
        assert calls == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
        assert sup.history == [(5, "fault: RuntimeError")]


def test_supervisor_fault_with_no_checkpoint_propagates():
    with tempfile.TemporaryDirectory() as d:
        sup, _ = _counting_supervisor(d, fail_at=0)
        with pytest.raises(RuntimeError, match="boom"):
            sup.run({"x": torch.zeros(())}, 4)


def test_supervisor_on_straggler_hook_fires():
    with tempfile.TemporaryDirectory() as d:
        hits = []
        sup = Supervisor(
            step_fn=lambda s, i: (time.sleep(0.1 if i == 6 else 0.01), s)[1],
            save_state=lambda s: s, load_state=lambda s: s, ckpt_dir=d, ckpt_interval=100,
            straggler=StragglerPolicy(deadline_factor=3.0, evict_after=1),
            on_straggler=hits.append,
        )
        sup.run({"x": torch.zeros(())}, 8)
        assert 6 in hits
        assert (6, "straggler") in sup.history


def test_save_cleans_stale_tmp_from_crashed_writer():
    with tempfile.TemporaryDirectory() as d:
        stale = os.path.join(d, "tmp.3")
        os.makedirs(stale)
        with open(os.path.join(stale, "garbage"), "w") as f:
            f.write("half-written")
        path = checkpoint.save(d, 3, {"w": torch.ones((2, 2))})
        assert not os.path.exists(stale)
        assert os.path.isdir(path)
        assert not os.path.exists(os.path.join(path, "garbage"))
        restored, manifest = checkpoint.restore(d, {"w": torch.zeros((2, 2))}, step=3)
        assert manifest["step"] == 3
        assert float(restored["w"].sum()) == 4.0


def test_save_replaces_existing_step_dir():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, {"w": torch.zeros((2,))})
        checkpoint.save(d, 1, {"w": torch.ones((2,))})
        restored, _ = checkpoint.restore(d, {"w": torch.zeros((2,))})
        assert float(restored["w"].sum()) == 2.0
        assert sorted(os.listdir(d)) == ["step_00000001"]


def test_retention_keep_every_protects_multiples():
    with tempfile.TemporaryDirectory() as d:
        for s in range(1, 11):
            checkpoint.save(d, s, {"w": torch.zeros(())})
        checkpoint.retention(d, keep_last=2, keep_every=4)
        kept = sorted(int(n.split("_")[1]) for n in os.listdir(d) if n.startswith("step_"))
        assert kept == [4, 8, 9, 10]
        assert checkpoint.latest_step(d) == 10


def test_retention_and_latest_on_missing_dir_are_noops():
    missing = os.path.join(tempfile.gettempdir(), "no-such-ckpt-dir-xyz")
    checkpoint.retention(missing, keep_last=1)
    assert checkpoint.latest_step(missing) is None


def test_manifest_carries_metadata_and_keys():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 2, {"a": torch.zeros((2,)), "b": torch.ones((3,))},
                        metadata={"arch": "sparse-mlp"})
        with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["step"] == 2 and manifest["arch"] == "sparse-mlp"
        assert manifest["num_leaves"] == 2 and manifest["keys"] == ["a", "b"]


def test_restore_refuses_a_missing_or_misshapen_leaf():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, {"w": torch.zeros((2,))})
        with pytest.raises(KeyError, match="'v'"):
            checkpoint.restore(d, {"v": torch.zeros((2,))})
        with pytest.raises(ValueError, match="shape"):
            checkpoint.restore(d, {"w": torch.zeros((3,))})
        with pytest.raises(FileNotFoundError):
            checkpoint.restore(os.path.join(d, "empty"), {"w": torch.zeros((2,))})


# ---------------------------------------------------------------------
# interchange: either package restores the other's checkpoints
# ---------------------------------------------------------------------


def _opts(name):
    return {"sgd": (sgd(0.1), jsgd(0.1)), "adamw": (adamw(1e-3), jadamw(1e-3))}[name]


def _stepped(name):
    """Both packages' states after one identical update of every leaf
    (values, biases and the optimizer's moments all nonzero)."""
    state, jstate, m = _state(seed=8, opt=_opts(name))
    jfn = _jbatch_fn(m)
    from repro.train.sparse import make_sparse_train_step as jstep
    from repro_torch.train.sparse import make_sparse_train_step as pstep

    popt, jopt = _opts(name)
    jstate, _ = jstep(jopt, use_kernel=False)(jstate, jfn(0))
    state, _ = pstep(popt, use_kernel=False)(state, _batch_fn(m)(0))
    return state, jstate


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_the_port_restores_a_checkpoint_the_reference_wrote(opt):
    state, jstate = _stepped(opt)
    with tempfile.TemporaryDirectory() as d:
        jcheckpoint.save(d, 4, jstate, metadata={"writer": "reference"})
        restored, manifest = checkpoint.restore(d, state)
        assert manifest["step"] == 4 and manifest["writer"] == "reference"
        want = jcheckpoint._flatten(jstate)
        got = _leaves(restored)
        assert got.keys() == want.keys() and manifest["keys"] == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        validate_sparse_state(restored)
        assert isinstance(restored.opt.mu, list) and len(restored.opt.mu) == len(state.opt.mu)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_the_reference_restores_a_checkpoint_the_port_wrote(opt):
    state, jstate = _stepped(opt)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 4, state, metadata={"writer": "port"})
        restored, manifest = jcheckpoint.restore(d, jstate)
        assert manifest["writer"] == "port"
        want, got = _leaves(state), jcheckpoint._flatten(restored)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        # and the two packages' states after the same step agree
        for k, v in jcheckpoint._flatten(jstate).items():
            if v.dtype.kind == "f":
                np.testing.assert_allclose(want[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
            else:
                assert np.array_equal(want[k], v), k
