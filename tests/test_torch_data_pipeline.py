"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's ``repro.data.pipeline``: every case of ``test_data_pipeline.py``
on the port, each batch equal to the reference's bit for bit, in all
three input modes, and the prefetcher's order."""

import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import Prefetcher, SyntheticLM


def _assert_same_batch(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@given(
    seed=st.integers(0, 2**31 - 1),
    step=st.integers(0, 10_000),
    vocab=st.sampled_from([64, 1000, 32768]),
)
@settings(max_examples=25, deadline=None)
def test_deterministic_in_seed_and_step(seed, step, vocab):
    a = SyntheticLM(vocab, 16, 4, seed=seed).batch(step)
    b = SyntheticLM(vocab, 16, 4, seed=seed).batch(step)
    _assert_same_batch(a, b)
    _assert_same_batch(a, JSyntheticLM(vocab, 16, 4, seed=seed).batch(step))


@given(step=st.integers(0, 1000))
@settings(max_examples=10, deadline=None)
def test_steps_differ(step):
    d = SyntheticLM(1024, 16, 4, seed=0)
    assert not np.array_equal(d.batch(step)["inputs"], d.batch(step + 1)["inputs"])


@given(num_hosts=st.sampled_from([2, 4]), step=st.integers(0, 100))
@settings(max_examples=10, deadline=None)
def test_hosts_get_different_shards(num_hosts, step):
    batches = [SyntheticLM(1024, 16, 8, seed=0, host_id=h, num_hosts=num_hosts).batch(step)
               for h in range(num_hosts)]
    for h, b in enumerate(batches):
        _assert_same_batch(b, JSyntheticLM(1024, 16, 8, seed=0, host_id=h,
                                           num_hosts=num_hosts).batch(step))
    for i in range(num_hosts):
        assert batches[i]["inputs"].shape[0] == 8 // num_hosts
        for j in range(i + 1, num_hosts):
            assert not np.array_equal(batches[i]["inputs"], batches[j]["inputs"])


def test_labels_are_shifted_inputs():
    b = SyntheticLM(512, 32, 4, seed=1).batch(0)
    _assert_same_batch(b, JSyntheticLM(512, 32, 4, seed=1).batch(0))
    a = 6364136223846793005 % 512 | 1
    c = 1442695040888963407 % 512
    pred = (a * b["inputs"].astype(np.int64) + c) % 512
    assert (pred == b["labels"]).mean() > 0.85  # noise = 5%


def test_vocab_bounds():
    b = SyntheticLM(100, 16, 4, seed=2).batch(7)
    _assert_same_batch(b, JSyntheticLM(100, 16, 4, seed=2).batch(7))
    assert b["inputs"].min() >= 0 and b["inputs"].max() < 100
    assert b["labels"].min() >= 0 and b["labels"].max() < 100


def test_embeddings_mode():
    d = SyntheticLM(100, 8, 4, seed=0, input_mode="embeddings", d_model=32)
    b = d.batch(0)
    assert b["inputs"].shape == (4, 8, 32)
    assert b["inputs"].dtype == np.float32
    _assert_same_batch(b, JSyntheticLM(100, 8, 4, seed=0, input_mode="embeddings",
                                       d_model=32).batch(0))


@pytest.mark.parametrize("step", [0, 5])
def test_features_mode_matches_reference(step):
    kw = dict(seed=3, input_mode="features", d_model=64)
    b = SyntheticLM(64, 1, 8, **kw).batch(step)
    assert b["inputs"].shape == (8, 64) and b["labels"].shape == (8,)
    _assert_same_batch(b, JSyntheticLM(64, 1, 8, **kw).batch(step))


def test_iteration_follows_the_steps():
    d = SyntheticLM(128, 8, 2, seed=4)
    it, jit = iter(d), iter(JSyntheticLM(128, 8, 2, seed=4))
    for step in range(3):
        got = next(it)
        _assert_same_batch(got, d.batch(step))
        _assert_same_batch(got, next(jit))


def test_prefetcher_deterministic_order():
    data = SyntheticLM(128, 8, 4, seed=3)
    pf = Prefetcher(data, depth=2)
    s0, b0 = pf.next()
    s1, b1 = pf.next()
    pf.close()
    assert (s0, s1) == (0, 1)
    assert not pf._thread.is_alive()
    np.testing.assert_array_equal(b0["inputs"], data.batch(0)["inputs"])
    np.testing.assert_array_equal(b1["inputs"], data.batch(1)["inputs"])
    _assert_same_batch(b1, JSyntheticLM(128, 8, 4, seed=3).batch(1))


def test_prefetcher_starts_at_start_step_and_close_joins_a_full_queue():
    data = SyntheticLM(128, 8, 4, seed=3)
    pf = Prefetcher(data, depth=1, start_step=7)
    steps = [pf.next()[0] for _ in range(3)]
    deadline = time.monotonic() + 10
    while not pf._q.full() and time.monotonic() < deadline:  # the worker blocks on it
        time.sleep(0.01)
    pf.close()
    assert steps == [7, 8, 9]
    assert not pf._thread.is_alive()
