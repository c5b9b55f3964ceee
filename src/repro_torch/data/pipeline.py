"""Deterministic synthetic data with per-host sharding and a background
prefetch — counterpart of ``repro/data/pipeline.py``, a copy in numpy.

The stream is a pure function of (seed, step, host): a restart needs no
loader checkpoint, and any host can recompute any shard, which the
checkpoint-and-restart supervisor relies on. Batches are numpy arrays,
equal to the reference's bit for bit (the same Philox key and counter,
the same draws in the same order); the trainer moves them to the card.

The LM task is learnable (tokens follow a noisy modular-affine
recurrence x_{t+1} = (a·x_t + b + ε) mod V), so a training run shows a
real loss drop rather than flat noise.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    input_mode: str = "tokens"  # "tokens" | "embeddings" | "features"
    d_model: int = 0  # for embeddings/features modes
    # per-host sharding
    host_id: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def _rng(self, step: int) -> np.random.Generator:
        # Philox keyed on (seed, step, host): deterministic, splittable.
        return np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, step, self.host_id]))

    def batch(self, step: int) -> dict[str, Any]:
        rng = self._rng(step)
        b, s, v = self.host_batch, self.seq_len, self.vocab_size
        if self.input_mode == "embeddings":
            x = rng.standard_normal((b, s, self.d_model), dtype=np.float32)
            labels = rng.integers(0, v, (b, s), dtype=np.int64)
            return {"inputs": x, "labels": labels.astype(np.int32)}
        if self.input_mode == "features":
            x = rng.random((b, self.d_model), dtype=np.float32)
            labels = rng.integers(0, v, (b,), dtype=np.int64)
            return {"inputs": x, "labels": labels.astype(np.int32)}
        a = 6364136223846793005 % v | 1
        c = 1442695040888963407 % v
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, v, b)
        noise_mask = rng.random((b, s)) < self.noise
        noise_tok = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = (a * toks[:, t] + c) % v
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"inputs": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict[str, Any]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background prefetch into a bounded queue (``depth`` batches): the
    host synthesises the next batches while the card runs a step. Batches
    come out in step order from ``start_step``; :meth:`close` stops and
    joins the worker thread."""

    def __init__(self, source: SyntheticLM, *, depth: int = 2, start_step: int = 0):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict[str, Any]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()  # the worker sees the stop within one batch and 0.1 s
