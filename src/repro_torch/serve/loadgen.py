"""Open-loop load generation for the fleet serving front end —
counterpart of ``repro/serve/loadgen.py``.

GraphChallenge (arXiv:2004.01181) scores sparse inference as *sustained
streaming rate under load* — which only means something against a
defined arrival process. This module generates those processes as
deterministic, timestamped job traces:

* :class:`LoadProfile` — a rate function λ(t) (jobs/second):
  ``constant``, ``diurnal`` (sinusoidal day-curve), ``bursty``
  (baseline + periodic burst windows — the overload shape the
  backpressure path exists for);
* :func:`generate_jobs` — an inhomogeneous Poisson draw against the
  profile via Lewis–Shedler thinning, from one seeded generator: same
  arguments → the same jobs, timestamps, panels, and deadlines, bit for
  bit — and the reference's, bit for bit: the same numpy generator and
  the same draws, the panels handed over as tensors on the caller's
  device.

**Open-loop** means arrivals never wait for the system: the trace is a
fixed function of (profile, seed), so an overloaded fleet sees the same
offered load as a healthy one — the honest way to measure saturation
(closed-loop generators self-throttle and hide it).

A *job* is an ``(m, k)`` panel of k feature columns served together —
the unit a client submits (k = 1 is a single request). ``k`` is drawn
from ``width_mix``, so a trace can carry several panel width classes;
the fleet router's affinity policy (``repro_torch.serve.fleet``) keys on
exactly those classes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ArrivalJob:
    """One timestamped unit of offered load."""

    rid: int
    t: float  # arrival timestamp, seconds from trace start
    features: torch.Tensor  # (m, k) panel; k columns served together
    deadline: float | None = None  # absolute seconds, or None

    @property
    def cols(self) -> int:
        return int(self.features.shape[1])


@dataclasses.dataclass(frozen=True)
class LoadProfile:
    """λ(t) in jobs/second, with the peak rate thinning needs.

    Build with the constructors (:meth:`constant` / :meth:`diurnal` /
    :meth:`bursty`) — they set a coherent ``peak``.
    """

    rate: Callable[[float], float]
    peak: float
    name: str = "custom"

    @staticmethod
    def constant(rate: float) -> "LoadProfile":
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        return LoadProfile(lambda t: rate, rate, "constant")

    @staticmethod
    def diurnal(
        base: float, amplitude: float, period: float
    ) -> "LoadProfile":
        """λ(t) = base + amplitude · (1 + sin(2πt/period)) / 2 — a
        smooth trough-to-peak day curve (trough = base, peak = base +
        amplitude)."""
        if base <= 0 or amplitude < 0 or period <= 0:
            raise ValueError(
                f"need base > 0, amplitude >= 0, period > 0; got "
                f"({base}, {amplitude}, {period})"
            )

        def lam(t: float) -> float:
            return base + amplitude * (
                1.0 + math.sin(2.0 * math.pi * t / period)
            ) / 2.0

        return LoadProfile(lam, base + amplitude, "diurnal")

    @staticmethod
    def bursty(
        base: float,
        burst_rate: float,
        burst_every: float,
        burst_len: float,
    ) -> "LoadProfile":
        """λ(t) = base, except ``burst_rate`` during the first
        ``burst_len`` seconds of every ``burst_every``-second window —
        the flash-crowd shape that exercises queueing + backpressure."""
        if base <= 0 or burst_rate < base:
            raise ValueError(
                f"need burst_rate >= base > 0, got ({base}, {burst_rate})"
            )
        if not 0 < burst_len <= burst_every:
            raise ValueError(
                f"need 0 < burst_len <= burst_every, got "
                f"({burst_len}, {burst_every})"
            )

        def lam(t: float) -> float:
            return burst_rate if (t % burst_every) < burst_len else base

        return LoadProfile(lam, burst_rate, "bursty")

    def scaled(self, factor: float) -> "LoadProfile":
        """The same shape at ``factor``× the rate — how the benchmark
        sweeps offered load along one curve."""
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        return LoadProfile(
            lambda t: self.rate(t) * factor,
            self.peak * factor,
            f"{self.name}x{factor:g}",
        )


def generate_jobs(
    profile: LoadProfile,
    duration: float,
    *,
    m: int,
    seed: int,
    width_mix: Sequence[tuple[int, float]] = ((1, 1.0),),
    deadline_s: float | None = None,
    device=None,
) -> list[ArrivalJob]:
    """Draw a deterministic open-loop job trace from ``profile``.

    Lewis–Shedler thinning: candidate arrivals are a homogeneous
    Poisson process at ``profile.peak``; a candidate at time t survives
    with probability λ(t)/peak. ``width_mix`` is a sequence of
    ``(k, weight)`` panel widths; weights are normalized. Every random
    choice (inter-arrival gaps, thinning, widths, feature values) comes
    from one ``np.random.default_rng(seed)`` stream, so the trace is a
    pure function of the arguments. The panels are float32 tensors on
    ``device`` (default: the GPU, raising if there is none).
    """
    if duration <= 0:
        raise ValueError(f"duration must be > 0, got {duration}")
    if not width_mix or any(k < 1 or w <= 0 for k, w in width_mix):
        raise ValueError(
            f"width_mix needs positive (k, weight) pairs, got {width_mix}"
        )
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    widths = np.array([k for k, _ in width_mix], dtype=np.int64)
    weights = np.array([w for _, w in width_mix], dtype=np.float64)
    weights = weights / weights.sum()

    jobs: list[ArrivalJob] = []
    t = 0.0
    rid = 0
    while True:
        t += float(rng.exponential(1.0 / profile.peak))
        if t >= duration:
            break
        if rng.uniform() > profile.rate(t) / profile.peak:
            continue  # thinned away: λ(t) < peak here
        k = int(widths[rng.choice(len(widths), p=weights)])
        features = torch.from_numpy(
            rng.uniform(0.0, 1.0, size=(m, k)).astype(np.float32)
        ).to(device)
        jobs.append(
            ArrivalJob(
                rid=rid,
                t=t,
                features=features,
                deadline=None if deadline_s is None else t + deadline_s,
            )
        )
        rid += 1
    return jobs


__all__ = ["ArrivalJob", "LoadProfile", "generate_jobs"]
