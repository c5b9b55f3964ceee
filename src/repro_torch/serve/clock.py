"""Injectable clocks for the serving stack — counterpart of
``repro/serve/clock.py`` (which imports no JAX; the port keeps its own
copy all the same).

Retry backoff and straggler stalls go through a :class:`Clock`, so the
same code runs on two kinds of time:

* :class:`WallClock` — ``time.monotonic`` timestamps and real
  ``time.sleep`` waits;
* :class:`VirtualClock` — time is a number the caller advances:
  ``sleep`` moves it forward at once and records the request, so a
  faulted trace with backoff runs in no real time and the same way
  every run.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """What the serving stack needs from a time source."""

    def now(self) -> float:
        """Current time in seconds (monotonic; the epoch is arbitrary)."""
        ...

    def sleep(self, seconds: float) -> None:
        """Block (or advance virtual time) for ``seconds``."""
        ...


class WallClock:
    """Real time: ``time.monotonic`` + ``time.sleep``."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock:
    """Deterministic simulated time: ``sleep(dt)`` advances it by ``dt``
    at once and logs the request in :attr:`sleeps`; ``advance_to(t)``
    jumps to an absolute time, never backwards."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.sleeps: list[float] = []

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot sleep {seconds} s")
        self.sleeps.append(float(seconds))
        self._now += float(seconds)

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(f"cannot move a monotonic clock backwards: {t} < {self._now}")
        self._now = float(t)

    @property
    def slept_total(self) -> float:
        return sum(self.sleeps)


# The default when callers inject none: a singleton, so `clock or
# WALL_CLOCK` never allocates on the hot path.
WALL_CLOCK = WallClock()


__all__ = ["Clock", "WallClock", "VirtualClock", "WALL_CLOCK"]
