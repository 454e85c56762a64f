"""Injectable clocks for the serving stack (twin of the reference's
``serving/clock.py``).

A *clock* is any zero-arg callable returning seconds as a float.
``core.serving.MESCServer`` reads every timestamp (``submitted_at``,
``started_at``, ``exec_s`` accumulation, LO-budget mode-switch checks)
through its injected clock, so the same scheduling code runs in two
regimes:

  * **wall clock** (:func:`wall_clock`, the default) — real serving on
    the card: timestamps are ``time.monotonic()`` and service time is
    whatever the model's dispatch costs;
  * **virtual clock** (:class:`VirtualClock`) — deterministic replay:
    time only moves when a model (``frontend.VirtualModel``) or the
    context-switch cost hooks :meth:`~VirtualClock.advance` it, so every
    SLO metric is an exact function of ``(workload, seed, policy)``.

Clocks are per dispatch lane: each lane of a
``core.serving.MultiLaneServer`` is an independent virtual accelerator
whose local time advances with its own dispatches.
"""
from __future__ import annotations

import time

#: The default clock: real (monotonic) time.
wall_clock = time.monotonic


class VirtualClock:
    """Deterministic simulated time: moves only via :meth:`advance`.

    Calling the instance returns the current virtual time in seconds.
    ``advance`` adds a non-negative service duration; ``advance_to``
    clamps forward to an absolute time (the open-loop drive rides idle
    lanes forward to the global frontier / next arrival with it).
    """

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"VirtualClock.advance(dt={dt}): dt must "
                             "be >= 0 (virtual time is monotone)")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        """Move forward to absolute time ``t`` (no-op if already past)."""
        if t > self._now:
            self._now = t
        return self._now

    def __repr__(self) -> str:                      # pragma: no cover
        return f"VirtualClock({self._now!r})"
