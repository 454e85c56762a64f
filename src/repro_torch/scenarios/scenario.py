"""Declarative fault/demand scenarios (own copy of the reference's
``scenarios/scenario.py``).

A :class:`Scenario` is a frozen bundle of *components*, each either off
(its knob at the neutral value) or on:

demand-profile components (shape the per-release demand draw)
  * ``heavy_tail`` — with probability ``heavy_tail_prob`` a release's
    demand is stretched by the bounded rational tail
    ``1 + scale * u / (1 - q * u)`` (u uniform on the 2**-26 grid;
    max ``1 + scale/(1-q)``), arithmetic that a fused multiply-add
    cannot change;
  * ``burst`` (correlated) — virtual time is cut into
    ``burst_window``-cycle windows; one keyed draw *per window* decides
    whether every release inside it is stretched by ``burst_factor``;
  * ``phase_shift`` — each task's initial release phase is shifted by
    ``phase_shift * u`` periods (keyed per task).

fault components (environmental stretch on top of any demand profile)
  * ``dma`` contention storm — per-release keyed coin: demand runs
    ``dma_factor`` slower with probability ``dma_prob``;
  * ``thermal`` throttle — releases inside the first ``thermal_duty``
    fraction of each ``thermal_period`` window run ``thermal_factor``
    slower;
  * ``instance loss`` (serving only) — a lane inside a keyed
    ``loss_window_s`` outage window cannot start new work until the
    window passes (see ``serving.frontend``).

:func:`demand_multiplier` is the single implementation of the
release-time fault arithmetic, parameterized by the array namespace
``xp`` (``numpy`` for the host engines).  All draws are counter-based
CRN streams (``scenarios.crn``) keyed ``(seed ^ salt(component), task,
release_index)``, so the same scenario realization is applied under
every policy and engine, and every draw is bit-equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.scenarios.crn import keyed_u01, keyed_u01_t, stream_salt

_SALT_HEAVY_TAIL = stream_salt("heavy_tail")
_SALT_BURST = stream_salt("burst")
_SALT_PHASE = stream_salt("phase_shift")
_SALT_DMA = stream_salt("dma")
_SALT_THERMAL = stream_salt("thermal")
_SALT_LOSS = stream_salt("instance_loss")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative scenario: a named, hashable component bundle.

    Neutral values (probability 0, window/duty 0, factor 1) switch a
    component off *statically*: a disabled component adds no operation
    to any engine."""
    name: str
    # demand-profile components
    heavy_tail_prob: float = 0.0
    heavy_tail_scale: float = 0.0
    heavy_tail_q: float = 0.85
    burst_window: float = 0.0
    burst_prob: float = 0.0
    burst_factor: float = 1.0
    phase_shift: float = 0.0
    # fault components
    dma_prob: float = 0.0
    dma_factor: float = 1.0
    thermal_period: float = 0.0
    thermal_duty: float = 0.0
    thermal_factor: float = 1.0
    # serving-only component
    loss_prob: float = 0.0
    loss_window_s: float = 0.0

    # -- static component gates --
    @property
    def has_heavy_tail(self) -> bool:
        return self.heavy_tail_prob > 0.0 and self.heavy_tail_scale > 0.0

    @property
    def has_burst(self) -> bool:
        return self.burst_window > 0.0 and self.burst_prob > 0.0 \
            and self.burst_factor != 1.0

    @property
    def has_phase_shift(self) -> bool:
        return self.phase_shift > 0.0

    @property
    def has_dma(self) -> bool:
        return self.dma_prob > 0.0 and self.dma_factor != 1.0

    @property
    def has_thermal(self) -> bool:
        return self.thermal_period > 0.0 and self.thermal_duty > 0.0 \
            and self.thermal_factor != 1.0

    @property
    def has_loss(self) -> bool:
        return self.loss_prob > 0.0 and self.loss_window_s > 0.0

    @property
    def affects_demand(self) -> bool:
        return (self.has_heavy_tail or self.has_burst or self.has_dma
                or self.has_thermal)


def faults(intensity: float) -> Scenario:
    """The parameterized ``faults@<intensity>`` family.

    ``intensity`` in [0, 1] scales a combined environmental-fault
    scenario — correlated contention bursts + DMA stretch + thermal
    duty-cycle + instance loss — from "off" (intensity 0 is the neutral
    multiplier) to a heavily degraded platform."""
    x = float(intensity)
    if not 0.0 <= x <= 1.0:
        raise ValueError(
            f"scenario 'faults@<intensity>' needs intensity in [0, 1], "
            f"got {intensity!r}")
    return Scenario(
        name=f"faults@{x:g}",
        burst_window=2e5, burst_prob=0.3 * x, burst_factor=1.0 + 0.4 * x,
        dma_prob=0.35 * x, dma_factor=1.0 + 0.3 * x,
        thermal_period=1e6, thermal_duty=0.4 * x,
        thermal_factor=1.0 + 0.5 * x,
        loss_prob=0.5 * x, loss_window_s=0.25)


#: Named scenario registry (the ``faults@<intensity>`` family rides
#: along via :func:`get_scenario`'s name parser).
SCENARIOS = {
    "heavy_tail": Scenario(name="heavy_tail", heavy_tail_prob=0.2,
                           heavy_tail_scale=0.6, heavy_tail_q=0.85),
    "burst": Scenario(name="burst", burst_window=1e5, burst_prob=0.25,
                      burst_factor=1.3),
    "phase_shift": Scenario(name="phase_shift", phase_shift=1.0),
    "dma_storm": Scenario(name="dma_storm", dma_prob=0.3,
                          dma_factor=1.25),
    "thermal_throttle": Scenario(name="thermal_throttle",
                                 thermal_period=1e6, thermal_duty=0.3,
                                 thermal_factor=1.4),
    "instance_loss": Scenario(name="instance_loss", loss_prob=0.35,
                              loss_window_s=0.25),
}


def get_scenario(scenario: Union[None, str, Scenario]) -> \
        Optional[Scenario]:
    """Resolve a scenario spec (None | name | ``faults@x`` | Scenario);
    an unknown name raises a ``ValueError`` naming it."""
    if scenario is None or isinstance(scenario, Scenario):
        return scenario
    if scenario in SCENARIOS:
        return SCENARIOS[scenario]
    if isinstance(scenario, str) and scenario.startswith("faults@"):
        try:
            x = float(scenario[len("faults@"):])
        except ValueError:
            raise ValueError(
                f"unknown scenario {scenario!r}: the faults family is "
                f"'faults@<intensity>' with a float intensity in [0, 1]"
            ) from None
        return faults(x)
    raise ValueError(
        f"unknown scenario {scenario!r}; want None, one of "
        f"{sorted(SCENARIOS)}, or 'faults@<intensity>'")


# ----------------------------------------------------------------------
# The release-time arithmetic (shared by every engine)
# ----------------------------------------------------------------------

#: Scenario draws that feed a ``c - a*b`` pattern live on this grid —
#: see :func:`_nofuse` for why.
_GRID = 2.0 ** 26


def _snap(x: float) -> float:
    """Snap a scenario parameter onto the 2**-26 grid."""
    return round(x * _GRID) / _GRID


def _nofuse(xp, x):
    """Materialize a product before it meets a subtract.

    A compiler may contract ``c - a*b`` into a fused multiply-add, which
    rounds once instead of twice.  Routing the product through ``abs``
    (the bitwise identity on the non-negative products used here) keeps
    it apart where the compiler cannot prove the sign; where it can,
    the factors are quantized to the 2**-26 grid instead, so the product
    is exact and fused and unfused subtracts round alike."""
    return xp.abs(x)


def burst_multiplier(scen: Scenario, xp, seed64, window):
    """Per-window correlated-burst multiplier (one draw per window,
    keyed (seed, 'burst', window): every release in an active window
    sees the same stretch).  ``window`` is the integer window index."""
    u = keyed_u01(seed64, _SALT_BURST, window, np.uint64(0))
    return xp.where(u < scen.burst_prob, scen.burst_factor, 1.0)


def demand_multiplier(scen: Scenario, xp, seed64, task_col, rel_n,
                      t_rel, burst_m=None):
    """The scenario's demand stretch for one release, as an array op.

    Pure function of ``(seed64, task_col, rel_n, t_rel)`` — the point
    seed, the task column, the task's absolute release index and the
    release time.  Component order is fixed (heavy_tail, burst, dma,
    thermal) so the float product associates identically in every
    engine.  Returns ``None`` when no demand component is active, else
    a float64 array to multiply into the base demand.  ``burst_m`` lets
    an engine supply a cached per-window draw."""
    m = None

    def _mul(m, f):
        return f if m is None else m * f

    if scen.has_heavy_tail:
        ua = keyed_u01(seed64, _SALT_HEAVY_TAIL, task_col, rel_n)
        # ub and q live on the 2**-26 grid so q*ub is exact in f64
        ub = xp.floor(
            keyed_u01(seed64, _SALT_HEAVY_TAIL, task_col, rel_n, sub=1)
            * _GRID) / _GRID
        q = _snap(scen.heavy_tail_q)
        tail = 1.0 + scen.heavy_tail_scale * ub / (1.0 - q * ub)
        m = _mul(m, xp.where(ua < scen.heavy_tail_prob, tail, 1.0))
    if scen.has_burst:
        if burst_m is None:
            burst_m = burst_multiplier(
                scen, xp, seed64, burst_window_index(scen, xp, t_rel))
        m = _mul(m, burst_m)
    if scen.has_dma:
        ud = keyed_u01(seed64, _SALT_DMA, task_col, rel_n)
        m = _mul(m, xp.where(ud < scen.dma_prob, scen.dma_factor, 1.0))
    if scen.has_thermal:
        k = xp.floor(t_rel / scen.thermal_period)
        pos = t_rel - _nofuse(xp, k * scen.thermal_period)
        on = scen.thermal_duty * scen.thermal_period
        m = _mul(m, xp.where(pos < on, scen.thermal_factor, 1.0))
    return m


def burst_window_index(scen: Scenario, xp, t_rel):
    """Integer burst-window index of a release time (int32)."""
    return xp.floor(t_rel / scen.burst_window).astype(np.int32)


# ----------------------------------------------------------------------
# torch twins of the release-time draws, for the lockstep engine
# (core.simulator_jit): int64 tensors hold the uint64 keys
# (``crn.keyed_u01_t``), every float operation is the numpy version's in
# its order, and each torch op is one kernel, so no product is fused into
# a following add or subtract.
# ----------------------------------------------------------------------

def _pick(cond, on: float, like):
    """``where(cond, on, 1.0)`` as float64 (two Python scalars would give
    torch's default float32)."""
    return torch.where(cond, on, torch.ones_like(like))


def burst_window_index_t(scen: Scenario, t_rel):
    """:func:`burst_window_index` on a float64 tensor (int32 result)."""
    return torch.floor(t_rel / scen.burst_window).to(torch.int32)


def burst_multiplier_t(scen: Scenario, seed64, window):
    """:func:`burst_multiplier` on tensors (``seed64`` int64 bits)."""
    u = keyed_u01_t(seed64, _SALT_BURST, window, 0)
    return _pick(u < scen.burst_prob, scen.burst_factor, u)


def demand_multiplier_t(scen: Scenario, seed64, task_col, rel_n, t_rel,
                        burst_m=None):
    """:func:`demand_multiplier` on tensors: the same components in the
    same order, bit-equal to the numpy version."""
    m = None

    def _mul(m, f):
        return f if m is None else m * f

    if scen.has_heavy_tail:
        ua = keyed_u01_t(seed64, _SALT_HEAVY_TAIL, task_col, rel_n)
        ub = torch.floor(
            keyed_u01_t(seed64, _SALT_HEAVY_TAIL, task_col, rel_n, sub=1)
            * _GRID) / _GRID
        q = _snap(scen.heavy_tail_q)
        tail = 1.0 + scen.heavy_tail_scale * ub / (1.0 - q * ub)
        m = _mul(m, torch.where(ua < scen.heavy_tail_prob, tail,
                                torch.ones_like(tail)))
    if scen.has_burst:
        if burst_m is None:
            burst_m = burst_multiplier_t(
                scen, seed64, burst_window_index_t(scen, t_rel))
        m = _mul(m, burst_m)
    if scen.has_dma:
        ud = keyed_u01_t(seed64, _SALT_DMA, task_col, rel_n)
        m = _mul(m, _pick(ud < scen.dma_prob, scen.dma_factor, ud))
    if scen.has_thermal:
        k = torch.floor(t_rel / scen.thermal_period)
        pos = t_rel - torch.abs(k * scen.thermal_period)
        on = scen.thermal_duty * scen.thermal_period
        m = _mul(m, _pick(pos < on, scen.thermal_factor, pos))
    return m


def shifted_phases(scen: Scenario, seed64, task_col, phase, period):
    """Apply the phase-shift component to host-drawn release phases.

    The shift fraction is a keyed CRN draw per (seed, task); the result
    wraps back into [0, period) with one exact subtract (the shift is
    less than one period)."""
    if not scen.has_phase_shift:
        return phase
    frac = scen.phase_shift * keyed_u01(seed64, _SALT_PHASE, task_col,
                                        np.uint64(0))
    shifted = phase + frac * period
    return np.where(shifted >= period, shifted - period, shifted)


def lane_lost(scen: Optional[Scenario], seed: int, lane: int,
              t: float) -> bool:
    """Serving instance loss: is ``lane`` inside a keyed outage window
    at virtual time ``t``?  One draw per (seed, lane, window): lost
    lanes recover when their window passes, and the realization is the
    same under every policy."""
    if scen is None or not scen.has_loss:
        return False
    w = np.uint64(int(t // scen.loss_window_s))
    u = keyed_u01(np.int64(seed).astype(np.uint64), _SALT_LOSS,
                  np.uint64(lane), w)
    return bool(u < scen.loss_prob)


def next_loss_boundary(scen: Scenario, t: float) -> float:
    """First instant after ``t`` at which a lost lane's outage window
    can end.

    Guarantees strict progress: the returned instant maps to a window
    index greater than ``t``'s.  Plain ``(w + 1) * window`` does not —
    ``0.9 // 0.05 == 17.0`` while ``18 * 0.05 == 0.9``, so a clock
    sitting on that boundary would jump to itself and the serving loop
    would spin forever."""
    win = scen.loss_window_s
    w = int(t // win)
    b = (w + 1) * win
    while int(b // win) <= w:      # float rounding kept the old window
        b = math.nextafter(b, math.inf)
    return b
