"""Declarative fault-injection / demand-profile scenario layer (twin of
the reference's ``scenarios`` package, on numpy).

  * :class:`~repro_torch.scenarios.scenario.Scenario` — frozen component
    bundle (demand profiles: heavy-tail, correlated burst, phase shift;
    faults: DMA stretch, thermal throttle, serving instance loss);
  * :data:`~repro_torch.scenarios.scenario.SCENARIOS` /
    :func:`~repro_torch.scenarios.scenario.get_scenario` — the named
    registry plus the parameterized ``faults@<intensity>`` family;
  * :func:`~repro_torch.scenarios.scenario.demand_multiplier` and
    friends — the ``xp``-generic release-time arithmetic, and their
    ``*_t`` torch twins for the lockstep engine;
  * :mod:`~repro_torch.scenarios.crn` — the counter-based splitmix64
    CRN primitives scenario streams draw from.
"""
from repro_torch.scenarios.crn import (GOLD, counter, keyed_u01,
                                       keyed_u01_t, mix64, mix64_t,
                                       stream_salt, u01, u01_t)
from repro_torch.scenarios.scenario import (SCENARIOS, Scenario,
                                            burst_multiplier,
                                            burst_multiplier_t,
                                            burst_window_index,
                                            burst_window_index_t,
                                            demand_multiplier,
                                            demand_multiplier_t, faults,
                                            get_scenario, lane_lost,
                                            next_loss_boundary,
                                            shifted_phases)

__all__ = [
    "GOLD", "SCENARIOS", "Scenario", "burst_multiplier",
    "burst_multiplier_t", "burst_window_index", "burst_window_index_t",
    "counter", "demand_multiplier", "demand_multiplier_t", "faults",
    "get_scenario", "keyed_u01", "keyed_u01_t", "lane_lost", "mix64",
    "mix64_t", "next_loss_boundary", "shifted_phases", "stream_salt",
    "u01", "u01_t",
]
