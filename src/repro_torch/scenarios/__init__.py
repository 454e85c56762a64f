"""Declarative fault-injection / demand-profile scenario layer (twin of
the reference's ``scenarios`` package, on numpy).

  * :class:`~repro_torch.scenarios.scenario.Scenario` — frozen component
    bundle (demand profiles: heavy-tail, correlated burst, phase shift;
    faults: DMA stretch, thermal throttle, serving instance loss);
  * :data:`~repro_torch.scenarios.scenario.SCENARIOS` /
    :func:`~repro_torch.scenarios.scenario.get_scenario` — the named
    registry plus the parameterized ``faults@<intensity>`` family;
  * :func:`~repro_torch.scenarios.scenario.demand_multiplier` and
    friends — the ``xp``-generic release-time arithmetic;
  * :mod:`~repro_torch.scenarios.crn` — the counter-based splitmix64
    CRN primitives scenario streams draw from.
"""
from repro_torch.scenarios.crn import (GOLD, counter, keyed_u01, mix64,
                                       stream_salt, u01)
from repro_torch.scenarios.scenario import (SCENARIOS, Scenario,
                                            burst_multiplier,
                                            burst_window_index,
                                            demand_multiplier, faults,
                                            get_scenario, lane_lost,
                                            next_loss_boundary,
                                            shifted_phases)

__all__ = [
    "GOLD", "SCENARIOS", "Scenario", "burst_multiplier",
    "burst_window_index", "counter", "demand_multiplier", "faults",
    "get_scenario", "keyed_u01", "lane_lost", "mix64",
    "next_loss_boundary", "shifted_phases", "stream_salt", "u01",
]
