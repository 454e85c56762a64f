"""Unified experiment-campaign engine of the port (own copy of the
reference's ``experiments/``; see docs/experiments.md).

Declare a sweep, run it as a campaign, collect tidy rows:

    from repro_torch.core import Policy
    from repro_torch.experiments import Campaign, Sweep, group_rows, frac

    sweep = Sweep(name="demo", policies=(Policy.mesc(),),
                  utils=(0.7, 0.9), n_sets=50)
    rows = Campaign(sweep).collect()          # parallel + cached
    for (u,), cell in group_rows(rows, "u").items():
        print(u, frac(cell, "success_all"))

Points are content-hashed and cached on disk (``results/campaigns`` by
default), so repeated or overlapping sweeps only simulate what is new.
Event and vec points run on the host; jit points run the lockstep
engine on the device the campaign names (``device=None``: the card).
"""
from repro_torch.experiments.spec import (FuncPoint, FuncSweep, SimPoint,
                                          Sweep, canonical_hash,
                                          canonical_json)
from repro_torch.experiments.cache import ResultCache, default_cache_dir
from repro_torch.experiments.runner import (Campaign, default_workers,
                                            run_sweep)
from repro_torch.experiments.metrics import (frac, group_rows,
                                             metrics_row, pooled_mean,
                                             ratio_of_sums)

__all__ = [
    "Sweep", "FuncSweep", "SimPoint", "FuncPoint",
    "canonical_hash", "canonical_json",
    "ResultCache", "default_cache_dir",
    "Campaign", "run_sweep", "default_workers",
    "metrics_row", "group_rows", "pooled_mean", "frac", "ratio_of_sums",
]
