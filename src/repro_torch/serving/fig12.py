"""Point function of the fig12 serving-SLO experiment (twin of the
reference's ``serving/fig12.py``).

One point = one deterministic open-loop serving run: a CRN workload
(``traffic.build_workload``) driven through the virtual-clock front end
(``frontend.run_virtual_serving``) under one scheduling policy,
summarized to one SLO row (``slo.slo_summary``).  The same ``(seed0,
set_index)`` and traffic knobs across policies give the same arrival and
service realizations, so the MESC-vs-non-preemptive delta in a row pair
is a pure policy effect.  Every row is byte-identical to the
reference's.

The offered-load axis is ``lo_load``: the LO arrival rate as a multiple
of pool capacity (``lanes x ServiceModelSpec.lane_capacity_rps``);
``lo_load >= 1`` saturates the pool.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.scheduler import Policy
from repro_torch.core.taskgen import point_seed
from repro_torch.serving.frontend import (ServiceModelSpec,
                                          run_virtual_serving)
from repro_torch.serving.slo import slo_summary
from repro_torch.serving.traffic import (Poisson, build_workload,
                                         make_process)

SERVING_SEMANTICS_VERSION = 1

POLICIES = {
    "mesc": Policy.mesc,
    "np": Policy.non_preemptive,
    "lp": Policy.limited,
    "amc": Policy.amc,
}


def simulate_fig12_point(*, policy: str, arrivals: str, lanes: int,
                         set_index: int, seed0: int = 0,
                         n_lo: int = 64, n_hi: int = 24,
                         lo_load: float = 1.2, hi_rate_rps: float = 0.25,
                         lo_tokens: int = 96, hi_tokens: int = 8,
                         hi_deadline_s: float = 0.5,
                         lo_deadline_s: Optional[float] = None,
                         decode_mean_ms: float = 10.0,
                         prefill_mean_ms: float = 20.0,
                         jitter: float = 0.25,
                         cs_ms: float = 4.0,
                         max_live_lo: Optional[int] = None,
                         trace_path: Optional[str] = None,
                         serving_v: Any = None) -> Dict[str, Any]:
    """One serving run -> one SLO row.

    ``policy`` names a :data:`POLICIES` entry; ``arrivals`` names the
    LO arrival process (``traffic.PROCESS_KINDS``); the HI stream is
    always Poisson at ``hi_rate_rps`` per lane.  ``lo_load`` scales the
    LO rate against pool capacity.  Every kwarg is JSON-able, and the
    row is byte-identical on replay.
    """
    del serving_v                   # cache-key salt only
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; "
                         f"want one of {sorted(POLICIES)}")
    seed = point_seed(seed0, set_index)
    svc = ServiceModelSpec(decode_mean_s=decode_mean_ms * 1e-3,
                           prefill_mean_s=prefill_mean_ms * 1e-3,
                           jitter=jitter,
                           cs_save_s=cs_ms * 1e-3,
                           cs_restore_s=cs_ms * 1e-3)
    # mean LO tokens is the midpoint of traffic._token_budget's
    # uniform [tokens/2, 3*tokens/2] draw = lo_tokens
    capacity = lanes * svc.lane_capacity_rps(float(lo_tokens))
    lo_rate = lo_load * capacity
    lo_process = make_process(arrivals, lo_rate, trace_path=trace_path)
    hi_process = Poisson(hi_rate_rps * lanes)
    workload = build_workload(seed=seed, lo_process=lo_process,
                              hi_process=hi_process,
                              n_lo=n_lo, n_hi=n_hi,
                              lo_tokens=lo_tokens, hi_tokens=hi_tokens)
    requests = run_virtual_serving(
        workload, lanes=lanes, policy=POLICIES[policy](), seed=seed,
        decode_mean_s=svc.decode_mean_s,
        prefill_mean_s=svc.prefill_mean_s, jitter=svc.jitter,
        cs_save_s=svc.cs_save_s, cs_restore_s=svc.cs_restore_s,
        max_live_lo=max_live_lo)
    row = slo_summary(requests.values(), hi_deadline_s=hi_deadline_s,
                      lo_deadline_s=lo_deadline_s)
    row["offered_lo_rps"] = float(lo_rate)
    row["capacity_rps"] = float(capacity)
    row["seed"] = seed
    # raw HI latencies ride along (sorted) so a figure can pool a true
    # p999 across set_index replications
    row["hi_latencies_s"] = sorted(
        r.finished_at - r.submitted_at
        for r in requests.values()
        if r.crit.value == "HI" and r.done and r.finished_at is not None)
    return row
