"""Per-request SLO metrics for the serving front end (twin of the
reference's ``serving/slo.py``).

  * **latency** — ``finished_at - submitted_at``: arrival at the front
    door to last token, so queueing under overload is in the number;
  * **TTFT** — ``first_token_at - submitted_at``: time to first token;
  * **deadline-miss rate** — fraction of a class's requests whose
    latency exceeds that class's deadline (unfinished requests count as
    misses);
  * **goodput** — finished-within-deadline requests per second of
    makespan.

Tail percentiles use the deterministic nearest-rank definition
(:func:`nearest_rank`): no interpolation, so a summary is a pure,
byte-stable function of the request set.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.core.task import Crit

#: The quantiles every class reports, as (field tag, q) pairs.
QUANTILES = (("p50", 0.50), ("p99", 0.99), ("p999", 0.999))


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank quantile: the ceil(q*n)-th smallest value (one of
    the inputs, never an interpolation); ``None`` on an empty sample."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile q={q} must be in (0, 1]")
    xs = sorted(values)
    if not xs:
        return None
    return float(xs[max(0, math.ceil(q * len(xs)) - 1)])


def _class_block(tag: str, reqs: List[Any],
                 deadline_s: Optional[float]) -> Dict[str, Any]:
    """SLO block for one criticality class (``tag`` in {'hi', 'lo'})."""
    fin = [r for r in reqs if r.done and r.finished_at is not None]
    lat = sorted(r.finished_at - r.submitted_at for r in fin)
    ttft = sorted(r.first_token_at - r.submitted_at for r in fin
                  if r.first_token_at is not None)
    out: Dict[str, Any] = {
        f"{tag}_n": len(reqs),
        f"{tag}_finished": len(fin),
        f"{tag}_mean_latency_s":
            (sum(lat) / len(lat)) if lat else None,
    }
    for name, q in QUANTILES:
        out[f"{tag}_{name}_latency_s"] = nearest_rank(lat, q)
    for name, q in QUANTILES[:2]:                 # TTFT tail: p50/p99
        out[f"{tag}_{name}_ttft_s"] = nearest_rank(ttft, q)
    if deadline_s is not None:
        # unfinished requests are misses by definition
        missed = sum(1 for v in lat if v > deadline_s) \
            + (len(reqs) - len(fin))
        out[f"{tag}_deadline_s"] = float(deadline_s)
        out[f"{tag}_miss_rate"] = missed / len(reqs) if reqs else None
        out[f"{tag}_in_deadline"] = len(reqs) - missed
    else:
        out[f"{tag}_deadline_s"] = None
        out[f"{tag}_miss_rate"] = None
        out[f"{tag}_in_deadline"] = len(fin)
    out[f"{tag}_preemptions"] = sum(r.preemptions for r in reqs)
    out[f"{tag}_saves"] = sum(r.saves for r in reqs)
    return out


def slo_summary(requests: Iterable[Any], *,
                hi_deadline_s: Optional[float] = None,
                lo_deadline_s: Optional[float] = None) -> Dict[str, Any]:
    """Flatten a finished (or partly finished) request set into one
    SLO row: per-class latency/TTFT tails, deadline-miss rates, and
    goodput over the serving makespan.

    ``requests`` is any iterable of ``core.serving.Request``."""
    reqs = list(requests)
    row: Dict[str, Any] = {}
    by_crit = {"hi": [r for r in reqs if r.crit == Crit.HI],
               "lo": [r for r in reqs if r.crit == Crit.LO]}
    row.update(_class_block("hi", by_crit["hi"], hi_deadline_s))
    row.update(_class_block("lo", by_crit["lo"], lo_deadline_s))

    fin = [r for r in reqs if r.done and r.finished_at is not None]
    sub = [r.submitted_at for r in reqs if r.submitted_at is not None]
    makespan = (max(r.finished_at for r in fin) - min(sub)) \
        if fin and sub else 0.0
    row["makespan_s"] = float(makespan)
    row["tokens_generated"] = sum(len(r.generated) for r in fin)
    in_deadline = row["hi_in_deadline"] + row["lo_in_deadline"]
    row["goodput_rps"] = in_deadline / makespan if makespan > 0 else None
    row["hi_goodput_rps"] = (row["hi_in_deadline"] / makespan
                             if makespan > 0 else None)
    row["throughput_rps"] = len(fin) / makespan if makespan > 0 else None
    return row
