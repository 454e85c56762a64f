"""Tidy per-point metric rows and cross-point aggregation helpers (the
SS VIII figures' statistics, exact under re-grouping); own copy of the
reference's ``experiments/metrics.py``.

The simulator returns a :class:`repro_torch.core.simulator.RunMetrics` full of
per-event lists; the cache and the figure reports want flat, JSON-able
rows.  ``metrics_row`` flattens one run into sums/counts (not means), so
any grouping of rows can be re-aggregated exactly: a pooled mean over a
cell equals the mean over the concatenated per-event lists the legacy
serial scripts computed.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Tuple

from repro_torch.core.simulator import AggSamples, RunMetrics

# the sample families metrics_row flattens (also the upgrade list for
# rows cached before the {name}_mean columns existed)
SAMPLE_FAMILIES = ("pi", "ci", "save", "restore")


def ensure_row_means(row: Dict[str, Any]) -> Dict[str, Any]:
    """Backfill the ``{name}_mean`` columns on a row cached before
    they existed (event/vec cache namespaces were deliberately NOT
    invalidated for a derivable column — the mean is a pure function
    of the stored sum/count).  Fresh rows and non-sim rows (no
    ``{name}_n`` keys) pass through untouched."""
    for name in SAMPLE_FAMILIES:
        n_key, mean_key = f"{name}_n", f"{name}_mean"
        if n_key in row and mean_key not in row:
            n = row[n_key]
            row[mean_key] = row[f"{name}_sum"] / n if n else None
    return row


def metrics_row(m: RunMetrics, **point_fields: Any) -> Dict[str, Any]:
    """Flatten one run's metrics into a JSON-able row.

    ``point_fields`` (policy name, u, gamma, ...) are merged in so rows
    are self-describing and groupable without the originating spec.
    Per-event lists may arrive pre-aggregated as
    :class:`~repro_torch.core.simulator.AggSamples` (the jit backend carries
    sums/counts on-device instead of sample lists).  Each sample
    family also yields a per-run ``{name}_mean``; a zero-count
    aggregate means ``None`` (NaN's JSON-/equality-safe spelling —
    see the inline note) rather than raising ``ZeroDivisionError``.
    """
    row: Dict[str, Any] = dict(point_fields)
    for name, xs in (("pi", m.pi_blocking), ("ci", m.ci_blocking),
                     ("save", m.save_cycles), ("restore", m.restore_cycles)):
        if not isinstance(xs, AggSamples):
            xs = AggSamples(float(sum(xs)), len(xs))
        row[f"{name}_sum"] = xs.total
        row[f"{name}_n"] = xs.n
        # per-run mean via the one canonical definition
        # (AggSamples.mean: NaN when empty — zero blocking/save events
        # is normal), with NaN encoded as None in the row: the JSON-
        # safe spelling that also keeps row equality usable — NaN !=
        # NaN would break the cross-engine row-comparison gates and
        # the cache round-trip, None == None does not
        mean = xs.mean
        row[f"{name}_mean"] = None if math.isnan(mean) else mean
    row.update(
        jobs_lo=m.jobs["LO"], jobs_hi=m.jobs["HI"],
        done_lo=m.done["LO"], done_hi=m.done["HI"],
        misses_lo=m.misses["LO"], misses_hi=m.misses["HI"],
        misses_by_mode=dict(m.misses_by_mode),
        lo_released_in_hi=m.lo_released_in_hi,
        lo_done_in_hi=m.lo_done_in_hi,
        mode_cycles=dict(m.mode_cycles),
        cs_count=m.cs_count,
        exec_cycles=float(m.exec_cycles),
        overhead_cycles=float(m.overhead_cycles),
        success_all=int(m.success()),
        success_hi=int(m.success("HI")),
        survivability=float(m.survivability()),
    )
    return row


# ----------------------------------------------------------------------
def group_rows(rows: Iterable[Dict[str, Any]],
               *keys: str) -> Dict[Tuple, List[Dict[str, Any]]]:
    """Group rows by the given field names (insertion-ordered)."""
    out: Dict[Tuple, List[Dict[str, Any]]] = defaultdict(list)
    for r in rows:
        out[tuple(r[k] for k in keys)].append(r)
    return dict(out)


def pooled_mean(rows: Iterable[Dict[str, Any]], name: str) -> float:
    """Mean of the concatenated per-event list ``name`` across rows
    (rows carry ``{name}_sum`` / ``{name}_n``).  A cell with zero
    events pools to NaN — "no samples" must read as *no data*, not as
    a blocking time of 0.0 — and never raises ``ZeroDivisionError``."""
    rows = list(rows)
    n = sum(r[f"{name}_n"] for r in rows)
    if n == 0:
        return float("nan")
    return sum(r[f"{name}_sum"] for r in rows) / n


def frac(rows: Iterable[Dict[str, Any]], field: str) -> float:
    """Mean of a per-row scalar (e.g. ``success_all`` -> success ratio)."""
    rows = list(rows)
    if not rows:
        return 0.0
    return sum(r[field] for r in rows) / len(rows)


def ratio_of_sums(rows: Iterable[Dict[str, Any]], num: str,
                  den: str) -> float:
    rows = list(rows)
    d = sum(r[den] for r in rows)
    return sum(r[num] for r in rows) / d if d else float("nan")
