"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration and a traffic mix; each is one JSON file
(``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``).  A
metric is one module, ``bench/metrics/<name>.py``, holding
``read(run) -> float | None``.  Nothing here knows a particular cell, so
a later cell, mix or metric needs only new files and new entries.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _metric_applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics a run of this cell reports: the end-to-end ones
        untraced, the per-layer ones traced."""
        return self.per_layer if trace else self.end_to_end


def resolve(workload: str, bench: Optional[dict] = None,
            root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    conf_file = root / confs[w["config"]]["file"]
    with open(conf_file) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=workload, config=config, traffic=traffic, chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"]
                    if _metric_applies(m, workload)],
        per_layer=[m for m in bench["per_layer"]
                   if _metric_applies(m, workload)])


def metric_reader(name: str) -> Callable:
    """``read`` of ``bench/metrics/<name>.py`` (loaded by path, so a
    metric's name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """Each metric that its reader finds, as {"value", "unit"}; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
