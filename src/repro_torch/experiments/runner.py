"""Campaign runner: fan sweep points (SS VIII experiment units) out
across worker processes (own copy of the reference's
``experiments/runner.py``, with the lockstep engine placed on a device).

Each point of a :class:`~repro_torch.experiments.spec.Sweep` is one
independent DES run (the simulator is embarrassingly parallel per
point), so the runner simply:

  1. expands the sweep into points and looks each point's content hash
     up in the :class:`~repro_torch.experiments.cache.ResultCache`;
  2. executes only the misses — serially for tiny batches, otherwise on
     a ``ProcessPoolExecutor`` (workers default to the CPU count, or
     the ``REPRO_WORKERS`` env var);
  3. writes each fresh row back to the cache and a campaign manifest
     under the sweep's spec hash.

Execution has two shapes:

  * ``engine="event"`` points run one DES per point (``_run_sim``),
    mapped over the pool with taskset construction memoized per worker
    (``_memo_taskset``) — a sweep that revisits the same
    ``(u, gamma, n_tasks, cf, seed)`` cell under several policies
    builds each task set once per worker instead of once per point;
  * ``engine="vec"`` / ``engine="jit"`` points are grouped into whole
    cache-miss *chunks* and handed to the vectorized SoA backend
    (``core.simulator_vec.simulate_vbatch``, which routes ``jit`` on
    to the lockstep engine ``core.simulator_jit``), advancing hundreds
    of points per lockstep step.  The content-addressed cache contract
    is unchanged: every point is still keyed and stored individually
    (vec keys carry ``VEC_SIM_SEMANTICS_VERSION``, jit keys
    ``JIT_SIM_SEMANTICS_VERSION``).

Placement.  Event and vec points go to the worker pool, as in the
reference.  Jit chunks run in the calling process, on the campaign's
``device`` (``None``: the CUDA card; ``"cpu"`` only when asked for),
while the pool works: a forked worker cannot use CUDA once the parent
has initialised it, and one card gains nothing from several processes
each capturing its own CUDA graphs.  Placement changes no row — every
row belongs to one point, and rows do not depend on how points are
batched.

``Campaign.collect()`` returns the tidy per-point rows in point order,
cache hits and fresh runs interleaved transparently — re-running an
identical sweep touches no simulator at all.
"""
from __future__ import annotations

import functools
import importlib
import os
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core.simulator import simulate
from repro_torch.core.simulator_vec import simulate_vbatch
from repro_torch.core.taskgen import generate_taskset
from repro_torch.experiments.cache import ResultCache
from repro_torch.experiments.metrics import ensure_row_means, metrics_row
from repro_torch.experiments.spec import (FuncPoint, FuncSweep, SimPoint,
                                          Sweep, point_from_dict,
                                          policy_from_dict)
from repro_torch.runtime.device_config import _env_int

# max points per vectorized chunk: wide batches amortize the lockstep
# overhead (hundreds of points per argmin), and one chunk is one unit
# of worker-pool scheduling
VEC_CHUNK = 512


def default_workers() -> int:
    """Worker-pool width: ``REPRO_WORKERS`` (validated — junk or
    non-positive values raise naming the variable) or the CPU count."""
    return _env_int("REPRO_WORKERS", max(os.cpu_count() or 1, 1))


@functools.lru_cache(maxsize=None)
def cached_library(which: str) -> Dict[str, Any]:
    """Per-process workload library ('sim' excludes the arch:* models).
    'sim' is derived from the cached 'all' build, so a process touching
    both pays the program-construction cost once."""
    if which == "sim":
        return {k: v for k, v in cached_library("all").items()
                if not k.startswith("arch:")}
    from repro_torch.core.program import workload_library
    return workload_library(include_archs=True)


def _resolve(fn_ref: str):
    mod_name, _, fn_name = fn_ref.partition(":")
    if not fn_name:
        raise ValueError(f"bad function ref {fn_ref!r}; want 'module:fn'")
    return getattr(importlib.import_module(mod_name), fn_name)


@functools.lru_cache(maxsize=4096)
def _memo_taskset(u: float, gamma: float, n_tasks: int, cf: float,
                  seed: int, library: str):
    """Per-worker taskset memo: sweeps revisit the same generation cell
    under several policies, so build each task set once per process.
    The returned list is shared — callers must not mutate it."""
    return generate_taskset(u, gamma=gamma, n_tasks=n_tasks, cf=cf,
                            seed=seed, programs=cached_library(library))


def _run_sim(point: SimPoint) -> Dict[str, Any]:
    programs = cached_library(point.library)
    policy = point.policy_obj()
    tasks = _memo_taskset(point.u, point.gamma, point.n_tasks, point.cf,
                          point.seed, point.library)
    if point.engine in ("vec", "jit"):
        m = simulate_vbatch([tasks], programs, policy, seeds=[point.seed],
                            duration=point.duration,
                            overrun_prob=point.overrun_prob,
                            cf=point.cf,
                            select_backend="numpy" if point.engine == "vec"
                            else "jit",
                            devices=point.devices,
                            demand_profile=point.demand_profile,
                            scenario=point.scenario)[0]
    else:
        m = simulate(tasks, programs, policy, duration=point.duration,
                     seed=point.seed, overrun_prob=point.overrun_prob,
                     cf=point.cf, demand_profile=point.demand_profile,
                     scenario=point.scenario)
    return metrics_row(m, policy=policy.name, u=point.u, gamma=point.gamma,
                       n_tasks=point.n_tasks, set_index=point.set_index,
                       seed=point.seed)


def _run_func(point: FuncPoint) -> Dict[str, Any]:
    kwargs = dict(point.kwargs)
    result = _resolve(point.fn)(**kwargs)
    if not isinstance(result, dict):
        result = {"result": result}
    for k, v in kwargs.items():      # make rows self-describing
        result.setdefault(k, v)
    return result


def _execute(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Top-level worker entry point (must be picklable)."""
    point = point_from_dict(payload)
    if isinstance(point, FuncPoint):
        return _run_func(point)
    return _run_sim(point)


def _execute_chunk(payloads: List[Dict[str, Any]],
                   device=None) -> List[Dict[str, Any]]:
    """Worker entry point for a whole chunk of points.

    Vec- and jit-engine sim points are grouped by engine plus their
    shared scalar parameters (policy / duration / cf / overrun_prob /
    library) and executed in one ``simulate_vbatch`` call per group —
    the batch-execution fast path.  Anything else in the chunk falls
    back to the per-point runners.  Row order matches the input
    payload order.  ``device`` reaches jit groups only.
    """
    rows: List[Optional[Dict[str, Any]]] = [None] * len(payloads)
    groups: Dict[Tuple, List[Tuple[int, SimPoint]]] = {}
    for i, d in enumerate(payloads):
        point = point_from_dict(d)
        if isinstance(point, SimPoint) and point.engine in ("vec", "jit"):
            key = (point.engine, point.policy, point.duration, point.cf,
                   point.overrun_prob, point.library, point.devices,
                   point.scenario, point.demand_profile)
            groups.setdefault(key, []).append((i, point))
        elif isinstance(point, FuncPoint):
            rows[i] = _run_func(point)
        else:
            rows[i] = _run_sim(point)
    for (engine, pol_items, duration, cf, op, library, devices,
         scenario, demand_profile), items in groups.items():
        programs = cached_library(library)
        policy = policy_from_dict(dict(pol_items))
        tasksets = [_memo_taskset(pt.u, pt.gamma, pt.n_tasks, pt.cf,
                                  pt.seed, library) for _, pt in items]
        seeds = [pt.seed for _, pt in items]
        ms = simulate_vbatch(tasksets, programs, policy, seeds=seeds,
                             duration=duration, overrun_prob=op, cf=cf,
                             batch_size=VEC_CHUNK,
                             select_backend="numpy" if engine == "vec"
                             else "jit",
                             devices=devices,
                             demand_profile=demand_profile,
                             scenario=scenario,
                             device=device if engine == "jit" else None)
        for (i, pt), m in zip(items, ms):
            rows[i] = metrics_row(
                m, policy=policy.name, u=pt.u, gamma=pt.gamma,
                n_tasks=pt.n_tasks, set_index=pt.set_index, seed=pt.seed)
    return rows  # type: ignore[return-value]


def _echo_point(**kwargs) -> Dict[str, Any]:
    """Trivial FuncSweep target used by the engine's own tests."""
    return {"echo": True, "pid": os.getpid(), **kwargs}


# ----------------------------------------------------------------------
class Campaign:
    """Plan, execute (in parallel, cached) and collect one sweep.

    ``device`` is where jit points run (``None``: the CUDA card, raising
    when there is none; ``"cpu"`` only when asked for); event, vec and
    function points ignore it and run on the host.
    """

    def __init__(self, sweep: Union[Sweep, FuncSweep], *,
                 cache_dir: Optional[Union[str, Path]] = None,
                 workers: Optional[int] = None,
                 use_cache: bool = True, device=None):
        self.sweep = sweep
        self.workers = default_workers() if workers is None else max(workers, 1)
        self.use_cache = use_cache and getattr(sweep, "cache", True)
        self.cache = ResultCache(cache_dir) if self.use_cache else None
        self.device = device
        self.stats = {"hits": 0, "misses": 0}
        self._rows: Optional[List[Dict[str, Any]]] = None

    def run(self) -> "Campaign":
        points = self.sweep.points()
        keys = [p.key() for p in points]
        rows: List[Optional[Dict[str, Any]]] = [None] * len(points)
        todo: List[int] = []
        for i, k in enumerate(keys):
            cached = self.cache.get(k) if self.use_cache else None
            if cached is not None:
                # rows cached before the {name}_mean columns existed
                # are upgraded in place (the mean is derivable from
                # the stored sum/count — no cache invalidation needed)
                rows[i] = ensure_row_means(cached)
            else:
                todo.append(i)
        self.stats = {"hits": len(points) - len(todo), "misses": len(todo)}

        payloads = [points[i].to_dict() for i in todo]
        # vec/jit-engine sim points take the chunked batch-execution
        # path: whole cache-miss chunks go to simulate_vbatch instead
        # of one point per task (each point still cached individually);
        # jit chunks run here, on self.device, the rest in the pool
        engine = [points[i].engine if isinstance(points[i], SimPoint)
                  else None for i in todo]
        jit_sel = [k for k, e in enumerate(engine) if e == "jit"]
        vec_sel = [k for k, e in enumerate(engine) if e == "vec"]
        other_sel = [k for k, e in enumerate(engine)
                     if e not in ("vec", "jit")]
        if len(payloads) <= 1 or self.workers <= 1:
            self._run_jit(jit_sel, todo, keys, rows, payloads)
            if vec_sel:
                out = _execute_chunk([payloads[k] for k in vec_sel])
                self._drain([todo[k] for k in vec_sel], keys, rows, out)
            fresh = (_execute(payloads[k]) for k in other_sel)
            self._drain([todo[k] for k in other_sel], keys, rows, fresh)
        else:
            with ProcessPoolExecutor(max_workers=self.workers) as ex:
                futures = {}
                if vec_sel:
                    per = max(1, min(VEC_CHUNK,
                                     -(-len(vec_sel) // self.workers)))
                    for lo in range(0, len(vec_sel), per):
                        sel = vec_sel[lo:lo + per]
                        fut = ex.submit(_execute_chunk,
                                        [payloads[k] for k in sel])
                        futures[fut] = sel
                fresh = ()
                if other_sel:
                    chunk = max(1, len(other_sel) // (self.workers * 8))
                    fresh = ex.map(_execute,
                                   [payloads[k] for k in other_sel],
                                   chunksize=chunk)
                # the pool has every task (it starts no worker when it
                # has none); the jit chunks run here meanwhile
                self._run_jit(jit_sel, todo, keys, rows, payloads)
                self._drain([todo[k] for k in other_sel], keys, rows,
                            fresh)
                # drain chunks as they finish, so a killed campaign
                # keeps every completed chunk (the per-point streaming
                # guarantee, at chunk granularity)
                for fut in as_completed(futures):
                    sel = futures[fut]
                    self._drain([todo[k] for k in sel], keys, rows,
                                fut.result())

        if self.use_cache:
            self.cache.write_manifest(self.sweep.spec_hash(), {
                "name": self.sweep.name,
                "spec_hash": self.sweep.spec_hash(),
                "spec": self.sweep.to_dict(),
                "n_points": len(points),
                "last_run": dict(self.stats),
                "point_keys": keys,
            })
        self._rows = rows  # type: ignore[assignment]
        return self

    def _run_jit(self, jit_sel, todo, keys, rows, payloads) -> None:
        """Run the jit points in this process on ``self.device``, one
        chunk of ``VEC_CHUNK`` at a time, storing each chunk's rows as
        it finishes."""
        for lo in range(0, len(jit_sel), VEC_CHUNK):
            sel = jit_sel[lo:lo + VEC_CHUNK]
            out = _execute_chunk([payloads[k] for k in sel], self.device)
            self._drain([todo[k] for k in sel], keys, rows, out)

    def _drain(self, todo, keys, rows, fresh) -> None:
        """Store rows as they stream in, so a killed campaign keeps
        every completed point and the next run resumes from there."""
        for i, row in zip(todo, fresh):
            rows[i] = row
            if self.use_cache:
                self.cache.put(keys[i], row)

    def collect(self) -> List[Dict[str, Any]]:
        """Tidy per-point rows, in point order (runs the sweep if needed)."""
        if self._rows is None:
            self.run()
        return list(self._rows)  # type: ignore[arg-type]


def run_sweep(sweep: Union[Sweep, FuncSweep],
              **campaign_kw) -> List[Dict[str, Any]]:
    """One-shot convenience: ``Campaign(sweep, **kw).collect()``
    (``device=`` places the jit points, as in :class:`Campaign`)."""
    return Campaign(sweep, **campaign_kw).collect()
