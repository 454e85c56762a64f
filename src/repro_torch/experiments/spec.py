"""Declarative sweep specifications for the campaign engine (the
SS VIII experimental campaigns as data); own copy of the reference's
``experiments/spec.py``, giving the same point keys and spec hashes.

A *sweep* is the unit the engine plans: a grid of independent *points*,
each of which is one unit of work a worker process can execute on its
own.  Two sweep flavours cover the repo's experiments:

  * :class:`Sweep` — the paper's simulation campaigns: a cartesian grid
    of policies x utilisations x gammas x taskset sizes x set indices.
    Each point is one taskset generation + one DES run
    (``core.simulator.MCSSimulator``), seeded by the deterministic
    per-point contract ``core.taskgen.point_seed`` (seed0 + set_index),
    which makes every point reproducible in isolation and keeps the
    engine's output bit-identical to the legacy serial loops.
  * :class:`FuncSweep` — analysis fan-outs (per-workload instruction
    statistics, roofline cells, ...): each point calls a module-level
    function referenced as ``"package.module:function"`` with
    JSON-able kwargs.

Every point owns a stable content hash (:func:`canonical_hash` over its
canonical-JSON form) used as its result-cache key, and every sweep owns
a ``spec_hash`` over the full spec — the campaign manifest key.  Hashes
depend only on point *content*, so two sweeps that share points share
cache entries.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator import DEMAND_PROFILES, SIM_SEMANTICS_VERSION
# both engine salts live in simulator_vec: hashing a jit point does
# not load the lockstep engine into every campaign worker
from repro_torch.core.simulator_vec import (JIT_SIM_SEMANTICS_VERSION,
                                            VEC_SIM_SEMANTICS_VERSION)
from repro_torch.core.taskgen import point_seed
from repro_torch.scenarios import get_scenario

SPEC_VERSION = 1

ENGINES = ("event", "vec", "jit")


def canonical_json(obj: Any) -> str:
    """Key-sorted, whitespace-free JSON — the hashing wire format."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def canonical_hash(obj: Any) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()


def policy_to_dict(policy: Policy) -> Dict[str, Any]:
    return dataclasses.asdict(policy)


def policy_from_dict(d: Dict[str, Any]) -> Policy:
    return Policy(**d)


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SimPoint:
    """One taskset + one simulator run; the engine's atomic sim unit."""
    policy: Tuple[Tuple[str, Any], ...]   # sorted Policy asdict items
    u: float
    gamma: float
    n_tasks: int
    set_index: int
    seed: int
    duration: float
    cf: float
    overrun_prob: float
    library: str = "sim"                  # 'sim' (no arch:*) | 'all'
    engine: str = "event"                 # 'event' | 'vec' | 'jit'
    devices: Optional[int] = None         # jit only: device count
    scenario: Optional[str] = None        # scenarios.get_scenario name
    demand_profile: str = "sampled"       # 'sampled' | 'nominal'

    kind = "sim"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["policy"] = dict(self.policy)
        d["kind"] = self.kind
        d["v"] = SPEC_VERSION
        # ties cache entries to the simulator's semantics, not just the
        # spec format: bumping core.simulator.SIM_SEMANTICS_VERSION
        # invalidates every cached sim point
        d["sim_v"] = SIM_SEMANTICS_VERSION
        # Cache contract across engines: event-engine points serialize
        # exactly as before this field existed (their keys — and every
        # previously cached result — survive), while vec/jit points
        # carry the engine tag plus their own semantics salt, so no
        # two engines ever share or clobber cache entries.
        if self.engine == "event":
            d.pop("engine")
        elif self.engine == "jit":
            d["jit_sim_v"] = JIT_SIM_SEMANTICS_VERSION
        else:
            d["vec_sim_v"] = VEC_SIM_SEMANTICS_VERSION
        # devices rides in worker payloads but never in cache keys —
        # see key(); omitting the default keeps old payloads identical
        if self.devices is None:
            d.pop("devices")
        # scenario / demand_profile salt the key only when non-default,
        # so every pre-scenario point hash stays byte-stable
        if self.scenario is None:
            d.pop("scenario")
        if self.demand_profile == "sampled":
            d.pop("demand_profile")
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SimPoint":
        return SimPoint(
            policy=tuple(sorted(d["policy"].items())),
            u=d["u"], gamma=d["gamma"], n_tasks=d["n_tasks"],
            set_index=d["set_index"], seed=d["seed"],
            duration=d["duration"], cf=d["cf"],
            overrun_prob=d["overrun_prob"],
            library=d.get("library", "sim"),
            engine=d.get("engine", "event"),
            devices=d.get("devices"),
            scenario=d.get("scenario"),
            demand_profile=d.get("demand_profile", "sampled"))

    def key(self) -> str:
        # the sharded jit engine is bit-identical at every device count
        # (per-point keyed RNG draws), so the device count is execution
        # placement, not semantics: points at different counts SHARE
        # cache entries (pinned by tests/test_campaign_cache.py)
        d = self.to_dict()
        d.pop("devices", None)
        return canonical_hash(d)

    def policy_obj(self) -> Policy:
        return policy_from_dict(dict(self.policy))


@dataclasses.dataclass(frozen=True)
class FuncPoint:
    """One call of an importable function with JSON-able kwargs."""
    fn: str                                # "package.module:function"
    kwargs: Tuple[Tuple[str, Any], ...]    # sorted items

    kind = "func"

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "v": SPEC_VERSION, "fn": self.fn,
                "kwargs": dict(self.kwargs)}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FuncPoint":
        return FuncPoint(fn=d["fn"],
                         kwargs=tuple(sorted(d["kwargs"].items())))

    def key(self) -> str:
        return canonical_hash(self.to_dict())


def point_from_dict(d: Dict[str, Any]):
    if d.get("kind") == "func":
        return FuncPoint.from_dict(d)
    return SimPoint.from_dict(d)


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sweep:
    """Cartesian simulation grid: policies x utils x gammas x betas x sets.

    ``n_sets`` task sets are drawn per grid cell, set ``s`` seeded with
    ``point_seed(seed0, s)`` for both taskset generation and the
    simulator — identical to the legacy ``benchmarks.common.run_many``
    loop, so engine results match the pre-engine serial outputs exactly.
    """
    name: str
    policies: Tuple[Policy, ...]
    utils: Tuple[float, ...] = (0.8,)
    gammas: Tuple[float, ...] = (0.5,)
    n_tasks: Tuple[int, ...] = (10,)
    n_sets: int = 100
    seed0: int = 0
    duration: float = 2e8
    cf: float = 2.0
    overrun_prob: float = 0.3
    library: str = "sim"
    engine: str = "event"                 # 'event' | 'vec' | 'jit'
    devices: Optional[int] = None         # jit only: device count
    scenario: Optional[str] = None        # scenarios.get_scenario name
    demand_profile: str = "sampled"       # 'sampled' | 'nominal'

    def __post_init__(self):
        names = [p.name for p in self.policies]
        if len(set(names)) != len(names):
            raise ValueError(
                f"sweep {self.name!r}: policy names must be unique "
                f"(got {names}); use dataclasses.replace(p, name=...)")
        if self.engine not in ENGINES:
            raise ValueError(f"sweep {self.name!r}: unknown engine "
                             f"{self.engine!r}; want one of {ENGINES}")
        if self.demand_profile not in DEMAND_PROFILES:
            raise ValueError(
                f"sweep {self.name!r}: unknown demand_profile "
                f"{self.demand_profile!r}; want one of {DEMAND_PROFILES}")
        try:
            get_scenario(self.scenario)
        except ValueError as e:
            raise ValueError(f"sweep {self.name!r}: {e}") from None
        if self.devices is not None:
            if self.engine != "jit":
                raise ValueError(
                    f"sweep {self.name!r}: devices={self.devices} "
                    f"requires engine='jit' (the {self.engine!r} "
                    "engine runs on the host)")
            if self.devices < 1:
                raise ValueError(f"sweep {self.name!r}: devices="
                                 f"{self.devices} must be >= 1")

    def points(self) -> List[SimPoint]:
        out = []
        for pol in self.policies:
            pol_items = tuple(sorted(policy_to_dict(pol).items()))
            for u in self.utils:
                for g in self.gammas:
                    for b in self.n_tasks:
                        for s in range(self.n_sets):
                            out.append(SimPoint(
                                policy=pol_items, u=u, gamma=g,
                                n_tasks=b, set_index=s,
                                seed=point_seed(self.seed0, s),
                                duration=self.duration, cf=self.cf,
                                overrun_prob=self.overrun_prob,
                                library=self.library,
                                engine=self.engine,
                                devices=self.devices,
                                scenario=self.scenario,
                                demand_profile=self.demand_profile))
        return out

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["policies"] = [policy_to_dict(p) for p in self.policies]
        d["kind"] = "sweep"
        d["v"] = SPEC_VERSION
        if self.engine == "event":        # keep pre-engine spec hashes
            d.pop("engine")
        if self.devices is None:          # keep pre-sharding hashes
            d.pop("devices")
        if self.scenario is None:         # keep pre-scenario hashes
            d.pop("scenario")
        if self.demand_profile == "sampled":
            d.pop("demand_profile")
        return d

    def spec_hash(self) -> str:
        return canonical_hash(self.to_dict())


@dataclasses.dataclass(frozen=True)
class FuncSweep:
    """Fan-out of one importable function over a list of kwargs dicts.

    ``cache=False`` marks sweeps whose points read mutable filesystem
    state (e.g. roofline over dry-run artifacts) — they always re-run.
    """
    name: str
    fn: str
    items: Tuple[Tuple[Tuple[str, Any], ...], ...]
    cache: bool = True

    @staticmethod
    def over(name: str, fn: str, items: Sequence[Dict[str, Any]],
             cache: bool = True) -> "FuncSweep":
        return FuncSweep(
            name=name, fn=fn, cache=cache,
            items=tuple(tuple(sorted(it.items())) for it in items))

    def points(self) -> List[FuncPoint]:
        return [FuncPoint(fn=self.fn, kwargs=it) for it in self.items]

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "func_sweep", "v": SPEC_VERSION, "name": self.name,
                "fn": self.fn, "cache": self.cache,
                "items": [dict(it) for it in self.items]}

    def spec_hash(self) -> str:
        return canonical_hash(self.to_dict())
