"""The port's campaign engine (``repro_torch.experiments``) against the
JAX package's: point keys and spec hashes (the committed
``engine_point_hashes.json``), ``Campaign`` rows on fig8's sweep recipe
for the event, vec and jit engines (the port's jit on ``device="cpu"``),
fig11's multi-accelerator ``FuncSweep``, the result cache, the worker
pool with jit chunks run in the calling process, and the row helpers.

Every campaign here writes to a fresh ``tmp_path`` cache (or none): the
two packages share cache keys, so a check must never read a row it did
not compute.  JAX 0.9 has no ``jax.experimental.enable_x64``, which the
reference's jit engine imports; the ``x64`` fixture points it at
``jax.enable_x64``, the same context manager, for these tests only.
"""
import json
from pathlib import Path

import jax
import jax.experimental
import pytest
import torch

import chip_smoke
from repro.core import Policy as JPolicy
from repro.experiments import Campaign as JCampaign
from repro.experiments import FuncSweep as JFuncSweep
from repro.experiments import Sweep as JSweep
from repro.experiments import metrics as j_metrics
from repro.experiments import runner as j_runner
from repro.experiments import spec as j_spec
from repro.experiments.cache import default_cache_dir as j_default_cache_dir

from repro_torch.core import simulator_jit
from repro_torch.core.scheduler import Policy
from repro_torch.experiments import (Campaign, FuncSweep, ResultCache,
                                     SimPoint, Sweep, default_cache_dir,
                                     default_workers, frac, group_rows,
                                     metrics, pooled_mean, ratio_of_sums,
                                     run_sweep, spec)

ROOT = Path(__file__).resolve().parents[1]
HASHES = json.loads((ROOT / "tests" / "data"
                     / "engine_point_hashes.json").read_text())


@pytest.fixture(autouse=True)
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            jax.enable_x64, raising=False)


def ref_fig8(engine, n_sets):
    """The reference's twin of chip_smoke.fig8_sweep."""
    systems = (JPolicy.mesc(), JPolicy.non_preemptive(), JPolicy.amc(),
               JPolicy(preemption="none", drop_lo_in_hi=True, name="amc-np"))
    return JSweep(name="fig8_success", policies=systems,
                  utils=chip_smoke.CAMPAIGN_UTILS, n_sets=n_sets,
                  duration=chip_smoke.CAMPAIGN_DURATION, engine=engine)


@pytest.mark.parametrize("engine", ["event", "vec", "jit"])
def test_point_keys_and_spec_hash_equal_the_committed_fixture(engine):
    want = HASHES[engine]
    sweep = Sweep(name="fixture", policies=(Policy.mesc(), Policy.amc()),
                  utils=(0.7, 0.9), n_sets=2, duration=2e7, engine=engine)
    pts = sweep.points()
    for i in range(4):
        assert pts[i].key() == want[f"point_{i}"], (engine, i)
    assert sweep.spec_hash() == want["spec_hash"]
    ref = JSweep(name="fixture", policies=(JPolicy.mesc(), JPolicy.amc()),
                 utils=(0.7, 0.9), n_sets=2, duration=2e7, engine=engine)
    assert [p.to_dict() for p in pts] == [p.to_dict() for p in ref.points()]
    assert sweep.to_dict() == ref.to_dict()
    # devices is placement, not semantics: it never reaches a key
    if engine == "jit":
        sharded = Sweep(name="fixture", policies=(Policy.mesc(),),
                        n_sets=1, duration=2e7, engine="jit", devices=2)
        assert sharded.points()[0].key() == Sweep(
            name="fixture", policies=(Policy.mesc(),), n_sets=1,
            duration=2e7, engine="jit").points()[0].key()
    p = pts[3]
    assert SimPoint.from_dict(p.to_dict()) == p
    assert spec.point_from_dict(p.to_dict()) == p


def test_sweep_validation_equals_the_reference():
    bad = [dict(engine="cuda"), dict(demand_profile="flat"),
           dict(scenario="no-such-scenario"), dict(devices=2),
           dict(engine="jit", devices=0)]
    for kw in bad:
        with pytest.raises(ValueError) as got:
            Sweep(name="t", policies=(Policy.mesc(),), n_sets=1, **kw)
        with pytest.raises(ValueError) as want:
            JSweep(name="t", policies=(JPolicy.mesc(),), n_sets=1, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unique"):
        Sweep(name="t", policies=(Policy.mesc(), Policy.mesc()))
    assert spec.ENGINES == ("event", "vec", "jit")
    assert spec.SPEC_VERSION == 1
    obj = {"b": 1, "a": [1.5, None]}
    assert spec.canonical_json(obj) == j_spec.canonical_json(obj)
    assert spec.canonical_hash(obj) == j_spec.canonical_hash(obj)


@pytest.mark.parametrize("engine", ["event", "vec", "jit"])
def test_campaign_rows_equal_the_reference(engine, tmp_path):
    sweep = chip_smoke.fig8_sweep(engine, n_sets=2)
    c = Campaign(sweep, cache_dir=tmp_path / "port", workers=1,
                 device="cpu")
    rows = c.collect()
    assert c.stats == {"hits": 0, "misses": len(rows)} and len(rows) == 48
    want = JCampaign(ref_fig8(engine, 2), use_cache=False,
                     workers=1).collect()
    assert rows == want
    assert [p.key() for p in sweep.points()] == \
        [p.key() for p in ref_fig8(engine, 2).points()]
    assert sweep.spec_hash() == ref_fig8(engine, 2).spec_hash()


@pytest.mark.parametrize("engine", ["event", "vec", "jit"])
def test_fig8_campaign_rows_equal_the_chip_pin(engine, tmp_path):
    """chip_smoke phase 9 holds the card's campaign to these pins."""
    c = Campaign(chip_smoke.fig8_sweep(engine), cache_dir=tmp_path,
                 workers=2, device="cpu")
    rows = c.collect()
    assert c.stats["misses"] == len(rows) == 192
    assert chip_smoke.rows_digest(rows) == \
        chip_smoke.SIM_PINS[f"fig8/{engine}"]


def test_fig11_multiacc_func_sweep_rows_equal_the_reference_and_pin(
        tmp_path):
    sweep = chip_smoke.fig11_sweep()
    assert sweep.fn == \
        "repro_torch.experiments.multiacc:simulate_multiacc_point"
    c = Campaign(sweep, cache_dir=tmp_path, workers=4)
    rows = c.collect()
    assert c.stats == {"hits": 0, "misses": 72}
    assert chip_smoke.rows_digest(rows) == chip_smoke.SIM_PINS[
        "fig11/multiacc"]
    # the reference's sweep names its own function: other keys, same rows
    ref = JFuncSweep.over(
        "fig11_multiacc", "repro.experiments.multiacc:simulate_multiacc_point",
        [dict(it) for it in sweep.items[:12]])
    want = JCampaign(ref, use_cache=False, workers=1).collect()
    assert rows[:12] == want
    assert sweep.points()[0].key() != ref.points()[0].key()
    assert any(r["migrations"] > 0 for r in rows)


def test_cache_hits_misses_manifest_and_no_cache(tmp_path):
    sweep = Sweep(name="cache", policies=(Policy.mesc(), Policy.amc()),
                  utils=(0.7,), n_sets=3, duration=2e6, engine="vec")
    first = Campaign(sweep, cache_dir=tmp_path, workers=1)
    rows = first.collect()
    assert first.stats == {"hits": 0, "misses": 6}
    again = Campaign(sweep, cache_dir=tmp_path, workers=1)
    assert again.collect() == rows
    assert again.stats == {"hits": 6, "misses": 0}
    # an overlapping sweep simulates only its new points
    wider = Sweep(name="cache", policies=(Policy.mesc(), Policy.amc()),
                  utils=(0.7,), n_sets=4, duration=2e6, engine="vec")
    w = Campaign(wider, cache_dir=tmp_path, workers=1)
    assert w.collect()[:3] == rows[:3]
    assert w.stats == {"hits": 6, "misses": 2}
    cache = ResultCache(tmp_path)
    man = cache.read_manifest(sweep.spec_hash())
    assert man["n_points"] == 6 and man["name"] == "cache"
    assert man["point_keys"] == [p.key() for p in sweep.points()]
    assert man["last_run"] == {"hits": 6, "misses": 0}
    assert man["spec"] == json.loads(json.dumps(sweep.to_dict()))
    assert len(cache.manifests()) == 2
    key = sweep.points()[0].key()
    assert cache.has(key) and cache.get(key) == rows[0]
    # use_cache=False neither reads nor writes
    off = tmp_path / "off"
    c = Campaign(sweep, cache_dir=off, workers=1, use_cache=False)
    assert c.collect() == rows and c.cache is None
    assert not off.exists()
    # a FuncSweep with cache=False always re-runs
    echo = FuncSweep.over("echo", "repro_torch.experiments.runner:_echo_point",
                          [dict(x=1), dict(x=2)], cache=False)
    e = Campaign(echo, cache_dir=tmp_path / "echo", workers=1)
    assert [r["x"] for r in e.collect()] == [1, 2]
    assert not (tmp_path / "echo").exists()


def test_cache_dir_and_workers_read_the_reference_variables(monkeypatch,
                                                           tmp_path):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    assert default_cache_dir() == j_default_cache_dir() == \
        Path("results/campaigns")
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    assert default_cache_dir() == j_default_cache_dir() == tmp_path
    assert ResultCache().root == tmp_path
    monkeypatch.setenv("REPRO_CACHE_DIR", "  ")
    with pytest.raises(ValueError, match="REPRO_CACHE_DIR"):
        default_cache_dir()
    monkeypatch.setenv("REPRO_WORKERS", "3")
    assert default_workers() == j_runner.default_workers() == 3
    for junk in ("x", "0"):
        monkeypatch.setenv("REPRO_WORKERS", junk)
        with pytest.raises(ValueError, match="REPRO_WORKERS"):
            default_workers()


@pytest.mark.parametrize("engine", ["event", "vec", "jit"])
def test_two_workers_give_the_rows_of_one(engine, tmp_path, monkeypatch):
    """The pool changes no row; jit chunks run in the calling process."""
    calls = []
    real = simulator_jit.simulate_jbatch

    def counted(*a, **kw):
        calls.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(simulator_jit, "simulate_jbatch", counted)
    sweep = Sweep(name="pool", policies=(Policy.mesc(), Policy.limited()),
                  utils=(0.7, 0.9), n_sets=3, duration=2e7, engine=engine)
    one = Campaign(sweep, cache_dir=tmp_path / "1", workers=1,
                   device="cpu").collect()
    two = Campaign(sweep, cache_dir=tmp_path / "2", workers=2,
                   device="cpu").collect()
    assert two == one
    if engine == "jit":
        # one call per policy group and campaign, all here, on the CPU
        assert calls == ["cpu"] * 4
    else:
        assert calls == []
    assert run_sweep(sweep, cache_dir=tmp_path / "1", workers=2,
                     device="cpu") == one


def test_jit_points_run_on_the_card_unless_the_cpu_is_named(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sweep = Sweep(name="card", policies=(Policy.mesc(),), n_sets=1,
                  duration=1e6, engine="jit")
    with pytest.raises(RuntimeError, match="CUDA"):
        Campaign(sweep, cache_dir=tmp_path, workers=1).collect()
    # event and vec points never need the card
    for engine in ("event", "vec"):
        s = Sweep(name="card", policies=(Policy.mesc(),), n_sets=1,
                  duration=1e6, engine=engine)
        assert len(Campaign(s, cache_dir=tmp_path, workers=1).collect()) == 1
    # a sharded jit campaign runs on the named device, with the
    # unsharded campaign's rows and keys
    sharded = Sweep(name="card", policies=(Policy.mesc(),), n_sets=3,
                    duration=1e6, engine="jit", devices=2)
    plain = Sweep(name="card", policies=(Policy.mesc(),), n_sets=3,
                  duration=1e6, engine="jit")
    assert [p.key() for p in sharded.points()] \
        == [p.key() for p in plain.points()]
    assert Campaign(sharded, cache_dir=tmp_path / "s", workers=1,
                    device="cpu").collect() \
        == Campaign(plain, cache_dir=tmp_path / "p", workers=1,
                    device="cpu").collect()


def test_row_helpers_equal_the_reference(tmp_path):
    rows = Campaign(chip_smoke.fig8_sweep("event", n_sets=3),
                    cache_dir=tmp_path, workers=1).collect()
    cells = group_rows(rows, "policy", "u")
    assert list(cells) == list(j_metrics.group_rows(rows, "policy", "u"))
    for cell in cells.values():
        for name in ("pi", "ci", "save", "restore"):
            a, b = pooled_mean(cell, name), j_metrics.pooled_mean(cell, name)
            assert a == b or (a != a and b != b)
        assert frac(cell, "success_all") == \
            j_metrics.frac(cell, "success_all")
        assert ratio_of_sums(cell, "done_lo", "jobs_lo") == \
            j_metrics.ratio_of_sums(cell, "done_lo", "jobs_lo")
    old = {k: v for k, v in rows[0].items() if not k.endswith("_mean")}
    assert metrics.ensure_row_means(dict(old)) == \
        j_metrics.ensure_row_means(dict(old)) == rows[0]
    assert frac([], "success_all") == 0.0
