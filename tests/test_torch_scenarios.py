"""The port's scenario layer against the reference's, bit for bit: the
splitmix64 CRN primitives, the scenario registry and its errors, the
release-time demand arithmetic, and the serving outage windows."""
import dataclasses

import numpy as np
import pytest

from repro import scenarios as J
from repro.scenarios import scenario as j_scenario
from repro_torch import scenarios as T
from repro_torch.scenarios import scenario as t_scenario

SALT_NAMES = ["heavy_tail", "burst", "phase_shift", "dma", "thermal",
              "instance_loss", "", "x" * 40]

SCENARIO_NAMES = sorted(J.SCENARIOS) + ["faults@0", "faults@0.25",
                                        "faults@1"]


def _u64(seed, n=257):
    return np.random.default_rng(seed).integers(
        0, np.iinfo(np.uint64).max, n, dtype=np.uint64, endpoint=True)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix64_u01_counter_bit_equal(seed):
    x = _u64(seed)
    _same(T.mix64(x), J.mix64(x))
    _same(T.u01(x), J.u01(x))
    ent = np.arange(x.size, dtype=np.int64) % 7
    idx = (x >> np.uint64(40)).astype(np.int64)
    _same(T.counter(ent, idx), J.counter(ent, idx))
    assert T.GOLD == J.GOLD


@pytest.mark.parametrize("name", SALT_NAMES)
def test_stream_salt_bit_equal(name):
    assert T.stream_salt(name) == J.stream_salt(name)
    assert type(T.stream_salt(name)) is type(J.stream_salt(name))


@pytest.mark.parametrize("sub", [0, 1])
@pytest.mark.parametrize("salt", ["heavy_tail", "instance_loss"])
def test_keyed_u01_bit_equal(sub, salt):
    seed64 = _u64(7)
    ent = np.arange(seed64.size, dtype=np.int64) % 5
    idx = np.arange(seed64.size, dtype=np.int64) * 3
    _same(T.keyed_u01(seed64, T.stream_salt(salt), ent, idx, sub=sub),
          J.keyed_u01(seed64, J.stream_salt(salt), ent, idx, sub=sub))


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_scenario_registry_equal(name):
    t, j = T.get_scenario(name), J.get_scenario(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for gate in ("has_heavy_tail", "has_burst", "has_phase_shift",
                 "has_dma", "has_thermal", "has_loss", "affects_demand"):
        assert getattr(t, gate) == getattr(j, gate)
    assert T.get_scenario(None) is None
    assert T.get_scenario(t) is t


@pytest.mark.parametrize("bad", ["nope", "faults@x", "faults@1.5",
                                 "faults@-0.1", 3])
def test_get_scenario_errors_equal(bad):
    with pytest.raises(Exception) as te:
        T.get_scenario(bad)
    with pytest.raises(Exception) as je:
        J.get_scenario(bad)
    assert te.type is je.type
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_release_time_arithmetic_bit_equal(name):
    t, j = T.get_scenario(name), J.get_scenario(name)
    n = 301
    seed64 = _u64(11, n)
    task = np.arange(n, dtype=np.int64) % 10
    rel_n = np.arange(n, dtype=np.int64) // 10
    t_rel = np.random.default_rng(3).random(n) * 3e6
    got = T.demand_multiplier(t, np, seed64, task, rel_n, t_rel)
    want = J.demand_multiplier(j, np, seed64, task, rel_n, t_rel)
    assert (got is None) == (want is None)
    if want is not None:
        _same(got, want)
    if j.has_burst:
        win = T.burst_window_index(t, np, t_rel)
        _same(win, J.burst_window_index(j, np, t_rel))
        _same(T.burst_multiplier(t, np, seed64, win),
              J.burst_multiplier(j, np, seed64, win))
    period = np.full(n, 2e5)
    phase = np.random.default_rng(4).random(n) * period
    _same(T.shifted_phases(t, seed64, task, phase, period),
          J.shifted_phases(j, seed64, task, phase, period))


def test_snap_and_nofuse_equal():
    for x in (0.85, 0.1, 1 / 3):
        assert t_scenario._snap(x) == j_scenario._snap(x)
    v = np.linspace(0, 5, 11)
    _same(t_scenario._nofuse(np, v), j_scenario._nofuse(np, v))


T_GRID = sorted(set([0.0, 0.05, 0.9, 0.25, 0.5, 0.7499999999999999,
                     np.nextafter(0.9, 0.0), np.nextafter(0.9, 2.0)]
                    + list(np.linspace(0.0, 3.0, 61))))


@pytest.mark.parametrize("name", ["instance_loss", "faults@0.25",
                                  "faults@1", "faults@0"])
def test_lane_lost_on_a_time_grid(name):
    t, j = T.get_scenario(name), J.get_scenario(name)
    for seed in (0, 5):
        for lane in range(3):
            got = [T.lane_lost(t, seed, lane, x) for x in T_GRID]
            assert got == [J.lane_lost(j, seed, lane, x) for x in T_GRID]
    assert T.lane_lost(None, 0, 0, 0.3) is False


@pytest.mark.parametrize("window", [0.05, 0.25, 0.1, 0.3])
def test_next_loss_boundary_on_a_time_grid(window):
    t = T.Scenario(name="loss", loss_prob=0.5, loss_window_s=window)
    j = J.Scenario(name="loss", loss_prob=0.5, loss_window_s=window)
    for x in T_GRID:
        b = T.next_loss_boundary(t, x)
        assert b == J.next_loss_boundary(j, x)
        assert int(b // window) > int(x // window)      # strict progress
    # the edge the nextafter loop is there for: 0.9 // 0.05 == 17.0
    # while 18 * 0.05 == 0.9
    if window == 0.05:
        assert T.next_loss_boundary(t, 0.9) > 0.9


# ----------------------------------------------------------------------
# the torch twins the lockstep engine draws with (int64 tensors holding
# the uint64 bits), against the numpy versions
# ----------------------------------------------------------------------

def _i64(x):
    import torch
    return torch.from_numpy(np.asarray(x, np.uint64).view(np.int64).copy())


def _top_bit_grid():
    """Seeds with and without the top bit, extremes included."""
    x = np.concatenate([_u64(5, 509),
                        np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1,
                                  2 ** 64 - 1], np.uint64)])
    x[::2] |= np.uint64(1 << 63)
    return x


def test_mix64_and_u01_twins_equal_numpy():
    x = _top_bit_grid()
    assert (x >> np.uint64(63)).sum() > x.size // 2
    got = T.mix64_t(_i64(x)).numpy().view(np.uint64)
    _same(got, T.mix64(x))
    _same(T.u01_t(_i64(x)).numpy(), T.u01(x))
    _same(T.u01_t(T.mix64_t(_i64(x))).numpy(), J.u01(J.mix64(x)))


@pytest.mark.parametrize("sub", [0, 1, 3])
@pytest.mark.parametrize("salt", ["heavy_tail", "burst", "dma"])
def test_keyed_u01_twin_equals_numpy(sub, salt):
    import torch
    seed = _top_bit_grid()
    n = seed.size
    ent = (np.arange(n) % 13).astype(np.int32)
    idx = (np.arange(n) * 7919 % 100003).astype(np.int32)
    s = T.stream_salt(salt)
    got = T.keyed_u01_t(_i64(seed), s, torch.from_numpy(ent),
                        torch.from_numpy(idx), sub=sub).numpy()
    _same(got, J.keyed_u01(seed, s, ent, idx, sub=sub))
    _same(T.keyed_u01_t(_i64(seed), s, torch.from_numpy(ent), 0).numpy(),
          J.keyed_u01(seed, s, ent, np.uint64(0)))


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_release_time_twins_equal_numpy(name):
    import torch
    t, j = T.get_scenario(name), J.get_scenario(name)
    n = 301
    seed64 = _top_bit_grid()[:n]
    task = np.arange(n, dtype=np.int64) % 10
    rel_n = np.arange(n, dtype=np.int32) // 10
    t_rel = np.random.default_rng(3).random(n) * 3e6
    t_rel[:6] = [0.0, 1e5, 2e5, 1e6, 3e5 - 1e-9, 4e5]   # window edges
    args = (_i64(seed64), torch.from_numpy(task), torch.from_numpy(rel_n),
            torch.from_numpy(t_rel))
    got = T.demand_multiplier_t(t, *args)
    want = J.demand_multiplier(j, np, seed64, task, rel_n, t_rel)
    assert (got is None) == (want is None)
    if want is not None:
        _same(got.numpy(), want)
    if j.has_burst:
        win = T.burst_window_index_t(t, torch.from_numpy(t_rel))
        jwin = J.burst_window_index(j, np, t_rel)
        _same(win.numpy(), jwin)
        _same(T.burst_multiplier_t(t, _i64(seed64), win).numpy(),
              J.burst_multiplier(j, np, seed64, jwin))
        got = T.demand_multiplier_t(
            t, *args, burst_m=T.burst_multiplier_t(t, _i64(seed64), win))
        _same(got.numpy(), want)


# ----------------------------------------------------------------------
# the lockstep engine under each scenario that reaches its loop, against
# the reference's simulate_jbatch (x64 shim: see test_torch_simulator_jit)
# ----------------------------------------------------------------------

JIT_SCENARIOS = ["heavy_tail", "burst", "thermal_throttle", "faults@0.7"]


@pytest.mark.parametrize("name", JIT_SCENARIOS)
def test_lockstep_engine_rows_equal_the_reference(monkeypatch, name):
    import jax
    import jax.experimental

    from repro.core import Policy as JPolicy
    from repro.core import generate_taskset as j_generate_taskset
    from repro.core import simulator_jit as j_sj
    from repro.experiments.runner import cached_library
    from repro_torch.core import simulator_jit as sj
    from repro_torch.core import program, taskgen
    from repro_torch.core.scheduler import Policy
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            jax.enable_x64, raising=False)
    jlib = cached_library("sim")
    lib = {k: v for k, v in program.workload_library().items()
           if not k.startswith("arch:")}
    pts = [(u, s) for u in (0.7, 0.9) for s in range(16)]
    jts = [j_generate_taskset(u, seed=s, programs=jlib) for u, s in pts]
    ts = [taskgen.generate_taskset(u, seed=s, programs=lib) for u, s in pts]
    seeds = [s for _, s in pts]
    want = j_sj.simulate_jbatch(jts, jlib, JPolicy.mesc(), seeds=seeds,
                                duration=4e6, scenario=name)
    got = sj.simulate_jbatch(ts, lib, Policy.mesc(), seeds=seeds,
                             duration=4e6, scenario=name, device="cpu")
    assert sj.metrics_digest(got) == sj.metrics_digest(want)
