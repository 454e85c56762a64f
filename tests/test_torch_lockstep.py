"""The port's lockstep engine against itself: steps per graph replay,
stale-interrupt pruning, spans and batch composition and the
interrupt-table retry ladder change no row; the table knobs reject junk;
the entry points run on the card unless the CPU is asked for, and raise
for what the port does not have yet.  (Rows against the JAX package:
tests/test_torch_simulator_jit.py.)"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import simulator_jit as sj
from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator_vec import simulate_vbatch
from repro_torch.runtime.device_config import MAX_LOGICAL_DEVICES

LIB = chip_smoke.sim_library()
_CASES = {}


def _corpus(name):
    """chip_smoke's smoke (fig8) or mixed corpus: (tasksets, seeds)."""
    if not _CASES:
        for case, ts, seeds, policy, kw in chip_smoke.sim_cases(LIB):
            _CASES.setdefault(case.split("/")[0], (ts, seeds))
    return _CASES[name]


_RUNS = {}


def _run(corpus, duration, **kw):
    key = (corpus, duration, tuple(sorted(kw.items())))
    if key not in _RUNS:
        ts, sd = _corpus(corpus)
        _RUNS[key] = sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd,
                                        duration=duration, device="cpu",
                                        **kw)
    return _RUNS[key]


def test_steps_per_replay_changes_no_result(monkeypatch):
    ts, sd = _corpus("mixed")
    want = sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd,
                              duration=4e6, device="cpu")
    sj.reset_counts()
    monkeypatch.setattr(sj, "GRAPH_STEPS", 1)
    got = sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd,
                             duration=4e6, device="cpu")
    assert got == want
    # one flag read per step (the loop ends on the step whose flag says
    # so) and one read of the final carry
    assert sj.COUNTS["replays"] == sj.COUNTS["steps"]
    assert sj.COUNTS["syncs"] == sj.COUNTS["replays"] + 1


def test_pruning_changes_no_result(monkeypatch):
    ts, sd = _corpus("smoke")
    want = _run("smoke", 4e6, scenario="heavy_tail")
    monkeypatch.setattr(sj, "_PRUNE_STALE", False)
    got = sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd,
                             duration=4e6, scenario="heavy_tail",
                             device="cpu")
    assert got == want


def test_spans_and_batch_composition_change_no_result():
    ts, sd = _corpus("smoke")
    want = _run("smoke", 4e6, scenario="heavy_tail")
    order = list(np.random.default_rng(0).permutation(len(ts)))
    for batch_size in (5, 64):
        got = sj.simulate_jbatch([ts[i] for i in order], LIB, Policy.mesc(),
                                 seeds=[sd[i] for i in order], duration=4e6,
                                 batch_size=batch_size,
                                 scenario="heavy_tail", device="cpu")
        assert got == [want[i] for i in order], batch_size


def test_a_real_retry_ladder_changes_no_result(monkeypatch):
    ts, sd = _corpus("smoke")
    want = _run("smoke", 4e6, scenario="heavy_tail")
    monkeypatch.setenv("REPRO_JIT_TABLE_WIDTH", "2")
    sj.reset_counts()
    got = sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd,
                             duration=4e6, scenario="heavy_tail",
                             device="cpu")
    assert sj.COUNTS["retried_points"] > 0
    assert got == want


class TestOverflowRetryLadder:
    """``_run_chunk``'s bookkeeping with ``_run_once`` stubbed (the
    reference's tests/test_simulator_jit.py cases, on the port)."""

    def test_selective_retry_merges_and_widens(self, monkeypatch):
        calls = []

        def run_once(b, policy, seeds, duration, op, cf, nominal, K,
                     scenario=None, device=None, devices=1):
            calls.append((list(seeds), K))
            return {"overflow": np.array([K <= sj._K0 and s % 2 == 1
                                          for s in seeds]),
                    "seeds": list(seeds)}

        monkeypatch.setattr(sj, "_run_once", run_once)
        monkeypatch.setattr(
            sj, "_assemble",
            lambda b, final, duration: [f"m{s}" for s in final["seeds"]])
        monkeypatch.setattr(sj, "_RETRY_BUCKET", 4)
        ts, _ = _corpus("mixed")
        out = sj._run_chunk(ts, LIB, Policy.mesc(), [0, 1, 2, 3], 4e6, 0.3,
                            2.0, "sampled")
        assert out == ["m0", "m1", "m2", "m3"]
        assert calls == [([0, 1, 2, 3], sj._K0), ([1, 3, 3, 3], 2 * sj._K0)]

    def test_ladder_gives_up_past_kmax(self, monkeypatch):
        monkeypatch.setattr(
            sj, "_run_once",
            lambda b, policy, seeds, duration, op, cf, nominal, K,
            scenario=None, device=None, devices=1:
            {"overflow": np.ones(b.P, bool), "seeds": list(seeds)})
        monkeypatch.setattr(
            sj, "_assemble", lambda b, final, duration: [None] * b.P)
        ts, _ = _corpus("mixed")
        with pytest.raises(RuntimeError) as ei:
            sj._run_chunk(ts[:2], LIB, Policy.mesc(), [7, 9], 1e6, 0.3,
                          2.0, "sampled", point_ids=[40, 41])
        msg = str(ei.value)
        assert "overflowed at the maximum width" in msg
        assert "(taskset 40, seed 7)" in msg
        assert "(taskset 41, seed 9)" in msg
        assert "REPRO_JIT_TABLE_MAX" in msg

    def test_real_exhaustion_with_tiny_starting_width(self, monkeypatch):
        monkeypatch.setenv("REPRO_JIT_TABLE_WIDTH", "1")
        monkeypatch.setenv("REPRO_JIT_TABLE_MAX", "1")
        ts, sd = _corpus("smoke")
        with pytest.raises(RuntimeError) as ei:
            simulate_vbatch(ts[:1], LIB, Policy.mesc(), seeds=sd[:1],
                            duration=2e6, demand_profile="nominal",
                            select_backend="jit", device="cpu")
        msg = str(ei.value)
        assert "overflowed at the maximum width 1" in msg
        assert f"seed {sd[0]}" in msg


@pytest.mark.parametrize("var", ["REPRO_JIT_TABLE_WIDTH",
                                 "REPRO_JIT_TABLE_MAX"])
@pytest.mark.parametrize("bad", ["abc", "1.5", "0", "-2", "2x"])
def test_table_knobs_reject_junk(monkeypatch, var, bad):
    monkeypatch.setenv(var, bad)
    ts, sd = _corpus("mixed")
    with pytest.raises(ValueError, match=var):
        sj.simulate_jbatch(ts[:1], LIB, Policy.mesc(), seeds=sd[:1],
                           duration=1e5, device="cpu")


def test_table_knobs_read_their_values(monkeypatch):
    monkeypatch.setenv("REPRO_JIT_TABLE_WIDTH", " 16 ")
    monkeypatch.setenv("REPRO_JIT_TABLE_MAX", "8")
    assert sj._table_width() == 16
    assert sj._table_max(16) == 16          # never below the start
    monkeypatch.setenv("REPRO_JIT_TABLE_WIDTH", "")
    assert sj._table_width() == sj._K0


# ----------------------------------------------------------------------
# entry points and arithmetic
# ----------------------------------------------------------------------

def test_entry_points_run_on_the_card_or_raise(monkeypatch):
    ts, sd = _corpus("mixed")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd, duration=1e5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_vbatch(ts, LIB, Policy.mesc(), seeds=sd, duration=1e5,
                        select_backend="jit")
    for bad in (0, MAX_LOGICAL_DEVICES + 1):
        with pytest.raises(ValueError, match="out of range"):
            sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd,
                               duration=1e5, devices=bad, device="cpu")
    # the host backend, the default, runs without the card
    host = simulate_vbatch(ts, LIB, Policy.mesc(), seeds=sd, duration=1e5)
    assert len(host) == len(ts)
    with pytest.raises(ValueError, match="select_backend"):
        simulate_vbatch(ts, LIB, Policy.mesc(), seeds=sd,
                        select_backend="gpu")
    with pytest.raises(ValueError, match="demand_profile"):
        simulate_vbatch(ts, LIB, Policy.mesc(), seeds=sd,
                        select_backend="jit", demand_profile="flat")
    with pytest.raises(ValueError, match="seeds"):
        sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd[:1],
                           device="cpu")


def test_jax_alias_warns_and_runs():
    ts, sd = _corpus("mixed")
    want = sj.simulate_jbatch(ts[:1], LIB, Policy.mesc(), seeds=sd[:1],
                              duration=2e5, device="cpu", devices=1)
    with pytest.warns(DeprecationWarning, match="alias"):
        got = simulate_vbatch(ts[:1], LIB, Policy.mesc(), seeds=sd[:1],
                              duration=2e5, select_backend="jax",
                              device="cpu")
    assert got == want
    assert isinstance(got[0].save_cycles, type(want[0].save_cycles))


