"""The port's lockstep engine (``repro_torch.core.simulator_jit``) on the
CPU against the JAX package's ``simulate_jbatch``: rows bit for bit on
the shared corpora, under every policy, profile and JIT scenario, the
final carry array by array, the nominal rows against the reference's
NumPy vec engine, the batched preemption boundary and the emulated FMA.
The scenario cases are in tests/test_torch_scenarios.py, the engine's
own invariances (steps per replay, pruning, spans and batch
composition, the retry ladder, the entry points) in
tests/test_torch_lockstep.py.

JAX 0.9 has no ``jax.experimental.enable_x64``, which the reference
engine imports; where it is missing, the ``x64`` fixture points it at
``jax.enable_x64``, the same context manager, for these tests only.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import chip_smoke
from harness import rows as j_rows
from repro.core import Policy as JPolicy
from repro.core import generate_taskset as j_generate_taskset
from repro.core import simulator as j_simulator
from repro.core import simulator_jit as j_sj
from repro.core.simulator_vec import _VecBatch as JVecBatch
from repro.core.simulator_vec import simulate_vbatch as j_simulate_vbatch
from repro.experiments.runner import cached_library

from repro_torch.core import simulator_jit as sj
from repro_torch.core import simulator_vec
from repro_torch.core.scheduler import Policy
from repro_torch.core.taskgen import generate_taskset

J_LIB = cached_library("sim")
LIB = chip_smoke.sim_library()
POLICIES = ("mesc", "np", "lp", "amc-instruction")


@pytest.fixture(autouse=True)
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            jax.enable_x64, raising=False)


def _policy(name, ref=False):
    P = JPolicy if ref else Policy
    return {"mesc": P.mesc(), "np": P.non_preemptive(), "lp": P.limited(),
            "amc-instruction": P.amc()}[name]


_CORPORA = {}


def _corpus(name, ref=False):
    """chip_smoke's smoke (fig8) and mixed corpora, built by the port's
    or the reference's taskgen and library."""
    key = (name, ref)
    if key not in _CORPORA:
        lib, gen = (J_LIB, j_generate_taskset) if ref \
            else (LIB, generate_taskset)
        if name == "smoke":
            spec = chip_smoke.SIM_SMOKE
            pts = [(u, s, 10) for u in spec["utils"]
                   for s in range(spec["n_sets"])]
        else:
            pts = [(0.9, s, n)
                   for s, n in enumerate(chip_smoke.SIM_MIXED_SIZES)]
        _CORPORA[key] = ([gen(u, seed=s, n_tasks=n, programs=lib)
                          for u, s, n in pts], [s for _, s, _ in pts])
    return _CORPORA[key]


def _as_ref(m):
    """A port RunMetrics as the reference's (for its metrics_row)."""
    d = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
    for k in ("pi_blocking", "ci_blocking", "save_cycles",
              "restore_cycles"):
        d[k] = j_simulator.AggSamples(d[k].total, d[k].n)
    return j_simulator.RunMetrics(**d)


def _rows(ms):
    return j_rows([_as_ref(m) for m in ms])


_RUNS = {}


def _run(corpus, policy, ref, duration, **kw):
    """Rows of one corpus under one policy, memoized per module."""
    key = (corpus, policy, ref, duration, tuple(sorted(kw.items())))
    if key not in _RUNS:
        ts, sd = _corpus(corpus, ref)
        if ref:
            ms = j_sj.simulate_jbatch(ts, J_LIB, _policy(policy, True),
                                      seeds=sd, duration=duration, **kw)
        else:
            ms = sj.simulate_jbatch(ts, LIB, _policy(policy), seeds=sd,
                                    duration=duration, device="cpu", **kw)
        _RUNS[key] = ms
    return _RUNS[key]


def _assert_rows_equal(got, want, what):
    gr, wr = _rows(got), j_rows(want)
    assert len(gr) == len(wr), what
    for i, (a, b) in enumerate(zip(gr, wr)):
        assert a == b, (what, i, {k: (a[k], b[k]) for k in a
                                  if a[k] != b[k]})


# ----------------------------------------------------------------------
# rows against the reference, and the pins chip_smoke holds the card to
# ----------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["sampled", "nominal"])
def test_smoke_corpus_rows_equal_the_reference_and_the_pin(profile):
    d = chip_smoke.SIM_DURATION
    got = _run("smoke", "mesc", False, d, demand_profile=profile)
    want = _run("smoke", "mesc", True, d, demand_profile=profile)
    _assert_rows_equal(got, want, profile)
    pin = chip_smoke.SIM_PINS[f"smoke/{profile}"]
    assert sj.metrics_digest(want) == pin
    assert sj.metrics_digest(got) == pin


@pytest.mark.parametrize("policy", POLICIES)
def test_mixed_corpus_rows_equal_the_reference_and_the_pin(policy):
    """Port and reference row for row over 4e6 cycles; the reference's
    rows over chip_smoke's 2e7 equal its pin (the card and the port's
    CPU path are held to that pin in chip_smoke's phase 8)."""
    got = _run("mixed", policy, False, 4e6)
    want = _run("mixed", policy, True, 4e6)
    _assert_rows_equal(got, want, policy)
    assert sj.metrics_digest(
        _run("mixed", policy, True, chip_smoke.SIM_DURATION)) == \
        chip_smoke.SIM_PINS[f"mixed/{policy}"]


@pytest.mark.parametrize("policy,cf,overrun_prob", [
    ("mesc", 1.7, 0.6), ("lp", 2.9, 0.15)])
def test_rows_equal_the_reference_at_other_draw_parameters(policy, cf,
                                                          overrun_prob):
    """A cf other than 2 makes the overrun branch's ``1 + (cf-1)u`` an
    inexact product, so the emulated FMA decides those demands."""
    got = _run("smoke", policy, False, 4e6, cf=cf,
               overrun_prob=overrun_prob)
    want = _run("smoke", policy, True, 4e6, cf=cf,
                overrun_prob=overrun_prob)
    _assert_rows_equal(got, want, (policy, cf))


def test_scenario_pin():
    d = chip_smoke.SIM_DURATION
    got = _run("smoke", "mesc", False, d, scenario="faults@0.7")
    assert sj.metrics_digest(got) == chip_smoke.SIM_PINS["smoke/faults@0.7"]


def test_nominal_rows_equal_the_reference_vec_engine():
    ts, sd = _corpus("smoke", True)
    d = chip_smoke.SIM_DURATION
    want = j_simulate_vbatch(ts, J_LIB, JPolicy.mesc(), seeds=sd,
                             duration=d, demand_profile="nominal",
                             select_backend="numpy")
    got = _run("smoke", "mesc", False, d, demand_profile="nominal")
    _assert_rows_equal(got, want, "vec")


@pytest.mark.parametrize("corpus,policy,profile,scenario", [
    ("smoke", "mesc", "sampled", None),
    ("mixed", "amc-instruction", "nominal", None),
    ("mixed", "mesc", "sampled", "faults@0.7"),
])
def test_final_carry_equals_the_reference_run_once(corpus, policy, profile,
                                                   scenario):
    """Every carried array of the last step — dtype, shape and bits."""
    from repro.scenarios import get_scenario as j_get_scenario
    from repro_torch.scenarios import get_scenario
    ts, sd = _corpus(corpus, False)
    jts, jsd = _corpus(corpus, True)
    kw = dict(seeds=sd, duration=4e6, overrun_prob=0.3, cf=2.0,
              scenario=scenario)
    b = simulator_vec._VecBatch(ts, LIB, _policy(policy), **kw)
    jb = JVecBatch(jts, J_LIB, _policy(policy, True), **kw)
    nominal = profile == "nominal"
    got = sj._run_once(b, _policy(policy), sd, 4e6, 0.3, 2.0, nominal, 64,
                       scenario=get_scenario(scenario))
    want = j_sj._run_once(jb, _policy(policy, True), jsd, 4e6, 0.3, 2.0,
                          nominal, 64, scenario=j_get_scenario(scenario))
    assert sorted(got) == sorted(want)
    for name in want:
        a, w = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert a.tobytes() == w.tobytes(), name
    assert int(got["steps"]) > 10


def test_one_step_with_tied_candidates_equals_the_reference():
    """Equal event times (a release, a scheduler tick and a pending
    interrupt at one instant): both libraries take the first source and
    the first column."""
    ts, sd = _corpus("mixed", False)
    jts, _ = _corpus("mixed", True)
    kw = dict(seeds=sd, duration=4e6, overrun_prob=0.3, cf=2.0)
    b = simulator_vec._VecBatch(ts, LIB, Policy.mesc(), **kw)
    jb = JVecBatch(jts, J_LIB, JPolicy.mesc(), **kw)
    carry = sj._carry0(b, 8)
    t = float(b.next_release[:, 0].max())
    carry["next_release"][:, :2] = t
    carry["tick_release"][:, 1:3] = t
    carry["ev_time"][:, 0] = t
    carry["ev_pay"][:, 0] = 1 * 4 + 1
    tb = sj._tables(b, sd)
    sc = {"t_sr": 5000.0, "overrun_prob": 0.3, "cf": 2.0,
          "duration": 4e6, "max_steps": 3}
    runner = sj._runners_for(Policy.mesc(), False, None, tb, carry,
                             torch.device("cpu"), 1)[0]
    got = sj._run_shards([runner], [(tb, sc, {k: v.copy()
                                              for k, v in carry.items()})])[0]
    run = j_sj._compiled_run(True, False, "instruction", False, True)
    with jax.experimental.enable_x64():
        import jax.numpy as jnp
        jtb = j_sj._tables(jb, sd)
        jsc = {k: (jnp.int64(v) if k == "max_steps" else jnp.float64(v))
               for k, v in sc.items()}
        jc = {k: jnp.asarray(v) for k, v in carry.items()}
        want = {k: np.asarray(v) for k, v in run(jtb, jsc, jc).items()}
    assert int(want["steps"]) == 3 == int(got["steps"])
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].tobytes() == want[name].tobytes(), name


# ----------------------------------------------------------------------
# arithmetic
# ----------------------------------------------------------------------

def test_fma_rounds_once():
    """_fma(a, b, c) is a*b + c rounded once: exact rational arithmetic
    on the demand draw's operands (and the XLA:CPU build's contraction,
    which the reference's sampled rows carry)."""
    from fractions import Fraction
    bits = np.random.default_rng(3).integers(0, 2 ** 53, 4096,
                                             dtype=np.int64)
    u = torch.from_numpy(bits.astype(np.float64) * 2.0 ** -53)
    for a, c in ((0.3, 0.7), (1.0, 1.0), (0.37, 1.0), (1e-3, -2.5)):
        got = sj._fma(torch.full_like(u, a), u, c).numpy()
        for i in range(0, 4096, 7):
            want = float(Fraction(a) * Fraction(float(u[i])) + Fraction(c))
            assert got[i] == want, (a, c, float(u[i]))
    # a product the unfused form rounds differently
    uf = u.numpy()
    assert ((sj._fma(0.3, u, 0.7).numpy() != 0.7 + 0.3 * uf).any())


def test_boundaries_equal_the_reference_batch_queries():
    """The batched preemption boundary against the reference batch's
    (``_VecBatch._boundaries``, the jit engine's float/int op order) at
    exact multiples of the program length, at segment ends and at the
    ``total - 1e-9`` clamp."""
    names = ["small_gemm", "alexnet_xs", "transformer_xs"]
    base = _corpus("mixed", False)[0][0][0]
    jbase = _corpus("mixed", True)[0][0][0]
    ts = [[dataclasses.replace(base, workload=n)] for n in names]
    jts = [[dataclasses.replace(jbase, workload=n)] for n in names]
    for preempt in ("instruction", "operator"):
        pol = dataclasses.replace(Policy.mesc(), preemption=preempt)
        jpol = dataclasses.replace(JPolicy.mesc(), preemption=preempt)
        kw = dict(seeds=[0, 1, 2], duration=1e6, overrun_prob=0.3, cf=2.0)
        b = simulator_vec._VecBatch(ts, LIB, pol, **kw)
        jb = JVecBatch(jts, J_LIB, jpol, **kw)
        tb = {k: torch.from_numpy(np.array(v))
              for k, v in sj._tables(b, [0, 1, 2]).items()}
        for p, name in enumerate(names):
            total = float(LIB[name].total_cycles)
            offs = [0.0, 1.0, total - 1.0, total - 1e-9, total,
                    2 * total, 5 * total + 3.0]
            offs += [float(e) for e in LIB[name]._seg_ends[:6]]
            pids = torch.full((len(offs),), int(b.prog_id[p, 0]),
                              dtype=torch.int32)
            got = sj._boundaries(tb, pids,
                                 torch.tensor(offs, dtype=torch.float64),
                                 preempt).tolist()
            want = []
            for off in offs:
                jb.exec_cy[p, 0] = off
                try:
                    want.append(float(jb._boundaries(np.array([p]),
                                                     np.array([0]))[0]))
                except IndexError:
                    # pk + off rounded up to the table's last key: the
                    # NumPy batch indexes past its end, the JAX engine
                    # clamps (as the port does); not comparable here
                    want.append(got[len(want)])
            assert len(offs) > 10
            assert got == want, (preempt, name)
