"""The port's event engine (``repro_torch.core.simulator``) against the
JAX package's: ``MCSSimulator`` rows on the smoke corpus (sampled and
nominal), the mixed corpus under every policy and the ``faults@0.7``
scenario; ``MultiAccelSimulator`` at 1, 2 and 4 instances under every
partition heuristic with migration and DMA contention on; and
``simulate_batch`` against single runs.  Rows (and the per-event sample
lists behind them) must be equal bit for bit."""
import dataclasses

import pytest

import chip_smoke
from repro.core import Policy as JPolicy
from repro.core import simulator as j_simulator
from repro.core.platform import MigrationPolicy as JMigrationPolicy
from repro.core.taskgen import generate_taskset as j_generate_taskset
from repro.experiments.metrics import metrics_row as j_metrics_row
from repro.experiments.runner import cached_library

from repro_torch.core import simulator
from repro_torch.core.platform import MigrationPolicy
from repro_torch.core.scheduler import Policy
from repro_torch.core.taskgen import generate_taskset
from repro_torch.experiments.metrics import metrics_row
from repro_torch.experiments.runner import cached_library as p_library

J_LIB = cached_library("sim")
LIB = p_library("sim")
DURATION = chip_smoke.SIM_DURATION
POLICIES = ("mesc", "np", "lp", "amc-instruction")


def policy_of(name, ref=False):
    P = JPolicy if ref else Policy
    return {"mesc": P.mesc(), "np": P.non_preemptive(), "lp": P.limited(),
            "amc-instruction": P.amc()}[name]


def corpus(name, ref=False):
    """chip_smoke's smoke (fig8) and mixed corpora, built by either
    package's taskgen and library."""
    lib, gen = (J_LIB, j_generate_taskset) if ref \
        else (LIB, generate_taskset)
    if name == "smoke":
        pts = [(u, s, 10) for u in chip_smoke.SIM_SMOKE["utils"]
               for s in range(chip_smoke.SIM_SMOKE["n_sets"])]
    else:
        pts = [(0.9, s, n) for s, n in enumerate(chip_smoke.SIM_MIXED_SIZES)]
    return ([gen(u, seed=s, n_tasks=n, programs=lib) for u, s, n in pts],
            [s for _, s, _ in pts])


def full_rows(ms):
    """Every field of every run, sample lists included."""
    return [dataclasses.asdict(m) for m in ms]


def assert_runs_equal(got, want, what):
    """Port runs against reference runs: the tidy rows and the raw
    per-event lists behind them."""
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        ra, rb = metrics_row(a), j_metrics_row(b)
        assert ra == rb, (what, i, {k: (ra[k], rb[k]) for k in ra
                                    if ra[k] != rb[k]})
    assert full_rows(got) == full_rows(want), what


def run_event(name, policy, ref, **kw):
    ts, seeds = corpus(name, ref)
    sim = j_simulator if ref else simulator
    return [sim.simulate(t, J_LIB if ref else LIB, policy_of(policy, ref),
                         seed=s, duration=DURATION, **kw)
            for t, s in zip(ts, seeds)]


@pytest.mark.parametrize("profile", ["sampled", "nominal"])
def test_smoke_corpus_rows_equal_the_reference(profile):
    got = run_event("smoke", "mesc", False, demand_profile=profile)
    want = run_event("smoke", "mesc", True, demand_profile=profile)
    assert_runs_equal(got, want, profile)
    assert sum(m.cs_count for m in got) > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_mixed_corpus_rows_equal_the_reference(policy):
    got = run_event("mixed", policy, False)
    want = run_event("mixed", policy, True)
    assert_runs_equal(got, want, policy)


def test_faults_scenario_rows_equal_the_reference():
    got = run_event("smoke", "mesc", False, scenario="faults@0.7")
    want = run_event("smoke", "mesc", True, scenario="faults@0.7")
    assert_runs_equal(got, want, "faults@0.7")
    plain = run_event("smoke", "mesc", False)
    assert full_rows(got) != full_rows(plain)


def test_semantics_salts_and_event_kinds_equal_the_reference():
    assert simulator.SIM_SEMANTICS_VERSION == \
        j_simulator.SIM_SEMANTICS_VERSION
    assert simulator.MULTI_SIM_SEMANTICS_VERSION == \
        j_simulator.MULTI_SIM_SEMANTICS_VERSION
    assert {k.name: int(k) for k in simulator.EventKind} == \
        {k.name: int(k) for k in j_simulator.EventKind}
    assert simulator.DEMAND_PROFILES == j_simulator.DEMAND_PROFILES
    with pytest.raises(ValueError, match="demand_profile"):
        simulator.simulate([], LIB, Policy.mesc(), demand_profile="flat")


def _multi(ref, n, heuristic, seed, **kw):
    lib = J_LIB if ref else LIB
    gen = j_generate_taskset if ref else generate_taskset
    sim = j_simulator if ref else simulator
    mig = (JMigrationPolicy if ref else MigrationPolicy)(enabled=True)
    tasks = gen(round(0.7 * n, 4), seed=seed, n_tasks=12, programs=lib,
                max_task_u=0.5)
    return sim.MultiAccelSimulator(
        tasks, lib, policy_of("mesc", ref), n_instances=n,
        heuristic=heuristic, duration=DURATION, seed=seed,
        dma_contention=True, migration=mig, **kw).run()


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("heuristic", ["first_fit", "worst_fit",
                                       "crit_aware"])
def test_multi_accelerator_rows_equal_the_reference(n, heuristic):
    migrations = contention = 0.0
    for seed in (0, 1):
        got = _multi(False, n, heuristic, seed)
        want = _multi(True, n, heuristic, seed)
        assert_runs_equal(got.per_instance, want.per_instance,
                          (n, heuristic, seed))
        assert_runs_equal([got.merged()], [want.merged()], "merged")
        assert (got.migrations, got.migration_cycles,
                got.dma_contention_cycles, got.n_instances) == \
            (want.migrations, want.migration_cycles,
             want.dma_contention_cycles, want.n_instances)
        assert (got.success(), got.success("HI"), got.survivability()) == \
            (want.success(), want.success("HI"), want.survivability())
        migrations += got.migrations
        contention += got.dma_contention_cycles
    if n > 1:
        assert migrations > 0 and contention > 0
    if n == 1:
        # one instance degenerates to MCSSimulator, run for run
        tasks = generate_taskset(0.7, seed=0, n_tasks=12, programs=LIB,
                                 max_task_u=0.5)
        one = simulator.simulate(tasks, LIB, Policy.mesc(), seed=0,
                                 duration=DURATION)
        assert full_rows(_multi(False, 1, heuristic, 0).per_instance) == \
            full_rows([one])


def test_multi_accelerator_scenario_and_nominal_rows_equal_the_reference():
    for kw in (dict(scenario="faults@0.7"), dict(demand_profile="nominal")):
        got = _multi(False, 2, "crit_aware", 3, **kw)
        want = _multi(True, 2, "crit_aware", 3, **kw)
        assert_runs_equal(got.per_instance, want.per_instance, kw)
        assert got.dma_contention_cycles == want.dma_contention_cycles


def test_simulate_batch_equals_single_runs_and_the_reference():
    ts, seeds = corpus("mixed")
    jts, _ = corpus("mixed", ref=True)
    for policy in ("mesc", "amc-instruction"):
        batch = simulator.simulate_batch(ts, LIB, policy_of(policy),
                                         seeds=seeds, duration=DURATION)
        single = [simulator.MCSSimulator(t, LIB, policy_of(policy), seed=s,
                                         duration=DURATION).run()
                  for t, s in zip(ts, seeds)]
        assert full_rows(batch) == full_rows(single)
        want = j_simulator.simulate_batch(jts, J_LIB, policy_of(policy, True),
                                          seeds=seeds, duration=DURATION)
        assert_runs_equal(batch, want, policy)
    with pytest.raises(ValueError, match="seeds"):
        simulator.simulate_batch(ts, LIB, Policy.mesc(), seeds=seeds[:-1])
