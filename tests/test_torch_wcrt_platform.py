"""The port's response-time analysis and multi-accelerator platform layer
against the JAX package's: ``analyze`` and ``analyze_partitioned`` on
UUnifast task sets, ``partition`` under every heuristic and instance
count, and the accelerator pool's assignments and migration costs.  The
same numpy-seeded task sets go through both packages; every result must
be equal."""
import dataclasses

import numpy as np
import pytest

from repro.core import executor as j_executor
from repro.core import platform as j_platform
from repro.core import task as j_task
from repro.core import wcrt as j_wcrt
from repro.core.serving import KVSlotArena as JKVSlotArena
from repro.core.taskgen import generate_taskset as j_generate_taskset
from repro.experiments.runner import cached_library

from repro_torch.core import executor, platform, task, wcrt
from repro_torch.core.serving import KVSlotArena
from repro_torch.core.taskgen import generate_taskset
from repro_torch.experiments.runner import cached_library as p_library

UTILS = (0.5, 0.7, 0.85, 0.95)
SEEDS = (0, 1, 2)
J_LIB = cached_library("sim")
LIB = p_library("sim")


def _sets(u, seed, **kw):
    return (j_generate_taskset(u, seed=seed, programs=J_LIB, **kw),
            generate_taskset(u, seed=seed, programs=LIB, **kw))


def _as_dict(tasks):
    return [dict(dataclasses.asdict(t), crit=t.crit.name) for t in tasks]


@pytest.mark.parametrize("u", UTILS)
def test_analyze_equals_the_reference(u):
    n_ok = 0
    for seed in SEEDS:
        jts, ts = _sets(u, seed)
        assert _as_dict(ts) == _as_dict(jts)
        for k in (wcrt.AnalysisConstants(),
                  wcrt.AnalysisConstants(t_sr=2000.0, y_save=30000.0)):
            jk = j_wcrt.AnalysisConstants(**dataclasses.asdict(k))
            got = wcrt.analyze(ts, LIB, k)
            want = j_wcrt.analyze(jts, J_LIB, jk)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            n_ok += got.schedulable
            assert wcrt.longest_instruction(ts, LIB) == \
                j_wcrt.longest_instruction(jts, J_LIB)
    if u <= 0.5:
        assert n_ok > 0


@pytest.mark.parametrize("n_instances", [1, 2, 4])
def test_analyze_partitioned_equals_the_reference(n_instances):
    for u_norm in (0.5, 0.8):
        for seed in SEEDS:
            jts, ts = _sets(round(u_norm * n_instances, 4), seed,
                            n_tasks=12, max_task_u=0.5)
            for heur in platform.HEURISTICS:
                for dma in (True, False):
                    got = wcrt.analyze_partitioned(
                        ts, LIB, n_instances=n_instances, heuristic=heur,
                        dma_contention=dma)
                    want = j_wcrt.analyze_partitioned(
                        jts, J_LIB, n_instances=n_instances, heuristic=heur,
                        dma_contention=dma)
                    assert got.schedulable == want.schedulable
                    assert {i: dataclasses.asdict(r)
                            for i, r in got.per_instance.items()} == \
                        {i: dataclasses.asdict(r)
                         for i, r in want.per_instance.items()}
                    assert dataclasses.asdict(got.assignment) == \
                        dataclasses.asdict(want.assignment)


@pytest.mark.parametrize("heuristic", ["first_fit", "worst_fit",
                                       "crit_aware"])
def test_partition_equals_the_reference(heuristic):
    assert platform.HEURISTICS == j_platform.HEURISTICS
    for n in (1, 2, 4):
        for u in (0.6 * n, 0.9 * n):
            for seed in SEEDS:
                jts, ts = _sets(round(u, 4), seed, n_tasks=12,
                                max_task_u=0.5)
                got = platform.partition(ts, n, heuristic)
                want = j_platform.partition(jts, n, heuristic)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.home == got.task_to_instance
                for inst in range(n):
                    assert [t.tid for t in got.tasks_on(inst, ts)] == \
                        [t.tid for t in want.tasks_on(inst, jts)]
                    assert platform.utilization(got.tasks_on(inst, ts)) \
                        == j_platform.utilization(want.tasks_on(inst, jts))
                assert platform.utilization(ts, hi=True) == \
                    j_platform.utilization(jts, hi=True)
    with pytest.raises(ValueError):
        platform.partition([], 0, heuristic)
    with pytest.raises(ValueError):
        platform.partition([], 2, "best_fit")


def _pool_run(mod_platform, mod_task, mod_exec, tasks, lib, n, seed):
    """Assign, build residency on each task's home, save contexts, then
    migrate LO tasks around; every cost and placement as plain values."""
    rng = np.random.default_rng(seed)
    pool = mod_platform.AcceleratorPool(
        n, heuristic="crit_aware",
        migration=mod_platform.MigrationPolicy(cost_per_byte=1.0 / 8.0))
    a = pool.assign(tasks)
    out = [dict(a.task_to_instance)]
    tcbs = {t.tid: mod_task.TCB(params=t) for t in tasks}
    for t in tasks:
        acc = pool.accel_of(t.tid)
        assert isinstance(acc, mod_exec.GemminiRT)
        acc.note_execution(t.tid, float(rng.uniform(0, 4e4)),
                           lib[t.workload])
        if rng.random() < 0.7:
            br = acc.context_save(tcbs[t.tid], 10,
                                  next_eta=int(rng.integers(1, 9)))
            out.append(br.total)
    for _ in range(3 * len(tasks)):
        t = tasks[int(rng.integers(len(tasks)))]
        dst = int(rng.integers(n))
        out.append((t.tid, dst, pool.migrate(t.tid, dst),
                    a.instance_of(t.tid), a.home_of(t.tid)))
        if rng.random() < 0.3:
            a.return_home(t.tid)
    out.append((pool.migrations, dict(a.task_to_instance), dict(a.home)))
    out.append([sorted((k, v["accumulator"], v["scratchpad"],
                        v["kept_resident"]) for k, v in acc.dram.items())
                for acc in pool.instances])
    return out


@pytest.mark.parametrize("n_instances", [1, 2, 4])
def test_accelerator_pool_assignment_and_migration_costs_equal_the_reference(
        n_instances):
    for seed in SEEDS:
        jts, ts = _sets(round(0.7 * n_instances, 4), seed, n_tasks=12,
                        max_task_u=0.5)
        got = _pool_run(platform, task, executor, ts, LIB, n_instances,
                        seed)
        want = _pool_run(j_platform, j_task, j_executor, jts, J_LIB,
                         n_instances, seed)
        assert got == want
        assert any(isinstance(x, tuple) and len(x) == 5 and x[2] > 0
                   for x in got) or n_instances == 1
    assert dataclasses.asdict(platform.MigrationPolicy()) == \
        dataclasses.asdict(j_platform.MigrationPolicy())
    with pytest.raises(ValueError):
        platform.AcceleratorPool(0)


def test_kv_slot_arena_quotas_equal_the_reference():
    for total, lanes in ((5, 2), (8, 3), (4, 4), (7, 1)):
        assert KVSlotArena(total, lanes).quotas == \
            JKVSlotArena(total, lanes).quotas
    for bad in ((4, 2, [3, 3]), (1, 2, None)):
        with pytest.raises(ValueError):
            KVSlotArena(bad[0], bad[1], quotas=bad[2])
