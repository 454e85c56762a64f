"""The port's task model, programs, task-set generation and batch tables
against the JAX package's: configs field by field, the workload library
segment by segment, task sets draw for draw, and the lockstep engine's
static tables and release phases array by array."""
import dataclasses

import numpy as np
import pytest

from repro import configs as j_configs
from repro.core import isa as j_isa
from repro.core import program as j_program
from repro.core import simulator as j_simulator
from repro.core import simulator_vec as j_vec
from repro.core import task as j_task
from repro.core import taskgen as j_taskgen
from repro.core.scheduler import Policy as JPolicy

from repro_torch import configs
from repro_torch.core import isa, program, simulator, simulator_vec, task, \
    taskgen
from repro_torch.core.scheduler import Policy


@pytest.fixture(scope="module")
def libs():
    return j_program.workload_library(), program.workload_library()


def _sim(lib):
    return {k: v for k, v in lib.items() if not k.startswith("arch:")}


def _asdict(cfg):
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", sorted(j_configs.ARCHS))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_every_config_equals_the_reference(name, smoke):
    key = name + ("-smoke" if smoke else "")
    jc, tc = j_configs.get_config(key), configs.get_config(key)
    assert _asdict(tc) == _asdict(jc)
    assert tc.dh == jc.dh


def test_config_registry_order_and_fields():
    assert list(configs.ARCHS) == list(j_configs.ARCHS)
    for cls in ("ArchConfig", "MoEConfig", "MLAConfig", "RGLRUConfig",
                "XLSTMConfig"):
        got = [f.name for f in dataclasses.fields(getattr(configs, cls))]
        want = [f.name for f in dataclasses.fields(getattr(j_configs, cls))]
        assert got == want, cls


def test_isa_constants_and_costs():
    for name in ("DMA_BYTES_PER_CYCLE", "DMA_SETUP_CYCLES", "TILE_DIM",
                 "CONFIG_CYCLES", "SCRATCHPAD_BANKS", "BANK_BYTES",
                 "ACCUM_BYTES", "REMAP_BLOCK_BYTES", "FREEZE_CYCLES",
                 "FLUSH_CYCLES"):
        assert getattr(isa, name) == getattr(j_isa, name), name
    assert [o.value for o in isa.Op] == [o.value for o in j_isa.Op]
    for op in isa.Op:
        for nbytes, k in ((0, 0), (17, 3), (4096, 300)):
            got = isa.instruction_cost(isa.Instruction(op, bytes=nbytes, k=k))
            want = j_isa.instruction_cost(
                j_isa.Instruction(j_isa.Op(op.value), bytes=nbytes, k=k))
            assert got == want, op
            assert isa.Instruction(op, bytes=nbytes, k=k).cost == got


def _segments(prog):
    return [(tuple(o.value for o in s.pattern_ops), s.pattern_costs,
             s.repeats, s.operator) for s in prog.segments]


def test_workload_library_equals_the_reference(libs):
    jlib, tlib = libs
    assert list(tlib) == list(jlib)
    for name in jlib:
        j, t = jlib[name], tlib[name]
        assert t.name == j.name
        assert _segments(t) == _segments(j), name
        assert t.working_set_bytes == j.working_set_bytes
        assert t.total_cycles == j.total_cycles
        assert t.n_instructions == j.n_instructions
        assert t.n_operators == j.n_operators
        assert t.max_instruction_cycles == j.max_instruction_cycles
        assert np.array_equal(t.operator_cycle_sizes(),
                              j.operator_cycle_sizes())
        assert taskgen.eta_for(t) == j_taskgen.eta_for(j)


@pytest.mark.parametrize("name", ["small_gemm", "alexnet_xs",
                                  "transformer_s", "arch:xlstm-125m"])
def test_preemption_boundaries_equal_the_reference(libs, name):
    j, t = libs[0][name], libs[1][name]
    total = t.total_cycles
    ends = [int(e) for e in t._seg_ends]
    offs = [0.0, 0.5, 1.0, total - 1.0, total - 1e-9, float(total),
            total + 0.5, 2.0 * total, 3.0 * total + 7.0]
    offs += [float(e) for e in ends] + [e - 0.25 for e in ends]
    offs += list(np.random.default_rng(0).uniform(0, 3 * total, 64))
    for off in offs:
        assert t.next_instruction_boundary(off) == \
            j.next_instruction_boundary(off), off
        assert t.next_operator_boundary(off) == \
            j.next_operator_boundary(off), off


def test_program_helpers_equal_the_reference():
    cfg = configs.get_config("deepseek-v2-lite-16b")
    assert program.arch_layer_gemms(cfg, seq=64) == \
        j_program.arch_layer_gemms(
            j_configs.get_config("deepseek-v2-lite-16b"), seq=64)
    assert program.scaled(program.ALEXNET, 0.3) == \
        j_program.scaled(j_program.ALEXNET, 0.3)
    hist = program.build_program("p", [(40, 70, 33)]) \
        .instruction_cost_histogram()
    jhist = j_program.build_program("p", [(40, 70, 33)]) \
        .instruction_cost_histogram()
    assert {o.value: h.tolist() for o, h in hist.items()} == \
        {o.value: h.tolist() for o, h in jhist.items()}
    ins = list(program.build_program("p", [(20, 20, 20)]).instructions())
    jins = list(j_program.build_program("p", [(20, 20, 20)]).instructions())
    assert [(i.op.value, i.bytes, i.k, i.operator, i.last_in_operator)
            for i in ins] == \
        [(i.op.value, i.bytes, i.k, i.operator, i.last_in_operator)
         for i in jins]


def _params(tp):
    d = dataclasses.asdict(tp)
    d["crit"] = tp.crit.value
    return d


@pytest.mark.parametrize("seed0", [0, 3])
@pytest.mark.parametrize("u,n_tasks,max_task_u", [
    (0.7, 10, None), (0.9, 13, None), (2.5, 12, 0.6)])
def test_generate_taskset_at_each_point_seed(libs, seed0, u, n_tasks,
                                             max_task_u):
    jlib, tlib = _sim(libs[0]), _sim(libs[1])
    for s in range(24):
        seed = taskgen.point_seed(seed0, s)
        assert seed == j_taskgen.point_seed(seed0, s)
        got = taskgen.generate_taskset(u, seed=seed, n_tasks=n_tasks,
                                       programs=tlib, max_task_u=max_task_u)
        want = j_taskgen.generate_taskset(u, seed=seed, n_tasks=n_tasks,
                                          programs=jlib,
                                          max_task_u=max_task_u)
        assert [_params(t) for t in got] == [_params(t) for t in want]
    got = taskgen.generate_taskset_batch(0.8, 5, seed0=7, programs=tlib)
    want = j_taskgen.generate_taskset_batch(0.8, 5, seed0=7, programs=jlib)
    assert [[_params(t) for t in ts] for ts in got] == \
        [[_params(t) for t in ts] for ts in want]


def test_generate_taskset_default_library():
    got = taskgen.generate_taskset(0.8, seed=11)
    want = j_taskgen.generate_taskset(0.8, seed=11)
    assert [_params(t) for t in got] == [_params(t) for t in want]


def test_uunifast_draws_equal_the_reference():
    for seed in range(8):
        got = taskgen.uunifast(9, 0.85, np.random.default_rng(seed))
        want = j_taskgen.uunifast(9, 0.85, np.random.default_rng(seed))
        assert np.array_equal(got, want)
        got = taskgen.uunifast_discard(6, 2.0, np.random.default_rng(seed),
                                       max_u=0.5)
        want = j_taskgen.uunifast_discard(6, 2.0,
                                          np.random.default_rng(seed),
                                          max_u=0.5)
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="max_u"):
        taskgen.uunifast_discard(2, 1.9, np.random.default_rng(0),
                                 max_u=0.5, max_tries=5)


def test_task_control_block_equals_the_reference():
    assert [s.value for s in task.Status] == [s.value for s in j_task.Status]
    kw = dict(tid=1, priority=2, period=100.0, deadline=90.0, c_lo=10.0,
              c_hi=20.0, eta=3, workload="small_gemm")
    tcb = task.TCB(task.TaskParams(crit=task.Crit.HI, **kw))
    jtcb = j_task.TCB(j_task.TaskParams(crit=j_task.Crit.HI, **kw))
    for t in (tcb, jtcb):
        t.release(40.0)
        t.exec_cycles = 12.5
    assert (tcb.status.value, tcb.job_deadline, tcb.jobs_released,
            tcb.tid) == (jtcb.status.value, jtcb.job_deadline,
                         jtcb.jobs_released, jtcb.tid)
    for hi in (False, True):
        assert tcb.remaining_budget(hi) == jtcb.remaining_budget(hi)


def test_run_metrics_and_aggregates():
    agg = simulator.AggSamples(9.0, 3)
    assert agg.mean == 3.0 and len(agg) == 3
    assert np.isnan(simulator.AggSamples(0.0, 0).mean)
    assert agg == simulator.AggSamples(9.0, 3)
    with pytest.raises(TypeError):
        list(agg)
    m = simulator.RunMetrics(lo_released_in_hi=4, lo_done_in_hi=3)
    jm = j_simulator.RunMetrics(lo_released_in_hi=4, lo_done_in_hi=3)
    assert m.survivability() == jm.survivability()
    m.misses["LO"] = jm.misses["LO"] = 1
    assert (m.success(), m.success("HI")) == (jm.success(), jm.success("HI"))
    assert [f.name for f in dataclasses.fields(simulator.RunMetrics)] == \
        [f.name for f in dataclasses.fields(j_simulator.RunMetrics)]
    assert simulator.DEMAND_PROFILES == j_simulator.DEMAND_PROFILES
    assert simulator_vec.BACKENDS == j_vec.BACKENDS
    assert simulator_vec.VEC_SIM_SEMANTICS_VERSION == \
        j_vec.VEC_SIM_SEMANTICS_VERSION
    assert simulator_vec.JIT_SIM_SEMANTICS_VERSION == \
        j_vec.JIT_SIM_SEMANTICS_VERSION


def test_vec_constants_equal_the_reference():
    for name in ("_PEND", "_READY", "_RUN", "_INT", "_LO", "_TRANS", "_HI",
                 "_MODE_KEYS", "_C_NONE", "_C_PI", "_C_CIQ", "_C_CI",
                 "_PID_KEY", "_EMPTY", "_BB", "_NBANKS", "_CAP", "_FF",
                 "_CFG_CY", "_REMAP_CY", "_RESTORE_FIXED"):
        assert getattr(simulator_vec, name) == getattr(j_vec, name), name
    n = np.array([-3, 0, 1, 16, 17, 4096, 65536], np.int64)
    assert np.array_equal(simulator_vec._dma_vec(n), j_vec._dma_vec(n))


@pytest.mark.parametrize("scenario", [None, "phase_shift", "faults@0.7"])
@pytest.mark.parametrize("policy", ["mesc", "lp"])
def test_batch_tables_and_phases_equal_the_reference(libs, scenario,
                                                     policy):
    jlib, tlib = _sim(libs[0]), _sim(libs[1])
    sizes, seeds = (3, 10, 6, 13), [0, 1, 2, 3 + 2 ** 40]
    jts = [j_taskgen.generate_taskset(0.9, seed=s, n_tasks=n, programs=jlib)
           for s, n in enumerate(sizes)]
    tts = [taskgen.generate_taskset(0.9, seed=s, n_tasks=n, programs=tlib)
           for s, n in enumerate(sizes)]
    jp = {"mesc": JPolicy.mesc(), "lp": JPolicy.limited()}[policy]
    tp = {"mesc": Policy.mesc(), "lp": Policy.limited()}[policy]
    kw = dict(seeds=seeds, duration=2e7, overrun_prob=0.3, cf=2.0,
              scenario=scenario)
    jb = j_vec._VecBatch(jts, jlib, jp, **kw)
    tb = simulator_vec._VecBatch(tts, tlib, tp, **kw)
    for name in ("valid", "prio", "period", "deadline_rel", "c_lo", "is_hi",
                 "eta", "prog_id", "etab", "next_release", "seed64",
                 "_prog_total", "_g_seg_key", "_g_seg_cycles", "_g_seg_pat",
                 "_g_pat_cumsum", "_g_op_key", "_g_op_end", "_g_op_hi"):
        a, b = getattr(tb, name), getattr(jb, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert (tb.P, tb.T, tb.t_sr, tb.preempt, tb.use_banks, tb.drop_lo) == \
        (jb.P, jb.T, jb.t_sr, jb.preempt, jb.use_banks, jb.drop_lo)
