"""The port's host scheduling core against the JAX package's: the MESC
mode rules (``pick_next``, ``eligible_set``, ``update_mode``), the
platform ``ModeCoordinator``, the address remapper, the GemminiRT
context-switch cost model and the task monitor.  The same numpy-seeded
inputs go through both packages; every answer must be equal."""
import dataclasses

import numpy as np
import pytest

from repro.core import executor as j_executor
from repro.core import monitor as j_monitor
from repro.core import remapper as j_remapper
from repro.core import scheduler as j_scheduler
from repro.core import task as j_task
from repro.core.program import workload_library as j_workload_library

from repro_torch.core import executor, monitor, remapper, scheduler, task
from repro_torch.core.program import workload_library

POLICIES = ("mesc", "non_preemptive", "limited", "amc-instruction",
            "amc-operator")
MODES = ("LO", "TRANS", "HI")
J_LIB = j_workload_library(include_archs=True)
LIB = workload_library(include_archs=True)


def _policy(name, mod):
    P = mod.Policy
    if name.startswith("amc-"):
        return P.amc(name.split("-", 1)[1])
    return getattr(P, name)()


def _tcbs(rng, mod_task):
    """One random TCB table: 1-6 tasks, every status, both criticalities,
    priorities with ties, random residency."""
    n = int(rng.integers(1, 7))
    out = {}
    statuses = list(mod_task.Status)
    for tid in range(n):
        crit = mod_task.Crit.HI if rng.random() < 0.5 else mod_task.Crit.LO
        p = mod_task.TaskParams(
            tid=tid, priority=int(rng.integers(0, 4)), period=1e6,
            deadline=1e6, c_lo=1e4, c_hi=2e4, crit=crit, eta=1,
            workload="small_gemm")
        t = mod_task.TCB(params=p,
                         status=statuses[int(rng.integers(len(statuses)))])
        t.data_in_accel = bool(rng.random() < 0.4)
        out[tid] = t
    return out


def _states(seed, n=300):
    """(reference tcbs, port tcbs, resident list, any_active) drawn from
    one numpy stream, built twice so each package gets its own objects."""
    out = []
    rng = np.random.default_rng(seed)
    for _ in range(n):
        state = rng.bit_generator.state
        j = _tcbs(rng, j_task)
        rng.bit_generator.state = state
        p = _tcbs(rng, task)
        resident = [int(t) for t in sorted(j)
                    if rng.random() < 0.3]
        out.append((j, p, resident, bool(rng.random() < 0.7)))
    return out


def _tid(t):
    return None if t is None else t.tid


@pytest.mark.parametrize("policy", POLICIES)
def test_pick_next_eligible_set_and_update_mode_equal_the_reference(policy):
    jp, pp = _policy(policy, j_scheduler), _policy(policy, scheduler)
    assert dataclasses.asdict(jp) == dataclasses.asdict(pp)
    n_picked = 0
    for j, p, resident, any_active in _states(POLICIES.index(policy)):
        for mode in MODES:
            jm, pm = j_scheduler.Mode[mode], scheduler.Mode[mode]
            want = _tid(j_scheduler.pick_next(j, jm, resident, jp))
            got = _tid(scheduler.pick_next(p, pm, resident, pp))
            assert got == want, (mode, resident)
            n_picked += want is not None
            # pick_next is min(eligible_set, key=priority), first wins
            elig = scheduler.eligible_set(p, pm, resident, pp)
            assert [t.tid for t in elig] == [
                t.tid for t in j_scheduler.eligible_set(j, jm, resident, jp)]
            best = min(elig, key=lambda t: t.params.priority) if elig \
                else None
            assert _tid(best) == got
            assert scheduler.update_mode(pm, p, resident, any_active).name \
                == j_scheduler.update_mode(jm, j, resident,
                                           any_active).name
    assert n_picked > 100


def test_active_statuses_and_mode_severity_equal_the_reference():
    assert [s.name for s in scheduler.ACTIVE] == \
        [s.name for s in j_scheduler.ACTIVE]
    assert {m.name: v for m, v in scheduler.MODE_SEVERITY.items()} == \
        {m.name: v for m, v in j_scheduler.MODE_SEVERITY.items()}


@pytest.mark.parametrize("n_instances", [1, 2, 4])
def test_mode_coordinator_equals_the_reference(n_instances):
    jc = j_scheduler.ModeCoordinator(n_instances)
    pc = scheduler.ModeCoordinator(n_instances)
    rng = np.random.default_rng(100 + n_instances)
    states = _states(200 + n_instances, n=120)
    for j, p, resident, any_active in states:
        inst = int(rng.integers(n_instances))
        if rng.random() < 0.3:
            mode = MODES[int(rng.integers(3))]
            jc.set_mode(inst, j_scheduler.Mode[mode])
            pc.set_mode(inst, scheduler.Mode[mode])
        assert pc.update_instance(inst, p, resident, any_active).name == \
            jc.update_instance(inst, j, resident, any_active).name
        assert [m.name for m in pc.modes] == [m.name for m in jc.modes]
        assert pc.mode_of(inst).name == jc.mode_of(inst).name
        assert pc.platform_mode().name == jc.platform_mode().name
        assert pc.degraded() == jc.degraded()
        for mode in MODES:
            assert pc.instances_in(scheduler.Mode[mode]) == \
                jc.instances_in(j_scheduler.Mode[mode])


def _remapper_state(rm, tids):
    return (rm.locked_banks(), rm.free_banks(), rm.resident_tasks(),
            [(rm.banks_of(t), rm.resident_bytes(t), rm.snapshot(t),
              rm.locked_banks(exclude_tid=t), rm.fits(2, exclude_tid=t))
             for t in tids],
            [(b.idx, b.owner, b.used_bytes, b.locked) for b in rm.banks],
            sorted(rm.remap_block.items()))


@pytest.mark.parametrize("n_banks", [4, 8])
def test_address_remapper_equals_the_reference(n_banks):
    jr = j_remapper.AddressRemapper(n_banks=n_banks)
    pr = remapper.AddressRemapper(n_banks=n_banks)
    rng = np.random.default_rng(n_banks)
    tids = list(range(5))
    bb = pr.bank_bytes
    n_full = 0
    for _ in range(400):
        op = rng.random()
        tid = int(rng.integers(len(tids)))
        laddr = int(rng.integers(4)) * 4096
        if op < 0.55:
            nbytes = int(rng.integers(1, 3 * bb))
            strict = bool(rng.random() < 0.2)
            outs = []
            for r in (jr, pr):
                try:
                    outs.append(("ok", r.write(tid, laddr, nbytes,
                                               strict=strict)))
                except MemoryError as e:
                    outs.append(("full", str(e)))
            assert outs[0] == outs[1]
            n_full += outs[0][0] == "full"
        elif op < 0.7:
            assert pr.read(tid, laddr) == jr.read(tid, laddr)
        elif op < 0.85:
            jr.release(tid)
            pr.release(tid)
        else:
            snap = jr.snapshot(tid)
            nbytes = int(rng.integers(0, 2 * bb))
            jr.restore(tid, snap, nbytes)
            pr.restore(tid, pr.snapshot(tid), nbytes)
        assert _remapper_state(pr, tids) == _remapper_state(jr, tids)
    assert n_full > 0
    assert pr.remap_block_bytes == jr.remap_block_bytes


def _ops(slots):
    """Config slots ``(Op, meta)`` by op name (each package has its own
    ``Op``)."""
    return [None if v is None else (v[0].name, v[1]) for v in slots]


def _stream(prog, n=256):
    return [(i.op.name, i.bytes, i.k, i.operator, i.last_in_operator,
             i.meta, i.cost) for i in prog.instructions(max_n=n)]


def _cs_run(mod_exec, mod_task, prog, use_remapper, rng_seed):
    """Two tasks share one accelerator: task 0 streams the program,
    task 1 preempts it, 0 resumes; every breakdown and the residency
    after each step, as plain tuples."""
    rng = np.random.default_rng(rng_seed)
    acc = mod_exec.GemminiRT(use_remapper=use_remapper)
    tcbs = []
    for tid in range(2):
        p = mod_task.TaskParams(
            tid=tid, priority=tid, period=1e7, deadline=1e7, c_lo=1e5,
            c_hi=2e5, crit=mod_task.Crit.HI if tid else mod_task.Crit.LO,
            eta=int(rng.integers(1, 9)), workload=prog.name)
        tcbs.append(mod_task.TCB(params=p))
    out = [acc.execute(ins, 0) for ins in prog.instructions(max_n=64)]
    out.append(_ops(acc.config_buffer.snapshot()))
    for step in range(6):
        tid = step % 2
        acc.note_execution(tid, float(rng.uniform(0, 5e4)), prog)
        nxt = tcbs[1 - tid]
        br = acc.context_save(tcbs[tid], int(rng.integers(0, 500)),
                              next_eta=nxt.params.eta if rng.random() < 0.7
                              else None)
        out.append(("save", dataclasses.astuple(br), br.total,
                    tcbs[tid].data_in_accel))
        br = acc.context_restore(nxt)
        out.append(("restore", dataclasses.astuple(br), br.total,
                    nxt.data_in_accel))
        out.append((acc.remapper.resident_tasks(),
                    sorted(acc.accum_bytes_used.items()),
                    sorted(acc.spad_bytes.items()),
                    sorted((k, v["accumulator"], v["scratchpad"],
                            v["kept_resident"]) for k, v in
                           acc.dram.items())))
    out.append((acc.instruction_freeze(), acc.flush(), acc.evict(0),
                acc.evict(1)))
    return out


@pytest.mark.parametrize("name", sorted(LIB))
def test_gemmini_context_switch_cost_equals_the_reference(name):
    assert _stream(LIB[name]) == _stream(J_LIB[name])
    for use_remapper in (True, False):
        want = _cs_run(j_executor, j_task, J_LIB[name], use_remapper, 7)
        got = _cs_run(executor, task, LIB[name], use_remapper, 7)
        assert got == want, (name, use_remapper)
    for n in (0, 1, 64, 4095, 4096, 1 << 20):
        assert executor._dma_cycles(n) == j_executor._dma_cycles(n)


def test_config_copy_buffer_and_frozen_accelerator_equal_the_reference():
    prog, jprog = LIB["small_gemm"], J_LIB["small_gemm"]
    acc, jacc = executor.GemminiRT(), j_executor.GemminiRT()
    for ins, jins in zip(prog.instructions(), jprog.instructions()):
        assert acc.execute(ins, 3) == jacc.execute(jins, 3)
    assert _ops(acc.config_buffer.snapshot()) == \
        _ops(jacc.config_buffer.snapshot())
    assert _ops(acc.config.as_tuple()) == _ops(jacc.config.as_tuple())
    assert acc.accum_bytes_used == jacc.accum_bytes_used
    assert _remapper_state(acc.remapper, [3]) == \
        _remapper_state(jacc.remapper, [3])
    acc.instruction_freeze()
    with pytest.raises(RuntimeError, match="frozen"):
        acc.execute(next(prog.instructions()), 3)
    acc.config_buffer.clear()
    assert acc.config_buffer.snapshot() == (None,) * 4


def test_task_monitor_with_an_injected_clock_equals_the_reference():
    fired = {"ref": [], "port": []}
    jm = j_monitor.TaskMonitor(on_overrun=lambda t: fired["ref"].append(
        (t.tid, t.exec_cycles)))
    pm = monitor.TaskMonitor(on_overrun=lambda t: fired["port"].append(
        (t.tid, t.exec_cycles)))
    for tid in range(4):
        kw = dict(tid=tid, priority=tid, period=1e4, deadline=1e4,
                  c_lo=300.0, c_hi=600.0, eta=1, workload="small_gemm")
        jm.register(j_task.TaskParams(crit=j_task.Crit.HI if tid % 2
                                      else j_task.Crit.LO, **kw))
        pm.register(task.TaskParams(crit=task.Crit.HI if tid % 2
                                    else task.Crit.LO, **kw))
    rng = np.random.default_rng(5)
    now = 0.0
    for _ in range(300):
        now += float(rng.uniform(0, 60))
        tid = int(rng.integers(4))
        op = rng.random()
        for m in (jm, pm):
            if op < 0.4:
                m.timer_activate(tid, now=now)
            elif op < 0.85:
                m.timer_pause(tid, now=now)
            elif op < 0.95:
                m.timer_set(tid)
            else:
                m.update_status(tid, (task.Status if m is pm
                                      else j_task.Status).RUNNING)
        for t in range(4):
            assert pm.elapsed(t) == jm.elapsed(t)
            assert pm.timer_is_zero(t) == jm.timer_is_zero(t)
            a, b = pm.tcbs[t], jm.tcbs[t]
            assert (a.exec_cycles, a.budget_overrun, a.status.name) == \
                (b.exec_cycles, b.budget_overrun, b.status.name)
    assert fired["port"] == fired["ref"] and fired["ref"]
