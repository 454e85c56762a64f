"""The port's front door and virtual-clock open-loop drive against the
reference's: every virtual serving case of tests/test_serving.py and
tests/test_scenarios.py gives per-request rows (submitted, first-token
and finished times, preemptions, saves, tokens) and an SLO row equal bit
for bit, with the port's MultiLaneServer under the drive."""
import dataclasses
import json

import numpy as np
import pytest

import repro.serving as j_serving
import test_scenarios as ref_scenario_tests
import test_serving as ref_serving_tests
from harness import run_serving_case
from repro.core import serving as j_core
from repro.core.scheduler import Mode as JMode
from repro.core.task import Crit as JCrit
from repro.serving import fig12 as j_fig12
from repro.serving import frontend as j_frontend
import repro_torch.serving as t_serving
from repro_torch.core import serving as t_core
from repro_torch.core.scheduler import Mode as TMode
from repro_torch.core.task import Crit as TCrit
from repro_torch.serving import fig12 as t_fig12
from repro_torch.serving import frontend as t_frontend

J = (j_serving, j_frontend, j_fig12, j_core)
T = (t_serving, t_frontend, t_fig12, t_core)

LOSS = ref_scenario_tests.TestServingLoss.CASE
CASES = list(ref_serving_tests.SERVING_CASES) + [
    dataclasses.replace(LOSS, name=f"loss-{s}", scenario=s)
    for s in (None, "instance_loss", "faults@0")]


def _workload(side, case):
    """tests/harness.py::serving_corpus, through ``side``'s traffic."""
    serving, frontend = side[0], side[1]
    svc = frontend.ServiceModelSpec()
    capacity = case.lanes * svc.lane_capacity_rps(48.0)
    return serving.build_workload(
        seed=case.seed,
        lo_process=serving.make_process(case.arrivals,
                                        case.lo_load * capacity),
        hi_process=serving.make_process("poisson", 0.25 * case.lanes),
        n_lo=case.n_lo, n_hi=case.n_hi, lo_tokens=48, hi_tokens=6)


def _rows(side, case, on_step=None, **kw):
    """tests/harness.py::run_serving_case, through ``side``'s modules."""
    serving, _, fig12, _ = side
    reqs = serving.run_virtual_serving(
        _workload(side, case), lanes=case.lanes,
        policy=fig12.POLICIES[case.policy](), seed=case.seed,
        heuristic=case.heuristic, max_live_lo=case.max_live_lo,
        scenario=case.scenario, on_step=on_step, **kw)
    out = []
    for rid in sorted(reqs):
        r = reqs[rid]
        out.append(dict(
            rid=rid, crit=r.crit.value, done=r.done,
            submitted_at=r.submitted_at, first_token_at=r.first_token_at,
            finished_at=r.finished_at, preemptions=r.preemptions,
            saves=r.saves, tokens=tuple(r.generated)))
    out.append(serving.slo_summary(reqs.values(),
                                   hi_deadline_s=case.hi_deadline_s))
    return out


def _dump(rows):
    return json.dumps(rows, sort_keys=True)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_virtual_serving_rows_bit_equal(case):
    want = run_serving_case(case)
    assert _dump(_rows(J, case)) == _dump(want)      # the helper is the
    got = _rows(T, case)                               # harness's
    assert _dump(got) == _dump(want)
    assert got[-1]["hi_finished"] == case.n_hi
    assert got[-1]["lo_finished"] == case.n_lo


@pytest.mark.parametrize("policy", ["mesc", "np"])
def test_one_resident_slot_bit_equal_and_saves_only_under_mesc(policy):
    """One lane with one resident slot: the configuration in which a HI
    arrival evicts the running LO request's cache (with two slots a
    lane never fills its pool).  Non-preemptive serving never holds two
    caches, so its rows do not depend on the slot count."""
    case = dataclasses.replace(ref_serving_tests.SERVING_CASES[0],
                               lanes=1, policy=policy)
    one = _rows(T, case, slots_per_lane=1)
    assert _dump(one) == _dump(_rows(J, case, slots_per_lane=1))
    two = _rows(T, case, slots_per_lane=2)
    saves = sum(r["saves"] for r in one[:-1])
    if policy == "mesc":
        assert saves > 0
        assert sum(r["saves"] for r in two[:-1]) == 0
    else:
        assert saves == 0 and _dump(one) == _dump(two)


@pytest.mark.parametrize("case", CASES[:2] + CASES[-2:-1], ids=str)
def test_conservation_at_every_step(case):
    steps = []

    def watch(front, server):
        front.check_conservation()
        assert front.finished() + front.live() + front.queued \
            == front.submitted
        steps.append(front.submitted)

    rows = _rows(T, case, on_step=watch)
    assert len(steps) > case.n_lo + case.n_hi
    assert steps[-1] == case.n_lo + case.n_hi
    assert all(r["done"] for r in rows[:-1])


def test_front_door_lo_cap_binds():
    case = ref_serving_tests.SERVING_CASES[2]
    assert case.max_live_lo == 2
    seen = []

    def watch(front, server):
        live_lo = sum(1 for r in server.requests.values()
                      if not r.done and r.crit == TCrit.LO)
        seen.append(live_lo)
        assert live_lo <= case.max_live_lo
        front.check_conservation()

    rows = _rows(T, case, on_step=watch)
    assert max(seen) == case.max_live_lo
    assert rows[-1]["hi_finished"] == case.n_hi
    with pytest.raises(ValueError):
        t_frontend.FrontDoor(None, max_live_lo=0)


def _mode_switch(side):
    """tests/test_serving.py::test_lo_budget_mode_switch_at_virtual_time,
    through ``side``'s modules: (steps, virtual time, exec_s) at which a
    LO request overrunning its budget trips LO -> HI."""
    serving, _, fig12, core = side
    mode_lo = (JMode if side is J else TMode).LO
    clk = serving.VirtualClock()
    model = serving.VirtualModel(clk, seed=3, decode_mean_s=0.010,
                                 jitter=0.0)
    srv = core.MESCServer(None, None, policy=fig12.POLICIES["mesc"](),
                          max_len=64, jit_fns=model.jit_fns, clock=clk)
    lo = core.Request(rid=0, priority=10, prompt=np.asarray([0], np.int32),
                      max_new_tokens=32,
                      crit=(JCrit if side is J else TCrit).LO,
                      lo_budget_s=0.035)
    srv.submit(lo)
    assert srv.mode == mode_lo
    steps = 0
    while srv.mode == mode_lo:
        srv.step()
        steps += 1
        assert steps < 64, "mode never switched"
    return steps, clk(), srv.requests[0].exec_s


def test_lo_budget_mode_switch_at_the_same_virtual_step_and_time():
    want = _mode_switch(J)
    got = _mode_switch(T)
    assert got == want
    assert got == _mode_switch(T)


def test_blocked_lanes_steer_assignment():
    sides = {}
    for name, side in (("jax", J), ("torch", T)):
        serving, frontend, fig12, core = side
        clocks = [serving.VirtualClock() for _ in range(3)]
        models = [serving.VirtualModel(c, seed=0) for c in clocks]
        server = core.MultiLaneServer(
            None, None, n_lanes=3, policy=fig12.POLICIES["mesc"](),
            max_len=16, total_slots=6,
            jit_fns=[m.jit_fns for m in models], clocks=clocks)
        wl = _workload(side, dataclasses.replace(LOSS, lanes=3, n_lo=6,
                                                 n_hi=2))
        server.blocked_lanes = {0, 2}
        lanes = [server.submit(frontend.make_request(s)) for s in wl[:4]]
        server.blocked_lanes = {0, 1, 2}
        lanes += [server.submit(frontend.make_request(s)) for s in wl[4:]]
        sides[name] = lanes
    assert sides["torch"][:4] == [1, 1, 1, 1]
    assert sides["torch"] == sides["jax"]


def test_virtual_model_stays_on_the_host():
    import torch
    clk = t_serving.VirtualClock()
    m = t_serving.VirtualModel(clk, seed=1)
    _, cache = m.prefill(None, {"tokens": torch.tensor([[7]])})
    logits, cache = m.decode(None, None, cache)
    assert logits.device.type == "cpu" and logits.shape == (1, 256)
    assert float(logits.sum()) == 1.0 and cache["k"] == 1
    assert clk() > 0
    with pytest.raises(ValueError):
        t_serving.VirtualModel(clk, seed=1, jitter=1.0)
    with pytest.raises(ValueError):
        clk.advance(-1.0)
