"""The port's MESC serving lane against the reference's, on the five
model-backed scenarios of tests/test_serving.py (TestMESCServing x3,
TestMultiLaneServing x2) and a HI arrival that saves a running LO
request's context to the host (one resident slot): same step order, same
generated tokens, same saves and preemptions, and an empty arena at the
end.  Both servers run tinyllama-1.1b-smoke, recurrentgemma-2b-smoke,
deepseek-v2-lite-16b-smoke (MLA + MoE), llama4-maverick-400b-a17b-smoke
(MoE), xlstm-125m-smoke (mLSTM + sLSTM: a fixed-size recurrent state) and
llava-next-34b-smoke (vlm, text prompts) in fp32 on the CPU with the same
parameters (the reference's, converted by ``params_from_jax``).  The
audio family takes (B, S, K) prompts, which neither server feeds
(tests/test_torch_vlm_audio.py)."""
import dataclasses
from typing import Any

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import scheduler as j_scheduler
from repro.core import serving as j_serving
from repro.core import task as j_task
from repro.models import lm as j_lm
from repro.models.common import CPU_RC as J_CPU_RC
from repro_torch.configs import get_config
from repro_torch.core import scheduler, serving, task
from repro_torch.models import lm
from repro_torch.models.common import CPU_RC

ARCH = "tinyllama-1.1b-smoke"
HYBRID = "recurrentgemma-2b-smoke"
MLA_MOE = "deepseek-v2-lite-16b-smoke"
MOE = "llama4-maverick-400b-a17b-smoke"
XLSTM = "xlstm-125m-smoke"
VLM = "llava-next-34b-smoke"


@dataclasses.dataclass(frozen=True)
class Side:
    serving: Any
    Crit: Any
    Policy: Any
    cfg: Any
    params: Any


_SIDES = {}


def _sides(arch=ARCH, **overrides):
    """The reference's and the port's server modules with one model,
    ``arch`` with config ``overrides``, on each side."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _SIDES:
        jcfg = dataclasses.replace(j_get_config(arch), **overrides)
        jp = j_lm.init_params(jcfg, jax.random.PRNGKey(0), J_CPU_RC)
        tcfg = dataclasses.replace(get_config(arch), **overrides)
        tp = lm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                                CPU_RC, device="cpu")
        _SIDES[key] = {
            "jax": Side(j_serving, j_task.Crit, j_scheduler.Policy, jcfg, jp),
            "torch": Side(serving, task.Crit, scheduler.Policy, tcfg, tp)}
    return _SIDES[key]


def _req(s: Side, rid, crit, prio, n=6):
    rng = np.random.default_rng(rid)
    return s.serving.Request(rid=rid, priority=prio,
                             prompt=rng.integers(0, s.cfg.vocab, 8,
                                                 dtype=np.int32),
                             max_new_tokens=n, crit=getattr(s.Crit, crit))


def _drain(srv, order):
    while True:
        ran = srv.step()
        order.append(ran)
        if ran is None or (isinstance(ran, list)
                           and all(x is None for x in ran)):
            return


def _record(order, servers):
    reqs = {}
    for name, srv in servers.items():
        for rid, r in srv.requests.items():
            reqs[(name, rid)] = (list(r.generated), r.saves, r.preemptions,
                                 r.done)
    held = {name: [srv.arena.held(i) for i in range(len(srv.arena.quotas))]
            for name, srv in servers.items()}
    return {"order": order, "requests": reqs, "held": held}


def hi_preempts_lo(s: Side):
    srv = s.serving.MESCServer(s.cfg, s.params, policy=s.Policy.mesc(),
                               max_len=32)
    order = []
    srv.submit(_req(s, 0, "LO", 10, n=12))
    order += [srv.step() for _ in range(2)]
    srv.submit(_req(s, 1, "HI", 0, n=3))
    order.append("hi")
    order += [srv.step() for _ in range(4)]
    assert order[3] == 1                  # HI runs at the very next step
    _drain(srv, order)
    return _record(order, {"srv": srv})


def non_preemptive_runs_to_completion(s: Side):
    srv = s.serving.MESCServer(s.cfg, s.params,
                               policy=s.Policy.non_preemptive(), max_len=32)
    order = []
    srv.submit(_req(s, 0, "LO", 10, n=8))
    order.append(srv.step())
    srv.submit(_req(s, 1, "HI", 0, n=2))
    order += [srv.step() for _ in range(7)]
    assert all(r == 0 for r in order)     # LO holds the accelerator
    _drain(srv, order)
    return _record(order, {"srv": srv})


def bank_pool_eviction_and_restore(s: Side):
    out = {}
    order = []
    for name, slots in (("pool1", 1), ("pool4", 4)):
        srv = s.serving.MESCServer(s.cfg, s.params, policy=s.Policy.mesc(),
                                   max_len=32, resident_slots=slots)
        srv.submit(_req(s, 0, "LO", 1))
        order += [srv.step() for _ in range(3)]
        srv.submit(_req(s, 1, "LO", 2))
        _drain(srv, order)
        out[name] = srv
    rec = _record(order, out)
    for rid in (0, 1):                    # eviction is output-preserving
        assert rec["requests"][("pool1", rid)][0] \
            == rec["requests"][("pool4", rid)][0]
    return rec


def hi_saves_lo_with_one_resident_slot(s: Side):
    """A HI arrival after a LO start on a one-slot pool: the running LO
    request's context is saved to the host, the HI request runs at the
    next step, and the LO request resumes from its restored context."""
    srv = s.serving.MESCServer(s.cfg, s.params, policy=s.Policy.mesc(),
                               max_len=32, resident_slots=1)
    order = []
    srv.submit(_req(s, 0, "LO", 10, n=10))
    order += [srv.step() for _ in range(3)]
    srv.submit(_req(s, 1, "HI", 0, n=3))
    order.append("hi")
    order.append(srv.step())
    assert order[-1] == 1
    _drain(srv, order)
    rec = _record(order, {"srv": srv})
    assert rec["requests"][("srv", 0)][1] >= 1      # saved at least once
    return rec


def lanes_partition_and_preserve_output(s: Side):
    msrv = s.serving.MultiLaneServer(s.cfg, s.params, n_lanes=2, max_len=32,
                                     total_slots=2, heuristic="crit_aware")
    reqs = [_req(s, 0, "HI", 0), _req(s, 1, "HI", 1),
            _req(s, 2, "LO", 10), _req(s, 3, "LO", 11)]
    lanes = [msrv.submit(r) for r in reqs]
    assert sorted(lanes[:2]) == [0, 1]    # HI spread one per lane
    order = [lanes]
    _drain(msrv, order)
    ref = s.serving.MESCServer(s.cfg, s.params, max_len=32, resident_slots=4)
    for r in [_req(s, 0, "HI", 0), _req(s, 1, "HI", 1),
              _req(s, 2, "LO", 10), _req(s, 3, "LO", 11)]:
        ref.submit(r)
    _drain(ref, order)
    rec = _record(order, {"multi": msrv, "single": ref})
    for rid in range(4):
        assert rec["requests"][("multi", rid)][0] \
            == rec["requests"][("single", rid)][0]
    return rec


def non_preemptive_lane_isolation(s: Side):
    msrv = s.serving.MultiLaneServer(s.cfg, s.params, n_lanes=2, max_len=32,
                                     policy=s.Policy.non_preemptive())
    order = []
    msrv.submit(_req(s, 0, "LO", 10, n=10))
    order.append(msrv.step())
    hi_lane = msrv.submit(_req(s, 1, "HI", 0, n=2))
    assert hi_lane != msrv.lane_of[0]
    ran = msrv.step()
    assert ran[hi_lane] == 1              # HI runs immediately
    order += [hi_lane, ran]
    _drain(msrv, order)
    return _record(order, {"multi": msrv})


SCENARIOS = [hi_preempts_lo, non_preemptive_runs_to_completion,
             bank_pool_eviction_and_restore,
             lanes_partition_and_preserve_output,
             non_preemptive_lane_isolation, hi_saves_lo_with_one_resident_slot]


# the tinyllama cases keep their bare scenario ids
CASES = [pytest.param(f, ARCH, id=f.__name__) for f in SCENARIOS] + \
    [pytest.param(f, a, id=f"{f.__name__}-{a}")
     for a in (HYBRID, MLA_MOE, MOE, XLSTM, VLM) for f in SCENARIOS]


@pytest.mark.parametrize("scenario,arch", CASES)
def test_port_serves_like_the_reference(scenario, arch):
    sides = _sides(arch)
    want = scenario(sides["jax"])
    got = scenario(sides["torch"])
    assert got["order"] == want["order"]
    assert got["requests"] == want["requests"]
    assert all(r[3] for r in got["requests"].values())   # all finished
    assert all(h == 0 for hs in got["held"].values() for h in hs)
    assert got["held"] == want["held"]


def test_eviction_moves_the_cache_to_host_and_back():
    s = _sides()["torch"]
    srv = s.serving.MESCServer(s.cfg, s.params, max_len=32, resident_slots=1)
    a, b = _req(s, 0, "LO", 1), _req(s, 1, "LO", 0)
    srv.submit(a)
    srv.step()
    srv.submit(b)                        # higher priority, pool of one
    srv.step()
    assert a.saves == 1 and not a.resident
    assert a.cache["ck"].device.type == "cpu" and a.cache["pos"] == 9
    srv.run()
    assert a.done and b.done and a.cache is None


def _leaf_devices(cache):
    out = []
    for v in cache.values():
        if isinstance(v, dict):
            out += _leaf_devices(v)
        elif isinstance(v, torch.Tensor):
            out.append(v.device.type)
    return out


def test_eviction_moves_every_leaf_of_a_hybrid_cache():
    """A 5-layer hybrid keeps its tail layers' RG-LRU states under
    ``cache["tail"]``: a save must take them to the host with the rest,
    and a restore bring them back.  The CPU has no second device, so the
    restore targets the ``meta`` device, where a leaf left behind would
    still be on the CPU."""
    s = _sides(HYBRID, n_layers=5, tie_embeddings=False)["torch"]
    srv = s.serving.MESCServer(s.cfg, s.params, max_len=32, resident_slots=1)
    a = _req(s, 0, "LO", 1)
    srv.submit(a)
    srv.step()
    assert set(a.cache["tail"]) == {"rh", "rconv"}
    srv._evict(a)
    assert a.saves == 1 and not a.resident
    assert set(_leaf_devices(a.cache)) == {"cpu"}
    assert len(_leaf_devices(a.cache)) == 8       # 6 + the tail's 2
    srv.device = torch.device("meta")
    srv._restore(a)
    assert a.resident and set(_leaf_devices(a.cache)) == {"meta"}
    assert a.cache["pos"] == 9


def test_eviction_moves_an_mla_cache_to_host_and_back():
    """DeepSeek-V2's compressed cache (``cc``, ``ckr``) leaves the device
    on a save and comes back on a restore (``meta`` stands in for a
    second device), and a request served across a save gives the tokens
    of one served alone."""
    s = _sides(MLA_MOE)["torch"]
    srv = s.serving.MESCServer(s.cfg, s.params, max_len=32, resident_slots=1)
    a = _req(s, 0, "LO", 1)
    srv.submit(a)
    srv.step()
    assert set(a.cache) == {"cc", "ckr", "pos"}
    srv._evict(a)
    assert a.saves == 1 and set(_leaf_devices(a.cache)) == {"cpu"}
    assert len(_leaf_devices(a.cache)) == 2
    srv.device = torch.device("meta")
    srv._restore(a)
    assert a.resident and set(_leaf_devices(a.cache)) == {"meta"}
    assert a.cache["pos"] == 9
    # served with one resident slot (b preempts a, a is saved and
    # restored) against a alone
    srv = s.serving.MESCServer(s.cfg, s.params, max_len=32, resident_slots=1)
    a, b = _req(s, 0, "LO", 1), _req(s, 1, "LO", 0)
    srv.submit(a)
    srv.step()
    srv.submit(b)
    srv.run()
    assert a.saves == 1 and a.done and b.done
    solo = s.serving.MESCServer(s.cfg, s.params, max_len=32)
    alone = _req(s, 0, "LO", 1)
    solo.submit(alone)
    solo.run()
    assert a.generated == alone.generated


def test_heuristics_and_mode_severity_are_the_reference_tables():
    from repro.core.platform import HEURISTICS as J_HEURISTICS
    assert serving.HEURISTICS == tuple(J_HEURISTICS)
    assert {m.value: v for m, v in scheduler.MODE_SEVERITY.items()} \
        == {m.value: v for m, v in j_scheduler.MODE_SEVERITY.items()}
    for make in ("mesc", "non_preemptive", "limited", "amc"):
        assert dataclasses.asdict(getattr(scheduler.Policy, make)()) \
            == dataclasses.asdict(getattr(j_scheduler.Policy, make)())
    assert scheduler.Policy.limited().name == "lp"
    with pytest.raises(ValueError):
        serving.MultiLaneServer(None, None, heuristic="best_fit")


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("policy", ["mesc", "np"])
def test_batch_drive_on_the_cpu(policy, lanes):
    """launch/serve.py's batch drive: every request finishes, and under
    MESC the HI requests run at the step after they arrive."""
    from repro_torch.launch import serve as tserve
    cfg, params, rc = tserve.load_model(ARCH, "cpu")
    pol = scheduler.Policy.mesc() if policy == "mesc" \
        else scheduler.Policy.non_preemptive()
    reqs = tserve.make_requests(cfg, np.random.default_rng(0))
    order = []
    got = tserve.run(cfg, params, pol, reqs, lanes=lanes, rc=rc,
                     order=order)
    assert sorted(got) == [r.rid for r in reqs]
    assert all(r.done and len(r.generated) == r.max_new_tokens
               for r in got.values())
    first = order[order.index("hi") + 1]
    first = set(first) if isinstance(first, list) else {first}
    his = {r.rid for r in reqs if r.crit == task.Crit.HI}
    if policy == "mesc":
        assert (his if lanes > 1 else {min(his)}) <= first
    else:
        assert not his & first            # HI waits behind running LO
    summary = tserve.summarize(policy, got)
    assert set(summary) == {"HI", "LO"}


@pytest.mark.parametrize("lanes,slots", [(1, 1), (2, 1), (2, 3)])
def test_resident_slots_size_every_lane(lanes, slots):
    """Both drives give each lane ``resident_slots`` resident cache slots,
    with one lane and with several."""
    from repro_torch.launch import serve as tserve
    cfg, params, rc = tserve.load_model(ARCH, "cpu")
    srv = tserve._server(cfg, params, scheduler.Policy.mesc(), lanes,
                         "crit_aware", rc, 32, slots)
    assert srv.arena.total_slots == lanes * slots
    assert srv.arena.quotas == [slots] * lanes


def test_preemptible_gemm_on_the_cpu():
    from repro_torch.launch import preemptible_gemm
    out = preemptible_gemm.run("cpu", M=96, K=256, N=64, bk=32, split=3)
    assert out["nk"] == 8 and out["acc_bytes"] == 96 * 64 * 4
    assert out["max_abs_err"] < 1e-3 and out["hi_max_abs_err"] < 1e-4


@pytest.mark.parametrize("argv", [
    ["--arrivals", "poisson", "--virtual"],
    ["--arrivals", "heavy_tail", "--virtual", "--lanes", "2"],
], ids=["poisson", "heavy_tail-lanes2"])
def test_open_loop_cli_prints_the_reference_lines(argv, monkeypatch, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jserve.main()
    want = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    tserve.main()
    got = capsys.readouterr().out
    assert got == want
    assert "mesc" in got and "np/mesc" in got


@pytest.mark.parametrize("policy,slots", [("mesc", 2), ("mesc", 1),
                                          ("np", 2)])
def test_open_loop_real_drive_on_the_cpu(policy, slots):
    """run_traffic_real serves a CRN workload in wall-clock time: every
    request finishes, the front door conserves requests, and each
    request's tokens equal the reference server's on that request's own
    prompt served alone, with the same parameters."""
    from repro_torch.launch import serve as tserve
    from repro_torch.serving import Poisson, build_workload
    sides = _sides()
    t = sides["torch"]
    pol = scheduler.Policy.mesc() if policy == "mesc" \
        else scheduler.Policy.non_preemptive()
    wl = build_workload(seed=0, lo_process=Poisson(40.0),
                        hi_process=Poisson(20.0), n_lo=4, n_hi=2,
                        lo_tokens=8, hi_tokens=3)
    got = tserve.run_traffic_real(t.cfg, t.params, pol, wl, rc=CPU_RC,
                                  resident_slots=slots)
    assert sorted(got) == [s.rid for s in wl]
    assert all(r.done and len(r.generated) == r.max_new_tokens
               for r in got.values())
    j = sides["jax"]
    ref = j.serving.MESCServer(j.cfg, j.params,
                               policy=j.Policy.non_preemptive(), max_len=64)
    for rid, r in sorted(got.items()):
        ref.submit(j.serving.Request(rid=rid, priority=0, prompt=r.prompt,
                                     max_new_tokens=r.max_new_tokens,
                                     crit=j.Crit.LO))
        ref.run()
        assert r.generated == ref.requests[rid].generated, rid
