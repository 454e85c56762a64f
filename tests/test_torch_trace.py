"""The port's tracer (``runtime/trace.py``): what it costs off, what it
keeps on, and the spans and counters the serving lane leaves on the CPU.

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import scheduler, serving
from repro_torch.core.task import Crit
from repro_torch.launch import serve as tserve
from repro_torch.models import lm
from repro_torch.models.common import CPU_RC
from repro_torch.runtime import trace


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


class _Counted:
    """A stand-in for a clock or ``torch.cuda.Event`` that counts calls."""

    def __init__(self, fn=None):
        self.n, self.fn = 0, fn

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw) if self.fn else None


_PARAMS = {}


def _model():
    if not _PARAMS:
        cfg = get_config("tinyllama-1.1b-smoke")
        gen = torch.Generator().manual_seed(0)
        _PARAMS["m"] = (cfg, lm.init_params(cfg, gen, CPU_RC, device="cpu"))
    return _PARAMS["m"]


def _req(cfg, rid, crit, prio, n):
    rng = np.random.default_rng(rid)
    return serving.Request(rid=rid, priority=prio,
                           prompt=rng.integers(0, cfg.vocab, 8,
                                               dtype=np.int32),
                           max_new_tokens=n, crit=crit)


def _hi_during_lo(slots=1):
    """A LO request started on a one-slot lane, then a HI arrival: the
    LO context is saved, HI runs, LO is restored.  Returns (server,
    steps that ran a request)."""
    cfg, params = _model()
    srv = serving.MESCServer(cfg, params, policy=scheduler.Policy.mesc(),
                             max_len=32, resident_slots=slots)
    srv.submit(_req(cfg, 0, Crit.LO, 10, 8))
    ran = [srv.step() for _ in range(3)]
    srv.submit(_req(cfg, 1, Crit.HI, 0, 3))
    while True:
        rid = srv.step()
        if rid is None:
            break
        ran.append(rid)
    return srv, ran


def test_off_reads_no_clock_makes_no_event_and_keeps_nothing(monkeypatch):
    perf = _Counted(time.perf_counter_ns)
    wall = _Counted(time.time_ns)
    event = _Counted()
    monkeypatch.setattr(trace.time, "perf_counter_ns", perf)
    monkeypatch.setattr(trace.time, "time_ns", wall)
    monkeypatch.setattr(torch.cuda, "Event", event)
    assert not trace.ON
    srv, ran = _hi_during_lo()
    assert sum(r.saves for r in srv.requests.values()) >= 1
    with trace.span("model.decode_step", pos=3) as sp:
        trace.count("serve.saves")
    assert sp is None
    assert (perf.n, wall.n, event.n) == (0, 0, 0)
    assert trace._spans == [] and trace._stack == []
    assert dict(trace._counters) == {}
    assert trace.drain() == ([], {})


def test_nesting_parents_and_self_time(monkeypatch):
    trace.enable(device_events=False)
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(ticks))
    # a: 0..70, b: 10..40 (c: 20..30 inside), d: 50..60
    with trace.span("a", rid=7):
        with trace.span("b", tokens=4) as b:
            with trace.span("c"):
                pass
            b.attrs["extra"] = 1
        with trace.span("d"):
            pass
    with trace.span("e"):
        pass
    trace.count("k", 3)
    trace.count("k")
    spans, counters = trace.drain()
    off = trace._offset_ns
    assert [s["name"] for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s["parent"] for s in spans] == [-1, 0, 1, 0, -1]
    assert [(s["t0_ns"] - off, s["t1_ns"] - off) for s in spans] == \
        [(0, 70), (10, 40), (20, 30), (50, 60), (80, 90)]
    assert spans[0]["rid"] == 7 and spans[1]["attrs"] == dict(tokens=4,
                                                              extra=1)
    assert all(s["device_s"] is None for s in spans)
    assert trace.self_ns(spans) == [70 - 30 - 10, 30 - 10, 10, 10, 10]
    rows = trace.summary(spans)
    assert list(rows) == ["a", "b", "c", "d", "e"]
    assert rows["a"]["self_ms"] == pytest.approx(30e-6)
    assert rows["b"]["host_ms"] == pytest.approx(30e-6)
    assert counters["k"] == 4
    assert "kernel.launch.decode_attention" in counters
    # the sites' counters are reported from 0
    assert {k: counters[k] for k in trace.COUNTERS} == dict.fromkeys(
        trace.COUNTERS, 0)
    assert trace.drain()[0] == []


def test_drain_refuses_an_open_span_and_the_cap_drops(monkeypatch):
    trace.enable(device_events=False)
    with trace.span("open"):
        with pytest.raises(RuntimeError, match="open"):
            trace.drain()
    trace.drain()
    monkeypatch.setattr(trace, "MAX_SPANS", 2)
    with trace.span("a"):
        with trace.span("b"):
            with trace.span("c"):
                pass
    with trace.span("d"):
        pass
    spans, counters = trace.drain()
    assert [s["name"] for s in spans] == ["a", "b"]
    assert [s["parent"] for s in spans] == [-1, 0]
    assert counters["trace.dropped"] == 2
    # a full tracer leaves the lane's sites working
    monkeypatch.setattr(trace, "MAX_SPANS", 0)
    srv, ran = _hi_during_lo()
    spans, counters = trace.drain()
    assert spans == [] and counters["trace.dropped"] > len(ran)


def test_epoch_anchor_lies_within_a_millisecond_of_time_ns():
    trace.enable(device_events=False)
    stamps = []
    for _ in range(5):
        before = time.time_ns()
        with trace.span("s"):
            pass
        stamps.append((before, time.time_ns()))
    for s, (before, after) in zip(trace.drain()[0], stamps):
        assert before - 1_000_000 < s["t0_ns"] <= s["t1_ns"] \
            < after + 1_000_000


def test_a_traced_cpu_lane_leaves_one_span_per_call():
    trace.enable(device_events=False)
    srv, ran = _hi_during_lo()
    spans, counters = trace.drain()
    by = {}
    for i, s in enumerate(spans):
        by.setdefault(s["name"], []).append(i)
    reqs = srv.requests.values()
    saves = sum(r.saves for r in reqs)
    assert saves >= 1
    # one prefill a request, one decode and one read-back a step
    assert sorted(spans[i]["rid"] for i in by["serve.prefill"]) == [0, 1]
    assert len(by["serve.decode"]) == len(by["serve.readback"]) == len(ran)
    assert [spans[i]["rid"] for i in by["serve.decode"]] == ran
    assert len(by["model.decode_step"]) == len(ran)
    assert len(by["model.prefill"]) == 2
    assert len(by["serve.save"]) == len(by["serve.restore"]) == saves
    assert counters["serve.saves"] == counters["serve.restores"] == saves
    assert counters["serve.save_bytes"] == sum(
        spans[i]["attrs"]["bytes"] for i in by["serve.save"]) > 0
    assert counters["serve.restore_bytes"] == counters["serve.save_bytes"]
    assert counters["serve.preemptions"] == sum(r.preemptions for r in reqs)
    # the call-site spans are children of serve.step; the model's of them
    step = set(by["serve.step"])
    for name in ("serve.prefill", "serve.decode", "serve.readback",
                 "serve.save", "serve.restore"):
        assert all(spans[i]["parent"] in step for i in by[name]), name
    for name, parent in (("model.decode_step", "serve.decode"),
                         ("model.prefill", "serve.prefill"),
                         ("kernel.flash_attention", "model.prefill")):
        assert all(spans[spans[i]["parent"]]["name"] == parent
                   for i in by[name]), name
    # the idle calls (None) are steps too, and carry no rid
    assert [spans[i]["rid"] for i in by["serve.step"]
            if spans[i]["rid"] is not None] == ran
    assert all(spans[i]["attrs"]["lane"] == 0 for i in by["serve.step"])
    assert min(trace.self_ns(spans)) >= 0


def test_traced_and_untraced_lanes_serve_the_same_tokens():
    srv, ran = _hi_during_lo()
    trace.enable(device_events=False)
    srv2, ran2 = _hi_during_lo()
    trace.disable()
    assert ran == ran2
    for rid, r in srv.requests.items():
        r2 = srv2.requests[rid]
        assert (r.generated, r.saves, r.preemptions) == \
            (r2.generated, r2.saves, r2.preemptions)


def test_the_cli_prints_spans_on_stderr_only(monkeypatch, capsys):
    argv = ["serve", "--arrivals", "poisson", "--virtual"]
    monkeypatch.setattr("sys.argv", argv)
    tserve.main()
    plain = capsys.readouterr()
    monkeypatch.setattr("sys.argv", argv + ["--spans"])
    tserve.main()
    spanned = capsys.readouterr()
    assert spanned.out == plain.out and plain.err == ""
    lines = spanned.err.splitlines()
    assert lines[0].split() == ["span", "count", "host_ms", "mean_ms",
                                "self_ms", "device_ms"]
    names = [ln.split()[0] for ln in lines[1:-1]]
    assert {"serve.pump", "serve.step", "serve.prefill", "serve.decode",
            "serve.readback"} <= set(names)
    assert lines[-1].startswith("counters: ")
    assert not trace.ON
