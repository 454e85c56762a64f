"""The port's traffic layer and SLO summary against the reference's, bit
for bit: CRN draws, every arrival process (trace through a save/load
round trip), workload synthesis, the factory's validation, and the SLO
row over the same request sets."""
import dataclasses
import json
import types

import numpy as np
import pytest

from repro.core.task import Crit as JCrit
from repro.serving import slo as j_slo
from repro.serving import traffic as j_traffic
from repro_torch.core.task import Crit as TCrit
from repro_torch.serving import slo as t_slo
from repro_torch.serving import traffic as t_traffic


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("stream", ["lo_arrivals", "svc_decode", 7])
@pytest.mark.parametrize("sub", [0, 1, 3])
def test_crn_draws_bit_equal(stream, sub):
    for seed in (0, 1, 2**40 + 3):
        idx = np.arange(513)
        _same(t_traffic.crn_bits(seed, stream, idx, sub),
              j_traffic.crn_bits(seed, stream, idx, sub))
        _same(t_traffic.crn_u01(seed, stream, idx, sub),
              j_traffic.crn_u01(seed, stream, idx, sub))
        _same(t_traffic.crn_u01(seed, stream, 5, sub),
              j_traffic.crn_u01(seed, stream, 5, sub))
    assert t_traffic.stream_key(stream) == j_traffic.stream_key(stream)


def _processes(kind, pkg, tmp_path):
    if kind == "trace":
        times = t_traffic.Poisson(3.0).arrival_times(4, "lo_arrivals", 40)
        path = t_traffic.save_trace(times, tmp_path / "trace.json")
        return pkg.load_trace(path)
    return pkg.make_process(kind, 2.5)


@pytest.mark.parametrize("kind", t_traffic.PROCESS_KINDS)
def test_arrival_times_bit_equal(kind, tmp_path):
    assert t_traffic.PROCESS_KINDS == j_traffic.PROCESS_KINDS
    tp = _processes(kind, t_traffic, tmp_path)
    jp = _processes(kind, j_traffic, tmp_path)
    for seed, stream in ((0, "lo_arrivals"), (3, "hi_arrivals")):
        got = t_traffic.arrival_times(tp, seed, stream, 40)
        _same(got, j_traffic.arrival_times(jp, seed, stream, 40))
        _same(tp.inter_arrivals(seed, stream, 40),
              jp.inter_arrivals(seed, stream, 40))
    if kind == "trace":
        # the reference's writer and the port's reader agree too
        back = j_traffic.save_trace(got, tmp_path / "ref.json")
        assert t_traffic.load_trace(back).times == tuple(got.tolist())


@pytest.mark.parametrize("lo_kind", ["poisson", "heavy_tail", "diurnal"])
def test_build_workload_equal_field_by_field(lo_kind):
    kw = dict(seed=5, n_lo=30, n_hi=9, lo_tokens=48, hi_tokens=6,
              hi_lo_budget_s=0.2)
    got = t_traffic.build_workload(
        lo_process=t_traffic.make_process(lo_kind, 4.0),
        hi_process=t_traffic.make_process("poisson", 0.5), **kw)
    want = j_traffic.build_workload(
        lo_process=j_traffic.make_process(lo_kind, 4.0),
        hi_process=j_traffic.make_process("poisson", 0.5), **kw)
    assert len(got) == len(want) == 39

    def rows(ws):
        return [{**dataclasses.asdict(s), "crit": s.crit.value} for s in ws]
    assert json.dumps(rows(got)) == json.dumps(rows(want))
    assert t_traffic.workload_stats(got) == j_traffic.workload_stats(want)


@pytest.mark.parametrize("call", [
    lambda m: m.make_process("bogus", 1.0),
    lambda m: m.make_process("trace", 1.0),
    lambda m: m.make_process("poisson", 0.0),
    lambda m: m.make_process("heavy_tail", 1.0, alpha=1.0),
    lambda m: m.make_process("diurnal", 1.0, amplitude=1.0),
    lambda m: m.make_process("diurnal", 1.0, period_s=0.0),
    lambda m: m.Trace(times=(0.5, 0.2)),
    lambda m: m.Trace(times=(0.1,)).arrival_times(0, "s", 2),
], ids=["kind", "trace-path", "rate", "alpha", "amplitude", "period",
        "descending", "short"])
def test_make_process_validation_equal(call):
    with pytest.raises(Exception) as te:
        call(t_traffic)
    with pytest.raises(Exception) as je:
        call(j_traffic)
    assert te.type is je.type is ValueError
    assert str(te.value) == str(je.value)


def test_load_trace_rejects_another_version(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": 99, "times": [0.1]}))
    with pytest.raises(ValueError, match="version 99"):
        t_traffic.load_trace(path)


@pytest.mark.parametrize("q", [0.5, 0.99, 0.999, 1.0, 0.01])
def test_nearest_rank_equal(q):
    xs = list(np.random.default_rng(0).random(37))
    assert t_slo.nearest_rank(xs, q) == j_slo.nearest_rank(xs, q)
    assert t_slo.nearest_rank([], q) is None
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            t_slo.nearest_rank(xs, bad)


def _requests(seed, crit_cls):
    """A seeded request set: some unfinished, some without a first
    token, both classes."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(int(rng.integers(0, 25))):
        sub = float(rng.random() * 10)
        done = bool(rng.random() < 0.85)
        first = sub + float(rng.random()) if rng.random() < 0.95 else None
        fin = (first or sub) + float(rng.random() * 2) if done else None
        out.append(types.SimpleNamespace(
            rid=rid, crit=crit_cls.HI if rng.random() < 0.3 else crit_cls.LO,
            done=done, submitted_at=sub, first_token_at=first,
            finished_at=fin, preemptions=int(rng.integers(0, 3)),
            saves=int(rng.integers(0, 2)),
            generated=[0] * int(rng.integers(1, 9))))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("deadlines", [(None, None), (0.5, None),
                                       (0.5, 1.5)])
def test_slo_summary_equal(seed, deadlines):
    hi, lo = deadlines
    got = t_slo.slo_summary(_requests(seed, TCrit), hi_deadline_s=hi,
                            lo_deadline_s=lo)
    want = j_slo.slo_summary(_requests(seed, JCrit), hi_deadline_s=hi,
                             lo_deadline_s=lo)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
