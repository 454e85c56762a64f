"""The port's NumPy vec engine (``simulate_vbatch(...,
select_backend="numpy")``) against the JAX package's vec engine and the
port's own event engine, bit for bit, on the smoke, mixed and scenario
corpora; the port's lockstep engine (``device="cpu"``) against the vec
engine on the nominal smoke corpus, where the reference promises
equality; and the host backend's argument checks."""
import dataclasses

import numpy as np
import pytest

import chip_smoke
from repro.core.simulator_vec import simulate_vbatch as j_simulate_vbatch
from test_torch_simulator import (DURATION, J_LIB, LIB, POLICIES,
                                  assert_runs_equal, corpus, full_rows,
                                  policy_of, run_event)

from repro_torch.core import simulator_jit, simulator_vec
from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator_vec import simulate_vbatch
from repro_torch.experiments.metrics import metrics_row


def run_vec(name, policy, ref, **kw):
    ts, seeds = corpus(name, ref)
    fn = j_simulate_vbatch if ref else simulate_vbatch
    return fn(ts, J_LIB if ref else LIB, policy_of(policy, ref), seeds=seeds,
              duration=DURATION, **kw)


CASES = ([("smoke", "mesc", dict(demand_profile=p))
          for p in ("sampled", "nominal")]
         + [("mixed", p, {}) for p in POLICIES]
         + [("smoke", "mesc", dict(scenario="faults@0.7"))])


@pytest.mark.parametrize("name,policy,kw", CASES,
                         ids=[f"{n}-{p}-{'-'.join(map(str, k.values()))}"
                              for n, p, k in CASES])
def test_vec_rows_equal_the_reference_and_the_event_engine(name, policy, kw):
    got = run_vec(name, policy, False, **kw)
    assert_runs_equal(got, run_vec(name, policy, True, **kw), (name, policy))
    assert full_rows(got) == full_rows(run_event(name, policy, False, **kw))


def test_vec_rows_do_not_depend_on_the_batch():
    """Lockstep width and compaction change no row: batch sizes that
    split the corpus unevenly give the full batch's rows."""
    ts, seeds = corpus("smoke")
    whole = simulate_vbatch(ts, LIB, Policy.mesc(), seeds=seeds,
                            duration=DURATION)
    for bs in (5, 13):
        part = simulate_vbatch(ts, LIB, Policy.mesc(), seeds=seeds,
                               duration=DURATION, batch_size=bs)
        assert full_rows(part) == full_rows(whole)
    # a point alone gives its row in the batch
    one = simulate_vbatch(ts[7:8], LIB, Policy.mesc(), seeds=seeds[7:8],
                          duration=DURATION)
    assert full_rows(one) == full_rows(whole[7:8])


def test_nominal_jit_rows_equal_the_vec_rows_and_the_pin():
    ts, seeds = corpus("smoke")
    vec = simulate_vbatch(ts, LIB, Policy.mesc(), seeds=seeds,
                          duration=DURATION, demand_profile="nominal")
    jit = simulate_vbatch(ts, LIB, Policy.mesc(), seeds=seeds,
                          duration=DURATION, demand_profile="nominal",
                          select_backend="jit", device="cpu")
    assert [metrics_row(m) for m in jit] == [metrics_row(m) for m in vec]
    # the digest hashes a sample list as its sum and count, so the vec
    # rows meet the pin that holds the jit engine's rows
    assert simulator_jit.metrics_digest(vec) == \
        chip_smoke.SIM_PINS["smoke/nominal"]
    assert simulator_jit.metrics_digest(jit) == \
        chip_smoke.SIM_PINS["smoke/nominal"]


def test_the_lockstep_engine_reads_construction_only():
    """``_VecBatch.__init__`` builds only what the lockstep engine reads;
    the NumPy state comes with ``run`` and leaves the phases as drawn."""
    ts, seeds = corpus("mixed")
    b = simulator_vec._VecBatch(ts, LIB, Policy.mesc(), seeds=seeds,
                                duration=DURATION, overrun_prob=0.3, cf=2.0)
    assert not hasattr(b, "status") and not hasattr(b, "rands")
    phases = b.next_release.copy()
    b._init_state()
    assert np.array_equal(b.next_release, phases)
    assert np.array_equal(b.rel_min, phases.min(axis=1))
    assert b.status.shape == (len(ts), b.T)


def test_host_backend_argument_checks():
    ts, seeds = corpus("mixed")
    kw = dict(seeds=seeds, duration=1e6)
    with pytest.raises(ValueError, match="devices=2"):
        simulate_vbatch(ts, LIB, Policy.mesc(), devices=2, **kw)
    with pytest.raises(ValueError, match="device="):
        simulate_vbatch(ts, LIB, Policy.mesc(), device="cpu", **kw)
    with pytest.raises(ValueError, match="select_backend"):
        simulate_vbatch(ts, LIB, Policy.mesc(), select_backend="cuda", **kw)
    with pytest.raises(ValueError, match="demand_profile"):
        simulate_vbatch(ts, LIB, Policy.mesc(), demand_profile="flat", **kw)
    with pytest.raises(ValueError, match="seeds"):
        simulate_vbatch(ts, LIB, Policy.mesc(), seeds=seeds[:-1],
                        duration=1e6)
    assert len(simulate_vbatch(ts, LIB, Policy.mesc(), devices=1, **kw)) \
        == len(ts)
    assert dataclasses.is_dataclass(
        simulate_vbatch(ts, LIB, Policy.mesc(), **kw)[0])
