"""CPU tests of the benchmark: the generator, the metric arithmetic on
synthetic spans, the lookup of every cell by name, the import check, the
plain reference against the program at a tiny size, and runs of the
harness whose timed path is broken underneath.

    PYTHONPATH=src:. python -m pytest -q bench
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import pytest
import torch

from bench import check, flops, generator, harness, reference, spec, tiny
from bench.harness import Run
from bench.run import banned_modules
from bench.trace import HOST_GAP, Slice, reduce_events

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (0, 1, 7, 2**31 + 11, 2**33 + 5, 123456789012)


# -- the generator --------------------------------------------------------

@pytest.mark.parametrize("traffic", ["longdoc4k", "longdoc8k",
                                     "longdoc8k_evict"])
@pytest.mark.parametrize("seed", SEEDS)
def test_generator_offers_the_same_work_for_any_seed(traffic, seed):
    cell = next(w for w in BENCH["workloads"] if w["traffic"] == traffic)
    t = spec.resolve(cell["name"]).traffic
    work = generator.Workload(t, seed, BENCH["run_seconds"], 64000)
    period = t["hi"]["period_s"]
    assert len(work.hi) == 102
    for rel in work.hi:
        assert rel.k * period <= rel.t < (rel.k + 1) * period
        assert rel.prompt.shape == (t["hi"]["prompt_tokens"],)
        assert rel.prompt.dtype == np.int32
    assert work.lo_prompt(5).shape == (t["lo"]["prompt_tokens"],)
    assert all(p.max() < 64000 for p in work.warm_prompts())


def test_generator_seed_moves_only_phase_jitter_and_ids():
    t = spec.resolve(CELLS[0]).traffic
    a = generator.Workload(t, 5, 51, 64000)
    b = generator.Workload(t, 5, 51, 64000)
    c = generator.Workload(t, 6, 51, 64000)
    assert [r.t for r in a.hi] == [r.t for r in b.hi]
    assert np.array_equal(a.lo_prompt(3), b.lo_prompt(3))
    assert [r.t for r in a.hi] != [r.t for r in c.hi]
    assert not np.array_equal(a.lo_prompt(3), c.lo_prompt(3))
    assert len(a.hi) == len(c.hi)


# -- the benchmark's definition -------------------------------------------

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    c = spec.resolve(cell)
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        if m in c.per_layer:
            assert m["moves"] in names


def test_benchmark_file_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(_NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert c["file"].startswith("bench/")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", ["llava34b", "dsv2lite"])
def test_config_file_layout_is_the_programs_tree(name):
    conf = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json")
                      .read_text())
    got = [(e["path"], e["shape"], e["dtype"]) for e in conf["params"]]
    want = [(e["path"], e["shape"], e["dtype"])
            for e in tiny.program_layout(conf["program"])]
    assert sorted(got) == sorted(want)
    prog = conf["program"]
    assert prog["n_layers"] == conf["num_hidden_layers"]
    assert prog["d_model"] == conf["hidden_size"]
    assert prog["n_heads"] == conf["num_attention_heads"]
    assert prog["vocab"] == conf["vocab_size"]


# -- the import check -----------------------------------------------------

def test_import_check_compares_whole_top_level_names():
    mods = ["jax.numpy", "jaxlib", "flax.linen", "repro.core.serving",
            "numpy", "torch"]
    assert banned_modules(mods) == ["flax", "jax", "jaxlib", "repro"]
    assert banned_modules(["repro_torch", "repro_torch.models.lm",
                           "jax_like", "reprox"]) == []


# -- the metric arithmetic on synthetic spans -----------------------------

def _run(requests=(), spans=(), trace=None, conf=None, clean_s=10.0):
    conf = conf or json.loads((spec.BENCH_DIR / "configs" / "llava34b.json")
                              .read_text())
    return Run(conf=conf, traffic=spec.resolve(CELLS[0]).traffic,
               seconds=10.0, setup_s=3.5, device_kind="NVIDIA H100 80GB HBM3",
               clean_s=clean_s, requests=list(requests), spans=list(spans),
               trace=trace)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_hi_latency_p90_is_the_nearest_rank_with_unfinished_unbounded():
    reqs = [dict(rid=k, crit="HI", due=0.1 * k, done=True,
                 finished=0.1 * k + 0.001 * (k + 1)) for k in range(20)]
    # ceil(0.9 * 20) = 18th smallest latency: 18 ms
    assert _read("hi_latency_p90_ms", _run(reqs)) == pytest.approx(18.0)
    reqs[0].update(done=False, finished=None)
    reqs[1].update(done=False, finished=None)
    reqs[2].update(done=False, finished=None)
    assert _read("hi_latency_p90_ms", _run(reqs)) is None
    # due after the close: not counted; 17 left, the 16th smallest
    late = dict(rid=99, crit="HI", due=10.5, done=True, finished=10.6)
    assert _read("hi_latency_p90_ms", _run(reqs[3:] + [late])) == \
        pytest.approx(19.0)


def test_lo_prompt_rate_counts_the_share_inside_the_window():
    reqs = [dict(rid=1, crit="LO", done=True, finished=4.0),
            dict(rid=2, crit="LO", done=True, finished=11.0),
            dict(rid=3, crit="LO", done=False, finished=None)]
    spans = [dict(kind="prefill", crit="LO", rid=1, tokens=1000, t0=0.0,
                  t1=0.5),
             dict(kind="prefill", crit="LO", rid=2, tokens=1000, t0=9.0,
                  t1=9.5),
             dict(kind="prefill", crit="HI", rid=0, tokens=128, t0=1.0,
                  t1=1.1),
             dict(kind="prefill", crit="LO", rid=3, tokens=1000, t0=8.0,
                  t1=8.5)]
    # all of the first document, half of the second (served from 9 s to
    # 11 s, the window ends at 10), none of the unfinished third
    assert _read("lo_prompt_tokens_per_s", _run(reqs, spans)) == \
        pytest.approx(150.0)


def test_span_metrics():
    spans = [dict(kind="save", bytes=2e9, t0=1.0, t1=2.0),
             dict(kind="save", bytes=1e9, t0=3.0, t1=3.5),
             dict(kind="restore", bytes=3e9, t0=4.0, t1=4.5),
             dict(kind="decode", rid=0, pos=100, t0=1.0, t1=1.05),
             dict(kind="decode", rid=0, pos=101, t0=2.0, t1=2.07),
             dict(kind="decode", rid=0, pos=102, t0=11.0, t1=11.5),
             dict(kind="prefill", crit="LO", rid=5, tokens=2000, t0=5.0,
                  t1=5.3, moe_s=0.2),
             dict(kind="prefill", crit="HI", rid=0, tokens=128, t0=0.4,
                  t1=0.45)]
    reqs = [dict(rid=0, crit="HI", due=0.1, done=True, finished=0.5)]
    run = _run(reqs, spans)
    assert _read("save_gbps", run) == pytest.approx(2.0)
    assert _read("restore_gbps", run) == pytest.approx(6.0)
    assert _read("decode_step_ms", run) == pytest.approx(60.0)
    assert _read("lo_prefill_ms_per_ktok", run) == pytest.approx(150.0)
    assert _read("moe_ms_per_ktok", run) == pytest.approx(100.0)
    assert _read("hi_wait_p90_ms", run) == pytest.approx(300.0)
    assert _read("save_gbps", _run()) is None
    assert _read("moe_ms_per_ktok", _run(reqs, spans[:6])) is None


def test_mfu_counts_the_calls_in_the_window():
    c = _run().conf
    spans = [dict(kind="prefill", crit="LO", rid=1, tokens=512, t0=1.0,
                  t1=2.0),
             dict(kind="decode", rid=1, pos=512, t0=2.0, t1=2.1),
             dict(kind="decode", rid=1, pos=513, t0=9.9, t1=10.1)]
    want = (flops.prefill_flops(c, 512) + flops.decode_flops(c, 512)
            + 0.5 * flops.decode_flops(c, 513))
    got = _read("mfu", _run(spans=spans))
    assert got == pytest.approx(100 * want / (10.0 * 989e12))


def test_flops_of_a_dense_prefill_from_its_shapes():
    c = _run().conf
    d, f, L = 7168, 20480, 60
    per_tok = 2 * L * (d * 7168 + 2 * d * 1024 + 7168 * d + 3 * d * f)
    attn = 2 * L * 56 * (4 * 5 / 2) * 256
    assert flops.prefill_flops(c, 4) == pytest.approx(
        4 * per_tok + attn + 2 * d * 64064)
    assert flops.attention_flops(c, 1, 4) == pytest.approx(
        2 * L * 56 * 4 * 256)


def test_flash_roofline_from_the_timed_calls():
    spans = [dict(kind="prefill", crit="LO", rid=1, tokens=3584, t0=1.0,
                  t1=1.5, flash_s=0.003),
             dict(kind="prefill", crit="HI", rid=0, tokens=128, t0=2.0,
                  t1=2.1, flash_s=0.001),
             dict(kind="prefill", crit="LO", rid=2, tokens=3584, t0=4.0,
                  t1=4.5, flash_s=0.001)]
    run = _run(spans=spans)
    c = run.conf
    bound = max(flops.attention_flops(c, 3584, 3584) / 989e12,
                flops.attention_bytes(c, 3584) / 3.35e12)
    assert _read("flash_roofline", run) == pytest.approx(
        100 * 2 * bound / 0.004)
    # the second LO prefill lies in the profiled slice: left out
    assert _read("flash_roofline", _run(spans=spans, clean_s=3.0)) == \
        pytest.approx(100 * bound / 0.003)
    assert _read("flash_roofline", _run()) is None


def test_span_metrics_skip_the_profiled_slice():
    spans = [dict(kind="decode", rid=0, pos=100, t0=1.0, t1=1.05),
             dict(kind="decode", rid=0, pos=101, t0=6.0, t1=6.5)]
    reqs = [dict(rid=0, crit="HI", due=0.1, done=True, finished=1.1),
            dict(rid=1, crit="HI", due=6.1, done=True, finished=9.0)]
    spans.append(dict(kind="prefill", crit="HI", rid=0, tokens=128, t0=0.6,
                      t1=0.7))
    run = _run(reqs, spans, clean_s=5.0)
    assert _read("decode_step_ms", run) == pytest.approx(50.0)
    assert _read("hi_wait_p90_ms", run) == pytest.approx(500.0)
    c = run.conf
    want = flops.decode_flops(c, 100) + flops.prefill_flops(c, 128)
    assert _read("mfu", run) == pytest.approx(100 * want / (5.0 * 989e12))


def test_idle_share_from_a_synthetic_slice():
    sl = Slice(window_s=0.05, busy_s=0.009)
    assert _read("device_idle_share", _run(trace=sl)) == pytest.approx(82.0)
    assert _read("device_idle_share", _run()) is None


class _Ev:
    def __init__(self, name, dev, s, d, annot=False):
        self._n, self._dev, self._s, self._d, self._a = name, dev, s, d, annot

    def name(self):
        return self._n

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_trace_reduction_busy_and_idle_gaps():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [_Ev("k1", cuda, 100, 50), _Ev("k2", cuda, 120, 60),
           _Ev("k1", cuda, 400, 100), _Ev("cudaLaunchKernel", cpu, 250, 30),
           _Ev("annotation", cuda, 90, 500, annot=True),
           _Ev("k3", cuda, 1200, 10)]
    sl = reduce_events(evs, 0, 1000)
    assert sl.busy_s == pytest.approx(180e-9)
    assert sl.window_s == pytest.approx(1e-6)
    assert dict((n, v) for n, v in sl.device_ops)["k1"] == \
        pytest.approx(150e-9)
    gaps = dict((n, v) for n, v in sl.idle_gaps)
    assert gaps["cudaLaunchKernel"] == pytest.approx(30e-9)
    assert gaps[HOST_GAP] == pytest.approx(790e-9)


# -- the plain reference against the program ------------------------------

def _program_logits(conf, params, prompt, fed):
    from repro_torch.models import lm
    cfg = harness.arch_config(conf["program"])
    rc = harness.runtime_config(conf["serve"])
    _, cache = lm.prefill(cfg, params, {"tokens": torch.tensor([prompt])}, rc,
                          max_len=len(fed) + 1)
    out = []
    for t in fed[len(prompt):]:
        logits, cache = lm.decode_step(cfg, params, torch.tensor([t]), cache,
                                       rc)
        out.append(logits[0])
    return torch.stack(out)


@pytest.mark.parametrize("name", ["llava34b", "dsv2lite"])
def test_reference_matches_the_program_at_a_tiny_size(name):
    conf = tiny.tiny_config(name)
    params = harness.weights.make_params(conf["params"], 3, "cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, conf["vocab_size"], 40).tolist()
    gen = rng.integers(0, conf["vocab_size"], 4).tolist()
    fed = reference.fed_tokens(prompt, gen)
    want = _program_logits(conf, params, prompt, fed)
    got = reference.logits_at(conf, params, torch.tensor([fed]),
                              len(prompt))[0]
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


def test_reference_capacity_drops_late_prompt_choices():
    conf = tiny.tiny_config("dsv2lite")
    assert reference.moe_capacity(40, 2, 8, 1.25) == 16
    conf["moe_capacity_factor"] = 0.05        # capacity 4: most dropped
    params = harness.weights.make_params(conf["params"], 3, "cpu")
    toks = torch.arange(41)[None] % conf["vocab_size"]
    low = reference.logits_at(conf, params, toks, 40)
    conf["moe_capacity_factor"] = None
    free = reference.logits_at(conf, params, toks, 40)
    assert not torch.allclose(low, free)


def test_control_reads_a_wider_gap_than_the_program():
    conf = tiny.tiny_config("llava34b")
    params = harness.weights.make_params(conf["params"], 4, "cpu")
    rng = np.random.default_rng(1)
    reqs = []
    for _ in range(6):
        prompt = rng.integers(0, conf["vocab_size"], 24)
        fed = reference.fed_tokens(prompt, [0, 0, 0])
        logits = reference.logits_at(conf, params, torch.tensor([fed[:-2]]),
                                     24)[0]
        reqs.append(dict(crit="LO", prompt=prompt, saves=0,
                         generated=[int(logits[0].argmax())]))
    out = check.compare(conf, params, reqs, control=True)
    assert out["gap"] == 0.0
    assert out["control_gap"] > conf["check"]["max_logit_gap"]
    out.update(lo_docs=6, hi_requests=1)
    assert check.judge(conf, out, 0)[0]
    assert not check.judge_control(conf, out)


# -- whole runs at a tiny size on the CPU ---------------------------------

def _tiny_run(name, evict=False, seed=2**32 + 9):
    cell = tiny.tiny_cell(name, evict)
    run, numbers, attempted, failed, _ = harness.run_cell(
        cell, seed, 3.0 if evict else 1.5, False, "cpu", 0.0)
    correct, checks = check.judge(cell.config, numbers, failed)
    return run, numbers, correct, checks


@pytest.mark.parametrize("name,evict", [("llava34b", False),
                                        ("dsv2lite", False),
                                        ("dsv2lite", True)])
def test_a_sound_tiny_run_is_correct(name, evict):
    run, numbers, correct, checks = _tiny_run(name, evict)
    assert correct, checks
    assert numbers["lo_docs"] >= 1 and numbers["hi_requests"] == 4
    assert list(checks) == ["logit_gap", "hi_unfinished"]
    if evict:
        assert numbers["saved_docs"] > 0
        assert any(s["kind"] == "save" for s in run.spans)
    else:
        assert not any(s["kind"] == "save" for s in run.spans)


def _state_unchanged(decode):
    def step(cfg, params, tokens, cache, rc):
        copy = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in cache.items()}
        logits, _ = decode(cfg, params, tokens, copy, rc)
        return logits, cache
    return step


def _token_altered(decode):
    def step(cfg, params, tokens, cache, rc):
        logits, cache = decode(cfg, params, tokens, cache, rc)
        best = logits.argmax(-1, keepdim=True)
        return logits.scatter(-1, best, -1e9), cache
    return step


@pytest.mark.parametrize("fault", [_state_unchanged, _token_altered])
@pytest.mark.parametrize("name", ["llava34b", "dsv2lite"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, name):
    from repro_torch.models import lm
    monkeypatch.setattr(lm, "decode_step", fault(lm.decode_step))
    _, numbers, correct, checks = _tiny_run(name)
    assert not correct
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


def test_the_run_needs_a_card():
    from bench.run import main
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2


@pytest.mark.cuda
def test_control_fails_and_sound_runs_pass_at_the_cells_size():
    """On the card: the fp8 control at the cell's own size reads above
    each configuration's limit, a sound run at or below it (short
    windows, three seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import time
    for cell_name in CELLS:
        cell = spec.resolve(cell_name)
        limit = cell.config["check"]["max_logit_gap"]
        for seed in (11, 12, 13):
            _, numbers, _, failed, _ = harness.run_cell(
                cell, seed, 30.0, False, "cuda", time.monotonic(),
                control=True)
            assert failed == 0
            assert numbers["gap"] <= limit < numbers["control_gap"]
            assert math.isfinite(numbers["control_gap"])
            assert check.judge(cell.config, numbers, failed)[0]
            assert not check.judge_control(cell.config, numbers)
