#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and then, failing on the first phase that goes wrong:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, the kernels' build time and ``ptxas`` register/spill lines,
   and for each flash, decode, GEMM and RG-LRU scan kernel whether its
   SASS holds tensor-core instructions (``HMMA``, ``HGMMA``), TMA loads
   (``UTMALDG``) and cp.async copies (``LDGSTS``); the bf16 flash kernel
   must hold HMMA, every bf16 GEMM entry HGMMA and its TMA entries
   UTMALDG, every scan entry LDGSTS, and no redesigned kernel (bf16 flash,
   decode, both GEMMs, the scan) may spill;
2. holds every kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at the sweep shapes of tests/test_kernels.py,
   in fp32 and bf16: the GEMM, decode and flash kernels at TinyLlama's
   shapes, the RG-LRU scan (bit for bit, every instantiation of its plan
   on both copy routes), flash with a 2048 window at dh 256 and decode
   at dh 256 / G 10 on a 2048-slot ring at recurrentgemma-2b's; flash at
   DeepSeek-V2-Lite's MLA prefill shapes (16 heads, q/k head dim 192
   against v 128, and the smoke config's 24/16; bf16 and fp32; a 512-token
   and a ragged 300-token prompt; every operand a view inside a NaN
   frame); flash and decode at LLaVA-NeXT-34B's GQA 56/8 at dh 128 (G 7:
   decode head groups of 4 + 3) and MusicGen-large's MHA 32/32 at dh 64
   (G 1), fp32 and bf16, every operand inside a NaN frame; the bf16 flash
   kernel at every (dqk, dv) pair it instantiates, and both flash kernels
   there with ``q_offset``, ``softcap`` and a window after an offset
   (keys past Skv NaN in their buffer); decode at the edges of
   its split plan's chunks, each call made twice and required to repeat
   bit for bit, and one decode call profiled to be one kernel launch;
3. checks full-width TinyLlama-1.1B, and recurrentgemma-2b cut to 5
   layers (one (rglru, rglru, attn) group and the 2-layer tail) with a
   512-token prompt, in fp32, teacher-forced, on the card (kernels)
   against the CPU (plain versions); then, with 64-token prompts,
   DeepSeek-V2-Lite cut to 2 layers and one Llama-4-Maverick group at
   full width with each expert's hidden width cut to 512, each MoE call
   required to choose the same experts on both sides before the logits
   are compared; then xlstm-125m whole with a 512-token (chunkwise mLSTM)
   and an 8-token (parallel) prompt, llava-next-34b cut to 2 layers with
   64 patch embeddings before 64 text tokens, and musicgen-large cut to 4
   layers with a 64-token, 4-codebook prompt;
4. serves full-width TinyLlama-1.1B and full-width recurrentgemma-2b in
   bf16 through the port's MESC server (the batch drive of
   ``repro_torch.launch.serve``), checking the step order against the
   CPU port, that HI requests run at the step after they arrive, and the
   kernel launches per decode step / prefill against the layer pattern;
   for recurrentgemma-2b a run with one resident slot evicts a LO
   request's cache to the host and restores it, and its tokens must
   equal an uninterrupted run's; the save and restore of one request's
   context are timed, and a decode step of each model is profiled; then
   full-width, full-depth DeepSeek-V2-Lite (MLA + MoE, 16.2 B parameters,
   made a 2-D slice at a time, its peak card memory recorded) under
   MESC and non-preemptive serving and MESC at 512-token prompts (flash
   27 times a prefill, no decode-attention launch: MLA's decode has no
   kernel), its context move and decode step profiled, and one
   full-width Llama-4-Maverick group (attn + dense, attn + 128-expert
   MoE; 18.5 B parameters) under MESC and non-preemptive serving; then
   full-width, full-depth xlstm-125m under MESC and non-preemptive
   serving with one resident slot (every saved request's tokens equal a
   solo replay; no kernel launch), llava-next-34b (60 layers, 34.4 B
   parameters, its peak card memory recorded) under MESC and
   non-preemptive serving and one request of 576 patch embeddings and 448
   text tokens through prefill and 8 decode steps, and musicgen-large (48
   layers) through a 512-token, 4-codebook prefill and 16 greedy decode
   steps (not served: its tokens are (B, S, K)); each with its context
   move and a decode step profiled;
5. runs the preemptible GEMM (``repro_torch.launch.preemptible_gemm``);
6. times each kernel at its main path's shapes against its plain version,
   one PyTorch library call (where one computes the same function) and
   its bound on the card (flash and decode also at LLaVA-NeXT-34B's and
   MusicGen-large's shapes; flash on the second 512-token chunk of a
   1024-token TinyLlama prompt, plainly and with a score cap of 50), and
   the scan plan's alternatives (channels x
   steps x stages) at the hybrid's 512-token prefill;
7. (run after 5, before 6) open-loop serving: (a) the 16 points of the
   reference's fig12 smoke grid through ``repro_torch.serving.fig12``,
   twice, byte-identical rows, the reference's gate on the pooled
   saturated poisson cells (host arithmetic on the virtual clock, no
   device); (b) full-width TinyLlama-1.1B in bf16 on one lane serving
   24 LO + 8 HI Poisson arrivals in wall-clock time through
   ``repro_torch.launch.serve.run_traffic_real`` under MESC and
   non-preemptive serving, the LO rate 1.2 x the lane's measured
   capacity: every request finishes, the launches match the layer
   pattern, MESC saves contexts, every HI and every saved request's
   tokens equal a solo replay of its own prompt, and MESC's HI p99 TTFT
   lies below non-preemptive serving's; each policy's SLO row is printed
   as a line of its own;
8. (run after 7, before 6) the lockstep simulation engine,
   ``repro_torch.core.simulator_jit.simulate_jbatch``, in CUDA graphs:
   the smoke corpus (sampled and nominal), the mixed corpus under mesc,
   np, lp and amc-instruction and the smoke corpus under ``faults@0.7``,
   each row set equal to its pinned digest of the JAX package's rows
   (the smoke corpus's also to the port's own CPU rows); then
   benchmarks/perf_sim.py's 512-point FULL corpus (duration 2e8) twice,
   equal to its pin, with steps, graph replays, host syncs, retried
   points, wall time and points/s on a ``{"lockstep": ...}`` line per
   run; one graph replay is profiled (kernels and card time per step,
   idle share, eager steps, the step's bytes bound);
9. (run after 8, before 6) campaigns and the three engines: (a) the
   FULL corpus through the port's event engine (``simulate``) and NumPy
   vec engine (``simulate_vbatch(..., select_backend="numpy")``) on the
   host, one process each: vec rows equal the event rows, which equal a
   pin of the reference's; the nominal smoke corpus's vec rows equal the
   jit pin; one ``{"engines": ...}`` line gives each engine's points/s
   and wall time on that corpus (jit: phase 8's second run) with the
   host's CPU count and the card's name and power limit; (b) fig8's
   sweep recipe (4 policies x 6 utilisations x 8 sets, duration 2e7) as
   a ``repro_torch.experiments.Campaign`` on jit (its chunks in this
   process, on the card), event and vec, each in a fresh cache
   directory: every point a miss, the rows equal a pin of the reference
   ``Campaign``'s rows for that engine, a second run all hits with the
   same rows; (c) fig11's multi-accelerator ``FuncSweep`` at 2 sets, the
   same way;
10. (run after 9, before 6) training: (a) ``lm.loss_fn`` and
   ``torch.autograd.grad`` of every parameter on the card against the
   CPU, fp32 with TF32 off, for each family's smoke config (xlstm also
   through its chunkwise mLSTM) and full-width tinyllama-1.1b cut to 2
   layers (B 1, S 128), which is run again with TF32 on as a control
   that must exceed the bound; (b) each kernel wrapper refuses CUDA inputs that
   require grad, and a ``make_train_step`` call launches no kernel; (c)
   full-width, full-depth TinyLlama-1.1B trains 8 steps of 8 x 512
   tokens from ``batch_for_arch`` through ``make_train_step`` in bf16 on
   fp32 master weights with bf16 moments: finite losses and grad norms,
   every leaf changed and still fp32; median step time, tokens/s, peak
   card memory and the model's arithmetic as a share of 989 TFLOP/s;
   (d) the trained weights, cast to their serving placement, through
   ``make_prefill_step`` (22 flash launches, a 512-token prompt,
   ``max_len`` 1024) and 8 teacher-forced ``make_decode_step`` steps (22
   decode launches each) against ``lm.forward``'s logits at the same
   positions, and above the bound against its logits at the next position
   (the control); (e) ``repro_torch.launch.train`` on tinyllama-1.1b cut
   to 2 layers: 4 steps saving every 2, then a second process resumes
   from step 2: the state the first held at step 2, the arrays on disk
   and the state the second restored on the card have one sha256, and
   the resumed losses equal the uninterrupted run's.  One
   ``{"train": ...}`` line holds (c), (d) and (e) with the card's name
   and power limit;
11. (run after 10, before 6) sharding: (a) the FULL corpus through
   ``simulate_jbatch`` at 1, 2 and 4 shards (each its own runner, graph
   and CUDA stream on the card), twice each: every run's rows equal the
   pin, points/s from the second run on a ``{"lockstep_devices": ...}``
   line; ``lockstep_kernel_count`` equals phase 8's profiled kernel
   launches a step; (b) the dry run (``repro_torch.launch.dryrun``) of
   tinyllama-1.1b at train_4k, prefill_32k and decode_32k, of
   deepseek-v2-lite-16b and recurrentgemma-2b at prefill_32k and of
   qwen1.5-110b at decode_32k on a fake 16x16 mesh, on the host, one
   ``{"dryrun": ...}``
   line each with the host's CPU count; (c) full-width tinyllama-1.1b at
   prefill_32k (global batch 2) and decode_32k (global batch 16, the
   cache at position 32767): the step plainly, then on DTensors under
   ``axis_rules`` on a 1-rank (1, 1) CUDA mesh, bit-equal logits and
   caches and 22 kernel launches, then the port's dry run of the cell on
   a 1-rank mesh: its argument bytes equal the real tensors', its peak
   within 0.8-1.25 of the card's ``max_memory_allocated``; one
   ``{"sharded_cell": ...}`` line each; (d) one train step of full-width
   tinyllama-1.1b at train_4k's 4096 tokens a sequence (global batch 2;
   the dry run's train RuntimeConfig, optimizer and 2d mode,
   sequence-parallel) plainly, then on DTensors under ``axis_rules`` on
   the 1-rank mesh, from the same parameters, optimizer state and batch:
   the loss, every updated leaf and moment bit-equal, no kernel launched
   by either; one ``{"sharded_train": ...}`` line with both steps'
   seconds and peak card memory; (e) the sharded steps of the gloo tests
   on the host, under this machine's torch: prefill and 4 decode steps of
   three smoke configs and one AdamW step of seven train cases, each on
   four gloo ranks of a (2, 2) mesh with the sequence-parallel residual
   against the plain port (logits within 1e-5; the train cases within
   tests/test_torch_sharded_train.py's tolerances), as many cases side by
   side as the host's CPUs hold; one ``{"gloo_torch": ...}`` line with
   the torch version and each case's largest error.

The line before the last is the card's name and power limit; the last is
``{"ok": true, "device": {...}}``.  Everything printed is also written to
``results/chip_smoke.json``.  It exits non-zero without a result when
CUDA is absent or the port's sources are not beside it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12            # outside the tensor cores
PEAK_BYTES = 3.35e12

RECORD: dict = {}
T0 = time.perf_counter()


def log(msg: str = "") -> None:
    """Prints ``msg``; a phase's heading ("phase ...") with the seconds
    since the script started, where the script's time limit is spent."""
    if msg.startswith("phase "):
        msg += f"  [{time.perf_counter() - T0:.0f} s]"
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(what, got, want, atol, rtol=0.0):
    err = max_err(got, want)
    bound = atol + rtol * float(want.float().abs().max())
    ok = bool(torch.isfinite(got.float()).all()) and err <= bound
    log(f"  {what}: max|err| {err:.3e} (tol {bound:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: max|err| {err} > {bound}")
    return err


def cuda_time_ms(fn, reps: int = 30, per_graph: int = 10) -> float:
    """Device time of one call: ``per_graph`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events, the
    median replay over ``per_graph``.  Replaying a graph leaves out the
    host's launch overhead, which a host-timed call would include."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):                       # warm-up outside capture
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per_graph)
    return statistics.median(times)


def host_call_ms(fn, reps: int = 30) -> float:
    """Wall time of one call on the host clock, synchronised: what a
    caller of the wrapper waits, launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# 1. what the attention and GEMM kernels compiled to
# ---------------------------------------------------------------------------

KERNELS = ("flash_mma_kernel", "flash_kernel", "decode_kernel",
           "gemm_wgmma_kernel", "gemm_f32_kernel", "rglru_kernel")
# the redesigned ones, which must not spill
NO_SPILL = ("flash_mma_kernel", "decode_kernel", "gemm_wgmma_kernel",
            "gemm_f32_kernel", "rglru_kernel")
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG", "LDGSTS")


def _short(mangled: str) -> str:
    """``decode_kernel<bf16,64>`` or ``gemm_wgmma_kernel<192,true,f32>``
    from a mangled entry name."""
    m = re.search(r"(%s)I(.*?)EEv" % "|".join(KERNELS), mangled)
    if not m:
        return mangled
    args = []
    for t in re.finditer(r"Li(\d+)E|Lb([01])E|13__nv_bfloat16|f",
                         m.group(2)):
        if t.group(1):
            args.append(t.group(1))
        elif t.group(2) is not None:
            args.append("true" if t.group(2) == "1" else "false")
        else:
            args.append("bf16" if t.group(0).startswith("13") else "f32")
    return f"{m.group(1)}<{','.join(args)}>"


def kernel_report() -> list:
    """Registers and spills (``ptxas -v``) and which of HMMA, HGMMA,
    UTMALDG and LDGSTS the SASS holds (``cuobjdump -sass``), for every
    flash, decode, GEMM and scan entry.  Fails where a redesigned kernel
    spills, where the bf16 flash kernel lacks HMMA, where a bf16 GEMM entry
    lacks HGMMA (and, on its TMA route, UTMALDG), or where a scan entry
    lacks LDGSTS (its cp.async ring)."""
    from repro_torch.kernels import _build, rglru_scan
    entries, cur = {}, None
    for ln in _build.ptxas_report().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in KERNELS) \
                else None
            if cur:
                entries[cur] = {"name": _short(cur)}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            entries[cur]["spill_stores"] = int(m.group(1))
            entries[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            entries[cur]["registers"] = int(m.group(1))
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    fn = None
    ops = {}
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            ops.setdefault(fn, set())
        elif fn:
            ops[fn].update(op for op in SASS_OPS
                           if re.search(r"\b%s\b" % op, ln))
    rows = []
    for mangled, e in sorted(entries.items(), key=lambda kv: kv[1]["name"]):
        for op in SASS_OPS:
            e[op.lower()] = op in ops.get(mangled, ())
        log(f"  {e['name']}: {e.get('registers')} registers, spill "
            f"{e.get('spill_stores')}/{e.get('spill_loads')} bytes "
            f"(stores/loads), in SASS: "
            f"{[op for op in SASS_OPS if e[op.lower()]]}")
        rows.append(e)
    for e in rows:
        if any(e["name"].startswith(k) for k in NO_SPILL):
            assert e.get("spill_stores") == 0 and e.get("spill_loads") == 0, e
        if e["name"].startswith("flash_mma_kernel"):
            assert e["hmma"], e
        if e["name"].startswith("gemm_wgmma_kernel"):
            assert e["hgmma"], e
            if e["name"].split(",")[1] == "true":       # the TMA route
                assert e["utmaldg"], e
        if e["name"].startswith("rglru_kernel"):
            assert e["ldgsts"], e
    count = {k: sum(e["name"].startswith(k + "<") for e in rows)
             for k in KERNELS}
    scan_entries = 2 * len(rglru_scan.CHANNELS) * len(rglru_scan.STEPS) \
        * len(rglru_scan.STAGES)                       # x the two routes
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    # each flash pair twice: uncapped and capped (softcap > 0)
    assert count["flash_mma_kernel"] == 2 * len(HEAD_DIMS) \
        and count["flash_kernel"] == 2 * len(HEAD_DIMS) \
        and count["decode_kernel"] == 10 \
        and count["gemm_wgmma_kernel"] == 8 \
        and count["gemm_f32_kernel"] == 8 \
        and count["rglru_kernel"] == scan_entries, count
    return rows


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

# bf16 tolerance: both sides round the same bf16 inputs, accumulate in fp32
# and round p and the output to bf16; a last-bit difference in an fp32 sum
# can flip a bf16 rounding, one bf16 ulp is 2^-8 relative (0.0078 at 1.0),
# so outputs of size ~1-3 are held to 2e-2.
ATTN_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# where outputs are not held to that size (phase_flash_options): one bf16
# ulp is at most 2^-7 of the value it rounds, so a flipped rounding of the
# largest output stays within ATTN_TOL + ATTN_RTOL * max|output|
ATTN_RTOL = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}


def randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def phase_kernels(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_tpu
    from repro_torch.kernels.flash_attention import flash_attention_tpu
    from repro_torch.kernels.systolic_gemm import gemm_partial, systolic_gemm
    gen = torch.Generator(device=dev).manual_seed(7)
    log("phase 2: kernels against their plain versions")

    phase_gemm_kernels(dev, gen)

    # decode: main path (model layout, transposed cache view) and sweep
    for dt in (torch.float32, torch.bfloat16):
        q = randn((1, 32, 64), gen, dt)
        kc = randn((1, 1024, 4, 64), gen, dt).transpose(1, 2)
        vc = randn((1, 1024, 4, 64), gen, dt).transpose(1, 2)
        for pos in (0, 17, 511, 1023):
            check_close(f"decode B1 Hq32 Hkv4 dh64 S1024 pos {pos} {dt}",
                        decode_attention_tpu(q, kc, vc, pos),
                        ref.decode_attention_ref(q, kc, vc, pos),
                        ATTN_TOL[dt])
    for (B, Hq, Hkv, S, dh) in [(2, 8, 2, 256, 64), (1, 4, 4, 512, 32)]:
        q = randn((B, Hq, dh), gen)
        kc, vc = randn((B, Hkv, S, dh), gen), randn((B, Hkv, S, dh), gen)
        for pos in (0, 17, 255):
            check_close(f"decode sweep {B},{Hq},{Hkv},{S},{dh} pos {pos}",
                        decode_attention_tpu(q, kc, vc, pos, block_s=64),
                        ref.decode_attention_ref(q, kc, vc, pos), 5e-5)

    # prefill: main path (model layout views) and sweep
    for dt in (torch.float32, torch.bfloat16):
        for S in (8, 512):
            q = randn((1, S, 32, 64), gen, dt).transpose(1, 2)
            k = randn((1, S, 4, 64), gen, dt).transpose(1, 2)
            v = randn((1, S, 4, 64), gen, dt).transpose(1, 2)
            check_close(f"flash B1 Hq32 Hkv4 dh64 S{S} {dt}",
                        flash_attention_tpu(q, k, v),
                        ref.flash_attention_ref(q, k, v), ATTN_TOL[dt])
    for (B, Hq, Hkv, S, dh, bq, bkv) in [(1, 4, 4, 128, 64, 64, 64),
                                         (2, 8, 2, 256, 64, 64, 128),
                                         (1, 8, 1, 128, 128, 32, 32)]:
        q = randn((B, Hq, S, dh), gen)
        k, v = randn((B, Hkv, S, dh), gen), randn((B, Hkv, S, dh), gen)
        for causal in (True, False):
            check_close(f"flash sweep {B},{Hq},{Hkv},{S},{dh} causal={causal}",
                        flash_attention_tpu(q, k, v, causal=causal,
                                            block_q=bq, block_kv=bkv),
                        ref.flash_attention_ref(q, k, v, causal=causal), 5e-5)
    phase_hybrid_kernels(dev, gen)
    phase_mla_kernels(dev, gen)
    phase_family_kernels(dev, gen)
    phase_attention_edges(dev, gen)
    torch.cuda.synchronize()


def _poisoned(a, b, k0, k1, bk):
    """Copies of A and B whose columns / rows outside the K slice
    [k0*bk, k1*bk) are NaN: a kernel that reads past its slice returns
    NaN."""
    a, b = a.clone(), b.clone()
    a[:, :k0 * bk] = float("nan")
    a[:, k1 * bk:] = float("nan")
    b[:k0 * bk] = float("nan")
    b[k1 * bk:] = float("nan")
    return a, b


def _routes_of(fn):
    """(result, {route: launches}) of one call of ``fn``."""
    from repro_torch.kernels import _build
    before = dict(_build.GEMM_ROUTES)
    out = fn()
    return out, {k: v - before[k] for k, v in _build.GEMM_ROUTES.items()
                 if v != before[k]}


def phase_gemm_kernels(dev, gen):
    """The checkpointable GEMM against its plain version: the preempt /
    resume chains (fp32 and TinyLlama-width bf16), the sweep shapes, ragged
    shapes in both dtypes on both bf16 routes, a random non-zero seed, K
    slices whose neighbours are NaN, every call twice and bit-identical,
    and the route each bf16 call took."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.systolic_gemm import gemm_partial, systolic_gemm
    bf = torch.bfloat16

    # preempt/resume chain, tests/test_kernels.py tolerances
    M = K = N = 512
    a, b = randn((M, K), gen), randn((K, N), gen)
    full = ref.gemm_ref(a, b)
    for split in (1, 2, 3):
        acc = torch.zeros((M, N), device=dev)
        acc = gemm_partial(a, b, acc, 0, split, bk=128)
        saved = acc.cpu()
        acc = gemm_partial(a, b, saved.to(dev), split, 4, bk=128)
        check_close(f"gemm_partial chain split {split}/4 fp32", acc, full,
                    1e-2, 1e-4)
    for (M, K, N, bm, bn, bk) in [(128, 128, 128, 128, 128, 128),
                                  (256, 512, 128, 128, 128, 128),
                                  (512, 256, 384, 128, 128, 128),
                                  (128, 1024, 256, 64, 128, 256),
                                  (200, 100, 72, 200, 72, 100),
                                  (192, 320, 136, 192, 136, 320)]:
        for dt, tol in ((torch.float32, 1e-3), (bf, 2e-2)):
            a, b = randn((M, K), gen, dt), randn((K, N), gen, dt)
            out, routes = _routes_of(
                lambda: systolic_gemm(a, b, bm=bm, bn=bn, bk=bk))
            again = systolic_gemm(a, b, bm=bm, bn=bn, bk=bk)
            assert out.dtype == dt and torch.equal(out, again), (M, K, N, dt)
            # bf16 (200, 100, 72): a 200-byte row of A, which TMA cannot take
            want = {torch.float32: "ffma", bf: "async" if (M, K, N) == (
                200, 100, 72) else "tma"}[dt]
            assert routes == {want: 1}, (M, K, N, dt, routes)
            check_close(f"systolic_gemm {M}x{K}x{N} {dt} ({want}, twice, "
                        "bit-identical)", out, ref.gemm_ref(a, b),
                        tol * K ** 0.5, tol)
    # TinyLlama width: activations (512, d_model) @ W1 (d_model, d_ff), bf16,
    # preempted at 3 of 8 K-blocks.  bf16 products are exact in fp32; only
    # the fp32 summation order differs, so the fp32 chain's tolerance holds.
    # Each call sees NaN outside its K slice, so it must read only its slice.
    a = randn((512, 2048), gen, bf)
    w = randn((2048, 5632), gen, bf)
    acc = torch.zeros((512, 5632), device=dev)
    for k0, k1 in ((0, 3), (3, 8)):
        ap, wp = _poisoned(a, w, k0, k1, 256)
        acc, routes = _routes_of(lambda: gemm_partial(ap, wp, acc, k0, k1,
                                                      bk=256))
        assert routes == {"tma": 1}, routes
    want = ref.gemm_partial_ref(a, w, torch.zeros((512, 5632), device=dev),
                                0, 8, 256)
    check_close("gemm_partial 512x2048x5632 bf16 split 3/8, NaN outside "
                "each slice (tma)", acc, want, 1e-2, 1e-4)
    # a random seed and NaN outside the slice, both dtypes, both bf16 routes
    # (bk 100: a slice that starts 200 bytes into a bf16 row, which TMA
    # cannot take) and fp32 4-byte copies (bk 50: 200 bytes into a row)
    for dt, (M, N, bk, nk), route in [
            (torch.float32, (512, 512, 128, 4), "ffma"),
            (torch.float32, (192, 136, 50, 4), "ffma"),
            (bf, (512, 512, 128, 4), "tma"), (bf, (192, 136, 320, 3), "tma"),
            (bf, (200, 72, 100, 4), "async")]:
        a, b = randn((M, bk * nk), gen, dt), randn((bk * nk, N), gen, dt)
        seed = randn((M, N), gen)
        ap, bp = _poisoned(a, b, 1, nk - 1, bk)
        got, routes = _routes_of(lambda: gemm_partial(ap, bp, seed, 1, nk - 1,
                                                      bk=bk))
        again = gemm_partial(ap, bp, seed, 1, nk - 1, bk=bk)
        assert routes == {route: 1} and torch.equal(got, again), \
            (dt, M, N, bk, routes)
        check_close(f"gemm_partial {M}x{bk * nk}x{N} {dt} bk {bk} K blocks "
                    f"[1,{nk - 1}), random seed, NaN outside ({route}, twice,"
                    " bit-identical)", got,
                    ref.gemm_partial_ref(a, b, seed, 1, nk - 1, bk), 1e-2, 1e-4)


def phase_hybrid_kernels(dev, gen):
    """The hybrid family's kernels at its shapes: the RG-LRU scan, flash
    with a window at dh 256, decode at dh 256 / G 10 on a window ring."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_tpu
    from repro_torch.kernels.flash_attention import flash_attention_tpu
    phase_scan_kernel(dev, gen)
    # local attention of the hybrid's prefill at a length where the window
    # really cuts the band: Hq 10 / Hkv 1, dh 256, S 2560, window 2048
    for dt in (torch.float32, torch.bfloat16):
        q = randn((1, 2560, 10, 256), gen, dt).transpose(1, 2)
        k = randn((1, 2560, 1, 256), gen, dt).transpose(1, 2)
        v = randn((1, 2560, 1, 256), gen, dt).transpose(1, 2)
        check_close(f"flash window 2048 B1 Hq10 Hkv1 dh256 S2560 {dt}",
                    flash_attention_tpu(q, k, v, window=2048),
                    ref.flash_attention_ref(q, k, v, window=2048),
                    ATTN_TOL[dt])
        check_close(f"flash causal B1 Hq10 Hkv1 dh256 S512 {dt}",
                    flash_attention_tpu(q[:, :, :512], k[:, :, :512],
                                        v[:, :, :512]),
                    ref.flash_attention_ref(q[:, :, :512], k[:, :, :512],
                                            v[:, :, :512]), ATTN_TOL[dt])
    # windowed decode: a 2048-slot ring (model layout view), G 10, dh 256,
    # part full (pos_eff < W - 1) and full (pos_eff = W - 1)
    for dt in (torch.float32, torch.bfloat16):
        q = randn((1, 10, 256), gen, dt)
        kc = randn((1, 2048, 1, 256), gen, dt).transpose(1, 2)
        vc = randn((1, 2048, 1, 256), gen, dt).transpose(1, 2)
        for pos in (0, 535, 2047):
            check_close(f"decode B1 Hq10 Hkv1 dh256 ring 2048 pos_eff {pos} "
                        f"{dt}", decode_attention_tpu(q, kc, vc, pos),
                        ref.decode_attention_ref(q, kc, vc, pos),
                        ATTN_TOL[dt])


def _nan_framed(shape, gen, dtype):
    """A (B,H,S,D) view of random values for a (B,S,H,D) ``shape`` inside
    a NaN frame: one more sequence row, one more head and 8 more columns
    than the view holds (8 keeps bf16 rows 16-byte aligned), so a kernel
    that reads outside its view returns NaN."""
    B, S, H, D = shape
    buf = torch.full((B, S + 1, H + 1, D + 8), float("nan"), dtype=dtype,
                     device=gen.device)
    view = buf[:, :S, :H, :D]
    view.copy_(randn(shape, gen, dtype))
    return view.transpose(1, 2)


def phase_mla_kernels(dev, gen):
    """Flash at DeepSeek-V2-Lite's MLA prefill shapes against its plain
    version: 16 heads, dqk 192 (128 nope + 64 rope) against dv 128 in
    bf16 (the serving path) and fp32 (the parity path), and the smoke
    config's 24/16, causal, at the 512-token prompt and a ragged 300,
    every operand a view inside a NaN frame."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_tpu
    for (dqk, dv), dt in [((192, 128), torch.bfloat16),
                          ((192, 128), torch.float32),
                          ((24, 16), torch.float32),
                          ((24, 16), torch.bfloat16)]:
        for S in (512, 300):
            q = _nan_framed((1, S, 16, dqk), gen, dt)
            k = _nan_framed((1, S, 16, dqk), gen, dt)
            v = _nan_framed((1, S, 16, dv), gen, dt)
            out = flash_attention_tpu(q, k, v)
            assert out.shape == (1, 16, S, dv), out.shape
            check_close(f"flash MLA dqk {dqk} dv {dv} q 1x16x{S} {dt} "
                        "(NaN frame)", out, ref.flash_attention_ref(q, k, v),
                        ATTN_TOL[dt])


# (name, Hq, Hkv, dh, S): the head layouts of the vlm and audio families'
# prefills and decode caches (LLaVA-NeXT-34B's GQA group of 7, MusicGen's
# MHA at dh 64); decode runs on a 1024-slot cache
FAMILY_SHAPES = (("llava-next-34b", 56, 8, 128, 1024),
                 ("musicgen-large", 32, 32, 64, 512))


def phase_family_kernels(dev, gen):
    """Flash and decode at LLaVA-NeXT-34B's and MusicGen-large's head
    layouts against their plain versions, fp32 and bf16, every operand a
    view inside a NaN frame: causal flash at the prefill lengths (1024 and
    512); decode at G 7 (two head groups, 4 + 3) and G 1 at 0, the split
    plan's first chunk edge, 535 and 1023, each call twice and
    bit-identical."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention_tpu,
                                                      split_plan)
    from repro_torch.kernels.flash_attention import flash_attention_tpu
    for name, Hq, Hkv, dh, S in FAMILY_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            q = _nan_framed((1, S, Hq, dh), gen, dt)
            k = _nan_framed((1, S, Hkv, dh), gen, dt)
            v = _nan_framed((1, S, Hkv, dh), gen, dt)
            out = flash_attention_tpu(q, k, v)
            assert out.shape == (1, Hq, S, dh), out.shape
            check_close(f"flash {name} q 1x{Hq}x{S}x{dh} kv 1x{Hkv}x{S}x{dh}"
                        f" {dt} causal (NaN frame)", out,
                        ref.flash_attention_ref(q, k, v), ATTN_TOL[dt])
            qd = _nan_framed((1, 1, Hq, dh), gen, dt)[:, :, 0]
            kc = _nan_framed((1, 1024, Hkv, dh), gen, dt)
            vc = _nan_framed((1, 1024, Hkv, dh), gen, dt)
            chunk, _ = split_plan(1, Hkv, 1024, Hq // Hkv, dh,
                                  itemsize=qd.element_size())
            for pos in sorted({0, chunk - 1, chunk, 535, 1023}):
                got = decode_attention_tpu(qd, kc, vc, pos)
                assert torch.equal(got, decode_attention_tpu(qd, kc, vc,
                                                             pos)), pos
                check_close(f"decode {name} q 1x{Hq}x{dh} cache "
                            f"1x{Hkv}x1024x{dh} G {Hq // Hkv} pos {pos} {dt} "
                            "(NaN frame, twice, bit-identical)", got,
                            ref.decode_attention_ref(qd, kc, vc, pos),
                            ATTN_TOL[dt])


def phase_scan_kernel(dev, gen):
    """The RG-LRU scan bit for bit (max error 0) against its plain version:
    the test_rglru_kernel_sweep shapes, recurrentgemma-2b's 512- and
    8-token prefills, batch 2 at one step, ragged D (100, and 37 on the
    4-byte route); each call twice and bit-identical; at the 512-token
    prefill and the ragged shapes every instantiation of the plan (channels
    x steps x stages) on both copy routes (16-byte ones where D % 4 == 0).
    The kernel rounds a*h and +b as the plain version does (no FMA) and
    walks S in order, so nothing less than equality is right."""
    from repro_torch.kernels import ref, rglru_scan
    from repro_torch.kernels.rglru_scan import (launch_plan, rglru_scan_tpu,
                                                scan_plan)
    every = list(itertools.product(rglru_scan.CHANNELS, rglru_scan.STEPS,
                                   rglru_scan.STAGES, ("cp16", "cp4")))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for (B, S, D) in [(2, 128, 256), (1, 64, 512), (1, 512, 2560),
                      (1, 8, 2560), (2, 1, 2560), (1, 37, 100), (1, 33, 37)]:
        a = torch.rand((B, S, D), generator=gen, device=dev) * 0.599 + 0.4
        b, h0 = randn((B, S, D), gen), randn((B, D), gen)
        want = ref.rglru_scan_ref(a, b, h0)
        plan = scan_plan(B, S, D, a_ptr=a.data_ptr(), b_ptr=b.data_ptr(),
                         n_sm=n_sm)
        out = rglru_scan_tpu(a, b, h0)
        assert torch.equal(out, rglru_scan_tpu(a, b, h0)), (B, S, D)
        check_close(f"rglru_scan B{B} S{S} D{D} (C {plan.channels}, T "
                    f"{plan.steps}, {plan.stages} stages, {plan.route}, "
                    f"{plan.blocks} blocks; twice, bit-identical)", out,
                    want, 0.0)
        if (S, D) not in ((512, 2560), (37, 100), (33, 37)):
            continue
        for c, t, st, route in every:
            if route == "cp16" and plan.route == "cp4":
                continue
            alt = dataclasses.replace(plan, channels=c, steps=t, stages=st,
                                      route=route)
            got = launch_plan(a, b, h0, alt)
            assert torch.equal(got, want), (alt, max_err(got, want))
        log(f"  rglru_scan B{B} S{S} D{D}: every instantiation on "
            f"{'both routes' if plan.route == 'cp16' else 'the cp4 route'}"
            " bit-equal")


# (q_offset, softcap, window) of phase_flash_options: a later chunk of a
# prompt, a cap that bites (q scaled by 4: scaled scores of std ~4 against
# a cap of 5), both, and a window across the chunk's start
FLASH_OPTIONS = ((156, None, 0), (0, 5.0, 0), (156, 5.0, 0), (156, None, 64))


def phase_flash_options(gen, dqk, dv, dtype):
    """Flash at one (dqk, dv) pair with the reference's ``q_offset`` and
    ``softcap`` and a window after an offset (``FLASH_OPTIONS``): a
    ragged 100-query chunk, GQA 8/2, against Skv = q_offset + 100 keys
    whose buffer holds NaN rows past Skv (a kernel that reads a key past
    Skv returns NaN), held to the plain version within ``ATTN_TOL`` plus
    ``ATTN_RTOL`` of the largest output: q scaled by 4 sharpens the
    softmax, whose outputs then reach the values' extremes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_tpu
    S = 100
    for off, cap, window in FLASH_OPTIONS:
        Skv = off + S
        q = (4 * randn((1, S, 8, dqk), gen)).to(dtype).transpose(1, 2)
        kv = []
        for d in (dqk, dv):
            buf = torch.full((1, Skv + 16, 2, d), float("nan"), dtype=dtype,
                             device=gen.device)
            buf[:, :Skv] = randn((1, Skv, 2, d), gen, dtype)
            kv.append(buf[:, :Skv].transpose(1, 2))
        out = flash_attention_tpu(q, *kv, q_offset=off, softcap=cap,
                                  window=window, block_q=S, block_kv=Skv)
        assert bool(torch.isfinite(out).all()), (dqk, dv, off, cap, window)
        check_close(f"flash {dtype} dh{dqk}/{dv} S{S} Skv{Skv} q_offset "
                    f"{off} softcap {cap} window {window} (NaN past Skv)",
                    out, ref.flash_attention_ref(
                        q, *kv, q_offset=off, softcap=cap, window=window),
                    ATTN_TOL[dtype], ATTN_RTOL[dtype])


def phase_attention_edges(dev, gen):
    """The bf16 tensor-core flash kernel at every (dqk, dv) pair it
    instantiates, and both flash kernels there with ``q_offset``,
    ``softcap`` and a window after an offset (``phase_flash_options``);
    decode at the edges of its split plan's chunks, every call twice and
    bit-identical (the last block reset its counter), and one call
    profiled to be one kernel launch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (HEADS_PER_BLOCK,
                                                      decode_attention_tpu,
                                                      split_plan)
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention_tpu)
    bf = torch.bfloat16
    # GQA 8/2, MQA 4/1, MHA 4/4 (batch 2); ragged S; model-layout views
    for dh, dv in HEAD_DIMS:
        for (B, Hq, Hkv) in [(1, 8, 2), (1, 4, 1), (2, 4, 4)]:
            for S in (8, 100):
                q = randn((B, S, Hq, dh), gen, bf).transpose(1, 2)
                k = randn((B, S, Hkv, dh), gen, bf).transpose(1, 2)
                v = randn((B, S, Hkv, dv), gen, bf).transpose(1, 2)
                for causal in (True, False):
                    check_close(f"flash bf16 dh{dh}/{dv} B{B} Hq{Hq} Hkv{Hkv}"
                                f" S{S} causal={causal}",
                                flash_attention_tpu(q, k, v, causal=causal),
                                ref.flash_attention_ref(q, k, v,
                                                        causal=causal),
                                ATTN_TOL[bf])
        q = randn((1, 300, 4, dh), gen, bf).transpose(1, 2)
        k = randn((1, 300, 1, dh), gen, bf).transpose(1, 2)
        v = randn((1, 300, 1, dv), gen, bf).transpose(1, 2)
        check_close(f"flash bf16 dh{dh}/{dv} Hq4 Hkv1 S300 window 64",
                    flash_attention_tpu(q, k, v, window=64, block_q=300,
                                        block_kv=300),
                    ref.flash_attention_ref(q, k, v, window=64), ATTN_TOL[bf])
        for dt in (torch.float32, bf):
            phase_flash_options(gen, dh, dv, dt)
    # decode: TinyLlama, the hybrid's ring, and B 2 x Hkv 2 (more than one
    # counter) at both families' head shapes
    for (B, Hkv, G, dh, S) in [(1, 4, 8, 64, 1024), (1, 1, 10, 256, 2048),
                               (2, 2, 4, 64, 256), (2, 2, 10, 256, 1024)]:
        for dt in (torch.float32, bf):
            q = randn((B, Hkv * G, dh), gen, dt)
            kc = randn((B, S, Hkv, dh), gen, dt).transpose(1, 2)
            vc = randn((B, S, Hkv, dh), gen, dt).transpose(1, 2)
            chunk, _ = split_plan(B, Hkv, S, G, dh, itemsize=q.element_size())
            for pos in sorted({0, chunk - 1, chunk, 535, S - 1} &
                              set(range(S))):
                got = decode_attention_tpu(q, kc, vc, pos)
                again = decode_attention_tpu(q, kc, vc, pos)
                assert torch.equal(got, again), (B, Hkv, G, dh, S, pos, dt)
                check_close(f"decode B{B} Hkv{Hkv} G{G} dh{dh} S{S} pos {pos}"
                            f" {dt} (twice, bit-identical)", got,
                            ref.decode_attention_ref(q, kc, vc, pos),
                            ATTN_TOL[dt])
    chunk, n_split = split_plan(1, 1, 536, 10, 256)
    blocks = n_split * -(-10 // HEADS_PER_BLOCK)
    log(f"  decode plan, recurrentgemma-2b at ring position 535: chunk "
        f"{chunk}, {n_split} splits x {-(-10 // HEADS_PER_BLOCK)} head "
        f"groups = {blocks} blocks (fixed 64-position chunks: 9)")
    assert blocks > 9
    RECORD["hybrid_decode_blocks_pos535"] = blocks
    q = randn((1, 10, 256), gen, bf)
    kc = randn((1, 2048, 1, 256), gen, bf).transpose(1, 2)
    decode_attention_tpu(q, kc, kc, 535)
    torch.cuda.synchronize()
    # the process's first profiler session has come back from an H100
    # without a single device event: that is no count, so profile again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            decode_attention_tpu(q, kc, kc, 535)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    log(f"  one decode call launched {len(names)} kernel(s): {names}")
    assert len(names) == 1 and "decode_kernel" in names[0], names


# ---------------------------------------------------------------------------
# 3. full-width model, fp32, card against CPU
# ---------------------------------------------------------------------------

# fp32 on both sides; the card sums in other orders (cuBLAS, the kernels'
# online softmax) than the CPU, through 22 layers (tinyllama) or 5
# (recurrentgemma, 512 tokens); logits are of size ~1
LOGIT_TOL = 1e-3


def _leaves(tree, prefix=""):
    """(name, tensor) for every tensor of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + k, v


def _same_experts(what, cpu_routes, dev_routes) -> float:
    """Fail unless the card chose the CPU's experts in every MoE call
    (layer) for every token; a near-tie in fp32 that flips one choice
    moves the logits by far more than LOGIT_TOL, so this is checked
    first, and a flip is reported with its router margin.  Returns the
    smallest margin (k-th choice's probability less the best unchosen
    one) on the CPU side, or inf without MoE calls."""
    assert len(cpu_routes) == len(dev_routes), (what, len(cpu_routes),
                                                len(dev_routes))
    low = float("inf")
    for layer, (c, d) in enumerate(zip(cpu_routes, dev_routes)):
        if not torch.equal(c["experts"], d["experts"]):
            bad = (c["experts"] != d["experts"]).any(-1)
            raise AssertionError(
                f"{what}: MoE call {layer} chose other experts on the card "
                f"for {int(bad.sum())} token(s); CPU router margins there "
                f"{c['margin'][bad].tolist()}, card "
                f"{d['margin'][bad].tolist()}")
        low = min(low, float(c["margin"].min()))
    return low


def path_launches(cfg) -> tuple:
    """(flash launches a prefill, decode-attention launches a decode step,
    scan launches a prefill) of ``cfg``'s path: one flash launch per
    attention layer, one decode launch per attention layer but for MLA's
    (PyTorch operations, no kernel), one scan launch per RG-LRU layer;
    xLSTM's cells launch none of the kernels."""
    from repro_torch.configs.base import _pattern_for
    if cfg.family == "xlstm":
        return 0, 0, 0
    pattern = _pattern_for(cfg)
    n_attn = pattern.count("attn")
    return (n_attn, 0 if cfg.family == "mla_moe" else n_attn,
            pattern.count("rglru"))


def zero_tokens(cfg, *shape):
    """Zero token ids of ``shape``, with the audio family's codebook dim
    appended."""
    if cfg.family == "audio":
        shape += (cfg.n_codebooks,)
    return torch.zeros(shape, dtype=torch.long)


def model_batch(cfg, prompt_len, rng, n_vis=0):
    """A batch of one prompt of ``prompt_len`` text tokens from ``rng``:
    (1, S, K) codebook ids for the audio family, and for the vlm family
    ``n_vis`` standard normal patch embeddings before them."""
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, zero_tokens(cfg, 1, prompt_len).shape, dtype=np.int32))}
    if n_vis:
        batch["vis_embeds"] = torch.from_numpy(
            rng.standard_normal((1, n_vis, cfg.d_model)).astype(np.float32))
    return batch


def phase_model(dev, cfg, prompt_len, max_len=None, n_vis=0):
    """``cfg`` at full width in fp32, card (kernels) against CPU (plain
    versions), teacher-forced: prefill, then 6 decode steps fed the CPU's
    greedy tokens (argmax per codebook for the audio family).  A vlm
    prompt has ``n_vis`` patch embeddings before its text tokens.  In a
    MoE family every call's experts must be the same on both sides before
    the logits are compared.  Returns the largest logit error."""
    from repro_torch.kernels import _build
    from repro_torch.models import ffn, lm
    from repro_torch.models.common import CPU_RC
    tag = f"{cfg.name} prompt {prompt_len}" + (f" + {n_vis} patches"
                                                if n_vis else "")
    log(f"phase 3: full-width {cfg.name} ({cfg.n_layers} layers) fp32, card "
        f"(kernels) vs CPU (plain versions), {prompt_len}-token prompt"
        f"{f' after {n_vis} patch embeddings' if n_vis else ''}, "
        "teacher-forced")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    p_dev = lm.init_params(cfg, gen, CPU_RC, device=dev)
    p_cpu = _tree_to(p_dev, "cpu")
    batch = model_batch(cfg, prompt_len, np.random.default_rng(1), n_vis)
    with ffn.record_routes() as r_cpu:
        lc, cc = lm.prefill(cfg, p_cpu, batch, CPU_RC, max_len=max_len)
    _build.reset_launches()
    with ffn.record_routes() as r_dev:
        ld, cd = lm.prefill(cfg, p_dev, batch, CPU_RC, max_len=max_len)
    torch.cuda.synchronize()
    margins = [_same_experts("prefill", r_cpu, r_dev)]
    n_flash, _, n_scan = path_launches(cfg)
    assert _build.LAUNCHES["flash_attention"] == n_flash and \
        _build.LAUNCHES["rglru_scan"] == n_scan, _build.LAUNCHES
    assert ld.shape == lc.shape == ((1, cfg.n_codebooks, cfg.vocab)
                                    if cfg.family == "audio"
                                    else (1, cfg.vocab)), ld.shape
    errs = [check_close("prefill logits", ld.cpu(), lc, LOGIT_TOL)]
    cpu_cache = dict(_leaves(cc))
    for name, t in _leaves(cd):
        check_close(f"prefill cache {name}", t.cpu(), cpu_cache[name],
                    LOGIT_TOL)
    tok = torch.argmax(lc, dim=-1)              # (1,) or (1, K)
    for step in range(6):
        with ffn.record_routes() as r_cpu:
            lc, cc = lm.decode_step(cfg, p_cpu, tok, cc, CPU_RC)
        with ffn.record_routes() as r_dev:
            ld, cd = lm.decode_step(cfg, p_dev, tok, cd, CPU_RC)
        margins.append(_same_experts(f"decode step {step}", r_cpu, r_dev))
        errs.append(check_close(f"decode step {step} logits", ld.cpu(), lc,
                                LOGIT_TOL))
        tok = torch.argmax(lc, dim=-1)
    if cfg.moe is not None:
        RECORD.setdefault("moe_min_router_margin", {})[cfg.name] = \
            min(margins)
        log(f"  same experts on both sides in every MoE call; smallest "
            f"router margin {min(margins):.3e}")
    del p_dev, cd
    torch.cuda.empty_cache()
    RECORD.setdefault("phase3_s", {})[tag] = time.perf_counter() - t_phase
    log(f"  {tag} ({cfg.n_layers} layers): {RECORD['phase3_s'][tag]:.1f} s")
    return max(errs)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# 4. serving at full width, bf16
# ---------------------------------------------------------------------------

def _ran(order):
    """(decode steps, distinct requests) in a recorded step order."""
    rids = []
    for x in order:
        if x == "hi":
            continue
        rids += [r for r in (x if isinstance(x, list) else [x])
                 if r is not None]
    return len(rids), len(set(rids))


def phase_serving(dev, arch, runs, n_layers=None):
    """Serve full-width ``arch`` in bf16 through the port's MESC server,
    one batch-drive run per (policy, lanes, prompt, max_len, slots) in
    ``runs``; check each against the CPU port's step order and the
    kernel launches against the layer pattern (``path_launches``).
    ``n_layers`` cuts the depth.  Returns (results by run tag, cfg,
    params, rc)."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import Policy
    from repro_torch.core.task import Crit
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    log(f"phase 4: MESC serving of full-width {arch}"
        f"{'' if n_layers is None else f' cut to {n_layers} layers'}, bf16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cfg, params, rc = serve.init_model(cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves(params))
    load = {"params": n_params, "load_s": time.perf_counter() - t0,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "card": torch.cuda.get_device_name(0)}
    RECORD.setdefault("model_load", {})[cfg.name + (
        "" if n_layers is None else f"@{n_layers}L")] = load
    log(f"  {n_params / 1e9:.3f} B parameters loaded in {load['load_s']:.1f}"
        f" s; peak card memory {load['max_memory_allocated'] / 2**30:.2f} "
        "GiB")
    scfg, sparams, src = serve.load_model(arch + "-smoke", "cpu")
    n_attn, n_dec, n_rec = path_launches(cfg)
    out = {}
    for name, lanes, plen, max_len, slots in runs:
        policy = Policy.mesc() if name == "mesc" else Policy.non_preemptive()
        tag = (f"{name} lanes={lanes} prompt={plen} max_len={max_len}"
               f" slots={slots}")
        kw = dict(lanes=lanes, max_len=max_len, resident_slots=slots)
        reqs = serve.make_requests(cfg, np.random.default_rng(0),
                                   prompt_len=plen)
        order = []
        _build.reset_launches()
        t0 = time.perf_counter()
        got = serve.run(cfg, params, policy, reqs, rc=rc, order=order, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        cpu_order = []
        serve.run(scfg, sparams, policy,
                  serve.make_requests(scfg, np.random.default_rng(0),
                                      prompt_len=plen),
                  rc=src, order=cpu_order, **kw)
        assert order == cpu_order, f"{tag}: step order differs from the CPU"
        steps, prefills = _ran(order)
        assert launches["decode_attention"] == n_dec * steps, (tag, launches)
        assert launches["flash_attention"] == n_attn * prefills, \
            (tag, launches)
        assert launches["rglru_scan"] == n_rec * prefills, (tag, launches)
        his = {r.rid for r in reqs if r.crit == Crit.HI}
        first = order[order.index("hi") + 1]
        first = set(first if isinstance(first, list) else [first])
        if name == "mesc":
            want = his if lanes > 1 else {min(his)}
            assert want <= first, f"{tag}: HI waited ({first})"
        for r in got.values():
            assert r.done and len(r.generated) == r.max_new_tokens
            assert all(0 <= t < cfg.vocab for t in r.generated)
        saves = sum(r.saves for r in got.values())
        log(f" {tag}: {steps} decode steps, {prefills} prefills, "
            f"{saves} saves, {wall:.2f} s; launches {launches}; first step "
            f"after HI arrival ran {sorted(first)}")
        summary = serve.summarize(name, got)
        out[tag] = {"steps": steps, "prefills": prefills, "wall_s": wall,
                    "saves": saves, "launches": launches,
                    "ttft_latency_s": summary,
                    "tokens": {r.rid: list(r.generated)
                               for r in got.values()},
                    "saved": {r.rid: r.saves for r in got.values()
                              if r.saves}}
    return out, cfg, params, rc


def context_move_ms(cfg, params, rc, prompt_len=512, reps=5):
    """Measured save (card -> host) and restore (host -> card) of one
    request's whole decode cache after a ``prompt_len`` prefill, the
    copies ``MESCServer._evict`` / ``_restore`` make; median of ``reps``."""
    from repro_torch.core.serving import _move_cache
    from repro_torch.models import lm
    dev = params["embed"].device
    _, cache = lm.prefill(cfg, params, {"tokens": zero_tokens(
        cfg, 1, prompt_len)}, rc, max_len=1024)
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(cache))
    saves, restores = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = _move_cache(cache, "cpu")
        t1 = time.perf_counter()
        back = _move_cache(host, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        assert all(t.device.type == "cpu" for _, t in _leaves(host))
        assert all(t.device == dev for _, t in _leaves(back))
        saves.append((t1 - t0) * 1e3)
        restores.append((t2 - t1) * 1e3)
    out = {"bytes": nbytes, "save_ms": statistics.median(saves),
           "restore_ms": statistics.median(restores)}
    log(f"  context of one request ({nbytes / 2**20:.2f} MiB after a "
        f"{prompt_len}-token prefill): save {out['save_ms']:.3f} ms, "
        f"restore {out['restore_ms']:.3f} ms")
    return out


def phase_dense_serving(dev):
    runs = [("mesc", 1, 8, 64, 2), ("np", 1, 8, 64, 2), ("mesc", 2, 8, 64, 2),
            ("np", 2, 8, 64, 2), ("mesc", 1, 512, 1024, 2)]
    out, cfg, params, rc = phase_serving(dev, "tinyllama-1.1b", runs)
    RECORD["serving"] = out
    RECORD["decode_profile"] = profile_decode(cfg, params, rc)
    del params
    torch.cuda.empty_cache()
    return out["mesc lanes=1 prompt=512 max_len=1024 slots=2"]["launches"]


def phase_hybrid_serving(dev):
    """recurrentgemma-2b: MESC and non-preemptive on one lane, one MESC
    run with 512-token prompts, and one MESC run with a single resident
    slot, so that a HI arrival evicts the running LO request's cache to
    the host; its tokens must equal the non-preemptive run's, in which
    no request is ever interrupted."""
    runs = [("mesc", 1, 8, 64, 2), ("np", 1, 8, 64, 2),
            ("mesc", 1, 512, 1024, 2), ("mesc", 1, 8, 64, 1)]
    out, cfg, params, rc = phase_serving(dev, "recurrentgemma-2b", runs)
    evicting = out["mesc lanes=1 prompt=8 max_len=64 slots=1"]
    uninterrupted = out["np lanes=1 prompt=8 max_len=64 slots=2"]
    assert evicting["saves"] >= 1, evicting
    assert evicting["tokens"] == uninterrupted["tokens"], \
        "tokens after a save and restore differ from an uninterrupted run"
    log(f"  slots=1: {evicting['saves']} saves; every request's tokens "
        "equal the non-preemptive run's")
    RECORD["hybrid_serving"] = out
    RECORD["hybrid_context_move"] = context_move_ms(cfg, params, rc)
    RECORD["hybrid_decode_profile"] = profile_decode(cfg, params, rc)
    del params
    torch.cuda.empty_cache()
    return out["mesc lanes=1 prompt=512 max_len=1024 slots=2"]["launches"]


def phase_mla_serving(dev):
    """deepseek-v2-lite-16b at full width and depth (27 layers of MLA +
    64-expert MoE, 16.2 B parameters): MESC and non-preemptive on one
    lane, and MESC at 512-token prompts; flash runs 27 times a prefill,
    decode attention never (MLA's decode is PyTorch operations).  Then
    the card is freed for the next model."""
    runs = [("mesc", 1, 8, 64, 2), ("np", 1, 8, 64, 2),
            ("mesc", 1, 512, 1024, 2)]
    out, cfg, params, rc = phase_serving(dev, "deepseek-v2-lite-16b", runs)
    for tag, r in out.items():
        log(f"  {tag}: TTFT / latency {r['ttft_latency_s']}")
    RECORD["mla_moe_serving"] = out
    RECORD["mla_moe_context_move"] = context_move_ms(cfg, params, rc)
    RECORD["mla_moe_decode_profile"] = profile_decode(cfg, params, rc)
    del params
    torch.cuda.empty_cache()
    return out["mesc lanes=1 prompt=512 max_len=1024 slots=2"]["launches"]


def phase_moe_serving(dev):
    """llama4-maverick-400b-a17b at full width, cut to one (attn + dense,
    attn + 128-expert MoE) group (18.5 B parameters, 37 GB in bf16; the
    whole model is 397.7 B): MESC and non-preemptive on one lane; two
    decode-attention launches a decode step and two flash launches a
    prefill."""
    runs = [("mesc", 1, 8, 64, 2), ("np", 1, 8, 64, 2)]
    out, cfg, params, rc = phase_serving(dev, "llama4-maverick-400b-a17b",
                                         runs, n_layers=2)
    for tag, r in out.items():
        log(f"  {tag}: TTFT / latency {r['ttft_latency_s']}")
    RECORD["moe_serving"] = out
    del params
    torch.cuda.empty_cache()
    return out


def phase_xlstm_serving(dev):
    """xlstm-125m at full width and depth (three groups of three mLSTM
    blocks and one sLSTM; 0.129 B parameters) under MESC and
    non-preemptive serving with one resident slot, so that a HI arrival
    saves the running LO request's recurrent state (20.42 MiB whatever the
    sequence's length) to the host; every saved request's tokens must
    equal a solo replay of its prompt.  The cells are PyTorch operations:
    no kernel launch."""
    from repro_torch.launch import serve
    runs = [("mesc", 1, 8, 64, 1), ("np", 1, 8, 64, 1)]
    out, cfg, params, rc = phase_serving(dev, "xlstm-125m", runs)
    mesc = out["mesc lanes=1 prompt=8 max_len=64 slots=1"]
    assert mesc["saves"] >= 1, mesc
    reqs = {r.rid: r for r in serve.make_requests(
        cfg, np.random.default_rng(0), prompt_len=8)}
    for rid in mesc["saved"]:
        toks, _ = _solo(cfg, params, rc, reqs[rid].prompt,
                        reqs[rid].max_new_tokens, 64)
        assert toks == mesc["tokens"][rid], \
            f"rid {rid}: tokens across a save differ from its solo replay"
    log(f"  slots=1: {mesc['saves']} saves of requests "
        f"{sorted(mesc['saved'])}; each equals its solo replay")
    for tag, r in out.items():
        log(f"  {tag}: TTFT / latency {r['ttft_latency_s']}")
    RECORD["xlstm_serving"] = out
    RECORD["xlstm_context_move"] = context_move_ms(cfg, params, rc)
    RECORD["xlstm_decode_profile"] = profile_decode(cfg, params, rc)
    del params
    torch.cuda.empty_cache()


def phase_vlm_serving(dev):
    """llava-next-34b at full width and depth (60 layers, GQA 56/8,
    34.39 B parameters, 64.05 GiB in bf16), loaded after the card's cache
    is emptied, its peak memory recorded: MESC and non-preemptive serving
    on 8-token text prompts; then one request of 576 patch embeddings and
    448 text tokens (1024 positions, RoPE over all of them) through
    ``lm.prefill`` and 8 greedy decode steps, 60 flash launches and 60
    decode launches a step.  Returns the MESC run's launches."""
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    torch.cuda.empty_cache()
    runs = [("mesc", 1, 8, 64, 2), ("np", 1, 8, 64, 2)]
    out, cfg, params, rc = phase_serving(dev, "llava-next-34b", runs)
    for tag, r in out.items():
        log(f"  {tag}: TTFT / latency {r['ttft_latency_s']}")
    n_flash, n_dec, _ = path_launches(cfg)
    n_vis = cfg.n_frontend_tokens
    batch = model_batch(cfg, 1024 - n_vis, np.random.default_rng(2), n_vis)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(cfg, params, batch, rc, max_len=2048)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    toks = []
    for _ in range(8):
        tok = torch.argmax(logits.float(), dim=-1)
        toks.append(int(tok[0]))
        logits, cache = lm.decode_step(cfg, params, tok, cache, rc)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert launches["flash_attention"] == n_flash \
        and launches["decode_attention"] == 8 * n_dec, launches
    assert cache["pos"] == 1032 and logits.shape == (1, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())
    prefixed = {"positions": 1024, "patches": n_vis,
                "prefill_wall_s": prefill_s, "tokens": toks,
                "launches": launches,
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"  {n_vis} patch embeddings + {1024 - n_vis} text tokens: prefill "
        f"{prefill_s * 1e3:.1f} ms wall, 8 decode steps, launches "
        f"{launches}, peak card memory "
        f"{prefixed['max_memory_allocated'] / 2**30:.2f} GiB")
    RECORD["vlm_serving"] = dict(out, prefixed=prefixed)
    RECORD["vlm_context_move"] = context_move_ms(cfg, params, rc)
    RECORD["vlm_decode_profile"] = profile_decode(cfg, params, rc)
    del params, cache
    torch.cuda.empty_cache()
    return out["mesc lanes=1 prompt=8 max_len=64 slots=2"]["launches"]


def phase_audio(dev):
    """musicgen-large at full width and depth (48 layers, MHA 32/32 at dh
    64, 3.26 B parameters) in bf16: a 512-token, 4-codebook prompt through
    ``lm.prefill`` and 16 greedy decode steps (argmax per codebook), 48
    flash launches and 48 decode launches a step.  Not served: its tokens
    are (B, S, K) and the server feeds (1, S) prompts, as the reference's
    does.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm
    log("phase 4: full-width musicgen-large, bf16, prefill and greedy "
        "decode (no server: the audio family takes (B, S, K) tokens)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, rc = serve.init_model(get_config("musicgen-large"), dev)
    torch.cuda.synchronize()
    load = {"params": sum(t.numel() for _, t in _leaves(params)),
            "load_s": time.perf_counter() - t0,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "card": torch.cuda.get_device_name(0)}
    RECORD.setdefault("model_load", {})[cfg.name] = load
    log(f"  {load['params'] / 1e9:.3f} B parameters loaded in "
        f"{load['load_s']:.1f} s; peak card memory "
        f"{load['max_memory_allocated'] / 2**30:.2f} GiB")
    n_flash, n_dec, _ = path_launches(cfg)
    batch = model_batch(cfg, 512, np.random.default_rng(3))
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(cfg, params, batch, rc, max_len=1024)
    toks = []
    for _ in range(16):
        tok = torch.argmax(logits.float(), dim=-1)          # (1, K)
        toks.append(tok[0].tolist())
        logits, cache = lm.decode_step(cfg, params, tok, cache, rc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    assert launches["flash_attention"] == n_flash \
        and launches["decode_attention"] == 16 * n_dec, launches
    assert logits.shape == (1, cfg.n_codebooks, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert all(0 <= t < cfg.vocab for step in toks for t in step)
    log(f"  512 x {cfg.n_codebooks} prompt and 16 decode steps: {wall:.2f} s"
        f" wall; launches {launches}; first steps' tokens {toks[:3]}")
    RECORD["audio"] = {"wall_s": wall, "launches": launches, "tokens": toks}
    RECORD["audio_context_move"] = context_move_ms(cfg, params, rc)
    RECORD["audio_decode_profile"] = profile_decode(cfg, params, rc)
    del params, cache
    torch.cuda.empty_cache()
    return launches


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    raise AttributeError("profiler event has no device time")


def profile_decode(cfg, params, rc, steps: int = 5) -> dict:
    """Where a decode step's time goes: host wall time per step against
    the card's busy time (sum of kernel and copy time in a torch.profiler
    trace), one request at position ~512 of a 1024-slot cache."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    dev = params["embed"].device
    prompt = zero_tokens(cfg, 1, 512)
    t0 = time.perf_counter()
    _, cache = lm.prefill(cfg, params, {"tokens": prompt}, rc, max_len=1024)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = (zero_tokens(cfg, 1) + 1).to(dev)
    for _ in range(3):
        _, cache = lm.decode_step(cfg, params, tok, cache, rc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, cache = lm.decode_step(cfg, params, tok, cache, rc)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _, cache = lm.decode_step(cfg, params, tok, cache, rc)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    per_step = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm.prefill(cfg, params, {"tokens": prompt}, rc, max_len=1024)
        torch.cuda.synchronize()
    pk = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    prefill_busy = sum(_device_us(e) for e in pk) / 1e3
    prefill_top = {e.key[:60]: _device_us(e) / 1e3
                   for e in sorted(pk, key=_device_us, reverse=True)[:5]}
    log(f"  prefill of 512 tokens: card busy {prefill_busy:.3f} ms")
    for name, ms in prefill_top.items():
        log(f"    {ms:.4f} ms/prefill  {name}")
    out = {"prefill_512_wall_ms": prefill_ms,
           "prefill_512_device_busy_ms": prefill_busy,
           "prefill_top_kernels_ms": prefill_top,
           "decode_step_wall_ms": wall_ms,
           "decode_step_device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_ops_per_step": per_step,
           "top_kernels_ms_per_step": {
               e.key[:60]: _device_us(e) / 1e3 / steps for e in top}}
    log(f"  decode step (pos ~512): wall {wall_ms:.2f} ms, card busy "
        f"{busy_ms:.3f} ms in {per_step:.0f} kernels and copies, idle "
        f"share {out['device_idle_share']:.3f}; prefill of 512 tokens "
        f"{prefill_ms:.1f} ms")
    for name, ms in out["top_kernels_ms_per_step"].items():
        log(f"    {ms:.4f} ms/step  {name}")
    return out


# ---------------------------------------------------------------------------
# 5. preemptible GEMM
# ---------------------------------------------------------------------------

def phase_gemm(dev):
    from repro_torch.kernels import _build
    from repro_torch.launch import preemptible_gemm
    log("phase 5: preemptible GEMM (1024^3 fp32, bk 128, HI at 3 of 8)")
    preemptible_gemm.run(dev)                  # warm-up (first launches)
    _build.reset_launches()
    out = preemptible_gemm.run(dev)
    launches = dict(_build.LAUNCHES)
    assert launches["gemm_partial"] == 2 and launches["systolic_gemm"] == 1, \
        launches
    assert out["max_abs_err"] < 1e-2 and out["hi_max_abs_err"] < 1e-3, out
    log(f"  context save {out['save_s']*1e3:.3f} ms, restore "
        f"{out['restore_s']*1e3:.3f} ms for {out['acc_bytes']/2**20:.1f} MiB;"
        f" HI product {out['hi_s']*1e3:.3f} ms; resumed max|err| "
        f"{out['max_abs_err']:.2e}; launches {launches}")
    RECORD["preemptible_gemm"] = out
    return launches


# ---------------------------------------------------------------------------
# 7. open-loop serving (runs after phase 5, before the timing of phase 6)
# ---------------------------------------------------------------------------

FIG12_HI_DEADLINE_S = 0.5
# the real-model drive's workload: fig12's smoke sizes (24 LO + 8 HI) at
# its saturated LO load, the reference CLI's token counts, 8-token prompts
OPEN_LOOP_LO_LOAD = 1.2
OPEN_LOOP_N_LO, OPEN_LOOP_N_HI = 24, 8
OPEN_LOOP_LO_TOKENS, OPEN_LOOP_HI_TOKENS = 24, 6
OPEN_LOOP_PROMPT_LEN, OPEN_LOOP_MAX_LEN = 8, 64


def fig12_smoke_grid() -> list:
    """The 16 points of the reference's ``benchmarks/fig12_serving_slo.py
    --smoke`` (``sweep(2, n_lo=24, n_hi=8)``): {mesc, np} x {poisson,
    heavy_tail} x lo_load {0.7, 1.2} x set {0, 1}, two lanes."""
    from repro_torch.serving.fig12 import SERVING_SEMANTICS_VERSION
    return [dict(policy=pol, arrivals=arr, lo_load=load, lanes=2,
                 set_index=s, n_lo=24, n_hi=8,
                 hi_deadline_s=FIG12_HI_DEADLINE_S,
                 serving_v=SERVING_SEMANTICS_VERSION)
            for pol in ("mesc", "np") for arr in ("poisson", "heavy_tail")
            for load in (0.7, 1.2) for s in range(2)]


def pool_fig12_cell(cell) -> dict:
    """Pool the SLO rows of one (policy, arrivals, lo_load) cell as the
    reference's fig12 benchmark script does (``_cell_stats``): HI tails
    from the pooled per-request latencies, miss rate and goodput from the
    counts."""
    from repro_torch.serving.slo import nearest_rank
    lat = sorted(v for r in cell for v in r["hi_latencies_s"])
    n_hi = sum(r["hi_n"] for r in cell)
    missed = sum(round(r["hi_miss_rate"] * r["hi_n"]) for r in cell)
    return dict(
        hi_p50=nearest_rank(lat, 0.50),
        hi_p99=nearest_rank(lat, 0.99),
        hi_p999=nearest_rank(lat, 0.999),
        hi_miss=missed / n_hi if n_hi else None,
        lo_p50=(sorted(r["lo_p50_latency_s"] for r in cell)
                [len(cell) // 2]),
        goodput=sum(r["goodput_rps"] for r in cell) / len(cell),
        preempts=sum(r["hi_preemptions"] + r["lo_preemptions"]
                     for r in cell),
    )


def fig12_gate(rows) -> dict:
    """The pooled table of the smoke grid and the reference's ``--gate``:
    at the saturated poisson cell MESC's pooled HI p99 and p999 lie below
    non-preemptive serving's and its HI miss rate is no higher."""
    cells = {}
    for r in rows:
        cells.setdefault((r["policy"], r["arrivals"], r["lo_load"]),
                         []).append(r)
    table = {k: pool_fig12_cell(v) for k, v in sorted(cells.items())}
    mesc, np_ = table[("mesc", "poisson", 1.2)], table[("np", "poisson", 1.2)]
    ok = (mesc["hi_p99"] < np_["hi_p99"] and mesc["hi_p999"] < np_["hi_p999"]
          and mesc["hi_miss"] <= np_["hi_miss"])
    return {"table": table, "ok": ok,
            "sat_hi_p99_np/mesc": np_["hi_p99"] / max(mesc["hi_p99"], 1e-9)}


def phase_fig12() -> dict:
    """(a) The fig12 smoke grid through the port, twice: the two passes'
    rows must be byte-identical (the reference's replay gate) and pass the
    reference's gate.  Host arithmetic on the virtual clock: no device."""
    from repro_torch.serving.fig12 import simulate_fig12_point
    log("  (a) fig12 smoke grid, 16 points x 2 passes (host arithmetic on "
        "the virtual clock; no device)")
    t0 = time.perf_counter()
    dumps = []
    for _ in range(2):
        rows = [{**item, **simulate_fig12_point(**item)}
                for item in fig12_smoke_grid()]
        dumps.append(json.dumps(rows, sort_keys=True, separators=(",", ":")))
    host_s = time.perf_counter() - t0
    assert dumps[0] == dumps[1], "fig12 rows differ between two passes"
    gate = fig12_gate(rows)
    log("  policy,arrivals,lo_load,hi_p50,hi_p99,hi_p999,hi_miss,lo_p50,"
        "goodput_rps")
    for (pol, arr, load), c in gate["table"].items():
        log(f"  {pol},{arr},{load},{c['hi_p50']:.4f},{c['hi_p99']:.4f},"
            f"{c['hi_p999']:.4f},{c['hi_miss']:.3f},{c['lo_p50']:.2f},"
            f"{c['goodput']:.2f}")
    log(f"  sat_hi_p99_np/mesc={gate['sat_hi_p99_np/mesc']:.1f}x; replay "
        f"byte-identical ({len(dumps[0])} bytes); gate "
        f"{'OK' if gate['ok'] else 'FAILED'}; {host_s:.1f} s of host time")
    assert gate["ok"], gate["table"]
    sha = hashlib.sha256(dumps[0].encode()).hexdigest()
    log(f"  rows sha256 {sha}")
    return {"host_s": host_s, "rows_sha256": sha,
            "sat_hi_p99_np_over_mesc": gate["sat_hi_p99_np/mesc"],
            "table": {",".join(map(str, k)): v
                      for k, v in gate["table"].items()}}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _solo(cfg, params, rc, prompt, n, max_len) -> tuple:
    """(tokens, wall s) of one request served alone, non-preemptively."""
    from repro_torch.core.scheduler import Policy
    from repro_torch.core.serving import MESCServer, Request
    from repro_torch.core.task import Crit
    srv = MESCServer(cfg, params, policy=Policy.non_preemptive(), rc=rc,
                     max_len=max_len)
    dev = params["embed"].device
    _sync(dev)
    t0 = time.perf_counter()
    srv.submit(Request(rid=0, priority=0, prompt=np.asarray(prompt),
                       max_new_tokens=n, crit=Crit.LO))
    srv.run()
    _sync(dev)
    return srv.requests[0].generated, time.perf_counter() - t0


def phase_open_loop(dev, arch="tinyllama-1.1b") -> dict:
    """Open-loop serving: (a) the fig12 smoke grid on the host, (b) the
    real-model open-loop drive of ``launch.serve.run_traffic_real`` on the
    card: full-width ``arch`` in bf16 on one lane serves Poisson LO and HI
    arrivals under MESC and under non-preemptive serving, the LO rate at
    ``OPEN_LOOP_LO_LOAD`` x the lane's measured capacity.  One resident
    cache slot, so that a HI arrival saves the running LO request's cache
    to the host (with two slots one lane never fills its pool);
    non-preemptive serving never holds two caches, so the slot count does
    not change it."""
    from repro_torch.configs.base import _pattern_for
    from repro_torch.core.scheduler import Policy
    from repro_torch.core.task import Crit
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving import Poisson, build_workload, slo_summary
    log("phase 7: open-loop serving (after phase 5, before phase 6's "
        "timing)")
    t_phase = time.perf_counter()
    out = {"fig12": phase_fig12()}

    cfg, params, rc = serve.load_model(arch, dev)
    n_attn = _pattern_for(cfg).count("attn")
    rng = np.random.default_rng(1)
    # one warm-up request, then the median of three: the first request
    # after a stretch of host-only work runs slower (on an H100 80GB HBM3,
    # ~35 ms a step against ~21 ms a step inside a busy open-loop run)
    alone = [_solo(cfg, params, rc,
                   rng.integers(0, cfg.vocab, OPEN_LOOP_PROMPT_LEN),
                   OPEN_LOOP_LO_TOKENS, OPEN_LOOP_MAX_LEN)[1]
             for _ in range(4)]
    one_s = statistics.median(alone[1:])
    capacity = 1.0 / one_s
    lo_rate = OPEN_LOOP_LO_LOAD * capacity
    hi_rate = lo_rate * OPEN_LOOP_N_HI / OPEN_LOOP_N_LO
    workload = build_workload(seed=0, lo_process=Poisson(lo_rate),
                              hi_process=Poisson(hi_rate),
                              n_lo=OPEN_LOOP_N_LO, n_hi=OPEN_LOOP_N_HI,
                              lo_tokens=OPEN_LOOP_LO_TOKENS,
                              hi_tokens=OPEN_LOOP_HI_TOKENS)
    dtype = str(rc.compute_dtype).replace("torch.", "")
    log(f"  (b) {arch} ({cfg.n_layers} layers), {dtype} on {dev}, one lane, "
        f"one resident slot: a {OPEN_LOOP_LO_TOKENS}-token LO request "
        f"alone takes {one_s * 1e3:.1f} ms (median of "
        f"{', '.join(f'{t * 1e3:.1f}' for t in alone[1:])}; warm-up "
        f"{alone[0] * 1e3:.1f}), capacity {capacity:.3f} req/s; LO "
        f"{lo_rate:.3f} req/s ({OPEN_LOOP_LO_LOAD} x), HI {hi_rate:.3f} "
        f"req/s; {OPEN_LOOP_N_LO} LO + {OPEN_LOOP_N_HI} HI, horizon "
        f"{workload[-1].t:.2f} s")
    out.update(capacity_rps=capacity, one_request_s=alone, lo_rate=lo_rate,
               hi_rate=hi_rate, runs={})
    for name, policy in (("mesc", Policy.mesc()),
                         ("np", Policy.non_preemptive())):
        _build.reset_launches()
        t0 = time.perf_counter()
        reqs = serve.run_traffic_real(cfg, params, policy, workload, rc=rc,
                                      max_len=OPEN_LOOP_MAX_LEN,
                                      prompt_len=OPEN_LOOP_PROMPT_LEN,
                                      resident_slots=1)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        assert sorted(reqs) == [s.rid for s in workload], name
        for r in reqs.values():
            assert r.done and len(r.generated) == r.max_new_tokens, r.rid
        steps = sum(len(r.generated) for r in reqs.values()) \
            + serve.WARMUP_TOKENS
        prefills = len(reqs) + 1                   # and the warm-up's
        if dev.type == "cuda":
            assert launches["decode_attention"] == n_attn * steps, launches
            assert launches["flash_attention"] == n_attn * prefills, \
                launches
        row = slo_summary(reqs.values(), hi_deadline_s=FIG12_HI_DEADLINE_S)
        replayed = [r for r in reqs.values()
                    if r.crit == Crit.HI or r.saves > 0]
        for r in replayed:
            toks, _ = _solo(cfg, params, rc, r.prompt, r.max_new_tokens,
                            OPEN_LOOP_MAX_LEN)
            assert toks == r.generated, (f"{name}: rid {r.rid} (saves "
                                         f"{r.saves}) differs from its "
                                         "solo replay")
        keep = ("hi_p50_ttft_s", "hi_p99_ttft_s", "hi_p50_latency_s",
                "hi_p99_latency_s", "lo_p50_ttft_s", "lo_p99_ttft_s",
                "lo_p50_latency_s", "lo_p99_latency_s", "hi_miss_rate",
                "goodput_rps", "hi_saves", "lo_saves", "hi_preemptions",
                "lo_preemptions", "makespan_s")
        slo = {k: row[k] for k in keep}
        slo.update(policy=name, wall_s=wall, decode_steps=steps,
                   prefills=prefills, launches=launches,
                   replayed=len(replayed))
        log(json.dumps({"open_loop": slo}))
        out["runs"][name] = dict(slo, row=row)
    mesc, base = out["runs"]["mesc"], out["runs"]["np"]
    assert mesc["hi_saves"] + mesc["lo_saves"] > 0, "MESC saved no context"
    assert base["hi_saves"] + base["lo_saves"] == 0
    assert mesc["hi_p99_ttft_s"] < base["hi_p99_ttft_s"], (mesc, base)
    out["wall_s"] = time.perf_counter() - t_phase
    ratio = base["hi_p99_ttft_s"] / mesc["hi_p99_ttft_s"]
    log(f"  HI p99 TTFT np/mesc {ratio:.1f}x; HI and saved requests equal "
        f"their solo replays; phase {out['wall_s']:.1f} s")
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 8. the lockstep simulation engine (runs after 7, before the timing of 6)
# ---------------------------------------------------------------------------

# the reference's corpora: tests/harness.py's fig8_corpus (the smoke
# corpus) and mixed_corpus, and benchmarks/perf_sim.py's FULL corpus (512
# MESC points over the fig8 utilisation band, duration 2e8)
SIM_SMOKE = dict(utils=(0.7, 0.9), n_sets=16)
SIM_FULL = dict(utils=(0.6, 0.7, 0.8, 0.9), n_sets=128)
SIM_MIXED_SIZES = (3, 10, 6, 13)
SIM_DURATION, SIM_FULL_DURATION = 2e7, 2e8
# sha256 (simulator_jit.metrics_digest: every field of every row, floats
# as float.hex) of the JAX package's simulate_jbatch rows for each case,
# computed on the CPU; tests/test_torch_simulator_jit.py and
# tests/test_torch_experiments.py hold the port and the reference to the
# same pins
SIM_PINS = {
    "smoke/sampled":
        "8bde19b7d2ecdaa21b97fa4538daa5e344ad18b767a5e39670a9aa563cf89eab",
    "smoke/nominal":
        "b7c5d7057606188c639f5f49b724680265cdc4e404db00ea4ad5204ca18cc275",
    "mixed/mesc":
        "a205a02e72f87dd7efd6ae14590980e86ce901e50cb6f7eea0a04290078701de",
    "mixed/np":
        "b3bd8723778f0c71c59d80846bdf93a7c5084bcf227b803c68daed062bb3ac16",
    "mixed/lp":
        "ae6a6ba6390c7a6fa393a38f703883bed99c8d569603e7ffa5fb933eb6285779",
    "mixed/amc-instruction":
        "8510053a797a38d00b96995274240d667a07fda07a2e5c668d55ca9eb191b27c",
    "smoke/faults@0.7":
        "ffc0807f60c9d2f40745595d20fffc3c9fe9de2625ee926184393576ffd0171e",
    "full/sampled":
        "922debb2f9c064a4e420b51b0b878ddbf9a7c0216bd0c702e05a7b2af11ce1b1",
    # phase 9: metrics_digest of the reference's event engine (simulate)
    # on the FULL corpus, and rows_digest of the reference Campaign's
    # rows for fig8's sweep on each engine and fig11's FuncSweep
    "full/event":
        "09eb53fa3c19c048f15e8e80249510b1d6f7a7cd1221639404a27611fe089975",
    "fig8/event":
        "a1cea7f3bc12df4fca118ed497dc05c9773c9a6a3fd3d8de173b7d6661c08d8d",
    "fig8/vec":
        "a1cea7f3bc12df4fca118ed497dc05c9773c9a6a3fd3d8de173b7d6661c08d8d",
    "fig8/jit":
        "262e6fe6db3ea6dbf57c9cbc32f0d52c89edb51df998af509dd09629cb5bff4d",
    "fig11/multiacc":
        "1b596716248722fd185bc8856d85147142048800b783948c27ce5be1e6c01fd9",
}


def sim_library() -> dict:
    """The workload library without the ``arch:`` programs (the
    reference's ``cached_library("sim")``)."""
    from repro_torch.core.program import workload_library
    return {k: v for k, v in workload_library().items()
            if not k.startswith("arch:")}


def sim_corpus(lib, utils, n_sets, n_tasks=10) -> tuple:
    """fig8-style corpus: ``n_sets`` UUnifast sets per utilisation, set s
    from seed s, run with seed s."""
    from repro_torch.core.taskgen import generate_taskset
    tasksets, seeds = [], []
    for u in utils:
        for s in range(n_sets):
            tasksets.append(generate_taskset(u, seed=s, n_tasks=n_tasks,
                                             programs=lib))
            seeds.append(s)
    return tasksets, seeds


def sim_cases(lib) -> list:
    """(pin name, tasksets, seeds, policy, keywords) of the small cases."""
    from repro_torch.core.scheduler import Policy
    from repro_torch.core.taskgen import generate_taskset
    smoke = sim_corpus(lib, **SIM_SMOKE)
    mixed = ([generate_taskset(0.9, seed=s, n_tasks=n, programs=lib)
              for s, n in enumerate(SIM_MIXED_SIZES)],
             list(range(len(SIM_MIXED_SIZES))))
    cases = [(f"smoke/{prof}", *smoke, Policy.mesc(),
              dict(demand_profile=prof)) for prof in ("sampled", "nominal")]
    cases += [(f"mixed/{p.name}", *mixed, p, {})
              for p in (Policy.mesc(), Policy.non_preemptive(),
                        Policy.limited(), Policy.amc())]
    cases.append(("smoke/faults@0.7", *smoke, Policy.mesc(),
                  dict(scenario="faults@0.7")))
    return cases


# the kernel launches of one lockstep step of the FULL corpus, profiled
# in a fresh process: a graph of one step (no flag), one replay.  Late in
# this long process the trace loses events (841-865 launches a step
# against the 866 a fresh process records, on an H100)
STEP_LAUNCHES_CLI = """
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as C
from repro_torch.core import simulator_jit as sj
from repro_torch.core.scheduler import Policy
lib = C.sim_library()
ts, seeds = C.sim_corpus(lib, **C.SIM_FULL)
b = sj._VecBatch(ts, lib, Policy.mesc(), seeds=seeds,
                 duration=C.SIM_FULL_DURATION, overrun_prob=0.3, cf=2.0)
runners, states = sj._prepare(b, Policy.mesc(), seeds, C.SIM_FULL_DURATION,
                              0.3, 2.0, False, sj._table_width(),
                              device=torch.device("cuda"))
r, st = runners[0], states[0]
r._load(*st)
one = r._capture(*st, body=lambda: r.step(r.tb, r.sc, r.c, r.k))
r._load(*st)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    one.replay()
    torch.cuda.synchronize()
print(sum(e.count for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.key.lower().startswith(("memcpy", "memset"))))
"""


def profiled_step_launches() -> int:
    """Kernel launches (no memcpy or memset) of one lockstep step of the
    FULL corpus, as torch.profiler records a one-step graph's replay in
    a fresh process (``STEP_LAUNCHES_CLI``)."""
    p = subprocess.run([sys.executable, "-c", STEP_LAUNCHES_CLI], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert p.returncode == 0, p.stdout + p.stderr
    return int(p.stdout.strip().splitlines()[-1])


def profile_lockstep(runner, state, eager_steps: int = 16) -> dict:
    """One graph replay from the batch's first state: its device time
    (CUDA events), its kernels and their busy time (torch.profiler), the
    same steps run eagerly with a host sync per step, and the FULL
    corpus's kernel launches a step (``profiled_step_launches``)."""
    from torch.profiler import ProfilerActivity, profile
    S = runner.steps
    runner._load(*state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    runner.graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end)
    runner._load(*state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in kernels)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:6]
    # the traced replay's own span on the card, first kernel start to
    # last kernel end (tracing slows kernels, so the untraced replay's
    # time is not the denominator)
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    span_ms = (max(t.end for t in spans) - min(t.start for t in spans)) \
        / 1e3 if spans else None
    runner._load(*state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(eager_steps):
        runner.step(runner.tb, runner.sc, runner.c, runner.k)
        torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / eager_steps
    # the least HBM traffic of a step: the carry read and written once,
    # the batch's tables read once
    nbytes = 2 * sum(t.numel() * t.element_size() for t in runner.c.values()) \
        + sum(t.numel() * t.element_size() for t in runner.tb.values())
    out = {"graph_steps": S, "replay_ms": replay_ms,
           "bytes_per_step": nbytes,
           "bytes_bound_ms_per_step": nbytes / PEAK_BYTES * 1e3,
           "ms_per_step": replay_ms / S,
           "kernels_per_step": n_kernels / S if n_kernels else None,
           "kernel_launches_per_step": profiled_step_launches(),
           "busy_ms_per_step": busy_ms / S if n_kernels else None,
           "traced_span_ms": span_ms,
           "idle_share": 1.0 - busy_ms / span_ms if n_kernels else None,
           "eager_ms_per_step": eager_ms,
           "top_kernels_ms_per_step": {e.key[:60]: _device_us(e) / 1e3 / S
                                       for e in top}}
    return out


def phase_sim(dev) -> dict:
    """The port's lockstep engine (``core.simulator_jit.simulate_jbatch``)
    on the card: each small case's rows equal its pin, the smoke
    corpus's also the port's own CPU rows; the 512-point FULL corpus,
    twice (the first run captures the CUDA graph), equals its pin; one
    graph replay is profiled."""
    from repro_torch.core import simulator_jit as sj
    from repro_torch.core.scheduler import Policy
    log("phase 8: the lockstep simulation engine (simulate_jbatch) in "
        f"CUDA graphs of {sj.GRAPH_STEPS} steps")
    t_phase = time.perf_counter()
    lib = sim_library()
    out = {"cases": {}}
    for name, ts, seeds, policy, kw in sim_cases(lib):
        sj.reset_counts()
        t0 = time.perf_counter()
        card = sj.simulate_jbatch(ts, lib, policy, seeds=seeds,
                                  duration=SIM_DURATION, device=dev, **kw)
        card_s = time.perf_counter() - t0
        counts = dict(sj.COUNTS)
        digest = sj.metrics_digest(card)
        assert digest == SIM_PINS[name], (name, digest)
        on_cpu = name in ("smoke/sampled", "smoke/nominal")
        if on_cpu:
            cpu = sj.simulate_jbatch(ts, lib, policy, seeds=seeds,
                                     duration=SIM_DURATION, device="cpu",
                                     **kw)
            assert sj.metrics_digest(cpu) == digest, name
        if dev.type == "cuda":
            assert counts["replays"] > 0 and counts["steps"] > 0, counts
        out["cases"][name] = dict(counts, points=len(ts), wall_s=card_s)
        also = " and the CPU port's" if on_cpu else ""
        log(f"  {name}: {len(ts)} points, rows equal the pin{also}; "
            f"{counts['steps']} steps, {counts['replays']} replays, "
            f"{counts['captures']} captures, {card_s:.2f} s")
    ts, seeds = sim_corpus(lib, **SIM_FULL)
    runs = []
    for _ in range(2):
        sj.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        ms = sj.simulate_jbatch(ts, lib, Policy.mesc(), seeds=seeds,
                                duration=SIM_FULL_DURATION, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = dict(sj.COUNTS)
        digest = sj.metrics_digest(ms)
        assert digest == SIM_PINS["full/sampled"], digest
        assert counts["steps"] > 0 and counts["replays"] > 0, counts
        runs.append(dict(counts, wall_s=wall, points=len(ts),
                         points_per_s=len(ts) / wall))
    assert runs[1]["captures"] == 0, runs[1]
    success_hi = float(np.mean([m.misses["HI"] == 0 for m in ms]))
    success_all = float(np.mean([m.success() for m in ms]))
    out.update(full=runs, full_success_hi=success_hi,
               full_success_all=success_all)
    for i, r in enumerate(runs):
        log(json.dumps({"lockstep": dict(r, run=i, corpus="perf_sim FULL",
                                         digest_ok=True)}))
    if dev.type == "cuda":
        b = sj._VecBatch(ts, lib, Policy.mesc(), seeds=seeds,
                         duration=SIM_FULL_DURATION, overrun_prob=0.3,
                         cf=2.0)
        runners, states = sj._prepare(b, Policy.mesc(), seeds,
                                      SIM_FULL_DURATION, 0.3, 2.0, False,
                                      sj._table_width(), device=dev)
        runner, state = runners[0], states[0]
        assert runner.graph is not None
        prof = profile_lockstep(runner, state)
        out["profile"] = prof
        busy = prof["busy_ms_per_step"]
        log(f"  one replay of {prof['graph_steps']} steps: "
            f"{prof['replay_ms']:.3f} ms of card time, "
            f"{prof['ms_per_step']:.4f} ms a step; "
            + (f"{prof['kernels_per_step']:.0f} kernels a step, busy "
               f"{busy:.4f} ms, idle share {prof['idle_share']:.3f}; "
               if busy is not None else "profiler saw no kernel; ")
            + f"eager with a sync per step {prof['eager_ms_per_step']:.3f} "
            f"ms a step; bytes bound {prof['bytes_bound_ms_per_step']:.5f} "
            f"ms a step ({prof['bytes_per_step']} bytes)")
        for name, ms_ in prof["top_kernels_ms_per_step"].items():
            log(f"    {ms_:.5f} ms/step  {name}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  FULL corpus: rows equal the pin in both runs; success_hi "
        f"{success_hi:.4f}, success_all {success_all:.4f}; "
        f"{runs[1]['points_per_s']:.1f} points/s; phase "
        f"{out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 9. campaigns and the three engines (runs after 8, before the timing of 6)
# ---------------------------------------------------------------------------

# benchmarks/fig8_success.py's sweep recipe (its four systems over
# benchmarks/common.py's UTILS), cut to 8 sets and duration 2e7, and
# benchmarks/fig11_multiacc.py's FuncSweep at 2 sets (duration 2e8)
CAMPAIGN_UTILS = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95)
CAMPAIGN_SETS, CAMPAIGN_DURATION = 8, 2e7
FIG11_SETS = 2
FIG11_INSTANCES, FIG11_UTILS_PER_INST = (1, 2, 4), (0.6, 0.8)
FIG11_HEURISTICS = ("first_fit", "worst_fit", "crit_aware")
def fig8_sweep(engine: str, n_sets: int = CAMPAIGN_SETS):
    """fig8's campaign: mesc, np, amc and non-preemptive AMC over the
    utilisation band, ``n_sets`` sets per cell."""
    from repro_torch.core.scheduler import Policy
    from repro_torch.experiments import Sweep
    systems = (Policy.mesc(), Policy.non_preemptive(), Policy.amc(),
               Policy(preemption="none", drop_lo_in_hi=True, name="amc-np"))
    return Sweep(name="fig8_success", policies=systems,
                 utils=CAMPAIGN_UTILS, n_sets=n_sets,
                 duration=CAMPAIGN_DURATION, engine=engine)


def fig11_sweep(n_sets: int = FIG11_SETS):
    """fig11's multi-accelerator FuncSweep over the port's point
    function (its point keys name the port's function, its rows equal
    the reference's)."""
    from repro_torch.core.simulator import (MULTI_SIM_SEMANTICS_VERSION,
                                            SIM_SEMANTICS_VERSION)
    from repro_torch.experiments import FuncSweep
    items = [dict(policy=policy, u=round(u_norm * n, 4), n_instances=n,
                  heuristic=heur, set_index=s,
                  sim_v=[SIM_SEMANTICS_VERSION, MULTI_SIM_SEMANTICS_VERSION])
             for policy in ("mesc", "np") for n in FIG11_INSTANCES
             for heur in FIG11_HEURISTICS for u_norm in FIG11_UTILS_PER_INST
             for s in range(n_sets)]
    return FuncSweep.over(
        "fig11_multiacc",
        "repro_torch.experiments.multiacc:simulate_multiacc_point", items)


def _hexed(x):
    if isinstance(x, float):
        return x.hex()
    if isinstance(x, dict):
        return {k: _hexed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_hexed(v) for v in x]
    return x


def rows_digest(rows) -> str:
    """sha256 of campaign rows, key-sorted JSON with floats as
    ``float.hex`` (bit-exact)."""
    return hashlib.sha256(json.dumps(_hexed(rows), sort_keys=True)
                          .encode()).hexdigest()


def _campaign_twice(sweep, device, workers) -> dict:
    """A campaign in a fresh cache directory (every point a miss), then
    again in the same directory (every point a hit, the same rows)."""
    from repro_torch.core import simulator_jit as sj
    from repro_torch.experiments import Campaign
    n = len(sweep.points())
    (ROOT / "results").mkdir(exist_ok=True)
    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_", dir=ROOT / "results")
    try:
        sj.reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        first = Campaign(sweep, cache_dir=cache, workers=workers,
                         device=device)
        rows = first.collect()
        _sync(device)
        wall = time.perf_counter() - t0
        counts = dict(sj.COUNTS)
        assert first.stats == {"hits": 0, "misses": n}, first.stats
        t0 = time.perf_counter()
        again = Campaign(sweep, cache_dir=cache, workers=workers,
                         device=device)
        rows2 = again.collect()
        hit_s = time.perf_counter() - t0
        assert again.stats == {"hits": n, "misses": 0}, again.stats
        assert rows2 == rows, sweep.name
    finally:
        shutil.rmtree(cache)
    return dict(rows=rows, points=n, wall_s=wall, hit_wall_s=hit_s,
                steps=counts["steps"], replays=counts["replays"])


def phase_campaign(dev, jit_run=None, full=None) -> dict:
    """(a) The FULL corpus through the port's event engine and NumPy vec
    engine on the host: vec rows equal the event rows, which equal the
    reference's pin; the nominal smoke corpus's vec rows equal the jit
    pin.  One ``{"engines": ...}`` line gives each engine's points/s,
    the jit figures from ``jit_run`` (phase 8's second FULL run).
    (b) fig8's campaign on jit (on ``dev``), event and vec, each equal
    to its pin, a second run all hits.  (c) fig11's multi-accelerator
    FuncSweep, equal to its pin."""
    from repro_torch.core import simulator_jit as sj
    from repro_torch.core.scheduler import Policy
    from repro_torch.core.simulator import simulate
    from repro_torch.core.simulator_vec import simulate_vbatch
    log("phase 9: campaigns and the three engines")
    t_phase = time.perf_counter()
    full = SIM_FULL if full is None else full
    lib = sim_library()
    ts, seeds = sim_corpus(lib, **full)
    policy = Policy.mesc()
    t0 = time.perf_counter()
    ev = [simulate(t, lib, policy, seed=s, duration=SIM_FULL_DURATION)
          for t, s in zip(ts, seeds)]
    ev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vec = simulate_vbatch(ts, lib, policy, seeds=seeds,
                          duration=SIM_FULL_DURATION, batch_size=512,
                          select_backend="numpy")
    vec_s = time.perf_counter() - t0
    assert vec == ev, "vec rows differ from the event rows"
    ev_digest = sj.metrics_digest(ev)
    if full == SIM_FULL:
        assert ev_digest == SIM_PINS["full/event"], ev_digest
    nts, nseeds = sim_corpus(lib, **SIM_SMOKE)
    nominal = simulate_vbatch(nts, lib, policy, seeds=nseeds,
                              duration=SIM_DURATION,
                              demand_profile="nominal")
    assert sj.metrics_digest(nominal) == SIM_PINS["smoke/nominal"]
    n = len(ts)
    host = f"host, one process, {os.cpu_count()} CPUs on the machine"
    engines = {
        "event": dict(points_per_s=n / ev_s, wall_s=ev_s, where=host),
        "vec": dict(points_per_s=n / vec_s, wall_s=vec_s, where=host),
        "jit": (dict(points_per_s=jit_run["points_per_s"],
                     wall_s=jit_run["wall_s"],
                     where=f"{dev.type}, phase 8 second run")
                if jit_run is not None else None)}
    card, power = [x.strip() for x in smi().split(",", 1)] \
        if dev.type == "cuda" else (None, None)
    log(f"  (a) {n} points, duration {SIM_FULL_DURATION:.0e}: vec rows "
        "equal the event rows" + (", which equal the reference's pin"
                                  if full == SIM_FULL else "")
        + "; the nominal smoke corpus's vec rows equal the jit pin")
    log(json.dumps({"engines": engines, "corpus": "perf_sim FULL"
                    if full == SIM_FULL else f"cut {full}", "points": n,
                    "host_cpus": os.cpu_count(), "card": card,
                    "power_limit": power}))
    out = {"engines": engines, "full_event_digest": ev_digest,
           "campaigns": {}}
    workers = os.cpu_count() or 1
    for engine in ("jit", "event", "vec"):
        r = _campaign_twice(fig8_sweep(engine), dev, workers)
        digest = rows_digest(r.pop("rows"))
        assert digest == SIM_PINS[f"fig8/{engine}"], (engine, digest)
        if engine == "jit" and dev.type == "cuda":
            assert r["replays"] > 0 and r["steps"] > 0, r
        out["campaigns"][f"fig8/{engine}"] = r
        log(f"  (b) fig8 campaign, {engine}: {r['points']} points equal the "
            f"pin in {r['wall_s']:.2f} s ({r['steps']} lockstep steps); "
            f"the second run all hits, {r['hit_wall_s']:.2f} s")
    r = _campaign_twice(fig11_sweep(), dev, workers)
    digest = rows_digest(r.pop("rows"))
    assert digest == SIM_PINS["fig11/multiacc"], digest
    out["campaigns"]["fig11/multiacc"] = r
    log(f"  (c) fig11 multiacc FuncSweep: {r['points']} points equal the "
        f"pin in {r['wall_s']:.2f} s; the second run all hits")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 10. training
# ---------------------------------------------------------------------------

# 10 (a): (arch, layers or None for the config's, batch, tokens) -- each
# family's smoke config (xlstm also at 32 tokens: its chunkwise mLSTM; the
# hybrid at 64: its 32-token window inside the sequence) and full-width
# tinyllama-1.1b cut to 2 of 22 layers
TRAIN_GRAD_CASES = (("tinyllama-1.1b-smoke", None, 2, 16),
                    ("recurrentgemma-2b-smoke", None, 2, 64),
                    ("llama4-maverick-400b-a17b-smoke", None, 2, 16),
                    ("deepseek-v2-lite-16b-smoke", None, 2, 16),
                    ("xlstm-125m-smoke", None, 2, 16),
                    ("xlstm-125m-smoke", None, 2, 32),
                    ("llava-next-34b-smoke", None, 2, 16),
                    ("musicgen-large-smoke", None, 2, 16),
                    ("tinyllama-1.1b", 2, 1, 128))
# card against CPU, fp32 with TF32 off, the same operations summed in other
# orders: the loss within 1e-5 relative; each leaf's gradient within
# GRAD_RTOL x that leaf's largest CPU gradient, the CPU tests' bound
# against the JAX package (fp32 readings: ~2e-6 of the scale at most).  The
# full-width cut is run once more with TF32 on as the control this check
# exists to catch, and that reading must lie above the bound
GRAD_RTOL = 1e-4
# the trained TinyLlama served in bf16 through the kernels against
# forward's blocked attention on the same bf16 weights: both round every
# activation to bf16 in other places through 22 layers.  The bound is
# TRAIN_SERVE_TOL x the largest |logit| of the position: one bf16 ulp of
# it (2^-7 at the bottom of a binade) to two (2^-8 at its top), the least
# that a one-ulp flip of the largest logit passes.  The control, the
# logits of the weights before training (the fault of serving other
# weights than the trained ones), must lie above it.  Forward's next
# position is read too: 8 steps from random weights leave the logits
# nearly alike from one position to the next, so a position fault is
# held by phase 3 (kernels against plain versions in fp32) and the CPU
# tests of prefill and decode against forward, not by this phase
TRAIN_SERVE_TOL = 8e-3
# a resumed process's printed losses against the uninterrupted run's:
# 4 decimals printed, and CUDA's atomics (the embedding's index backward)
# make the backward nondeterministic in the last bits
RESUME_LOSS_TOL = 2e-3
# launch/train.py on a depth cut: ``python -c TRAIN_CLI <layers> <args...>``
# (from the repo's root), printing ``saved <step> <digest>`` for each state
# it checkpoints and ``restored <step> <digest> <devices>`` for the state a
# resumed run restores
TRAIN_CLI = """
import dataclasses, sys
from chip_smoke import state_digest, tensor_items
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.pytree import tree_leaves
n = int(sys.argv[1])
train.get_config = lambda name: dataclasses.replace(configs.get_config(name),
                                                    n_layers=n)


class Manager(train.CheckpointManager):
    def maybe_save(self, step, state, extra=None):
        if step % self.interval == 0:
            print(f"saved {step} {state_digest(tensor_items(state))}")
        return super().maybe_save(step, state, extra)

    def restore_or_init(self, templates, init_fn, device=None):
        state, step, extra = super().restore_or_init(templates, init_fn,
                                                     device)
        devs = sorted({t.device.type for t in tree_leaves(state)})
        print(f"restored {step} {state_digest(tensor_items(state))} "
              + ",".join(devs))
        return state, step, extra


train.CheckpointManager = Manager
sys.exit(train.main(sys.argv[2:]))
"""


def state_digest(items) -> str:
    """sha256 over each (key, array, dtype name) of ``items``, in order:
    the key, dtype name and shape, then the array's bytes."""
    h = hashlib.sha256()
    for key, a, dtype in items:
        h.update(f"{key} {dtype} {tuple(a.shape)}\n".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def tensor_items(state):
    """(group/path, array, dtype name) of a checkpoint state's tensors, in
    the order of its npz files (bf16 as its uint16 bits)."""
    from repro_torch.pytree import to_numpy, tree_items
    for group in sorted(state):
        for path, t in tree_items(state[group]):
            yield (f"{group}/{path}", *to_numpy(t))


def train_cfg(arch, n_layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def _worst_grad(gc, gd) -> tuple:
    """(largest max|err| / max|g| over the leaves, its leaf): card
    gradients ``gd`` against CPU ones ``gc``, flat dicts by path."""
    worst, where = 0.0, None
    for path, g in gc.items():
        assert gd[path].dtype == torch.float32, path
        scale = float(g.abs().max())
        err = max_err(gd[path].cpu(), g)
        ratio = err / scale if scale else (0.0 if err <= 1e-7 else np.inf)
        if ratio >= worst:
            worst, where = ratio, path
    return worst, where


def phase_train_grads(dev, cases=TRAIN_GRAD_CASES) -> dict:
    """10 (a): each case's loss, metrics and every leaf's gradient on the
    card against the CPU, fp32 (TF32 off), from the same master weights
    and batch; in a MoE family every call's experts must agree first.
    The full-width cut again with TF32 on: the control, which must fail
    the bound.  Returns each case's largest gradient error over its
    leaf's scale, and the control's."""
    from repro_torch.data import batch_for_arch
    from repro_torch.models import ffn, lm
    from repro_torch.models.common import CPU_RC
    from repro_torch.pytree import tree_items
    from repro_torch.runtime.trainer import loss_and_grads
    log("phase 10 (a): loss_fn and every gradient, card against CPU, fp32 "
        "(TF32 off)")
    assert not torch.backends.cuda.matmul.allow_tf32
    out = {}
    for arch, n_layers, B, S in cases:
        cfg = train_cfg(arch, n_layers)
        p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU_RC,
                               "cpu", master=True)
        p_dev = _tree_to(p_cpu, dev)
        batch = {k: torch.from_numpy(v)
                 for k, v in batch_for_arch(cfg, S, B, 0).items()}
        with ffn.record_routes() as r_cpu:
            (lc, mc), gc = loss_and_grads(cfg, p_cpu, batch, CPU_RC)
        with ffn.record_routes() as r_dev:
            (ld, md), gd = loss_and_grads(cfg, p_dev, _tree_to(batch, dev),
                                          CPU_RC)
        gc, gd = dict(tree_items(gc)), dict(tree_items(gd))
        _same_experts(f"{arch} loss_fn", r_cpu, r_dev)
        tag = f"{arch}{f' {n_layers} layers' if n_layers else ''} B{B} S{S}"
        check_close(f"{tag} loss", ld.cpu(), lc, 0.0, 1e-5)
        for k in mc:
            err = max_err(md[k].cpu(), mc[k])
            assert err <= 1e-6 + 1e-5 * float(mc[k].abs()), (tag, k, err)
        worst, where = _worst_grad(gc, gd)
        log(f"  {tag}: metrics {sorted(mc)} ok; {len(gc)} gradients, worst "
            f"max|err| / max|g| {worst:.2e} ({where}; tol {GRAD_RTOL:.0e}) "
            f"{'ok' if worst <= GRAD_RTOL else 'FAIL'}")
        assert worst <= GRAD_RTOL, (tag, where, worst)
        out[tag] = worst
        if n_layers:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                _, g32 = loss_and_grads(cfg, p_dev, _tree_to(batch, dev),
                                        CPU_RC)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            control, where = _worst_grad(gc, dict(tree_items(g32)))
            log(f"  {tag} with TF32 on (control): worst max|err| / max|g| "
                f"{control:.2e} ({where}), above the bound "
                f"{'ok' if control > GRAD_RTOL else 'FAIL'}")
            assert control > GRAD_RTOL, (tag, where, control)
            out[f"{tag} TF32 on (control)"] = control
            del g32
        del p_dev, gd
    torch.cuda.empty_cache()
    return out


def _refuses(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except RuntimeError as e:
        if "no backward" in str(e):
            return
        raise
    raise AssertionError(f"{fn.__name__} ran on inputs that require grad")


def phase_train_fault(dev) -> None:
    """10 (b): each kernel wrapper, given CUDA inputs that require grad
    under grad mode, raises; one ``make_train_step`` call launches no
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for_arch
    from repro_torch.kernels import _build, ops
    from repro_torch.models.common import CPU_RC
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import trainer
    log("phase 10 (b): the kernel wrappers refuse inputs that require grad")

    def r(*shape):
        return torch.randn(shape, device=dev).requires_grad_(True)
    _refuses(ops.flash_attention_tpu, r(1, 2, 64, 64), r(1, 2, 64, 64),
             r(1, 2, 64, 64))
    _refuses(ops.decode_attention_tpu, r(1, 2, 64), r(1, 2, 64, 64),
             r(1, 2, 64, 64), 3)
    _refuses(ops.rglru_scan_tpu, r(1, 8, 64), r(1, 8, 64), r(1, 64))
    _refuses(ops.systolic_gemm, r(128, 128), r(128, 128))
    _refuses(ops.gemm_partial, r(128, 128), r(128, 128),
             torch.zeros(128, 128, device=dev), 0, 1, bk=128)
    cfg = get_config("tinyllama-1.1b-smoke")
    params, opt = trainer.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), CPU_RC, OptConfig(),
        device=dev)
    before = dict(_build.LAUNCHES)
    trainer.make_train_step(cfg, CPU_RC, OptConfig())(
        params, opt, batch_for_arch(cfg, 16, 2, 0))
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before, (before, _build.LAUNCHES)
    log("  all five raise; make_train_step launched no kernel ok")


def train_flops(cfg, n_params, B, S) -> float:
    """The model's arithmetic a training step: 6 x parameters x tokens
    (forward and backward of every weight product, the embedding
    lookup counted as one) plus attention's QK^T and PV over the full S x
    S scores that the blocked attention computes (fwd + bwd: 3 x 4 B H S^2
    dh a layer)."""
    return 6.0 * n_params * B * S + \
        12.0 * cfg.n_layers * B * cfg.n_heads * S * S * cfg.dh


def profile_train_step(cfg, rc, opt_cfg, step_fn, params, opt, batch) -> dict:
    """Where a training step's time goes: the gradients
    (``loss_and_grads``: forward, recompute, backward) and the AdamW
    update timed apart, synchronised; then one more step under
    torch.profiler: the card's busy time (the sum of its kernels' and
    copies' device time) against the step's wall time, and the kernels
    that take the most of it.  Every result is dropped."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw_update
    from repro_torch.pytree import tree_leaves
    from repro_torch.runtime.trainer import loss_and_grads
    dev = tree_leaves(params)[0].device
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = loss_and_grads(cfg, params, tb, rc)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = adamw_update(params, grads, opt, opt_cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads, out
    split = {"grads_ms": (t1 - t0) * 1e3, "adamw_ms": (t2 - t1) * 1e3}
    log(f"  gradients (forward, recompute, backward) {split['grads_ms']:.1f} "
        f"ms, AdamW update {split['adamw_ms']:.1f} ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step_fn(params, opt, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    del out
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    rec = {**split, "profiled_step_wall_ms": wall, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall,
           "device_ops": sum(e.count for e in kernels),
           "top_kernels_ms": {f"{e.key[:70]} (x{e.count})":
                              _device_us(e) / 1e3 for e in top}}
    log(f"  one profiled step: wall {wall:.1f} ms (profiler on), card busy "
        f"{busy:.1f} ms in {rec['device_ops']} kernels and copies, idle "
        f"share {rec['device_idle_share']:.3f}")
    for name, ms in rec["top_kernels_ms"].items():
        log(f"    {ms:8.2f} ms  {name}")
    return rec


def phase_train_full(dev, card, power, arch="tinyllama-1.1b", batch=8,
                     seq=512, steps=8, prompt=512, max_len=1024,
                     decode_steps=8) -> dict:
    """10 (c) full-width, full-depth training in bf16 on fp32 master
    weights with bf16 moments, ``steps`` steps of ``batch`` x ``seq``
    tokens through ``make_train_step``; (d) the trained weights in their
    serving placement through ``make_prefill_step`` (flash kernel) and
    ``make_decode_step`` (decode kernel), teacher-forced, against
    ``forward`` at the same positions.  Returns the record and the (d)
    launches."""
    from repro_torch.configs.base import _pattern_for
    from repro_torch.data import batch_for_arch
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.models.common import RuntimeConfig
    from repro_torch.optim import OptConfig
    from repro_torch.pytree import tree_items, tree_leaves
    from repro_torch.runtime import trainer
    cfg, rc = train_cfg(arch), RuntimeConfig()
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    log(f"phase 10 (c): {cfg.name} full width, {cfg.n_layers} layers, bf16 "
        f"compute on fp32 master weights, bf16 moments, {steps} steps of "
        f"{batch} x {seq} tokens")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = trainer.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), rc, opt_cfg,
        device=dev)
    n_params = sum(v.numel() for v in tree_leaves(params))
    first = _tree_to(params, "cpu")
    step_fn = trainer.make_train_step(cfg, rc, opt_cfg)
    before = dict(_build.LAUNCHES)
    times, losses, gnorms, lrs = [], [], [], []
    for s in range(steps):
        b = batch_for_arch(cfg, seq, batch, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        log(f"  step {s}: loss {losses[-1]:.4f} gnorm {gnorms[-1]:.3f} lr "
            f"{lrs[-1]:.2e} {times[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_train_step(cfg, rc, opt_cfg, step_fn, params, opt,
                              batch_for_arch(cfg, seq, batch, steps))
    assert _build.LAUNCHES == before, (before, _build.LAUNCHES)
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), \
        (losses, gnorms)
    for (path, new), old in zip(tree_items(params), tree_leaves(first)):
        assert new.dtype == torch.float32, (path, new.dtype)
        assert not torch.equal(new.cpu(), old), f"{path} did not change"
    assert {v.dtype for v in tree_leaves(opt["m"])} == {torch.bfloat16}
    med = statistics.median(times[1:])
    flops = train_flops(cfg, n_params, batch, seq)
    rec = {"arch": cfg.name, "params": n_params, "batch": batch, "seq": seq,
           "steps": steps, "losses": losses, "grad_norms": gnorms,
           "lrs": lrs, "step_ms": times, "median_step_ms_after_step_1": med,
           "tokens_per_s": batch * seq / med * 1e3,
           "peak_memory_gib": peak / 2 ** 30,
           "model_tflop_per_step": flops / 1e12,
           "share_of_989_tflops": flops / (med * 1e-3) / PEAK_BF16,
           "profile": prof, "card": card, "power_limit": power}
    log(f"  {n_params / 1e9:.3f} B parameters, every leaf changed and fp32; "
        f"median step {med:.1f} ms after step 1 (first {times[0]:.1f} ms), "
        f"{rec['tokens_per_s']:.0f} tokens/s, peak card memory "
        f"{rec['peak_memory_gib']:.2f} GiB, {flops / 1e12:.2f} TFLOP a step "
        f"= {rec['share_of_989_tflops']:.3f} of 989 TFLOP/s; no kernel "
        "launched ok")

    log(f"phase 10 (d): the trained weights served through the kernels, a "
        f"{prompt}-token prompt (max_len {max_len}) and {decode_steps} "
        "teacher-forced decode steps against forward")
    with torch.no_grad():
        serve = lm.place_params(params, rc, dev)
    del params, opt
    torch.cuda.empty_cache()
    toks = torch.from_numpy(batch_for_arch(cfg, max_len, 1, 1000)["tokens"])
    n_attn = _pattern_for(cfg).count("attn")
    _build.reset_launches()
    logits, cache = trainer.make_prefill_step(cfg, rc, max_len=max_len)(
        serve, {"tokens": toks[:, :prompt]})
    torch.cuda.synchronize()
    n_flash = _build.LAUNCHES["flash_attention"]
    assert n_flash == n_attn and _build.LAUNCHES["decode_attention"] == 0, \
        _build.LAUNCHES
    outs = [logits]
    decode = trainer.make_decode_step(cfg, rc)
    _build.reset_launches()
    for t in range(decode_steps):
        logits, cache = decode(serve, toks[:, prompt + t].to(dev), cache)
        outs.append(logits)
    torch.cuda.synchronize()
    n_decode = _build.LAUNCHES["decode_attention"]
    assert n_decode == n_attn * decode_steps and \
        _build.LAUNCHES["flash_attention"] == 0, _build.LAUNCHES
    with torch.no_grad():
        full, _ = lm.forward(cfg, serve, {"tokens": toks}, rc)
        untrained, _ = lm.forward(cfg, lm.place_params(first, rc, dev),
                                  {"tokens": toks}, rc)
    del first

    def rel_err(got, want):
        return max_err(got, want) / float(want.float().abs().max())
    errs, rel, control, nxt = [], [], [], []
    for i, got in enumerate(outs):
        pos = prompt - 1 + i
        got, want = got.float().cpu(), full[:, pos].float().cpu()
        errs.append(check_close(f"position {pos} logits", got, want, 0.0,
                                TRAIN_SERVE_TOL))
        rel.append(rel_err(got, want))
        control.append(rel_err(got, untrained[:, pos].cpu()))
        if i + 1 < len(outs):
            nxt.append(rel_err(got, full[:, pos + 1].cpu()))
    same = sum(int(torch.equal(o.argmax(-1).cpu(),
                               full[:, prompt - 1 + i].argmax(-1).cpu()))
               for i, o in enumerate(outs))
    log(f"  flash {n_flash} launches a prefill, decode {n_decode} in "
        f"{decode_steps} steps ({n_attn} a step); greedy token equal at "
        f"{same} of {len(outs)} positions; max|err| / max|logit| "
        f"{max(rel):.2e} (tol {TRAIN_SERVE_TOL:.0e})")
    log(f"  control, against forward on the weights before training: "
        f"max|err| / max|logit| at least {min(control):.2e}, above the "
        f"bound {'ok' if min(control) > TRAIN_SERVE_TOL else 'FAIL'}; "
        f"against forward's next position: {min(nxt):.2e} – "
        f"{max(nxt):.2e}")
    assert min(control) > TRAIN_SERVE_TOL, control
    rec.update(serve_max_logit_err=max(errs), serve_max_rel_err=max(rel),
               serve_untrained_min_rel_err=min(control),
               serve_next_position_rel_err=[min(nxt), max(nxt)],
               serve_argmax_equal=same, serve_positions=len(outs),
               serve_flash_launches=n_flash, serve_decode_launches=n_decode)
    del serve, cache, full, untrained
    torch.cuda.empty_cache()
    return rec, {"flash_attention": n_flash, "decode_attention": n_decode}


def _train_lines(out: str) -> dict:
    """{step: loss} of launch/train.py's ``step ... loss=`` lines."""
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+) loss=(\S+) ", out, re.M)}


def phase_train_resume(dev, arch="tinyllama-1.1b", n_layers=2, batch=4,
                       seq=128, steps=4, every=2) -> dict:
    """10 (e): ``repro_torch.launch.train`` on ``arch`` cut to
    ``n_layers`` at full width: ``steps`` steps saving every ``every``,
    then a second process resuming from step ``every`` (its checkpoint
    alone copied beside it) runs to ``steps``.  The digest of the state
    the first process held when it saved step ``every``, of the arrays on
    disk, and of the state the second process restored on the card are
    equal; the resumed losses equal the uninterrupted run's within
    RESUME_LOSS_TOL."""
    from repro_torch.models.common import RuntimeConfig
    from repro_torch.optim import OptConfig
    from repro_torch.pytree import tree_items
    from repro_torch.runtime import trainer
    log(f"phase 10 (e): launch/train.py on {arch} cut to {n_layers} layers, "
        f"{steps} steps saving every {every}, then a resumed process")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        def run(ckpt):
            cmd = [sys.executable, "-c", TRAIN_CLI, str(n_layers), "--arch",
                   arch, "--steps", str(steps), "--batch", str(batch),
                   "--seq", str(seq), "--log-every", "1", "--ckpt-every",
                   str(every), "--ckpt-dir", str(ckpt), "--device", dev.type]
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=600, env=dict(
                                   os.environ, PYTHONPATH=str(ROOT / "src")))
            assert p.returncode == 0, p.stdout + p.stderr
            return p.stdout
        t0 = time.perf_counter()
        full = run(tmp / "a")
        saved = tmp / "a" / f"step_{every:08d}"
        shutil.copytree(saved, tmp / "b" / saved.name)
        resumed = run(tmp / "b")
        wall = time.perf_counter() - t0
        assert f"resumed from step {every}" in resumed, resumed
        la, lb = _train_lines(full), _train_lines(resumed)
        assert sorted(la) == list(range(steps)), full
        assert sorted(lb) == list(range(every, steps)), resumed
        diff = max(abs(lb[s] - la[s]) for s in lb)
        assert diff <= RESUME_LOSS_TOL, (la, lb)
        held = dict(re.findall(r"^saved (\d+) (\w+)$", full, re.M))
        got = re.search(rf"^restored {every} (\w+) (\S+)$", resumed, re.M)
        assert held.keys() == {str(s) for s in range(every, steps + 1, every)}
        assert got and got.group(2) == dev.type, resumed
        # the arrays on disk, in the state's order, as the manifest names
        # their dtypes
        cfg = train_cfg(arch, n_layers)
        p_meta, o_meta = trainer.init_train_state(
            cfg, torch.Generator(), RuntimeConfig(), OptConfig(),
            device="meta")
        manifest = json.loads((saved / "manifest.json").read_text())
        assert manifest["extra"] == {"data_step": every}
        disk = []
        for group, tmpl in (("opt", o_meta), ("params", p_meta)):
            with np.load(saved / f"{group}.npz") as z:
                for path, _ in tree_items(tmpl):
                    disk.append((f"{group}/{path}", z[path],
                                 manifest["groups"][group][path]["dtype"]))
        on_disk = state_digest(disk)
        assert held[str(every)] == on_disk == got.group(1), \
            (held, on_disk, got.group(1))
        log(f"  the state held at step {every}, its {len(disk)} arrays on "
            f"disk and the state restored on the {dev.type} by the resumed "
            f"process: one sha256 ({on_disk[:16]}...) ok; resumed losses "
            f"{lb} against {la}: max |diff| {diff:.1e} (tol "
            f"{RESUME_LOSS_TOL}) ok; {wall:.1f} s for both processes")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"arch": f"{arch} {n_layers} layers", "batch": batch, "seq": seq,
            "uninterrupted": la, "resumed": lb, "max_loss_diff": diff,
            "arrays_equal": len(disk), "state_sha256": on_disk,
            "wall_s": wall}


def phase_train(dev, card, power) -> dict:
    """Phase 10: (a) gradients card vs CPU, (b) the wrappers' refusal,
    (c) + (d) full TinyLlama-1.1B training and serving its weights, (e)
    resume through launch/train.py.  Prints the ``{"train": ...}`` line and
    returns the (d) launches."""
    t0 = time.perf_counter()
    rec = {"grads_worst_rel_err": phase_train_grads(dev)}
    phase_train_fault(dev)
    full, launches = phase_train_full(dev, card, power)
    rec.update(full)
    rec["resume"] = phase_train_resume(dev)
    rec["phase10_s"] = time.perf_counter() - t0
    RECORD["train"] = rec
    log(json.dumps({"train": rec}))
    return launches


# ---------------------------------------------------------------------------
# 11. the lockstep engine's devices > 1, the dry run, and the sharded steps
#     (runs after 10, before the timing of 6)
# ---------------------------------------------------------------------------

# the FULL corpus's shard counts; the dry-run cells on the 16x16 mesh
# (the prefill cells shard the residual's sequence over 'model');
# full-width tinyllama-1.1b's two cells on the card, only the global
# batch cut (from 32 and 128); the dry run's peak against the card's
PHASE11_DEVICES = (1, 2, 4)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"),
                ("tinyllama-1.1b", "decode_32k"),
                ("qwen1.5-110b", "decode_32k"),
                ("tinyllama-1.1b", "prefill_32k"),
                ("deepseek-v2-lite-16b", "prefill_32k"),
                ("recurrentgemma-2b", "prefill_32k"))
SHARDED_ARCH = "tinyllama-1.1b"
SHARDED_CELLS = (("prefill_32k", 2), ("decode_32k", 16))
# (d): train_4k's 4096 tokens a sequence, its global batch cut from 256
SHARDED_TRAIN_BATCH = 2
PEAK_RATIO = (0.8, 1.25)


def phase_devices(dev) -> dict:
    """(a) The FULL corpus at ``PHASE11_DEVICES`` shards (each its own
    runner, graph and stream on the card): every run's rows equal the
    pin; points/s from a run with every graph already captured (a second
    run, unless phase 8 left the runners captured).  Then
    ``lockstep_kernel_count`` against phase 8's profiled kernels a step."""
    from repro_torch.core import simulator_jit as sj
    from repro_torch.core.scheduler import Policy
    lib = sim_library()
    ts, seeds = sim_corpus(lib, **SIM_FULL)
    out = {}
    for d in PHASE11_DEVICES:
        runs = []
        while not runs or runs[-1]["captures"]:
            assert len(runs) < 2, runs
            sj.reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            ms = sj.simulate_jbatch(ts, lib, Policy.mesc(), seeds=seeds,
                                    duration=SIM_FULL_DURATION, device=dev,
                                    devices=d)
            _sync(dev)
            wall = time.perf_counter() - t0
            assert sj.metrics_digest(ms) == SIM_PINS["full/sampled"], d
            runs.append(dict(sj.COUNTS, wall_s=wall,
                             points_per_s=len(ts) / wall))
        out[d] = runs[-1]
        log(json.dumps({"lockstep_devices": dict(
            runs[-1], devices=d, points=len(ts), digest_ok=True,
            first_run_s=runs[0]["wall_s"] if len(runs) > 1 else None)}))
    n = sj.lockstep_kernel_count(ts, lib, Policy.mesc(), seeds=seeds,
                                 duration=SIM_FULL_DURATION, device=dev)
    prof = RECORD["lockstep"]["profile"]
    profiled = prof["kernel_launches_per_step"]
    log(f"  lockstep_kernel_count {n}, profiled {profiled} kernel "
        "launches a step (a fresh process)")
    assert n == profiled, (n, profiled)
    return {"runs": out, "kernel_count": n, "profiled": profiled}


def phase_dryrun_cells() -> list:
    """(b) The dry run of ``DRYRUN_CELLS`` on the fake 16x16 mesh, on the
    host: one ``{"dryrun": ...}`` line each."""
    from repro_torch.launch import dryrun
    recs = []
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, False, probe=False)
        assert rec["status"] == "ok", rec.get("error")
        line = {"arch": arch, "shape": shape, "mesh": rec["mesh"],
                "status": rec["status"],
                "argument_gib": rec["argument_size_in_bytes"] / 2 ** 30,
                "peak_gib": rec["per_device_hbm_bytes"] / 2 ** 30,
                "fits_80gib": rec["fits_80gib"],
                "flops_per_device": rec["flops_per_device"],
                "collectives": {k: v["count"]
                                for k, v in rec["collectives"].items()},
                "collective_link_gib": rec["collective_link_bytes"] / 2 ** 30,
                "wall_s": rec["wall_seconds"], "host_cpus": os.cpu_count()}
        log(json.dumps({"dryrun": line}))
        recs.append(line)
    return recs


def _tensor_bytes(*trees) -> int:
    from repro_torch.pytree import tree_leaves
    n = 0
    for tree in trees:
        for t in (tree_leaves(tree) if isinstance(tree, dict) else [tree]):
            if isinstance(t, torch.Tensor):
                n += t.numel() * t.element_size()
    return n


def _sharded_inputs(cfg, shape, rc, dev, seed: int = 0):
    """(batch or tokens, cache or None) of one cell on the card, from a
    seed: prompts of the cell's length, or one token a sequence and a
    zero cache at its last position."""
    from repro_torch.models import lm
    gen = torch.Generator(device=dev).manual_seed(seed)
    if shape.kind == "prefill":
        return {"tokens": torch.randint(0, cfg.vocab, (
            shape.global_batch, shape.seq_len), generator=gen,
            device=dev)}, None
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, rc, dev)
    cache["pos"] = shape.seq_len - 1
    return torch.randint(0, cfg.vocab, (shape.global_batch,),
                         generator=gen, device=dev), cache


def phase_sharded_cell(dev, kind_name: str, batch: int) -> dict:
    """(c) One cell of full-width ``SHARDED_ARCH`` on the card: (i) the
    step plainly, its peak card memory from a reset; (ii) the same step
    on DTensors under ``axis_rules`` on a 1-rank (1, 1) CUDA mesh:
    logits and cache bit-equal to (i), and one kernel launch a layer;
    (iii) the port's dry run of the cell on a 1-rank mesh: argument bytes
    equal to the real tensors', its peak within ``PEAK_RATIO`` of (i)'s."""
    import gc
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.trainer import make_decode_step, \
        make_prefill_step

    cfg = get_config(SHARDED_ARCH)
    shape = dataclasses.replace(SHAPES_BY_NAME[kind_name],
                                global_batch=batch)
    rc = dryrun.cell_rc(SHARDED_ARCH, shape.kind)
    mode = dryrun.cell_mode(SHARDED_ARCH, shape.name)
    step = make_prefill_step(cfg, rc) if shape.kind == "prefill" \
        else make_decode_step(cfg, rc)
    kernel = "flash_attention" if shape.kind == "prefill" \
        else "decode_attention"
    gc.collect()
    torch.cuda.empty_cache()
    _sync(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            rc, dev)
    inp, cache = _sharded_inputs(cfg, shape, rc, dev)
    args_bytes = _tensor_bytes(params, inp, cache or {})
    _sync(dev)
    t0 = time.perf_counter()
    if shape.kind == "prefill":
        logits, out_cache = step(params, inp)
    else:
        logits, out_cache = step(params, inp, cache)
    _sync(dev)
    plain_s = time.perf_counter() - t0
    cuda_peak = torch.cuda.max_memory_allocated(dev) - base

    # (ii) the same step on a (1, 1) mesh
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = sh.AxisRules(mesh, sequence_parallel=True, mode=mode)
        dparams = sh.distribute(params, sh.param_specs(params, rules), mesh)
        inp2, cache2 = _sharded_inputs(cfg, shape, rc, dev)
        _build.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        with sh.axis_rules(rules), implicit_replication():
            if shape.kind == "prefill":
                dbatch = sh.distribute(inp2, sh.batch_specs(inp2, rules),
                                       mesh)
                dlogits, dcache = step(dparams, dbatch)
            else:
                dtok = sh.distribute({"t": inp2}, sh.batch_specs(
                    {"t": inp2}, rules), mesh)["t"]
                dcache = sh.distribute(cache2, sh.cache_specs(cache2, rules),
                                       mesh)
                dlogits, dcache = step(dparams, dtok, dcache)
        _sync(dev)
        sharded_s = time.perf_counter() - t0
        launches = _build.LAUNCHES[kernel]
        assert launches == cfg.n_layers, (kernel, launches)
        assert torch.equal(dlogits.to_local(), logits), \
            max_err(dlogits.to_local(), logits)
        for k in ("ck", "cv"):
            assert torch.equal(dcache[k].to_local(), out_cache[k]), k
        assert dcache["pos"] == out_cache["pos"]
    finally:
        dist.destroy_process_group()
    del params, inp, cache, logits, out_cache, dparams, inp2, cache2, \
        dlogits, dcache
    gc.collect()
    torch.cuda.empty_cache()

    # (iii) the port's dry run of the cell on a 1-rank mesh
    rec = dryrun.measure_cell(SHARDED_ARCH, shape, (1, 1),
                              ("data", "model"), mode=mode, rc=rc)
    assert rec["argument_size_in_bytes"] == args_bytes, \
        (rec["argument_size_in_bytes"], args_bytes)
    ratio = rec["per_device_hbm_bytes"] / cuda_peak
    out = {"arch": SHARDED_ARCH, "shape": shape.name,
           "global_batch": shape.global_batch,
           "reduced": {"global_batch": [SHAPES_BY_NAME[kind_name]
                                        .global_batch, batch]},
           "plain_s": plain_s, "sharded_s": sharded_s,
           "launches": {kernel: launches}, "bit_equal": True,
           "argument_bytes": args_bytes, "cuda_peak_bytes": cuda_peak,
           "dryrun_peak_bytes": rec["per_device_hbm_bytes"],
           "peak_ratio": ratio, "dryrun_wall_s": rec["wall_seconds"],
           "dryrun_flops": rec["flops_per_device"]}
    log(json.dumps({"sharded_cell": out}))
    lo, hi = PEAK_RATIO
    assert lo <= ratio <= hi, ratio
    return out


def phase_sharded_train(dev) -> dict:
    """(d) One train step of full-width ``SHARDED_ARCH`` (train_4k's
    ``dryrun.cell_rc``: bf16 compute on fp32 master weights, remat
    "full", sequence-parallel; its optimizer and 2d mode) plainly, then
    on DTensors under ``axis_rules`` on a 1-rank (1, 1) CUDA mesh, from
    the same parameters, optimizer state and batch: the loss, every
    updated leaf and every moment bit-equal, and no kernel launched (the
    training forward runs the kernels' differentiable twins)."""
    import gc
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.data import batch_for_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.pytree import tree_items
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.trainer import init_train_state, \
        make_train_step

    cfg = get_config(SHARDED_ARCH)
    full = SHAPES_BY_NAME["train_4k"]
    shape = dataclasses.replace(full, global_batch=SHARDED_TRAIN_BATCH)
    rc = dryrun.cell_rc(SHARDED_ARCH, "train")
    opt_cfg = dryrun.cell_opt(SHARDED_ARCH)
    mode = dryrun.cell_mode(SHARDED_ARCH, shape.name)
    log(f"phase 11 (d): {cfg.name} full width, one train step of "
        f"{shape.global_batch} x {shape.seq_len} tokens, plain and on a "
        f"1-rank mesh ({mode} mode, sequence-parallel)")
    gc.collect()
    torch.cuda.empty_cache()
    params, opt = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), rc, opt_cfg,
        device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_for_arch(
        cfg, shape.seq_len, shape.global_batch, 0).items()}
    step = make_train_step(cfg, rc, opt_cfg,
                           microbatches=dryrun.cell_microbatches(
                               SHARDED_ARCH, "train"))

    def timed(*args):
        _build.reset_launches()
        _sync(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = step(*args)
        _sync(dev)
        sec = time.perf_counter() - t0
        launches = sum(_build.LAUNCHES.values())
        assert launches == 0, dict(_build.LAUNCHES)
        return out, sec, torch.cuda.max_memory_allocated(dev) - base

    (want_p, want_o, want_m), plain_s, plain_peak = timed(params, opt, batch)
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = sh.AxisRules(mesh, sequence_parallel=True, mode=mode)
        p_spec = sh.param_specs(params, rules)
        o_spec = {k: p_spec if k in ("m", "v") else sh.replicated(v, rules)
                  for k, v in opt.items()}
        args = (sh.distribute(params, p_spec, mesh),
                sh.distribute(opt, o_spec, mesh),
                sh.distribute(batch, sh.batch_specs(batch, rules), mesh))
        with sh.axis_rules(rules), implicit_replication():
            (got_p, got_o, got_m), sharded_s, sharded_peak = timed(*args)
        assert torch.equal(got_m["loss"].to_local(), want_m["loss"]), \
            (float(got_m["loss"].to_local()), float(want_m["loss"]))
        got = dict(tree_items({"params": got_p, "opt": got_o}))
        leaves = 0
        for path, w in tree_items({"params": want_p, "opt": want_o}):
            g = got[path]
            g = g.to_local() if hasattr(g, "to_local") else g
            assert torch.equal(g, w), (path, max_err(g, w))
            leaves += 1
    finally:
        dist.destroy_process_group()
    out = {"arch": SHARDED_ARCH, "shape": shape.name,
           "global_batch": shape.global_batch, "seq_len": shape.seq_len,
           "reduced": {"global_batch": [full.global_batch,
                                        shape.global_batch]},
           "mode": mode, "loss": float(want_m["loss"]),
           "plain_s": plain_s, "sharded_s": sharded_s,
           "plain_peak_bytes": plain_peak,
           "sharded_peak_bytes": sharded_peak, "launches": 0,
           "leaves_compared": leaves, "bit_equal": True}
    log(json.dumps({"sharded_train": out}))
    del params, opt, batch, want_p, want_o, got_p, got_o, args, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


# (e): the sharded steps of tests/test_torch_device_sharding.py (serve:
# prefill and 4 decode steps) and tests/test_torch_sharded_train.py (one
# AdamW step), four gloo ranks on a (2, 2) mesh on the host, every step
# with the sequence-parallel residual.  The tests import these programs,
# so one copy runs under each machine's torch.
GLOO_SERVE_ARCHS = ("tinyllama-1.1b-smoke", "deepseek-v2-lite-16b-smoke",
                    "recurrentgemma-2b-smoke")
# (arch, cut): the cut as keyword arguments of dataclasses.replace, a
# dict value replacing fields of that sub-config
GLOO_TRAIN_CASES = [
    ("tinyllama-1.1b-smoke", {}),
    ("recurrentgemma-2b-smoke", {}),
    ("xlstm-125m-smoke", {}),
    ("llama4-maverick-400b-a17b-smoke", {}),
    ("xlstm-125m-smoke", {"n_heads": 3, "n_kv_heads": 3, "d_model": 48,
                          "xlstm": {"chunk": 8}}),
    ("recurrentgemma-2b-smoke", {"n_heads": 3, "rglru": {"d_rnn": 48}}),
    ("llama4-maverick-400b-a17b-smoke", {"moe": {"d_expert": 256}}),
]
GLOO_TRAIN_IDS = [a + ("-cut" if c else "") for a, c in GLOO_TRAIN_CASES]
# both sides sum the same terms in other orders (the sharded one over
# ranks, then locally): logits, and the loss, gradient norm and each
# gradient, to 1e-5 of their scale
GLOO_TOL = 1e-5

# one serve rank: the unsharded steps, then the same steps on DTensors
# under axis_rules; prints the max logit error of the prefill and of each
# decode step as JSON.  argv: port, rank, arch
GLOO_SERVE_RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.models.common import RuntimeConfig
from repro_torch.runtime import sharding

port, rank, arch = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
cfg = configs.get_config(arch)
rc = RuntimeConfig(compute_dtype=torch.float32, param_dtype=torch.float32,
                   sequence_parallel=True)
params = lm.init_params(cfg, torch.Generator().manual_seed(0), rc, "cpu")
toks = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (4, 16)))
want, cache = lm.prefill(cfg, params, {"tokens": toks}, rc, max_len=32)
wants, nxt = [want], toks[:, -1]
for _ in range(4):
    logits, cache = lm.decode_step(cfg, params, nxt, cache, rc)
    wants.append(logits)
    nxt = logits.argmax(-1)
mesh = make_debug_mesh(2, 2)
rules = sharding.AxisRules(mesh, sequence_parallel=True)
dparams = sharding.distribute(params, sharding.param_specs(params, rules),
                              mesh)


def batch(t):
    return sharding.distribute(
        {"t": t}, sharding.batch_specs({"t": t}, rules), mesh)["t"]


errs = []
with sharding.axis_rules(rules), implicit_replication():
    got, cache = lm.prefill(cfg, dparams, {"tokens": batch(toks)}, rc,
                            max_len=32)
    errs.append(float((got.full_tensor() - wants[0]).abs().max()))
    nxt = toks[:, -1]
    for i in range(4):
        got, cache = lm.decode_step(cfg, dparams, batch(nxt), cache, rc)
        errs.append(float((got.full_tensor() - wants[i + 1]).abs().max()))
        nxt = wants[i + 1].argmax(-1)
dist.destroy_process_group()
print(json.dumps(errs))
"""

# one train rank: the plain step, then the same step on DTensors under
# axis_rules; prints the comparison as JSON.  argv: port, rank, arch, cut
GLOO_TRAIN_RANK = """
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.data import batch_for_arch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.common import RuntimeConfig
from repro_torch.optim import OptConfig
from repro_torch.pytree import tree_items
from repro_torch.runtime import sharding
from repro_torch.runtime.trainer import init_train_state, make_train_step

port, rank, arch = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cut = json.loads(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
cfg = configs.get_config(arch)
cfg = dataclasses.replace(cfg, **{
    k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
    else v for k, v in cut.items()})
rc = RuntimeConfig(compute_dtype=torch.float32, param_dtype=torch.float32,
                   remat_policy="full", sequence_parallel=True)
opt_cfg = OptConfig(lr=3e-3, warmup_steps=2, decay_steps=10,
                    moment_dtype=torch.float32)
params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), rc,
                               opt_cfg, device="cpu")
batch = {k: torch.from_numpy(v)
         for k, v in batch_for_arch(cfg, 16, 4, 0).items()}
step = make_train_step(cfg, rc, opt_cfg)
want_p, want_o, want_m = step(params, opt, batch)

mesh = make_debug_mesh(2, 2)
rules = sharding.AxisRules(mesh, sequence_parallel=True)
p_spec = sharding.param_specs(params, rules)
o_spec = {k: p_spec if k in ("m", "v") else sharding.replicated(v, rules)
          for k, v in opt.items()}
args = (sharding.distribute(params, p_spec, mesh),
        sharding.distribute(opt, o_spec, mesh),
        sharding.distribute(batch, sharding.batch_specs(batch, rules), mesh))
with sharding.axis_rules(rules), implicit_replication():
    got_p, got_o, got_m = step(*args)


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


lr, eps, b1 = float(want_m["lr"]), opt_cfg.eps, opt_cfg.b1
got_p, got_g = dict(tree_items(got_p)), dict(tree_items(got_o["m"]))
want_g = dict(tree_items(want_o["m"]))
leaves = {}
for path, w in tree_items(want_p):
    gw, gg = want_g[path] / (1 - b1), full(got_g[path]) / (1 - b1)
    dg = (gg - gw).abs()
    implied = lr * eps * dg / (torch.minimum(gg.abs(), gw.abs()) + eps) ** 2
    dw = (full(got_p[path]) - w).abs()
    leaves["/".join(path)] = {
        "dg": float(dg.max()), "g_scale": float(gw.abs().max()),
        "dw": float(dw.max()), "over": float((dw - implied).max())}
print(json.dumps({
    "loss": [float(full(got_m["loss"])), float(want_m["loss"])],
    "grad_norm": [float(full(got_m["grad_norm"])),
                  float(want_m["grad_norm"])],
    "leaves": leaves}))
dist.destroy_process_group()
"""


def run_gloo(program: str, args, ranks: int = 4, timeout: float = 120) -> list:
    """Run ``program`` as ``ranks`` ``python -c`` processes of one gloo
    group on a free localhost port (argv: port, rank, *args) and return
    each rank's last stdout line, parsed as JSON.  Raises naming the rank
    and the end of its stderr if one fails; kills every rank left."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, path)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", program, str(port), str(r), *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"gloo rank {r} exited {p.returncode}: "
                               f"{err[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def gloo_serve_err(res) -> float:
    """The largest logit error of a serve case's ranks (5 steps each)."""
    assert all(len(errs) == 5 for errs in res), res
    return max(max(errs) for errs in res)


def gloo_train_err(res) -> float:
    """The largest error of a train case's ranks as a share of its bound:
    the loss, the gradient norm and each gradient over GLOO_TOL of their
    scale, each updated weight's excess over AdamW's implied gap over
    GLOO_TOL.  At most 1 passes."""
    worst = 0.0
    for r in res:
        got, want = r["loss"]
        worst = max(worst, abs(got - want) / (GLOO_TOL * max(1.0, abs(want))))
        got, want = r["grad_norm"]
        worst = max(worst, abs(got - want) / (GLOO_TOL * want))
        assert len(r["leaves"]) > 0
        for lf in r["leaves"].values():
            worst = max(worst, lf["dg"] / (GLOO_TOL * lf["g_scale"]),
                        lf["over"] / GLOO_TOL)
    return worst


def gloo_torch_cases(ranks: int = 4, timeout: float = 300) -> dict:
    """The 3 serve and 7 train cases of four gloo ranks on the host, as
    many cases side by side as the host's CPUs hold one rank each: the
    torch version and each case's largest error against its test's
    tolerance.  Logs nothing: ``main`` runs it on a thread of its own."""
    from concurrent.futures import ThreadPoolExecutor
    # (name, program, argv, error of the ranks' output, its limit)
    cases = ([(f"serve/{a}", GLOO_SERVE_RANK, (a,), gloo_serve_err,
               GLOO_TOL) for a in GLOO_SERVE_ARCHS]
             + [(f"train/{i}", GLOO_TRAIN_RANK, (a, json.dumps(c)),
                 gloo_train_err, 1.0)
                for i, (a, c) in zip(GLOO_TRAIN_IDS, GLOO_TRAIN_CASES)])

    def one(case):
        name, program, args, err_of, limit = case
        t0 = time.perf_counter()
        try:
            err = err_of(run_gloo(program, args, ranks, timeout))
            rec = {"case": name, "max_err": err, "limit": limit,
                   "ok": err <= limit}
        except Exception as e:  # recorded, then the phase fails
            rec = {"case": name, "ok": False,
                   "error": f"{type(e).__name__}: {e}"[-3000:]}
        rec["s"] = time.perf_counter() - t0
        return rec

    t0 = time.perf_counter()
    width = max(1, (os.cpu_count() or 1) // ranks)
    with ThreadPoolExecutor(width) as pool:
        recs = list(pool.map(one, cases))
    return {"torch": torch.__version__, "side_by_side": width,
            "host_cpus": os.cpu_count(),
            "wall_s": time.perf_counter() - t0, "cases": recs}


def phase_gloo_torch(out=None) -> dict:
    """(e) ``gloo_torch_cases`` (run here unless ``out`` is its result):
    every case must pass its test's tolerance.  One ``{"gloo_torch":
    ...}`` line with the torch version and each case's largest error."""
    out = out or gloo_torch_cases()
    log(json.dumps({"gloo_torch": out}))
    bad = [r for r in out["cases"] if not r["ok"]]
    assert not bad, bad
    return out


def phase_sharding(dev, gloo=None) -> dict:
    """Phase 11: (a) ``phase_devices``, (b) ``phase_dryrun_cells``, (c)
    ``phase_sharded_cell`` for each of ``SHARDED_CELLS``, (d)
    ``phase_sharded_train``, (e) ``phase_gloo_torch`` of ``gloo``, the
    cases' result where ``main`` ran them earlier."""
    log("phase 11: the lockstep engine's devices > 1, the dry run, and "
        "sharded steps against their dry run and on gloo ranks")
    t0 = time.perf_counter()
    out = {"devices": phase_devices(dev),
           "dryrun": phase_dryrun_cells(),
           "cells": [phase_sharded_cell(dev, k, b)
                     for k, b in SHARDED_CELLS],
           "train": phase_sharded_train(dev),
           "gloo": phase_gloo_torch(gloo)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 11: {out['wall_s']:.1f} s on {os.cpu_count()} host "
        f"CPUs")
    return out


# ---------------------------------------------------------------------------
# 6. timing at the main path's shapes
# ---------------------------------------------------------------------------

# the redesigned rows' kernel times before their redesign, when flash ran
# on FFMA, decode in two kernels, the GEMM on 64x64 tiles (FFMA for fp32,
# WMMA for bf16) and the scan one thread per channel (PERF.md's kernel
# table: this script's phase 6 on an NVIDIA H100 80GB HBM3 at 700 W);
# printed beside the new times, never in the kernels line
BEFORE_REDESIGN_MS = {"decode_attention": 0.0247, "flash_attention": 0.1891,
                      "decode_attention@recurrentgemma-2b": 0.0755,
                      "flash_attention@recurrentgemma-2b": 1.7546,
                      "gemm_partial": 0.0716, "systolic_gemm": 0.0131,
                      "rglru_scan": 0.0227}


def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flex_softcap_call(q, k, v, q_offset: int, softcap: float):
    """One PyTorch call that computes the capped chunk of phase 6:
    ``flex_attention`` (compiled, as it must be to run fused) with a
    score_mod c * tanh(s / c) on the scaled score and a causal block mask
    on q_offset + i, GQA in the call.  A yardstick only: the port never
    calls it.  Inductor's and Triton's caches go under build/."""
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    inductor_config.compile_threads = 1       # no pool of worker processes

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, qi, ki):
        return ki <= qi + q_offset

    block_mask = create_block_mask(mask_mod, None, None, q.shape[2],
                                   k.shape[2], device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(q, k, v, score_mod=score_mod, block_mask=block_mask,
                        enable_gqa=True)


def phase_timing(dev, launches, card, power):
    """``launches`` maps each row to the count of its path's run: the
    tinyllama, recurrentgemma-2b and deepseek-v2-lite-16b 512-token MESC
    runs, the llava-next-34b 8-token MESC run, the musicgen-large prefill
    and decode, the preemptible GEMM."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_tpu
    from repro_torch.kernels.flash_attention import flash_attention_tpu
    from repro_torch.kernels import rglru_scan
    from repro_torch.kernels.rglru_scan import (launch_plan, rglru_scan_tpu,
                                                scan_plan)
    from repro_torch.kernels.systolic_gemm import (gemm_partial, gemm_plan,
                                                   systolic_gemm)
    F = torch.nn.functional
    log("phase 6: kernel times at the main path's shapes (device time: "
        "median of 30 CUDA-graph replays of 10 calls, CUDA events)")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []

    def row(name, source, replaces, kern, plain, lib, flops, nbytes, peak,
            tol, shape):
        err = max_err(kern(), plain())
        assert err <= tol, (name, err, tol)
        bound_ms, bound_by = _bound(flops, nbytes, peak)
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "tpu_kernel": replaces,
             "launches": launches[name], "max_abs_err": err, "tol": tol,
             "ms": cuda_time_ms(kern), "plain_ms": cuda_time_ms(plain),
             "library_ms": cuda_time_ms(lib) if lib else None,
             "bound_ms": bound_ms, "bound_by": bound_by, "shape": shape,
             "card": card, "power_limit": power}
        r["kernel_ms"] = r["ms"]
        r["call_ms"] = host_call_ms(kern)
        rows.append(r)
        log(f"  {name} {shape}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, host "
            f"call {r['call_ms']:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}), max|err| {err:.2e}")
        if r["library_ms"]:
            log(f"    {r['ms'] / r['library_ms']:.2f}x the library call")
        if name in BEFORE_REDESIGN_MS:
            before = BEFORE_REDESIGN_MS[name]
            log(f"    before the redesign: {before} ms, "
                f"{before / r['ms']:.1f}x this kernel's time")

    def decode_row(name, Hq, Hkv, dh, S, pos, note):
        """One layer's decode attention; the library call gets the KV
        heads repeated to Hq beforehand."""
        q = randn((1, Hq, dh), gen, bf)
        kc = randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        vc = randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        live = pos + 1
        kr = kc[:, :, :live].repeat_interleave(Hq // Hkv, dim=1)
        vr = vc[:, :, :live].repeat_interleave(Hq // Hkv, dim=1)
        row(name, "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:59",
            lambda: decode_attention_tpu(q, kc, vc, pos),
            lambda: ref.decode_attention_ref(q, kc, vc, pos),
            lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr),
            4 * Hq * live * dh, 2 * (2 * Hkv * live * dh + 2 * Hq * dh),
            PEAK_BF16, ATTN_TOL[bf],
            f"q 1x{Hq}x{dh}, cache 1x{Hkv}x{S}x{dh} bf16, pos {pos}{note}")

    def flash_row(name, Hq, Hkv, dh, S, window, note):
        """One layer of an S-token prefill; the library call gets the
        KV heads repeated to Hq beforehand.  At S <= window the band is
        the causal triangle, so SDPA's causal call is the same function."""
        assert S <= window or window == 0
        q = randn((1, S, Hq, dh), gen, bf).transpose(1, 2)
        k = randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        v = randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        pairs = S * (S + 1) // 2
        kr = k.repeat_interleave(Hq // Hkv, dim=1)
        vr = v.repeat_interleave(Hq // Hkv, dim=1)
        row(name, "src/repro_torch/kernels/csrc/flash_attention_mma.cu",
            "src/repro/kernels/flash_attention.py:64",
            lambda: flash_attention_tpu(q, k, v, window=window),
            lambda: ref.flash_attention_ref(q, k, v, window=window),
            lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
            4 * Hq * pairs * dh,
            2 * (2 * Hq * S * dh + 2 * Hkv * S * dh), PEAK_BF16,
            ATTN_TOL[bf], f"q 1x{Hq}x{S}x{dh}, kv 1x{Hkv}x{S}x{dh} bf16, "
            f"causal{note}")

    # gemm_partial: the preemptible GEMM's resume call, K blocks [3, 8) of
    # 1024^3 fp32 with bk 128 (K range 640); the HI product 128^3
    for shape in ((1024, 1024, 640), (128, 128, 128)):
        plan = gemm_plan(*shape, torch.float32)
        log(f"  gemm plan M, N, K = {shape} fp32: {plan.route}, tile "
            f"{plan.bm}x{plan.bn}, {plan.blocks} blocks")
        RECORD.setdefault("gemm_plans", {})[str(shape)] = str(plan)
    M = K = N = 1024
    A, B = randn((M, K), gen), randn((K, N), gen)
    acc = randn((M, N), gen)
    kr = 640
    row("gemm_partial", "src/repro_torch/kernels/csrc/gemm.cu",
        "src/repro/kernels/systolic_gemm.py:113",
        lambda: gemm_partial(A, B, acc, 3, 8, bk=128),
        lambda: ref.gemm_partial_ref(A, B, acc, 3, 8, 128),
        lambda: torch.addmm(acc, A[:, 384:], B[384:]),
        2 * M * N * kr, 4 * (M * kr + kr * N + 2 * M * N), PEAK_FP32,
        1e-2, "A 1024x1024 B 1024x1024 fp32, K blocks [3,8) of 128")
    # systolic_gemm: the preemptible GEMM's HI product, 128^3 fp32
    Ah, Bh = randn((128, 128), gen), randn((128, 128), gen)
    row("systolic_gemm", "src/repro_torch/kernels/csrc/gemm.cu",
        "src/repro/kernels/systolic_gemm.py:70",
        lambda: systolic_gemm(Ah, Bh, bm=128, bn=128, bk=128),
        lambda: ref.gemm_ref(Ah, Bh), lambda: torch.matmul(Ah, Bh),
        2 * 128 ** 3, 4 * 3 * 128 * 128, PEAK_FP32, 1e-3,
        "128x128x128 fp32")
    bf = torch.bfloat16
    # tinyllama-1.1b: one layer of the 512-token serving run (decode at its
    # last position of a 1024-slot cache; prefill of the prompt)
    decode_row("decode_attention", 32, 4, 64, 1024, 535, "")
    flash_row("flash_attention", 32, 4, 64, 512, 0, "")
    # the same layer on the second 512-token chunk of a 1024-token prompt
    # (q_offset 512, the reference's chunked prefill), plainly and with
    # Gemma 2's published score cap of 50: no model's path passes either
    # option (the reference's neither), so these rows carry the flash
    # kernel's launches on the tinyllama path.  SDPA takes the offset as a
    # boolean mask; it has no cap, so the capped row's library call is
    # flex_attention (flex_softcap_call), held to the plain version first
    from repro_torch.kernels.meta import attention_pairs
    S, Skv, off = 512, 1024, 512
    q = randn((1, S, 32, 64), gen, bf).transpose(1, 2)
    k = randn((1, Skv, 4, 64), gen, bf).transpose(1, 2)
    v = randn((1, Skv, 4, 64), gen, bf).transpose(1, 2)
    kr, vr = k.repeat_interleave(8, dim=1), v.repeat_interleave(8, dim=1)
    mask = torch.arange(Skv, device=dev)[None] <= off + torch.arange(
        S, device=dev)[:, None]
    pairs = attention_pairs(S, Skv, True, 0, off)
    for name, cap, lib in [
            ("flash_attention@chunk512", None,
             lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                    attn_mask=mask)),
            ("flash_attention@chunk512_softcap50", 50.0,
             flex_softcap_call(q, k, v, off, 50.0))]:
        launches[name] = launches["flash_attention"]
        if cap:
            check_close(f"{name}: flex_attention against the plain version",
                        lib(), ref.flash_attention_ref(
                            q, k, v, q_offset=off, softcap=cap),
                        ATTN_TOL[bf])
        row(name, "src/repro_torch/kernels/csrc/flash_attention_mma.cu",
            "src/repro/kernels/flash_attention.py:64",
            lambda: flash_attention_tpu(q, k, v, q_offset=off, softcap=cap),
            lambda: ref.flash_attention_ref(q, k, v, q_offset=off,
                                            softcap=cap),
            lib, 4 * 32 * pairs * 64,
            2 * (2 * 32 * S * 64 + 2 * 4 * Skv * 64), PEAK_BF16,
            ATTN_TOL[bf], f"q 1x32x{S}x64, kv 1x4x{Skv}x64 bf16, q_offset "
            f"{off}" + (f", softcap {cap:g}" if cap else ""))
    rows[-1]["library"] = ("flex_attention (torch.compile): tanh "
                           "score_mod, offset causal block mask")
    # recurrentgemma-2b: the same run's shapes on the hybrid's attention
    # layers (2048-slot window ring, ring position 535; 512-token prefill
    # inside the 2048 window) and its RG-LRU prefill scan
    decode_row("decode_attention@recurrentgemma-2b", 10, 1, 256, 2048, 535,
               ", window ring")
    flash_row("flash_attention@recurrentgemma-2b", 10, 1, 256, 512, 2048,
              ", window 2048")
    # llava-next-34b: a layer of the 1024-position prefixed prefill (576
    # patches + 448 text tokens) and of decode at cache position 535, GQA
    # 56/8 (G 7: head groups of 4 + 3); musicgen-large: a layer of the
    # 512-token prefill and of decode at 535, MHA 32/32 at dh 64
    for name, Hq, Hkv, dh, S in FAMILY_SHAPES:
        flash_row(f"flash_attention@{name}", Hq, Hkv, dh, S, 0, "")
        decode_row(f"decode_attention@{name}", Hq, Hkv, dh, 1024, 535, "")
    # deepseek-v2-lite-16b: one MLA layer of the 512-token prefill, q/k
    # head dim 192 against v 128, 16 heads; SDPA takes Ev != E as it is
    H, S, dqk, dv = 16, 512, 192, 128
    q = randn((1, S, H, dqk), gen, bf).transpose(1, 2)
    k = randn((1, S, H, dqk), gen, bf).transpose(1, 2)
    v = randn((1, S, H, dv), gen, bf).transpose(1, 2)
    pairs = S * (S + 1) // 2
    row("flash_attention@deepseek-v2-lite-16b",
        "src/repro_torch/kernels/csrc/flash_attention_mma.cu",
        "src/repro/kernels/flash_attention.py:64",
        lambda: flash_attention_tpu(q, k, v),
        lambda: ref.flash_attention_ref(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        2 * H * pairs * (dqk + dv), 2 * H * S * (2 * dqk + 2 * dv),
        PEAK_BF16, ATTN_TOL[bf],
        f"q 1x{H}x{S}x{dqk}, k 1x{H}x{S}x{dqk}, v 1x{H}x{S}x{dv} bf16, "
        "causal")
    Bs, S, D = 1, 512, 2560
    a = torch.rand((Bs, S, D), generator=gen, device=dev) * 0.599 + 0.4
    b, h0 = randn((Bs, S, D), gen), randn((Bs, D), gen)
    plan = scan_plan(
        Bs, S, D, a_ptr=a.data_ptr(), b_ptr=b.data_ptr(),
        n_sm=torch.cuda.get_device_properties(dev).multi_processor_count)
    log(f"  rglru plan B, S, D = {(Bs, S, D)}: C {plan.channels}, T "
        f"{plan.steps}, {plan.stages} stages, {plan.route}, {plan.blocks} "
        f"blocks, {plan.smem_bytes} bytes of shared memory")
    RECORD["scan_plan"] = str(plan)
    # no single PyTorch call computes a linear recurrence: library_ms null;
    # the kernel equals the plain version bit for bit: tolerance 0
    row("rglru_scan", "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan.py:42",
        lambda: rglru_scan_tpu(a, b, h0),
        lambda: ref.rglru_scan_ref(a, b, h0), None,
        2 * Bs * S * D, 4 * (3 * Bs * S * D + Bs * D), PEAK_FP32, 0.0,
        f"a, b {Bs}x{S}x{D} fp32, h0 {Bs}x{D}")
    # the plan's alternatives at the same call (not main-path launches)
    sweep = []
    for c, t, st in itertools.product(rglru_scan.CHANNELS, rglru_scan.STEPS,
                                      rglru_scan.STAGES):
        alt = dataclasses.replace(plan, channels=c, steps=t, stages=st)
        e = {"channels": c, "steps": t, "stages": st, "route": alt.route,
             "blocks": alt.blocks, "plan": alt == plan,
             "ms": cuda_time_ms(lambda: launch_plan(a, b, h0, alt))}
        sweep.append(e)
        log(f"  scan sweep C {c:2d} T {t:3d} stages {st} ({alt.route}, "
            f"{alt.blocks} blocks): {e['ms']:.4f} ms"
            f"{'  <- the plan' if e['plan'] else ''}")
    RECORD["scan_sweep"] = {"card": card, "power_limit": power,
                            "shape": [Bs, S, D], "rows": sweep}

    # the bf16 GEMM at TinyLlama's FFN width (not main-path calls): the full
    # product W1, and the resume call of the split-3/8 chain of phase 2
    a = randn((512, 2048), gen, bf)
    w = randn((2048, 5632), gen, bf)
    acc = randn((512, 5632), gen)
    extras = []
    for name, kern, lib, lib_name, flops, nbytes in [
            ("systolic_gemm@tinyllama_w1", lambda: systolic_gemm(a, w),
             lambda: torch.matmul(a, w), "torch.matmul",
             2 * 512 * 2048 * 5632,
             2 * (512 * 2048 + 2048 * 5632 + 512 * 5632)),
            ("gemm_partial@tinyllama_bf16",
             lambda: gemm_partial(a, w, acc, 3, 8, bk=256),
             lambda: torch.addmm(acc, a[:, 768:], w[768:],
                                 out_dtype=torch.float32),
             "torch.addmm(out_dtype=float32)", 2 * 512 * 1280 * 5632,
             2 * (512 * 1280 + 1280 * 5632) + 4 * 2 * 512 * 5632)]:
        _, routes = _routes_of(kern)
        assert routes == {"tma": 1}, (name, routes)
        e = {"name": name, "route": "tma", "library_call": lib_name,
             "ms": cuda_time_ms(kern), "library_ms": cuda_time_ms(lib),
             "bound_ms": _bound(flops, nbytes, PEAK_BF16)[0],
             "bound_by": _bound(flops, nbytes, PEAK_BF16)[1],
             "card": card, "power_limit": power}
        log(f"  {name} (TMA route): kernel {e['ms']:.4f} ms, {lib_name} "
            f"{e['library_ms']:.4f} ms ({e['ms'] / e['library_ms']:.2f}x), "
            f"bound {e['bound_ms']:.5f} ms ({e['bound_by']})")
        extras.append(e)
    # decode later in a request (not main-path rows): TinyLlama's cache
    # nearly full, the hybrid's ring full (128 splits, two combine levels)
    for name, Hq, Hkv, dh, S, pos in [("decode_attention@pos1023", 32, 4, 64,
                                       1024, 1023),
                                      ("decode_attention@recurrentgemma-2b"
                                       "@pos2047", 10, 1, 256, 2048, 2047)]:
        q = randn((1, Hq, dh), gen, bf)
        kc = randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        kr = kc[:, :, :pos + 1].repeat_interleave(Hq // Hkv, dim=1)
        e = {"name": name, "shape": f"q 1x{Hq}x{dh}, cache 1x{Hkv}x{S}x{dh} "
             f"bf16, pos {pos}",
             "ms": cuda_time_ms(lambda: decode_attention_tpu(q, kc, kc, pos)),
             "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
                 q[:, :, None], kr, kr)),
             "card": card, "power_limit": power}
        log(f"  {name}: kernel {e['ms']:.4f} ms, SDPA "
            f"{e['library_ms']:.4f} ms")
        extras.append(e)
    # the scan at the hybrid's 8-token prefill (launch-bound) and at a
    # 2560-token one (past the 50 MB L2: bytes-bound), beside the main row
    for S in (8, 2560):
        a = torch.rand((1, S, D), generator=gen, device=dev) * 0.599 + 0.4
        b, h0 = randn((1, S, D), gen), randn((1, D), gen)
        bound_ms, bound_by = _bound(2 * S * D, 4 * (3 * S * D + D), PEAK_FP32)
        e = {"name": f"rglru_scan@S{S}", "shape": f"a, b 1x{S}x{D} fp32",
             "ms": cuda_time_ms(lambda: rglru_scan_tpu(a, b, h0)),
             "bound_ms": bound_ms, "bound_by": bound_by, "card": card,
             "power_limit": power}
        log(f"  {e['name']}: kernel {e['ms']:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        extras.append(e)
    RECORD["kernels"] = rows
    RECORD["extra_timings"] = extras
    RECORD["before_redesign_ms"] = BEFORE_REDESIGN_MS
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.runtime.device import resolve_device
    dev = resolve_device()
    t_start = time.perf_counter()
    # phase 11 (e) needs the host's CPUs and no kernel: its gloo ranks run
    # beside the build and phases 2-3, which time nothing, and phase 11
    # reports them
    from concurrent.futures import ThreadPoolExecutor
    gloo_pool = ThreadPoolExecutor(1)
    gloo = gloo_pool.submit(gloo_torch_cases)
    line = smi()
    card, power = [s.strip() for s in line.split(",", 1)]
    log(f"phase 1: {line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    build_s = time.perf_counter() - t0
    for ln in _build.ptxas_report().splitlines():
        if "entry function" in ln or "registers" in ln or "spill" in ln:
            log("  ptxas: " + ln.strip())
    RECORD.update(card=card, power_limit=power, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  kernel_report=kernel_report())

    phase_kernels(dev)
    from repro_torch.configs import get_config
    RECORD["model_fp32_max_logit_err"] = phase_model(
        dev, get_config("tinyllama-1.1b"), 8, max_len=32)
    # one (rglru, rglru, attn) group and the 2-layer tail at full width
    hybrid5 = dataclasses.replace(get_config("recurrentgemma-2b"),
                                  n_layers=5)
    RECORD["hybrid_fp32_max_logit_err"] = phase_model(dev, hybrid5, 512)
    # two MLA + MoE layers of deepseek-v2-lite-16b (1.6 B parameters, 6.4
    # GB in fp32 a side); one (attn + dense, attn + MoE) group of
    # llama4-maverick-400b-a17b with all 128 experts, router, top-1 and
    # capacity as published, each expert's hidden width cut from 8192 to
    # 512 (3.5 B parameters, 14 GB a side; at 8192 the group is 18.5 B,
    # 74 GB in fp32 a side, over what the card and the host hold together)
    ds2 = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=2)
    RECORD["mla_moe_fp32_max_logit_err"] = phase_model(dev, ds2, 64,
                                                       max_len=128)
    mav = get_config("llama4-maverick-400b-a17b")
    mav = dataclasses.replace(mav, n_layers=2, moe=dataclasses.replace(
        mav.moe, d_expert=512))
    RECORD["moe_fp32_max_logit_err"] = phase_model(dev, mav, 64,
                                                   max_len=128)
    # xlstm-125m whole through the chunkwise (512 = 2 chunks of 256) and
    # the parallel (8) mLSTM prefill; llava-next-34b cut to 2 of 60 layers
    # (2.03 B parameters, 8.1 GB in fp32 a side); musicgen-large cut to 4
    # of 48 (0.30 B)
    t0 = time.perf_counter()
    xl = get_config("xlstm-125m")
    RECORD["xlstm_fp32_max_logit_err"] = max(
        phase_model(dev, xl, 512), phase_model(dev, xl, 8))
    RECORD["vlm_fp32_max_logit_err"] = phase_model(
        dev, dataclasses.replace(get_config("llava-next-34b"), n_layers=2),
        64, max_len=192, n_vis=64)
    RECORD["audio_fp32_max_logit_err"] = phase_model(
        dev, dataclasses.replace(get_config("musicgen-large"), n_layers=4),
        64, max_len=128)
    RECORD["last_families_fp32_s"] = time.perf_counter() - t0
    dense_launches = phase_dense_serving(dev)
    hybrid_launches = phase_hybrid_serving(dev)
    t0 = time.perf_counter()
    mla_launches = phase_mla_serving(dev)
    phase_moe_serving(dev)
    RECORD["moe_serving_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_xlstm_serving(dev)
    vlm_launches = phase_vlm_serving(dev)
    audio_launches = phase_audio(dev)
    RECORD["last_families_serving_s"] = time.perf_counter() - t0
    gemm_launches = phase_gemm(dev)
    RECORD["open_loop"] = phase_open_loop(dev)
    RECORD["lockstep"] = phase_sim(dev)
    RECORD["campaign"] = phase_campaign(dev, RECORD["lockstep"]["full"][1])
    train_launches = phase_train(dev, card, power)
    RECORD["sharding"] = phase_sharding(dev, gloo.result())
    gloo_pool.shutdown()
    launches = {
        "decode_attention": dense_launches["decode_attention"],
        "flash_attention": dense_launches["flash_attention"],
        "decode_attention@recurrentgemma-2b":
            hybrid_launches["decode_attention"],
        "flash_attention@recurrentgemma-2b":
            hybrid_launches["flash_attention"],
        "flash_attention@deepseek-v2-lite-16b":
            mla_launches["flash_attention"],
        "flash_attention@llava-next-34b": vlm_launches["flash_attention"],
        "decode_attention@llava-next-34b": vlm_launches["decode_attention"],
        "flash_attention@musicgen-large": audio_launches["flash_attention"],
        "decode_attention@musicgen-large":
            audio_launches["decode_attention"],
        "rglru_scan": hybrid_launches["rglru_scan"],
        "gemm_partial": gemm_launches["gemm_partial"],
        "systolic_gemm": gemm_launches["systolic_gemm"]}
    assert all(n > 0 for n in launches.values()), launches
    rows = phase_timing(dev, launches, card, power)
    # phase 10 (d) serves the trained TinyLlama at the same shapes as the
    # tinyllama rows: its launches beside theirs
    for r in rows:
        if r["name"] in train_launches:
            r["launches_trained_serving"] = train_launches[r["name"]]
    RECORD["wall_s"] = time.perf_counter() - t_start

    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    log(f"total {RECORD['wall_s']:.1f} s")
    log(json.dumps({"kernels": rows, "card": card, "power_limit": power}))
    log(smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
