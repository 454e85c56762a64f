"""Mixed-criticality serving on the card (twin of the reference's
``launch/serve.py``).

Serves a model with batched requests of mixed priority/criticality under
the MESC scheduler (decode-step preemption, bank-pool cache residency,
LO-budget mode switching) and compares against a non-preemptive
baseline.  With ``--lanes N`` the requests are partitioned across N
dispatch lanes sharing one KV-slot arena.

``--arrivals`` switches from the batch drive to the open-loop traffic
layer (``repro_torch.serving``): requests arrive per a CRN arrival
process (poisson / heavy_tail / diurnal / a replayed ``--trace`` file)
through the admission front door, and the run is summarized as SLO
metrics.  ``--virtual`` runs it on the deterministic virtual clock and
service model on the host, with no model and no device; without it the
model serves the arrivals in wall-clock time on ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-maverick-400b-a17b-smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --lanes 2 --device cpu \
      --arch tinyllama-1.1b-smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --arrivals poisson --virtual
  PYTHONPATH=src python -m repro_torch.launch.serve --arrivals poisson

``--spans`` turns on the program's tracer (``runtime/trace.py``) after
the model is loaded and prints, on standard error at the end, each
span's count, host ms (total and mean), self ms and device ms, and the
counters (context saves and restores with their bytes, preemptions,
mode switches, decode-plan misses, kernel launches by wrapper and
route).  Standard output is unchanged.

``--arch`` takes a config of the dense (tinyllama-1.1b, olmo-1b,
phi4-mini-3.8b, qwen1.5-110b), ``vlm`` (llava-next-34b, served on text
prompts), hybrid (recurrentgemma-2b), ``xlstm`` (xlstm-125m), ``moe``
(llama4-maverick-400b-a17b) or ``mla_moe`` (deepseek-v2-lite-16b) family,
or its ``-smoke`` cut.  One 80 GB card holds DeepSeek-V2-Lite whole (16.2 B
parameters, 32.4 GB in bf16) and LLaVA-NeXT-34B whole (34.4 B, 64.05 GiB
in bf16); full Maverick (397.7 B) fits no card, its smoke config runs
anywhere.  The ``audio`` family (musicgen-large) cannot be served: its
tokens are (B, S, K) codebook ids and the server feeds (1, S) prompts,
as the reference's does, so its first prefill raises a ``ValueError``;
drive it through ``lm.prefill`` / ``lm.decode_step``.

Parameters are random, from ``lm.init_params`` on a seeded generator; on
the card the model computes in bf16 (``SERVE_RC``), on the CPU in fp32
(``CPU_RC``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.scheduler import Policy
from repro_torch.core.serving import (HEURISTICS, MESCServer,
                                      MultiLaneServer, Request)
from repro_torch.core.task import Crit
from repro_torch.models import lm
from repro_torch.models.common import CPU_RC, DEFAULT_RC
from repro_torch.runtime import trace
from repro_torch.runtime.device import resolve_device
from repro_torch.serving import (PROCESS_KINDS, FrontDoor, build_workload,
                                 make_process, run_virtual_serving,
                                 slo_summary)

#: the card's serving placement: bf16, and the decode cache written in
#: place at ``pos`` (the reference's dynamic-update-slice) rather than by
#: its one-hot select over the whole cache, which only a cache sharded on
#: S needs (``runtime.sharding``); one card holds its cache whole, and
#: both writes leave the same values
SERVE_RC = dataclasses.replace(DEFAULT_RC, dus_cache_update=True)

#: decode steps of the warm-up request each drive serves before its
#: measured window (one prefill and this many decode steps)
WARMUP_TOKENS = 2


def init_model(cfg, device=None):
    """(cfg, params, rc) with random parameters for ``cfg`` made on
    ``device`` from seed 0: bf16 compute on the card, fp32 on the CPU."""
    device = resolve_device(device)
    rc = CPU_RC if device.type == "cpu" else SERVE_RC
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, lm.init_params(cfg, gen, rc, device=device), rc


def load_model(arch: str, device=None):
    """``init_model`` of the config named ``arch``."""
    return init_model(get_config(arch), device)


def make_requests(cfg, rng, n_lo: int = 4, n_hi: int = 2,
                  lo_len: int = 24, hi_len: int = 6, prompt_len: int = 8):
    reqs = []
    rid = 0
    for _ in range(n_lo):
        reqs.append(Request(rid=rid, priority=10 + rid,
                            prompt=rng.integers(0, cfg.vocab, prompt_len,
                                                dtype=np.int32),
                            max_new_tokens=lo_len, crit=Crit.LO))
        rid += 1
    for _ in range(n_hi):
        reqs.append(Request(rid=rid, priority=rid - n_lo,
                            prompt=rng.integers(0, cfg.vocab, prompt_len,
                                                dtype=np.int32),
                            max_new_tokens=hi_len, crit=Crit.HI))
        rid += 1
    return reqs


def _drain(srv, order: Optional[list]):
    """``srv.run()`` that also records what each step ran."""
    for _ in range(10_000):
        ran = srv.step()
        if order is not None:
            order.append(ran)
        if ran is None or (isinstance(ran, list)
                           and all(x is None for x in ran)):
            return


def _server(cfg, params, policy, lanes, heuristic, rc, max_len,
            resident_slots):
    """One MESCServer, or with ``lanes > 1`` a MultiLaneServer whose arena
    holds ``resident_slots`` slots per lane."""
    if lanes > 1:
        return MultiLaneServer(cfg, params, policy=policy, rc=rc,
                               max_len=max_len, n_lanes=lanes,
                               heuristic=heuristic,
                               total_slots=resident_slots * lanes)
    return MESCServer(cfg, params, policy=policy, rc=rc, max_len=max_len,
                      resident_slots=resident_slots)


def run(cfg, params, policy, reqs, hi_delay_steps: int = 3,
        lanes: int = 1, heuristic: str = "crit_aware", rc=CPU_RC,
        max_len: int = 64, order: Optional[List] = None,
        resident_slots: int = 2):
    """LO requests submitted first; HI requests arrive mid-flight.

    ``order``, when given, receives the return of every ``step()`` call
    (warm-up included) and the marker ``"hi"`` where the HI requests are
    submitted.  ``resident_slots`` sizes each lane's device-resident
    cache pool.
    """
    srv = _server(cfg, params, policy, lanes, heuristic, rc, max_len,
                  resident_slots)
    # warm-up request outside the measured window
    warm = Request(rid=-1, priority=99,
                   prompt=np.zeros(len(reqs[0].prompt), np.int32),
                   max_new_tokens=WARMUP_TOKENS, crit=Crit.LO)
    srv.submit(warm)
    _drain(srv, order)
    for ln in getattr(srv, "lanes", [srv]):
        ln.requests.clear()
    lo = [r for r in reqs if r.crit == Crit.LO]
    hi = [r for r in reqs if r.crit == Crit.HI]
    for r in lo:
        srv.submit(r)
    for _ in range(hi_delay_steps):
        ran = srv.step()
        if order is not None:
            order.append(ran)
    if order is not None:
        order.append("hi")
    for r in hi:
        srv.submit(r)
    _drain(srv, order)
    return srv.requests


def summarize(name, reqs):
    out = {}
    for crit in (Crit.HI, Crit.LO):
        rs = [r for r in reqs.values() if r.crit == crit and r.finished_at]
        if not rs:
            continue
        ttft = [r.first_token_at - r.submitted_at for r in rs]
        lat = [r.finished_at - r.submitted_at for r in rs]
        out[crit.value] = (float(np.mean(ttft)), float(np.mean(lat)))
        print(f"  {name:12s} {crit.value}: ttft={np.mean(ttft)*1e3:7.1f} ms "
              f"latency={np.mean(lat)*1e3:7.1f} ms  n={len(rs)} "
              f"saves={sum(r.saves for r in rs)}")
    return out


def run_traffic_real(cfg, params, policy, workload, *, lanes: int = 1,
                     heuristic: str = "crit_aware", max_live_lo=None,
                     prompt_len: int = 8, rc=CPU_RC, max_len: int = 64,
                     resident_slots: int = 2):
    """Open-loop wall-clock drive: the model serves a CRN arrival
    realization in real time through the admission front door.

    Prompts are drawn from one seeded generator in admission order, as
    the reference draws them, so under a wall clock the same rid may get
    another prompt under another policy; each request keeps its own in
    ``Request.prompt``.  ``resident_slots`` sizes each lane's resident
    cache pool."""
    srv = _server(cfg, params, policy, lanes, heuristic, rc, max_len,
                  resident_slots)
    warm = Request(rid=-1, priority=99, prompt=np.zeros(prompt_len, np.int32),
                   max_new_tokens=WARMUP_TOKENS, crit=Crit.LO)
    srv.submit(warm)
    srv.run()
    for ln in getattr(srv, "lanes", [srv]):
        ln.requests.clear()

    rng = np.random.default_rng(0)
    t0 = time.monotonic()

    def make_real(spec):
        # pre-stamp the true arrival instant so front-door queueing is
        # inside measured latency (same contract as the virtual path)
        return Request(rid=spec.rid, priority=spec.priority,
                       prompt=rng.integers(0, cfg.vocab, prompt_len,
                                           dtype=np.int32),
                       max_new_tokens=spec.max_new_tokens,
                       crit=spec.crit, lo_budget_s=spec.lo_budget_s,
                       submitted_at=t0 + spec.t)

    front = FrontDoor(srv, max_live_lo=max_live_lo,
                      make_request_fn=make_real)
    pending = deque(sorted(workload, key=lambda s: (s.t, s.rid)))
    while pending or front.queued or front.live():
        now = time.monotonic() - t0
        while pending and pending[0].t <= now:
            front.arrive(pending.popleft())
        front.pump()
        if front.live():
            srv.step()
        elif pending:                      # idle: sleep to next arrival
            time.sleep(max(0.0, min(pending[0].t - now, 0.05)))
    front.check_conservation()
    return srv.requests


def print_slo(name, row):
    def f(v, scale=1e3, unit="ms"):
        return "   n/a" if v is None else f"{v * scale:7.1f} {unit}"
    print(f"  {name:6s} HI: p50={f(row['hi_p50_latency_s'])} "
          f"p99={f(row['hi_p99_latency_s'])} "
          f"miss={row['hi_miss_rate'] if row['hi_miss_rate'] is not None else 'n/a'}  "
          f"LO: p50={f(row['lo_p50_latency_s'])}  "
          f"goodput={row['goodput_rps']:.2f} rps")


def main_traffic(args):
    """--arrivals != batch: the open-loop traffic front end."""
    lo_process = make_process(args.arrivals, args.rate,
                              trace_path=args.trace)
    hi_process = make_process("poisson", args.hi_rate)
    workload = build_workload(seed=args.seed, lo_process=lo_process,
                              hi_process=hi_process, n_lo=args.n_lo,
                              n_hi=args.n_hi, lo_tokens=args.lo_tokens,
                              hi_tokens=args.hi_tokens)
    mode = "virtual clock" if args.virtual else "wall clock"
    print(f"open-loop {args.arrivals} arrivals ({mode}, "
          f"lanes={args.lanes}, n_lo={args.n_lo}, n_hi={args.n_hi}, "
          f"lo_rate={args.rate}/s, hi_rate={args.hi_rate}/s)")
    if not args.virtual:
        cfg, params, rc = load_model(args.arch, args.device)
    _start_spans(args, "cpu" if args.virtual else params["embed"].device)
    rows = {}
    for name, policy in (("mesc", Policy.mesc()),
                         ("np", Policy.non_preemptive())):
        if args.virtual:
            reqs = run_virtual_serving(
                workload, lanes=args.lanes, policy=policy,
                seed=args.seed, heuristic=args.heuristic,
                max_live_lo=args.max_live_lo)
        else:
            reqs = run_traffic_real(
                cfg, params, policy, workload, lanes=args.lanes,
                heuristic=args.heuristic, max_live_lo=args.max_live_lo,
                rc=rc)
        rows[name] = slo_summary(reqs.values(),
                                 hi_deadline_s=args.hi_deadline)
        print_slo(name, rows[name])
    m, b = rows["mesc"], rows["np"]
    if m["hi_p99_latency_s"] and b["hi_p99_latency_s"]:
        print(f"HI p99 latency np/mesc: "
              f"{b['hi_p99_latency_s'] / m['hi_p99_latency_s']:.1f}x")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--lanes", type=int, default=1,
                    help="dispatch lanes (partitioned MESC when > 1)")
    ap.add_argument("--heuristic", default="crit_aware", choices=HEURISTICS,
                    help="request -> lane partition heuristic")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--arrivals", default="batch",
                    choices=("batch",) + PROCESS_KINDS,
                    help="batch = the closed batch drive; anything else "
                         "selects the open-loop traffic layer")
    ap.add_argument("--trace", default=None,
                    help="arrival-trace JSON for --arrivals trace "
                         "(see repro_torch.serving.save_trace)")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="LO arrival rate, requests/s")
    ap.add_argument("--hi-rate", type=float, default=0.5,
                    help="HI arrival rate, requests/s")
    ap.add_argument("--n-lo", type=int, default=16)
    ap.add_argument("--n-hi", type=int, default=6)
    ap.add_argument("--lo-tokens", type=int, default=24)
    ap.add_argument("--hi-tokens", type=int, default=6)
    ap.add_argument("--hi-deadline", type=float, default=0.5,
                    help="HI deadline for miss-rate accounting, seconds")
    ap.add_argument("--max-live-lo", type=int, default=None,
                    help="admission cap on concurrently-live LO "
                         "requests (None = open throttle)")
    ap.add_argument("--virtual", action="store_true",
                    help="serve on the deterministic virtual clock + "
                         "service model (no weights, no device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spans", action="store_true",
                    help="trace the serving path and print each span's "
                         "times and the counters on stderr at the end")
    args = ap.parse_args()
    if args.arrivals == "trace" and not args.trace:
        ap.error("--arrivals trace requires --trace PATH")
    if args.arrivals != "batch":
        main_traffic(args)
    else:
        main_batch(args)
    if args.spans:
        spans, counters = trace.drain()
        trace.disable()
        print(trace.format_summary(spans, counters), file=sys.stderr)


def _start_spans(args, device) -> None:
    if args.spans:
        trace.enable(device_events=torch.device(device).type == "cuda")


def main_batch(args):
    """--arrivals batch: the closed batch drive."""
    cfg, params, rc = load_model(args.arch, args.device)
    _start_spans(args, params["embed"].device)
    lane_kw = dict(lanes=args.lanes, heuristic=args.heuristic, rc=rc)
    rng = np.random.default_rng(0)
    print(f"MESC (instruction-level preemption, lanes={args.lanes}, "
          f"{cfg.name} on {params['embed'].device}):")
    mesc = summarize("mesc", run(cfg, params, Policy.mesc(),
                                 make_requests(cfg, rng), **lane_kw))
    print("non-preemptive baseline:")
    rng = np.random.default_rng(0)
    base = summarize("np", run(cfg, params, Policy.non_preemptive(),
                               make_requests(cfg, rng), **lane_kw))
    if "HI" in mesc and "HI" in base:
        sp = base["HI"][0] / max(mesc["HI"][0], 1e-9)
        print(f"HI time-to-first-token speedup: {sp:.1f}x")


if __name__ == "__main__":
    main()
