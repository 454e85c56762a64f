"""Mixed-criticality serving driver on the card (twin of the batch drive
of the reference's ``launch/serve.py``).

Serves a model with batched requests of mixed priority/criticality under
the MESC scheduler (decode-step preemption, bank-pool cache residency,
LO-budget mode switching) and compares against a non-preemptive
baseline.  With ``--lanes N`` the requests are partitioned across N
dispatch lanes sharing one KV-slot arena.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --lanes 2 --device cpu \
      --arch tinyllama-1.1b-smoke

Parameters are random, from ``lm.init_params`` on a seeded generator; on
the card the model computes in bf16 (``DEFAULT_RC``), on the CPU in fp32
(``CPU_RC``).  The open-loop ``--arrivals`` / ``--virtual`` drive of the
reference needs its ``serving`` package and is not ported yet.
"""
from __future__ import annotations

import argparse
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
from repro_torch.runtime.device import resolve_device


def load_model(arch: str, device=None):
    """(cfg, params, rc) with random parameters made on ``device`` from
    seed 0: bf16 compute on the card, fp32 on the CPU."""
    device = resolve_device(device)
    cfg = get_config(arch)
    rc = CPU_RC if device.type == "cpu" else DEFAULT_RC
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, lm.init_params(cfg, gen, rc, device=device), rc


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


def run(cfg, params, policy, reqs, hi_delay_steps: int = 3,
        lanes: int = 1, heuristic: str = "crit_aware", rc=CPU_RC,
        max_len: int = 64, order: Optional[List] = None,
        resident_slots: int = 2):
    """LO requests submitted first; HI requests arrive mid-flight.

    ``order``, when given, receives the return of every ``step()`` call
    (warm-up included) and the marker ``"hi"`` where the HI requests are
    submitted.  ``resident_slots`` sizes the device-resident cache pool
    of one lane (with more lanes, two slots each).
    """
    if lanes > 1:
        srv = MultiLaneServer(cfg, params, policy=policy, rc=rc,
                              max_len=max_len, n_lanes=lanes,
                              heuristic=heuristic)
    else:
        srv = MESCServer(cfg, params, policy=policy, rc=rc,
                         max_len=max_len, resident_slots=resident_slots)
    # warm-up request outside the measured window
    warm = Request(rid=-1, priority=99,
                   prompt=np.zeros(len(reqs[0].prompt), np.int32),
                   max_new_tokens=2, crit=Crit.LO)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--lanes", type=int, default=1,
                    help="dispatch lanes (partitioned MESC when > 1)")
    ap.add_argument("--heuristic", default="crit_aware", choices=HEURISTICS,
                    help="request -> lane partition heuristic")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg, params, rc = load_model(args.arch, args.device)
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
