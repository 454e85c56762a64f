#!/usr/bin/env python3
"""Every split of the decode kernel's cluster plan, timed on one NVIDIA card.

    python3 decode_split_sweep.py

For each row (phase 6's seven bf16 decode rows of ``chip_smoke.py`` and
five more positions of the same models) it launches every candidate of
``kernels/decode_attention.py::cluster_plan`` whose clusters the card
holds at once, each (n_split CTAs a cluster, head_splits clusters a kv
head) with the plan's own tiles and stages, through ``launch_plan``
(no launch counted): device time, the median of 30 CUDA-graph replays
of 10 calls.  It prints the plan's pick beside the fastest candidate and
SDPA, and the non-negative least-squares fit of the plan's cost terms
(``split_cost``: cache bytes and head arithmetic a CTA, heads a cluster,
CTAs) to all timed candidates, the source of the plan's ``COST_*``
constants.  It prints the card's name and power limit and writes
``results/decode_split_sweep.json``; it exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

# (name, Hq, Hkv, dh, S, pos)
ROWS = (("tinyllama-1.1b", 32, 4, 64, 1024, 535),
        ("recurrentgemma-2b", 10, 1, 256, 2048, 535),
        ("llava-next-34b", 56, 8, 128, 1024, 535),
        ("musicgen-large", 32, 32, 64, 1024, 535),
        ("pos63", 32, 4, 64, 64, 63),
        ("pos1023", 32, 4, 64, 1024, 1023),
        ("recurrentgemma-2b@pos2047", 10, 1, 256, 2048, 2047),
        ("tinyllama-1.1b@pos255", 32, 4, 64, 1024, 255),
        ("tinyllama-1.1b@pos2047", 32, 4, 64, 2048, 2047),
        ("llava-next-34b@pos1023", 56, 8, 128, 1024, 1023),
        ("recurrentgemma-2b@pos1023", 10, 1, 256, 2048, 1023),
        ("llava-next-34b@pos127", 56, 8, 128, 1024, 127))


def candidates(dec, Hkv, G, dh, live, n_sm, fits):
    """Every (plan, cost terms) of the plan's search whose clusters fit."""
    seen = set()
    for n in range(1, dec.MAX_CLUSTER + 1):
        chunk = -(-(-(-live // n)) // dec.SPLIT_ALIGN) * dec.SPLIT_ALIGN
        n_split = -(-live // chunk)
        for h in range(1, G + 1):
            hps = -(-G // h)
            if -(-G // hps) != h or (n_split, h) in seen:
                continue
            seen.add((n_split, h))
            ctas = Hkv * h * n_split
            if ctas > n_sm and n_split * h > 1:
                continue
            rows, stages = dec._tiles(chunk, hps, dh, 2)
            if n_split * h > 1 and not fits(n_split, hps, rows, stages,
                                            Hkv * h):
                continue
            terms = [chunk * dh, chunk * dh * dec.padded_heads(hps), hps,
                     ctas]
            yield dec.DecodePlan(chunk, n_split, rows, stages, h), terms


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split_sweep.py needs a CUDA card", file=sys.stderr)
        return 1
    from scipy.optimize import nnls

    from repro_torch.kernels import decode_attention as dec
    card = chip_smoke.smi()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    F = torch.nn.functional
    record = {"card": card, "rows": []}
    X, y = [], []
    for name, Hq, Hkv, dh, S, pos in ROWS:
        G = Hq // Hkv
        q = chip_smoke.randn((1, Hq, dh), gen, bf)
        kc = chip_smoke.randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        vc = chip_smoke.randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        kr = kc[:, :, :pos + 1].repeat_interleave(G, dim=1)
        vr = vc[:, :, :pos + 1].repeat_interleave(G, dim=1)
        sdpa = chip_smoke.cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr))
        pick = dec.plan_for(q, kc, pos)
        timed = []
        for plan, terms in candidates(dec, Hkv, G, dh, pos + 1, n_sm,
                                      dec._fits(q)):
            ms = chip_smoke.cuda_time_ms(
                lambda: dec.launch_plan(q, kc, vc, pos, plan))
            timed.append({"plan": list(plan), "ms": ms, "terms": terms})
            X.append([1.0] + terms)
            y.append(ms * 1e3)
        fastest = min(timed, key=lambda e: e["ms"])
        mine = next(e for e in timed if e["plan"] == list(pick))
        r = {"name": name, "shape": f"q 1x{Hq}x{dh}, cache 1x{Hkv}x{S}x{dh} "
             f"bf16, pos {pos}", "sdpa_ms": sdpa, "plan": list(pick),
             "plan_ms": mine["ms"], "fastest": fastest["plan"],
             "fastest_ms": fastest["ms"], "splits": timed}
        record["rows"].append(r)
        print(f"  {name} ({r['shape']}): plan {tuple(pick)} "
              f"{mine['ms']:.5f} ms, fastest {tuple(fastest['plan'])} "
              f"{fastest['ms']:.5f} ms ({mine['ms'] / fastest['ms']:.3f}x), "
              f"SDPA {sdpa:.5f} ms, {len(timed)} splits timed", flush=True)
    coef, _ = nnls(np.array(X), np.array(y))
    record["fit_us"] = {"constant": coef[0], "row_dh": coef[1],
                        "row_dh_head": coef[2], "head": coef[3],
                        "cta": coef[4]}
    print(f"  fit (us): {record['fit_us']}; the plan's: row_dh "
          f"{dec.COST_ROW_DH}, row_dh_head {dec.COST_ROW_DH_HEAD}, head "
          f"{dec.COST_HEAD}, cta {dec.COST_CTA}", flush=True)
    out = ROOT / "results" / "decode_split_sweep.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"decode_split_sweep": [
        {k: r[k] for k in ("name", "plan", "plan_ms", "fastest",
                           "fastest_ms", "sdpa_ms")}
        for r in record["rows"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
