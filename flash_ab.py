#!/usr/bin/env python3
"""The bf16 flash kernel of two checkouts, side by side on one NVIDIA card.

    python3 flash_ab.py OTHER_CHECKOUT

Builds the kernels of this checkout and of ``OTHER_CHECKOUT`` (a second
copy of the repository, for example an earlier commit unpacked with
``git archive`` into ``build/``), each from its own ``csrc/`` into its own
``build/``, and loads both libraries.  Then for each of phase 6's flash
rows of ``chip_smoke.py`` (TinyLlama, recurrentgemma-2b's window,
LLaVA-NeXT-34B, MusicGen-large and DeepSeek-V2-Lite's MLA, no cap and no
offset) it compares the two kernels' outputs bit for bit and times them in
rounds of other, this, this, other: device time, the median of 30
CUDA-graph replays of 10 calls each time.  It prints each bf16 flash
entry's registers and spills (``ptxas -v``) in both builds, the card's
name and power limit, and writes ``results/flash_ab.json``; it exits
non-zero without CUDA.
"""
from __future__ import annotations

import importlib.util
import json
import re
import statistics
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

ROUNDS = 5
# (name, Hq, Hkv, dqk, dv, S, window): phase 6's flash rows
ROWS = (("tinyllama-1.1b", 32, 4, 64, 64, 512, 0),
        ("recurrentgemma-2b", 10, 1, 256, 256, 512, 2048),
        ("llava-next-34b", 56, 8, 128, 128, 1024, 0),
        ("musicgen-large", 32, 32, 64, 64, 512, 0),
        ("deepseek-v2-lite-16b", 16, 16, 192, 128, 512, 0))


def load_build(checkout: Path, name: str):
    """The ``kernels/_build`` module of ``checkout``, loaded under
    ``name``: it builds that checkout's sources into its own build/."""
    path = checkout / "src" / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flash_entries(report: str) -> dict:
    """bf16 flash entry -> (registers, spill stores, spill loads)."""
    out, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = chip_smoke._short(m.group(1))
            cur = cur if cur.startswith("flash_mma_kernel<") else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def caller(lib, q, k, v, out, window):
    """A launch of ``lib``'s bf16 flash entry on these tensors, through
    whichever C interface the checkout has (with or without q_offset and
    softcap)."""
    fn = lib.repro_flash_attention_bf16
    B, Hq, S, dqk = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, S, Skv, dqk, dv, 1, window]
    if len(fn.argtypes) == len(head) + len(strides) + 2:
        args = head + strides + [dqk ** -0.5]
    else:                                   # q_offset 0, softcap 0 (none)
        args = head + [0] + strides + [dqk ** -0.5, 0.0]

    def call():                 # the current stream: a graph captures it
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
    return call


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    builds = {"other": load_build(other, "other_kernels_build"),
              "this": load_build(ROOT, "this_kernels_build")}
    errors = []

    def build(mod):
        try:
            mod.lib()
        except Exception as e:                    # reported below
            errors.append(e)
    threads = [threading.Thread(target=build, args=(m,))
               for m in builds.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    card = chip_smoke.smi()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    record = {"card": card, "torch": torch.__version__, "other": str(other),
              "ptxas": {}, "rows": []}
    for side, mod in builds.items():
        record["ptxas"][side] = flash_entries(mod.ptxas_report())
        for name, e in sorted(record["ptxas"][side].items()):
            print(f"  {side}: {name}: {e.get('registers')} registers, spill "
                  f"{e.get('spill_stores')}/{e.get('spill_loads')} bytes "
                  "(stores/loads)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    for name, Hq, Hkv, dqk, dv, S, window in ROWS:
        q = chip_smoke.randn((1, S, Hq, dqk), gen, bf).transpose(1, 2)
        k = chip_smoke.randn((1, S, Hkv, dqk), gen, bf).transpose(1, 2)
        v = chip_smoke.randn((1, S, Hkv, dv), gen, bf).transpose(1, 2)
        outs = {s: torch.empty((1, S, Hq, dv), dtype=bf,
                               device="cuda").transpose(1, 2)
                for s in builds}
        calls = {s: caller(m.lib(), q, k, v, outs[s], window)
                 for s, m in builds.items()}
        for c in calls.values():
            c()
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        times = {s: [] for s in builds}
        for _ in range(ROUNDS):
            for s in ("other", "this", "this", "other"):
                times[s].append(chip_smoke.cuda_time_ms(calls[s]))
        r = {"name": name, "shape": f"q 1x{Hq}x{S}x{dqk}, kv 1x{Hkv}x{S}x"
             f"{dqk}/{dv} bf16" + (f", window {window}" if window else ""),
             "bit_equal": same,
             "max_abs_diff": chip_smoke.max_err(outs["other"], outs["this"])}
        for s, ts in times.items():
            r[f"{s}_ms"] = statistics.median(ts)
            r[f"{s}_range_ms"] = [min(ts), max(ts)]
        r["this_over_other"] = r["this_ms"] / r["other_ms"]
        record["rows"].append(r)
        print(f"  {name} ({r['shape']}): other {r['other_ms']:.5f} ms "
              f"[{min(times['other']):.5f}, {max(times['other']):.5f}], this "
              f"{r['this_ms']:.5f} ms [{min(times['this']):.5f}, "
              f"{max(times['this']):.5f}], this / other "
              f"{r['this_over_other']:.4f}, outputs "
              f"{'bit-equal' if same else 'differ: %.3e' % r['max_abs_diff']}",
              flush=True)
    out = ROOT / "results" / "flash_ab.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"flash_ab": [{k: r[k] for k in ("name", "other_ms",
                                                        "this_ms",
                                                        "this_over_other")}
                                   for r in record["rows"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
