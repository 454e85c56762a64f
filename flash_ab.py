#!/usr/bin/env python3
"""The bf16 flash and decode kernels of two checkouts, side by side on one
NVIDIA card.

    python3 flash_ab.py OTHER_CHECKOUT

Builds the kernels of this checkout and of ``OTHER_CHECKOUT`` (a second
copy of the repository, for example an earlier commit unpacked with
``git archive`` into ``build/``), each from its own ``csrc/`` into its own
``build/``, and loads both libraries.  Then for each of phase 6's flash
rows of ``chip_smoke.py`` (TinyLlama, recurrentgemma-2b's window,
LLaVA-NeXT-34B, MusicGen-large and DeepSeek-V2-Lite's MLA, and the
second 512-token chunk of a 1024-token TinyLlama prompt plainly and with a
score cap of 50, where both checkouts take ``q_offset`` and ``softcap``)
and its seven bf16 decode rows (TinyLlama, recurrentgemma-2b's ring,
LLaVA-NeXT-34B and MusicGen-large at position 535, the open-loop drive's
63, TinyLlama's 1023 and the hybrid's full ring) it compares the two
kernels' outputs and times them in rounds of other, this, this, other
(the decode rows also SDPA once a round, on the KV heads repeated to the
query heads): device time, the median of 30 CUDA-graph replays of 10
calls each time.  It prints each bf16 flash and each decode entry's
registers and spills (``ptxas -v``) in both builds, the card's name and
power limit, and writes ``results/flash_ab.json``; it exits non-zero
without CUDA.
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
# (name, Hq, Hkv, dqk, dv, S, Skv, window, q_offset, softcap): phase 6's
# flash rows
ROWS = (("tinyllama-1.1b", 32, 4, 64, 64, 512, 512, 0, 0, 0.0),
        ("recurrentgemma-2b", 10, 1, 256, 256, 512, 512, 2048, 0, 0.0),
        ("llava-next-34b", 56, 8, 128, 128, 1024, 1024, 0, 0, 0.0),
        ("musicgen-large", 32, 32, 64, 64, 512, 512, 0, 0, 0.0),
        ("deepseek-v2-lite-16b", 16, 16, 192, 128, 512, 512, 0, 0, 0.0),
        ("chunk512", 32, 4, 64, 64, 512, 1024, 0, 512, 0.0),
        ("chunk512_softcap50", 32, 4, 64, 64, 512, 1024, 0, 512, 50.0))
# (name, Hq, Hkv, dh, S, pos): phase 6's decode rows
DECODE_ROWS = (("tinyllama-1.1b", 32, 4, 64, 1024, 535),
               ("recurrentgemma-2b", 10, 1, 256, 2048, 535),
               ("llava-next-34b", 56, 8, 128, 1024, 535),
               ("musicgen-large", 32, 32, 64, 1024, 535),
               ("pos63", 32, 4, 64, 64, 63),
               ("pos1023", 32, 4, 64, 1024, 1023),
               ("recurrentgemma-2b@pos2047", 10, 1, 256, 2048, 2047))
# the bf16 flash kernel's entry, in either checkout, and the decode entry
FLASH_ENTRIES = ("flash_mma_kernel", "flash_wgmma_kernel")
DECODE_ENTRIES = ("decode_kernel",)


def load_module(checkout: Path, module: str, name: str):
    """The port's ``kernels/<module>.py`` of ``checkout``, loaded under
    ``name`` (``_build`` builds that checkout's sources into its own
    build/)."""
    path = checkout / "src" / "repro_torch" / "kernels" / f"{module}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_build(checkout: Path, name: str):
    return load_module(checkout, "_build", name)


def entries(report: str, kinds=FLASH_ENTRIES) -> dict:
    """Entry of one of ``kinds`` -> (registers, spill stores, spill
    loads)."""
    out, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = chip_smoke._short(m.group(1), kinds)
            cur = cur if cur.split("<")[0] in kinds else None
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


def caller(lib, q, k, v, out, window, q_offset=0, softcap=0.0):
    """A launch of ``lib``'s bf16 flash entry on these tensors, through
    whichever C interface the checkout has (with or without q_offset and
    softcap; without them only for a call that passes neither)."""
    fn = lib.repro_flash_attention_bf16
    B, Hq, S, dqk = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, S, Skv, dqk, dv, 1, window]
    if len(fn.argtypes) == len(head) + len(strides) + 2:
        assert not q_offset and not softcap, "the checkout takes neither"
        args = head + strides + [dqk ** -0.5]
    else:
        args = head + [q_offset] + strides + [dqk ** -0.5, softcap]

    def call():                 # the current stream: a graph captures it
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
    return call


def decode_caller(lib, dec, q, kc, vc, out, pos):
    """A launch of ``lib``'s decode entry on these tensors, through
    whichever interface the checkout has: the cluster kernel (this
    checkout's ``plan_for``, whose occupancy query asks this checkout's
    build; with or without the device-position pointer, passed null) or
    the split-and-fold kernel (``dec.split_plan``, its scratch and zeroed
    counters, which the kernel leaves zeroed)."""
    from repro_torch.kernels.decode_attention import plan_for
    fn = lib.repro_decode_attention
    B, Hq, dh = q.shape
    Hkv, S = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    code = 0 if q.dtype == torch.float32 else 1
    strides = [q.stride(0), q.stride(1)] + [t.stride(i) for t in (kc, vc)
                                            for i in range(3)]
    keep = []
    if hasattr(dec, "split_plan"):
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        chunk, n_split = dec.split_plan(B, Hkv, pos + 1, G, dh, n_sm=n_sm,
                                        itemsize=q.element_size())
        n_grp = -(-G // dec.HEADS_PER_BLOCK)
        n_run = -(-n_split // dec.FAN)
        part = torch.empty(B * Hkv * (n_split + n_run) * G * (dh + 2),
                           dtype=torch.float32, device=q.device)
        counters = torch.zeros(B * Hkv * n_grp * (n_run + 1),
                               dtype=torch.int32, device=q.device)
        keep = [part, counters]
        args = [code, q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, Hkv,
                G, dh, pos, chunk, n_split, n_grp]
    else:
        p = plan_for(q, kc, pos)
        args = [code, q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                out.data_ptr(), B, Hkv, G, dh, S, pos]
        if len(fn.argtypes) == len(args) + 16:     # pos_dev, null
            args.append(None)
        args += [p.chunk, p.n_split, p.head_splits, p.tile_rows, p.stages]
    args += strides + [dh ** -0.5]

    def call():                 # the current stream: a graph captures it
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        assert err == 0 and keep is not None, err
    return call


def decode_rows(builds, decs, gen) -> list:
    """Phase 6's decode rows through both builds (and SDPA), interleaved."""
    F = torch.nn.functional
    bf = torch.bfloat16
    rows = []
    for name, Hq, Hkv, dh, S, pos in DECODE_ROWS:
        q = chip_smoke.randn((1, Hq, dh), gen, bf)
        kc = chip_smoke.randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        vc = chip_smoke.randn((1, S, Hkv, dh), gen, bf).transpose(1, 2)
        kr = kc[:, :, :pos + 1].repeat_interleave(Hq // Hkv, dim=1)
        vr = vc[:, :, :pos + 1].repeat_interleave(Hq // Hkv, dim=1)
        outs = {s: torch.empty((1, Hq, dh), dtype=bf, device="cuda")
                for s in builds}
        calls = {s: decode_caller(m.lib(), decs[s], q, kc, vc, outs[s], pos)
                 for s, m in builds.items()}
        for c in calls.values():
            c()
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        times = {s: [] for s in builds}
        sdpa = []
        for _ in range(ROUNDS):
            for s in ("other", "this", "this", "other"):
                times[s].append(chip_smoke.cuda_time_ms(calls[s]))
            sdpa.append(chip_smoke.cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q[:, :, None], kr,
                                                       vr)))
        r = {"name": f"decode_attention@{name}",
             "shape": f"q 1x{Hq}x{dh}, cache 1x{Hkv}x{S}x{dh} bf16, pos "
             f"{pos}", "bit_equal": same,
             "max_abs_diff": chip_smoke.max_err(outs["other"], outs["this"])}
        for s, ts in times.items():
            r[f"{s}_ms"] = statistics.median(ts)
            r[f"{s}_range_ms"] = [min(ts), max(ts)]
        r["sdpa_ms"] = statistics.median(sdpa)
        r["this_over_other"] = r["this_ms"] / r["other_ms"]
        r["this_over_sdpa"] = r["this_ms"] / r["sdpa_ms"]
        rows.append(r)
        print(f"  {r['name']} ({r['shape']}): other {r['other_ms']:.5f} ms "
              f"[{min(times['other']):.5f}, {max(times['other']):.5f}], this "
              f"{r['this_ms']:.5f} ms [{min(times['this']):.5f}, "
              f"{max(times['this']):.5f}], SDPA {r['sdpa_ms']:.5f} ms; this "
              f"/ other {r['this_over_other']:.4f}, this / SDPA "
              f"{r['this_over_sdpa']:.4f}; outputs max|diff| "
              f"{r['max_abs_diff']:.3e}", flush=True)
    return rows


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
        record["ptxas"][side] = entries(mod.ptxas_report(),
                                        FLASH_ENTRIES + DECODE_ENTRIES)
        for name, e in sorted(record["ptxas"][side].items()):
            print(f"  {side}: {name}: {e.get('registers')} registers, spill "
                  f"{e.get('spill_stores')}/{e.get('spill_loads')} bytes "
                  "(stores/loads)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    for name, Hq, Hkv, dqk, dv, S, Skv, window, off, cap in ROWS:
        q = chip_smoke.randn((1, S, Hq, dqk), gen, bf).transpose(1, 2)
        k = chip_smoke.randn((1, Skv, Hkv, dqk), gen, bf).transpose(1, 2)
        v = chip_smoke.randn((1, Skv, Hkv, dv), gen, bf).transpose(1, 2)
        outs = {s: torch.empty((1, S, Hq, dv), dtype=bf,
                               device="cuda").transpose(1, 2)
                for s in builds}
        calls = {s: caller(m.lib(), q, k, v, outs[s], window, off, cap)
                 for s, m in builds.items()}
        for c in calls.values():
            c()
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        times = {s: [] for s in builds}
        for _ in range(ROUNDS):
            for s in ("other", "this", "this", "other"):
                times[s].append(chip_smoke.cuda_time_ms(calls[s]))
        r = {"name": name, "shape": f"q 1x{Hq}x{S}x{dqk}, kv 1x{Hkv}x{Skv}x"
             f"{dqk}/{dv} bf16" + (f", window {window}" if window else "")
             + (f", q_offset {off}" if off else "")
             + (f", softcap {cap:g}" if cap else ""),
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
    decs = {"other": load_module(other, "decode_attention", "other_decode"),
            "this": load_module(ROOT, "decode_attention", "this_decode")}
    record["rows"] += decode_rows(builds, decs, gen)
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
