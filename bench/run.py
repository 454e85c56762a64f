"""Run one cell of ``BENCHMARK.json`` on the card and print its result as
the last line of standard output (one JSON object).

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (spans synchronised, a profiled slice of the window).
Every run checks what the window served against the plain reference and
prints each number compared beside its limit, last on standard error and
last in the result.  It exits non-zero and prints no result when no card
(or too few) is visible, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.monotonic()      # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may load: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(names=None):
    """The banned top-level names among ``names`` (default: loaded)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def host_probe_ms() -> float:
    """Milliseconds this host takes for a fixed pure-Python loop: a
    reading of the host's speed beside each run, since the eager serving
    loop is paced by the host."""
    t = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i & 7
    return (time.perf_counter() - t) * 1e3


def cuda_probe_us():
    """Microseconds a tiny CUDA launch costs the host (2000 in a row) and
    a launch with its result read back (500): the host-side costs that
    the eager decode steps pay thousands of times a window."""
    import torch
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    launch = (time.perf_counter() - t) / 2000 * 1e6
    t = time.perf_counter()
    for _ in range(500):
        x.add_(1).item()
    return launch, (time.perf_counter() - t) / 500 * 1e6


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _details(run, numbers):
    hi = [r for r in run.requests
          if r["crit"] == "HI" and 0 <= r["due"] < run.seconds]
    lo_done = [r for r in run.requests if r["crit"] == "LO" and r["done"]
               and r["finished"] <= run.seconds]
    deadline = run.traffic["hi"]["deadline_s"]
    miss = sum(1 for r in hi if not r["done"]
               or r["finished"] - r["due"] > deadline)
    lo_tok = sum(r["generated"] for r in lo_done)
    saves = sum(1 for s in run.spans if s["kind"] == "save")
    _log(f"HI due {len(hi)}, finished {sum(r['done'] for r in hi)}, "
         f"past the {deadline} s deadline {miss}; LO documents finished "
         f"{len(lo_done)}, LO output tokens/s {lo_tok / run.seconds}; "
         f"context saves {saves}")
    lat = sorted(round(float(r["finished"] - r["due"]) * 1e3, 1)
                 for r in hi if r["done"])
    _log(f"HI latencies, ms, sorted: {lat}")
    for b in range(0, int(run.seconds + 0.999), 10):
        st = [d for t, d, _ in run.steps if b <= t < b + 10]
        docs = sum(1 for r in lo_done if b <= r["finished"] < b + 10)
        if st:
            _log(f"window {b}-{b + 10} s: {len(st)} steps, mean "
                 f"{1e3 * sum(st) / len(st)} ms, longest {1e3 * max(st)} "
                 f"ms; LO documents finished {docs}")
    _log(f"compared {numbers['tokens']} served tokens: {numbers['lo_docs']} "
         f"LO documents ({numbers['saved_docs']} saved and restored), "
         f"{numbers['hi_requests']} HI requests, in {numbers['check_s']} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program builds its kernels into build/repro_torch_kernels inside
    # the checkout (kernels/_build.py) and runs no Triton kernel
    host_ms = host_probe_ms()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from bench import check, harness, spec
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"{args.workload} needs {cell.chips} CUDA device(s); "
             f"available: {torch.cuda.is_available()}, count: "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    traced = bool(args.trace)
    run, numbers, attempted, failed, peak = harness.run_cell(
        cell, args.seed, args.seconds, traced, "cuda", T_START)
    bad = banned_modules()
    if bad:
        _log(f"loaded modules with banned top-level names: {bad}")
        return 3
    metrics = spec.read_metrics(cell.metrics(traced), run)
    correct, checks = check.judge(cell.config, numbers, failed)
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    _log(f"card: {_card_line()}; peaks against the published bf16 "
         f"989 TFLOP/s and 3.35 TB/s")
    launch_us, sync_us = cuda_probe_us()
    _log(f"host: probe loop {host_ms} ms before set-up, {host_probe_ms()} "
         f"ms after the check; a launch {launch_us} us, a launch read back "
         f"{sync_us} us; {len(os.sched_getaffinity(0))} cores")
    _log(f"set-up {run.setup_s} s; memory peak {peak} bytes")
    _details(run, numbers)
    for name, c in checks.items():
        _log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
