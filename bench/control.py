"""The readings a cell's correctness limit is set from, on the card at the
cell's own size: the program's widest served-token gap on each seed
(sound runs: the lower reading) and, on the first ``--control`` seeds,
the fp8 control's on the same sample (the upper one), each judged by
``check.judge`` against the configuration's limit: the control has to
come out not correct.  One process, a
short window a seed, long enough to finish as many requests as a run
compares.

    python3 -m bench.control --workload dsv2lite.longdoc8k \
        --seeds 101,102,103 --control 3 --seconds 30 --out result.json
"""
import time

import argparse
import json
import sys

from bench.run import ROOT, banned_modules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from bench import check, harness, spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        run, numbers, attempted, failed, peak = harness.run_cell(
            cell, seed, args.seconds, False, "cuda", t,
            control=i < args.control)
        metrics = {k: v["value"] for k, v in
                   spec.read_metrics(cell.end_to_end, run).items()}
        row = dict(seed=seed, failed=failed, attempted=attempted,
                   wall_s=time.monotonic() - t, **metrics, **numbers,
                   correct=check.judge(cell.config, numbers, failed)[0])
        if "control_gap" in numbers:
            row["control_correct"] = check.judge_control(cell.config,
                                                         numbers)
        rows.append(row)
        print(json.dumps(row), flush=True)
    gaps = [r["gap"] for r in rows]
    ctl = [r["control_gap"] for r in rows if "control_gap" in r]
    summary = {"workload": args.workload, "lower": max(gaps),
               "upper": min(ctl) if ctl else None,
               "runs_correct": sum(r["correct"] for r in rows),
               "controls_correct": sum(r.get("control_correct", False)
                                       for r in rows),
               "rows": rows, "banned": banned_modules()}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
