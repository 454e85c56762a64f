"""mfu (program span): the model operations of every prefill and decode
step that ran in the window before the profiled slice
(``bench/flops.py``: projections, the top-k and shared experts,
attention over live positions, the output head), over those seconds at
the card's bf16 peak, in %.  A call that straddles the end counts its
share inside (traced run)."""
from bench import flops
from bench.metrics._common import in_window


def read(run):
    c = run.conf
    end = run.clean_s
    total = 0.0
    for s in run.spans:
        share = in_window(run, s["t0"], s["t1"], end)
        if s["kind"] == "prefill":
            total += share * flops.prefill_flops(c, s["tokens"])
        elif s["kind"] == "decode":
            total += share * flops.decode_flops(c, s["pos"])
    if not total or end <= 0:
        return None
    return 100.0 * total / (end * flops.peak(run.device_kind, "bf16_flops"))
