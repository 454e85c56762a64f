"""hi_wait_p90_ms (program span): HI due time to the start of its own
prefill call, at p90 over the HI due in the window before the profiled
slice: the wait behind the LO work that was running (and a context save)
before HI got the card."""
from bench.metrics._common import hi_due, p90


def read(run):
    start = {s["rid"]: s["t0"] for s in run.spans if s["kind"] == "prefill"}
    return p90([(start[r["rid"]] - r["due"]) * 1e3 if r["rid"] in start
                else float("inf") for r in hi_due(run, run.clean_s)])
