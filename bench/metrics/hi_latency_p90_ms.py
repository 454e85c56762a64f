"""hi_latency_p90_ms (host clock): due (release) time to last token, at
p90 (nearest rank), over every HI request due in the window.  A request
still unfinished after the wait past the close is unbounded; when that
reaches the p90 nothing is reported (the run also counts it failed)."""
from bench.metrics._common import hi_due, p90


def read(run):
    return p90([(r["finished"] - r["due"]) * 1e3 if r["done"]
                else float("inf") for r in hi_due(run)])
