"""lo_prompt_tokens_per_s (host clock): LO documents processed in the
window, in prompt tokens, over the window's seconds.  The two clients'
documents are served one after the other (LO requests in arrival order),
so each document is counted by the share of its service, from its
prefill call to its last token, that lies in the window: the documents at
the window's ends count in part, and the rate does not move in steps of
a whole document."""
from bench.metrics._common import in_window


def read(run):
    done = {r["rid"]: r["finished"] for r in run.requests
            if r["crit"] == "LO" and r["done"]}
    tokens = 0.0
    for s in run.spans:
        if s["kind"] == "prefill" and s["crit"] == "LO" and s["rid"] in done:
            tokens += s["tokens"] * in_window(run, s["t0"], done[s["rid"]])
    return tokens / run.seconds if tokens else None
