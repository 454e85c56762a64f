"""moe_ms_per_ktok (program span): device time between CUDA events
recorded around each ``models/ffn.py::moe_dispatch`` call (the module
attribute ``lm.py`` calls) inside the LO documents' prefills, in the
window before the profiled slice, per 1000 prompt tokens (traced run).
Nothing for a model with no expert layer."""
from bench.metrics._common import clean_spans


def read(run):
    spans = [s for s in clean_spans(run, "prefill", "LO") if "moe_s" in s]
    tokens = sum(s["tokens"] for s in spans)
    if not tokens:
        return None
    return sum(s["moe_s"] for s in spans) * 1e6 / tokens
