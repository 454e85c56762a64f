"""lo_prefill_ms_per_ktok (program span): wall time of the LO documents'
``lm.prefill`` calls in the window before the profiled slice,
synchronised at both ends (traced run), per 1000 prompt tokens.  Every
LO prompt of a cell has one length S, so the share of the bf16 peak the
prefill reaches is ``flops.prefill_flops(conf, S) * 1000 / S`` over this
time and 989 TFLOP/s: one reading, not a second metric."""
from bench.metrics._common import clean_spans


def read(run):
    spans = clean_spans(run, "prefill", "LO")
    tokens = sum(s["tokens"] for s in spans)
    if not tokens:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) * 1e6 / tokens
