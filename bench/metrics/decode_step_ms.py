"""decode_step_ms (program span): wall time of one ``lm.decode_step``
call, synchronised at both ends (traced run), the mean over the calls of
HI and LO requests in the window before the profiled slice."""
from bench.metrics._common import clean_spans


def read(run):
    ms = [(s["t1"] - s["t0"]) * 1e3 for s in clean_spans(run, "decode")]
    return sum(ms) / len(ms) if ms else None
