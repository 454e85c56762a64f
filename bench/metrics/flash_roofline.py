"""flash_roofline (program span, device time): the least time the LO
prefills' causal attention could take on the card (operations at the
bf16 peak, or bytes at HBM bandwidth, whichever is larger;
``bench/flops.py``) over the device time between CUDA events recorded
around each call of ``models/attention.py::flash_attention`` (the module
attribute ``lm.py`` calls; it launches the flash kernel and nothing
else) inside those prefills, in the window before the profiled slice,
in %."""
from bench import flops
from bench.metrics._common import clean_spans


def read(run):
    c = run.conf
    f_peak = flops.peak(run.device_kind, "bf16_flops")
    b_peak = flops.peak(run.device_kind, "hbm_bytes_per_s")
    bound = spent = 0.0
    for s in clean_spans(run, "prefill", "LO"):
        if s.get("flash_s", 0.0) <= 0.0:
            continue
        S = s["tokens"]
        bound += max(flops.attention_flops(c, S, S) / f_peak,
                     flops.attention_bytes(c, S) / b_peak)
        spent += s["flash_s"]
    return 100.0 * bound / spent if spent else None
