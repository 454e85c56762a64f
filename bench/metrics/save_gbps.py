"""save_gbps (program span): bytes of the contexts moved by
``core/serving.py::_move_cache`` to the host over the calls' time,
synchronised (traced run), in GB/s.  Nothing when no context moved."""


def read(run):
    spans = [s for s in run.spans if s["kind"] == "save"]
    secs = sum(s["t1"] - s["t0"] for s in spans)
    if not spans or secs <= 0:
        return None
    return sum(s["bytes"] for s in spans) / secs / 1e9
