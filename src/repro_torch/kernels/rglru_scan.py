"""RG-LRU linear recurrence (twin of the reference's
``kernels/rglru_scan.py``).

h_t = a_t * h_{t-1} + b_t along S.  On a CUDA tensor this launches
``csrc/rglru_scan.cu``: one thread per (batch, channel) walks S with h in
a register, loads coalesced along D, so a and b are read once and h
written once.  On a CPU tensor it runs the plain version in
``kernels/ref.py``.

Inputs a, b fp32 (B, S, D) (precomputed gates; see models.recurrent);
h0 (B, D) initial state.  Returns h (B, S, D) in a's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def rglru_scan_tpu(a, b, h0, *, block_s: int = 256, block_d: int = 256):
    """a,b (B,S,D) fp32; h0 (B,D) -> h (B,S,D).

    ``block_s``/``block_d`` keep the reference's divisibility asserts;
    the CUDA kernel tiles on its own.
    """
    B, S, D = a.shape
    bs, bd = min(block_s, S), min(block_d, D)
    assert S % bs == 0 and D % bd == 0
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    if b.shape != a.shape or tuple(h0.shape) != (B, D):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)} do not match")
    for t in (a, b, h0):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru kernel takes float32, got {t.dtype}")
        if not t.is_contiguous() or t.device != a.device:
            raise ValueError("rglru kernel needs contiguous tensors on one "
                             "device")
    out = torch.empty_like(a)
    err = _build.lib().repro_rglru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), B, S, D,
        _build.stream_ptr(a))
    _build.check(err, "repro_rglru_scan")
    _build.LAUNCHES["rglru_scan"] += 1
    return out
