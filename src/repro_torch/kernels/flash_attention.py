"""Causal flash attention (twin of the reference's
``kernels/flash_attention.py``), with an optional local window.

On a CUDA tensor this launches a kernel that skips fully masked KV tiles
rather than masking them and keeps (m, l, acc) on chip, so nothing
score-sized reaches device memory: bf16 (the serving path) runs on the
tensor cores (``csrc/flash_attention_mma.cu``), fp32 (the parity path) on
the FFMA kernel of ``csrc/flash_attention.cu``.  On a CPU tensor it runs
the plain version in ``kernels/ref.py``.  ``window > 0`` keeps the
keys k with q - window < k <= q, the banded attention of the reference's
``models/attention.py::local_attention``.

Layout: q (B,Hq,S,dh), k/v (B,Hkv,S,dh), any strides with a contiguous
last dimension; GQA maps query head h to KV head h // G.  The output is
a (B,Hq,S,dh) view of a contiguous (B,S,Hq,dh) buffer, so the model's
``transpose(1, 2)`` back to its own layout costs no copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated by both kernels


def flash_attention_tpu(q, k, v, *, causal: bool = True, block_q: int = 512,
                        block_kv: int = 512, window: int = 0):
    """q (B,Hq,S,dh), k/v (B,Hkv,S,dh) -> (B,Hq,S,dh).

    ``block_q``/``block_kv`` keep the reference's divisibility asserts;
    the CUDA kernel tiles on its own and masks the ragged edge.
    ``window`` 0 means none; a window needs ``causal``.
    """
    B, Hq, S, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    bq, bkv = min(block_q, S), min(block_kv, Skv)
    assert S % bq == 0 and Skv % bkv == 0
    if window < 0 or (window > 0 and not causal):
        raise ValueError(f"window={window} needs causal attention and >= 0")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v dtypes differ")
    if v.shape != k.shape:
        raise ValueError("k and v shapes differ")
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError("flash kernel needs a contiguous last dim and "
                             "one device")
    if q.dtype == torch.bfloat16:
        _build.check_aligned(q, k, v)      # 16-byte cp.async row copies
        name = "repro_flash_attention_bf16"
    elif q.dtype == torch.float32:
        name = "repro_flash_attention_f32"
    else:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    out = torch.empty((B, S, Hq, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    err = getattr(_build.lib(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        S, Skv, dh, int(causal), int(window),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        dh ** -0.5, _build.stream_ptr(q))
    _build.check(err, name)
    _build.LAUNCHES["flash_attention"] += 1
    return out
