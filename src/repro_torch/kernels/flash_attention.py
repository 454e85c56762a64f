"""Causal flash attention (twin of the reference's
``kernels/flash_attention.py``), with an optional local window, query
offset and score cap.

On a CUDA tensor this launches a kernel that skips fully masked KV tiles
rather than masking them and keeps (m, l, acc) on chip, so nothing
score-sized reaches device memory: bf16 (the serving path) runs on the
tensor cores (``csrc/flash_attention_mma.cu``), fp32 (the parity path) on
the FFMA kernel of ``csrc/flash_attention.cu``.  On a CPU tensor it runs
the plain version in ``kernels/ref.py``, on a meta tensor its shapes
(``kernels/meta.py``).  Query row i sits at position ``q_offset`` + i
(the reference's jnp ``flash_attention``'s chunked prefill); ``window >
0`` keeps the keys k with p - window < k <= p for the query at position p,
the banded attention of the reference's ``models/attention.py::
local_attention``; ``softcap`` c maps each scaled score s to
c * tanh(s / c) before the mask, as the reference's jnp function does.

Layout: q (B,Hq,S,dqk), k (B,Hkv,Skv,dqk), v (B,Hkv,Skv,dv), any strides
with a contiguous last dimension; GQA maps query head h to KV head h // G.
The value head dim may differ from the key's (MLA's prefill: dqk 192, dv
128), and the scale is dqk ** -0.5, as the reference's jnp flash computes
it.  The output is a (B,Hq,S,dv) view of a contiguous (B,S,Hq,dv) buffer,
so the model's ``transpose(1, 2)`` back to its own layout costs no copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, meta, ref

NEG_INF = -1e30
# (dqk, dv) pairs instantiated by both kernels (their dispatch macros):
# square dims for the attention families, DeepSeek-V2's MLA prefill
# (192 = 128 nope + 64 rope, 128) and its smoke config's (24, 16); the
# tensor-core kernel pads a dqk of 24 with zero columns to 32
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (256, 256),
             (192, 128), (24, 16))


def flash_attention_tpu(q, k, v, *, causal: bool = True, block_q: int = 512,
                        block_kv: int = 512, window: int = 0,
                        q_offset: int = 0, softcap: float | None = None):
    """q (B,Hq,S,dqk), k (B,Hkv,Skv,dqk), v (B,Hkv,Skv,dv) -> (B,Hq,S,dv).

    ``block_q``/``block_kv`` keep the reference's divisibility asserts;
    the CUDA kernel tiles on its own and masks the ragged edge.
    ``window`` 0 means none; a window needs ``causal``, and with a
    ``q_offset`` the reference's prefill layout Skv == q_offset + S.
    ``q_offset`` (>= 0) is the position of q's first row; ``softcap``
    None means no cap, else a positive cap.
    """
    _build.check_no_grad("flash_attention_tpu", q, k, v)
    B, Hq, S, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    dv = v.shape[-1]
    bq, bkv = min(block_q, S), min(block_kv, Skv)
    assert S % bq == 0 and Skv % bkv == 0
    if window < 0 or (window > 0 and not causal):
        raise ValueError(f"window={window} needs causal attention and >= 0")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset} must be >= 0")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap={softcap} must be None or > 0")
    assert not (window > 0 and q_offset) or Skv == q_offset + S, \
        (Skv, q_offset, S)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, softcap=softcap)
    if q.device.type == "meta":
        return meta.flash_attention(q, k, v, causal, window, q_offset,
                                    softcap or 0.0)
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if (dh, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (dqk, dv) = {(dh, dv)} not in "
                         f"{HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v dtypes differ")
    if v.shape[:-1] != k.shape[:-1] or k.shape[-1] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
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
    out = torch.empty((B, S, Hq, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    err = getattr(_build.lib(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        S, Skv, dh, dv, int(causal), int(window), int(q_offset),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        dh ** -0.5, float(softcap or 0.0), _build.stream_ptr(q))
    _build.check(err, name)
    _build.LAUNCHES["flash_attention"] += 1
    return out
