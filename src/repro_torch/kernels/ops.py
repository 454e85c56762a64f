"""Public wrappers for the kernels (twin of the reference's ``kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written kernel, or the call raises.  There
is no fallback from one to the other.  The kernels have no backward: on
any device, a call that autograd would record (grad mode on, an input
that requires grad) raises ``RuntimeError``.  ``_build.LAUNCHES`` counts
the kernel launches of each wrapper.

Inside ``runtime.sharding.axis_rules`` the model hands the attention and
scan wrappers DTensors; these run the same kernel on each rank's local
shards (``sharding.attention_local``, ``sharding.local_call``), so a
kernel never sees a DTensor.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor

from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.decode_attention import decode_attention_tpu
from repro_torch.kernels.flash_attention import flash_attention_tpu
from repro_torch.kernels.rglru_scan import rglru_scan_tpu
from repro_torch.kernels.systolic_gemm import gemm_partial, systolic_gemm
from repro_torch.runtime import sharding


def gemm(a, b, *, bm=256, bn=256, bk=256):
    return systolic_gemm(a, b, bm=bm, bn=bn, bk=bk)


def gemm_resume(a, b, acc, k_begin, k_end, *, bk=256):
    """Preemptible GEMM step: process K blocks [k_begin, k_end)."""
    return gemm_partial(a, b, acc, k_begin, k_end, bk=bk)


def flash_attention(q, k, v, *, causal=True, block_q=512, block_kv=512,
                    window=0, q_offset=0, softcap=None):
    kw = dict(causal=causal, block_q=block_q, block_kv=block_kv,
              window=window, q_offset=q_offset, softcap=softcap)
    if isinstance(q, DTensor):
        return sharding.attention_local(flash_attention_tpu, q, k, v, **kw)
    return flash_attention_tpu(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, pos, *, block_s=1024,
                     pos_top=None):
    kw = dict(block_s=block_s, pos_top=pos_top)
    if isinstance(q, DTensor):
        return sharding.attention_local(decode_attention_tpu, q, k_cache,
                                        v_cache, pos, **kw)
    return decode_attention_tpu(q, k_cache, v_cache, pos, **kw)


def rglru(a, b, h0, *, block_s=256, block_d=256):
    kw = dict(block_s=block_s, block_d=block_d)
    if isinstance(a, DTensor):
        # the recurrence runs along S: keep S whole, channels on 'model'
        return sharding.local_call(rglru_scan_tpu, (a, b, h0),
                                   (("batch", None, "model"),
                                    ("batch", None, "model"),
                                    ("batch", "model")), 0, **kw)
    return rglru_scan_tpu(a, b, h0, **kw)
