"""The kernels on the ``meta`` device: shapes, dtypes and arithmetic,
no data (the dry run's path, ``launch/dryrun.py``).

Each of the five wrappers routes a ``meta`` tensor here.  Each kernel is
a PyTorch custom operator whose fake implementation returns an output of
the kernel's shape, dtype and layout, and whose flop formula
(``torch.utils.flop_counter``) counts the arithmetic the kernel does on
these inputs: causal attention counts the unmasked (query, key) pairs,
decode the live cache positions.  Running the plain version instead
would reckon what the kernel never allocates (a 32768-token prefill's
S x S scores).  The operators have no implementation on any real device:
there the wrappers launch the kernels themselves.
"""
import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula


def _meta_only(name: str):
    raise RuntimeError(f"repro_torch::{name} runs on the meta device only")


def _tri(n: int) -> int:
    return n * (n + 1) // 2 if n > 0 else 0


def attention_pairs(S: int, Skv: int, causal: bool, window: int,
                    q_offset: int = 0) -> int:
    """(query, key) pairs causal attention with an optional window
    computes: the query at position p = q_offset + i sees keys
    max(0, p - window + 1) .. min(p, Skv - 1)."""
    if not causal:
        return S * Skv
    a, b = q_offset, q_offset + S - 1          # the queries' positions
    if window > 0:
        b = min(b, Skv + window - 2)    # later queries' bands hold no key
    # sum over p of min(p + 1, Skv): p + 1 up to Skv - 1, then Skv
    c = min(b, Skv - 1)
    pairs = (_tri(c + 1) - _tri(a) if c >= a else 0) \
        + Skv * max(0, b - max(a, Skv) + 1)
    if window > 0:
        # minus the keys below the band: sum over p of max(0, p - window + 1)
        lo = max(a, window)
        if b >= lo:
            pairs -= _tri(b - window + 1) - _tri(lo - window)
    return pairs


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: int, q_offset: int, softcap: float) -> Tensor:
    _meta_only("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal, window, q_offset, softcap):
    B, Hq, S, _ = q.shape
    # the kernel's (B,Hq,S,dv) view of a contiguous (B,S,Hq,dv) buffer
    return q.new_empty((B, S, Hq, v.shape[-1])).transpose(1, 2)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, q_offset,
                 softcap, *args, out_shape=None, **kwargs) -> int:
    B, Hq, S, dqk = q_shape
    pairs = attention_pairs(S, k_shape[2], causal, window, q_offset)
    return 2 * B * Hq * pairs * (dqk + v_shape[-1])


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     pos: int) -> Tensor:
    _meta_only("decode_attention")


@decode_attention.register_fake
def _(q, k_cache, v_cache, pos):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_flops(q_shape, k_shape, v_shape, pos, *args, out_shape=None,
                  **kwargs) -> int:
    B, Hq, dh = q_shape
    return 4 * B * Hq * (pos + 1) * dh


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def rglru_scan(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    _meta_only("rglru_scan")


@rglru_scan.register_fake
def _(a, b, h0):
    return torch.empty_like(a)


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _scan_flops(a_shape, b_shape, h0_shape, *args, out_shape=None,
                **kwargs) -> int:
    B, S, D = a_shape
    return 2 * B * S * D


@torch.library.custom_op("repro_torch::gemm", mutates_args=())
def gemm(a: Tensor, b: Tensor, acc: Tensor | None,
         out_dtype: torch.dtype) -> Tensor:
    _meta_only("gemm")


@gemm.register_fake
def _(a, b, acc, out_dtype):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype)


@register_flop_formula(torch.ops.repro_torch.gemm)
def _gemm_flops(a_shape, b_shape, acc_shape, out_dtype, *args,
                out_shape=None, **kwargs) -> int:
    M, K = a_shape
    N = b_shape[1]
    return 2 * M * N * K + (M * N if acc_shape is not None else 0)
