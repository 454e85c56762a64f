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


def attention_pairs(S: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs causal attention with an optional window
    computes: query i sees keys max(0, i - window + 1) .. i."""
    if not causal:
        return S * Skv
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: int) -> Tensor:
    _meta_only("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal, window):
    B, Hq, S, _ = q.shape
    # the kernel's (B,Hq,S,dv) view of a contiguous (B,S,Hq,dv) buffer
    return q.new_empty((B, S, Hq, v.shape[-1])).transpose(1, 2)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args,
                 out_shape=None, **kwargs) -> int:
    B, Hq, S, dqk = q_shape
    pairs = attention_pairs(S, k_shape[2], causal, window)
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
