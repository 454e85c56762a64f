"""Gated MLPs and mixture-of-experts (twin of the reference's
``models/ffn.py``).

The products stay ``torch.matmul`` / ``torch.einsum``: the reference
leaves them to XLA, and no Pallas kernel covers them.

MoE uses sort-based capacity dispatch, as the reference does: the
(token, choice) slots are sorted by expert id (a stable sort, so slots
keep token order inside an expert), packed into per-expert buffers of
capacity C = ``moe_capacity(N, K, E, cf)`` by gathers, run through
batched expert products on (R, E, C, D), and combined by gathers.  A
slot past its expert's capacity is dropped.  Prefill routes per
sequence (rows R = B); decode routes over the batch (R = 1, N = B).
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.runtime.sharding import contiguous_grad, reshape, \
    shard_activation

# (expert ids, top-k margin) of every moe_dispatch call while a
# ``record_routes()`` block is open
_ROUTES: Optional[List[dict]] = None


def _glu(x, p, act):
    if x.ndim == 3:
        x = shard_activation(x, "ffn_in", None)
    h = torch.matmul(x, p["w1"].to(x.dtype))
    g = torch.matmul(x, p["w3"].to(x.dtype))
    h = act(h) * g
    if h.ndim == 3:
        h = shard_activation(h, "ffn_hidden", None)
    y = torch.matmul(h, p["w2"].to(x.dtype))
    if y.ndim == 3:
        # partial sums over 'model' reduce-scatter straight into the
        # S-sharded residual layout (Megatron-SP exit boundary)
        y = shard_activation(y, "residual", None)
    return y


def swiglu(x, p):
    """x (..., D) with params w1,w3 (D,F), w2 (F,D)."""
    return _glu(x, p, F.silu)


def gelu(x):
    """``jax.nn.gelu``, which defaults to the tanh form."""
    return F.gelu(x, approximate="tanh")


def geglu(x, p):
    """Gated-GeLU MLP (RecurrentGemma/Gemma style)."""
    return _glu(x, p, gelu)


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(math.ceil(n_tokens * top_k * cf / n_experts))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


@contextlib.contextmanager
def record_routes():
    """Collect, for every ``moe_dispatch`` call inside the block, the chosen
    experts ``"experts"`` (R, N, K) and ``"margin"`` (R, N), the router
    probability of the k-th choice less the best one not chosen (how
    near the choice came to a tie), both on the CPU."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort keeps equal values in index order; ``torch.topk``
    promises no order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    if _ROUTES is not None:
        nxt = vals[..., k] if k < vals.shape[-1] else torch.zeros_like(
            vals[..., 0])
        _ROUTES.append({"experts": idx[..., :k].cpu(),
                        "margin": (vals[..., k - 1] - nxt).detach().cpu()})
    return vals[..., :k], idx[..., :k]


def _take(a, idx):
    """``take_along_axis(a, idx[..., None], axis=1)`` for a (R, M, D) and
    idx (R, I)."""
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def moe_dispatch(x, p, cfg):
    """Mixture-of-experts FFN without its metrics.  x (R, N, D) ->
    (y (R, N, D), route), where route = (router_logits, probs, eidx,
    slot_valid) is what ``moe_apply``'s metrics are computed from.  The
    serving path calls this and drops ``route``.

    R = routing rows (sorted independently), N = tokens per row.  The
    router logits, softmax and gate normalisation are fp32; the slot
    gates are cast to ``x``'s dtype before they scale the expert
    outputs, as in the reference.
    """
    e = cfg.moe
    R, N, D = x.shape
    E, K = e.num_experts, e.top_k
    C = moe_capacity(N, K, E, e.capacity_factor)
    dev = x.device

    x = shard_activation(x, "moe_tokens", None)
    router_logits = torch.matmul(x, p["router"].to(x.dtype)).float()
    probs = torch.softmax(router_logits, dim=-1)
    gates, eidx = _top_k(probs, K)                                # (R, N, K)
    if K > 1:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # ---- dispatch bookkeeping (all (R, N*K)) ----
    e_flat = eidx.reshape(R, N * K)
    order = torch.sort(e_flat, dim=-1, stable=True).indices      # by expert
    sorted_e = torch.gather(e_flat, 1, order)
    hist = torch.zeros_like(probs[:, 0], dtype=torch.long).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))                       # (R, E)
    starts = torch.cumsum(hist, dim=-1) - hist                   # exclusive
    ar = torch.arange(N * K, device=dev)
    pos_in_e = ar[None, :] - torch.gather(starts, 1, sorted_e)
    tok_sorted = order // K                      # token id per sorted slot

    # destination-major view: slot (e, c) <- sorted position starts[e] + c
    arc = torch.arange(C, device=dev)
    slot = starts[:, :, None] + arc[None, None, :]               # (R, E, C)
    slot_valid = arc[None, None, :] < torch.clamp(hist, max=C)[:, :, None]
    slot_c = torch.clamp(slot, 0, N * K - 1).reshape(R, E * C)
    src_tok = torch.gather(tok_sorted, 1, slot_c)                # (R, E*C)
    gates_flat = torch.gather(gates.reshape(R, N * K), 1, order)
    slot_gate = reshape(torch.gather(gates_flat, 1, slot_c), (R, E, C))
    slot_gate = (slot_gate * slot_valid).to(x.dtype)

    # ---- gather -> expert compute -> gather-based combine ----
    x_e = reshape(_take(x, src_tok), (R, E, C, D))
    x_e = x_e * slot_valid[..., None].to(x.dtype)
    x_e = shard_activation(x_e, "moe_buf", None)                # EP layout
    h = torch.einsum("recd,edf->recf", x_e, p["w1"].to(x.dtype))
    g = contiguous_grad(torch.einsum("recd,edf->recf", x_e,
                                     p["w3"].to(x.dtype)))
    h = contiguous_grad(shard_activation(h, "moe_buf", None))
    y_e = torch.einsum("recf,efd->recd", (F.silu(h) * g).contiguous(),
                       p["w2"].to(x.dtype))
    y_e = y_e * slot_gate[..., None]

    # invert the sort: position of every (token, choice) inside its expert
    inv = torch.scatter(torch.empty_like(order), 1, order,
                        ar.expand(R, -1))
    slot_c2 = reshape(torch.gather(pos_in_e, 1, inv), (R, N, K))
    valid_tok = slot_c2 < C
    y_e = shard_activation(y_e, "moe_gathered", None)  # AG experts locally
    flat_idx = (eidx * C + torch.clamp(slot_c2, 0, C - 1)).reshape(R, N * K)
    picked = reshape(_take(y_e.reshape(R, E * C, D), flat_idx),
                     (R, N, K, D))
    y = torch.sum(picked * valid_tok[..., None].to(x.dtype), dim=2)
    y = shard_activation(y, "moe_tokens", None)

    if e.num_shared > 0:
        y = y + swiglu(x, p["shared"])
    return y, (router_logits, probs, eidx, slot_valid)


def moe_apply(x, p, cfg):
    """Mixture-of-experts FFN.  x (R, N, D) -> (y (R, N, D), metrics):
    ``moe_dispatch`` and the Switch-style load balance, router z-loss and
    dropped share of its routing."""
    e = cfg.moe
    R, N, _ = x.shape
    E, K = e.num_experts, e.top_k
    y, (router_logits, probs, eidx, slot_valid) = moe_dispatch(x, p, cfg)
    frac = F.one_hot(eidx, E).float().mean(dim=(1, 2))           # (R, E)
    mean_p = probs.mean(dim=1)
    aux = E * torch.mean(torch.sum(frac * mean_p, dim=-1))
    z = torch.mean(torch.square(torch.logsumexp(router_logits, dim=-1)))
    dropped = 1.0 - slot_valid.sum() / (R * N * K)
    metrics = {"moe_aux": aux * e.aux_coef, "moe_z": z * e.router_z_coef,
               "moe_dropped": dropped}
    return y, metrics
