"""Int8 error-feedback gradient compression for slow links (twin of the
reference's ``optim/compression.py``).

Per-tensor symmetric int8 quantization with an error-feedback residual,
so that compression noise does not bias convergence.  ``psum_compressed``
is the all-reduce with an int8 payload: the per-tensor scales agree by a
MAX all-reduce, every rank requantizes against the shared scale, the
int8 values are summed as int32 and dequantized.  The reference runs it
under ``shard_map`` over a mesh axis; here it runs ``torch.distributed``
all-reduces over a process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.pytree import tree_map


def compress_int8(x):
    """x fp -> (q int8, scale fp32). Symmetric per-tensor."""
    x32 = x.float()
    amax = torch.clamp(torch.max(torch.abs(x32)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def ef_compress(g, residual):
    """Error-feedback compression for one tensor.

    Returns ((q, scale), new_residual): the residual carries this round's
    quantization error into the next step.
    """
    x = g.float() + residual
    q, s = compress_int8(x)
    return (q, s), x - decompress_int8(q, s)


def psum_compressed(grads, group=None):
    """All-reduce (sum) the tree ``grads`` over ``group`` (default: the
    world) with an int8 payload; every rank gets the same result, in each
    leaf's dtype."""
    def one(g):
        s_max = compress_int8(g)[1]
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        # requantize against the shared scale so the sums are consistent
        q2 = torch.clamp(torch.round(g.float() / s_max), -127, 127)
        total = q2.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.float() * s_max).to(g.dtype)
    return tree_map(one, grads)
