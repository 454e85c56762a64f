"""Causal flash attention (twin of the reference's
``kernels/flash_attention.py``), with an optional local window, query
offset and score cap.

On a CUDA tensor this launches a kernel that skips fully masked KV tiles
rather than masking them and keeps (m, l, acc) on chip, so nothing
score-sized reaches device memory: bf16 (the serving path) runs on
Hopper's tensor cores (``csrc/flash_attention_wgmma.cu``: ``wgmma`` fed by
TMA, a producer warpgroup and one or two consumer warpgroups; route
"wgmma", tiled by its ``REPRO_FLASH_WGMMA_TILING`` table, whose tiles,
grid and order :func:`flash_plan` computes for the CPU tests), fp32 (the
parity path) on the FFMA kernel of ``csrc/flash_attention.cu`` (route "ffma").
``_build.FLASH_ROUTES`` counts the launches of each route.  On a CPU
tensor it runs the plain version in ``kernels/ref.py``, on a meta tensor
its shapes (``kernels/meta.py``).  Query row i sits at position
``q_offset`` + i (the reference's jnp ``flash_attention``'s chunked
prefill); ``window > 0`` keeps the keys k with p - window < k <= p for the
query at position p, the banded attention of the reference's
``models/attention.py::local_attention``; ``softcap`` c maps each scaled
score s to c * tanh(s / c) before the mask, as the reference's jnp
function does.

Layout: q (B,Hq,S,dqk), k (B,Hkv,Skv,dqk), v (B,Hkv,Skv,dv), any strides
with a contiguous last dimension; GQA maps query head h to KV head h // G.
The value head dim may differ from the key's (MLA's prefill: dqk 192, dv
128), and the scale is dqk ** -0.5, as the reference's jnp flash computes
it.  The output is a (B,Hq,S,dv) view of a contiguous (B,S,Hq,dv) buffer,
so the model's ``transpose(1, 2)`` back to its own layout costs no copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build, meta, ref

NEG_INF = -1e30
# (dqk, dv) pairs instantiated by both kernels (their dispatch macros):
# square dims for the attention families, DeepSeek-V2's MLA prefill
# (192 = 128 nope + 64 rope, 128) and its smoke config's (24, 16); the
# tensor-core kernel reads a dqk of 24 as 24 columns and zeros (TMA's fill)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (256, 256),
             (192, 128), (24, 16))

SMEM_MAX = 232448       # bytes of shared memory an H100 block may use
MAX_STAGES = 4
ATOM = 64               # bf16 columns of one 128-byte swizzled row


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_tiling(dqk: int, dv: int) -> Tuple[int, int, int]:
    """(consumer warpgroups, keys a tile, ring stages) of the bf16 kernel
    at one (dqk, dv) pair: its ``REPRO_FLASH_WGMMA_TILING`` table.  One
    warpgroup (64 query rows a block) where a head dim passes 128, so that
    the hybrid's 10 heads and MLA's 16 still make 80 and 128 blocks of a
    512-token prompt, else two; 64 keys a tile at dv 256 (the output
    accumulator takes 128 registers a thread), else 128; as many stages,
    at most ``MAX_STAGES``, as the block's shared memory holds."""
    consumers = 1 if max(dqk, dv) > 128 else 2
    bkv = 64 if dv > 128 else 128
    stages = max(s for s in range(1, MAX_STAGES + 1)
                 if _smem(dqk, dv, consumers, bkv, s) <= SMEM_MAX)
    return consumers, bkv, stages


def _smem(dqk, dv, consumers, bkv, stages) -> int:
    """Q (64 rows a consumer), the ring of K and V tiles, all in atoms of
    64 columns x 128 bytes; the Q barrier and three a stage (full K, full
    V, empty); 1024 bytes to align the swizzled tiles."""
    qa, va = _cdiv(dqk, ATOM), _cdiv(dv, ATOM)
    return (1024 + 64 * consumers * 128 * qa + stages * bkv * 128 * (qa + va)
            + (3 * stages + 1) * 8)


@dataclass(frozen=True)
class FlashPlan:
    """How one bf16 call runs on ``csrc/flash_attention_wgmma.cu``: a grid
    of (B * Hq, row blocks) blocks of ``bq`` query rows (``consumers``
    warpgroups of 64) plus a producer warpgroup; K and V tiles of ``bkv``
    keys through a ring of ``stages``; every tile in ``swizzle``-byte
    swizzled atoms; two consumer warpgroups take turns at the tensor
    cores.  ``capped`` says which object runs: the one built with
    ``-DREPRO_FLASH_CAP=1`` (same tiling).  ``order[y]`` is the row block
    of blockIdx.y: the heaviest first when causal.  ``kv_tiles(qb)`` is
    the first key and the tile count that row block visits, the kernel's
    own arithmetic."""
    consumers: int
    bq: int
    bkv: int
    stages: int
    smem_bytes: int
    grid: Tuple[int, int]
    S: int
    Skv: int
    causal: bool
    window: int
    q_offset: int
    capped: bool

    @property
    def swizzle(self) -> int:
        """Bytes of one swizzled row: ``ATOM`` bf16 columns."""
        return 2 * ATOM

    @property
    def threads(self) -> int:
        return 128 * (self.consumers + 1)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def order(self) -> Tuple[int, ...]:
        n = self.grid[1]
        return tuple(range(n - 1, -1, -1)) if self.causal else tuple(range(n))

    def kv_tiles(self, qb: int) -> Tuple[int, int]:
        """(first key, tiles) of row block ``qb``: causal stops at the
        diagonal of its last row, a window starts at the tile that holds
        the band of its first row (positions are ``q_offset`` + row)."""
        q0 = qb * self.bq
        p_first = self.q_offset + q0
        p_last = self.q_offset + min(q0 + self.bq, self.S) - 1
        end = min(self.Skv, p_last + 1) if self.causal else self.Skv
        begin = (max(0, p_first - self.window + 1) // self.bkv * self.bkv
                 if self.window > 0 else 0)
        return begin, (_cdiv(end - begin, self.bkv) if end > begin else 0)

    def warpgroup_tiles(self, qb: int, w: int) -> Tuple[int, int]:
        """The tiles [lo, hi) of row block ``qb``'s ``kv_tiles`` on which
        consumer warpgroup ``w`` (rows qb * bq + 64 w ..) runs its
        products.  Two warpgroups take turns at the tensor cores, so both
        walk every tile (one dead for all a warpgroup's rows is masked
        whole); a lone one skips the tiles dead for all its rows, which lie
        before and after its live ones."""
        first, n = self.kv_tiles(qb)
        if self.consumers == 2:
            return 0, n
        r0 = qb * self.bq + 64 * w
        w_first = self.q_offset + r0
        w_last = self.q_offset + min(r0 + 64, self.S) - 1

        def dead(t):
            k0 = first + t * self.bkv
            return r0 >= self.S or (self.causal and k0 > w_last) or (
                self.window > 0 and k0 + self.bkv - 1 <= w_first - self.window)
        lo, hi = 0, n
        while lo < hi and dead(lo):
            lo += 1
        while hi > lo and dead(hi - 1):
            hi -= 1
        return lo, hi


def flash_plan(B: int, Hq: int, Hkv: int, S: int, Skv: int, dqk: int,
               dv: int, causal: bool = True, window: int = 0,
               q_offset: int = 0, softcap: float | None = None) -> FlashPlan:
    """The bf16 kernel's tiling, grid, row-block order and KV-tile ranges
    for q (B,Hq,S,dqk) against k (B,Hkv,Skv,dqk), v (B,Hkv,Skv,dv)."""
    if (dqk, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (dqk, dv) = {(dqk, dv)} not in "
                         f"{HEAD_DIMS}")
    consumers, bkv, stages = flash_tiling(dqk, dv)
    bq = 64 * consumers
    return FlashPlan(consumers=consumers, bq=bq, bkv=bkv, stages=stages,
                     smem_bytes=_smem(dqk, dv, consumers, bkv, stages),
                     grid=(B * Hq, _cdiv(S, bq)), S=S, Skv=Skv,
                     causal=bool(causal), window=int(window),
                     q_offset=int(q_offset), capped=bool(softcap))


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
        _build.check_aligned(q, k, v)      # TMA: 16-byte bases and strides
        route, name = "wgmma", "repro_flash_attention_bf16"
    elif q.dtype == torch.float32:
        route, name = "ffma", "repro_flash_attention_f32"
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
    _build.FLASH_ROUTES[route] += 1
    return out
