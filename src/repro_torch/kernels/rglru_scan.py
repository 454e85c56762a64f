"""RG-LRU linear recurrence (twin of the reference's
``kernels/rglru_scan.py``).

h_t = a_t * h_{t-1} + b_t along S.  On a CUDA tensor this launches
``csrc/rglru_scan.cu`` as :func:`scan_plan` lays it out: a block owns C
consecutive channels of one batch row, so B * ceil(D / C) blocks fill the
card; one lane per channel walks S in order with h in a register (so the
result equals the plain version bit for bit), while the block's other
warps keep a ring of (T steps x C channels) tiles of a and b in flight
into shared memory by cp.async.  a and b are read once and h written
once.  On a CPU tensor it runs the plain version in ``kernels/ref.py``,
on a meta tensor its shapes (``kernels/meta.py``).

Inputs a, b fp32 (B, S, D) (precomputed gates; see models.recurrent);
h0 (B, D) initial state.  Returns h (B, S, D) in a's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build, meta, ref

N_SM = 132                      # the H100 SXM's SMs
# what csrc/rglru_scan.cu instantiates: channels a block owns (one chain
# lane each, one warp at most), steps a ring stage holds, ring depths
CHANNELS = (8, 16, 32)
STEPS = (64, 128)
STAGES = (3, 4)
# the plan's tile and ring (chip_smoke.py phase 6 times the others)
PLAN_STEPS = 128
PLAN_STAGES = 3
MAX_GRID_Y = 65535              # batch rows, the grid's y


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ScanPlan:
    """How one (B, S, D) call runs: block x owns channels
    [x * channels, min((x + 1) * channels, D)) of batch row y; ``route``
    "cp16" copies 16 bytes at a time, "cp4" 4 bytes; the ring holds
    ``stages`` tiles of ``steps`` x ``channels`` of a and of b."""
    B: int
    S: int
    D: int
    route: str
    channels: int
    steps: int
    stages: int

    @property
    def grid(self) -> Tuple[int, int]:
        return (_cdiv(self.D, self.channels), self.B)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def smem_bytes(self) -> int:
        return self.stages * 2 * self.steps * self.channels * 4

    def block_channels(self, x: int) -> range:
        """The channels block x (of any batch row) runs, one chain lane
        each."""
        return range(x * self.channels,
                     min((x + 1) * self.channels, self.D))


def scan_plan(B: int, S: int, D: int, *, a_ptr: int = 0, b_ptr: int = 0,
              n_sm: int = N_SM) -> ScanPlan:
    """The block width, tile and route of a contiguous (B, S, D) scan whose
    a and b start at ``a_ptr`` and ``b_ptr``.

    Channels: the widest of ``CHANNELS`` whose grid still has ``n_sm``
    blocks (one full wave; wider blocks copy longer rows), else the
    narrowest (the most blocks): (1, 512, 2560) takes 16 (160 blocks; 32
    gives 80).  Tile and ring: ``PLAN_STEPS`` x ``PLAN_STAGES``.  Route
    "cp16" where every row starts 16-byte aligned (D a multiple of 4, both
    bases 16-byte aligned), else "cp4".  A shape the kernel does not take
    raises ValueError."""
    if min(B, S, D) <= 0:
        raise ValueError(f"scan of an empty shape {(B, S, D)}")
    if B > MAX_GRID_Y:
        raise ValueError(f"scan kernel takes at most {MAX_GRID_Y} batch "
                         f"rows, got {B}")
    full = [c for c in CHANNELS if B * _cdiv(D, c) >= n_sm]
    vec = D % 4 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0
    return ScanPlan(B, S, D, "cp16" if vec else "cp4",
                    max(full) if full else min(CHANNELS), PLAN_STEPS,
                    PLAN_STAGES)


def launch_plan(a, b, h0, plan: ScanPlan):
    """Launch the scan kernel as ``plan`` says on checked CUDA tensors;
    returns h.  Counts no launch: the wrapper does.  A plan with another
    instantiation (``dataclasses.replace`` of channels, steps, stages or
    route, as chip_smoke.py's sweep makes) runs that one; one the kernel
    does not instantiate raises."""
    out = torch.empty_like(a)
    err = _build.lib().repro_rglru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), plan.B,
        plan.S, plan.D, plan.channels, plan.steps, plan.stages,
        int(plan.route == "cp16"), _build.stream_ptr(a))
    _build.check(err, "repro_rglru_scan")
    return out


def rglru_scan_tpu(a, b, h0, *, block_s: int = 256, block_d: int = 256):
    """a,b (B,S,D) fp32; h0 (B,D) -> h (B,S,D).

    ``block_s``/``block_d`` keep the reference's divisibility asserts;
    the CUDA kernel tiles as :func:`scan_plan` says.
    """
    _build.check_no_grad("rglru_scan_tpu", a, b, h0)
    B, S, D = a.shape
    bs, bd = min(block_s, S), min(block_d, D)
    assert S % bs == 0 and D % bd == 0
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    if a.device.type == "meta":
        return meta.rglru_scan(a, b, h0)
    if b.shape != a.shape or tuple(h0.shape) != (B, D):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)} do not match")
    for t in (a, b, h0):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru kernel takes float32, got {t.dtype}")
        if not t.is_contiguous() or t.device != a.device:
            raise ValueError("rglru kernel needs contiguous tensors on one "
                             "device")
    plan = scan_plan(
        B, S, D, a_ptr=a.data_ptr(), b_ptr=b.data_ptr(),
        n_sm=torch.cuda.get_device_properties(a.device).multi_processor_count)
    out = launch_plan(a, b, h0, plan)
    _build.LAUNCHES["rglru_scan"] += 1
    return out
