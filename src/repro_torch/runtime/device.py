"""Device resolution for the port (twin of ``runtime/device_config.py``).

The reference picks an XLA platform with ``set_platform``.  The port
runs on the CUDA card: ``resolve_device()`` returns it and raises when
CUDA is absent.  The CPU is used only when the caller asks for it by
name (the tests do); there is no silent fallback, so a run that reports
device numbers really ran on the device.
"""
from __future__ import annotations

from typing import Union

import torch


def _set_fp32_numerics() -> None:
    # fp32 parity with the reference: TF32 keeps ~3 decimal digits, so an
    # fp32 product or convolution in TF32 would miss the reference
    # tolerances (tests/test_kernels.py rtol 1e-3, the preempt/resume
    # chain rtol 1e-4).  Both switches are set, not assumed.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device the port runs on.

    ``None`` means CUDA and raises ``RuntimeError`` when CUDA is absent.
    ``"cpu"`` must be asked for explicitly.
    """
    _set_fp32_numerics()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the card unless "
            "device='cpu' is passed explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    return dev
