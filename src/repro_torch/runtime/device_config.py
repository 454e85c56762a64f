"""Environment configuration of the port (partial twin of the reference's
``runtime/device_config.py``).

Only the validated integer read is here: the lockstep engine's
interrupt-table knobs ``REPRO_JIT_TABLE_WIDTH`` / ``REPRO_JIT_TABLE_MAX``
go through :func:`_env_int`.  The reference's XLA host-device pool
(``REPRO_DEVICES``, ``configure_host_devices``) has no counterpart: the
port runs on one CUDA card (``runtime.device``).
"""
from __future__ import annotations

import os
from typing import Optional


def _env_int(name: str, default: int, minimum: int = 1,
             maximum: Optional[int] = None) -> int:
    """Read an integer env override, rejecting junk loudly.

    A misconfigured knob fails at startup with the variable named; it
    never falls back to the default quietly.
    """
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer; set {name} to an "
            f"integer >= {minimum} or unset it") from None
    if val < minimum:
        raise ValueError(
            f"{name}={raw!r} must be >= {minimum}; fix or unset {name}")
    if maximum is not None and val > maximum:
        raise ValueError(
            f"{name}={raw!r} exceeds the maximum of {maximum}; fix or "
            f"unset {name}")
    return val
