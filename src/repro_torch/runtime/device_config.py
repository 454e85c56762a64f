"""Environment configuration of the port (twin of the reference's
``runtime/device_config.py``).

The lockstep engine (``core.simulator_jit``) can split its point axis
into ``devices`` shards.  In the reference a device is a logical XLA
host device carved out of one CPU (``--xla_force_host_platform_device_count``);
in the port a device is one shard of the point axis with its own runner,
its own captured CUDA graph and its own CUDA stream, all on the one card.
Points are independent, so the count is a throughput knob and changes no
row.

``REPRO_DEVICES`` sets the default count, read through :func:`_env_int`,
which also reads the interrupt-table knobs ``REPRO_JIT_TABLE_WIDTH`` /
``REPRO_JIT_TABLE_MAX``.

No counterpart, by design: the reference's ``configure_host_devices``,
``set_platform`` and ``jax_initialized`` write or read ``XLA_FLAGS`` and
``JAX_PLATFORM_NAME`` before JAX's backend starts.  PyTorch reads no such
flag: shards need no pool carved out ahead of time, and the device is
named per call (``runtime.device.resolve_device``).
"""
from __future__ import annotations

import os
from typing import Optional

# the reference's bound on the logical device count: past it, more
# shards only add scheduling pressure, so a larger request is taken as a
# misconfiguration
MAX_LOGICAL_DEVICES = 256


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


def default_device_count() -> int:
    """Shard count requested via ``REPRO_DEVICES`` (default 1).

    Junk, zero/negative, and oversubscribed (> ``MAX_LOGICAL_DEVICES``)
    values raise ``ValueError`` naming the variable.
    """
    return _env_int("REPRO_DEVICES", 1, minimum=1,
                    maximum=MAX_LOGICAL_DEVICES)


def resolve_device_count(requested: Optional[int] = None) -> int:
    """The shard count the lockstep engine uses: ``requested``, or the
    ``REPRO_DEVICES`` default for ``None``, within
    [1, ``MAX_LOGICAL_DEVICES``].  Shards share one card, so there is no
    pool to clamp to."""
    want = default_device_count() if requested is None else int(requested)
    if want < 1 or want > MAX_LOGICAL_DEVICES:
        raise ValueError(
            f"devices={want} out of range [1, {MAX_LOGICAL_DEVICES}]")
    return want
