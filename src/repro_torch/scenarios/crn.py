"""Counter-based common-random-number primitives for the scenario layer
(own copy of the reference's ``scenarios/crn.py``).

Every scenario draw is a pure function of a 64-bit key — no host RNG
state, no draw-order dependence — built from the splitmix64 finalizer:

    stream seed   s0  = point_seed64 ^ stream_salt(scenario, component)
    counter       ctr = (entity << 33) + (index << 1)
    draw          u   = u01(mix64(s0 + ctr * GOLD))

``stream_salt`` derives a fixed 64-bit constant per (scenario,
component) name via sha256, so scenario streams are decorrelated from
each other while staying comparable under common random numbers: the
draw for (seed, scenario, entity, index) is the same under every
policy and batch composition, and bit-equal to the reference's.

The helpers run on numpy ``uint64``: the shifts must be logical and the
multiplies must wrap, which numpy's unsigned arithmetic gives.  Their
``*_t`` twins run the same arithmetic on torch int64 tensors for the
lockstep engine, which draws on the device: torch has no uint64 ``>>``
and its int64 ``>>`` is arithmetic, so the twins mask the shifts.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

#: splitmix64 golden-ratio increment.
GOLD = np.uint64(0x9E3779B97F4A7C15)

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def mix64(x):
    """splitmix64 finalizer (uint64 wrap-around is the point, so numpy's
    overflow warning is suppressed)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def u01(bits):
    """Top 53 bits of a uint64 -> uniform double in [0, 1)."""
    return (bits >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def stream_salt(name: str) -> np.uint64:
    """Fixed 64-bit salt for a named scenario stream.

    sha256-derived (first 8 bytes, little-endian), so salts are stable
    across runs and platforms.  The hashed prefix is the reference
    package's name, ``repro.scenario:``, on purpose: the salt is part
    of every draw's key, and another prefix would change every draw."""
    digest = hashlib.sha256(f"repro.scenario:{name}".encode()).digest()
    return np.uint64(int.from_bytes(digest[:8], "little"))


def counter(entity, index):
    """Pack (entity, index) into the draw counter: entity in the high
    bits (task/lane/window id), index shifted left once so the low bit
    stays free for sub-draws."""
    return (entity.astype(np.uint64) << np.uint64(33)) \
        + (index.astype(np.uint64) << np.uint64(1))


def keyed_u01(seed64, salt: np.uint64, entity, index, sub: int = 0):
    """One CRN draw: uniform double keyed (seed, stream, entity, index).

    ``sub`` selects independent sub-draws at the same counter (``+ k *
    GOLD``)."""
    with np.errstate(over="ignore"):
        s = (seed64 ^ salt) + counter(entity, index) * GOLD
        if sub:
            s = s + np.uint64(sub) * GOLD
    return u01(mix64(s))


# ----------------------------------------------------------------------
# torch twins (int64 tensors holding the uint64 bits), for the lockstep
# engine (core.simulator_jit).  torch has no uint64 ``>>``, so a logical
# right shift is an arithmetic shift with the sign-extended bits masked
# off; the wrapping multiply, add and XOR give the same bits in int64 as
# in uint64.
# ----------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def as_int64(u) -> int:
    """The int64 with the bits of the uint64 ``u`` (a Python int)."""
    u = int(u) & _MASK64
    return u - (1 << 64) if u >> 63 else u


_GOLD_I = as_int64(GOLD)
_M1_I = as_int64(_M1)
_M2_I = as_int64(_M2)


def lshr(x, k: int):
    """Logical right shift of int64 ``x`` by ``k`` (0 < k < 64)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64_t(x):
    """splitmix64 finalizer on int64 tensors; bit-equal to :func:`mix64`."""
    x = (x ^ lshr(x, 30)) * _M1_I
    x = (x ^ lshr(x, 27)) * _M2_I
    return x ^ lshr(x, 31)


def u01_t(bits):
    """Top 53 bits -> uniform float64 in [0, 1); equal to :func:`u01`."""
    return lshr(bits, 11).to(torch.float64) * (1.0 / (1 << 53))


def counter_t(entity, index):
    """:func:`counter` on int64 tensors (``index`` may be a Python int)."""
    if isinstance(index, int):
        return (entity.to(torch.int64) << 33) + (index << 1)
    return (entity.to(torch.int64) << 33) + (index.to(torch.int64) << 1)


def keyed_u01_t(seed64, salt, entity, index, sub: int = 0):
    """:func:`keyed_u01` on int64 tensors: ``seed64`` holds the seed's
    bits, ``salt`` is a :func:`stream_salt` value."""
    s = (seed64 ^ as_int64(salt)) + counter_t(entity, index) * _GOLD_I
    if sub:
        s = s + as_int64(sub * int(GOLD))
    return u01_t(mix64_t(s))
