"""Task-set generation: the per-point seeding contract (own copy of
``point_seed`` from the reference's ``core/taskgen.py``).

Set ``s`` of a batch anchored at ``seed0`` is generated from
``point_seed(seed0, s) == seed0 + s``, and the run over that set uses the
same seed, so every (seed0, s) point is reproducible in isolation.
"""
from __future__ import annotations


def point_seed(seed0: int, set_index: int) -> int:
    """Deterministic per-point seed: see the module seeding contract."""
    return int(seed0) + int(set_index)
