"""Weights from the seed, made on the device in the parameter layout that
the configuration file writes out (``params``: one entry a leaf, with its
dotted path, shape, dtype and init).

Every ``normal`` leaf is drawn by one generator on the device, in its
serving dtype, in calls of at most 2**30 elements; ``zeros`` leaves (the
norm scales, read as 1 + scale) are zero.  The program and the plain
reference get the same tensors.
"""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_CHUNK = 1 << 30


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split(".")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def make_params(layout, seed: int, device) -> dict:
    """The parameter tree of ``layout`` with values drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = {}
    for entry in layout:
        t = torch.empty(entry["shape"], dtype=DTYPES[entry["dtype"]],
                        device=device)
        if entry["init"] == "zeros":
            t.zero_()
        else:
            refill(t, g, entry["std"])
        flat[entry["path"]] = t
    return _nest(flat)


def refill(t: torch.Tensor, g: torch.Generator, std: float) -> None:
    flat = t.view(-1)
    for i in range(0, flat.numel(), _CHUNK):
        flat[i:i + _CHUNK].normal_(0.0, std, generator=g)
