"""Nested-dict trees of tensors, walked as JAX walks a pytree of dicts.

JAX flattens a dict in sorted-key order, and Python dicts keep insertion
order.  The optimizer's global norm sums its leaves in that order and a
checkpoint's ``.npz`` lists its arrays in it, so every walk here goes
through the keys sorted, and every tree built here holds them sorted.

``to_numpy`` / ``from_numpy`` carry a tensor to a numpy array and back;
numpy has no bfloat16, so a bf16 tensor travels as its uint16 bits and
the dtype name ``"bfloat16"`` (the reference's ``ml_dtypes`` arrays have
that name too, and are read by it without importing ``ml_dtypes``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in sorted-key order; paths join keys with ``/``, as
    the reference's checkpoint keys do."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on each leaf of ``tree`` and the leaves at the same paths of
    ``rest``; the result's dicts hold their keys sorted."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(template, flat: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf taken from ``flat`` by its
    path; a path missing from ``flat`` raises ``KeyError``."""
    if isinstance(template, dict):
        return {k: tree_unflatten(template[k], flat, f"{prefix}{k}/")
                for k in sorted(template)}
    if prefix[:-1] not in flat:
        raise KeyError(f"checkpoint missing {prefix[:-1]}")
    return flat[prefix[:-1]]


def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array, dtype name); bf16 as its uint16 bits named ``bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def from_numpy(a: np.ndarray, dtype: str = None) -> torch.Tensor:
    """A tensor holding ``a``; ``dtype`` (default: ``a``'s dtype name)
    ``bfloat16`` reads ``a`` as bf16 values or their 16-bit pattern."""
    a = np.asarray(a)
    if (dtype or a.dtype.name) == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))
