"""Per-device cost of one step from the operations it dispatches (twin of
the reference's ``runtime/hlo_analysis.py``).

The reference parses the compiled XLA text of a step.  Eager PyTorch
compiles nothing, so the port watches the step run instead: an
:class:`OpStream` dispatch mode sits below DTensor (it declines DTensor
operations, which DTensor then lowers to aten operations on the local
shards and to ``_c10d_functional`` collectives) and records, per rank:

  * dot flops, as ``torch.utils.flop_counter`` counts them (the kernels'
    meta operators register their own formulas, ``kernels/meta.py``);
  * HBM bytes: operand plus output bytes of every operation that
    materialises (views and metadata excluded), the XLA "bytes accessed"
    convention; ``hbm_bytes_no_copies`` leaves out the copies;
  * collectives: per kind (XLA's names) count, output bytes and the ring
    model's link bytes (:func:`_link_bytes`, the reference's);
  * live bytes: the storages the step allocates, each freed when its
    last tensor dies (a weak reference to the storage), so ``peak_bytes``
    is the most the step held at once beyond its arguments.

Operations that DTensor's sharding propagation runs on global-shape
stand-ins are its metadata and are not counted.

:func:`analyze_ops` returns the reference's result keys.
"""
from __future__ import annotations

import sys
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

_FUNCOL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# operations that move no data of their own
_FREE = {"detach", "alias", "empty", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "_local_scalar_dense",
         "wait_tensor", "sym_size", "sym_stride", "sym_numel",
         "is_same_size"}
_COPIES = {"copy_", "copy", "clone", "_to_copy"}


def _link_bytes(kind: str, out_bytes: float, gsize: int) -> float:
    g = max(gsize, 1)
    if kind == "all-reduce":
        return 2 * (g - 1) / g * out_bytes
    if kind == "all-gather":
        return (g - 1) / g * out_bytes
    if kind == "reduce-scatter":
        return (g - 1) * out_bytes          # input = out * g
    if kind == "all-to-all":
        return (g - 1) / g * out_bytes
    return out_bytes                        # collective-permute


def _nbytes(t) -> int:
    return t.numel() * t.element_size() \
        if isinstance(t, torch.Tensor) else 0


# DTensor's sharding propagation runs operations on global-shape meta
# stand-ins (and caches them); they are its metadata, not the step's
_PROPAGATION = ("_sharding_prop.py", "_op_schema.py")


def _in_propagation(depth: int = 24) -> bool:
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f, depth = f.f_back, depth - 1
    return False


def _group_size(name: str, args, kwargs) -> int:
    if "group_size" in kwargs:
        return int(kwargs["group_size"])
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    group_name = args[-1] if isinstance(args[-1], str) \
        else kwargs.get("group_name")
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


class OpStream(TorchDispatchMode):
    """Dispatch mode recording flops, bytes, collectives and live
    storages of the local operations run under it (see the module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.hbm_bytes_no_copies = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak_bytes = 0
        self._tracked: Dict[int, int] = {}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # see the local operations
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) \
                or _in_propagation():
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if ns == "_c10d_functional" and name in _FUNCOL:
            kind = _FUNCOL[name]
            ob = sum(_nbytes(t) for t in outs)
            g = _group_size(name, args, kwargs)
            rec = self.collectives.setdefault(
                kind, {"count": 0.0, "out_bytes": 0.0, "link_bytes": 0.0})
            rec["count"] += 1
            rec["out_bytes"] += ob
            rec["link_bytes"] += _link_bytes(kind, ob, g)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        if not func._schema.is_mutable:
            for t in outs:
                self._track(t)
        if name in _FREE:
            return out
        ins = sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0])
        b = ins + sum(_nbytes(t) for t in outs)
        self.hbm_bytes += b
        if name not in _COPIES:
            self.hbm_bytes_no_copies += b
        return out

    def result(self) -> dict:
        """The reference's ``analyze_hlo`` keys, per device."""
        link = sum(v["link_bytes"] for v in self.collectives.values())
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "hbm_bytes_no_copies": self.hbm_bytes_no_copies,
                "collectives": self.collectives,
                "collective_link_bytes": link}


def analyze_ops(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its :meth:`OpStream.result` plus
    ``peak_bytes``, the most bytes the call held at once beyond its
    arguments)."""
    mode = OpStream()
    with mode:
        out = fn(*args, **kwargs)
    res = mode.result()
    res["peak_bytes"] = mode.peak_bytes
    return out, res
