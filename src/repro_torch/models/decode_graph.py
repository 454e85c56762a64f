"""Decode steps replayed as CUDA graphs, and the pool of cache entries
they run on (the model layer's: ``lm.prefill`` and ``lm.decode_step``
call in here; nothing else does).

An eager decode step is its host enqueue: thousands of launches of small
batch-1 kernels, each paid for on the host while the card waits.  On the
card a step is instead one replay of a CUDA graph that was captured from
the same body (``lm._decode_step``), with the position in a device word
that the body reads where it needs it (RoPE, the cache write, the masks,
the decode kernel's chunks).

Graphs bake in addresses, so the caches they run on live in a **pool**:
per parameter tree, device and cache layout (every leaf's path, shape
and dtype), a list of **entries**, each one cache's leaves and the
graphs captured on them.  The pools and graphs of a parameter tree live
as long as its tensors (held by weak reference).  ``lm.prefill`` on the
card takes the leaves of a free entry through ``init_cache``'s ``make``
hook (:func:`take`).  An entry is free when nothing outside the pool
holds one of its leaves: no cache dict (a finished request drops its
dict, a saved one replaces it by the host copy), counted by the leaf's
Python references, and no other tensor on its memory (a view, a
``detach``), counted by its storage's uses.  So two live caches never
share an entry.  A cache that is no entry (a context restored from the
host) is copied into a free entry once, or becomes an entry itself where
none is free (:func:`adopt`), and the step returns a dict of the entry's
leaves.

Memory: a layout's pool keeps as many entries as it has ever had caches
live at once, free ones included, since their graphs replay only on
their own addresses; the memory of a free entry is not the caching
allocator's to lend (to a prefill's activations, say).  When a pool has
to grow (a new entry, or a cache adopted as one), the free entries of
the parameter tree's other layouts are given back first, with their
graphs: a model served at one cache length holds no other length's
caches.

A **family** is what one graph's body depends on besides the parameters,
the entry and the bucket: the config, the runtime config, the token
shape and the cache layout.  It owns the static token and position
buffers that its graphs read and one memory pool for their
intermediates (one replay at a time, on one stream).  A bucket is the
decode kernel's plan over a range of positions (:func:`bucket_top`); a
family whose body launches no decode kernel has the one bucket
``None``.  The graph of (entry, bucket) replays.  Where it is missing (a
bucket or an entry met first), the step runs eagerly on the bucket's
plan, which plans the decode kernel and loads every kernel and library
routine the body launches outside any capture, and then every missing
(entry, bucket) graph of the family is captured: after a warm-up that
meets each bucket and entry a serving window captures nothing.  A step
that cannot replay runs the body with the plan for its own position.

Counters of the tracer (``runtime/trace.py``): ``model.decode_graph_
replays``, ``model.decode_graph_captures``, ``model.decode_cache_
adoptions`` and ``model.decode_eager`` (steps not replayed).  Inside a
capture the tracer is off, so spans and counters inside the body
(``model.moe_dispatch``, ``kernel.decode_plan_miss``) fire only on eager
steps; a replay adds the kernel wrappers' launches that its capture
counted to ``_build.LAUNCHES`` and the route counters.

What can be observed picks the path: parameters and cache leaves that
are plain CUDA tensors (no DTensor), no stream capture already open and
no expert routes being recorded (``ffn.record_routes``, which reads each
step's routes on the host) give the graph; anything else, the CPU and
the meta device among them, runs the body eagerly.
"""
from __future__ import annotations

import sys
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.pytree import tree_leaves
from repro_torch.runtime import trace

#: the first bucket edge: positions 0-511 share the plan for 511
FIRST_EDGE = 512

Layout = Tuple[Tuple[Tuple[str, ...], Tuple[int, ...], torch.dtype], ...]


def bucket_top(pos: int, reach: Optional[int]) -> Optional[int]:
    """The last position of the bucket of ``pos`` among ``reach`` cache
    slots (None: no decode kernel, one bucket).  The edges are the powers
    of two of pos + 1 from FIRST_EDGE up, capped at the reach; a position
    past the reach (a ring that has wrapped) counts as its last slot."""
    if reach is None:
        return None
    live = min(pos, reach - 1) + 1
    return min(max(FIRST_EDGE, 1 << (live - 1).bit_length()), reach) - 1


def _flat(cache, prefix=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) of a cache dict's tensors, in its key order."""
    out = []
    for k, v in cache.items():
        if isinstance(v, dict):
            out += _flat(v, prefix + (k,))
        elif isinstance(v, torch.Tensor):
            out.append((prefix + (k,), v))
    return out


def _refs(leaves) -> List[Tuple[int, int]]:
    """(Python references, tensors on its storage) of each leaf."""
    return [(sys.getrefcount(t),
             torch._C._storage_Use_Count(t.untyped_storage()._cdata))
            for t in leaves]


# what _refs counts of a leaf that only the entry's list holds
_HELD = _refs([torch.empty(1)])[0]


class Entry:
    """One cache's leaves, at fixed addresses, and the graphs captured on
    them: (family key, bucket) -> graph."""

    def __init__(self, layout: Layout, leaves: List[torch.Tensor]):
        self.layout, self.leaves = layout, leaves
        self._at = {path: i for i, (path, _, _) in enumerate(layout)}
        self.graphs: Dict[tuple, "_Graph"] = {}

    def busy(self) -> bool:
        """Whether a cache dict or another tensor (a view) outside the
        pool holds a leaf."""
        return any(n > h for refs in _refs(self.leaves)
                   for n, h in zip(refs, _HELD))

    def make(self, path, shape, dtype, fill):
        """``init_cache``'s ``make``: the leaf at ``path``, filled."""
        return self.leaves[self._at[tuple(path)]].fill_(fill)

    def cache(self, pos: int) -> dict:
        """A new cache dict of this entry's leaves at ``pos``."""
        out: dict = {}
        for (path, _, _), t in zip(self.layout, self.leaves):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        out["pos"] = pos
        return out


_COUNTS = (_build.LAUNCHES, _build.GEMM_ROUTES, _build.FLASH_ROUTES)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    logits: torch.Tensor          # written by each replay
    launched: List[Dict[str, int]]  # the wrappers' counts its capture made


class _Family:
    """One (config, runtime config, token shape, cache layout) of a
    model: the static buffers its graphs read, their memory pool and the
    buckets met so far (its graphs are kept by the entries)."""

    def __init__(self, tokens_shape, device):
        self.tok = torch.zeros(tokens_shape, dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.mempool = torch.cuda.graph_pool_handle()
        self.tops: set = set()


class _Model:
    """The pools (layout -> entries) and graph families of one parameter
    tree on one device, for as long as every parameter tensor lives."""

    def __init__(self, key, leaves):
        self.key = key
        self.refs = [weakref.ref(t, self._died) for t in leaves]
        self.pools: Dict[Layout, List[Entry]] = {}
        self.families: Dict[tuple, _Family] = {}

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def _died(self, _ref=None) -> None:
        if _MODELS.get(self.key) is self:
            del _MODELS[self.key]
        for pool in self.pools.values():
            for e in pool:
                for t in e.leaves:
                    if _OWNER.get(id(t)) is e:
                        del _OWNER[id(t)]
        self.pools.clear()
        self.families.clear()


# (device, ids of the parameter tensors) -> model; id(leaf) -> its entry
_MODELS: Dict[tuple, _Model] = {}
_OWNER: Dict[int, Entry] = {}


def model_of(params, device) -> _Model:
    """The pools and graphs of ``params`` on ``device``."""
    leaves = tree_leaves(params)
    key = (torch.device(device), tuple(id(t) for t in leaves))
    m = _MODELS.get(key)
    if m is None or not m.alive():
        if m is not None:
            m._died()
        m = _MODELS[key] = _Model(key, leaves)
    return m


def _layout(cache) -> Layout:
    return tuple((path, tuple(t.shape), t.dtype) for path, t in _flat(cache))


def _free(pool: List[Entry]) -> Optional[Entry]:
    return next((e for e in pool if not e.busy()), None)


def _enlist(model: _Model, layout: Layout, e: Entry) -> Entry:
    """``e`` added to ``model``'s pool of ``layout``, after the free
    entries of its other layouts have been given back with their
    graphs."""
    for other, pool in model.pools.items():
        if other != layout:
            for old in [x for x in pool if not x.busy()]:
                pool.remove(old)
                for t in old.leaves:
                    _OWNER.pop(id(t), None)
    model.pools[layout].append(e)
    for t in e.leaves:
        _OWNER[id(t)] = e
    return e


def take(model: _Model, layout: Layout, device) -> Entry:
    """A free entry of ``layout`` on ``device`` in ``model``'s pool (a
    new one when every entry is held)."""
    pool = model.pools.setdefault(layout, [])
    return _free(pool) or _enlist(model, layout, Entry(layout, [
        torch.empty(shape, dtype=dtype, device=device)
        for _, shape, dtype in layout]))


def adopt(model: _Model, cache) -> Tuple[Entry, bool]:
    """(the entry of ``model``'s pool that holds ``cache``, whether it
    was copied in).  A cache that is no entry of that pool is copied into
    a free one; where none is free, its own tensors become an entry (no
    copy, and no more memory than the cache holds already) unless one
    shares its memory with another tensor, which is copied into a new
    entry."""
    leaves = [t for _, t in _flat(cache)]
    layout = _layout(cache)
    pool = model.pools.setdefault(layout, [])
    e = _OWNER.get(id(leaves[0]))
    if e is not None and len(e.leaves) == len(leaves) \
            and all(a is b for a, b in zip(e.leaves, leaves)) \
            and any(x is e for x in pool):
        return e, False
    e = _free(pool)
    if e is None and not any(id(t) in _OWNER for t in leaves) \
            and all(u == _HELD[1] for _, u in _refs(leaves)):
        # tensors of their own (no view among them, which would keep the
        # entry busy for good): the cache becomes an entry
        return _enlist(model, layout, Entry(layout, leaves)), False
    e = e or take(model, layout, leaves[0].device)
    for dst, src in zip(e.leaves, leaves):
        dst.copy_(src)
    if trace.ON:
        trace.count("model.decode_cache_adoptions")
    return e, True


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

def graphable(params, cache) -> bool:
    """Whether this step can replay: plain CUDA tensors, no capture open,
    no routes recorded."""
    from repro_torch.models import ffn
    emb = params["embed"]
    if isinstance(emb, DTensor) or emb.device.type != "cuda" \
            or ffn._ROUTES is not None \
            or torch.cuda.is_current_stream_capturing():
        return False
    return all(type(t) is torch.Tensor and t.device == emb.device
               for _, t in _flat(cache))


def _capture(fam: _Family, entry: Entry, top, body: Callable) -> _Graph:
    """``body(tokens, cache, pos, top)`` on the family's static buffers
    and ``entry``, captured; the kernel launches it counted are kept for
    its replays and taken back from the counters (a capture runs
    nothing)."""
    before = [dict(c) for c in _COUNTS]
    on = trace.ON
    trace.ON = False
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=fam.mempool):
            logits = body(fam.tok, entry.cache(0), fam.pos, top)
    finally:
        trace.ON = on
        launched = []
        for counts, was in zip(_COUNTS, before):
            launched.append({k: v - was.get(k, 0) for k, v in counts.items()
                             if v != was.get(k, 0)})
            counts.clear()
            counts.update(was)
    if trace.ON:
        trace.count("model.decode_graph_captures")
    return _Graph(graph, logits, launched)


def step(cfg, params, tokens, cache, rc, reach: Optional[int],
         body: Callable):
    """One decode step: (logits, the cache dict at pos + 1).

    ``body(tokens, cache, pos, top)`` is the step's body (the model's
    ``_decode_step`` on ``cfg``, ``params``, ``rc``) and returns the
    logits; ``pos`` is the position as a 0-d int64 tensor on the
    parameters' device (a host int where the parameters are DTensors)
    and ``top`` the position whose plan the decode kernel takes: on the
    graph path the last position of the bucket among ``reach`` slots, in
    a step that cannot replay ``pos`` itself."""
    pos = int(cache["pos"])
    emb = params["embed"]
    if not graphable(params, cache):
        if trace.ON:
            trace.count("model.decode_eager")
        where = pos if isinstance(emb, DTensor) else \
            torch.full((), pos, dtype=torch.long, device=emb.device)
        return body(tokens, cache, where, pos), {**cache, "pos": pos + 1}
    device = emb.device
    tokens = torch.as_tensor(tokens, device=device)
    model = model_of(params, device)
    entry, _ = adopt(model, cache)
    key = (cfg, rc, tuple(tokens.shape), entry.layout)
    fam = model.families.get(key)
    if fam is None:
        fam = model.families[key] = _Family(tokens.shape, device)
    top = bucket_top(pos, reach)
    g = entry.graphs.get((key, top))
    if g is None:
        # a bucket or an entry met first: this step runs eagerly on the
        # bucket's plan, so the decode kernel is planned (an occupancy
        # query a capture refuses) and every kernel and library routine
        # the body launches is loaded; then every missing (entry, bucket)
        # graph of the family is captured
        if trace.ON:
            trace.count("model.decode_eager")
        c = entry.cache(pos)
        logits = body(tokens, c, torch.full((), pos, dtype=torch.long,
                                            device=device), top)
        fam.tops.add(top)
        for e in model.pools[entry.layout]:
            for t in sorted(fam.tops, key=lambda t: -1 if t is None else t):
                if (key, t) not in e.graphs:
                    e.graphs[(key, t)] = _capture(fam, e, t, body)
        return logits, {**c, "pos": pos + 1}
    fam.tok.copy_(tokens)
    fam.pos.fill_(pos)
    g.graph.replay()
    for counts, add in zip(_COUNTS, g.launched):
        for k, v in add.items():
            counts[k] += v
    if trace.ON:
        trace.count("model.decode_graph_replays")
    return g.logits.clone(), entry.cache(pos + 1)
