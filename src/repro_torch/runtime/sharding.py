"""Sharding rules on DTensor: DP (+pod) x FSDP('data') x TP/EP('model')
(twin of the reference's ``runtime/sharding.py``).

A thread-local :class:`AxisRules` context maps logical roles to the axes
of a ``torch.distributed.DeviceMesh``.  Outside any context, or with
``rc.logical_axes`` False, every constraint is a no-op: the model is the
unsharded model.

Conventions (the reference's):
  * batch dims           -> ('pod','data') / ('data',)
  * up-proj weights      -> (in='data' [FSDP], out='model' [TP])
  * down-proj weights    -> (in='model', out='data')
  * MoE expert weights   -> (E='model' [EP], in='data', out=None)
  * vocab dim            -> 'model'
  * residual stream S    -> 'model' when sequence_parallel
  * KV-cache S dim       -> 'model'

A spec is a tuple with one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of names (one tensor dim split over several mesh dims,
major to minor).  Every spec is *sanitized* against the actual shape:
axes that do not divide the dimension are dropped (replicated).  A
sanitized spec maps to DTensor placements (:meth:`AxisRules.named`): a
tensor dim ``d`` with axis ``a`` puts ``Shard(d)`` on ``a``'s mesh dim,
and every other mesh dim is ``Replicate()``.

Inside ``axis_rules``, :func:`shard_activation` redistributes a DTensor
to its kind's placements; a plain tensor is left as it is.  The kernels
run on local shards (:func:`attention_local`): the DTensor layouts of
``_attn_spec`` keep their loops collective-free, as the reference's do.
"""
from __future__ import annotations

import threading
import types
from contextlib import contextmanager
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_TLS = threading.local()


def logical_device_mesh(n: int, axis_name: str = "dev",
                        device_type: str = "cuda"):
    """1-D ``DeviceMesh`` over ranks 0..n-1 of the default process group.

    The reference's sim dispatcher shards its point axis over this mesh;
    the port's lockstep engine needs none (its shards are CUDA streams on
    one card, ``core.simulator_jit``), so this is for callers that run one
    rank per device.  Raises unless a process group of at least ``n``
    ranks is initialised.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    have = dist.get_world_size() if dist.is_initialized() else 0
    if not 1 <= n <= have:
        raise ValueError(
            f"logical_device_mesh: need 1 <= n <= {have} ranks of the "
            f"default process group, got n={n} (initialise it first with "
            "torch.distributed.init_process_group)")
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def current_rules() -> Optional["AxisRules"]:
    return getattr(_TLS, "rules", None)


Spec = Tuple


class AxisRules:
    """mode='sp': Megatron-SP+TP (weights stay model-sharded; sequence is
    gathered at block entry and reduce-scattered at exit).  mode='2d':
    batch sharded over data x model (ZeRO-3-style full weight gathers) —
    right for small models where replicating a layer's weights is cheap.

    ``mesh`` is a ``DeviceMesh`` with named dims (any object with
    ``mesh_dim_names`` and ``shape`` serves for the specs alone)."""

    def __init__(self, mesh, *, sequence_parallel: bool = False,
                 mode: str = "sp", fsdp_over_pod: bool = False):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(names, tuple(mesh.shape)))
        self.dp: Tuple[str, ...] = tuple(n for n in names
                                         if n in ("pod", "data"))
        self.tp: Optional[str] = "model" if "model" in names else None
        self.sp = sequence_parallel
        self.mode = mode
        # ZeRO across pods: shard params over ('pod','data') so 400B-class
        # state halves per added pod
        self.fsdp: Tuple[str, ...] = (
            tuple(n for n in names if n in ("pod", "data"))
            if fsdp_over_pod else ("data",) if "data" in names else ())

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return int(np.prod([self.sizes[a] for a in axes]))

    def _resolve(self, ax):
        if ax == "data":                    # alias: the FSDP shard axes
            if len(self.fsdp) == 0:
                return None
            return self.fsdp if len(self.fsdp) > 1 else self.fsdp[0]
        return ax

    def sanitize(self, spec: Spec, shape: Tuple[int, ...]) -> Spec:
        """``spec`` on ``shape``: 'data' resolved to the FSDP axes, axes
        that do not divide their dim dropped, padded with ``None``."""
        out = []
        for d, ax in enumerate(spec[:len(shape)]):
            ax = self._resolve(ax)
            if ax is None or shape[d] % self.axis_size(ax) != 0:
                out.append(None)
            else:
                out.append(ax)
        out += [None] * (len(shape) - len(out))
        return tuple(out)

    def named(self, spec: Spec, shape: Tuple[int, ...]):
        """The DTensor placements of ``spec`` sanitized on ``shape``, one
        per mesh dim (the reference's ``NamedSharding``).  A mesh dim of
        size 1 is ``Replicate()``: its one shard is the whole tensor."""
        names = list(self.sizes)
        place = [Replicate()] * len(names)
        for d, ax in enumerate(self.sanitize(spec, shape)):
            for a in ((ax,) if isinstance(ax, str) else ax or ()):
                if self.sizes[a] > 1:
                    place[names.index(a)] = Shard(d)
        return tuple(place)


@contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = rules
    try:
        yield rules
    finally:
        _TLS.rules = prev


def local_shape(placements, mesh_shape, shape) -> Tuple[int, ...]:
    """A shard's shape of a tensor of ``shape`` under ``placements``
    (every sharded dim divides evenly, as sanitized specs ensure)."""
    out = list(shape)
    for p, n in zip(placements, mesh_shape):
        if isinstance(p, Shard):
            out[p.dim] //= n
    return tuple(out)


# ---------------------------------------------------------------------------
# Activation constraints (called from model code)
# ---------------------------------------------------------------------------

def activation_spec(r: AxisRules, kind: str, shape, rc=None
                    ) -> Optional[Spec]:
    """The spec ``shard_activation`` gives an activation of ``shape`` of
    this kind (unsanitized); ``None`` for a kind it leaves alone."""
    dp = r.dp if len(r.dp) != 1 else r.dp[0]
    full = r.dp + ((r.tp,) if r.tp else ())
    ndim = len(shape)
    is2d = r.mode == "2d" and shape[0] % r.axis_size(full) == 0
    if kind == "residual":
        if is2d:
            return (full, None, None)
        seq = r.tp if (r.sp and (rc is None or rc.sequence_parallel)) \
            else None
        return (dp, seq, None)
    if kind == "logits":
        return (dp,) + (None,) * (ndim - 2) + (r.tp,)
    if kind == "batch":
        return (dp,) + (None,) * (ndim - 1)
    if kind == "attn_in":
        # q/k/v (B, S, H, dh): keep the flash loops collective-free.
        # 2d: batch-local attention; sp: head-sharded TP when heads divide,
        # else replicated across 'model'
        return _attn_spec(r, shape[0], shape[2])
    if kind == "attn_out":
        # o (B, S, H*dh) before the output projection
        return (full, None, None) if is2d else (dp, None, r.tp)
    if kind == "ffn_in":
        # block input x (B, S, D): sequence gathered (Megatron-SP boundary)
        return (full, None, None) if is2d else (dp, None, None)
    if kind == "ffn_hidden":
        # up-projection output (B, S, F): F model-sharded in sp mode so the
        # FFN weights are never replicated across 'model'
        return (full, None, None) if is2d else (dp, None, r.tp)
    if kind == "moe_tokens":
        # (R, N, D) routing rows: train routes per sequence (R = batch),
        # decode routes over batch (R = 1, N = batch)
        return (dp, None, None) if shape[0] > 1 else (None, dp, None)
    if kind == "moe_buf":
        # expert buffers (R, E, C, *): expert dim over 'model' (EP)
        return (dp if shape[0] > 1 else None, r.tp) + (None,) * (ndim - 2)
    return None


def shard_activation(x, kind: str, rc=None):
    """``x`` redistributed to its kind's placements inside
    ``axis_rules``; unchanged outside, with ``rc.logical_axes`` False, for
    an unknown kind (the reference's ``"moe_gathered"`` is one) or for a
    plain tensor."""
    r = current_rules()
    if r is None or (rc is not None and not rc.logical_axes):
        return x
    spec = activation_spec(r, kind, tuple(x.shape), rc)
    if spec is None or not isinstance(x, DTensor):
        return x
    place = r.named(spec, tuple(x.shape))
    if tuple(x.placements) == place:
        return x
    return x.redistribute(x.device_mesh, place)


def _attn_spec(r: AxisRules, B: int, H: int) -> Spec:
    dp = r.dp if len(r.dp) != 1 else r.dp[0]
    full = r.dp + ((r.tp,) if r.tp else ())
    if r.mode == "2d" and B % r.axis_size(full) == 0:
        return (full, None, None, None)
    if r.tp and H % r.axis_size(r.tp) == 0:
        return (dp, None, r.tp, None)
    return (dp, None, None, None)


def attention_local(kernel: Callable, q, k, v, *args, **kwargs):
    """``kernel(q, k, v, *args, **kwargs)`` on the local shards of the
    DTensors q, k, v in the kernels' layout (batch dim 0, heads dim 1):
    flash's (B, H, S, d) and decode's q (B, Hq, dh) against a (B, Hkv, S,
    dh) cache, or the blocked attention that training differentiates.
    The batch is placed as ``_attn_spec`` places it and the
    query heads over 'model' where they divide; the key and value heads
    follow when they divide too, and otherwise stay whole, each shard
    taking the one KV head its query heads share (a shard's heads must
    then lie in one GQA group).  Everything else is gathered, so the
    kernel needs no collective and the output keeps q's placements."""
    r = current_rules()
    mesh = q.device_mesh
    if r is None:
        r = AxisRules(mesh)
    B, Hq, Hkv = q.shape[0], q.shape[1], k.shape[1]
    spec = _attn_spec(r, B, Hq)
    q_spec = (spec[0], spec[2]) + (None,) * (q.ndim - 2)
    kv_heads = spec[2] if spec[2] and Hkv % r.axis_size(spec[2]) == 0 \
        else None
    kv_spec = (spec[0], kv_heads) + (None,) * (k.ndim - 2)
    q = q.redistribute(mesh, r.named(q_spec, tuple(q.shape)))
    k = k.redistribute(mesh, r.named(kv_spec, tuple(k.shape)))
    v = v.redistribute(mesh, r.named(kv_spec, tuple(v.shape)))
    # under autograd: a KV tensor whole across query shards gets from each
    # a partial gradient (its query heads' share)
    kv_grad = [Partial() if isinstance(a, Shard) and not isinstance(b, Shard)
               else b for a, b in zip(q.placements, k.placements)]
    ql = q.to_local()
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    if spec[2] and kv_heads is None and Hkv > 1:
        # KV heads whole, query heads sharded: shard j holds query heads
        # [j*hq, (j+1)*hq), all in KV group (j*hq) // G
        G, hq = Hq // Hkv, ql.shape[1]
        if G % hq:
            raise ValueError(
                f"{hq} query heads a shard straddle GQA groups of {G}: "
                "pad the heads (RuntimeConfig.pad_attn_heads)")
        j = mesh.get_local_rank(mesh.mesh_dim_names.index(spec[2]))
        g = (j * hq) // G
        kl, vl = kl[:, g:g + 1], vl[:, g:g + 1]
    out = kernel(ql, kl, vl, *args, **kwargs)
    shape = (B, Hq) + tuple(out.shape[2:])
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_global_stride(out, shape))


def whole_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` gathered where it is sharded: an
    embedding table whose vocab is sharded (a tied table) before a
    lookup, which DTensor would otherwise leave as a masked partial sum;
    any other tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    place = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in x.placements]
    if place == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, place)


def _view_groups(src, dst):
    """Pair the dims of a reshape from ``src`` to ``dst`` (no -1): a list
    of (input dims, output dims) whose sizes multiply out equal."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [], []
        a = b = 1
        while True:
            if a <= b and i < len(src):
                a *= src[i]
                gi.append(i)
                i += 1
            elif j < len(dst):
                b *= dst[j]
                gj.append(j)
                j += 1
            else:
                break
            if a == b and gi and gj and not (
                    i < len(src) and src[i] == 1 and j >= len(dst)):
                break
        groups.append((gi, gj))
    return groups


def _reshape_placements(x, shape):
    """(``shape`` with -1 resolved, the placements ``x`` takes before it
    is viewed as ``shape``): a sharded dim keeps its placement where it is
    split into factors whose first the shards divide, or merged as the
    first of its group; any other sharded dim of the reshape is gathered."""
    shape = list(shape)
    if -1 in shape:
        known = 1
        for s in shape:
            known *= s if s != -1 else 1
        shape[shape.index(-1)] = x.numel() // known
    mesh, place = x.device_mesh, list(x.placements)
    split = {}
    for m, p in enumerate(place):
        if isinstance(p, Shard):
            split.setdefault(p.dim, []).append(m)
    for gi, gj in _view_groups(tuple(x.shape), shape):
        for k, d in enumerate(gi):
            if d not in split:
                continue
            n = 1
            for m in split[d]:
                n *= mesh.size(m)
            keep = k == 0 and gj and shape[gj[0]] % n == 0
            if not keep:
                for m in split[d]:
                    place[m] = Replicate()
    return shape, place


def _dtensor_reshape(x, shape):
    shape, place = _reshape_placements(x, shape)
    if place != list(x.placements):
        x = x.redistribute(x.device_mesh, place)
    return x.reshape(shape)


def _contiguous_shards(x):
    """``x`` with contiguous local shards and the contiguous global stride:
    DTensor views a shard as the global stride says, and a gradient may
    come with a transposed stride over contiguous shards or the reverse."""
    local = x.to_local()
    if local.is_contiguous() and x.is_contiguous():
        return x
    local = local.contiguous()
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=_global_stride(local, tuple(x.shape)))


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _contiguous_shards(g)


def contiguous_grad(x):
    """``x``, whose gradient (a DTensor's) is made contiguous on the way
    back (``_contiguous_shards``): the expert products' einsums view
    their gradients, which DTensor's backward may leave with a global
    stride that its shards do not have."""
    if isinstance(x, DTensor) and torch.is_grad_enabled() \
            and x.requires_grad:
        return _ContiguousGrad.apply(x)
    return x


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward is placed as its forward: the
    gradient is reshaped back by the same rule (DTensor's own backward
    unflattens a dim whatever its shards, 10 heads of a 16-way sharded
    2560 among them) and returned in the input's placements, a partial
    sum's replicated (the gradient of a sum is each term's)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return _dtensor_reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        g = _dtensor_reshape(_contiguous_shards(g), ctx.shape)
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return _contiguous_shards(g), None


def reshape(x, shape):
    """``x.reshape(shape)``.  A DTensor keeps a sharded dim's placement
    where DTensor can: split into factors whose first the shards divide,
    or merged as the first of its group.  Any other sharded dim of the
    reshape is gathered first, as GSPMD would (40 heads of a projection
    sharded 16 ways, a microbatch split of a data-sharded batch).  Under
    autograd the gradient takes the same way back (``_Reshape``)."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


def local_call(kernel: Callable, tensors, specs, out_of: int, **kwargs):
    """``kernel(*locals, **kwargs)`` on the local shards of DTensors
    ``tensors``, each redistributed to its spec ('batch' is the rules'
    data axes); the output takes the placements of ``tensors[out_of]``
    and its shape, in the output's own layout.  Differentiable: each
    input's gradient comes back in its redistributed placements."""
    r = current_rules()
    mesh = tensors[0].device_mesh
    if r is None:
        r = AxisRules(mesh)
    dp = r.dp if len(r.dp) != 1 else (r.dp[0] if r.dp else None)
    moved = []
    for t, spec in zip(tensors, specs):
        if not isinstance(t, DTensor):     # e.g. a zero initial state
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        spec = tuple(dp if a == "batch" else (a if a != "model" else r.tp)
                     for a in spec)
        moved.append(t.redistribute(mesh, r.named(spec, tuple(t.shape))))
    out = kernel(*(t.to_local() for t in moved), **kwargs)
    ref_t = moved[out_of]
    return DTensor.from_local(out, mesh, ref_t.placements, run_check=False,
                              shape=ref_t.shape,
                              stride=_global_stride(out, ref_t.shape))


def _global_stride(local, shape):
    """The stride of a tensor of ``shape`` laid out in the same dim
    order as ``local`` (contiguous, or the flash kernel's (B, H, S, d)
    view of a (B, S, H, d) buffer)."""
    order = sorted(range(local.ndim), key=lambda d: -local.stride(d))
    stride, acc = [0] * local.ndim, 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

_UP = {"wq", "wk", "wv", "w1", "w3", "w_q", "w_dkv", "w_uk", "w_uv", "w_in",
       "w_up", "w_y", "w_xb", "w_if", "w_k"}
_DOWN = {"wo", "w2", "w_o", "w_down", "w_out"}
_REPL3 = {"w_a", "w_x", "r"}          # small block-diagonal weights

# (core_rank, core_spec); leading stack dims are padded with None
_PARAM_RULES = {
    **{n: (2, ("data", "model")) for n in _UP},
    **{n: (2, ("model", "data")) for n in _DOWN},
    **{n: (3, (None, None, None)) for n in _REPL3},
    # embed: vocab replicated, D sharded over the whole mesh -> token
    # gathers are fully local
    "embed": (2, (None, ("data", "model"))),
    "lm_head": (2, ("data", "model")),
    "router": (2, ("data", None)),
    "conv_w": (2, (None, "model")),
    "lam": (1, ("model",)),
}
_MOE_RULES = {
    "w1": (3, ("model", "data", None)),
    "w3": (3, ("model", "data", None)),
    "w2": (3, ("model", None, "data")),
}


def _walk(tree, fn, path=()):
    """``tree`` (nested dicts, the port's pytree) with each leaf ``a`` at
    key path ``path`` replaced by ``fn(path, a)``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _param_spec(keys, arr, rules: AxisRules, tied: bool = False):
    name = keys[-1]
    in_moe = len(keys) >= 2 and keys[-2] == "moe"
    if name == "embed" and tied:
        # tied embeddings serve as lm_head too: keep vocab on 'model' so
        # the logits matmul stays vocab-parallel
        rule = (2, ("model", "data"))
    else:
        rule = (_MOE_RULES.get(name) if in_moe else None) \
            or _PARAM_RULES.get(name)
    if rule is None:
        return rules.named((None,) * arr.ndim, tuple(arr.shape))
    core_rank, core = rule
    lead = arr.ndim - core_rank
    if lead < 0:
        return rules.named((None,) * arr.ndim, tuple(arr.shape))
    return rules.named((None,) * lead + tuple(core), tuple(arr.shape))


def param_specs(params, rules: AxisRules):
    """Tree of placements for a parameter tree."""
    tied = isinstance(params, dict) and "lm_head" not in params
    return _walk(params, lambda p, a: _param_spec(p, a, rules, tied=tied))


# ---------------------------------------------------------------------------
# Cache / optimizer / batch specs
# ---------------------------------------------------------------------------

_CACHE_RULES = {
    # core spec counted from the END of the shape
    "ck": ("batch", "model", None, None), "cv": ("batch", "model", None, None),
    "cka": ("batch", "model", None, None), "cva": ("batch", "model", None, None),
    "ckb": ("batch", "model", None, None), "cvb": ("batch", "model", None, None),
    "cc": ("batch", "model", None), "ckr": ("batch", "model", None),
    "wk": ("batch", "model", None, None), "wv": ("batch", "model", None, None),
    "rh": ("batch", "model"), "rconv": ("batch", None, "model"),
    "mC": ("batch", None, None, None), "mn": ("batch", None, None),
    "mm": ("batch", None), "mconv": ("batch", None, "model"),
    "sc": ("batch", "model"), "sn": ("batch", "model"),
    "sh": ("batch", "model"), "sm": ("batch", "model"),
    "pos": (),
}


def _cache_spec(keys, arr, rules: AxisRules):
    name = keys[-1]
    ndim = getattr(arr, "ndim", 0)
    shape = tuple(getattr(arr, "shape", ()))
    rule = _CACHE_RULES.get(name) or _CACHE_RULES.get(name.rstrip("0123456789"))
    if rule is None:
        return rules.named((None,) * ndim, shape)
    dp = rules.dp if len(rules.dp) != 1 else rules.dp[0]
    core = tuple(dp if ax == "batch" else ax for ax in rule)
    lead = ndim - len(core)
    if lead < 0:
        return rules.named((None,) * ndim, shape)
    return rules.named((None,) * lead + core, shape)


def cache_specs(cache, rules: AxisRules):
    """Tree of placements for a decode cache (``pos``, a host int, is
    replicated)."""
    return _walk(cache, lambda p, a: _cache_spec(p, a, rules))


def batch_specs(batch, rules: AxisRules):
    dp = rules.dp if len(rules.dp) != 1 else rules.dp[0]
    return _walk(batch, lambda p, a: rules.named(
        (dp,) + (None,) * (a.ndim - 1), tuple(a.shape)))


def replicated(tree, rules: AxisRules):
    return _walk(tree, lambda p, a: rules.named(
        (None,) * getattr(a, "ndim", 0), tuple(getattr(a, "shape", ()))))


def distribute(tree, specs, mesh):
    """``tree``'s tensors as DTensors with the placements of ``specs``.
    A meta tensor becomes a meta shard of its local shape (the dry run's
    parameters, no data); any other is sliced locally, every rank holding
    the same full tensor.  Non-tensor leaves (``pos``) stay."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        place = _get(specs, path)
        if t.device.type == "meta":
            local = torch.empty(local_shape(place, mesh.shape, t.shape),
                                dtype=t.dtype, device="meta")
            return DTensor.from_local(local, mesh, place, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return distribute_tensor(t, mesh, place, src_data_rank=None)
    return _walk(tree, one)


def cache_leaf(like):
    """When ``like`` (a prefill's activations) is a DTensor inside
    ``axis_rules``, the ``make`` of ``lm.init_cache`` that builds each
    leaf as a DTensor with ``cache_specs``' placements from this rank's
    shard alone (no rank holds the whole cache); else ``None``."""
    r = current_rules()
    if r is None or not isinstance(like, DTensor):
        return None
    mesh = like.device_mesh

    def make(path, shape, dtype, fill):
        place = _cache_spec(path, types.SimpleNamespace(
            ndim=len(shape), shape=tuple(shape)), r)
        local = torch.full(local_shape(place, mesh.shape, shape), fill,
                           dtype=dtype, device=like.device)
        return DTensor.from_local(
            local, mesh, place, run_check=False, shape=torch.Size(shape),
            stride=_global_stride(local, shape))
    return make


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
