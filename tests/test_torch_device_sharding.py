"""The port's device count, shapes, ``_compat`` shim and sharding rules
against the JAX package, and the lockstep engine's ``devices > 1``:

* configs: the four shapes, ``SHAPES_BY_NAME``, ``supports_shape`` over
  ``ARCHS x SHAPES`` and ``list_archs``;
* ``_compat.hypothesis_fallback`` draws the reference's values;
* ``REPRO_DEVICES`` and ``resolve_device_count`` reject junk, zero and
  oversubscribed values with the variable named;
* ``simulator_jit._plan_spans`` equals the reference's, and
  ``simulate_jbatch(devices=d)`` on the CPU gives the reference's
  ``devices=1`` rows for d in 1..4, ragged tails and the overflow retry
  ladder included;
* every parameter and cache leaf's local shard shape under the port's
  ``param_specs`` / ``cache_specs`` equals the shape the reference's
  ``AxisRules.sanitize`` gives, for the ten full-width archs on the
  16x16 and 2x16x16 meshes (the reference's rules run on a stand-in mesh
  with its ``axis_names`` and ``shape``, so no 256 JAX devices are
  needed), and ``shard_activation``'s spec for every kind in both modes;
* the sharded model on real collectives: four CPU processes on the
  ``gloo`` backend, a (2, 2) mesh, prefill and four decode steps under
  ``axis_rules`` against the unsharded port within 1e-5.  gloo has every
  collective these steps need (all-gather, all-reduce, reduce-scatter
  and all-to-all, which the gloo group runs as an all-gather); the fake
  group's tests (tests/test_torch_dryrun.py) cover the rest of the
  kinds.

JAX 0.9 has no ``jax.experimental.enable_x64``, which the reference
engine imports; the ``x64`` fixture points it at ``jax.enable_x64`` for
these tests only.
"""
import json
import os
import socket
import subprocess
import sys
import types

import jax
import jax.experimental
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from repro import configs as j_configs
from repro._compat import hypothesis_fallback as j_hf
from repro.core import Policy as JPolicy
from repro.core import generate_taskset as j_generate_taskset
from repro.core import simulator_jit as j_sj
from repro.experiments.runner import cached_library
from repro.models import lm as j_lm
from repro.models.common import RuntimeConfig as JRuntimeConfig
from repro.runtime import sharding as j_sharding

from repro_torch import configs
from repro_torch._compat import hypothesis_fallback as hf
from repro_torch.core import simulator_jit as sj
from repro_torch.core.scheduler import Policy
from repro_torch.core.taskgen import generate_taskset
from repro_torch.launch import specs
from repro_torch.models.common import RuntimeConfig
from repro_torch.pytree import tree_items
from repro_torch.runtime import device_config as dc
from repro_torch.runtime import sharding

J_LIB = cached_library("sim")
LIB = chip_smoke.sim_library()


@pytest.fixture(autouse=True)
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            jax.enable_x64, raising=False)


# ----------------------------------------------------------------------
# configs and _compat
# ----------------------------------------------------------------------

def test_shapes_and_list_archs_equal_the_reference():
    assert configs.list_archs() == j_configs.list_archs()
    assert configs.__all__ == j_configs.__all__
    assert [vars(s) for s in configs.SHAPES] \
        == [vars(s) for s in j_configs.SHAPES]
    assert list(configs.SHAPES_BY_NAME) == list(j_configs.SHAPES_BY_NAME)
    for s in configs.SHAPES:
        assert s.tokens == j_configs.SHAPES_BY_NAME[s.name].tokens
    for name, arch in configs.ARCHS.items():
        j_arch = j_configs.ARCHS[name]
        assert arch.sub_quadratic == j_arch.sub_quadratic
        assert arch.param_count() == j_arch.param_count()
        assert arch.active_param_count() == j_arch.active_param_count()
        for s, js in zip(configs.SHAPES, j_configs.SHAPES):
            assert configs.supports_shape(arch, s) \
                == j_configs.supports_shape(j_arch, js), (name, s.name)


def _draws(shim):
    got = []

    @shim.settings(max_examples=12)
    @shim.given(seed=shim.integers(0, 10 ** 6), u=shim.floats(0.0, 1.0),
                xs=shim.lists(shim.integers(0, 9), min_size=1, max_size=4),
                b=shim.booleans(), c=shim.sampled_from(("a", "b", "c")))
    def property_case(seed, u, xs, b, c):
        got.append((seed, u, tuple(xs), b, c))

    property_case()
    return got


def test_compat_fallback_draws_equal_the_reference():
    mine, ref = _draws(hf), _draws(j_hf)
    assert len(mine) == 12 and mine == ref


# ----------------------------------------------------------------------
# device count
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bad", ["abc", "1.5", "0", "-2", "2x",
                                 str(dc.MAX_LOGICAL_DEVICES + 1)])
def test_device_count_rejects_junk_zero_and_oversubscribed(monkeypatch,
                                                           bad):
    monkeypatch.setenv("REPRO_DEVICES", bad)
    with pytest.raises(ValueError, match="REPRO_DEVICES"):
        dc.default_device_count()
    with pytest.raises(ValueError, match="REPRO_DEVICES"):
        dc.resolve_device_count()


def test_device_count_valid_default_and_range(monkeypatch):
    monkeypatch.setenv("REPRO_DEVICES", "3")
    assert dc.default_device_count() == dc.resolve_device_count() == 3
    assert dc.resolve_device_count(5) == 5
    monkeypatch.setenv("REPRO_DEVICES", "  ")          # blank = unset
    assert dc.default_device_count() == 1
    monkeypatch.delenv("REPRO_DEVICES")
    assert dc.resolve_device_count() == 1
    assert dc.MAX_LOGICAL_DEVICES == 256
    for bad in (0, -1, dc.MAX_LOGICAL_DEVICES + 1):
        with pytest.raises(ValueError, match="out of range"):
            dc.resolve_device_count(bad)


# ----------------------------------------------------------------------
# the lockstep engine's devices > 1
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 7, 9, 64, 130])
def test_plan_spans_equal_the_reference(n):
    for chunk in (1, 2, 3, 8, 64):
        for devices in (1, 2, 3, 4, 16):
            assert sj._plan_spans(n, chunk, devices) \
                == j_sj._plan_spans(n, chunk, devices), (n, chunk, devices)


MIXED = (3, 10, 6, 13, 5, 8, 4, 9, 7)
DURATION = 4e6
_REF = {}


def _mixed(ref=False):
    lib, gen = (J_LIB, j_generate_taskset) if ref else (LIB, generate_taskset)
    return [gen(0.9, seed=s, n_tasks=n, programs=lib)
            for s, n in enumerate(MIXED)], list(range(len(MIXED)))


def _ref_digest():
    if "d" not in _REF:
        ts, sd = _mixed(ref=True)
        _REF["d"] = sj.metrics_digest(j_sj.simulate_jbatch(
            ts, J_LIB, JPolicy.mesc(), seeds=sd, duration=DURATION,
            devices=1))
    return _REF["d"]


@pytest.mark.parametrize("devices", [1, 2, 3, 4])
def test_sharded_rows_equal_the_reference(devices):
    """batch_size 2 on 9 points: spans of 2 * devices points, the last a
    ragged tail padded with copies of its last point."""
    ts, sd = _mixed()
    sj.reset_counts()
    got = sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd,
                             duration=DURATION, batch_size=2,
                             devices=devices, device="cpu")
    assert len(got) == len(ts)
    assert sj.metrics_digest(got) == _ref_digest()
    spans = sj._plan_spans(len(ts), 2, devices)
    assert sj.COUNTS["spans"] == len(spans)
    assert any(len(i) > r for i, r, _ in spans[1:]) or len(spans) == 1


def test_overflow_retry_ladder_runs_unsharded(monkeypatch):
    """A primary table of 2 entries overflows: the overflowing points are
    re-run on one shard at doubled widths, and every row still equals the
    reference's."""
    monkeypatch.setenv("REPRO_JIT_TABLE_WIDTH", "2")
    calls = []
    run_once = sj._run_once

    def spy(b, *args, devices=1, **kwargs):
        calls.append((args[6], devices))
        return run_once(b, *args, devices=devices, **kwargs)

    monkeypatch.setattr(sj, "_run_once", spy)
    ts, sd = _mixed()
    sj.reset_counts()
    got = sj.simulate_jbatch(ts, LIB, Policy.mesc(), seeds=sd,
                             duration=DURATION, devices=3, device="cpu")
    assert sj.COUNTS["retried_points"] > 0
    assert calls[0] == (2, 3)
    assert all(d == 1 for K, d in calls if K > 2)
    assert sj.metrics_digest(got) == _ref_digest()


# ----------------------------------------------------------------------
# sharding rules against the reference's
# ----------------------------------------------------------------------

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _rules(mesh, **kw):
    names, sizes = MESHES[mesh]
    port = sharding.AxisRules(
        types.SimpleNamespace(mesh_dim_names=names, shape=sizes), **kw)
    ref = j_sharding.AxisRules(
        types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes))),
        **kw)
    return port, ref


def _ref_local(rules, spec, shape):
    out = list(shape)
    for d, ax in enumerate(tuple(spec)):
        out[d] //= rules.axis_size(ax)
    return tuple(out)


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_and_cache_local_shapes_equal_the_reference(monkeypatch,
                                                          arch, mesh):
    # the reference's specs without a JAX mesh: named -> its sanitized spec
    monkeypatch.setattr(j_sharding.AxisRules, "named",
                        lambda self, spec, shape: self.sanitize(spec, shape))
    fsdp_over_pod = mesh == "2x16x16" and arch in (
        "llama4-maverick-400b-a17b", "qwen1.5-110b")
    port, ref = _rules(mesh, sequence_parallel=True,
                       fsdp_over_pod=fsdp_over_pod)
    cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
    shape = configs.SHAPES_BY_NAME["decode_32k"]
    jrc = JRuntimeConfig(compute_dtype=jnp.bfloat16,
                         param_dtype=jnp.bfloat16)
    rc = RuntimeConfig()
    trees = (
        (specs.params_abstract(cfg, rc), sharding.param_specs,
         jax.eval_shape(lambda: j_lm.init_params(
             jcfg, jax.random.PRNGKey(0), jrc)), j_sharding.param_specs),
        (specs.cache_specs_abstract(cfg, shape, rc), sharding.cache_specs,
         jax.eval_shape(lambda: j_lm.init_cache(
             jcfg, shape.global_batch, shape.seq_len, jrc)),
         j_sharding.cache_specs))
    for tree, port_specs, jtree, ref_specs in trees:
        place = dict(tree_items(port_specs(tree, port)))
        jspec = _ref_leaves(ref_specs(jtree, ref))
        jleaves = _ref_leaves(jtree)
        mine = {k: t for k, t in tree_items(tree)
                if isinstance(t, torch.Tensor)}
        assert sorted(mine) == sorted(k for k in jleaves if k != "pos")
        for k, t in mine.items():
            want = _ref_local(ref, jspec[k], jleaves[k].shape)
            got = sharding.local_shape(place[k], MESHES[mesh][1], t.shape)
            assert got == want, (arch, mesh, k, place[k], jspec[k])


KIND_SHAPES = {
    "residual": (256, 4096, 2048), "logits": (256, 4096, 32000),
    "batch": (32, 4096), "attn_in": (32, 4096, 56, 128),
    "attn_out": (32, 4096, 7168), "ffn_in": (512, 64, 2048),
    "ffn_hidden": (32, 4096, 5632), "moe_tokens": (32, 512, 2048),
    "moe_buf": (32, 64, 80, 2048), "moe_gathered": (32, 64, 80, 2048),
}


@pytest.mark.parametrize("mode", ["sp", "2d"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_activation_specs_equal_the_reference(monkeypatch, mode,
                                                    mesh):
    monkeypatch.setattr(j_sharding.AxisRules, "named",
                        lambda self, spec, shape: self.sanitize(spec, shape))
    monkeypatch.setattr(j_sharding.jax.lax, "with_sharding_constraint",
                        lambda x, spec: tuple(spec))
    port, ref = _rules(mesh, sequence_parallel=True, mode=mode)
    for kind, shape in KIND_SHAPES.items():
        for rows in (shape, (1,) + shape[1:]):
            for sp in (True, False):
                rc = types.SimpleNamespace(logical_axes=True,
                                           sequence_parallel=sp)
                x = jax.ShapeDtypeStruct(rows, jnp.float32)
                with j_sharding.axis_rules(ref):
                    want = j_sharding.shard_activation(x, kind, rc)
                spec = sharding.activation_spec(port, kind, rows, rc)
                if spec is None:
                    assert want is x, kind       # an unknown kind: as is
                    continue
                assert port.sanitize(spec, rows) == tuple(want), \
                    (kind, rows, sp)


def test_shard_activation_is_a_noop_outside_rules():
    x = torch.ones(4, 8, 16)
    port, _ = _rules("16x16")
    assert sharding.shard_activation(x, "residual") is x
    with sharding.axis_rules(port):
        # a plain tensor is left as it is; so is everything with
        # logical_axes off, and an unknown kind
        assert sharding.shard_activation(x, "residual") is x
        off = types.SimpleNamespace(logical_axes=False)
        assert sharding.shard_activation(x, "residual", off) is x
        assert sharding.shard_activation(x, "moe_gathered") is x
    assert sharding.current_rules() is None


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    port, _ = _rules("2x16x16", fsdp_over_pod=True)
    assert port.named(("data", "model"), (4096, 5632)) \
        == (Shard(0), Shard(0), Shard(1))
    assert port.named((None, ("data", "model")), (32000, 2048)) \
        == (Replicate(), Shard(1), Shard(1))
    # 40 heads do not divide 16: replicated
    assert port.named((None, None, "model", None), (1, 8, 40, 128)) \
        == (Replicate(), Replicate(), Replicate())


# ----------------------------------------------------------------------
# real collectives: four gloo ranks on a (2, 2) mesh
# ----------------------------------------------------------------------

GLOO_ARCHS = ("tinyllama-1.1b-smoke", "deepseek-v2-lite-16b-smoke",
              "recurrentgemma-2b-smoke")


# one rank's program: the unsharded steps, then the same steps on DTensors
# under axis_rules; prints the max logit error of the prefill and of each
# decode step as JSON
_GLOO_RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.models.common import RuntimeConfig
from repro_torch.runtime import sharding

arch, port, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
cfg = configs.get_config(arch)
rc = RuntimeConfig(compute_dtype=torch.float32, param_dtype=torch.float32,
                   sequence_parallel=True)
params = lm.init_params(cfg, torch.Generator().manual_seed(0), rc, "cpu")
toks = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (4, 16)))
want, cache = lm.prefill(cfg, params, {"tokens": toks}, rc, max_len=32)
wants, nxt = [want], toks[:, -1]
for _ in range(4):
    logits, cache = lm.decode_step(cfg, params, nxt, cache, rc)
    wants.append(logits)
    nxt = logits.argmax(-1)
mesh = make_debug_mesh(2, 2)
rules = sharding.AxisRules(mesh, sequence_parallel=True)
dparams = sharding.distribute(params, sharding.param_specs(params, rules),
                              mesh)


def batch(t):
    return sharding.distribute(
        {"t": t}, sharding.batch_specs({"t": t}, rules), mesh)["t"]


errs = []
with sharding.axis_rules(rules), implicit_replication():
    got, cache = lm.prefill(cfg, dparams, {"tokens": batch(toks)}, rc,
                            max_len=32)
    errs.append(float((got.full_tensor() - wants[0]).abs().max()))
    nxt = toks[:, -1]
    for i in range(4):
        got, cache = lm.decode_step(cfg, dparams, batch(nxt), cache, rc)
        errs.append(float((got.full_tensor() - wants[i + 1]).abs().max()))
        nxt = wants[i + 1].argmax(-1)
dist.destroy_process_group()
print(json.dumps(errs))
"""


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_steps_on_four_gloo_ranks_match_the_unsharded_port(arch):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(root, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_RANK, arch, str(port), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-2000:])
        errs = json.loads(out.strip().splitlines()[-1])
        assert len(errs) == 5 and max(errs) <= 1e-5, (r, errs)
