"""The port's dry run, op-stream analysis, meshes, input specs and perf
harness (``repro_torch.launch.{dryrun,perf,mesh,specs}``,
``runtime.hlo_analysis``, ``kernels.meta``) on the CPU:

* input specs, the policy tables and the perf variants equal the JAX
  package's;
* one ``-smoke`` cell of each step kind runs on a fake (2, 2) mesh, its
  argument bytes equal to the sum of the local shards' bytes, and so do
  the full-width train cells that raised in DTensor's backward, cut in
  depth, on the smallest fake mesh that showed each error;
* the analysis counts a known product's flops and bytes exactly, and a
  known redistribution on a fake 4-rank mesh as the expected collective
  with the ring model's link bytes;
* the kernels' meta path gives the kernels' output layout and flops and
  launches nothing;
* a failing cell is recorded and the sweep goes on, a bug propagates, and
  the fake process group never outlives its cell;
* ``while_body_kernels`` counts the kernel nodes of a CUDA graph's DOT
  dump taken on the card (``tests/data/cuda_graph_small.dot``), and
  ``lockstep_kernel_count`` refuses the CPU.
"""
import dataclasses
import math
import os
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro import configs as j_configs
from repro.launch import specs as j_specs
from repro.models import common as j_common

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import simulator_jit as sj
from repro_torch.core.scheduler import Policy
from repro_torch.kernels import _build, meta, ops
from repro_torch.launch import dryrun, perf, specs
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.pytree import tree_items
from repro_torch.runtime import sharding
from repro_torch.runtime.hlo_analysis import OpStream, _link_bytes, \
    analyze_ops

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def reference_launch(monkeypatch):
    """The reference's dryrun and perf modules; importing them appends to
    XLA_FLAGS, which the fixture restores."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as j_dryrun
    from repro.launch import perf as j_perf
    return j_dryrun, j_perf


# ----------------------------------------------------------------------
# specs, tables and variants against the reference
# ----------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items() if k != "pos"}
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
    for s in configs.SHAPES:
        if not configs.supports_shape(cfg, s):
            continue
        js = j_configs.SHAPES_BY_NAME[s.name]
        got = specs.input_specs(cfg, s)
        want = j_specs.input_specs(jcfg, js, j_common.DEFAULT_RC)
        assert _shapes(got) == _shapes(want), (arch, s.name)
        if s.kind == "decode":
            assert got["cache"]["pos"] == s.seq_len - 1
        for t in (v for _, v in tree_items(got)
                  if isinstance(v, torch.Tensor)):
            assert t.device.type == "meta"
    assert _shapes(specs.params_abstract(cfg)) \
        == _shapes(j_specs.params_abstract(jcfg))


def test_policy_tables_equal_the_reference(reference_launch):
    j_dryrun, _ = reference_launch
    for name in ("BIG_TRAIN", "MICROBATCH", "INT8_MOMENTS", "BF16_ACCUM",
                 "SMALL_2D", "FSDP_OVER_POD"):
        assert getattr(dryrun, name) == getattr(j_dryrun, name), name
    dt = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    for arch in configs.ARCHS:
        assert dryrun.cell_opt(arch).moments_int8 \
            == j_dryrun.cell_opt(arch).moments_int8
        for s in configs.SHAPES_BY_NAME:
            assert dryrun.cell_mode(arch, s) == j_dryrun.cell_mode(arch, s)
        for kind in ("train", "prefill", "decode"):
            assert dryrun.cell_microbatches(arch, kind) \
                == j_dryrun.cell_microbatches(arch, kind)
            got = dataclasses.asdict(dryrun.cell_rc(arch, kind))
            want = dataclasses.asdict(j_dryrun.cell_rc(arch, kind))
            for k in ("compute_dtype", "param_dtype"):
                got[k] = dt[got[k]]
                want[k] = jnp.dtype(want[k]).name
            assert got == want, (arch, kind)


def test_perf_variants_equal_the_reference(reference_launch):
    _, j_perf = reference_launch
    assert list(perf.VARIANTS) == list(j_perf.VARIANTS)
    for cell, spec in perf.VARIANTS.items():
        ref = j_perf.VARIANTS[cell]
        assert (spec["arch"], spec["shape"]) == (ref["arch"], ref["shape"])
        assert list(spec["variants"]) == list(ref["variants"])
        for name, kw in spec["variants"].items():
            assert sorted(kw) == sorted(ref["variants"][name]), (cell, name)


def test_perf_override_is_undone(monkeypatch, tmp_path):
    """xlstm's chunk variant sees its chunk; the port's ARCHS is whole
    again afterwards (the reference changes it in place)."""
    seen = []

    def fake(arch, shape_name, **kw):
        seen.append(configs.get_config(arch).xlstm.chunk)
        return {"per_device_hbm_bytes": 0, "flops_per_device": 0.0,
                "bytes_per_device": 0.0, "collective_link_bytes": 0.0}

    monkeypatch.setattr(perf, "lower_variant", fake)
    monkeypatch.setattr(perf, "OUT", tmp_path)
    before = configs.ARCHS["xlstm-125m"]
    perf.run("xlstm_prefill", "chunk128")
    assert seen == [128]
    assert configs.ARCHS["xlstm-125m"] is before
    assert configs.get_config("xlstm-125m").xlstm.chunk == 256
    assert (tmp_path / "xlstm_prefill__chunk128.json").exists()


# ----------------------------------------------------------------------
# the dry run on a fake mesh
# ----------------------------------------------------------------------

def _local_bytes(tree, placements, mesh_shape):
    total = 0
    place = dict(tree_items(placements))
    for k, t in tree_items(tree):
        if isinstance(t, torch.Tensor):
            total += math.prod(sharding.local_shape(
                place[k], mesh_shape, t.shape)) * t.element_size()
    return total


def _argument_bytes(arch, shape, mesh_shape):
    """A cell's argument bytes a device, from the specs alone."""
    kind = shape.kind
    cfg = configs.get_config(arch)
    rc = dryrun.cell_rc(arch, kind)
    with dryrun.fake_mesh(mesh_shape, ("data", "model")) as mesh:
        rules = sharding.AxisRules(mesh, sequence_parallel=True)
        if kind == "train":
            params = specs.params_abstract(cfg, rc, master=True)
            from repro_torch.optim import init_opt_state
            opt = init_opt_state(params, dryrun.cell_opt(arch))
            mv = [k for k in opt if k != "step"]
            trees = [(params, sharding.param_specs(params, rules)),
                     ({k: opt[k] for k in mv},
                      {k: (sharding.param_specs(params, rules)
                           if k in ("m", "v")
                           else sharding.replicated(opt[k], rules))
                       for k in mv}),
                     ({"step": opt["step"]},
                      sharding.replicated({"step": opt["step"]}, rules))]
            batch = specs.train_batch_specs(cfg, shape, rc)
        else:
            params = specs.params_abstract(cfg, rc)
            trees = [(params, sharding.param_specs(params, rules))]
            batch = specs.prefill_batch_specs(cfg, shape, rc) \
                if kind == "prefill" \
                else {"t": specs.decode_token_specs(cfg, shape)}
            if kind == "decode":
                cache = specs.cache_specs_abstract(cfg, shape, rc)
                trees.append((cache, sharding.cache_specs(cache, rules)))
        trees.append((batch, sharding.batch_specs(batch, rules)))
    return sum(_local_bytes(t, p, mesh_shape) for t, p in trees)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cell_on_a_fake_2x2_mesh(kind):
    arch = "tinyllama-1.1b-smoke"
    shape = ShapeConfig("smoke", 32, 4, kind)
    rec = dryrun.measure_cell(arch, shape, (2, 2), ("data", "model"))
    assert not dist.is_initialized()
    want = _argument_bytes(arch, shape, (2, 2))
    assert rec["argument_size_in_bytes"] == want
    assert rec["n_devices"] == 4
    assert rec["per_device_hbm_bytes"] \
        == want + rec["peak_step_bytes"] > want
    assert rec["fits_80gib"] and rec["flops_per_device"] > 0
    assert rec["collectives"] and rec["collective_link_bytes"] > 0
    assert rec["wall_seconds"] < 30


# The train_4k cells that raised in the backward before the port's
# sharding.reshape (_Reshape), common.log_sigmoid and
# sharding.contiguous_grad, at full widths with the depth cut, on the
# smallest fake mesh that reproduced each error: (arch, cut as
# dataclasses.replace keywords, a dict replacing a sub-config's fields,
# mesh, seq, batch).  Each raised on the tree before those changes.
TRAIN_GAPS = {
    # the expert products' backward: a gradient whose global stride its
    # shards lack, then aten.view of a non-contiguous local gradient
    # (8 rows: 4 microbatches of 2, one a data rank)
    "maverick-view": ("llama4-maverick-400b-a17b", {"n_layers": 2},
                      (2, 2), 16, 8),
    # the RG-LRU's 10-head merge: 2560 sharded 4 ways does not
    # unflatten into 10 heads
    "recurrentgemma-heads": ("recurrentgemma-2b", {"n_layers": 2},
                             (1, 4), 16, 2),
    # aten.log_sigmoid_backward has no sharding strategy
    "xlstm-logsigmoid": ("xlstm-125m",
                         {"n_layers": 2, "xlstm": {"slstm_every": 2}},
                         (2, 2), 16, 4),
    # the mLSTM's 4-head split: 1536 sharded 8 ways into 4 heads
    "xlstm-heads": ("xlstm-125m",
                    {"n_layers": 2, "xlstm": {"slstm_every": 2}},
                    (1, 8), 16, 2),
}


@pytest.mark.parametrize("gap", sorted(TRAIN_GAPS))
def test_a_train_cell_that_raised_in_the_backward_runs(gap, monkeypatch):
    arch, cut, mesh_shape, seq, batch = TRAIN_GAPS[gap]
    cfg = configs.ARCHS[arch]
    monkeypatch.setitem(configs.ARCHS, arch, dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v)
        if isinstance(v, dict) else v for k, v in cut.items()}))
    shape = ShapeConfig("cut", seq, batch, "train")
    rec = dryrun.measure_cell(arch, shape, mesh_shape, ("data", "model"),
                              mode=dryrun.cell_mode(arch, "train_4k"))
    assert not dist.is_initialized()
    assert rec["flops_per_device"] > 0
    assert rec["argument_size_in_bytes"] \
        == _argument_bytes(arch, shape, mesh_shape)


def test_a_failing_cell_is_recorded_and_a_bug_propagates(monkeypatch,
                                                         tmp_path):
    def no_strategy(*a, **kw):
        raise NotImplementedError("Operator aten.foo.default does not "
                                  "have a sharding strategy registered.")
    monkeypatch.setattr(dryrun, "measure_cell", no_strategy)
    rec = dryrun.run_cell("olmo-1b", "decode_32k", False, tmp_path,
                          probe=False)
    assert rec["status"] == "error" and "aten.foo" in rec["error"]
    assert (tmp_path / "olmo-1b__decode_32k__pod1.json").exists()

    def bug(*a, **kw):
        raise NameError("undefined")
    monkeypatch.setattr(dryrun, "measure_cell", bug)
    with pytest.raises(NameError):
        dryrun.run_cell("olmo-1b", "decode_32k", False, tmp_path,
                        probe=False)


def test_main_runs_the_supported_cells(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(
        dryrun, "run_cell",
        lambda a, s, mp, probe=True: calls.append((a, s, mp, probe)) or {
            "status": "error", "error": "stub"})
    dryrun.main(["--arch", "tinyllama-1.1b", "--multi-pod", "--no-probe"])
    assert calls == [("tinyllama-1.1b", s, True, False)
                     for s in ("train_4k", "prefill_32k", "decode_32k")]
    assert "SKIP tinyllama-1.1b x long_500k" in capsys.readouterr().out


def test_meshes_are_built_when_called_and_scoped():
    assert not dist.is_initialized()
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        assert dist.get_world_size() == 4
        assert tuple(mesh.shape) == (2, 2)
        dbg = make_debug_mesh(2, 2)
        assert dbg.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    for multi_pod, shape, names in (
            (False, (16, 16), ("data", "model")),
            (True, (2, 16, 16), ("pod", "data", "model"))):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
        try:
            m = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            assert tuple(m.shape) == shape and m.mesh_dim_names == names
        finally:
            dist.destroy_process_group()


# ----------------------------------------------------------------------
# the op-stream analysis
# ----------------------------------------------------------------------

def test_analysis_counts_a_known_product_exactly():
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    out, res = analyze_ops(torch.mm, a, b)
    assert res["flops"] == 2 * 64 * 32 * 16
    assert res["hbm_bytes"] == res["hbm_bytes_no_copies"] \
        == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert res["peak_bytes"] == 64 * 16 * 4
    assert res["collectives"] == {} and res["collective_link_bytes"] == 0
    # a buffer made inside the call counts from its allocation, however
    # it is filled
    _, res = analyze_ops(lambda: torch.zeros(1000, 250).index_fill_(
        0, torch.tensor([3]), 1.0))
    assert res["peak_bytes"] == 1000 * 250 * 4
    # views move nothing; a copy is left out of the no-copies count
    _, res = analyze_ops(lambda t: t.t().clone(), a)
    assert res["hbm_bytes"] == 2 * 64 * 32 * 4
    assert res["hbm_bytes_no_copies"] == 0


def test_analysis_counts_known_redistributions_on_a_fake_4_rank_mesh():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with dryrun.fake_mesh((4,), ("model",)) as mesh:
        local = torch.empty(16, 32, device="meta")
        full = 64 * 32 * 4
        x = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
        with OpStream() as m:
            x.redistribute(mesh, [Replicate()])
        ag = m.result()["collectives"]["all-gather"]
        assert ag == {"count": 1, "out_bytes": full,
                      "link_bytes": _link_bytes("all-gather", full, 4)}
        assert ag["link_bytes"] == 3 / 4 * full
        p = DTensor.from_local(torch.empty(64, 32, device="meta"), mesh,
                               [Partial()], run_check=False)
        with OpStream() as m:
            p.redistribute(mesh, [Replicate()])
        ar = m.result()["collectives"]["all-reduce"]
        assert ar["count"] == 1 and ar["link_bytes"] == 2 * 3 / 4 * full
        with OpStream() as m:
            p.redistribute(mesh, [Shard(0)])
        rs = m.result()["collectives"]["reduce-scatter"]
        assert rs["count"] == 1 and rs["out_bytes"] == full / 4
        assert rs["link_bytes"] == 3 * full / 4


def test_meta_kernels_give_the_kernels_layouts_and_flops():
    def m(*shape, dt=torch.bfloat16):
        return torch.empty(shape, dtype=dt, device="meta")
    before = dict(_build.LAUNCHES)
    with OpStream() as mode:
        o = ops.flash_attention(m(2, 8, 256, 64), m(2, 2, 256, 64),
                                m(2, 2, 256, 64))
    assert tuple(o.shape) == (2, 8, 256, 64)
    assert o.stride() == torch.empty(2, 256, 8, 64).transpose(1, 2).stride()
    assert mode.flops == 2 * 2 * 8 * (256 * 257 // 2) * (64 + 64)
    with OpStream() as mode:
        ops.flash_attention(m(1, 4, 256, 32), m(1, 4, 256, 32),
                            m(1, 4, 256, 16), window=64)
    assert meta.attention_pairs(256, 256, True, 64) \
        == 64 * 65 // 2 + (256 - 64) * 64
    assert mode.flops == 2 * 4 * meta.attention_pairs(256, 256, True, 64) \
        * (32 + 16)
    with OpStream() as mode:
        d = ops.decode_attention(m(3, 8, 64), m(3, 2, 512, 64),
                                 m(3, 2, 512, 64), 99)
        h = ops.rglru(m(2, 64, 128, dt=torch.float32),
                      m(2, 64, 128, dt=torch.float32),
                      m(2, 128, dt=torch.float32))
        g = ops.gemm(m(256, 512), m(512, 128))
        r = ops.gemm_resume(m(256, 1024), m(1024, 128),
                            m(256, 128, dt=torch.float32), 1, 3)
    assert tuple(d.shape) == (3, 8, 64) and tuple(h.shape) == (2, 64, 128)
    assert g.dtype == torch.bfloat16 and r.dtype == torch.float32
    assert mode.flops == (4 * 3 * 8 * 100 * 64 + 2 * 2 * 64 * 128
                          + 2 * 256 * 128 * 512
                          + 2 * 256 * 128 * 512 + 256 * 128)
    assert dict(_build.LAUNCHES) == before


# ----------------------------------------------------------------------
# kernel counts of a captured graph
# ----------------------------------------------------------------------

def test_while_body_kernels_counts_a_graph_dump_from_the_card():
    """The DOT dump of a graph of ``y = x * 2; x.add_(1); y.sum();
    x.copy_(w); w.zero_()`` captured with debug mode on the card: the
    product, the add, the sum and the zero fill are kernel nodes; the
    copy is a memcpy node and does not count."""
    text = (DATA / "cuda_graph_small.dot").read_text()
    assert text.count("KERNEL") == 4 and text.count("MEMCPY") == 1
    assert sj.while_body_kernels(text) == 4
    assert sj.while_body_kernels("digraph dot {\n}\n") == 0


def test_lockstep_kernel_count_refuses_the_cpu():
    from chip_smoke import sim_library
    lib = sim_library()
    from repro_torch.core.taskgen import generate_taskset
    ts = [generate_taskset(0.7, seed=0, n_tasks=4, programs=lib)]
    with pytest.raises(ValueError, match="no graph to count"):
        sj.lockstep_kernel_count(ts, lib, Policy.mesc(), seeds=[0],
                                 device="cpu")


def test_one_rank_cell_equals_the_plain_step_and_four_ranks_split_it():
    """DTensor's own stand-ins stay out of the count: on a (1, 1) mesh a
    prefill cell's flops and peak equal the plain meta step's, and a
    (2, 2) mesh splits tinyllama-1.1b's prefill flops four ways."""
    from repro_torch.runtime.trainer import make_prefill_step
    arch = "tinyllama-1.1b"
    cfg, rc = configs.get_config(arch), dryrun.cell_rc(arch, "prefill")
    shape = ShapeConfig("small", 256, 8, "prefill")
    _, plain = analyze_ops(make_prefill_step(cfg, rc),
                           specs.params_abstract(cfg, rc),
                           specs.prefill_batch_specs(cfg, shape, rc))
    one = dryrun.measure_cell(arch, shape, (1, 1), ("data", "model"),
                              rc=rc)
    assert one["flops_per_device"] == plain["flops"]
    assert one["peak_step_bytes"] == plain["peak_bytes"]
    four = dryrun.measure_cell(arch, shape, (2, 2), ("data", "model"),
                               rc=rc)
    assert four["flops_per_device"] * 4 == plain["flops"]
