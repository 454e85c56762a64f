"""Dry run of every (architecture x shape x mesh) cell without a card
(twin of the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 256 or 512 forced host
devices.  Here each cell runs its step once on a fake process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``): the
parameters, optimizer state, batch and cache are DTensors of ``meta``
shards with the placements of ``param_specs``, ``cache_specs`` and
``batch_specs``, the step is ``runtime/trainer.py``'s, run under
``axis_rules``, and rank 0's operations are recorded by
``runtime.hlo_analysis.OpStream``.  Collectives of the fake group move
nothing, and meta tensors hold no data, so only shapes, dtypes,
placements and arithmetic are real.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Per cell it records argument bytes per device (exact, from the local
shard shapes), peak live bytes per device (arguments plus the most the
step held at once), the op-stream analysis, wall time and ``status``
(with the error on failure), and whether the peak fits one H100 80GB
card.  Records go to ``results/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_config, \
    supports_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs as S
from repro_torch.models.common import RuntimeConfig
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.pytree import tree_leaves
from repro_torch.runtime import sharding as shlib
from repro_torch.runtime.hlo_analysis import analyze_ops
from repro_torch.runtime.trainer import (make_decode_step, make_prefill_step,
                                         make_train_step)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# one H100 80GB HBM3's memory: the fit criterion
DEVICE_BYTES = 80 * 2 ** 30

# Failures one analysis probe may survive (recorded per cell, never fatal
# to the sweep).  A DTensor operation without a sharding strategy raises
# NotImplementedError or RuntimeError.
PROBE_ERRORS = (AttributeError, KeyError, TypeError, ValueError,
                RuntimeError, NotImplementedError, AssertionError,
                IndexError)
# Failures one *cell* may survive: they land in the cell's record and the
# sweep moves on.  Genuine bugs (NameError, ImportError) and
# KeyboardInterrupt still propagate.
CELL_ERRORS = PROBE_ERRORS + (MemoryError, OSError)

# --------------------------------------------------------------------------
# Per-cell runtime policy (the reference's tables)
# --------------------------------------------------------------------------

BIG_TRAIN = {"qwen1.5-110b": 8, "llava-next-34b": 6, "llama4-maverick-400b-a17b": 6}
# grad-accumulation microbatches for train cells (activation-linear memory)
MICROBATCH = {"qwen1.5-110b": 4, "llava-next-34b": 4,
              "llama4-maverick-400b-a17b": 4, "phi4-mini-3.8b": 2,
              "recurrentgemma-2b": 2, "deepseek-v2-lite-16b": 2}


def cell_microbatches(arch_name: str, shape_kind: str) -> int:
    return MICROBATCH.get(arch_name, 1) if shape_kind == "train" else 1


INT8_MOMENTS = {"llama4-maverick-400b-a17b"}
BF16_ACCUM = {"llama4-maverick-400b-a17b"}


def cell_opt(arch_name: str) -> OptConfig:
    return OptConfig(moments_int8=arch_name in INT8_MOMENTS)


def cell_rc(arch_name: str, shape_kind: str) -> RuntimeConfig:
    if shape_kind == "train":
        return RuntimeConfig(
            compute_dtype=torch.bfloat16,
            param_dtype=torch.bfloat16
            if arch_name == "llama4-maverick-400b-a17b" else torch.float32,
            remat_policy="full",
            remat_groups=BIG_TRAIN.get(arch_name, 0),
            sequence_parallel=True,
            flash_block_q=512, flash_block_kv=1024)
    return RuntimeConfig(compute_dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16,
                         sequence_parallel=(shape_kind == "prefill"),
                         pad_attn_heads=16,   # TP-align odd head counts
                         flash_block_q=512, flash_block_kv=1024)


SMALL_2D = {"tinyllama-1.1b", "olmo-1b", "xlstm-125m", "musicgen-large",
            "phi4-mini-3.8b"}


def cell_mode(arch_name: str, shape_name: str) -> str:
    """2d (ZeRO-3 batch sharding) for small archs in training; sp+TP else."""
    if shape_name == "train_4k" and arch_name in SMALL_2D:
        return "2d"
    return "sp"


FSDP_OVER_POD = {"llama4-maverick-400b-a17b", "qwen1.5-110b"}

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


# --------------------------------------------------------------------------
# The fake process group and a cell's step
# --------------------------------------------------------------------------

@contextmanager
def fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` on a fake process group of its size,
    as rank 0; the group is destroyed on exit, so nothing global is left
    behind."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def lower_cell(arch_name: str, shape: ShapeConfig, mesh, rules,
               rc_override: Optional[RuntimeConfig] = None, *,
               microbatches: Optional[int] = None,
               opt_cfg: Optional[OptConfig] = None, accum_dtype=None):
    """The cell's step and its DTensor arguments, nothing run yet:
    ``(fn, args)``.  A train cell's microbatches, optimizer and
    accumulator dtype default to the policy tables'."""
    cfg = get_config(arch_name)
    rc = rc_override or cell_rc(arch_name, shape.kind)
    if shape.kind == "train":
        opt_cfg = opt_cfg or cell_opt(arch_name)
        if microbatches is None:
            microbatches = cell_microbatches(arch_name, "train")
        if accum_dtype is None:
            accum_dtype = torch.bfloat16 if arch_name in BF16_ACCUM \
                else torch.float32
        params_a = S.params_abstract(cfg, rc, master=True)
        opt_a = init_opt_state(params_a, opt_cfg)
        batch_a = S.train_batch_specs(cfg, shape, rc)
        p_spec = shlib.param_specs(params_a, rules)
        o_spec = {k: (shlib.param_specs(params_a, rules)
                      if k in ("m", "v") else shlib.replicated(v, rules))
                  for k, v in opt_a.items()}
        step = make_train_step(cfg, rc, opt_cfg, microbatches=microbatches,
                               accum_dtype=accum_dtype)
        args = (shlib.distribute(params_a, p_spec, mesh),
                shlib.distribute(opt_a, o_spec, mesh),
                shlib.distribute(batch_a, shlib.batch_specs(batch_a, rules),
                                 mesh))
    elif shape.kind == "prefill":
        params_a = S.params_abstract(cfg, rc)
        batch_a = S.prefill_batch_specs(cfg, shape, rc)
        step = make_prefill_step(cfg, rc)
        args = (shlib.distribute(params_a, shlib.param_specs(params_a, rules),
                                 mesh),
                shlib.distribute(batch_a, shlib.batch_specs(batch_a, rules),
                                 mesh))
    else:
        params_a = S.params_abstract(cfg, rc)
        tok_a = S.decode_token_specs(cfg, shape)
        cache_a = S.cache_specs_abstract(cfg, shape, rc)
        step = make_decode_step(cfg, rc)
        args = (shlib.distribute(params_a, shlib.param_specs(params_a, rules),
                                 mesh),
                shlib.distribute({"t": tok_a},
                                 shlib.batch_specs({"t": tok_a}, rules),
                                 mesh)["t"],
                shlib.distribute(cache_a, shlib.cache_specs(cache_a, rules),
                                 mesh))
    return step, args


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors on this rank."""
    from torch.distributed.tensor import DTensor
    leaves = tree_leaves(tree) if isinstance(tree, dict) else [tree]
    n = 0
    for t in leaves:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def analyze(step, args, rules) -> dict:
    """Run the step once under ``axis_rules`` and the op-stream analysis;
    per-device bytes, flops, collectives and wall time."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_bytes = sum(local_bytes(a) for a in args)
    t0 = time.perf_counter()
    with shlib.axis_rules(rules), implicit_replication():
        _, h = analyze_ops(step, *args)
    res = {"wall_seconds": time.perf_counter() - t0,
           "argument_size_in_bytes": arg_bytes,
           "peak_step_bytes": h["peak_bytes"],
           "per_device_hbm_bytes": arg_bytes + h["peak_bytes"]}
    res["fits_80gib"] = res["per_device_hbm_bytes"] <= DEVICE_BYTES
    res["flops_per_device"] = h["flops"]
    res["bytes_per_device"] = h["hbm_bytes"]
    res["bytes_no_copies"] = h["hbm_bytes_no_copies"]
    res["collectives"] = h["collectives"]
    res["collective_link_bytes"] = h["collective_link_bytes"]
    return res


def measure_cell(arch_name: str, shape: ShapeConfig,
                 mesh_shape: Tuple[int, ...], names: Tuple[str, ...], *,
                 mode: str = "sp", fsdp_over_pod: bool = False,
                 rc: Optional[RuntimeConfig] = None) -> dict:
    """One cell on a fake mesh of ``mesh_shape``: :func:`analyze`'s
    record (raises on failure)."""
    with fake_mesh(mesh_shape, names) as mesh:
        rules = shlib.AxisRules(mesh, sequence_parallel=True, mode=mode,
                                fsdp_over_pod=fsdp_over_pod)
        step, args = lower_cell(arch_name, shape, mesh, rules, rc)
        rec = analyze(step, args, rules)
    rec["n_devices"] = int(mesh.size())
    return rec


def cost_probe(arch_name: str, shape_name: str) -> dict:
    """The same step on a 1-rank mesh with the constraints off: the
    step's global flops and bytes (the reference's single-device
    probe)."""
    shape = SHAPES_BY_NAME[shape_name]
    rc = dataclasses.replace(cell_rc(arch_name, shape.kind),
                             cost_probe=True, logical_axes=False)
    rec = measure_cell(arch_name, shape, (1, 1), ("data", "model"), rc=rc)
    return {"probe_global_flops": rec["flops_per_device"],
            "probe_global_bytes": rec["bytes_per_device"]}


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: Path = RESULTS_DIR, probe: bool = True) -> dict:
    mesh_shape, names = MESHES[multi_pod]
    tag = f"{arch_name}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    out_dir.mkdir(parents=True, exist_ok=True)
    rec: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "status": "ok"}
    t0 = time.perf_counter()
    try:
        rec.update(measure_cell(
            arch_name, SHAPES_BY_NAME[shape_name], mesh_shape, names,
            mode=cell_mode(arch_name, shape_name),
            fsdp_over_pod=multi_pod and arch_name in FSDP_OVER_POD))
        if probe:
            try:
                rec.update(cost_probe(arch_name, shape_name))
            except PROBE_ERRORS as e:     # the probe is best-effort
                rec["probe_error"] = f"{type(e).__name__}: {e}"
                print(f"dryrun: {tag}: cost probe failed: "
                      f"{rec['probe_error']}", file=sys.stderr)
    except CELL_ERRORS as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"dryrun: {tag}: cell failed: {rec['error'][:300]}",
              file=sys.stderr)
    rec["cell_seconds"] = time.perf_counter() - t0
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the 1-rank global-flops probe")
    args = ap.parse_args(argv)

    cells = []
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = (["train_4k", "prefill_32k", "decode_32k", "long_500k"]
              if (args.all or not args.shape) else [args.shape])
    for a in archs:
        for s in shapes:
            if supports_shape(ARCHS[a], SHAPES_BY_NAME[s]):
                cells.append((a, s))
            else:
                print(f"SKIP {a} x {s} (needs sub-quadratic attention)")

    for a, s in cells:
        tag = f"{a}__{s}__{'pod2' if args.multi_pod else 'pod1'}"
        if args.skip_existing and (RESULTS_DIR / f"{tag}.json").exists():
            prev = json.loads((RESULTS_DIR / f"{tag}.json").read_text())
            if prev.get("status") == "ok":
                print(f"CACHED {tag}")
                continue
        print(f"=== {tag} ===", flush=True)
        rec = run_cell(a, s, args.multi_pod, probe=not args.no_probe)
        if rec["status"] == "ok":
            print(f"  ok: {rec['wall_seconds']:.1f}s "
                  f"args/device={rec['argument_size_in_bytes'] / 2**30:.2f}GiB "
                  f"peak/device={rec['per_device_hbm_bytes'] / 2**30:.2f}GiB "
                  f"fits80={rec['fits_80gib']} "
                  f"flops/device={rec['flops_per_device']:.3e} "
                  f"coll={rec['collective_link_bytes'] / 2**30:.3f}GiB",
                  flush=True)
        else:
            print(f"  ERROR: {rec['error'][:300]}", flush=True)


if __name__ == "__main__":
    main()
