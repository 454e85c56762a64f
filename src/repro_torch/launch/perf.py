"""Perf harness: dry-run named VARIANTS of three cells and record their
per-device terms (twin of the reference's ``launch/perf.py``), for the
hypothesis -> change -> measure -> validate loop.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen_train --variant mb2

Each variant runs the cell's step on the fake 16x16 mesh of
``launch/dryrun.py`` and records its argument and peak bytes per device,
flops, bytes and collectives.  Records go to ``results/perf_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

import repro_torch.configs as C
from repro_torch.configs import SHAPES_BY_NAME
from repro_torch.launch.dryrun import (MESHES, analyze, cell_opt, cell_rc,
                                       fake_mesh, lower_cell)
from repro_torch.runtime import sharding as shlib

OUT = Path(__file__).resolve().parents[3] / "results" / "perf_torch"


def lower_variant(arch, shape_name, *, rc=None, microbatches=None,
                  mode="sp", opt_cfg=None, accum_dtype=torch.float32):
    """Run one variant of a cell on the fake 16x16 mesh; its
    :func:`dryrun.analyze` record."""
    shape = SHAPES_BY_NAME[shape_name]
    mesh_shape, names = MESHES[False]
    with fake_mesh(mesh_shape, names) as mesh:
        rules = shlib.AxisRules(mesh, sequence_parallel=True, mode=mode)
        step, args = lower_cell(arch, shape, mesh, rules, rc,
                                microbatches=microbatches,
                                opt_cfg=opt_cfg or cell_opt(arch),
                                accum_dtype=accum_dtype)
        rec = analyze(step, args, rules)
    rec["n_devices"] = int(mesh.size())
    return rec


# ---------------------------------------------------------------------------
# Variant registry (the reference's hypotheses)
# ---------------------------------------------------------------------------

def _qwen_rc(**kw):
    return dataclasses.replace(cell_rc("qwen1.5-110b", "train"), **kw)


def _xlstm_cfg_chunk(chunk):
    """xlstm-125m with its mLSTM chunk set to ``chunk``."""
    cfg = C.ARCHS["xlstm-125m"]
    return dataclasses.replace(cfg, xlstm=dataclasses.replace(
        cfg.xlstm, chunk=chunk))


VARIANTS = {
    "qwen_train": {
        "arch": "qwen1.5-110b", "shape": "train_4k",
        "variants": {
            "baseline": {},
            "mb2": {"microbatches": 2},
            "mb1": {"microbatches": 1},
            "dots": {"rc": _qwen_rc(remat_policy="dots", remat_groups=0),
                     "microbatches": 4},
            "mb2_groups4": {"microbatches": 2,
                            "rc": _qwen_rc(remat_groups=4)},
            # dots needs less memory headroom via more microbatches
            "dots_mb8": {"rc": _qwen_rc(remat_policy="dots", remat_groups=0),
                         "microbatches": 8},
            # ZeRO-3 (2d batch sharding) vs Megatron-SP: weight gathers vs
            # activation all-gathers / reduce-scatters
            "2d_dots_mb1": {"mode": "2d", "microbatches": 1,
                            "rc": _qwen_rc(remat_policy="dots",
                                           remat_groups=0)},
            "2d_full_mb2": {"mode": "2d", "microbatches": 2},
            # 2d needs mb=1 (B=256 = dp x tp exactly); full remat trades
            # one extra gather pass for activation memory
            "2d_full_mb1": {"mode": "2d", "microbatches": 1,
                            "rc": _qwen_rc(remat_groups=0)},
            "2d_groups8_mb1": {"mode": "2d", "microbatches": 1},
        },
    },
    "xlstm_prefill": {
        "arch": "xlstm-125m", "shape": "prefill_32k",
        "variants": {
            "baseline": {},
            "chunk128": {"cfg_override": 128},
            "chunk512": {"cfg_override": 512},
            "chunk1024": {"cfg_override": 1024},
        },
    },
    "qwen_decode": {
        "arch": "qwen1.5-110b", "shape": "decode_32k",
        "variants": {
            "baseline": {},
            # the in-place write touches one slot; the select touches the
            # whole cache
            "dus_update": {"rc": dataclasses.replace(
                cell_rc("qwen1.5-110b", "decode"), dus_cache_update=True)},
        },
    },
}


def run(cell: str, variant: str):
    spec = VARIANTS[cell]
    kw = dict(spec["variants"][variant])
    cfg_override = kw.pop("cfg_override", None)
    arch = spec["arch"]
    saved = C.ARCHS[arch]
    if cfg_override is not None:
        C.ARCHS[arch] = _xlstm_cfg_chunk(cfg_override)
    t0 = time.perf_counter()
    try:
        rec = lower_variant(arch, spec["shape"], **kw)
    finally:
        C.ARCHS[arch] = saved          # the override is this variant's only
    rec = {"cell": cell, "variant": variant,
           "run_s": time.perf_counter() - t0, **rec}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{cell}__{variant}.json").write_text(json.dumps(rec, indent=2))
    print(f"{cell}/{variant}: hbm={rec['per_device_hbm_bytes'] / 2**30:.2f}GiB "
          f"flops/dev={rec['flops_per_device']:.3e} "
          f"bytes/dev={rec['bytes_per_device']:.3e} "
          f"coll={rec['collective_link_bytes'] / 2**30:.1f}GiB")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--variant", default=None)
    args = ap.parse_args(argv)
    variants = ([args.variant] if args.variant
                else list(VARIANTS[args.cell]["variants"]))
    for v in variants:
        run(args.cell, v)


if __name__ == "__main__":
    main()
