"""Atomic checkpoints in the reference's on-disk format (twin of its
``checkpointing/checkpoint.py``), so either package loads the other's.

  * a checkpoint is a directory ``step_<n>.tmp`` renamed to ``step_<n>``
    (8 digits) once fully written: a crash mid-write never corrupts one;
  * each top-level group of the state (``{"params": ..., "opt": ...}``)
    is one ``<group>.npz`` of its leaves, keyed by their paths joined with
    ``/``, in the reference's sorted-key order (``pytree``); a dtype numpy
    lacks is stored as its bits (bf16 as uint16) under its name;
  * ``manifest.json`` holds ``step``, ``time``, each group's keys with
    their ``shape`` and ``dtype``, and ``extra`` (e.g. the data cursor);
  * retention keeps the last ``keep`` checkpoints.

A restore places the arrays on the caller's ``device`` (the counterpart
of the reference's target shardings), whatever device saved them.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.pytree import from_numpy, to_numpy, tree_items, \
    tree_unflatten
from repro_torch.runtime.device import resolve_device


def save_checkpoint(directory, step: int, state: Dict[str, Any],
                    extra: Optional[dict] = None, keep: int = 3) -> Path:
    """state: dict of trees (e.g. {'params': ..., 'opt': ...}).  Atomic."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:08d}.tmp"
    final = directory / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "time": time.time(), "groups": {},
                "extra": extra or {}}
    for group, tree in state.items():
        arrays, meta = {}, {}
        for key, leaf in tree_items(tree):
            arr, dtype = to_numpy(leaf)
            meta[key] = {"shape": list(arr.shape), "dtype": dtype}
            arrays[key] = arr
        np.savez(tmp / f"{group}.npz", **arrays)
        manifest["groups"][group] = meta
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    ckpts = sorted(p for p in directory.iterdir()
                   if p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.iterdir()
             if p.name.startswith("step_") and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(directory, templates: Dict[str, Any],
                    step: Optional[int] = None, device=None):
    """(state, manifest): each group of ``templates`` (trees whose
    structure names the keys to read; a meta tree will do) restored on
    ``device`` (default: the CUDA card) in its saved dtypes; the latest
    step unless ``step`` is given."""
    device = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    state = {}
    for group, template in templates.items():
        meta = manifest["groups"][group]
        with np.load(d / f"{group}.npz") as z:
            flat = {k: from_numpy(z[k], meta[k]["dtype"]).to(device)
                    for k in z.files}
        state[group] = tree_unflatten(template, flat)
    return state, manifest


class CheckpointManager:
    """Train-loop helper: periodic save, crash-safe resume, retention."""

    def __init__(self, directory, interval: int = 100, keep: int = 3):
        self.directory = Path(directory)
        self.interval = interval
        self.keep = keep

    def maybe_save(self, step: int, state: Dict[str, Any],
                   extra: Optional[dict] = None) -> Optional[Path]:
        if step % self.interval == 0 and step > 0:
            return save_checkpoint(self.directory, step, state, extra,
                                   keep=self.keep)
        return None

    def restore_or_init(self, templates, init_fn, device=None):
        """(state, step, extra): the latest checkpoint on ``device``, or
        ``init_fn()`` at step 0."""
        step = latest_step(self.directory)
        if step is None:
            return init_fn(), 0, {}
        state, manifest = load_checkpoint(self.directory, templates,
                                          step=step, device=device)
        return state, step, manifest.get("extra", {})
