"""Production meshes (twin of the reference's ``launch/mesh.py``).

Defined as FUNCTIONS so that importing this module builds no mesh and
touches no process group.  Each needs a default process group of at
least the mesh's size: ``torch.distributed.init_process_group`` with one
rank per card, or the dry run's fake group (``launch/dryrun.py``).
"""
from __future__ import annotations


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 (256 cards) or 2x16x16 (512 cards): the reference's shapes,
    so every per-device layout can be held against its layouts.

    Axis roles: 'pod' = pure DP across pods (slow links, gradient
    all-reduce only), 'data' = DP + FSDP shard axis, 'model' =
    TP/EP/vocab/sequence.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: str = "cpu"):
    """Small mesh for tests (needs a process group of n_data * n_model
    ranks)."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
