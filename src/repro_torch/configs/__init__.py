"""Config registry of the port: the configs it runs (plus smoke variants)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, RGLRUConfig
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA

ARCHS = {c.name: c for c in (TINYLLAMA, RECURRENTGEMMA_2B)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[:-len("-smoke")]].reduced()
    return ARCHS[name]


__all__ = ["ArchConfig", "RGLRUConfig", "ARCHS", "get_config"]
