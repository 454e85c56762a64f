"""Config registry of the port: the reference's ten configs (plus smoke
variants), in the reference's order — ``core/program.py``'s workload
library builds one ``arch:`` program per entry, in this order."""
from __future__ import annotations

from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      SHAPES, SHAPES_BY_NAME, TRAIN_4K,
                                      ArchConfig, MLAConfig, MoEConfig,
                                      RGLRUConfig, ShapeConfig, XLSTMConfig,
                                      supports_shape)
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE
from repro_torch.configs.llama4_maverick_400b_a17b import \
    CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.llava_next_34b import CONFIG as LLAVA_NEXT_34B
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE
from repro_torch.configs.olmo_1b import CONFIG as OLMO_1B
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI
from repro_torch.configs.qwen1_5_110b import CONFIG as QWEN15_110B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
from repro_torch.configs.xlstm_125m import CONFIG as XLSTM_125M

ARCHS = {
    c.name: c for c in (
        LLAMA4_MAVERICK, DEEPSEEK_V2_LITE, OLMO_1B, PHI4_MINI, TINYLLAMA,
        QWEN15_110B, RECURRENTGEMMA_2B, LLAVA_NEXT_34B, XLSTM_125M,
        MUSICGEN_LARGE,
    )
}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[:-len("-smoke")]].reduced()
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


__all__ = [
    "ArchConfig", "MLAConfig", "MoEConfig", "RGLRUConfig", "XLSTMConfig",
    "ShapeConfig", "SHAPES", "SHAPES_BY_NAME", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "supports_shape", "ARCHS", "get_config",
    "list_archs",
]
