"""Architecture registry: ``--arch <id>`` resolution for every launcher (a
copy of the reference package's registry)."""

from repro_torch.configs.base import (
    ArchConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
    param_count, reduced, shape_applicable,
)
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.qwen2_moe_a2p7b import CONFIG as _qwen2
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.gemma_2b import CONFIG as _gemma2b
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.xlstm_1p3b import CONFIG as _xlstm
from repro_torch.configs.hymba_1p5b import CONFIG as _hymba

ARCHS = {
    c.name: c
    for c in (
        _deepseek, _qwen2, _paligemma, _gemma2b, _starcoder2,
        _glm4, _gemma3, _musicgen, _xlstm, _hymba,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS", "ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "get_arch", "param_count", "reduced", "shape_applicable",
]
