"""Architecture config registry:  get_config(name) / list_archs().

The port's own copy of ``repro.configs`` (plain dataclasses, no array
library): the same ten architectures, field for field, and the port
builds a model of each.
"""

from __future__ import annotations

from .base import LM_SHAPES, ModelConfig, ShapeConfig, cell_is_applicable
from .dbrx_132b import CONFIG as _dbrx
from .deepseek_coder_33b import CONFIG as _dsc
from .falcon_mamba_7b import CONFIG as _mamba
from .h2o_danube3_4b import CONFIG as _danube
from .olmo_1b import CONFIG as _olmo
from .qwen2_moe_a2_7b import CONFIG as _qmoe
from .qwen2_vl_7b import CONFIG as _qvl
from .qwen3_8b import CONFIG as _q3
from .recurrentgemma_2b import CONFIG as _rg
from .whisper_base import CONFIG as _whisper

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [_qvl, _dbrx, _qmoe, _whisper, _olmo, _dsc, _q3, _danube, _rg, _mamba]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return list(ARCHS)


def get_shape(name: str) -> ShapeConfig:
    if name not in LM_SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(LM_SHAPES)}")
    return LM_SHAPES[name]


__all__ = [
    "ARCHS",
    "LM_SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "cell_is_applicable",
    "get_config",
    "get_shape",
    "list_archs",
]
