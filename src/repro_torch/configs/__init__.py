"""Architecture + shape registry.

``get_config(name)`` returns the exact assigned configuration;
``get_smoke_config(name)`` returns the family-preserving reduced config used
by CPU smoke tests. ``iter_cells()`` yields every (arch x shape) cell with
its applicability verdict.
"""
from __future__ import annotations

from typing import Iterator, Tuple

from repro_torch.configs.base import (
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SSMConfig,
    reduce_for_smoke,
    shape_applicable,
)

from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.llama3_2_3b import CONFIG as _llama
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba

ARCHS = {
    c.name: c
    for c in [
        _chameleon, _whisper, _arctic, _deepseek, _mamba2,
        _llama, _internlm2, _nemotron, _granite, _hymba,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return reduce_for_smoke(get_config(name))


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def iter_cells() -> Iterator[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    """All 40 (arch x shape) cells: (cfg, shape, applicable, skip_reason)."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, why = shape_applicable(arch, shape)
            yield arch, shape, ok, why


__all__ = [
    "ARCHS", "SHAPES", "ModelConfig", "MoEConfig", "SSMConfig", "MLAConfig",
    "RunConfig", "ShapeConfig", "get_config", "get_smoke_config", "get_shape",
    "iter_cells", "reduce_for_smoke", "shape_applicable",
]
