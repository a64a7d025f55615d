"""Architecture config registry: ``get_config(name)`` / ``list_configs()``.

The port's own copy of ``repro.configs``: framework-free dataclasses, held
field for field against the reference by ``tests/test_torch_models.py``.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeConfig, SHAPES

from .olmoe_1b_7b import CONFIG as olmoe_1b_7b
from .dbrx_132b import CONFIG as dbrx_132b
from .xlstm_1_3b import CONFIG as xlstm_1_3b
from .whisper_base import CONFIG as whisper_base
from .internvl2_76b import CONFIG as internvl2_76b
from .gemma_2b import CONFIG as gemma_2b
from .qwen2_5_14b import CONFIG as qwen2_5_14b
from .minitron_8b import CONFIG as minitron_8b
from .yi_34b import CONFIG as yi_34b
from .zamba2_7b import CONFIG as zamba2_7b

CONFIGS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        olmoe_1b_7b,
        dbrx_132b,
        xlstm_1_3b,
        whisper_base,
        internvl2_76b,
        gemma_2b,
        qwen2_5_14b,
        minitron_8b,
        yi_34b,
        zamba2_7b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]


def list_configs() -> list[str]:
    return sorted(CONFIGS)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[ModelConfig, ShapeConfig]]:
    """Every (arch, shape) dry-run cell, including skip-eligible ones."""
    return [(c, s) for c in CONFIGS.values() for s in SHAPES.values()]


def runnable_cells() -> list[tuple[ModelConfig, ShapeConfig]]:
    return [(c, s) for c, s in all_cells() if c.supports_shape(s)]


__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "CONFIGS",
    "get_config",
    "get_shape",
    "list_configs",
    "all_cells",
    "runnable_cells",
]
