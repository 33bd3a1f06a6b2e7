"""Architecture config registry: one module per assigned architecture."""
from __future__ import annotations

from .base import ModelConfig, ShapeConfig, SHAPES, supports_shape

from .qwen2_1_5b import CONFIG as qwen2_1_5b
from .qwen2_5_14b import CONFIG as qwen2_5_14b
from .qwen1_5_32b import CONFIG as qwen1_5_32b
from .mistral_nemo_12b import CONFIG as mistral_nemo_12b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .dbrx_132b import CONFIG as dbrx_132b
from .musicgen_large import CONFIG as musicgen_large
from .zamba2_2_7b import CONFIG as zamba2_2_7b
from .mamba2_780m import CONFIG as mamba2_780m
from .phi_3_vision_4_2b import CONFIG as phi_3_vision_4_2b

ARCHS = {
    c.name: c
    for c in [
        qwen2_1_5b,
        qwen2_5_14b,
        qwen1_5_32b,
        mistral_nemo_12b,
        llama4_scout_17b_a16e,
        dbrx_132b,
        musicgen_large,
        zamba2_2_7b,
        mamba2_780m,
        phi_3_vision_4_2b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name.endswith("-smoke") and name[: -len("-smoke")] in ARCHS:
        return ARCHS[name[: -len("-smoke")]].reduced()
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def all_cells():
    """Every (arch, shape) dry-run cell, with skips resolved."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            yield arch, shape, supports_shape(arch, shape)
