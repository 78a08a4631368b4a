"""Config registry: ``--arch <id>`` resolution.

The ten architecture configs are plain data, copied from the JAX package
so that the port imports nothing of it.  ``paper_index`` (the paper's own
index workloads) sits beside them and is imported on its own.
"""

from .base import SHAPES, ArchConfig, ShapeConfig, shape_applies
from .granite_34b import CONFIG as granite_34b
from .internlm2_20b import CONFIG as internlm2_20b
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from .llama3_8b import CONFIG as llama3_8b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout
from .llama_3_2_vision_90b import CONFIG as llama_3_2_vision_90b
from .minitron_4b import CONFIG as minitron_4b
from .musicgen_large import CONFIG as musicgen_large
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe
from .xlstm_1_3b import CONFIG as xlstm_1_3b

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        qwen3_moe,
        llama4_scout,
        jamba_v0_1_52b,
        musicgen_large,
        xlstm_1_3b,
        llama_3_2_vision_90b,
        granite_34b,
        minitron_4b,
        llama3_8b,
        internlm2_20b,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = [
    "ARCHS",
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "get_arch",
    "get_shape",
    "shape_applies",
]
