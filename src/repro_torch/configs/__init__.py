"""Architecture registry of the port.  ``get_config(name)`` resolves an
``--arch`` id of the JAX package's registry; any other name raises."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ASSIGNED_SHAPES,
    ArchConfig,
    BlockKind,
    BlockSpec,
    ParallelPlan,
    ShapeSpec,
    applicable_shapes,
    cut_to_depth,
    cut_to_kinds,
    make_reduced,
    single_stage,
    stage_config,
)

# Every arch of the JAX package's registry (repro.configs), in its order.
_MODULES: Dict[str, str] = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "internlm2-1.8b": "internlm2_1_8b",
    "whisper-small": "whisper_small",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2.5-32b": "qwen2_5_32b",
    "llama3.1-100b": "llama3_1_100b",
}

# The archs of the assigned cells: the registry's first ten, as the JAX
# package's ``ASSIGNED_ARCHS``.
ASSIGNED_ARCHS: List[str] = list(_MODULES)[:10]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_MODULES)


__all__ = [
    "ASSIGNED_ARCHS",
    "ASSIGNED_SHAPES",
    "ArchConfig",
    "BlockKind",
    "BlockSpec",
    "ParallelPlan",
    "ShapeSpec",
    "applicable_shapes",
    "cut_to_depth",
    "cut_to_kinds",
    "get_config",
    "list_archs",
    "make_reduced",
    "single_stage",
    "stage_config",
]
