"""Architecture registry of the port.  ``get_config(name)`` resolves an
``--arch`` id among the architectures the port can serve so far; any other
arch the JAX package knows raises "not yet ported"."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ArchConfig,
    BlockKind,
    BlockSpec,
    ParallelPlan,
    cut_to_kinds,
    make_reduced,
    single_stage,
    stage_config,
)

# Archs whose block kinds the port runs (ATTN_MLP dense, ATTN_MOE at NS=1,
# RWKV, MAMBA_MLP and MAMBA_MOE).
_MODULES: Dict[str, str] = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2.5-14b": "qwen2_5_14b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "rwkv6-3b": "rwkv6_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

# Archs of the JAX package's registry that later slices of the port add.
_NOT_YET_PORTED = (
    "qwen2-vl-7b", "kimi-k2-1t-a32b", "minicpm3-4b",
    "internlm2-1.8b", "whisper-small", "qwen2.5-32b", "llama3.1-100b",
)


def get_config(name: str) -> ArchConfig:
    if name in _NOT_YET_PORTED:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch; "
                       f"ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_MODULES)


__all__ = [
    "ArchConfig",
    "BlockKind",
    "BlockSpec",
    "ParallelPlan",
    "cut_to_kinds",
    "get_config",
    "list_archs",
    "make_reduced",
    "single_stage",
    "stage_config",
]
