"""Architecture registry: --arch <id> → ModelConfig, for the ten archs of the
JAX package's registry."""
from __future__ import annotations

import importlib
from typing import Dict

from .config import ModelConfig

# arch id → config module name under repro_torch.configs
ARCHS: Dict[str, str] = {
    "qwen3-1.7b": "qwen3_1p7b",
    "mamba2-1.3b": "mamba2_1p3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-8b": "granite_8b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "llama3.2-3b": "llama3p2_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-26b": "internvl2_26b",
}


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)} "
                       "(the JAX package's registry, ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG
