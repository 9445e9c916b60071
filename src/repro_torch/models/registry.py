"""Architecture registry: --arch <id> → ModelConfig, for the ported archs only."""
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
}


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: "
            f"{sorted(ARCHS)}); see ROADMAP.md for the order of the port")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG
