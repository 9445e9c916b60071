"""Architecture registry: --arch <id> → ModelConfig, for the ten archs of the
JAX package's registry, and the shape cells of the dry run
(``src/repro/models/registry.py``)."""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from .config import ModelConfig

# arch id → config module name under repro_torch.configs, in the JAX
# package's order, which all_cells follows
ARCHS: Dict[str, str] = {
    "qwen3-1.7b": "qwen3_1p7b",
    "granite-8b": "granite_8b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "llama3.2-3b": "llama3p2_3b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-26b": "internvl2_26b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-1.3b": "mamba2_1p3b",
}

SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": {"seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32},
    "decode_32k": {"seq_len": 32768, "global_batch": 128},
    "long_500k": {"seq_len": 524288, "global_batch": 1},
}

STEP_KIND = {
    "train_4k": "train",
    "prefill_32k": "prefill",
    "decode_32k": "decode",
    "long_500k": "decode",
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


def cell_status(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch × shape) cell."""
    kind = STEP_KIND[shape]
    if kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.is_subquadratic:
        return False, "pure full-attention arch; 500k context needs sub-quadratic attention"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
