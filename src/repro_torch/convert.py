"""Copy a parameter tree of the JAX package into the port.

``params_from_jax`` takes the output of ``repro.models.lm.init_params`` after
``jax.tree_util.tree_map(np.asarray, ...)`` — nested dicts and lists of numpy
arrays, with the same keys and layouts the port uses — and returns the same
tree as torch tensors. It needs numpy arrays only; this module imports no JAX.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def _convert(node: Any, device, dtype: torch.dtype) -> Any:
    if isinstance(node, dict):
        return {k: _convert(v, device, dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, dtype) for v in node]
    # via f32: numpy has no native bfloat16, and every bf16 value is exact in f32
    arr = np.asarray(node, dtype=np.float32)
    return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)


def params_from_jax(tree: Any, cfg: ModelConfig, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """The port's params from a numpy copy of a JAX param tree. ``dtype``
    defaults to the config's ``param_dtype``."""
    dtype = dtype if dtype is not None else getattr(torch, cfg.param_dtype)
    if set(tree) != {"embed", "backbone", "final_norm"}:
        raise ValueError(f"not an lm param tree: top-level keys {sorted(tree)}")
    return _convert(tree, torch.device(device), dtype)
