"""Copy a parameter tree of the JAX package into the port.

``params_from_jax`` takes the output of ``repro.models.lm.init_params`` after
``jax.tree_util.tree_map(np.asarray, ...)`` — nested dicts and lists of numpy
arrays, with the same keys and layouts the port uses — and returns the same
tree as torch tensors. It needs numpy arrays only; this module imports no JAX.

Every leaf keeps its source dtype: a bf16 model keeps some leaves in f32
(mamba2's ``a_log``, ``dt_bias`` and ``d_skip``, the RG-LRU's ``lam``), and
casting those to bf16 would change the decay rates.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def _convert(node: Any, device, allowed) -> Any:
    if isinstance(node, dict):
        return {k: _convert(v, device, allowed) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, allowed) for v in node]
    arr = np.asarray(node)
    # numpy's bfloat16 is ml_dtypes', which torch.from_numpy does not take
    dtype = getattr(torch, arr.dtype.name, None)
    if dtype not in allowed:
        raise TypeError(f"a param leaf of dtype {arr.dtype} in a model of "
                        f"{sorted(map(str, allowed))}")
    # via f32: every bf16 value is exact in f32
    return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)


def params_from_jax(tree: Any, cfg: ModelConfig, device="cpu") -> Any:
    """The port's params from a numpy copy of a JAX param tree. Leaves must be
    f32 or the config's ``param_dtype``, and keep their dtype."""
    if set(tree) != {"embed", "backbone", "final_norm"}:
        raise ValueError(f"not an lm param tree: top-level keys {sorted(tree)}")
    allowed = {torch.float32, getattr(torch, cfg.param_dtype)}
    return _convert(tree, torch.device(device), allowed)
