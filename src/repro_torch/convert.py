"""Copy a parameter tree, or an optimizer state, of the JAX package into the
port.

``params_from_jax`` takes the output of ``repro.models.lm.init_params`` after
``jax.tree_util.tree_map(np.asarray, ...)`` — nested dicts and lists of numpy
arrays, with the same keys and layouts the port uses — and returns the same
tree as torch tensors; ``opt_state_from_jax`` does the same for the
``repro.optim.adamw.OptState`` of those params. It needs numpy arrays only;
this module imports no JAX.

Every leaf keeps its source dtype: a bf16 model keeps some leaves in f32
(mamba2's ``a_log``, ``dt_bias`` and ``d_skip``, the RG-LRU's ``lam``, an MoE
router), and casting those to bf16 would change the decay rates.

The one change of layout: the JAX package stores an MoE layer's expert
weights blocked for its sharding, ``(tp, E/ep, D, F/fp)`` and ``(tp, E/ep,
F/fp, D)`` with ``(ep, fp) = _ep_fp(cfg, tp)``, and the port stores whole
experts, ``(E, D, F)`` and ``(E, F, D)`` (``repro_torch.models.moe``);
``params_from_jax`` re-blocks them once, here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import ep_fp
from repro_torch.optim.adamw import OptState


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


def unblock_experts(moe: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """An MoE layer's params, stacked over units (leading axis n), with the
    expert leaves re-blocked from JAX's ``(n, tp, E/ep, D, F/fp)`` and ``(n,
    tp, E/ep, F/fp, D)`` to ``(n, E, D, F)`` and ``(n, E, F, D)``, as
    ``_moe_compute_local`` reassembles them: block ``b·fp + f`` holds F slice
    ``f`` of experts ``b·E/ep`` up to ``(b+1)·E/ep``. Other leaves pass as
    they are."""
    n, tp = np.shape(moe["w_gate"])[:2]
    ep, fp = ep_fp(cfg, tp)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    e_loc, f_loc = E // ep, F // fp
    out = dict(moe)
    for name in ("w_gate", "w_up"):
        w = np.asarray(moe[name]).reshape(n, ep, fp, e_loc, D, f_loc)
        out[name] = w.transpose(0, 1, 3, 4, 2, 5).reshape(n, E, D, F)
    w = np.asarray(moe["w_down"]).reshape(n, ep, fp, e_loc, f_loc, D)
    out["w_down"] = w.transpose(0, 1, 3, 2, 4, 5).reshape(n, E, F, D)
    return out


def params_from_jax(tree: Any, cfg: ModelConfig, device="cpu") -> Any:
    """The port's params from a numpy copy of a JAX param tree. Leaves must be
    f32 or the config's ``param_dtype``, and keep their dtype; MoE expert
    leaves are re-blocked (``unblock_experts``)."""
    if set(tree) != {"embed", "backbone", "final_norm"}:
        raise ValueError(f"not an lm param tree: top-level keys {sorted(tree)}")
    if cfg.n_experts > 0:
        units = [{**u, "moe": unblock_experts(u["moe"], cfg)} if "moe" in u else u
                 for u in tree["backbone"]["units"]]
        tree = {**tree, "backbone": {**tree["backbone"], "units": units}}
    allowed = {torch.float32, getattr(torch, cfg.param_dtype)}
    return _convert(tree, torch.device(device), allowed)


def opt_state_from_jax(state: Any, device="cpu") -> OptState:
    """The port's ``OptState`` from a numpy copy of a JAX ``OptState`` (any
    object with ``step``, ``master``, ``m`` and ``v``): an int32 step and f32
    trees (``master`` is ``()`` when the f32 master copy is off)."""
    device = torch.device(device)
    f32 = {torch.float32}
    master = state.master
    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
        master=() if isinstance(master, tuple) and not master else _convert(master, device, f32),
        m=_convert(state.m, device, f32), v=_convert(state.v, device, f32))
