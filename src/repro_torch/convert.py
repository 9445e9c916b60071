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
``params_from_jax`` and ``opt_state_from_jax`` re-block them once, here
(``unblock_experts``), and ``block_experts`` is its exact inverse, for a
port tree written in the JAX package's layout. On a mesh the port holds the
experts blocked for the mesh's model size (``parallel.specs``):
``experts_blocked`` and ``experts_whole`` turn any tree (params, an
optimizer state, a checkpoint's) between the two layouts, the expert count
read from each layer's router.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
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


def _regroup(w: Any, shape, axes, out_shape) -> Any:
    """``w`` reshaped to ``shape``, its axes permuted, reshaped to
    ``out_shape``: a numpy array stays numpy, a tensor a tensor."""
    if isinstance(w, torch.Tensor):
        return w.reshape(shape).permute(axes).reshape(out_shape)
    return np.asarray(w).reshape(shape).transpose(axes).reshape(out_shape)


def _ep_fp(n_experts: int, tp: int):
    ep = math.gcd(n_experts, tp)  # models.moe.ep_fp's factoring
    return ep, tp // ep


def _unblock(moe: Dict[str, Any], n_experts: int) -> Dict[str, Any]:
    n, tp, e_loc, D, f_loc = moe["w_gate"].shape
    ep, fp = _ep_fp(n_experts, tp)
    E, F = n_experts, f_loc * fp
    out = dict(moe)
    for name in ("w_gate", "w_up"):
        out[name] = _regroup(moe[name], (n, ep, fp, e_loc, D, f_loc), (0, 1, 3, 4, 2, 5),
                             (n, E, D, F))
    out["w_down"] = _regroup(moe["w_down"], (n, ep, fp, e_loc, f_loc, D), (0, 1, 3, 2, 4, 5),
                             (n, E, F, D))
    return out


def _block(moe: Dict[str, Any], tp: int) -> Dict[str, Any]:
    n, E, D, F = moe["w_gate"].shape
    ep, fp = _ep_fp(E, tp)
    e_loc, f_loc = E // ep, F // fp
    out = dict(moe)
    for name in ("w_gate", "w_up"):
        out[name] = _regroup(moe[name], (n, ep, e_loc, D, fp, f_loc), (0, 1, 4, 2, 3, 5),
                             (n, tp, e_loc, D, f_loc))
    out["w_down"] = _regroup(moe["w_down"], (n, ep, e_loc, fp, f_loc, D), (0, 1, 3, 2, 4, 5),
                             (n, tp, e_loc, f_loc, D))
    return out


def unblock_experts(moe: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """An MoE layer's params, stacked over units (leading axis n), with the
    expert leaves re-blocked from JAX's ``(n, tp, E/ep, D, F/fp)`` and ``(n,
    tp, E/ep, F/fp, D)`` to ``(n, E, D, F)`` and ``(n, E, F, D)``, as
    ``_moe_compute_local`` reassembles them: block ``b·fp + f`` holds F slice
    ``f`` of experts ``b·E/ep`` up to ``(b+1)·E/ep``. Other leaves pass as
    they are. Numpy leaves give numpy leaves, tensors tensors."""
    return _unblock(moe, cfg.n_experts)


def block_experts(moe: Dict[str, Any], cfg: ModelConfig, tp: int) -> Dict[str, Any]:
    """The exact inverse of ``unblock_experts``: an MoE layer's params (or
    an optimizer moment of them) stacked over units, from the port's ``(n,
    E, D, F)`` and ``(n, E, F, D)`` to the JAX package's layout blocked for a
    model axis of ``tp`` shards (its ``init_moe_layer`` takes ``tp_hint=16``).
    A permutation of the values: bit for bit."""
    if moe["w_gate"].shape[1] != cfg.n_experts:
        raise ValueError(f"{moe['w_gate'].shape[1]} experts in the leaves, "
                         f"{cfg.n_experts} in the config")
    return _block(moe, tp)


def map_experts(tree: Any, fn) -> Any:
    """A tree (params, gradients, a moment, the master copy, or any nesting
    of them in dicts, lists and NamedTuples) with ``fn`` applied to every MoE
    layer's dict (the one holding ``router`` and ``w_gate``); the rest as it
    is."""
    if isinstance(tree, dict):
        if "router" in tree and "w_gate" in tree:
            return fn(tree)
        return {k: map_experts(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_experts(getattr(tree, f), fn) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_experts(v, fn) for v in tree)
    return tree


def experts_whole(tree: Any) -> Any:
    """``tree`` with every blocked MoE layer (rank-5 experts) in the port's
    whole layout; the expert count is the router's."""
    return map_experts(tree, lambda m: _unblock(m, m["router"].shape[-1])
                       if m["w_gate"].dim() == 5 else m)


def experts_blocked(tree: Any, tp: int) -> Any:
    """``tree`` with every whole MoE layer (rank-4 experts) blocked for a
    model axis of ``tp`` shards, the layout on a mesh of that model size."""
    return map_experts(tree, lambda m: _block(m, tp) if m["w_gate"].dim() == 4 else m)


def _has_experts(tree: Any) -> bool:
    return any("moe" in u for u in tree.get("backbone", {}).get("units", ()))


def params_from_jax(tree: Any, cfg: ModelConfig, device="cpu") -> Any:
    """The port's params from a numpy copy of a JAX param tree. Leaves must be
    f32 or the config's ``param_dtype``, and keep their dtype; MoE expert
    leaves are re-blocked (``unblock_experts``)."""
    if set(tree) != {"embed", "backbone", "final_norm"}:
        raise ValueError(f"not an lm param tree: top-level keys {sorted(tree)}")
    if _has_experts(tree):
        tree = map_experts(tree, lambda moe: unblock_experts(moe, cfg))
    allowed = {torch.float32, getattr(torch, cfg.param_dtype)}
    return _convert(tree, torch.device(device), allowed)


def opt_state_from_jax(state: Any, cfg: Optional[ModelConfig] = None,
                       device="cpu") -> OptState:
    """The port's ``OptState`` from a numpy copy of a JAX ``OptState`` (any
    object with ``step``, ``master``, ``m`` and ``v``): an int32 step and f32
    trees (``master`` is ``()`` when the f32 master copy is off). The trees
    mirror the params, so a model with experts needs its ``cfg``: their
    expert leaves are re-blocked as ``params_from_jax`` re-blocks the
    params'."""
    device = torch.device(device)
    f32 = {torch.float32}

    def tree(t):
        if _has_experts(t):
            if cfg is None:
                raise ValueError("an optimizer state with MoE leaves needs the model's "
                                 "config to re-block its experts")
            t = map_experts(t, lambda moe: unblock_experts(moe, cfg))
        return _convert(t, device, f32)
    master = state.master
    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
        master=() if isinstance(master, tuple) and not master else tree(master),
        m=tree(state.m), v=tree(state.v))
