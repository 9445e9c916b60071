"""Step functions: train, prefill and greedy decode.

PyTorch runs eagerly, so these are plain closures where the JAX package
builds functions for ``jax.jit``; ``jax.value_and_grad`` becomes
``torch.autograd.grad`` over the param leaves.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import leaf_paths, unflatten_like


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads) of ``lm.train_loss``; grads mirror ``params``.
    The param leaves require grad only for the duration of the call. A leaf
    the loss does not reach (hubert-xlarge's ``embed.tok``: its frames are
    not tokens) gets a zero gradient of its shape and dtype, as
    ``jax.value_and_grad`` gives it, so AdamW still decays it.

    On a mesh (DTensor params) each gradient is laid out as its param: a
    replicated param's gradient comes back partial over the batch axes
    (``parallel.axes.gather_weight``) and is summed here."""
    named = leaf_paths(params)
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss, metrics = lm.train_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _laid_out_as(g, p)
                 for p, g in zip(named.values(), grads)]
    finally:
        for p in named.values():
            p.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten_like(params, dict(zip(named, grads)))


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig) -> Callable:
    """train_step(params, opt_state, batch) → (params, opt_state, metrics).
    The update is written into the given params and state (see
    ``adamw.apply_updates``)."""
    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(cfg, params, batch)
        params, opt_state, opt_metrics = adamw.apply_updates(opt_cfg, params, grads,
                                                             opt_state)
        return params, opt_state, {**metrics, **opt_metrics}
    return train_step


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch):
        return lm.train_loss(cfg, params, batch)
    return loss_fn


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, max_len: Optional[int] = None) -> Callable:
    """One decode step of caches of ``max_len`` tokens (``lm.decode_step``:
    needed where the rules split the caches' slots over ``model``; whole
    caches need none, and then none is passed)."""
    extra = {} if max_len is None else {"max_len": max_len}

    def decode_step(params, cache, token, pos):
        logits, cache = lm.decode_step(cfg, params, cache, token, pos, **extra)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache
    return decode_step
