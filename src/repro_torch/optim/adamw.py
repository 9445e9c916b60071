"""AdamW with an f32 master copy, global-norm clipping, the warmup-then-cosine
schedule and int8 gradient compression (port of ``src/repro/optim/adamw.py``).

Functional over parameter trees as in the reference: states mirror the param
tree (``repro_torch.tree``), with the same leaf keys, so checkpoints of the
two packages name every leaf alike. One difference: ``apply_updates`` writes
the new params, master copy and moments into the given tensors, in place,
where the JAX train step donates them; at qwen3-1.7b's width that saves the
24 GB a second copy of the optimizer state would take.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import leaf_paths, tree_map

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_fp32: bool = True


class OptState(NamedTuple):
    step: torch.Tensor     # () int32
    master: Params         # f32 master copy (or () when disabled)
    m: Params
    v: Params


def schedule(cfg: AdamWConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr, an f32 scalar."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init(cfg: AdamWConfig, params: Params) -> OptState:
    device = next(iter(leaf_paths(params).values())).device
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    # clone: the master copy must never alias an f32 param (both are updated)
    master = (tree_map(lambda p: p.detach().to(torch.float32).clone(), params)
              if cfg.master_fp32 else ())
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), master=master,
                    m=zeros, v=tree_map(torch.clone, zeros))


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in leaf_paths(tree).values()])))


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    gnorm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)
    # keep the gradient dtype, as the reference does
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


# -- optional gradient compression (cross-pod reduction trick) -----------------

def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q, scale). torch.round rounds
    half to even, as jnp.round does."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Params, grads: Params, state: OptState
                  ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step. Writes the new params, master copy and moments into
    ``params`` and ``state``'s tensors (in place) and returns them with the new
    step count and {grad_norm, lr}. The arithmetic is the reference's, leaf by
    leaf: clip in the gradient's dtype, moments and the update in f32."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - b1 ** sf
    bc2 = 1 - b2 ** sf

    p_leaves = leaf_paths(params)
    g_leaves, m_leaves, v_leaves = (leaf_paths(t) for t in (grads, state.m, state.v))
    master_leaves = leaf_paths(state.master) if cfg.master_fp32 else {}
    for key, p in p_leaves.items():
        g = g_leaves[key]
        g = (g * scale.to(g.dtype)).to(torch.float32)
        m, v = m_leaves[key], v_leaves[key]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        base = master_leaves[key] if cfg.master_fp32 else p.to(torch.float32)
        new = base - lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                           + cfg.weight_decay * base)
        if cfg.master_fp32:
            base.copy_(new)
        p.copy_(new)  # rounds to the param dtype
    new_state = OptState(step=step, master=state.master, m=state.m, v=state.v)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
