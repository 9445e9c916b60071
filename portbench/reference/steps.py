"""What the plain reference computes for a cell, over any family module of
this folder (``mamba2``, ``encoder``; the configuration's file names it):
the training steps with AdamW, and the logits of served positions.

Training: the mean cross-entropy of the batch, its gradients by autograd
(each layer kept as its input and run again in the backward, so 48 layers
fit), clipping by the global norm, and AdamW with bias correction, decoupled
weight decay on every leaf and the linear warm-up of the learning rate, all
in float32. The weights the forward reads are held as the configuration
stores them: an f32 master copy takes each update, and the working weights
are the master rounded to the parameter dtype (bfloat16), as AdamW with
``master_fp32`` keeps them; a bfloat16 weight cannot take most of a 3e-6
update, so the stored precision decides what the later steps see. A leaf
the loss does not reach gets a zero gradient (AdamW still decays it).
"""
from __future__ import annotations

import importlib
import math
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from .common import Precision, checkpointed, f32, leaves, xent_sum

XENT_ROWS = 2048  # sequence positions a block of the cross-entropy takes


def family(name: str):
    """The reference module a configuration names (``portbench/reference/<name>.py``)."""
    return importlib.import_module(f"{__package__}.{name}")


def hidden(fam, model: dict, params: dict, batch: Dict[str, torch.Tensor],
           prec: Precision) -> torch.Tensor:
    x = fam.embed(model, params, batch, prec)
    for i in range(model["n_layers"]):
        x = checkpointed(fam.block, model, params, i, x, prec)
    return fam.final_norm(model, params, x)


def train_loss(fam, model: dict, params: dict, batch: Dict[str, torch.Tensor],
               prec: Precision) -> torch.Tensor:
    h = hidden(fam, model, params, batch, prec)
    w, labels = fam.unembed(model, params), batch["labels"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], XENT_ROWS):
        total = total + checkpointed(xent_sum, h[:, c0:c0 + XENT_ROWS], w,
                                     labels[:, c0:c0 + XENT_ROWS], prec)
    return total / (labels != -100).sum().clamp_min(1)


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of the rate."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(1.0, opt["warmup_steps"])
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(1.0, opt["decay_steps"] - opt["warmup_steps"])))
    return opt["lr"] * (opt["min_lr_frac"]
                        + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog)))


def train(fam, model: dict, init: dict, batches: List[Dict[str, np.ndarray]], opt: dict,
          prec: Precision, device, against: Optional[Dict[str, dict]] = None,
          keep_first: bool = False) -> dict:
    """Train from the weights ``init`` over ``batches``, in float32 with the
    weights stored between steps in ``init``'s dtype (the master copy's
    change read where ``opt["master_fp32"]``). Returns the loss of each
    step, each leaf's norm of the first step's clipped gradient and of its
    change over all the steps;
    for each named set of first gradients in ``against`` (per leaf, on the
    host) each leaf's norm of its difference from this run's
    (``first_grad_diff``); with ``keep_first`` this run's first gradients,
    bf16 on the host (``first_grad_host``)."""
    start = dict(leaves(init))
    params = _unflatten(init, {k: f32(v).clone().requires_grad_(True) for k, v in start.items()})
    named = dict(leaves(params))
    # the f32 copy that takes the updates: the master, or the working weights
    master = ({k: p.detach().clone() for k, p in named.items()} if opt["master_fp32"]
              else {k: p.detach() for k, p in named.items()})
    m = {k: torch.zeros_like(p) for k, p in named.items()}
    v = {k: torch.zeros_like(p) for k, p in named.items()}
    losses, first_grad, kept = [], {}, {}
    diff = {name: {} for name in (against or {})}
    for t, host in enumerate(batches, start=1):
        batch = {k: torch.from_numpy(a).to(device) for k, a in host.items()}
        loss = train_loss(fam, model, params, batch, prec)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp_max(opt["grad_clip"] / (gnorm + 1e-9), 1.0)
        losses.append(float(loss.detach()))
        lr, b1, b2 = lr_at(opt, t), opt["beta1"], opt["beta2"]
        with torch.no_grad():
            for k, p in named.items():
                g = grads[k] * scale
                if t == 1:
                    first_grad[k] = float(torch.linalg.vector_norm(g))
                    for name, grads_of in (against or {}).items():
                        other = grads_of[k].to(device, torch.float32)
                        diff[name][k] = float(torch.linalg.vector_norm(other - g))
                    if keep_first:
                        kept[k] = g.to("cpu", torch.bfloat16)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[k] / (1 - b1 ** t)) / (torch.sqrt(v[k] / (1 - b2 ** t)) + opt["eps"])
                base = master[k]
                base.sub_(lr * (upd + opt["weight_decay"] * base))
                p.copy_(base.to(start[k].dtype))      # the stored weight, read in f32
        del grads, loss
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(master[k] - f32(start[k])))
                  for k in named}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "first_grad_diff": diff, "first_grad_host": kept}


def _unflatten(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], flat, f"{prefix}/{k}" if prefix else str(k))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(c, flat, f"{prefix}/{i}" if prefix else str(i))
                for i, c in enumerate(tree)]
    return flat[prefix]


@torch.no_grad()
def logits_at(fam, model: dict, params: dict, tokens: torch.Tensor, at: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """Logits (b, k, V) at the positions ``at`` (b, k) of one forward pass
    over ``tokens`` (b, T)."""
    h = hidden(fam, model, params, {"tokens": tokens}, prec)
    h = h.gather(1, at[..., None].expand(*at.shape, h.shape[-1]))
    return prec.mm(h, f32(fam.unembed(model, params)).t())


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the best (b, k)."""
    best = ref_logits.amax(-1)
    return best - ref_logits.gather(-1, served[..., None].long())[..., 0]


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], skip=()) -> Dict[str, float]:
    """Each leaf's gap between two per-leaf norms: |got - want| over the
    larger of the reference's norm of that leaf and of the median leaf."""
    floor = statistics.median(want.values())
    return {k: abs(got[k] - w) / max(w, floor) for k, w in want.items() if k not in skip}


def leaf_gap(got: Dict[str, float], want: Dict[str, float], skip=()) -> tuple:
    """(the worst leaf's gap, that leaf)."""
    gaps = leaf_gaps(got, want, skip)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst
