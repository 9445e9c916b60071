"""Token-choice top-k Mixture-of-Experts, the single-device (local) path.

Covers mixtral-8x7b (8 experts, top-2, every layer) and llama4-maverick
(128 experts, top-1, every other layer, plus a shared expert), with the
semantics of the JAX package's path without a mesh
(``src/repro/models/moe.py``: ``_moe_compute_local`` and the shared expert of
``apply_moe``):

* routing: f32 logits ``x·router``, the top k, a softmax over the k values;
  equal logits go to the lower expert index, as in ``jax.lax.top_k``;
* aux loss: the Switch load-balancing term times ``router_aux_coef`` plus a
  1e-4 router z-loss, returned (serving ignores it);
* capacity: ``max(4, ceil(T·k·capacity_factor/E))`` over the call's T tokens
  (B·S at prefill, B at decode);
* drops: buffer slots go token-major, then in k order, by each expert's
  running count; assignments past capacity are dropped and weigh 0;
* expert FFN: products in the compute dtype, silu in f32, the k outputs
  combined in f32 and cast back;
* training: the router's gradient reaches the logits through the combine
  weights (``torch.sort``'s backward, as ``jax.lax.top_k``'s) and the aux
  term's mean probabilities (the expert counts carry none); a dropped
  assignment gives no gradient to any expert or token. Dispatch and combine
  are gathers whose backward is the inverse gather (``_MoveRows``), so a
  train step on the card adds no float atomically and repeats bit for bit.

Expert weights are stored whole, ``(E, D, F)`` and ``(E, F, D)``. The JAX
package keeps them blocked for its expert × FFN sharding, ``(tp_hint, E/ep, D,
F/fp)``, and reassembles the experts on every call; the port re-blocks once,
in ``repro_torch.convert``. There is no sharding here (ROADMAP.md, Queue 1,
"Sharding"). The expert products are ``torch.bmm``: the JAX package computes
MoE in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, _normal, apply_mlp, cdt, dt, init_mlp


def ep_fp(cfg: ModelConfig, tp: int) -> Tuple[int, int]:
    """The JAX package's factoring of a model axis of ``tp`` shards into
    ``ep`` expert shards times ``fp`` FFN shards (the port's copy of
    ``_ep_fp``; only the converter uses it, to undo the blocking)."""
    ep = math.gcd(cfg.n_experts, tp)
    return ep, tp // ep


def _normal_experts(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """One expert at a time, so that the f32 draw is one expert's size
    (llama4-maverick's 128 experts of one layer are 21 GB a matrix in f32)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = _normal(gen, shape[1:], scale, dtype, device)
    return out


def init_moe_layer(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "router": _normal(gen, (D, E), 0.02, torch.float32, device),
        "w_gate": _normal_experts(gen, (E, D, Fd), 0.02, dt(cfg), device),
        "w_up": _normal_experts(gen, (E, D, Fd), 0.02, dt(cfg), device),
        "w_down": _normal_experts(gen, (E, Fd, D), out_scale, dt(cfg), device),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = init_mlp(cfg, gen, device, d_ff=cfg.n_shared_experts * cfg.d_ff)
    return p


def route(cfg: ModelConfig, router: torch.Tensor, x2d: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d (T,D) → (expert index (T,k) int64, combine weights (T,k) f32, aux
    loss f32 scalar)."""
    logits = x2d.float() @ router.float()                        # (T, E)
    k = cfg.experts_per_token
    # a stable descending sort keeps equal logits in index order, as top_k does
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    weights = torch.softmax(vals, dim=-1)
    # Switch-style load balancing + router z-loss
    me = torch.softmax(logits, dim=-1).mean(dim=0)                # (E,)
    ce = (torch.bincount(idx.reshape(-1), minlength=cfg.n_experts).float()
          / (x2d.shape[0] * k))
    aux = cfg.n_experts * torch.sum(me * ce) * cfg.router_aux_coef
    zloss = 1e-4 * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return idx, weights, aux + zloss


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.experts_per_token * cfg.capacity_factor
                      / cfg.n_experts))
    return max(4, c)


def dispatch_indices(idx: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """idx (T,k) expert ids → the flat buffer position ``expert·cap + slot``
    of each assignment (T·k,), token-major then in k order, or -1 where its
    expert's ``cap`` slots are taken."""
    flat = idx.reshape(-1)
    # each expert's running count (1-based) as a scan along its own row of an
    # expert-major one-hot (E, T·k): PyTorch runs the token-major (T·k, E)
    # scan as E threads each stepping through T·k rows, which took 112 of a
    # mixtral-8x7b prefill's 748 device ms on an H100 (chip_smoke.py trace)
    experts = torch.arange(n_experts, device=flat.device)[:, None]
    count = torch.cumsum(flat[None, :] == experts, dim=1).gather(0, flat[None, :])[0]
    return torch.where(count <= cap, flat * cap + count - 1, -1)


def expert_ffn(cfg: ModelConfig, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
               buf: torch.Tensor) -> torch.Tensor:
    """buf (E,C,D) → (E,C,D) through each expert's SwiGLU FFN."""
    c = cdt(cfg)
    g = torch.bmm(buf, wg.to(c))
    u = torch.bmm(buf, wu.to(c))
    h = F.silu(g.float()).to(c) * u
    return torch.bmm(h, wd.to(c))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0, where idx == len(x) reads a zero row."""
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])[idx]


class _MoveRows(torch.autograd.Function):
    """``_take_rows(x, idx)`` where each row of x lands in at most one output
    row, and ``inv`` maps each row of x to that output row (or past the
    output's end). Autograd's backward of an index adds the gradient rows
    into a zero tensor (a scatter-add); here it is the gather ``grad[inv]``:
    each row receives at most one term, so the numbers are the same, and
    there is no addition whose order could vary between runs."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return _take_rows(x, idx)

    @staticmethod
    def backward(ctx, grad):
        inv, = ctx.saved_tensors
        return _take_rows(grad, inv), None, None


def moe_local(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All experts on this device. x (B,S,D) → (y (B,S,D), aux loss)."""
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    idx, weights, aux = route(cfg, p["router"], x2d)
    E, k, c = cfg.n_experts, cfg.experts_per_token, cdt(cfg)
    cap = capacity(cfg, T)
    buf_pos = dispatch_indices(idx, E, cap)
    # assignment → buffer row, a dropped one to the zero row past the buffer;
    # buffer row → assignment, an empty row to the zero row past the T·k
    # assignments (the dropped ones all write the scratch row E·cap, cut off)
    pos = torch.where(buf_pos >= 0, buf_pos, E * cap)
    src = torch.full((E * cap + 1,), T * k, dtype=pos.dtype, device=pos.device)
    src[pos] = torch.arange(T * k, dtype=pos.dtype, device=pos.device)
    src = src[:-1]
    buf = _MoveRows.apply(x2d.to(c).repeat_interleave(k, dim=0), src, pos)
    out = expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"],
                     buf.view(E, cap, D)).reshape(-1, D)
    w = torch.where(buf_pos[:, None] >= 0, weights.reshape(-1, 1), 0.0)
    y = (_MoveRows.apply(out, pos, src).float() * w).view(T, k, D).sum(dim=1)
    return y.view(B, S, D).to(x.dtype), aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN, with the shared expert where the config has one.
    Returns (y, aux loss)."""
    y, aux = moe_local(cfg, p, x)
    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x)
    return y, aux
