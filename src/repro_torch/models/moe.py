"""Token-choice top-k Mixture-of-Experts: the single-device (local) path and
the expert-parallel path on a mesh.

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

Off a mesh expert weights are stored whole, ``(E, D, F)`` and ``(E, F, D)``.
The JAX package keeps them blocked for its expert × FFN sharding, ``(tp_hint,
E/ep, D, F/fp)``, and reassembles the experts on every call; the port
re-blocks once, in ``repro_torch.convert``. The expert products are
``torch.bmm``: the JAX package computes MoE in XLA, outside any Pallas kernel.

On a mesh with ``data`` and ``model`` axes the expert leaves are held blocked
for the mesh's model size (``parallel.specs.expert_blocks``) and
``apply_moe`` takes the sharded path, a port of the JAX package's
``shard_map`` body (``_moe_shard_body``): the model axis of TP shards is
factored into ``ep`` expert shards × ``fp`` FFN shards, each model rank runs
its block of experts over the tokens routed to them, and a sum over ``model``
combines the blocks. It runs on the rank's local tensors with process-group
collectives whose backward follows how the ranks use the result (see
``_moe_sharded``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.parallel.axes import (SumGrad, batch_axes, current_mesh, current_rules,
                                       gather_weight)
from .config import ModelConfig
from .layers import Params, _normal, apply_mlp, cdt, dt, init_mlp


def ep_fp(cfg: ModelConfig, tp: int) -> Tuple[int, int]:
    """The JAX package's factoring of a model axis of ``tp`` shards into
    ``ep`` expert shards times ``fp`` FFN shards (the port's copy of
    ``_ep_fp``)."""
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
    # each expert's count of assignments, of a fixed length (bincount's
    # length follows the data, which a trace on fake tensors cannot know)
    flat = idx.reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=flat.dtype, device=flat.device)
    ce = counts.index_add_(0, flat, torch.ones_like(flat)).float() / (x2d.shape[0] * k)
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


def _experts(cfg: ModelConfig, src: torch.Tensor, weights: torch.Tensor,
             buf_pos: torch.Tensor, n_local: int, cap: int,
             ffn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Dispatch, expert FFN and combine. ``src`` (T·k, D) holds each token's
    row in the compute dtype, token-major then in k order; ``buf_pos`` (T·k,)
    its slot in the (n_local, cap) buffer or -1; ``ffn`` maps the buffer
    (n_local, cap, D) to the experts' outputs. Returns (T, D) f32: each
    token's outputs weighted and summed over its k assignments."""
    Tk, D = src.shape
    k = cfg.experts_per_token
    # assignment → buffer row, a dropped one to the zero row past the buffer;
    # buffer row → assignment, an empty row to the zero row past the T·k
    # assignments (the dropped ones all write the scratch row n_local·cap, cut off)
    pos = torch.where(buf_pos >= 0, buf_pos, n_local * cap)
    inv = torch.full((n_local * cap + 1,), Tk, dtype=pos.dtype, device=pos.device)
    inv[pos] = torch.arange(Tk, dtype=pos.dtype, device=pos.device)
    inv = inv[:-1]
    buf = _MoveRows.apply(src, inv, pos)
    out = ffn(buf.view(n_local, cap, D)).reshape(-1, D)
    w = torch.where(buf_pos[:, None] >= 0, weights.reshape(-1, 1), 0.0)
    return (_MoveRows.apply(out, pos, inv).float() * w).view(Tk // k, k, D).sum(dim=1)


def moe_local(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All experts on this device. x (B,S,D) → (y (B,S,D), aux loss)."""
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    idx, weights, aux = route(cfg, p["router"], x2d)
    E, k, c = cfg.n_experts, cfg.experts_per_token, cdt(cfg)
    cap = capacity(cfg, T)
    y = _experts(cfg, x2d.to(c).repeat_interleave(k, dim=0), weights,
                 dispatch_indices(idx, E, cap), E, cap,
                 lambda buf: expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"], buf))
    return y.view(B, S, D).to(x.dtype), aux


# -- the sharded path ------------------------------------------------------------------
#
# Each collective's backward follows from how the ranks use its result. A
# gradient held on a rank is either the whole gradient of a value (every rank
# that holds the value holds the same one) or a part of it (the whole is the
# sum over the ranks). Outside the MoE layer the ranks of one batch block
# (those that differ only on axes that do not split the batch) run the same
# dense layers on the same rows, so their gradients are whole and alike.


class _AllGather(torch.autograd.Function):
    """Rows of every rank of ``group`` concatenated along ``dim``, in rank
    order. The ranks use the result differently, so the backward sums their
    gradients and hands each rank its own rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        x0 = x.movedim(dim, 0).contiguous()
        out = x0.new_empty((n * x0.shape[0], *x0.shape[1:]))
        dist.all_gather_into_tensor(out, x0, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        g0 = grad.movedim(ctx.dim, 0).contiguous()
        out = g0.new_empty((g0.shape[0] // n, *g0.shape[1:]))
        dist.reduce_scatter_tensor(out, g0, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    """The sum over ``group``. With ``grad_sum`` the backward sums the
    gradients too (the ranks use the result differently); without, each
    rank's gradient passes as it is (every rank of the group uses the result
    alike, so each holds its whole gradient already)."""

    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        if ctx.grad_sum:
            grad = grad.clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


class _Mean(torch.autograd.Function):
    """The mean over every rank of ``mesh``, whose gradient passes as it is:
    each rank's value stands for the mean it enters (the aux loss, whose
    share each rank's loss takes)."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.clone()
        for dim in range(mesh.ndim):
            dist.all_reduce(out, group=mesh.get_group(dim))
        return out / mesh.size()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _local_experts(w, mesh, dim_d: int, gather: bool, rows: Sequence[str]) -> torch.Tensor:
    """This model rank's block of an expert leaf (TP, E/ep, ·, ·), the D dim
    ``dim_d`` gathered over ``data`` or kept as this rank's slice, as a
    plain (E/ep, ·, ·) tensor. Its gradient: this block's alone over
    ``model``, partial over ``data`` where gathered (replicated where the
    batch is: every data rank then computes the whole gradient) and this
    slice's alone where not, partial over any other batch axis (pod) and
    replicated over the rest."""
    def on(axis, gathered, kept):
        if axis == "model":
            return Shard(0)
        if axis == "data":
            return gathered if gather else Shard(dim_d)
        return kept
    names = mesh.mesh_dim_names
    target = [on(a, Replicate(), Replicate()) for a in names]
    grads = [on(a, Partial() if "data" in rows else Replicate(),
                Partial() if a in rows else Replicate()) for a in names]
    return w.redistribute(mesh, target).to_local(grad_placements=grads)[0]


def _moe_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor, mesh,
                 force_gather: Optional[bool]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_moe_shard_body`` and its set-up in ``apply_moe`` on this rank's rows
    x (B_loc, S, D). The tokens are routed in pools: this rank's own rows,
    gathered over ``model`` where the batch is split over it (pure FSDP) and
    over ``data`` in the weight-stationary mode. Every model rank of a pool
    routes it alike and runs its block of experts on it; capacity is over
    the rank's own t_loc tokens, times the pool's size in rows of t_loc.

    * gather mode (token-heavy): the expert leaves' D dim is gathered over
      ``data`` once per layer and the products run whole;
    * weight-stationary mode (token-light): the tokens are gathered over
      ``data``, each data rank contracts its D slice, the f32 g/u partials
      are summed over ``data``, the down projection gives this rank's D slice
      of the outputs, gathered back, and each rank keeps its own rows.

    A replicated batch (``specs.batch_rules``: no batch axes) is one pool on
    every rank and runs in the gather mode. The combine is summed over
    ``model`` in the compute dtype; the aux loss
    is averaged over every mesh axis. Where the pool is the same on every
    model rank, the pool and the combine weights enter the expert work
    through ``SumGrad`` and the combine's sum passes its gradient as it is;
    where the pool is gathered over ``model``, the gather's backward does the
    sum and the combine's sum sums its gradient. The aux loss, which varies
    over the pools, is averaged over the mesh and passes its gradient as it
    is: the loss takes 1/n of it on each of the n ranks that split the batch
    (``lm.train_loss``), which is each pool's share of the mean."""
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    rows = batch_axes()
    if rows and "data" not in rows:
        raise ValueError(f"the sharded MoE path needs the batch split over 'data' or "
                         f"replicated; the rules split it over {rows}")
    tp = sizes["model"]
    ep, fp = ep_fp(cfg, tp)
    E, k, c = cfg.n_experts, cfg.experts_per_token, cdt(cfg)
    e_loc, f_loc = E // ep, cfg.d_ff // fp
    B, S, D = x.shape
    t_loc = B * S
    cap0 = capacity(cfg, t_loc)
    # napkin math: weight-gather bytes vs weight-stationary bytes per layer.
    # Stationary mode pays: the token all-gather over data (every shard needs
    # the same tokens), the g+u partial psum (f32, ring 2x), and n_dp-fold
    # compute replication is tolerated only when the token count is tiny —
    # all captured by scaling with T_eff = t_loc * n_dp.
    n_dp = sizes["data"]
    gather_bytes = 3 * e_loc * D * f_loc * 2            # 3 weight mats bf16
    cap_eff = cap0 * n_dp
    act_bytes = (2 * e_loc * cap_eff * f_loc * 4 * 2    # g+u psum, f32 ring
                 + 2 * t_loc * n_dp * D * 2)            # token gather + out
    gather = gather_bytes * (n_dp - 1) / n_dp < act_bytes
    if force_gather is not None:
        gather = force_gather
    if not rows:  # a replicated batch: every data rank holds these tokens already
        gather = True
    g_data, g_model = mesh.get_group("data"), mesh.get_group("model")
    pooled = (["model"] if "model" in rows else []) + ([] if gather else ["data"])

    pool = x.reshape(t_loc, D)
    own = 0  # this rank's block of t_loc rows in the pool
    for a in pooled:
        pool = _AllGather.apply(pool, mesh.get_group(a), 0)
        own = mesh.get_local_rank(a) * (pool.shape[0] // t_loc // sizes[a]) + own
    cap = cap0 * (pool.shape[0] // t_loc)
    idx, weights, aux = route(cfg, gather_weight(p["router"]), pool)
    e_lo = (mesh.get_local_rank("model") // fp) * e_loc
    glob = dispatch_indices(idx, E, cap)
    flat = idx.reshape(-1)
    buf_pos = torch.where((flat >= e_lo) & (flat < e_lo + e_loc) & (glob >= 0),
                          glob - e_lo * cap, -1)
    src = pool.to(c).repeat_interleave(k, dim=0)
    if "model" not in pooled:
        src, weights = SumGrad.apply(src, g_model), SumGrad.apply(weights, g_model)

    wg = _local_experts(p["w_gate"], mesh, 2, gather, rows)
    wu = _local_experts(p["w_up"], mesh, 2, gather, rows)
    wd = _local_experts(p["w_down"], mesh, 3, gather, rows)
    if gather:
        def ffn(buf):
            return expert_ffn(cfg, wg, wu, wd, buf)
    else:
        d_loc = D // n_dp
        d_lo = mesh.get_local_rank("data") * d_loc

        def ffn(buf):
            buf_d = buf[:, :, d_lo:d_lo + d_loc]
            g = torch.bmm(buf_d, wg.to(c))
            u = torch.bmm(buf_d, wu.to(c))
            gu = _AllReduce.apply(torch.stack([g, u]).float(), g_data, True)
            # rounded as the local path rounds its h: silu(g) to the compute
            # dtype, times u in it (the JAX package multiplies in f32)
            h = F.silu(gu[0]).to(c) * gu[1].to(c)
            return _AllGather.apply(torch.bmm(h, wd.to(c)), g_data, 2)
    y = _experts(cfg, src, weights, buf_pos, e_loc, cap, ffn)
    y = _AllReduce.apply(y.to(c), g_model, "model" in pooled)
    y = y[own * t_loc:(own + 1) * t_loc]
    return y.view(B, S, D).to(x.dtype), _Mean.apply(aux, mesh)


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              force_gather: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN, with the shared expert where the config has one.
    Returns (y, aux loss). On a mesh with ``data`` and ``model`` axes whose
    expert leaves are blocked for its model size, as the JAX package decides
    (``src/repro/models/moe.py:264-268``), the sharded path, in the mode
    ``force_gather`` names (True: gather the weights, False: keep them
    stationary) or, where it is None, the one the napkin math picks; else
    the local path."""
    mesh, rules = current_mesh(), current_rules()
    if (mesh is not None and rules is not None
            and {"data", "model"} <= set(mesh.mesh_dim_names)):
        tp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
        if p["w_gate"].dim() != 4 or p["w_gate"].shape[0] != tp:
            raise ValueError(f"expert leaves of shape {tuple(p['w_gate'].shape)} on a mesh "
                             f"with a model axis of {tp}: they must be blocked for it "
                             "(parallel.specs.expert_blocks)")
        y, aux = _moe_sharded(cfg, p, x, mesh, force_gather)
    else:
        y, aux = moe_local(cfg, p, x)
    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x)
    return y, aux
