"""Layers shared by the families: norms (RMSNorm, LayerNorm), RoPE, GQA
attention with qk-norm, the ring KV cache insert, the MLP (SwiGLU, GELU), the
tied embedding and the chunked cross-entropy of the train path.

Functional style as in the JAX package: ``init_*`` returns a dict of tensors
with the reference's key names and layouts (``wq (D,H,Dh)``, ``wk``/``wv
(D,Hkv,Dh)``, ``wo (H,Dh,D)``, ``w_gate``/``w_up (D,F)``, ``w_down (F,D)``,
the GELU MLP's ``b_up (F,)``, ``b_down (D,)``, LayerNorm's ``bias (D,)``,
``tok (V,D)``), and ``apply_*`` consumes it. The projections and the MLP are
plain matrix products; attention goes through ``kernels.ops``. Every param
is read through ``parallel.axes.gather_weight`` and activations pass
``shard`` where the JAX package constrains them; both return their input
without a mesh.

Where the active rules and mesh split a layer's dim over ``model``
(``axes.tp_split``: the single- and multi-pod rules, a model axis above 1
that divides the dim), the layer runs tensor-parallel, Megatron-style:
attention over its q heads (``wq`` column-, ``wo`` row-parallel; ``wk`` and
``wv`` read whole and projecting only the kv heads the rank's q heads read,
which are all that the rank's KV cache holds, ``kv_heads_local``), the MLP
over ``ffn`` (``w_gate``, ``w_up`` column-, ``w_down`` row-parallel; the
GELU form adds its slice of ``b_up``, and ``b_down`` once after the sum),
and the embedding, the logits and the cross-entropy over ``vocab``.
Activations are whole on every model rank between the layers; each
row-parallel product is summed over ``model``
(``axes.reduce_from_model``). Elsewhere a layer runs as without a mesh.

Decode is context-sharded where the rules put ``kv_seq`` on ``model`` and
the model size m divides the cache's C slots (``axes.kv_seq_span``, the
JAX package's cache layout): each rank's KV cache holds its slots
[r·C/m, (r+1)·C/m) of every kv head (``kv_cache_shape``), the prefill
hands each rank its slots, and a decode step attends all q heads over the
rank's slots and merges the ranks' partials by their logsumexps
(``axes.merge_over_model``) before the output projection.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.parallel.axes import (copy_to_model, first_holders, gather_from_model,
                                       gather_heads, gather_partial, gather_weight, kv_seq_span,
                                       local_weight, max_over_model, merge_over_model,
                                       reduce_from_model, shard, slots_from_heads,
                                       splits_kv_seq, tp_split)
from .config import ModelConfig

Params = Dict[str, Any]


def dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
            device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            * scale).to(dtype)


def init_stacked(n: int, make: Callable[[], Params]) -> Params:
    """n layers from ``make()`` stacked: every leaf gets a leading (n,) axis.
    The n layers and their stack are never held at once: each layer is copied
    into the stacked leaves as soon as it is made, so the peak is the stack
    and one layer (mixtral-8x7b's 16 layers are 45 GB in bf16), and a stack
    of one is the layer itself (llama4-maverick's one MoE layer is 32 GB)."""
    def alloc(t):
        return ({k: alloc(v) for k, v in t.items()} if isinstance(t, dict)
                else t.new_empty((n, *t.shape)))

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    def views(t):
        return {k: views(v) for k, v in t.items()} if isinstance(t, dict) else t[None]

    first = make()
    if n == 1:  # a leading axis on the one layer's leaves: no copy
        return views(first)
    out = alloc(first)
    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, make(), i)
    return out


def layer_of(stacked: Params, i: int) -> Params:
    """Layer i of a stacked dict: index the leading axis of every leaf (views,
    so an in-place write reaches the stacked tensor)."""
    return {k: layer_of(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


# =============================================================================
# Norms
# =============================================================================

def init_norm(cfg: ModelConfig, device) -> Params:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dt(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dt(cfg), device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm, or LayerNorm (mean, then the variance as the mean of
    (x - mean)^2, as the JAX package computes them), in f32, cast back to x's
    dtype."""
    if cfg.norm == "layernorm":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * gather_weight(p["scale"]).float()
                + gather_weight(p["bias"]).float()).to(x.dtype)
    return rms_head_norm(x, gather_weight(p["scale"]), cfg.norm_eps)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS over the last axis with a learned per-dim scale, in f32."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# =============================================================================
# RoPE
# =============================================================================

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B,S,H,Dh), positions (B,S) or (S,). Split-halves convention: the
    first half of Dh pairs with the second half (not HF's interleaving)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# =============================================================================
# Attention (GQA + qk-norm + RoPE)
# =============================================================================

def init_attention(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    D = cfg.d_model
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "wq": _normal(gen, (D, cfg.n_heads, cfg.head_dim), 0.02, dt(cfg), device),
        "wk": _normal(gen, (D, cfg.n_kv_heads, cfg.head_dim), 0.02, dt(cfg), device),
        "wv": _normal(gen, (D, cfg.n_kv_heads, cfg.head_dim), 0.02, dt(cfg), device),
        "wo": _normal(gen, (cfg.n_heads, cfg.head_dim, D), out_scale, dt(cfg), device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=dt(cfg), device=device)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=dt(cfg), device=device)
    return p


def _proj_heads(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x (B,S,D) times w (D,h,Dh) → contiguous (B,S,h,Dh)."""
    D, h, Dh = w.shape
    return (x @ w.to(dtype).reshape(D, h * Dh)).view(*x.shape[:-1], h, Dh)


def _kv_heads_of(cfg: ModelConfig, m: int, r: int) -> Optional[Tuple[int, int]]:
    """(first kv head, count) that model rank r's q heads read where H
    splits over m ranks; None where a kv head's group would split unevenly."""
    n, g = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    if n % g and g % n:
        return None
    return r * n // g, max(1, n // g)


def kv_heads_local(cfg: ModelConfig) -> Optional[Tuple[int, int]]:
    """(first kv head, count) that this rank's q heads read where attention
    runs tensor-parallel over ``model``; None where it runs whole. The q
    heads [r·H/m, (r+1)·H/m) of model rank r read the kv heads h // g (g =
    H / Hkv). Where they would split a kv head's group unevenly (no
    registered config does on a mesh of powers of 2) attention runs whole."""
    m, r = tp_split("heads", cfg.n_heads)
    if m == 1:
        return None
    return _kv_heads_of(cfg, m, r)


def n_kv_heads_cached(cfg: ModelConfig) -> int:
    """The kv heads of this rank's KV cache where it holds every slot: those
    its q heads read."""
    local = kv_heads_local(cfg)
    return cfg.n_kv_heads if local is None else local[1]


def kv_cache_shape(cfg: ModelConfig, n_slots: int) -> Tuple[int, int]:
    """(slots, kv heads) of this rank's KV cache of a whole cache of
    ``n_slots`` slots: C/m slots of every kv head where the slots split over
    ``model`` (``axes.kv_seq_span``), else every slot of the kv heads its q
    heads read."""
    span = kv_seq_span(n_slots)
    if span is not None:
        return span[1] - span[0], cfg.n_kv_heads
    return n_slots, n_kv_heads_cached(cfg)


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    local = kv_heads_local(cfg)
    read = read_q = read_kv = gather_weight
    if local is not None:  # this rank's q heads and the kv heads they read
        x = copy_to_model(x)
        lo, n = local
        read, read_q = gather_partial, local_weight

        def read_kv(w):
            return gather_partial(w)[:, lo:lo + n]
    q = _proj_heads(x, read_q(p["wq"]), cdt(cfg))
    k = _proj_heads(x, read_kv(p["wk"]), cdt(cfg))
    v = _proj_heads(x, read_kv(p["wv"]), cdt(cfg))
    if cfg.qk_norm:
        q = rms_head_norm(q, read(p["q_norm"]), cfg.norm_eps)
        k = rms_head_norm(k, read(p["k_norm"]), cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


def _out_proj(cfg: ModelConfig, p: Params, out: torch.Tensor) -> torch.Tensor:
    """out (..., H, Dh) times wo (H,Dh,D) → (..., D); tensor-parallel, the
    rank's heads times its rows of wo, summed over ``model``."""
    if kv_heads_local(cfg) is None:
        H, Dh, D = p["wo"].shape
        w = gather_weight(p["wo"]).to(cdt(cfg)).reshape(H * Dh, D)
        return out.reshape(*out.shape[:-2], H * Dh) @ w
    w = local_weight(p["wo"]).to(cdt(cfg))
    H, Dh, D = w.shape
    return reduce_from_model(out.reshape(*out.shape[:-2], H * Dh) @ w.reshape(H * Dh, D))


def _attend(cfg: ModelConfig, p: Params, q, k, v,
            window_override: Optional[int]) -> torch.Tensor:
    window = cfg.window if window_override is None else window_override
    out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window)
    out = shard(out, "batch", None, "heads", None)
    return shard(_out_proj(cfg, p, out), "batch", None, None)


def apply_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    window_override: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill body). x (B,S,D) → (B,S,D).
    ``window_override`` replaces ``cfg.window`` (the hybrid's local layers)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _attend(cfg, p, q, k, v, window_override)


def attention_prefill_kv(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                         cache_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit post-RoPE k, v (B,S,Hkv,Dh) to a cache of ``cache_size`` slots:
    the last ``cache_size`` positions ring-rotated so that slot = pos % C, or
    zero padding when the cache is longer than S.

    The JAX function of this name projects x itself; here
    ``apply_attention_prefill`` projects once and passes k, v in."""
    S = k.shape[1]
    if cache_size < S:
        k, v = k[:, -cache_size:], v[:, -cache_size:]
        first = positions[..., -cache_size:]
        first = first[0, 0] if first.dim() == 2 else first[0]
        # torch.roll by (first % C) as a gather, so the shift stays on the device
        idx = torch.remainder(torch.arange(cache_size, device=k.device) - first,
                              cache_size)
        k, v = k.index_select(1, idx), v.index_select(1, idx)
    elif cache_size > S:
        pad = (0, 0, 0, 0, 0, cache_size - S)
        k, v = F.pad(k, pad), F.pad(v, pad)
    return k, v


def _kv_firsts(cfg: ModelConfig) -> List[int]:
    """The first kv head of each model rank's q heads, in rank order."""
    m, _ = tp_split("heads", cfg.n_heads)
    return [_kv_heads_of(cfg, m, r)[0] for r in range(m)]


def _rank_slots(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, span: Tuple[int, int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slots ``span`` of every kv head, from this rank's k and v (B, C,
    h, Dh) of every slot: a slice where it holds every kv head, else one
    all-to-all over ``model`` from the ranks that hold each head."""
    if kv_heads_local(cfg) is None:
        return k[:, span[0]:span[1]], v[:, span[0]:span[1]]
    kv = slots_from_heads(torch.stack([k, v]), _kv_firsts(cfg), cfg.n_kv_heads)
    return kv[0], kv[1]


def _all_heads(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every q head and every kv head of the new token (B, 1, ·, Dh), from
    each model rank's q heads and the kv heads they read: one all-gather
    over ``model`` of B (H/m + 2n) Dh values, no projection recomputed."""
    hq, n = q.shape[-2], k.shape[-2]
    firsts = _kv_firsts(cfg)
    got = gather_heads(torch.cat([q, k, v], dim=-2)).unflatten(-2, (len(firsts), hq + 2 * n))
    ranks, at = first_holders(firsts, n, cfg.n_kv_heads, q.device)
    return (got[..., :hq, :].flatten(-3, -2), got[..., hq:hq + n, :][..., ranks, at, :],
            got[..., hq + n:, :][..., ranks, at, :])


def apply_attention_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                            positions: torch.Tensor, cache_size: int, *,
                            window_override: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``apply_attention`` plus ``attention_prefill_kv`` from one
    projection: returns (y (B,S,D), k, v (B,cache_size,Hkv,Dh)), or, where
    the cache's slots split over ``model``, this rank's share of k and v
    (``kv_cache_shape``)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    y = _attend(cfg, p, q, k, v, window_override)
    k, v = attention_prefill_kv(k, v, positions, cache_size)
    span = kv_seq_span(cache_size)
    if span is not None:
        k, v = _rank_slots(cfg, k, v, span)
    return y, k, v


def apply_attention_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                           pos: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, n_slots: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. x_t (B,1,D), pos (B,) absolute positions, caches
    (B,C,Hkv,Dh) of this rank's kv heads (``n_kv_heads_cached``), or its
    share of the slots of a whole cache of ``n_slots`` slots
    (``kv_cache_shape``; ``n_slots`` None: the caches are whole, which rules
    that split ``kv_seq`` refuse). Returns (y (B,1,D), k_cache, v_cache).

    Unlike the JAX version, which returns new caches, the new token's K/V is
    written into the given caches in place (they are views into the stacked
    cache), and the same tensors are returned."""
    if n_slots is None:
        if splits_kv_seq():
            raise ValueError("a decode step under rules that split kv_seq over 'model' "
                             "needs the whole cache's slots (lm.decode_step's max_len)")
        n_slots = k_cache.shape[1]
    span = kv_seq_span(n_slots)
    if span is not None:
        return _decode_kv_seq(cfg, p, x_t, pos, k_cache, v_cache, n_slots, span)
    B = x_t.shape[0]
    C = k_cache.shape[1]
    q, k, v = _project_qkv(cfg, p, x_t, pos[:, None])
    slot = torch.remainder(pos, C).long()  # ring insert at pos % C
    bidx = torch.arange(B, device=x_t.device)
    k_cache[bidx, slot] = k[:, 0]
    v_cache[bidx, slot] = v[:, 0]
    k_cache = shard(k_cache, "batch", "kv_seq", None, None)
    v_cache = shard(v_cache, "batch", "kv_seq", None, None)
    cache_len = torch.clamp(pos + 1, max=C).to(torch.int32)
    out = ops.decode_attention(q[:, 0], k_cache, v_cache, cache_len)
    out = shard(out, "batch", "heads", None)
    return shard(_out_proj(cfg, p, out)[:, None], "batch", None, None), k_cache, v_cache


def _decode_kv_seq(cfg: ModelConfig, p: Params, x_t: torch.Tensor, pos: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor, C: int,
                   span: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``apply_attention_decode`` on this rank's slots ``span`` of a C-slot
    cache: the new token's k and v of every kv head (gathered from the
    ranks that project them where the heads split) written where this rank
    owns slot pos % C (per row, on the device), every q head attended over
    the rank's valid slots, clamp(cache_len - lo, 0, C/m) of them (validity
    is a prefix of the slots in full and ring caches alike), and the
    partials merged over ``model`` into this rank's heads (all of them where
    the heads do not split)."""
    lo, hi = span
    B = x_t.shape[0]
    q, k, v = _project_qkv(cfg, p, x_t, pos[:, None])
    split = kv_heads_local(cfg) is not None
    if split:
        q, k, v = _all_heads(cfg, q, k, v)
    slot = torch.remainder(pos, C).long()
    owned = ((slot >= lo) & (slot < hi))[:, None, None]
    at = torch.clamp(slot - lo, 0, hi - lo - 1)
    bidx = torch.arange(B, device=x_t.device)
    k_cache[bidx, at] = torch.where(owned, k[:, 0], k_cache[bidx, at])
    v_cache[bidx, at] = torch.where(owned, v[:, 0], v_cache[bidx, at])
    cache_len = torch.clamp(torch.clamp(pos + 1, max=C) - lo, 0, hi - lo).to(torch.int32)
    out, lse = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache, cache_len,
                                    return_lse=True)
    out = merge_over_model(out, lse, split)
    return _out_proj(cfg, p, out)[:, None], k_cache, v_cache


# =============================================================================
# MLP (SwiGLU or GELU)
# =============================================================================

def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             d_ff: Optional[int] = None) -> Params:
    """``d_ff`` defaults to the config's (an MoE layer's shared expert passes
    ``n_shared_experts · d_ff``)."""
    D, Fd = cfg.d_model, cfg.d_ff if d_ff is None else d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    if cfg.act == "silu":
        return {
            "w_gate": _normal(gen, (D, Fd), 0.02, dt(cfg), device),
            "w_up": _normal(gen, (D, Fd), 0.02, dt(cfg), device),
            "w_down": _normal(gen, (Fd, D), out_scale, dt(cfg), device),
        }
    return {
        "w_up": _normal(gen, (D, Fd), 0.02, dt(cfg), device),
        "b_up": torch.zeros((Fd,), dtype=dt(cfg), device=device),
        "w_down": _normal(gen, (Fd, D), out_scale, dt(cfg), device),
        "b_down": torch.zeros((D,), dtype=dt(cfg), device=device),
    }


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x·w_gate) in f32, cast, times x·w_up, then ·w_down. GELU:
    u = x·w_up + b_up, gelu(u) in f32, cast, then ·w_down + b_down. The GELU
    is the tanh form, which ``jax.nn.gelu`` computes by default (torch's
    default, the erf form, differs by up to 4.7e-4 over [-6, 6]).

    Tensor-parallel over ``ffn``: the rank's columns of ``w_gate``, ``w_up``
    and ``b_up`` and rows of ``w_down``, the products summed over ``model``,
    then ``b_down``."""
    c = cdt(cfg)
    m, r = tp_split("ffn", p["w_up"].shape[-1])
    if m > 1:
        return _apply_mlp_tp(cfg, p, x, m, r)
    if cfg.act == "silu":
        g = x @ gather_weight(p["w_gate"]).to(c)
        u = x @ gather_weight(p["w_up"]).to(c)
        h = shard(F.silu(g.float()).to(c) * u, "batch", None, "ffn")
        return shard(h @ gather_weight(p["w_down"]).to(c), "batch", None, None)
    u = x @ gather_weight(p["w_up"]).to(c) + gather_weight(p["b_up"])
    h = shard(F.gelu(u.float(), approximate="tanh").to(c), "batch", None, "ffn")
    y = h @ gather_weight(p["w_down"]).to(c) + gather_weight(p["b_down"])
    return shard(y, "batch", None, None)


def _apply_mlp_tp(cfg: ModelConfig, p: Params, x: torch.Tensor, m: int, r: int
                  ) -> torch.Tensor:
    c = cdt(cfg)
    x = copy_to_model(x)
    if cfg.act == "silu":
        g = x @ local_weight(p["w_gate"]).to(c)
        u = x @ local_weight(p["w_up"]).to(c)
        h = F.silu(g.float()).to(c) * u
        return reduce_from_model(h @ local_weight(p["w_down"]).to(c))
    f = p["w_up"].shape[-1] // m
    u = x @ local_weight(p["w_up"]).to(c) + gather_partial(p["b_up"])[r * f:(r + 1) * f]
    h = F.gelu(u.float(), approximate="tanh").to(c)
    return reduce_from_model(h @ local_weight(p["w_down"]).to(c)) + gather_weight(p["b_down"])


# =============================================================================
# Embedding / unembedding
# =============================================================================

def init_embedding(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    p = {"tok": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt(cfg), device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.vocab_size, cfg.d_model),
                               1.0 / math.sqrt(cfg.d_model), dt(cfg), device)
    return p


def _vocab_rows(cfg: ModelConfig) -> Optional[Tuple[int, int]]:
    """[first, end) of the vocab rows this rank holds where the embedding,
    the logits and the loss run vocab-parallel; None where they run whole."""
    m, r = tp_split("vocab", cfg.vocab_size)
    if m == 1:
        return None
    n = cfg.vocab_size // m
    return r * n, (r + 1) * n


def embed_tokens(cfg: ModelConfig, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel: each rank looks the tokens up in its rows of the
    table, 0 for a token outside them, and the lookups are summed over
    ``model``."""
    rows = _vocab_rows(cfg)
    # F.embedding, not indexing: its CUDA backward sums each row's gradient in
    # a fixed order, where indexing's accumulating scatter need not
    if rows is None:
        x = F.embedding(tokens, gather_weight(p["tok"]).to(cdt(cfg)))
        return shard(x, "batch", None, None)
    lo, hi = rows
    inside = (tokens >= lo) & (tokens < hi)
    x = F.embedding(torch.where(inside, tokens - lo, 0), local_weight(p["tok"]).to(cdt(cfg)))
    return reduce_from_model(x.masked_fill(~inside[..., None], 0))


def unembed_matrix(cfg: ModelConfig, p: Params) -> torch.Tensor:
    """(V, D) in the compute dtype; this rank's rows where the logits run
    vocab-parallel."""
    w = p["tok"] if cfg.tie_embeddings else p["unembed"]
    read = gather_weight if _vocab_rows(cfg) is None else local_weight
    return read(w).to(cdt(cfg))


def logits_for(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full logits (..., V) — use only for single-position outputs.
    Vocab-parallel, each rank's block of the vocab gathered over ``model``."""
    if _vocab_rows(cfg) is not None:
        return gather_from_model(copy_to_model(x) @ unembed_matrix(cfg, p).t())
    out = x @ unembed_matrix(cfg, p).t()
    return shard(out, "batch", "vocab") if out.dim() == 2 else shard(out, "batch", None, "vocab")


def _xent_chunk(x_c: torch.Tensor, w: torch.Tensor, l_c: torch.Tensor,
                lo: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk's token-loss sum and valid count. Vocab-parallel (``lo``,
    the rank's first vocab row): the logsumexp from the max, the sum of
    exps and the picked logit, each reduced over ``model``."""
    logits = shard((x_c @ w.t()).float(), "batch", None, "vocab")
    valid = l_c != -100
    if lo is None:
        lse = torch.logsumexp(logits, dim=-1)
        safe = torch.where(valid, l_c, 0).long()
        picked = logits.gather(-1, safe[..., None])[..., 0]
    else:
        # the max only steadies the sum: the logsumexp does not depend on it
        mx = max_over_model(logits.amax(-1))
        lse = mx + torch.log(reduce_from_model(torch.exp(logits - mx[..., None]).sum(-1)))
        local = l_c - lo
        mine = valid & (local >= 0) & (local < w.shape[0])
        picked = logits.gather(-1, torch.where(mine, local, 0).long()[..., None])[..., 0]
        picked = reduce_from_model(torch.where(mine, picked, 0.0))
    tok_loss = torch.where(valid, lse - picked, 0.0)
    return tok_loss.sum(), valid.sum()


def chunked_softmax_xent(cfg: ModelConfig, p_embed: Params, x: torch.Tensor,
                         labels: torch.Tensor, s_chunk: int = 2048
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materialising (B, S, V) logits for all of S.
    x (B,S,D) final hidden states, labels (B,S) with -100 ignored. Logits are
    made one sequence chunk at a time, in the compute dtype and then f32, as
    the JAX package does, and each chunk runs under ``torch.utils.checkpoint``
    so its logits are recomputed in the backward instead of kept (at
    qwen3-1.7b's width one chunk of 4 x 2048 tokens holds 5 GB of f32 logits).

    Vocab-parallel, each rank makes its block of the logits and no rank
    holds all of V (``_xent_chunk``).

    Returns (sum of the token losses, number of valid tokens) as f32 scalars."""
    S = x.shape[1]
    w = unembed_matrix(cfg, p_embed)
    rows = _vocab_rows(cfg)
    lo = None if rows is None else rows[0]
    if rows is not None:
        x = copy_to_model(x)
    sc = min(s_chunk, S)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, S, sc):
        ls, nv = torch.utils.checkpoint.checkpoint(
            _xent_chunk, x[:, c0:c0 + sc], w, labels[:, c0:c0 + sc], lo,
            use_reentrant=False, preserve_rng_state=False)
        loss_sum = loss_sum + ls
        n_valid = n_valid + nv
    return loss_sum, n_valid.float()
