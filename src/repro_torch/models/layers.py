"""Layers shared by the families: norms, RoPE, GQA attention with qk-norm,
the ring KV cache insert, the SwiGLU MLP, the tied embedding and the chunked
cross-entropy of the train path.

Functional style as in the JAX package: ``init_*`` returns a dict of tensors
with the reference's key names and layouts (``wq (D,H,Dh)``, ``wk``/``wv
(D,Hkv,Dh)``, ``wo (H,Dh,D)``, ``w_gate``/``w_up (D,F)``, ``w_down (F,D)``,
``tok (V,D)``), and ``apply_*`` consumes it. The projections and the MLP are
plain matrix products; attention goes through ``kernels.ops``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops
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


def stack_layers(layers: List[Params]) -> Params:
    """Stack per-layer param (or cache) dicts: every leaf gets a leading axis."""
    return {k: stack_layers([l[k] for l in layers]) if isinstance(layers[0][k], dict)
            else torch.stack([l[k] for l in layers]) for k in layers[0]}


def layer_of(stacked: Params, i: int) -> Params:
    """Layer i of a stacked dict: index the leading axis of every leaf (views,
    so an in-place write reaches the stacked tensor)."""
    return {k: layer_of(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


# =============================================================================
# Norms
# =============================================================================

def init_norm(cfg: ModelConfig, device) -> Params:
    return {"scale": torch.ones((cfg.d_model,), dtype=dt(cfg), device=device)}


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet (ROADMAP.md)")
    return rms_head_norm(x, p["scale"], cfg.norm_eps)


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


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj_heads(x, p["wq"], cdt(cfg))
    k = _proj_heads(x, p["wk"], cdt(cfg))
    v = _proj_heads(x, p["wv"], cdt(cfg))
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(cfg: ModelConfig, p: Params, out: torch.Tensor) -> torch.Tensor:
    """out (..., H, Dh) times wo (H,Dh,D) → (..., D)."""
    H, Dh, D = p["wo"].shape
    return out.reshape(*out.shape[:-2], H * Dh) @ p["wo"].to(cdt(cfg)).reshape(H * Dh, D)


def _attend(cfg: ModelConfig, p: Params, q, k, v,
            window_override: Optional[int]) -> torch.Tensor:
    window = cfg.window if window_override is None else window_override
    out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window)
    return _out_proj(cfg, p, out)


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


def apply_attention_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                            positions: torch.Tensor, cache_size: int, *,
                            window_override: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``apply_attention`` plus ``attention_prefill_kv`` from one
    projection: returns (y (B,S,D), k, v (B,cache_size,Hkv,Dh))."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    y = _attend(cfg, p, q, k, v, window_override)
    k, v = attention_prefill_kv(k, v, positions, cache_size)
    return y, k, v


def apply_attention_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                           pos: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. x_t (B,1,D), pos (B,) absolute positions, caches
    (B,C,Hkv,Dh). Returns (y (B,1,D), k_cache, v_cache).

    Unlike the JAX version, which returns new caches, the new token's K/V is
    written into the given caches in place (they are views into the stacked
    cache), and the same tensors are returned."""
    B = x_t.shape[0]
    C = k_cache.shape[1]
    q, k, v = _project_qkv(cfg, p, x_t, pos[:, None])
    slot = torch.remainder(pos, C).long()  # ring insert at pos % C
    bidx = torch.arange(B, device=x_t.device)
    k_cache[bidx, slot] = k[:, 0]
    v_cache[bidx, slot] = v[:, 0]
    cache_len = torch.clamp(pos + 1, max=C).to(torch.int32)
    out = ops.decode_attention(q[:, 0], k_cache, v_cache, cache_len)
    return _out_proj(cfg, p, out)[:, None], k_cache, v_cache


# =============================================================================
# MLP (SwiGLU)
# =============================================================================

def init_mlp(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    if cfg.act != "silu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported yet (ROADMAP.md)")
    D, Fd = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "w_gate": _normal(gen, (D, Fd), 0.02, dt(cfg), device),
        "w_up": _normal(gen, (D, Fd), 0.02, dt(cfg), device),
        "w_down": _normal(gen, (Fd, D), out_scale, dt(cfg), device),
    }


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x·w_gate) in f32, cast, times x·w_up, then ·w_down."""
    if cfg.act != "silu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported yet (ROADMAP.md)")
    c = cdt(cfg)
    g = x @ p["w_gate"].to(c)
    u = x @ p["w_up"].to(c)
    h = F.silu(g.float()).to(c) * u
    return h @ p["w_down"].to(c)


# =============================================================================
# Embedding / unembedding
# =============================================================================

def init_embedding(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    p = {"tok": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt(cfg), device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.vocab_size, cfg.d_model),
                               1.0 / math.sqrt(cfg.d_model), dt(cfg), device)
    return p


def embed_tokens(cfg: ModelConfig, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: its CUDA backward sums each row's gradient in
    # a fixed order, where indexing's accumulating scatter need not
    return F.embedding(tokens, p["tok"].to(cdt(cfg)))


def unembed_matrix(cfg: ModelConfig, p: Params) -> torch.Tensor:
    w = p["tok"] if cfg.tie_embeddings else p["unembed"]
    return w.to(cdt(cfg))


def logits_for(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full logits (..., V) — use only for single-position outputs."""
    return x @ unembed_matrix(cfg, p).t()


def _xent_chunk(x_c: torch.Tensor, w: torch.Tensor, l_c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = (x_c @ w.t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = l_c != -100
    safe = torch.where(valid, l_c, 0).long()
    picked = logits.gather(-1, safe[..., None])[..., 0]
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

    Returns (sum of the token losses, number of valid tokens) as f32 scalars."""
    S = x.shape[1]
    w = unembed_matrix(cfg, p_embed)
    sc = min(s_chunk, S)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, S, sc):
        ls, nv = torch.utils.checkpoint.checkpoint(
            _xent_chunk, x[:, c0:c0 + sc], w, labels[:, c0:c0 + sc],
            use_reentrant=False, preserve_rng_state=False)
        loss_sum = loss_sum + ls
        n_valid = n_valid + nv
    return loss_sum, n_valid.float()
