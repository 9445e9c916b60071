"""Dense decoder stack: stacked per-layer params, the train forward and the
serve path.

Params keep the JAX layout: ``{"units": [unit_params]}`` where every leaf has
a leading ``(n_units,)`` axis (for the dense family a unit is one layer), and
the KV cache is ``{"k", "v"}`` of shape ``(n_units, unit, B, C, Hkv, Dh)``.
``jax.lax.scan`` over units becomes a Python loop over layers, and the
reference's per-unit ``jax.checkpoint`` becomes ``torch.utils.checkpoint``
per layer. MoE configs raise: the MoE FFN is a later slice of the port
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.utils.checkpoint

from .config import ModelConfig
from .layers import (
    Params,
    apply_attention,
    apply_attention_decode,
    apply_attention_prefill,
    apply_mlp,
    apply_norm,
    dt,
    init_attention,
    init_mlp,
    init_norm,
    layer_of,
    stack_layers,
)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} with {cfg.n_experts} experts is "
            "not ported yet; repro_torch serves the dense family (ROADMAP.md)")


def init_layer(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    return {
        "attn_norm": init_norm(cfg, device),
        "attn": init_attention(cfg, gen, device),
        "mlp_norm": init_norm(cfg, device),
        "mlp": init_mlp(cfg, gen, device),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Stacked params: every leaf gets a leading (n_layers,) axis."""
    _check_dense(cfg)
    return {"units": [stack_layers([init_layer(cfg, gen, device)
                                    for _ in range(cfg.n_layers)])]}


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["mlp_norm"], x))


def _layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = x + apply_attention(cfg, p["attn"], apply_norm(cfg, p["attn_norm"], x), positions)
    return _ffn(cfg, p, x)


def forward_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers. Returns (hidden (B,S,D), aux loss 0 for the dense family).

    Each layer runs under ``torch.utils.checkpoint``: only its input is kept,
    and the backward runs the layer again (flash attention's forward kernel
    included) to rebuild what it needs."""
    _check_dense(cfg)
    unit = params["units"][0]
    for i in range(cfg.n_layers):
        # the layers draw no random numbers: no RNG state to replay
        x = torch.utils.checkpoint.checkpoint(_layer, cfg, layer_of(unit, i), x,
                                              positions, use_reentrant=False,
                                              preserve_rng_state=False)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# =============================================================================
# Inference: prefill + decode with per-layer KV caches
# =============================================================================

def cache_size_for(cfg: ModelConfig, max_len: int) -> int:
    if cfg.attention_kind in ("sliding", "local") and cfg.window > 0:
        return min(max_len, cfg.window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    """KV caches stacked (n_units, unit, B, C, Hkv, Dh), zero-filled."""
    _check_dense(cfg)
    C = cache_size_for(cfg, max_len)
    shape = (cfg.n_layers, 1, batch, C, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=dt(cfg), device=device)}


def prefill_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Params
                   ) -> Tuple[torch.Tensor, Params]:
    """Forward + populate the caches (written in place). Returns (hidden, cache)."""
    _check_dense(cfg)
    unit = params["units"][0]
    C = cache["k"].shape[3]
    for i in range(cfg.n_layers):
        p = layer_of(unit, i)
        h, k, v = apply_attention_prefill(
            cfg, p["attn"], apply_norm(cfg, p["attn_norm"], x), positions, C)
        cache["k"][i, 0].copy_(k)
        cache["v"][i, 0].copy_(v)
        x = _ffn(cfg, p, x + h)
    return x, cache


def decode_hidden(cfg: ModelConfig, params: Params, cache: Params,
                  x_t: torch.Tensor, pos: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    """One token through all layers. x_t (B,1,D), pos (B,). The caches are
    updated in place and returned."""
    _check_dense(cfg)
    unit = params["units"][0]
    x = x_t
    for i in range(cfg.n_layers):
        p = layer_of(unit, i)
        h, _, _ = apply_attention_decode(
            cfg, p["attn"], apply_norm(cfg, p["attn_norm"], x), pos,
            cache["k"][i, 0], cache["v"][i, 0])
        x = _ffn(cfg, p, x + h)
    return x, cache
