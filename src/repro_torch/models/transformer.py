"""Decoder stack with optional interleaved MoE FFNs: stacked per-layer params,
the train forward and the serve path.

Covers the dense archs (qwen3-1.7b, granite-8b, phi4-mini-3.8b, llama3.2-3b)
and the MoE ones (mixtral-8x7b: MoE every layer, sliding window;
llama4-maverick: MoE every other layer, with a shared expert).

Params keep the JAX layout: layers are grouped into units of ``moe_every``
consecutive layers (one layer without experts), ``{"units": [params of
position 0, ..., position unit-1]}`` where every leaf has a leading
``(n_units,)`` axis, and the MoE layer is the last of each unit. The KV cache
is ``{"k", "v"}`` of shape ``(n_units, unit, B, C, Hkv, Dh)``, Hkv the kv
heads of this rank's q heads under tensor parallelism, or, where the rules
split the cache's slots over ``model`` (``kv_seq``), this rank's C/m slots
of every kv head (``layers.kv_cache_shape``).
``jax.lax.scan`` over units becomes a Python loop over layers, and the
reference's per-unit ``jax.checkpoint`` becomes ``torch.utils.checkpoint``
per layer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.parallel.axes import shard
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
    init_stacked,
    kv_cache_shape,
    layer_of,
)
from .moe import apply_moe, init_moe_layer


def _unit_size(cfg: ModelConfig) -> int:
    return cfg.moe_every if cfg.n_experts > 0 else 1


def _n_units(cfg: ModelConfig) -> int:
    if cfg.n_layers % _unit_size(cfg):
        raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers are not whole units "
                         f"of moe_every={cfg.moe_every}")
    return cfg.n_layers // _unit_size(cfg)


def _layer_is_moe(cfg: ModelConfig, pos_in_unit: int) -> bool:
    # MoE occupies the last layer of each unit (llama4: dense, moe, dense, ...)
    return cfg.n_experts > 0 and pos_in_unit == _unit_size(cfg) - 1


def _layers(cfg: ModelConfig, params: Params):
    """(unit, position in the unit, that layer's params) in depth order."""
    units = params["units"]
    for i in range(_n_units(cfg)):
        for pos in range(_unit_size(cfg)):
            yield i, pos, layer_of(units[pos], i)


def init_layer(cfg: ModelConfig, gen: torch.Generator, device, is_moe: bool) -> Params:
    p = {
        "attn_norm": init_norm(cfg, device),
        "attn": init_attention(cfg, gen, device),
        "mlp_norm": init_norm(cfg, device),
    }
    if is_moe:
        p["moe"] = init_moe_layer(cfg, gen, device)
    else:
        p["mlp"] = init_mlp(cfg, gen, device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Stacked params: one dict per position in the unit, every leaf with a
    leading (n_units,) axis."""
    n_units = _n_units(cfg)
    return {"units": [init_stacked(n_units, lambda: init_layer(cfg, gen, device,
                                                               _layer_is_moe(cfg, pos)))
                      for pos in range(_unit_size(cfg))]}


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + FFN(norm(x)), and the layer's aux loss (None for a dense FFN)."""
    h = apply_norm(cfg, p["mlp_norm"], x)
    if "moe" in p:
        y, aux = apply_moe(cfg, p["moe"], h)
        return x + y, aux
    return x + apply_mlp(cfg, p["mlp"], h), None


def _layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
           positions: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    x = x + apply_attention(cfg, p["attn"], apply_norm(cfg, p["attn_norm"], x), positions)
    return _ffn(cfg, p, x)


def forward_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers. Returns (hidden (B,S,D), aux loss summed over the MoE
    layers; 0 without experts).

    Each layer runs under ``torch.utils.checkpoint``: only its input is kept,
    and the backward runs the layer again (flash attention's forward kernel
    included) to rebuild what it needs."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, _, p in _layers(cfg, params):
        # the layers draw no random numbers: no RNG state to replay
        x, a = torch.utils.checkpoint.checkpoint(_layer, cfg, p, x, positions,
                                                 use_reentrant=False,
                                                 preserve_rng_state=False)
        x = shard(x, "batch", None, None)
        if a is not None:
            aux = aux + a
    return x, aux


# =============================================================================
# Inference: prefill + decode with per-layer KV caches
# =============================================================================

def cache_size_for(cfg: ModelConfig, max_len: int) -> int:
    if cfg.attention_kind in ("sliding", "local") and cfg.window > 0:
        return min(max_len, cfg.window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    """KV caches stacked (n_units, unit, B, C, Hkv, Dh), zero-filled. Where
    attention runs tensor-parallel over ``model`` each rank's cache holds
    only the kv heads its q heads read, and where the slots split over
    ``model`` its C/m slots of every kv head (``layers.kv_cache_shape``)."""
    slots, heads = kv_cache_shape(cfg, cache_size_for(cfg, max_len))
    shape = (_n_units(cfg), _unit_size(cfg), batch, slots, heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=dt(cfg), device=device)}


def prefill_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Params, max_len: int
                   ) -> Tuple[torch.Tensor, Params]:
    """Forward + populate the caches of ``max_len`` tokens (written in
    place). Returns (hidden, cache)."""
    C = cache_size_for(cfg, max_len)
    for i, pos, p in _layers(cfg, params):
        h, k, v = apply_attention_prefill(
            cfg, p["attn"], apply_norm(cfg, p["attn_norm"], x), positions, C)
        cache["k"][i, pos].copy_(k)
        cache["v"][i, pos].copy_(v)
        x, _ = _ffn(cfg, p, x + h)
        x = shard(x, "batch", None, None)
    return x, cache


def decode_hidden(cfg: ModelConfig, params: Params, cache: Params,
                  x_t: torch.Tensor, pos: torch.Tensor, max_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """One token through all layers. x_t (B,1,D), pos (B,), ``max_len`` the
    caches' as ``init_cache`` took it (None: the caches are whole). The
    caches are updated in place and returned."""
    C = None if max_len is None else cache_size_for(cfg, max_len)
    x = x_t
    for i, j, p in _layers(cfg, params):
        h, _, _ = apply_attention_decode(
            cfg, p["attn"], apply_norm(cfg, p["attn_norm"], x), pos,
            cache["k"][i, j], cache["v"][i, j], C)
        x, _ = _ffn(cfg, p, x + h)
    return x, cache
