"""RecurrentGemma / Griffin, the hybrid family: RG-LRU recurrent blocks and
local attention, 2:1.

The block pattern (rglru, rglru, attn) repeats; every temporal-mixing block is
followed by a SwiGLU MLP. The RG-LRU recurrence runs through
``kernels.ops.rglru_scan``, local attention through ``kernels.ops`` with the
config's window. Params keep the JAX layout: ``{"units": [one dict per
pattern position, leaves stacked over units], "tail": [layer dicts]}`` — the
layers that do not fill a whole pattern (38 = 12 × 3 + 2) are the tail, of
kinds ``pattern[t % 3]``. The serve state mirrors it: attention layers hold
ring KV caches of ``min(max_len, window)`` slots, RG-LRU layers their state
``h`` (B,W) and conv tail (B,K-1,W), all f32 but the caches; prefill and
decode write them in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.parallel.axes import gather_weight, shard
from .config import ModelConfig
from .layers import (
    Params,
    _normal,
    apply_attention,
    apply_attention_decode,
    apply_attention_prefill,
    apply_mlp,
    apply_norm,
    cdt,
    dt,
    init_attention,
    init_mlp,
    init_norm,
    init_stacked,
    layer_of,
    n_kv_heads_cached,
)

N_DIAG_BLOCKS = 8  # RG-LRU gate matrices are block-diagonal (Griffin §2.4)
C_RGLRU = 8.0      # decay sharpness constant


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


# =============================================================================
# RG-LRU temporal-mixing block
# =============================================================================

def init_rglru_block(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    W, D, K = cfg.lru_width, cfg.d_model, cfg.conv_width
    kb = W // N_DIAG_BLOCKS
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    # Λ so that a = exp(-c softplus(Λ) σ(...)) starts near 0.9..0.999
    a0 = torch.linspace(0.9, 0.999, W, dtype=torch.float32, device=device)
    zeros = dict(dtype=dt(cfg), device=device)
    return {
        "w_x": _normal(gen, (D, W), 0.02, dt(cfg), device),
        "w_gate": _normal(gen, (D, W), 0.02, dt(cfg), device),
        "conv_w": _normal(gen, (K, W), 0.02, dt(cfg), device),
        "conv_b": torch.zeros((W,), **zeros),
        "w_a": _normal(gen, (N_DIAG_BLOCKS, kb, kb), 0.02, dt(cfg), device),
        "b_a": torch.zeros((W,), **zeros),
        "w_i": _normal(gen, (N_DIAG_BLOCKS, kb, kb), 0.02, dt(cfg), device),
        "b_i": torch.zeros((W,), **zeros),
        "lam": torch.log(torch.expm1(-torch.log(a0) / C_RGLRU)),  # (W,) f32
        "w_out": _normal(gen, (W, D), out_scale, dt(cfg), device),
    }


def _block_diag_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., W) times the block-diagonal w (nb, kb, kb) → (..., W)."""
    nb, kb, _ = w.shape
    y = torch.einsum("...nk,nkj->...nj", x.reshape(*x.shape[:-1], nb, kb), w.to(x.dtype))
    return y.reshape(x.shape)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence. x (B,S,W), w (K,W); ``tail``
    (B,K-1,W) is the carried context of earlier tokens (decode)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)) if tail is None else torch.cat([tail.to(x.dtype), x], 1)
    return sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K)) + b.to(x.dtype)


def _rglru_gates(p: Params, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (a_log (B,S,W) <= 0, gated input (B,S,W)), both f32."""
    r = torch.sigmoid(_block_diag_matmul(xc, gather_weight(p["w_a"])).float()
                      + gather_weight(p["b_a"]).float())
    i = torch.sigmoid(_block_diag_matmul(xc, gather_weight(p["w_i"])).float()
                      + gather_weight(p["b_i"]).float())
    a_log = -C_RGLRU * F.softplus(gather_weight(p["lam"])) * r
    return a_log, i * xc.float()


def _rglru_mix(cfg: ModelConfig, p: Params, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU mixing. x (B,S,D) → (out (B,S,D), last state
    (B,W) in the compute dtype, conv input xb (B,S,W))."""
    c = cdt(cfg)
    gate = _gelu((x @ gather_weight(p["w_gate"]).to(c)).float())
    xb = shard(x @ gather_weight(p["w_x"]).to(c), "batch", None, "ffn")
    xc = _causal_conv(xb, gather_weight(p["conv_w"]), gather_weight(p["conv_b"]))
    a_log, gated = _rglru_gates(p, xc)
    hs, h_last = ops.rglru_scan(gated.to(c), a_log)
    out = (hs.float() * gate).to(c) @ gather_weight(p["w_out"]).to(c)
    return shard(out, "batch", None, None), h_last, xb


def apply_rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence RG-LRU mixing. x (B,S,D) → (B,S,D)."""
    return _rglru_mix(cfg, p, x)[0]


def rglru_block_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                       state: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token RG-LRU step. x_t (B,1,D); state {h (B,W) f32, conv (B,K-1,W)
    f32}. Returns (out (B,1,D), the new state)."""
    c = cdt(cfg)
    gate = _gelu((x_t @ gather_weight(p["w_gate"]).to(c)).float())
    xb = x_t @ gather_weight(p["w_x"]).to(c)
    xc = _causal_conv(xb, gather_weight(p["conv_w"]), gather_weight(p["conv_b"]),
                      tail=state["conv"])
    new_conv = torch.cat([state["conv"][:, 1:], xb.float()], 1)
    a_log, gated = _rglru_gates(p, xc)
    h = ops.rglru_decode_step(gated[:, 0], a_log[:, 0], state["h"])
    out = (h[:, None].float() * gate).to(c) @ gather_weight(p["w_out"]).to(c)
    return out, {"h": h, "conv": new_conv}


# =============================================================================
# Hybrid stack
# =============================================================================

def _n_units(cfg: ModelConfig) -> int:
    return cfg.n_layers // len(cfg.block_pattern)


def _tail_kinds(cfg: ModelConfig) -> List[str]:
    pat = cfg.block_pattern
    return [pat[t % len(pat)] for t in range(cfg.n_layers % len(pat))]


def init_layer(cfg: ModelConfig, gen: torch.Generator, device, kind: str) -> Params:
    p = {"mix_norm": init_norm(cfg, device), "mlp_norm": init_norm(cfg, device)}
    if kind == "attn":
        p["attn"] = init_attention(cfg, gen, device)
    else:
        p["rglru"] = init_rglru_block(cfg, gen, device)
    p["mlp"] = init_mlp(cfg, gen, device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    return {
        "units": [init_stacked(_n_units(cfg), lambda: init_layer(cfg, gen, device, kind))
                  for kind in cfg.block_pattern],
        "tail": [init_layer(cfg, gen, device, kind) for kind in _tail_kinds(cfg)],
    }


def _layers(cfg: ModelConfig, params: Params, cache: Optional[Params] = None):
    """Every layer in order as (kind, params, cache slot or None); the slots of
    stacked units are views, so writing into them updates the cache."""
    for i in range(_n_units(cfg)):
        for pos, kind in enumerate(cfg.block_pattern):
            c = layer_of(cache["units"][pos], i) if cache is not None else None
            yield kind, layer_of(params["units"][pos], i), c
    for t, kind in enumerate(_tail_kinds(cfg)):
        yield kind, params["tail"][t], cache["tail"][t] if cache is not None else None


def _mlp_residual(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["mlp_norm"], x))


def _layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    h_in = apply_norm(cfg, p["mix_norm"], x)
    if kind == "attn":
        h = apply_attention(cfg, p["attn"], h_in, positions, window_override=cfg.window)
    else:
        h = apply_rglru_block(cfg, p["rglru"], h_in)
    return _mlp_residual(cfg, p, x + h)


def forward_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers over the sequence (no cache). Returns (hidden, aux 0).

    Each layer runs under ``torch.utils.checkpoint``: only its input is kept,
    and the backward runs the layer again (its RG-LRU scan or attention
    forward kernel included) to rebuild what it needs. The JAX package remats
    per pattern unit (``repro.models.rglru.forward_hidden``); the
    granularity changes what is kept, not a value."""
    for kind, p, _ in _layers(cfg, params):
        # the layers draw no random numbers: no RNG state to replay
        x = torch.utils.checkpoint.checkpoint(_layer, cfg, kind, p, x, positions,
                                              use_reentrant=False, preserve_rng_state=False)
        x = shard(x, "batch", None, None)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# =============================================================================
# Inference state: attention ring caches + recurrent states
# =============================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    C = min(max_len, cfg.window) if cfg.window else max_len
    W, K = cfg.lru_width, cfg.conv_width

    def state(lead: Tuple[int, ...], kind: str) -> Dict[str, Any]:
        if kind == "attn":
            # this rank's kv heads under tensor parallelism
            shape = (*lead, batch, C, n_kv_heads_cached(cfg), cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dt(cfg), device=device),
                    "v": torch.zeros(shape, dtype=dt(cfg), device=device)}
        f32 = dict(dtype=torch.float32, device=device)
        return {"h": torch.zeros((*lead, batch, W), **f32),
                "conv": torch.zeros((*lead, batch, K - 1, W), **f32)}

    return {"units": [state((_n_units(cfg),), kind) for kind in cfg.block_pattern],
            "tail": [state((), kind) for kind in _tail_kinds(cfg)]}


def prefill_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Params) -> Tuple[torch.Tensor, Params]:
    """Forward + fill the caches and states (written in place)."""
    K = cfg.conv_width
    for kind, p, c in _layers(cfg, params, cache):
        h_in = apply_norm(cfg, p["mix_norm"], x)
        if kind == "attn":
            h, k, v = apply_attention_prefill(cfg, p["attn"], h_in, positions,
                                              c["k"].shape[1], window_override=cfg.window)
            c["k"].copy_(k)
            c["v"].copy_(v)
        else:
            h, h_last, xb = _rglru_mix(cfg, p["rglru"], h_in)
            c["h"].copy_(h_last)
            c["conv"].copy_(xb[:, -(K - 1):])  # the conv input, before the conv
        x = _mlp_residual(cfg, p, x + h)
    return x, cache


def decode_hidden(cfg: ModelConfig, params: Params, cache: Params, x_t: torch.Tensor,
                  pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One token through all layers. x_t (B,1,D), pos (B,). The caches and
    states are updated in place and returned."""
    x = x_t
    for kind, p, c in _layers(cfg, params, cache):
        h_in = apply_norm(cfg, p["mix_norm"], x)
        if kind == "attn":
            h, _, _ = apply_attention_decode(cfg, p["attn"], h_in, pos, c["k"], c["v"])
        else:
            h, new = rglru_block_decode(cfg, p["rglru"], h_in, c)
            c["h"].copy_(new["h"])
            c["conv"].copy_(new["conv"])
        x = _mlp_residual(cfg, p, x + h)
    return x, cache
