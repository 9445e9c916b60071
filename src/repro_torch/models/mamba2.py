"""Mamba-2 (SSD, state-space duality): the attention-free ssm family.

Block: in_proj → [z gate | x, B, C | dt] → depthwise causal conv over
(x, B, C) → SSD scan (``kernels.ops.ssd_scan``) → ``+ d_skip · x`` → gated
RMSNorm → out_proj. Params keep the JAX layout: ``{"blocks", "norms"}``, each
leaf stacked over layers; ``a_log``, ``dt_bias`` and ``d_skip`` stay f32 in a
bf16 model. The serve state is ``{"ssm" (L,B,H,P,N) f32, "conv" (L,B,K-1,
conv_dim) f32}``, written in place by prefill and decode.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.axes import gather_weight, shard
from .config import ModelConfig
from .layers import (Params, _normal, apply_norm, cdt, dt, init_norm, init_stacked,
                     layer_of)

N_GROUPS = 1  # single B/C group (mamba2-1.3b default)


def init_block(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    D, d_in, H, N, K = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state, cfg.conv_width
    conv_dim = d_in + 2 * N_GROUPS * N
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    f32 = dict(dtype=torch.float32, device=device)
    # dt bias: softplus^-1 of dt log-uniform in [1e-3, 1e-1] (mamba2 default)
    u = torch.rand((H,), generator=gen, **f32)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": _normal(gen, (D, 2 * d_in + 2 * N_GROUPS * N + H), 0.02, dt(cfg), device),
        "conv_w": _normal(gen, (K, conv_dim), 0.02, dt(cfg), device),
        "conv_b": torch.zeros((conv_dim,), dtype=dt(cfg), device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
        "d_skip": torch.ones((H,), **f32),
        "out_norm": torch.ones((d_in,), dtype=dt(cfg), device=device),
        "out_proj": _normal(gen, (d_in, D), out_scale, dt(cfg), device),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    return {"blocks": init_stacked(cfg.n_layers, lambda: init_block(cfg, gen, device)),
            "norms": init_stacked(cfg.n_layers, lambda: init_norm(cfg, device))}


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N_GROUPS * N],
            proj[..., -H:])


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    d_in, N = cfg.d_inner, cfg.ssm_state
    return xbc[..., :d_in], xbc[..., d_in:d_in + N], xbc[..., d_in + N:]


def _dt(p: Params, dt_raw: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt_raw.float() + gather_weight(p["dt_bias"]).float())


def _gated_out(cfg: ModelConfig, p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm + out projection. y, z (..., d_inner)."""
    yf = y.float() * F.silu(z.float())
    ms = (yf * yf).mean(-1, keepdim=True)
    yn = yf * torch.rsqrt(ms + cfg.norm_eps) * gather_weight(p["out_norm"]).float()
    return yn.to(cdt(cfg)) @ gather_weight(p["out_proj"]).to(cdt(cfg))


def _conv_silu(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, S: int) -> torch.Tensor:
    """Depthwise causal conv of the K-1-padded xp (B, S+K-1, C) then SiLU in f32."""
    y = sum(xp[:, i:i + S] * w[i].to(xp.dtype) for i in range(w.shape[0]))
    return F.silu((y + b.to(xp.dtype)).float()).to(xp.dtype)


def _block_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block over the whole sequence. Returns (out (B,S,D), final SSD
    state (B,H,P,N) f32, conv tail (B,K-1,conv_dim) f32)."""
    B, S, _ = x.shape
    H, P, K = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.conv_width
    z, xbc, dt_raw = _split_proj(cfg, x @ gather_weight(p["in_proj"]).to(cdt(cfg)))
    conv_tail = xbc[:, -(K - 1):].float()
    xbc = _conv_silu(F.pad(xbc, (0, 0, K - 1, 0)), gather_weight(p["conv_w"]),
                     gather_weight(p["conv_b"]), S)
    xs, Bmat, Cmat = _split_xbc(cfg, xbc)
    xh = shard(xs.reshape(B, S, H, P).contiguous(), "batch", None, "ssm_heads", None)
    y, h_final = ops.ssd_scan(xh, _dt(p, dt_raw), -torch.exp(gather_weight(p["a_log"])),
                              Bmat.contiguous(), Cmat.contiguous(), chunk=cfg.ssm_chunk)
    y = y.float() + gather_weight(p["d_skip"]).float()[None, None, :, None] * xh.float()
    out = _gated_out(cfg, p, y.reshape(B, S, cfg.d_inner).to(cdt(cfg)), z)
    return shard(out, "batch", None, None), h_final, conv_tail


def _layer(cfg: ModelConfig, p_block: Params, p_norm: Params, x: torch.Tensor) -> torch.Tensor:
    return x + _block_prefill(cfg, p_block, apply_norm(cfg, p_norm, x))[0]


def forward_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all blocks over the sequence (no cache). Returns (hidden, aux 0).

    Each block runs under ``torch.utils.checkpoint`` (the JAX package's
    ``remat=True``): only its input is kept, and the backward runs the block
    again (the SSD scan's forward kernels included) to rebuild what it needs."""
    for i in range(cfg.n_layers):
        # the blocks draw no random numbers: no RNG state to replay
        x = torch.utils.checkpoint.checkpoint(_layer, cfg, layer_of(params["blocks"], i),
                                              layer_of(params["norms"], i), x,
                                              use_reentrant=False, preserve_rng_state=False)
        x = shard(x, "batch", None, None)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# =============================================================================
# Inference: recurrent state (no KV cache)
# =============================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * N_GROUPS * N
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssm": torch.zeros((cfg.n_layers, batch, H, P, N), **f32),
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, conv_dim), **f32)}


def prefill_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Params) -> Tuple[torch.Tensor, Params]:
    """Forward + fill the states (written in place). Returns (hidden, cache)."""
    for i in range(cfg.n_layers):
        out, h_final, conv_tail = _block_prefill(
            cfg, layer_of(params["blocks"], i),
            apply_norm(cfg, layer_of(params["norms"], i), x))
        cache["ssm"][i].copy_(h_final)
        cache["conv"][i].copy_(conv_tail)
        x = x + out
    return x, cache


def decode_hidden(cfg: ModelConfig, params: Params, cache: Params, x_t: torch.Tensor,
                  pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One token through all blocks. x_t (B,1,D). The states are updated in
    place and returned."""
    B = x_t.shape[0]
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    x = x_t
    for i in range(cfg.n_layers):
        p = layer_of(params["blocks"], i)
        h_in = apply_norm(cfg, layer_of(params["norms"], i), x)
        z, xbc, dt_raw = _split_proj(cfg, h_in @ gather_weight(p["in_proj"]).to(cdt(cfg)))
        conv_tail = cache["conv"][i]
        yc = _conv_silu(torch.cat([conv_tail.to(xbc.dtype), xbc], 1),
                        gather_weight(p["conv_w"]), gather_weight(p["conv_b"]), 1)
        new_tail = torch.cat([conv_tail[:, 1:], xbc.float()], 1)
        xs, Bmat, Cmat = _split_xbc(cfg, yc)
        xh = xs.reshape(B, H, P)
        y, h_new = ops.ssd_decode_step(xh, _dt(p, dt_raw)[:, 0],
                                       -torch.exp(gather_weight(p["a_log"])),
                                       Bmat[:, 0], Cmat[:, 0], cache["ssm"][i])
        y = y.float() + gather_weight(p["d_skip"]).float()[None, :, None] * xh.float()
        x = x + _gated_out(cfg, p, y.reshape(B, 1, cfg.d_inner).to(cdt(cfg)), z)
        cache["ssm"][i].copy_(h_new)
        cache["conv"][i].copy_(new_tail)
    return x, cache
