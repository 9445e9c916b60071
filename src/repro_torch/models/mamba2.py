"""Mamba-2 (SSD, state-space duality): the attention-free ssm family.

Block: in_proj → [z gate | x, B, C | dt] → depthwise causal conv over
(x, B, C) → SSD scan (``kernels.ops.ssd_scan``) → ``+ d_skip · x`` → gated
RMSNorm → out_proj. Params keep the JAX layout: ``{"blocks", "norms"}``, each
leaf stacked over layers; ``a_log``, ``dt_bias`` and ``d_skip`` stay f32 in a
bf16 model. The serve state is ``{"ssm" (L,B,H,P,N) f32, "conv" (L,B,K-1,
conv_dim) f32}``, written in place by prefill and decode.

Where the active rules split ``ssm_heads`` over ``model`` (``axes.tp_split``:
the single- and multi-pod rules, a model axis m > 1 that divides H), each
block runs tensor-parallel over its heads: model rank r owns heads
[r·H/m, (r+1)·H/m). Its input enters through ``copy_to_model``; it reads
``in_proj`` whole (``gather_partial``: the stored ``ffn`` shard is
contiguous and does not line up with heads) and takes its heads' z and x
columns, B and C whole (one group, which every head reads) and its heads'
dt columns; the conv runs over its x columns and B and C; ``a_log``,
``dt_bias``, ``d_skip`` and ``out_norm`` are sliced to its heads; the SSD
scan runs at H/m heads; the gated RMSNorm's statistic over all of
``d_inner`` is summed over ``model`` (``axes.stat_over_model``);
``out_proj`` is row-parallel (``local_weight``: its rows are the heads'
rows in order) and the block's output is summed over ``model``
(``reduce_from_model``). The serve state then holds the rank's share:
``ssm`` (L,B,H/m,P,N) and ``conv`` (L,B,K-1,d_inner/m + 2N), its heads' x
columns, then B and C. A model axis of 1, or rules that do not split the
heads, run the whole block as without a mesh.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.axes import (copy_to_model, gather_partial, gather_weight,
                                       local_weight, reduce_from_model, shard,
                                       stat_over_model, tp_split)
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


def heads_split(cfg: ModelConfig) -> Tuple[int, int]:
    """(m, r): the model ranks that split the SSD heads and this rank's
    block; (1, 0) where the block runs whole. ``out_proj``'s rows, which the
    block reads as its model shard, must split with the heads."""
    m, r = tp_split("ssm_heads", cfg.n_ssm_heads)
    if m > 1 and tp_split("ffn", cfg.d_inner) != (m, r):
        return 1, 0
    return m, r


Spans = List[Tuple[int, int]]


def in_proj_spans(cfg: ModelConfig, m: int, r: int) -> Spans:
    """The columns of ``in_proj``, [z | x | B | C | dt], that model rank r of
    m reads, in order: its heads' z and x, B and C whole, its heads' dt."""
    d_in, bc, H = cfg.d_inner, 2 * N_GROUPS * cfg.ssm_state, cfg.n_ssm_heads
    dl, hl = d_in // m, H // m
    return [(r * dl, (r + 1) * dl), (d_in + r * dl, d_in + (r + 1) * dl),
            (2 * d_in, 2 * d_in + bc), (2 * d_in + bc + r * hl, 2 * d_in + bc + (r + 1) * hl)]


def conv_spans(cfg: ModelConfig, m: int, r: int) -> Spans:
    """The conv's channels, [x | B | C], that model rank r of m runs: its
    heads' x, then B and C whole. The serve state's ``conv`` holds these."""
    d_in, dl = cfg.d_inner, cfg.d_inner // m
    return [(r * dl, (r + 1) * dl), (d_in, d_in + 2 * N_GROUPS * cfg.ssm_state)]


def _cols(t: torch.Tensor, spans: Spans) -> torch.Tensor:
    return torch.cat([t[..., lo:hi] for lo, hi in spans], -1)


def _read(cfg: ModelConfig, p: Params) -> Tuple[Dict[str, torch.Tensor], int]:
    """The block's params as this rank runs them, and the model ranks that
    split its heads: whole (``gather_weight``) where m is 1, else the rank's
    share (see the module's note)."""
    m, r = heads_split(cfg)
    if m == 1:
        return {k: gather_weight(v) for k, v in p.items()}, 1
    hl, dl = cfg.n_ssm_heads // m, cfg.d_inner // m
    heads, xs = slice(r * hl, (r + 1) * hl), slice(r * dl, (r + 1) * dl)
    conv = conv_spans(cfg, m, r)
    return {"in_proj": _cols(gather_partial(p["in_proj"]), in_proj_spans(cfg, m, r)),
            "conv_w": _cols(gather_partial(p["conv_w"]), conv),
            "conv_b": _cols(gather_partial(p["conv_b"]), conv),
            "a_log": gather_partial(p["a_log"])[heads],
            "dt_bias": gather_partial(p["dt_bias"])[heads],
            "d_skip": gather_partial(p["d_skip"])[heads],
            "out_norm": gather_partial(p["out_norm"])[xs],
            "out_proj": local_weight(p["out_proj"])}, m


def _split_proj(cfg: ModelConfig, proj: torch.Tensor, m: int):
    """(z, xBC, dt) of the rank's in-projection (the whole one where m is 1)."""
    d_in, N, H = cfg.d_inner // m, cfg.ssm_state, cfg.n_ssm_heads // m
    return (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N_GROUPS * N],
            proj[..., -H:])


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor, m: int):
    d_in, N = cfg.d_inner // m, cfg.ssm_state
    return xbc[..., :d_in], xbc[..., d_in:d_in + N], xbc[..., d_in + N:]


def _dt(w: Params, dt_raw: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt_raw.float() + w["dt_bias"].float())


def _gated_out(cfg: ModelConfig, w: Params, y: torch.Tensor, z: torch.Tensor,
               m: int) -> torch.Tensor:
    """Gated RMSNorm + out projection. y, z (..., d_inner), the rank's
    d_inner / m columns where m > 1: the statistic then sums every rank's
    squares, and the projections are summed over ``model``."""
    yf = y.float() * F.silu(z.float())
    if m == 1:
        ms = (yf * yf).mean(-1, keepdim=True)
    else:
        ms = stat_over_model((yf * yf).sum(-1, keepdim=True)) / cfg.d_inner
    yn = yf * torch.rsqrt(ms + cfg.norm_eps) * w["out_norm"].float()
    out = yn.to(cdt(cfg)) @ w["out_proj"].to(cdt(cfg))
    return out if m == 1 else reduce_from_model(out)


def _conv_silu(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, S: int) -> torch.Tensor:
    """Depthwise causal conv of the K-1-padded xp (B, S+K-1, C) then SiLU in f32."""
    y = sum(xp[:, i:i + S] * w[i].to(xp.dtype) for i in range(w.shape[0]))
    return F.silu((y + b.to(xp.dtype)).float()).to(xp.dtype)


def _block_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block over the whole sequence. Returns (out (B,S,D), final SSD
    state (B,H,P,N) f32, conv tail (B,K-1,conv_dim) f32), the state and
    tail of the rank's heads where they split over ``model``."""
    B, S, _ = x.shape
    w, m = _read(cfg, p)
    H, P, K = cfg.n_ssm_heads // m, cfg.ssm_head_dim, cfg.conv_width
    if m > 1:
        x = copy_to_model(x)
    z, xbc, dt_raw = _split_proj(cfg, x @ w["in_proj"].to(cdt(cfg)), m)
    conv_tail = xbc[:, -(K - 1):].float()
    xbc = _conv_silu(F.pad(xbc, (0, 0, K - 1, 0)), w["conv_w"], w["conv_b"], S)
    xs, Bmat, Cmat = _split_xbc(cfg, xbc, m)
    xh = shard(xs.reshape(B, S, H, P).contiguous(), "batch", None, "ssm_heads", None)
    y, h_final = ops.ssd_scan(xh, _dt(w, dt_raw), -torch.exp(w["a_log"]),
                              Bmat.contiguous(), Cmat.contiguous(), chunk=cfg.ssm_chunk)
    y = y.float() + w["d_skip"].float()[None, None, :, None] * xh.float()
    out = _gated_out(cfg, w, y.reshape(B, S, H * P).to(cdt(cfg)), z, m)
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
    """The states of this rank's heads (all of them where the heads do not
    split over ``model``)."""
    m, _ = heads_split(cfg)
    H, P, N = cfg.n_ssm_heads // m, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner // m + 2 * N_GROUPS * N
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssm": torch.zeros((cfg.n_layers, batch, H, P, N), **f32),
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, conv_dim), **f32)}


def prefill_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Params, max_len: int
                   ) -> Tuple[torch.Tensor, Params]:
    """Forward + fill the states (written in place; ``max_len`` does not size
    them). Returns (hidden, cache)."""
    for i in range(cfg.n_layers):
        out, h_final, conv_tail = _block_prefill(
            cfg, layer_of(params["blocks"], i),
            apply_norm(cfg, layer_of(params["norms"], i), x))
        cache["ssm"][i].copy_(h_final)
        cache["conv"][i].copy_(conv_tail)
        x = x + out
    return x, cache


def decode_hidden(cfg: ModelConfig, params: Params, cache: Params, x_t: torch.Tensor,
                  pos: torch.Tensor, max_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """One token through all blocks. x_t (B,1,D); neither ``pos`` nor
    ``max_len`` is read (no KV cache). The states are updated in place and
    returned."""
    B = x_t.shape[0]
    P = cfg.ssm_head_dim
    x = x_t
    for i in range(cfg.n_layers):
        w, m = _read(cfg, layer_of(params["blocks"], i))
        H = cfg.n_ssm_heads // m
        h_in = apply_norm(cfg, layer_of(params["norms"], i), x)
        if m > 1:
            h_in = copy_to_model(h_in)
        z, xbc, dt_raw = _split_proj(cfg, h_in @ w["in_proj"].to(cdt(cfg)), m)
        conv_tail = cache["conv"][i]
        yc = _conv_silu(torch.cat([conv_tail.to(xbc.dtype), xbc], 1),
                        w["conv_w"], w["conv_b"], 1)
        new_tail = torch.cat([conv_tail[:, 1:], xbc.float()], 1)
        xs, Bmat, Cmat = _split_xbc(cfg, yc, m)
        xh = xs.reshape(B, H, P)
        y, h_new = ops.ssd_decode_step(xh, _dt(w, dt_raw)[:, 0], -torch.exp(w["a_log"]),
                                       Bmat[:, 0], Cmat[:, 0], cache["ssm"][i])
        y = y.float() + w["d_skip"].float()[None, :, None] * xh.float()
        x = x + _gated_out(cfg, w, y.reshape(B, 1, H * P).to(cdt(cfg)), z, m)
        cache["ssm"][i].copy_(h_new)
        cache["conv"][i].copy_(new_tail)
    return x, cache

