"""Plain Mamba-2 (SSD) language model, from the Mamba-2 paper (Dao and Gu,
arXiv:2405.21060, section 6 and its listing of the chunked SSD).

Block, pre-norm with a residual: RMSNorm → in_proj → [z | x, B, C | dt];
a depthwise causal conv of width K over (x, B, C), then SiLU; dt =
softplus(dt + dt_bias); A = -exp(a_log); the SSD recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ, y_t = h_t C_t (one B/C group,
every head reads it); y + D·x; the gated RMSNorm of y·silu(z) over the
inner width; out_proj. Tied embeddings; a final RMSNorm.

Parameter layout (stacked over layers): ``embed/tok (V, D)``;
``backbone/blocks/{in_proj (L, D, 2·d_in + 2N + H), conv_w (L, K, d_in +
2N), conv_b, a_log (L, H), dt_bias, d_skip, out_norm (L, d_in), out_proj
(L, d_in, D)}``; ``backbone/norms/scale (L, D)``; ``final_norm/scale``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Draw, Precision, f32, layer, rms_norm


def dims(model: dict):
    D = model["d_model"]
    d_in = model["ssm_expand"] * D
    P, N, K = model["ssm_head_dim"], model["ssm_state"], model["conv_width"]
    return D, d_in, d_in // P, P, N, K


def make_params(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Random weights from ``seed``: normal(0, 0.02) projections and
    embedding, out_proj at 0.02 / sqrt(2 L), dt_bias the inverse softplus of
    dt log-uniform in [1e-3, 1e-1], a_log = log(1..16), D = 1, unit norms."""
    L, V = model["n_layers"], model["vocab_size"]
    D, d_in, H, P, N, K = dims(model)
    draw = Draw(seed, device, dtype)
    tok = draw.normal((V, D), 0.02)
    in_proj = draw.normal((L, D, 2 * d_in + 2 * N + H), 0.02)
    conv_w = draw.normal((L, K, d_in + 2 * N), 0.02)
    out_proj = draw.normal((L, d_in, D), 0.02 / math.sqrt(2 * L))
    u = draw.uniform((L, H))
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=draw.device))
    return {
        "embed": {"tok": tok},
        "backbone": {
            "blocks": {"in_proj": in_proj, "conv_w": conv_w,
                       "conv_b": draw.full((L, d_in + 2 * N), 0.0),
                       "a_log": a_log.expand(L, H).contiguous(),
                       "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
                       "d_skip": draw.full((L, H), 1.0, torch.float32),
                       "out_norm": draw.full((L, d_in), 1.0), "out_proj": out_proj},
            "norms": {"scale": draw.full((L, D), 1.0)}},
        "final_norm": {"scale": draw.full((D,), 1.0)},
    }


def ssd(x, dt, A, Bm, Cm, chunk: int, prec: Precision = None):
    """The chunked SSD: x (B,S,H,P), dt (B,S,H), A (H,), Bm and Cm (B,S,N),
    all float32, zero initial state → y (B,S,H,P). Exact for any chunk.
    ``prec`` rounds the operands of its products (x·dt, B, C), as the
    control rounds every other product's."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:  # dt = 0 rows leave the state as it is and add nothing
        x, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xdt = (x * dt[..., None]).reshape(b, nc, Q, H, P)
    cs = (dt * A).reshape(b, nc, Q, H).permute(0, 3, 1, 2).cumsum(-1)   # (b, H, nc, Q)
    Bc, Cc = Bm.reshape(b, nc, Q, N), Cm.reshape(b, nc, Q, N)
    if prec is not None:
        xdt, Bc, Cc = (prec.operand(t) for t in (xdt, Bc, Cc))
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(~tri, float("-inf")))
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y = torch.einsum("bhcqk,bckhp->bcqhp", decay * scores[:, None], xdt)
    # each chunk's own state, and the states carried into each chunk
    to_end = torch.exp(cs[..., -1:] - cs)                                 # (b, H, nc, Q)
    own = torch.einsum("bckn,bckhp->bchpn", Bc, xdt * to_end.permute(0, 2, 3, 1)[..., None])
    carried, h = [], torch.zeros_like(own[:, 0])
    for c in range(nc):
        carried.append(h)
        h = h * torch.exp(cs[:, :, c, -1])[..., None, None] + own[:, c]
    carried = torch.stack(carried, 1)                                     # (b, nc, H, P, N)
    y = y + (torch.einsum("bcqn,bchpn->bcqhp", Cc, carried)
             * torch.exp(cs).permute(0, 2, 3, 1)[..., None])
    return y.reshape(b, nc * Q, H, P)[:, :S]


def embed(model: dict, params: dict, batch: dict, prec: Precision) -> torch.Tensor:
    return f32(params["embed"]["tok"])[batch["tokens"].long()]


def _block(model: dict, p: dict, scale: torch.Tensor, x: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    D, d_in, H, P, N, K = dims(model)
    b, S, _ = x.shape
    proj = prec.mm(rms_norm(x, scale, model["norm_eps"]), f32(p["in_proj"]))
    z, xbc, dt = proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N], proj[..., -H:]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    w = f32(p["conv_w"])
    xbc = F.silu(sum(xp[:, i:i + S] * w[i] for i in range(K)) + f32(p["conv_b"]))
    xs, Bm, Cm = xbc[..., :d_in], xbc[..., d_in:d_in + N], xbc[..., d_in + N:]
    dt = F.softplus(dt + f32(p["dt_bias"]))
    xh = xs.reshape(b, S, H, P)
    y = ssd(xh, dt, -torch.exp(f32(p["a_log"])), Bm, Cm, model["ssm_chunk"], prec)
    y = (y + f32(p["d_skip"])[:, None] * xh).reshape(b, S, d_in) * F.silu(z)
    y = rms_norm(y, p["out_norm"], model["norm_eps"])
    return x + prec.mm(y, f32(p["out_proj"]))


def block(model: dict, params: dict, i: int, x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    bb = params["backbone"]
    return _block(model, layer(bb["blocks"], i), bb["norms"]["scale"][i], x, prec)


def final_norm(model: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"]["scale"], model["norm_eps"])


def unembed(model: dict, params: dict) -> torch.Tensor:
    return params["embed"]["tok"]
