"""Plain pre-norm transformer encoder over audio frames (HuBERT X-Large's
encoder, arXiv:2106.07447, with the frames entering at the model width).

Layer: x + Wo·attn(rope(Wq·LN(x)), rope(Wk·LN(x)), Wv·LN(x)), bidirectional
softmax attention at scale Dh^-1/2, then x + W_down·gelu(W_up·LN(x) + b_up)
+ b_down, GELU in its tanh form. RoPE at positions 0..S-1 (split halves).
A final LayerNorm and an untied output layer over the targets.

Parameter layout (stacked over layers): ``embed/{tok, unembed} (V, D)``
(``tok`` is never read: the inputs are frames, not tokens);
``backbone/units/0/{attn_norm, mlp_norm}/{scale, bias} (L, D)``,
``attn/{wq, wk, wv} (L, D, H, Dh)``, ``attn/wo (L, H, Dh, D)``,
``mlp/{w_up (L, D, F), b_up (L, F), w_down (L, F, D), b_down (L, D)}``;
``final_norm/{scale, bias}``.
"""
from __future__ import annotations

import math

import torch

from .common import Draw, Precision, f32, gelu_tanh, layer, layer_norm, rope

ROWS = 512  # query rows a block of the attention scores takes


def dims(model: dict):
    D, H = model["d_model"], model["n_heads"]
    Dh = model.get("head_dim") or D // H
    return D, H, model["n_kv_heads"], Dh, model["d_ff"]


def make_params(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Random weights from ``seed``: normal(0, 0.02) projections and token
    table, the output projections at 0.02 / sqrt(2 L), the output layer at
    D^-1/2, unit norm scales and zero biases."""
    L, V = model["n_layers"], model["vocab_size"]
    D, H, Hkv, Dh, Fd = dims(model)
    draw = Draw(seed, device, dtype)
    out = 0.02 / math.sqrt(2 * L)
    tok = draw.normal((V, D), 0.02)
    unembed = draw.normal((V, D), 1.0 / math.sqrt(D))
    attn = {"wq": draw.normal((L, D, H, Dh), 0.02), "wk": draw.normal((L, D, Hkv, Dh), 0.02),
            "wv": draw.normal((L, D, Hkv, Dh), 0.02), "wo": draw.normal((L, H, Dh, D), out)}
    mlp = {"w_up": draw.normal((L, D, Fd), 0.02), "b_up": draw.full((L, Fd), 0.0),
           "w_down": draw.normal((L, Fd, D), out), "b_down": draw.full((L, D), 0.0)}

    def ln(*lead):
        return {"scale": draw.full((*lead, D), 1.0), "bias": draw.full((*lead, D), 0.0)}
    return {"embed": {"tok": tok, "unembed": unembed},
            "backbone": {"units": [{"attn_norm": ln(L), "attn": attn, "mlp_norm": ln(L),
                                    "mlp": mlp}]},
            "final_norm": ln()}


def embed(model: dict, params: dict, batch: dict, prec: Precision) -> torch.Tensor:
    return f32(batch["frames"])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              prec: Precision) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(Dh)) v over (B, S, H, Dh), in blocks of query rows."""
    S, Dh = q.shape[1], q.shape[-1]
    kt, vt = k.permute(0, 2, 3, 1), v.transpose(1, 2)      # (B, H, Dh, S), (B, H, S, Dh)
    out = []
    for r0 in range(0, S, ROWS):
        qr = q[:, r0:r0 + ROWS].transpose(1, 2)             # (B, H, r, Dh)
        s = prec.mm(qr, kt) / math.sqrt(Dh)
        if causal:
            rows = torch.arange(r0, r0 + qr.shape[2], device=q.device)[:, None]
            s = s.masked_fill(torch.arange(S, device=q.device)[None] > rows, float("-inf"))
        out.append(prec.mm(torch.softmax(s, -1), vt))
    return torch.cat(out, 2).transpose(1, 2)


def _layer(model: dict, p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    D, H, Hkv, Dh, _ = dims(model)
    b, S, _ = x.shape
    eps, theta = model["norm_eps"], model["rope_theta"]
    h = layer_norm(x, p["attn_norm"]["scale"], p["attn_norm"]["bias"], eps)
    a = p["attn"]
    q = rope(prec.mm(h, f32(a["wq"]).reshape(D, H * Dh)).reshape(b, S, H, Dh), theta)
    k = rope(prec.mm(h, f32(a["wk"]).reshape(D, Hkv * Dh)).reshape(b, S, Hkv, Dh), theta)
    v = prec.mm(h, f32(a["wv"]).reshape(D, Hkv * Dh)).reshape(b, S, Hkv, Dh)
    if Hkv != H:
        k, v = (t.repeat_interleave(H // Hkv, dim=2) for t in (k, v))
    o = attention(q, k, v, bool(model["causal"]), prec).reshape(b, S, H * Dh)
    x = x + prec.mm(o, f32(a["wo"]).reshape(H * Dh, D))
    h = layer_norm(x, p["mlp_norm"]["scale"], p["mlp_norm"]["bias"], eps)
    m = p["mlp"]
    u = gelu_tanh(prec.mm(h, f32(m["w_up"])) + f32(m["b_up"]))
    return x + prec.mm(u, f32(m["w_down"])) + f32(m["b_down"])


def block(model: dict, params: dict, i: int, x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    return _layer(model, layer(params["backbone"]["units"][0], i), x, prec)


def final_norm(model: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    p = params["final_norm"]
    return layer_norm(x, p["scale"], p["bias"], model["norm_eps"])


def unembed(model: dict, params: dict) -> torch.Tensor:
    return params["embed"]["unembed"]
