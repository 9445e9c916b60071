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
decode write them in place. Where the rules split a cache's slots over
``model`` (``kv_seq``), a rank's ring holds its C/m slots of every kv head
(``layers.kv_cache_shape``).

Where the active rules split ``ffn`` over ``model`` (``axes.tp_split``, a
model axis m > 1 that divides W) and m divides the 8 gate blocks or they
divide m, each RG-LRU block runs tensor-parallel over its width: model rank
r owns the W/m columns [r·W/m, (r+1)·W/m) of the recurrence. Its input
enters through ``copy_to_model``; ``w_gate``, ``b_a``, ``b_i``, ``lam``
and ``w_out`` are read as its columns (``w_out`` by rows, and the output
is summed over ``model``, ``reduce_from_model``); the scan runs at (B, S,
W/m). The gates are block-diagonal, a gate column reading every input
column of its block: where m <= 8 the rank's columns are whole blocks, and
it takes its blocks of ``w_a`` and ``w_i``; where m > 8 a block straddles
m / 8 ranks, and each of them computes ``w_x``'s columns of the whole block
and their conv (that product m / 8 times over, no collective) and its own
columns of the gates. The serve state holds the rank's share: ``h``
(…, B, W/m) and ``conv`` the columns whose conv it computes, W/m or its
whole block. Attention layers and the MLPs split as ``models/layers.py``
splits them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.parallel.axes import (copy_to_model, gather_partial, gather_weight,
                                       local_weight, reduce_from_model, shard, tp_split)
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
    kv_cache_shape,
    layer_of,
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
    """x (..., nb·kb) times the block-diagonal w (nb, kb, kj) → (..., nb·kj):
    kj is kb for whole blocks, or a rank's columns of one block."""
    nb, kb, _ = w.shape
    y = torch.einsum("...nk,nkj->...nj", x.reshape(*x.shape[:-1], nb, kb), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], -1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence. x (B,S,W), w (K,W); ``tail``
    (B,K-1,W) is the carried context of earlier tokens (decode)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)) if tail is None else torch.cat([tail.to(x.dtype), x], 1)
    return sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K)) + b.to(x.dtype)


class WidthShare(NamedTuple):
    """A model rank's share of the RG-LRU's width W: the columns of the
    recurrence it owns, and those whose input projection and conv it
    computes (the same, or its whole gate block where blocks straddle
    ranks); [lo, hi) of W each."""

    own: Tuple[int, int]
    conv: Tuple[int, int]


def width_share(cfg: ModelConfig) -> Optional[WidthShare]:
    """This rank's share of the width where the RG-LRU blocks split over
    ``model``; None where they run whole."""
    W = cfg.lru_width
    m, r = tp_split("ffn", W)
    if m == 1 or (N_DIAG_BLOCKS % m and m % N_DIAG_BLOCKS):
        return None
    w = W // m
    own = (r * w, (r + 1) * w)
    if m <= N_DIAG_BLOCKS:
        return WidthShare(own, own)
    kb = W // N_DIAG_BLOCKS
    b = own[0] // kb
    return WidthShare(own, (b * kb, (b + 1) * kb))


def _read(cfg: ModelConfig, p: Params, share: Optional[WidthShare]) -> Params:
    """The block's params as this rank runs them: whole
    (``gather_weight``) where ``share`` is None, else its share (see the
    module's note)."""
    if share is None:
        return {k: gather_weight(v) for k, v in p.items()}
    (o0, o1), (c0, c1) = share
    kb = cfg.lru_width // N_DIAG_BLOCKS
    blocks = (slice(c0 // kb, c1 // kb), slice(None), slice(o0 - c0, o1 - c0))
    return {"w_x": (local_weight(p["w_x"]) if share.own == share.conv
                    else gather_partial(p["w_x"])[:, c0:c1]),
            "w_gate": local_weight(p["w_gate"]),
            "conv_w": gather_partial(p["conv_w"])[:, c0:c1],
            "conv_b": gather_partial(p["conv_b"])[c0:c1],
            "w_a": gather_partial(p["w_a"])[blocks],
            "w_i": gather_partial(p["w_i"])[blocks],
            **{k: gather_partial(p[k])[o0:o1] for k in ("b_a", "b_i", "lam")},
            "w_out": local_weight(p["w_out"])}


def _rglru_gates(w: Params, xc: torch.Tensor, share: Optional[WidthShare]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (a_log (B,S,W) <= 0, gated input (B,S,W)), both f32; of the
    rank's own columns where ``share`` is given (``xc`` is then the conv
    output of its conv columns)."""
    r = torch.sigmoid(_block_diag_matmul(xc, w["w_a"]).float() + w["b_a"].float())
    i = torch.sigmoid(_block_diag_matmul(xc, w["w_i"]).float() + w["b_i"].float())
    a_log = -C_RGLRU * F.softplus(w["lam"]) * r
    if share is not None and share.own != share.conv:
        c0 = share.conv[0]
        xc = xc[..., share.own[0] - c0:share.own[1] - c0]
    return a_log, i * xc.float()


def _rglru_mix(cfg: ModelConfig, p: Params, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU mixing. x (B,S,D) → (out (B,S,D), last state
    (B,W) in the compute dtype, conv input xb (B,S,W)); of the rank's
    columns where the width splits over ``model`` (``width_share``)."""
    c = cdt(cfg)
    share = width_share(cfg)
    w = _read(cfg, p, share)
    if share is not None:
        x = copy_to_model(x)
    gate = _gelu((x @ w["w_gate"].to(c)).float())
    xb = shard(x @ w["w_x"].to(c), "batch", None, "ffn")
    xc = _causal_conv(xb, w["conv_w"], w["conv_b"])
    a_log, gated = _rglru_gates(w, xc, share)
    hs, h_last = ops.rglru_scan(gated.to(c), a_log)
    out = (hs.float() * gate).to(c) @ w["w_out"].to(c)
    if share is not None:
        out = reduce_from_model(out)
    return shard(out, "batch", None, None), h_last, xb


def apply_rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence RG-LRU mixing. x (B,S,D) → (B,S,D)."""
    return _rglru_mix(cfg, p, x)[0]


def rglru_block_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                       state: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token RG-LRU step. x_t (B,1,D); state {h (B,W) f32, conv (B,K-1,W)
    f32}, the rank's share where the width splits. Returns (out (B,1,D),
    the new state)."""
    c = cdt(cfg)
    share = width_share(cfg)
    w = _read(cfg, p, share)
    if share is not None:
        x_t = copy_to_model(x_t)
    gate = _gelu((x_t @ w["w_gate"].to(c)).float())
    xb = x_t @ w["w_x"].to(c)
    xc = _causal_conv(xb, w["conv_w"], w["conv_b"], tail=state["conv"])
    new_conv = torch.cat([state["conv"][:, 1:], xb.float()], 1)
    a_log, gated = _rglru_gates(w, xc, share)
    h = ops.rglru_decode_step(gated[:, 0], a_log[:, 0], state["h"])
    out = (h[:, None].float() * gate).to(c) @ w["w_out"].to(c)
    if share is not None:
        out = reduce_from_model(out)
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

def cache_slots(cfg: ModelConfig, max_len: int) -> int:
    """The slots of an attention layer's ring cache for ``max_len`` tokens."""
    return min(max_len, cfg.window) if cfg.window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    """The caches and states of this rank's share (``width_share``, and the
    kv heads its q heads read or its slots of every kv head,
    ``layers.kv_cache_shape``), or whole where nothing splits."""
    slots, heads = kv_cache_shape(cfg, cache_slots(cfg, max_len))
    K = cfg.conv_width
    share = width_share(cfg)
    W = W_conv = cfg.lru_width
    if share is not None:
        W, W_conv = share.own[1] - share.own[0], share.conv[1] - share.conv[0]

    def state(lead: Tuple[int, ...], kind: str) -> Dict[str, Any]:
        if kind == "attn":
            shape = (*lead, batch, slots, heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dt(cfg), device=device),
                    "v": torch.zeros(shape, dtype=dt(cfg), device=device)}
        f32 = dict(dtype=torch.float32, device=device)
        return {"h": torch.zeros((*lead, batch, W), **f32),
                "conv": torch.zeros((*lead, batch, K - 1, W_conv), **f32)}

    return {"units": [state((_n_units(cfg),), kind) for kind in cfg.block_pattern],
            "tail": [state((), kind) for kind in _tail_kinds(cfg)]}


def prefill_hidden(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Params, max_len: int
                   ) -> Tuple[torch.Tensor, Params]:
    """Forward + fill the caches and states of ``max_len`` tokens (written
    in place)."""
    K, C = cfg.conv_width, cache_slots(cfg, max_len)
    for kind, p, c in _layers(cfg, params, cache):
        h_in = apply_norm(cfg, p["mix_norm"], x)
        if kind == "attn":
            h, k, v = apply_attention_prefill(cfg, p["attn"], h_in, positions, C,
                                              window_override=cfg.window)
            c["k"].copy_(k)
            c["v"].copy_(v)
        else:
            h, h_last, xb = _rglru_mix(cfg, p["rglru"], h_in)
            c["h"].copy_(h_last)
            c["conv"].copy_(xb[:, -(K - 1):])  # the conv input, before the conv
        x = _mlp_residual(cfg, p, x + h)
    return x, cache


def decode_hidden(cfg: ModelConfig, params: Params, cache: Params, x_t: torch.Tensor,
                  pos: torch.Tensor, max_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """One token through all layers. x_t (B,1,D), pos (B,), ``max_len`` the
    caches' as ``init_cache`` took it (None: the caches are whole). The
    caches and states are updated in place and returned."""
    C = None if max_len is None else cache_slots(cfg, max_len)
    x = x_t
    for kind, p, c in _layers(cfg, params, cache):
        h_in = apply_norm(cfg, p["mix_norm"], x)
        if kind == "attn":
            h, _, _ = apply_attention_decode(cfg, p["attn"], h_in, pos, c["k"], c["v"], C)
        else:
            h, new = rglru_block_decode(cfg, p["rglru"], h_in, c)
            c["h"].copy_(new["h"])
            c["conv"].copy_(new["conv"])
        x = _mlp_residual(cfg, p, x + h)
    return x, cache
