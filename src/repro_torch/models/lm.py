"""LM facade, ``tokens`` frontend: serving over the dense, moe, hybrid and
ssm families, training over the dense, hybrid and ssm families.

* ``init_params(cfg, generator, device)`` — the parameter dict (JAX layout)
* ``train_loss(cfg, params, batch)`` — scalar loss + metrics (dense, hybrid, ssm)
* ``init_cache`` / ``prefill`` / ``decode_step`` — serving

Init draws from the same distributions as the JAX init (normal·0.02, and
``0.02/sqrt(2·n_layers)`` for output projections) from a ``torch.Generator``;
the values differ from ``jax.random``'s. Tests copy JAX params over instead
(``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import mamba2, rglru, transformer
from .config import ModelConfig
from .layers import (
    Params,
    apply_norm,
    chunked_softmax_xent,
    embed_tokens,
    init_embedding,
    init_norm,
    logits_for,
)

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "hybrid": rglru,
    "ssm": mamba2,
}


def backbone(cfg: ModelConfig):
    """The family's module; the families not ported yet raise."""
    if cfg.family not in _FAMILY:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet; "
                                  f"repro_torch serves {sorted(_FAMILY)} (ROADMAP.md)")
    return _FAMILY[cfg.family]


def _check_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported yet "
                                  "(ROADMAP.md)")


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    _check_frontend(cfg)
    return {
        "embed": init_embedding(cfg, generator, device),
        "backbone": backbone(cfg).init_params(cfg, generator, device),
        "final_norm": init_norm(cfg, device),
    }


def train_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy of ``batch`` {"tokens", "labels"} (B,S)
    (labels -100 ignored), with per-layer recompute. Returns (loss, {loss,
    xent, aux, tokens}), f32 scalars. The dense, hybrid and ssm families
    train; moe training is a later slice, and encoder and vlm are not ported
    (ROADMAP.md)."""
    _check_frontend(cfg)
    if cfg.family not in ("dense", "hybrid", "ssm"):
        raise NotImplementedError(
            f"{cfg.arch_id}: training the {cfg.family!r} family is not ported yet; "
            "repro_torch trains the dense, hybrid and ssm families (ROADMAP.md)")
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    hidden, aux = backbone(cfg).forward_hidden(cfg, params["backbone"], x, positions)
    hidden = apply_norm(cfg, params["final_norm"], hidden)
    loss_sum, n_valid = chunked_softmax_xent(cfg, params["embed"], hidden, labels)
    n_valid = torch.clamp_min(n_valid, 1.0)
    xent = loss_sum / n_valid
    loss = xent + aux
    return loss, {"loss": loss, "xent": xent, "aux": aux, "tokens": n_valid}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    return backbone(cfg).init_cache(cfg, batch, max_len, device)


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            max_len: int) -> Tuple[torch.Tensor, Params]:
    """Run the prompt ``batch["tokens"]`` (B,S); returns (last-position logits
    (B,V), populated cache)."""
    _check_frontend(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    cache = init_cache(cfg, B, max_len, x.device)
    hidden, cache = backbone(cfg).prefill_hidden(cfg, params["backbone"], x,
                                                 positions, cache)
    last = apply_norm(cfg, params["final_norm"], hidden[:, -1])
    return logits_for(cfg, params["embed"], last), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. token (B,) int, pos (B,) absolute position. Returns
    (logits (B,V), cache); the cache is updated in place."""
    x_t = embed_tokens(cfg, params["embed"], token[:, None])
    x_t, cache = backbone(cfg).decode_hidden(cfg, params["backbone"], cache, x_t, pos)
    h = apply_norm(cfg, params["final_norm"], x_t[:, 0])
    return logits_for(cfg, params["embed"], h), cache
