"""LM facade over every family: serving over the dense, moe, vlm, hybrid and
ssm families (the encoder prefills only: it has no decode step), training
over all six.

* ``init_params(cfg, generator, device)`` — the parameter dict (JAX layout)
* ``train_loss(cfg, params, batch)`` — scalar loss + metrics
* ``init_cache`` / ``prefill`` / ``decode_step`` — serving

Batch layouts, as in the JAX package:
  dense/moe/hybrid/ssm : {"tokens": (B,S) int, "labels": (B,S) int}
  encoder (audio stub) : {"frames": (B,S,D) float, "labels": (B,S) int}
  vlm (patch stub)     : {"tokens": (B,S_text) int, "patches": (B,P,D) float,
                          "labels": (B,S_text) int}
The VLM puts the patches before the text (early fusion), and its patch
positions carry label -100.

Init draws from the same distributions as the JAX init (normal·0.02, and
``0.02/sqrt(2·n_layers)`` for output projections) from a ``torch.Generator``;
the values differ from ``jax.random``'s. Tests copy JAX params over instead
(``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.parallel.axes import batch_axes, batch_shards, shard, sum_over
from . import mamba2, rglru, transformer
from .config import ModelConfig
from .layers import (
    Params,
    apply_norm,
    cdt,
    chunked_softmax_xent,
    embed_tokens,
    init_embedding,
    init_norm,
    logits_for,
)

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "encoder": transformer,
    "vlm": transformer,
    "hybrid": rglru,
    "ssm": mamba2,
}


def backbone(cfg: ModelConfig):
    """The family's module; a family the JAX package does not have raises."""
    if cfg.family not in _FAMILY:
        raise NotImplementedError(f"family {cfg.family!r} is not a family of the JAX "
                                  f"package; repro_torch has {sorted(_FAMILY)} (ROADMAP.md)")
    return _FAMILY[cfg.family]


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    return {
        "embed": init_embedding(cfg, generator, device),
        "backbone": backbone(cfg).init_params(cfg, generator, device),
        "final_norm": init_norm(cfg, device),
    }


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(x (B,S,D), positions (B,S), labels or None) of any batch layout
    (``src/repro/models/lm.py:60-81``): audio frames cast to the compute
    dtype; vision patches cast to the token embedding's dtype and put before
    the embedded text, with P leading -100 labels; else the embedded tokens."""
    labels = batch.get("labels")
    if cfg.frontend == "audio_frames":
        x = batch["frames"].to(cdt(cfg))
    elif cfg.frontend == "vision_patches":
        tok = embed_tokens(cfg, params["embed"], batch["tokens"])
        patches = batch["patches"].to(tok.dtype)
        x = torch.cat([patches, tok], dim=1)  # early fusion
        if labels is not None:  # patch positions carry no LM loss
            pad = torch.full(patches.shape[:2], -100, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
    else:
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return shard(x, "batch", None, None), positions, labels


def train_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy of ``batch`` against its labels (-100 ignored)
    plus the aux loss summed over the MoE layers (0 without experts), with
    per-layer recompute (``src/repro/models/lm.py:87-95``). Returns (loss,
    {loss, xent, aux, tokens}), f32 scalars.

    Under axis rules that split the batch over n > 1 ranks, ``batch`` is
    this rank's rows: the token count is the global one, the returned loss
    is this rank's share (its cross-entropy sum over the global count, plus
    1/n of the aux loss, which the MoE layers average over the mesh), whose
    gradients the param gathers sum over the ranks, and the metrics are the
    global loss, cross-entropy and aux loss."""
    x, positions, labels = _embed_inputs(cfg, params, batch)
    hidden, aux = backbone(cfg).forward_hidden(cfg, params["backbone"], x, positions)
    hidden = apply_norm(cfg, params["final_norm"], hidden)
    loss_sum, n_valid = chunked_softmax_xent(cfg, params["embed"], hidden, labels)
    rows = batch_axes()
    n_valid = torch.clamp_min(sum_over(n_valid, rows), 1.0)
    xent = loss_sum / n_valid
    n = batch_shards()
    if n == 1:
        loss = xent + aux
        return loss, {"loss": loss, "xent": xent, "aux": aux, "tokens": n_valid}
    share = xent + aux / n
    xent = sum_over(xent, rows)
    aux = aux.detach()
    return share, {"loss": xent + aux, "xent": xent, "aux": aux, "tokens": n_valid}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    return backbone(cfg).init_cache(cfg, batch, max_len, device)


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            max_len: int) -> Tuple[torch.Tensor, Params]:
    """Run the prompt (any batch layout: tokens, frames, or patches and
    tokens); returns (last-position logits (B,V), populated cache)."""
    x, positions, _ = _embed_inputs(cfg, params, batch)
    cache = init_cache(cfg, x.shape[0], max_len, x.device)
    hidden, cache = backbone(cfg).prefill_hidden(cfg, params["backbone"], x,
                                                 positions, cache, max_len)
    last = apply_norm(cfg, params["final_norm"], hidden[:, -1])
    return logits_for(cfg, params["embed"], last), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor, pos: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. token (B,) int, pos (B,) absolute position, ``max_len``
    the cache's as ``init_cache`` / ``prefill`` took it. Returns (logits
    (B,V), cache); the cache is updated in place.

    Where the rules split the KV caches' slots over ``model`` (``kv_seq``) a
    rank's cache is its share, whose whole length ``max_len`` gives, and the
    step refuses to run without it; elsewhere the caches are whole and
    ``max_len`` may be None."""
    x_t = embed_tokens(cfg, params["embed"], token[:, None])
    x_t, cache = backbone(cfg).decode_hidden(cfg, params["backbone"], cache, x_t, pos,
                                             max_len)
    h = apply_norm(cfg, params["final_norm"], x_t[:, 0])
    return logits_for(cfg, params["embed"], h), cache
