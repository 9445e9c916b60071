"""Serve step functions: prefill and greedy decode.

PyTorch runs eagerly, so these are plain closures where the JAX package
builds functions for ``jax.jit``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, token, pos):
        logits, cache = lm.decode_step(cfg, params, cache, token, pos)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache
    return decode_step
