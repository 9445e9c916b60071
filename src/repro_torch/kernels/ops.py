"""Attention entry points of the port; the path follows the tensor's device.

* a CPU tensor takes the plain PyTorch version (``ref``);
* a CUDA tensor takes the hand-written Hopper kernel, or the call raises;
* any other device raises.

There is no switch that picks another path and no fallback between them.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .decode_attention import decode_attention_cuda
from .flash_attention import flash_attention_cuda


def _device_type(*ts: torch.Tensor) -> str:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1:
        raise ValueError(f"inputs on mixed devices: {[str(t.device) for t in ts]}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch attention runs on cpu or cuda tensors, "
                         f"not {kind!r}")
    return kind


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Train/prefill attention. q (B,Sq,H,Dh), k/v (B,Skv,Hkv,Dh) → (B,Sq,H,Dh)."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if _device_type(q, k, v) == "cpu":
        return ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset,
                       softmax_scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, softmax_scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention. q (B,H,Dh), caches (B,C,Hkv,Dh), cache_len (B,)
    → (B,H,Dh)."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if _device_type(q, k_cache, v_cache, cache_len) == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                    softmax_scale=scale)
    return decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                 softmax_scale=scale)
