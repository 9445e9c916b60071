"""Plain PyTorch versions of the attention kernels.

They compute what ``repro.kernels.ref`` computes, in f32, materialising the
whole score matrix: small shapes only. The CPU takes them in ``ops``; on the
card they are what ``chip_smoke.py`` holds each CUDA kernel against.
``calls`` counts every call so a run can show that serving did not use them.
"""
from __future__ import annotations

from typing import Optional

import torch

calls = 0


def attention_mask(s_q: int, s_kv: int, *, causal: bool, window: int = 0,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_kv) boolean mask. window>0 limits lookback (sliding/local)."""
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_kv, device=device)[None, :]
    mask = torch.ones((s_q, s_kv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    return mask


def _masked_softmax(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    scores = scores.masked_fill(~valid, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.nan_to_num(p, nan=0.0)  # fully-masked rows → 0


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, q_offset: int = 0,
        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention. q (B,Sq,H,Dh), k/v (B,Skv,Hkv,Dh) → (B,Sq,H,Dh)."""
    global calls
    calls += 1
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qg = q.reshape(B, Sq, Hkv, group, Dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = attention_mask(Sq, k.shape[1], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    p = _masked_softmax(scores, mask[None, None, None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """One query token per row. q (B,H,Dh), caches (B,C,Hkv,Dh), cache_len (B,)
    valid prefix length → (B,H,Dh)."""
    global calls
    calls += 1
    B, H, Dh = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = H // Hkv
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qg = q.reshape(B, Hkv, group, Dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    valid = (torch.arange(C, device=q.device)[None]
             < cache_len.to(q.device)[:, None])  # (B, C)
    p = _masked_softmax(scores, valid[:, None, None])
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, H, Dh).to(q.dtype)
