"""Plain PyTorch versions of the kernels: attention, the Mamba-2 SSD scan
and the RG-LRU scan.

The attention functions compute what ``repro.kernels.ref`` computes, in f32,
materialising the whole score matrix. ``ssd_scan`` is the JAX package's
chunked form (``repro.kernels.ops.ssd_scan``), ``ssd_sequential`` its
sequential oracle, and ``rglru_scan`` a sequential f32 loop. The CPU takes
them in ``ops``; on the card they are what ``chip_smoke.py`` holds each CUDA
kernel against. ``calls`` counts every call so a run can show that serving
did not use them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, *, chunk: int, h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba-2 SSD. x (B,S,H,P), dt (B,S,H) > 0, A (H,) < 0, Bmat and
    Cmat (B,S,N) (one group), h0 (B,H,P,N) or None → (y (B,S,H,P) in x's
    dtype, final state (B,H,P,N) f32). Any S: the tail is padded with dt = 0
    rows, which leave the state as it is. A bf16 x rounds the dot inputs to
    bf16 as the JAX package does; sums and decays stay f32."""
    global calls
    calls += 1
    Bb, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtf = dt.float().reshape(Bb, nc, Q, H)
    Bf = Bmat.float().reshape(Bb, nc, Q, N)
    Cf = Cmat.float().reshape(Bb, nc, Q, N)
    if x.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t

    dA = dtf * A.float()                                   # (B, nc, Q, H)
    xdt = xf * dtf[..., None]
    cs = dA.cumsum(2)
    csh = cs.transpose(2, 3)                               # (B, nc, H, Q)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp((csh[..., :, None] - csh[..., None, :]).masked_fill(~tri, float("-inf")))
    scores = torch.einsum("bcqn,bckn->bcqk", rnd(Cf), rnd(Bf))
    w = rnd(L * scores[:, :, None])                        # (B, nc, H, Q, Q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w, rnd(xdt))

    decay_to_end = torch.exp(cs[:, :, -1:] - cs)           # (B, nc, Q, H)
    s_chunk = torch.einsum("bcqn,bcqhp->bchpn", rnd(Bf), rnd(xdt * decay_to_end[..., None]))
    chunk_decay = torch.exp(cs[:, :, -1])                  # (B, nc, H)
    h = (h0.float() if h0 is not None
         else torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device))
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = chunk_decay[:, c, :, None, None] * h + s_chunk[:, c]
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cf, torch.exp(cs),
                           torch.stack(h_enter, 1))
    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :S].to(x.dtype)
    return y, h


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bmat: torch.Tensor, Cmat: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD oracle, one step at a time in f32: h_t = exp(A dt_t) h_{t-1} +
    dt_t x_t ⊗ B_t, y_t = h_t · C_t. Returns (y in x's dtype, final state f32)."""
    global calls
    calls += 1
    Bb, S, H, P = x.shape
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), Bmat.float(), Cmat.float(), A.float()
    h = (h0.float() if h0 is not None
         else torch.zeros((Bb, H, P, Bmat.shape[-1]), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(S):
        decay = torch.exp(Af * dtf[:, t])                  # (B, H)
        update = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) * Bf[:, t, None, None, :]
        h = decay[..., None, None] * h + update
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, 1).to(x.dtype), h


def rglru_scan(x: torch.Tensor, a_log: torch.Tensor, *,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU recurrence h_t = a_t h_{t-1} + sqrt(max(1 - a_t², 1e-12)) x_t with
    a = exp(a_log), sequential in f32. x, a_log (B,S,W), h0 (B,W) or None →
    (y (B,S,W), h_last (B,W)), both in x's dtype."""
    global calls
    calls += 1
    a = torch.exp(a_log.float())
    g = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * x.float()
    h = (h0.float() if h0 is not None
         else torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + g[:, t]
        ys.append(h)
    return torch.stack(ys, 1).to(x.dtype), h.to(x.dtype)
