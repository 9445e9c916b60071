"""Kernel entry points of the port; the path follows the tensor's device.

* a CPU tensor takes the plain PyTorch version (``ref``);
* a CUDA tensor takes the hand-written Hopper kernel, or the call raises;
* any other device raises.

There is no switch that picks another path and no fallback between them.
``ssd_decode_step`` and ``rglru_decode_step`` are plain PyTorch on both
devices, as they are plain jnp (no Pallas kernel) in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .burst_gather import burst_gather_cuda
from .decode_attention import decode_attention_cuda
from .epoch_pass import epoch_pass_cuda
from .flash_attention import flash_attention_cuda
from .rglru_scan import rglru_scan_cuda
from .ssd_scan import ssd_scan_cuda


def _device_type(*ts: torch.Tensor) -> str:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1:
        raise ValueError(f"inputs on mixed devices: {[str(t.device) for t in ts]}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch kernels run on cpu or cuda tensors, "
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
                     softmax_scale: Optional[float] = None, return_lse: bool = False):
    """Single-token attention. q (B,H,Dh), caches (B,C,Hkv,Dh), cache_len (B,)
    → (B,H,Dh); with ``return_lse`` (out, logsumexp (B,H) f32 of the scaled
    scores over the valid slots, -inf on a row with none)."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if _device_type(q, k_cache, v_cache, cache_len) == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                    softmax_scale=scale, return_lse=return_lse)
    return decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                 softmax_scale=scale, return_lse=return_lse)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, *, chunk: int = 128, h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD. x (B,S,H,P), dt (B,S,H), A (H,), Bmat/Cmat (B,S,N), h0
    (B,H,P,N) or None → (y (B,S,H,P), final state (B,H,P,N) f32)."""
    ts = (x, dt, A, Bmat, Cmat) + ((h0,) if h0 is not None else ())
    if _device_type(*ts) == "cpu":
        return ref.ssd_scan(x, dt, A, Bmat, Cmat, chunk=chunk, h0=h0)
    return ssd_scan_cuda(x, dt, A, Bmat, Cmat, chunk=chunk, h0=h0)


def ssd_decode_step(x_t: torch.Tensor, dt_t: torch.Tensor, A: torch.Tensor,
                    B_t: torch.Tensor, C_t: torch.Tensor, h: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update. x_t (B,H,P), dt_t (B,H), B_t/C_t (B,N), h
    (B,H,P,N) f32 → (y (B,H,P) in x_t's dtype, new state)."""
    dtf = dt_t.float()
    decay = torch.exp(A.float()[None] * dtf)
    update = (dtf[..., None, None] * x_t.float()[..., None]) * B_t.float()[:, None, None, :]
    h_new = decay[..., None, None] * h + update
    y = torch.einsum("bhpn,bn->bhp", h_new, C_t.float())
    return y.to(x_t.dtype), h_new


def rglru_scan(x: torch.Tensor, a_log: torch.Tensor, *,
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU scan. x, a_log (B,S,W), h0 (B,W) or None → (y (B,S,W), h_last
    (B,W)) in x's dtype."""
    ts = (x, a_log) + ((h0,) if h0 is not None else ())
    if _device_type(*ts) == "cpu":
        return ref.rglru_scan(x, a_log, h0=h0)
    return rglru_scan_cuda(x, a_log, h0=h0)


def rglru_decode_step(x_t: torch.Tensor, a_log_t: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
    """One-token RG-LRU update: (B,W) state in and out, in h's dtype."""
    a = torch.exp(a_log_t.float())
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * x_t.float()
    return (a * h.float() + b).to(h.dtype)


def burst_gather(arena: torch.Tensor, slots: torch.Tensor, lengths: torch.Tensor,
                 out_width: int) -> torch.Tensor:
    """Descriptor-driven packet gather. arena (n_slots, slot_size) uint8,
    slots and lengths (n,) integer (cast to int32, as the JAX op does) →
    (n, out_width) uint8."""
    slots, lengths = slots.to(torch.int32), lengths.to(torch.int32)
    if _device_type(arena, slots, lengths) == "cpu":
        return ref.burst_gather(arena, slots, lengths, out_width)
    return burst_gather_cuda(arena, slots.contiguous(), lengths.contiguous(), out_width)


def epoch_pass(handed: torch.Tensor, ser: torch.Tensor, busy0: int, latency: int,
               table: Optional[torch.Tensor] = None, fids: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """The simulator's epoch pass. handed, ser (n,) integer, handed
    non-decreasing; busy0, latency ints; table (n_flows,) and fids (n,)
    integer, or None (cast to int64, as ``epoch_pass_np`` casts its times) →
    (arrivals (n,) int64, busy_until int, queues (n,) int64, or None unless
    both table and fids are given)."""
    steer = table is not None and fids is not None
    ts = tuple(t.to(torch.int64).contiguous()
               for t in ((handed, ser, table, fids) if steer else (handed, ser)))
    if _device_type(*ts) == "cpu":
        return ref.epoch_pass(ts[0], ts[1], busy0, latency, *ts[2:])
    return epoch_pass_cuda(ts[0], ts[1], busy0, latency, *ts[2:])
