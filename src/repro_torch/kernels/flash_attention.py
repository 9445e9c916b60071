"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``)
and its gradient.

Replaces ``src/repro/kernels/flash_attention.py:92`` (``flash_attention_pallas``).
What bounds the kernel on the H100 and what its design does about it is in
the note at the top of the CUDA source. ``launches`` counts forward-kernel
launches.

When autograd needs a gradient (grad mode on and an input that requires
grad), the call goes through ``FlashAttention``, an ``autograd.Function``
whose forward also writes the logsumexp and whose backward is the CUDA
backward kernel (``flash_attention_bwd.py``). Otherwise the forward runs
alone, without the logsumexp.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .flash_attention_bwd import flash_attention_bwd_cuda

launches = 0


def _fn():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def check_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 max_head_dim: int) -> None:
    """Raise on what the forward and backward kernels do not take."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{name} needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if Dh % 16 or not 16 <= Dh <= max_head_dim:
        raise ValueError(f"{name} takes head_dim a multiple of 16 in [16, "
                         f"{max_head_dim}], got {Dh}"
                         + ("" if max_head_dim >= 256 else
                            " (larger head dims need the redesign ROADMAP.md lists)"))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous q, k, v")


def check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless each bf16 tensor starts on a 16-byte boundary: the bf16
    bodies move rows with 16-byte cp.async; the f32 bodies have no such need."""
    for tname, t in tensors.items():
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} needs {tname} to start on a 16-byte boundary, "
                             f"got address {t.data_ptr():#x}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
             window: int, q_offset: int, softmax_scale: float, with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    global launches
    check_inputs("flash_attention_cuda", q, k, v, 256)
    B, Sq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    check_aligned("flash_attention_cuda", q=q, k=k, v=v)
    lib, fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if lse is not None else None,
                 B, Sq, k.shape[1], H, k.shape[2], q.shape[3], int(causal), int(window),
                 int(q_offset), float(softmax_scale), _build.DTYPE_CODES[q.dtype], stream)
    launches += 1
    _build.check(lib, "flash_attention", err)
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with the CUDA backward kernel as its gradient. The
    forward saves q, k, v, the output and the logsumexp; the backward
    recomputes the softmax from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softmax_scale):
        out, lse = _forward(q, k, v, causal=causal, window=window, q_offset=q_offset,
                            softmax_scale=softmax_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset, softmax_scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, scale = ctx.mask
        dout = dout.contiguous()
        if dout.dtype == torch.bfloat16 and dout.data_ptr() % 16:
            dout = dout.clone()  # a view into another buffer: bf16 rows move 16 bytes at a time
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, dout, causal=causal, window=window,
            q_offset=q_offset, softmax_scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, window: int, q_offset: int,
                         softmax_scale: float) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Skv,Hkv,Dh) on one CUDA device → (B,Sq,H,Dh),
    differentiable through the backward kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset, softmax_scale)
    return _forward(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    softmax_scale=softmax_scale, with_lse=False)[0]
