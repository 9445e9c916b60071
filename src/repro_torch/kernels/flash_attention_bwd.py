"""Wrapper of the CUDA flash-attention backward kernel
(``csrc/flash_attention_bwd.cu``).

The gradient of ``src/repro/kernels/flash_attention.py:92``
(``flash_attention_pallas``), which the JAX package takes through its chunked
path instead of a kernel. What bounds the kernel on the H100 and what its
design does about it is in the note at the top of the CUDA source.
``launches`` counts calls, each of which launches the source's three kernels
(row dots, dK/dV, dQ).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

launches = 0

# past 128 the bf16 body splits dK, dV and dQ over the grid (see the CUDA source)
MAX_HEAD_DIM = 256


def _fn():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: int, q_offset: int,
                             softmax_scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of flash attention, in q's dtype, from the
    forward's inputs, its output ``out`` and logsumexp ``lse`` (B,H,Sq) f32,
    and the output's gradient ``dout``."""
    global launches
    from .flash_attention import check_aligned, check_inputs
    check_inputs("flash_attention_bwd_cuda", q, k, v, MAX_HEAD_DIM)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype
            or dout.dtype != q.dtype or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype}, dout {tuple(dout.shape)} "
                         f"{dout.dtype} and lse {tuple(lse.shape)} {lse.dtype} do not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if any(t.device != q.device or not t.is_contiguous() for t in (out, lse, dout)):
        raise ValueError("flash_attention_bwd_cuda needs out, lse and dout contiguous "
                         "on q's device")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_bwd_cuda takes at most 65535 batch rows and "
                         f"heads, got {B}, {H}")
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if Skv == 0 or q.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    check_aligned("flash_attention_bwd_cuda", q=q, k=k, v=v, out=out, dout=dout)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib, fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, Sq, Skv, H, Hkv, Dh, int(causal), int(window),
                 int(q_offset), float(softmax_scale), _build.DTYPE_CODES[q.dtype], stream)
    launches += 1
    _build.check(lib, "flash_attention_bwd", err)
    return dq, dk, dv
