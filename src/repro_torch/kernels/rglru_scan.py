"""Wrapper of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

Replaces ``src/repro/kernels/rglru_scan.py:46`` (``rglru_scan_pallas``).
What bounds the kernel on the H100 and what its design does about it is in
the note at the top of the CUDA source. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

launches = 0


def _fn():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def rglru_scan_cuda(x: torch.Tensor, a_log: torch.Tensor, *,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,W) f32 or bf16, a_log (B,S,W) f32, h0 (B,W) f32 or None, on one
    CUDA device → (y (B,S,W), h_last (B,W)) in x's dtype."""
    global launches
    ts = (x, a_log) + ((h0,) if h0 is not None else ())
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"rglru_scan_cuda needs x, a_log and h0 on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if x.dtype not in _build.DTYPE_CODES or a_log.dtype != torch.float32 or (
            h0 is not None and h0.dtype != torch.float32):
        raise TypeError(f"rglru_scan_cuda takes f32 or bf16 x with f32 a_log and h0, "
                        f"got {[t.dtype for t in ts]}")
    if x.dim() != 3 or a_log.shape != x.shape or (
            h0 is not None and tuple(h0.shape) != (x.shape[0], x.shape[2])):
        raise ValueError(f"bad shapes x {tuple(x.shape)} a_log {tuple(a_log.shape)} "
                         f"h0 {None if h0 is None else tuple(h0.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rglru_scan_cuda needs contiguous inputs")
    B, S, W = x.shape
    if S == 0 or B > 65535:
        raise ValueError(f"rglru_scan_cuda takes 1 or more steps and at most 65535 "
                         f"batch rows, got S {S}, B {B}")
    _build.refuse_grad("rglru_scan_cuda", *ts)
    y = torch.empty_like(x)
    h_last = torch.empty((B, W), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y, h_last
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), a_log.data_ptr(), h0.data_ptr() if h0 is not None else None,
                 y.data_ptr(), h_last.data_ptr(), B, S, W, _build.DTYPE_CODES[x.dtype],
                 stream)
    launches += 1
    _build.check(lib, "rglru_scan", err)
    return y, h_last
