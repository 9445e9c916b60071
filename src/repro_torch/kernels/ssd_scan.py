"""Wrapper of the CUDA Mamba-2 SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan.py:66`` (``ssd_scan_pallas``). What
bounds the kernel on the H100 and what its design does about it is in the
note at the top of the CUDA source. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

launches = 0

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128  # the kernel's compile-time bounds


def _fn():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
                  Cmat: torch.Tensor, *, chunk: int, h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) f32 or bf16, dt (B,S,H) f32, A (H,) f32, Bmat/Cmat (B,S,N) in
    x's dtype, h0 (B,H,P,N) f32 or None, on one CUDA device → (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) f32)."""
    global launches
    ts = (x, dt, A, Bmat, Cmat) + ((h0,) if h0 is not None else ())
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan_cuda needs every input on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if (x.dtype not in _build.DTYPE_CODES or Bmat.dtype != x.dtype or Cmat.dtype != x.dtype
            or any(t.dtype != torch.float32 for t in ts[1:3] + ts[5:])):
        raise TypeError(f"ssd_scan_cuda takes f32 or bf16 x, Bmat, Cmat of one dtype and "
                        f"f32 dt, A, h0, got {[t.dtype for t in ts]}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bmat.shape) != (B, S, N) or Cmat.shape != Bmat.shape
            or (h0 is not None and tuple(h0.shape) != (B, H, P, N))):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(Bmat.shape)} C {tuple(Cmat.shape)} "
                         f"h0 {None if h0 is None else tuple(h0.shape)}")
    Q = min(chunk, S)
    if not (S >= 1 and 1 <= Q <= MAX_CHUNK and P <= MAX_HEAD_DIM and N <= MAX_STATE
            and B <= 65535):
        raise ValueError(f"ssd_scan_cuda takes S >= 1, a chunk in [1, {MAX_CHUNK}], head "
                         f"dim <= {MAX_HEAD_DIM}, state <= {MAX_STATE} and <= 65535 batch "
                         f"rows, got S {S}, chunk {chunk}, P {P}, N {N}, B {B}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan_cuda needs contiguous inputs")
    y = torch.empty_like(x)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:  # B, H or P is 0: h_final is empty too
        return y, h_final
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                 h_final.data_ptr(), B, S, H, P, N, Q, _build.DTYPE_CODES[x.dtype], stream)
    launches += 1
    _build.check(lib, "ssd_scan", err)
    return y, h_final
