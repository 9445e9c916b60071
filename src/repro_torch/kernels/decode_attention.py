"""Wrapper of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention.py:62`` (``decode_attention_pallas``).
What bounds the kernel on the H100 and what its design does about it is in
the note at the top of the CUDA source. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def _fn():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                          softmax_scale: float) -> torch.Tensor:
    """q (B,H,Dh), caches (B,C,Hkv,Dh), cache_len (B,) int32, one CUDA device
    → (B,H,Dh)."""
    global launches
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k_cache, v_cache, cache_len)):
        raise ValueError("decode_attention_cuda needs q, caches and cache_len on "
                         f"one CUDA device, got {q.device}, {k_cache.device}, "
                         f"{v_cache.device}, {cache_len.device}")
    if q.dtype not in _build.DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention_cuda takes f32 or bf16 q and caches of "
                        f"one dtype, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if cache_len.dtype != torch.int32:
        raise TypeError(f"cache_len must be int32, got {cache_len.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_cache "
                         f"{tuple(k_cache.shape)} v_cache {tuple(v_cache.shape)}")
    B, H, Dh = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != Dh
            or tuple(cache_len.shape) != (B,) or H % Hkv):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)} and "
                         f"cache_len {tuple(cache_len.shape)} do not match")
    if not 1 <= Dh <= 256 or H // Hkv > 16:
        raise ValueError(f"decode_attention_cuda takes head_dim <= 256 and a GQA "
                         f"group <= 16, got head_dim {Dh}, group {H // Hkv}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, cache_len)):
        raise ValueError("decode_attention_cuda needs contiguous inputs")
    _build.refuse_grad("decode_attention_cuda", q, k_cache, v_cache)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 cache_len.data_ptr(), out.data_ptr(), B, C, H, Hkv, Dh,
                 float(softmax_scale), _build.DTYPE_CODES[q.dtype], stream)
    launches += 1
    _build.check(lib, "decode_attention", err)
    return out
