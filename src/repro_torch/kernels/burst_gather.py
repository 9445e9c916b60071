"""Wrapper of the CUDA burst-gather kernel (``csrc/burst_gather.cu``).

Replaces ``src/repro/kernels/burst_gather.py:34`` (``burst_gather_pallas``).
What bounds the kernel on the H100 and what its design does about it is in
the note at the top of the CUDA source. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def _fn():
    lib = _build.load("burst_gather")
    fn = lib.burst_gather_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def burst_gather_cuda(arena: torch.Tensor, slots: torch.Tensor, lengths: torch.Tensor,
                      out_width: int) -> torch.Tensor:
    """arena (n_slots, slot_size) uint8, slots and lengths (n,) int32, on one
    CUDA device → (n, out_width) uint8. The checks that do not need the device
    come first, so they hold for tensors anywhere."""
    global launches
    if arena.dtype != torch.uint8 or slots.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"burst_gather_cuda takes a uint8 arena and int32 slots and "
                        f"lengths, got {arena.dtype}, {slots.dtype}, {lengths.dtype}")
    if arena.dim() != 2 or slots.dim() != 1 or lengths.shape != slots.shape:
        raise ValueError(f"bad shapes arena {tuple(arena.shape)} slots {tuple(slots.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    n, (n_slots, slot_size) = slots.shape[0], arena.shape
    if out_width < 0 or max(n, n_slots, slot_size, out_width) > 2**31 - 1:
        raise ValueError(f"burst_gather_cuda takes out_width >= 0 and sizes below 2**31, "
                         f"got n {n}, arena {tuple(arena.shape)}, out_width {out_width}")
    if n > 0 and n_slots == 0:
        raise ValueError(f"burst_gather_cuda: {n} descriptors into an arena with no slots")
    if not all(t.is_contiguous() for t in (arena, slots, lengths)):
        raise ValueError("burst_gather_cuda needs contiguous inputs")
    dev = arena.device
    if dev.type != "cuda" or slots.device != dev or lengths.device != dev:
        raise ValueError(f"burst_gather_cuda needs arena, slots and lengths on one CUDA "
                         f"device, got {arena.device}, {slots.device}, {lengths.device}")
    _build.refuse_grad("burst_gather_cuda", arena, slots, lengths)
    out = torch.empty((n, out_width), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    lib, fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(arena.data_ptr(), slots.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 n, n_slots, slot_size, out_width, stream)
    launches += 1
    _build.check(lib, "burst_gather", err)
    return out
