"""Wrapper of the CUDA burst-gather kernel (``csrc/burst_gather.cu``).

Replaces ``src/repro/kernels/burst_gather.py:34`` (``burst_gather_pallas``).
What bounds the kernel on the H100 and what its design does about it is in
the note at the top of the CUDA source: one thread per 16 output bytes over
the whole burst, planned here on the host by ``plan``. ``launches`` counts
kernel launches (one a non-empty call).

The launch path is trimmed to what a call needs, since at a burst of a few
hundred packets the host's enqueue, not the device, sets the time
(``chip_smoke.py``'s ``gather_host`` line times each stage): the C function
and torch's raw current-stream accessor are resolved once (the accessor that
PyTorch's own generated kernels launch with; ``torch.cuda.current_stream``
builds a ``Stream`` object on every call), the device guard is entered only
when the arena's device is not the current one, the device checks read
device indices, and there is no autograd check (integer tensors never
require grad). Every check that keeps a bad argument from an out-of-bounds
access stays.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

launches = 0

CHUNK = 16          # output bytes of a thread (one 16-byte store)
THREADS = 128       # threads of a block, one per chunk
MAX_GRID_X = 2 ** 31 - 1  # CUDA's bound on gridDim.x
INT_MAX = 2 ** 31 - 1

# the C entry's arguments: arena, slots, lengths, out; n, n_slots, slot_size,
# out_width; n_chunks, tail, grid, threads; stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])


class Plan(NamedTuple):
    """The grid of one call: thread c writes the flat output bytes
    [16c, 16c + 16) of the (n, out_width) output."""
    chunks: int   # ceil(n * out_width / 16)
    tail: int     # bytes of the last chunk where it is partial, else 0
    threads: int  # threads of a block
    grid: int     # blocks: ceil(chunks / threads)


@functools.lru_cache(maxsize=256)
def plan(n: int, out_width: int) -> Plan:
    """The call's plan from its shapes (Python ints; nothing on the device is
    read). At the benchmark's burst of 256 packets of 1518 bytes: 24288
    chunks in 190 blocks, under one wave of the H100's 132 SMs; at 4096,
    388608 chunks in 3036 blocks. Raises ValueError for shapes the grid
    cannot take."""
    if n < 0 or out_width < 0:
        raise ValueError(f"burst_gather_cuda takes n >= 0 and out_width >= 0, "
                         f"got n {n}, out_width {out_width}")
    total = n * out_width
    chunks = -(-total // CHUNK)
    grid = -(-chunks // THREADS)
    if grid > MAX_GRID_X:
        raise ValueError(f"burst_gather_cuda: {total} output bytes need {grid} blocks, "
                         f"past CUDA's {MAX_GRID_X}")
    return Plan(chunks=chunks, tail=total % CHUNK, threads=THREADS, grid=grid)


def check_args(arena: torch.Tensor, slots: torch.Tensor, lengths: torch.Tensor,
               out_width: int):
    """The wrapper's checks, which need no device; raise on what the kernel
    does not take. Returns n, n_slots, slot_size. No input can require grad:
    integer tensors never do, so there is no autograd check."""
    if arena.dtype != torch.uint8 or slots.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"burst_gather_cuda takes a uint8 arena and int32 slots and "
                        f"lengths, got {arena.dtype}, {slots.dtype}, {lengths.dtype}")
    if arena.dim() != 2 or slots.dim() != 1 or lengths.shape != slots.shape:
        raise ValueError(f"bad shapes arena {tuple(arena.shape)} slots {tuple(slots.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    n, (n_slots, slot_size) = slots.shape[0], arena.shape
    if out_width < 0 or max(n, n_slots, slot_size, out_width) > INT_MAX:
        raise ValueError(f"burst_gather_cuda takes out_width >= 0 and sizes below 2**31, "
                         f"got n {n}, arena {tuple(arena.shape)}, out_width {out_width}")
    if n > 0 and n_slots == 0:
        raise ValueError(f"burst_gather_cuda: {n} descriptors into an arena with no slots")
    if not (arena.is_contiguous() and slots.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("burst_gather_cuda needs contiguous inputs")
    index = arena.get_device()  # -1 on the CPU
    if not arena.is_cuda or slots.get_device() != index or lengths.get_device() != index:
        raise ValueError(f"burst_gather_cuda needs arena, slots and lengths on one CUDA "
                         f"device, got {arena.device}, {slots.device}, {lengths.device}")
    return n, n_slots, slot_size


# (library, its burst_gather_fwd, torch's raw current-stream accessor by device
# index), resolved at the first launch: CPU builds of torch lack the accessor
_launcher = None


def _fn():
    global _launcher
    if _launcher is None:
        lib = _build.load("burst_gather")
        fn = lib.burst_gather_fwd
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _launcher = lib, fn, torch._C._cuda_getCurrentRawStream
    return _launcher


def burst_gather_cuda(arena: torch.Tensor, slots: torch.Tensor, lengths: torch.Tensor,
                      out_width: int) -> torch.Tensor:
    """arena (n_slots, slot_size) uint8, slots and lengths (n,) int32, on one
    CUDA device → (n, out_width) uint8. The checks that do not need the device
    come first, so they hold for tensors anywhere."""
    global launches
    n, n_slots, slot_size = check_args(arena, slots, lengths, out_width)
    out = torch.empty((n, out_width), dtype=torch.uint8, device=arena.device)
    if n == 0 or out_width == 0:
        return out
    p = plan(n, out_width)
    lib, fn, raw_stream = _launcher or _fn()
    index = arena.get_device()
    args = (arena.data_ptr(), slots.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            n, n_slots, slot_size, out_width, p.chunks, p.tail, p.grid, p.threads)
    if index == torch.cuda.current_device():
        err = fn(*args, raw_stream(index))
    else:  # the launch goes to the current device: make it the arena's
        with torch.cuda.device(index):
            err = fn(*args, raw_stream(index))
    launches += 1
    _build.check(lib, "burst_gather", err)
    return out
