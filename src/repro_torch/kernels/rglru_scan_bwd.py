"""Wrapper of the CUDA RG-LRU scan backward kernels (``csrc/rglru_scan_bwd.cu``).

The gradient of ``src/repro/kernels/rglru_scan.py:46`` (``rglru_scan_pallas``),
which the JAX package takes by differentiating its associative scan
(``src/repro/kernels/ops.py:248-281``) instead of a kernel. What bounds the
kernels on the H100 and what their design does about it is in the note at
the top of the CUDA source. Each call runs three kernels on the current
stream (each chunk's reverse decay product and local carry, the pass over
the chunks right to left, then each chunk's states recomputed from the
forward's workspace and its dx and da_log), or the last alone where S is
one chunk; ``plan`` works out the grids and the f32 workspace here on the
host, from the shapes alone, on the forward's chunks. ``launches`` counts
calls of the wrapper (up to three kernels each).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .rglru_scan import MAX_GRID_YZ, THREADS
from .rglru_scan import plan as forward_plan

launches = 0

MAX_CHUNK = 64  # the out kernel holds a chunk's states in shared memory

# the C entry's arguments: x, a_log, h0, fwd_ws, dy, dh_last, dx, da_log, dh0, ws;
# B, S, W, L, dtype; stream
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """Chunk length (the forward's), grids ((x, y, z) blocks of THREADS) and
    f32 workspace of one call. The workspace holds the chunks' reverse decay
    products (B, n_chunks - 1, W), then their local carries of the same
    shape, which the pass overwrites with the carry into each chunk from its
    right; it is empty for one chunk, where only the out kernel runs."""
    chunk: int                          # L: steps of every chunk but the last
    n_chunks: int
    chunk_grid: Tuple[int, int, int]    # one thread per (b, chunk, w), all chunks but the first
    pass_grid: Tuple[int, int, int]     # one thread per (b, w)
    out_grid: Tuple[int, int, int]      # one thread per (b, chunk, w)
    workspace_floats: int


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, W: int) -> Plan:
    """The call's plan from its shapes (Python ints; nothing on the device is
    read), on the chunks of the forward's plan, whose workspace it reads.
    Raises ValueError for shapes the grids cannot take, and where the
    forward's chunk is longer than MAX_CHUNK (S past 64 * 65535 steps)."""
    fp = forward_plan(B, S, W)
    if fp.chunk > MAX_CHUNK:
        raise ValueError(f"rglru_scan_bwd_cuda takes chunks of at most {MAX_CHUNK} steps, "
                         f"so S at most {MAX_CHUNK * MAX_GRID_YZ}; got S {S} (chunk "
                         f"{fp.chunk})")
    wb, nc = -(-W // THREADS), fp.n_chunks
    return Plan(chunk=fp.chunk, n_chunks=nc, chunk_grid=(wb, nc - 1, B), pass_grid=(wb, B, 1),
                out_grid=(wb, nc, B), workspace_floats=2 * B * (nc - 1) * W)


def _fn():
    lib = _build.load("rglru_scan_bwd")
    fn = lib.rglru_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def rglru_scan_bwd_cuda(x: torch.Tensor, a_log: torch.Tensor, h0: Optional[torch.Tensor],
                        dy: torch.Tensor, dh_last: Optional[torch.Tensor], *,
                        fwd_workspace: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The gradients of ``rglru_scan_cuda``: x (B,S,W) f32 or bf16, a_log
    (B,S,W) f32, h0 (B,W) f32 or None, dy (B,S,W) in x's dtype, dh_last (B,W)
    in x's dtype or None (no cotangent on the final state), and the forward's
    f32 workspace after its call, on one CUDA device → (dx in x's dtype,
    da_log f32, dh0 f32, or None when h0 is None)."""
    global launches
    ts = tuple(t for t in (x, a_log, h0, dy, dh_last, fwd_workspace) if t is not None)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"rglru_scan_bwd_cuda needs every input on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if (x.dtype not in _build.DTYPE_CODES or dy.dtype != x.dtype
            or (dh_last is not None and dh_last.dtype != x.dtype)
            or any(t.dtype != torch.float32 for t in (a_log, h0, fwd_workspace)
                   if t is not None)):
        raise TypeError(f"rglru_scan_bwd_cuda takes f32 or bf16 x, dy and dh_last of one "
                        f"dtype with f32 a_log, h0 and workspace, got "
                        f"{[t.dtype for t in ts]}")
    if x.dim() != 3 or a_log.shape != x.shape or dy.shape != x.shape or any(
            t is not None and tuple(t.shape) != (x.shape[0], x.shape[2]) for t in (h0, dh_last)):
        raise ValueError(f"bad shapes x {tuple(x.shape)} a_log {tuple(a_log.shape)} dy "
                         f"{tuple(dy.shape)} h0 {None if h0 is None else tuple(h0.shape)} "
                         f"dh_last {None if dh_last is None else tuple(dh_last.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rglru_scan_bwd_cuda needs contiguous inputs")
    B, S, W = x.shape
    if S == 0:
        raise ValueError("rglru_scan_bwd_cuda takes 1 or more steps")
    dx = torch.empty_like(x)
    da_log = torch.empty_like(a_log)
    dh0 = torch.empty_like(h0) if h0 is not None else None
    if x.numel() == 0:
        return dx, da_log, dh0
    p = plan(B, S, W)
    if fwd_workspace.numel() != forward_plan(B, S, W).workspace_floats:
        raise ValueError(f"the forward's workspace has {fwd_workspace.numel()} floats, its "
                         f"plan {forward_plan(B, S, W).workspace_floats}")
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        # from the caching allocator on the current stream, which the kernels run on
        ws = torch.empty(p.workspace_floats, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), a_log.data_ptr(), h0.data_ptr() if h0 is not None else None,
                 fwd_workspace.data_ptr(), dy.data_ptr(),
                 dh_last.data_ptr() if dh_last is not None else None, dx.data_ptr(),
                 da_log.data_ptr(), dh0.data_ptr() if dh0 is not None else None, ws.data_ptr(),
                 B, S, W, p.chunk, _build.DTYPE_CODES[x.dtype], stream)
    launches += 1
    _build.check(lib, "rglru_scan_bwd", err)
    return dx, da_log, dh0
