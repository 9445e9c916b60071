"""Wrapper of the CUDA RG-LRU scan kernels (``csrc/rglru_scan.cu``).

Replaces ``src/repro/kernels/rglru_scan.py:46`` (``rglru_scan_pallas``).
What bounds the kernels on the H100 and what their design does about it is
in the note at the top of the CUDA source. Each call runs three kernels on
the current stream (the chunks' decay products and end states, the pass
over the chunks, the outputs from the carried state), or the output kernel
alone where S is one chunk; ``plan`` works out the chunk length, the grids
and the f32 workspace here on the host, from the shapes alone. ``launches``
counts forward calls (up to three kernels each).

When autograd needs a gradient (grad mode on and an input that requires
grad), the call goes through ``RGLRUScan``, an ``autograd.Function`` whose
backward is the CUDA backward (``rglru_scan_bwd.py``). Otherwise the forward
runs alone and its workspace is freed. Both directions launch through
``torch.library`` ops (``forward_op``, ``repro_torch::rglru_scan_fwd``, and
``rglru_scan_bwd.backward_op``), whose fake implementations give the outputs'
shapes and dtypes, the workspace's from ``plan``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

launches = 0

THREADS = 128       # threads of a block, one per channel
CHUNK = 64          # steps of a chunk (see plan)
MAX_GRID_YZ = 65535  # CUDA's bound on gridDim.y and gridDim.z

# the C entry's arguments: x, a_log, h0, y, h_last, ws; B, S, W, L, dtype; stream
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """Chunk length, grids ((x, y, z) blocks of THREADS) and f32 workspace of
    one call. The workspace holds the decay products (B, n_chunks - 1, W),
    then the end states of the same shape, which the pass overwrites with
    the state entering each following chunk; it is empty for one chunk,
    where only the output kernel runs."""
    chunk: int                          # L: steps of every chunk but the last
    n_chunks: int
    chunk_grid: Tuple[int, int, int]    # one thread per (b, chunk, w), all chunks but the last
    pass_grid: Tuple[int, int, int]     # one thread per (b, w)
    out_grid: Tuple[int, int, int]      # one thread per (b, chunk, w)
    workspace_floats: int


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, W: int) -> Plan:
    """The call's plan from its shapes (Python ints; nothing on the device is
    read). L is CHUNK (or S, where S is shorter), and grows past it only to
    keep the chunks within a grid dimension. At recurrentgemma-9b's prefill
    CHUNK makes 6144 blocks, about three waves of full SMs on an H100. A
    shorter L on a grid of under a wave was slower on the card at every
    shape tried: the pass, a chain of loads over the chunks, grows with
    their number. Raises ValueError for shapes the grids cannot take."""
    if not (B >= 1 and S >= 1 and W >= 1):
        raise ValueError(f"rglru_scan_cuda takes B, S and W of 1 or more, got B {B}, "
                         f"S {S}, W {W}")
    if B > MAX_GRID_YZ:
        raise ValueError(f"rglru_scan_cuda takes at most {MAX_GRID_YZ} batch rows, got {B}")
    wb = -(-W // THREADS)
    L = min(max(CHUNK, -(-S // MAX_GRID_YZ)), S)
    nc = -(-S // L)
    return Plan(chunk=L, n_chunks=nc, chunk_grid=(wb, nc - 1, B), pass_grid=(wb, B, 1),
                out_grid=(wb, nc, B), workspace_floats=2 * B * (nc - 1) * W)


def _fn():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _forward(x: torch.Tensor, a_log: torch.Tensor, h0: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, h_last, the f32 workspace after the call: the decay products, then
    the states entering chunks 1 .. n_chunks - 1, as ``plan`` lays them out)."""
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
    if S == 0 or B > MAX_GRID_YZ:
        raise ValueError(f"rglru_scan_cuda takes 1 or more steps and at most "
                         f"{MAX_GRID_YZ} batch rows, got S {S}, B {B}")
    y = torch.empty_like(x)
    h_last = torch.empty((B, W), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y, h_last, torch.empty(0, dtype=torch.float32, device=x.device)
    p = plan(B, S, W)
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        # from the caching allocator on the current stream, which the kernels run on
        ws = torch.empty(p.workspace_floats, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), a_log.data_ptr(), h0.data_ptr() if h0 is not None else None,
                 y.data_ptr(), h_last.data_ptr(), ws.data_ptr(),
                 B, S, W, p.chunk, _build.DTYPE_CODES[x.dtype], stream)
    launches += 1
    _build.check(lib, "rglru_scan", err)
    return y, h_last, ws


@torch.library.custom_op("repro_torch::rglru_scan_fwd", mutates_args=())
def forward_op(x: torch.Tensor, a_log: torch.Tensor, h0: Optional[torch.Tensor]
               ) -> List[torch.Tensor]:
    """``_forward`` as an op: [y, h_last, workspace]."""
    return list(_forward(x, a_log, h0))


@forward_op.register_fake
def _forward_fake(x, a_log, h0):
    B, S, W = x.shape
    floats = plan(B, S, W).workspace_floats if x.numel() else 0
    return [torch.empty_like(x), x.new_empty((B, W)),
            x.new_empty((floats,), dtype=torch.float32)]


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan with the CUDA backward kernels as its gradient. The
    forward keeps its f32 workspace (the states entering each chunk) for the
    backward, which recomputes the states inside each chunk from it."""

    @staticmethod
    def forward(ctx, x, a_log, h0):
        y, h_last, ws = forward_op(x, a_log, h0)
        ctx.save_for_backward(x, a_log, h0, ws)
        ctx.set_materialize_grads(False)  # no gradient on an output: no zeros made
        return y, h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_last):
        from .rglru_scan_bwd import backward_op
        x, a_log, h0, ws = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh_last = None if dh_last is None else dh_last.contiguous()
        grads = backward_op(x, a_log, h0, dy, dh_last, ws)
        return grads[0], grads[1], grads[2] if h0 is not None else None


def rglru_scan_cuda(x: torch.Tensor, a_log: torch.Tensor, *,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,W) f32 or bf16, a_log (B,S,W) f32, h0 (B,W) f32 or None, on one
    CUDA device → (y (B,S,W), h_last (B,W)) in x's dtype, differentiable
    through the backward kernels."""
    ts = (x, a_log) + ((h0,) if h0 is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return RGLRUScan.apply(x, a_log, h0)
    y, h_last, _ = forward_op(x, a_log, h0)
    return y, h_last
