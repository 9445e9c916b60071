"""Wrapper of the CUDA Mamba-2 SSD scan kernels (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan.py:66`` (``ssd_scan_pallas``). What
bounds the kernels on the H100 and what their design does about it is in the
note at the top of the CUDA source. Each call runs four kernels on the
current stream (the chunk states, C·Bᵀ once per chunk, the state pass over
the chunks, the outputs), whose grids and f32 workspace ``plan`` works out
here on the host from the shapes alone. ``launches`` counts forward calls
(four kernels each).

When autograd needs a gradient (grad mode on and an input that requires
grad), the call goes through ``SSDScan``, an ``autograd.Function`` whose
backward is the CUDA backward (``ssd_scan_bwd.py``). Otherwise the forward
runs alone and its workspace is freed. Both directions launch through
``torch.library`` ops (``forward_op``, ``repro_torch::ssd_scan_fwd``, and
``ssd_scan_bwd.backward_op``), whose fake implementations give the outputs'
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

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128  # the kernels' compile-time bounds
TILE = 64       # rows of a query tile and of a key tile
THREADS = 256   # threads of a block of the state pass
MAX_BLOCKS = 2 ** 31 - 1  # a one-dimensional grid


class Plan(NamedTuple):
    """Grids and f32 workspace of one call. The workspace is one buffer:
    the C·Bᵀ tiles (B, n_chunks, n_pairs, TILE, TILE) first, on the
    allocator's alignment, then the chunk states (B, n_chunks, H, P, N),
    then cum (B, n_chunks, H, chunk)."""
    chunk: int          # Q, the chunk the kernels run: min(chunk, S)
    n_chunks: int
    n_tiles: int        # TILE-row tiles of a chunk
    n_pairs: int        # (query tile, key tile at or below it) pairs of a chunk
    state_blocks: int   # one per (row, chunk, head)
    score_blocks: int   # one per (row, chunk, tile pair)
    pass_blocks: int    # one thread per (row, head, p, n)
    out_blocks: int     # one per (row, chunk, head, query tile)
    score_floats: int
    state_floats: int
    cum_floats: int

    @property
    def workspace_floats(self) -> int:
        return self.score_floats + self.state_floats + self.cum_floats


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, H: int, P: int, N: int, chunk: int) -> Plan:
    """The call's plan from its shapes (Python ints; nothing on the device
    is read). Raises ValueError where the kernels' compile-time bounds or a
    one-dimensional grid refuse the shapes."""
    Q = min(chunk, S)
    if not (S >= 1 and 1 <= Q <= MAX_CHUNK and P <= MAX_HEAD_DIM and N <= MAX_STATE):
        raise ValueError(f"ssd_scan_cuda takes S >= 1, a chunk in [1, {MAX_CHUNK}], head "
                         f"dim <= {MAX_HEAD_DIM} and state <= {MAX_STATE}, got S {S}, "
                         f"chunk {chunk}, P {P}, N {N}")
    nc, nt = -(-S // Q), -(-Q // TILE)
    n_pairs = nt * (nt + 1) // 2
    p = Plan(chunk=Q, n_chunks=nc, n_tiles=nt, n_pairs=n_pairs,
             state_blocks=B * nc * H, score_blocks=B * nc * n_pairs,
             pass_blocks=-(-B * H * P * N // THREADS), out_blocks=B * nc * H * nt,
             score_floats=B * nc * n_pairs * TILE * TILE, state_floats=B * nc * H * P * N,
             cum_floats=B * nc * H * Q)
    if max(p.state_blocks, p.score_blocks, p.pass_blocks, p.out_blocks) > MAX_BLOCKS:
        raise ValueError(f"ssd_scan_cuda: a grid of more than {MAX_BLOCKS} blocks for "
                         f"B {B}, S {S}, H {H}, chunk {Q}, P {P}, N {N}")
    return p


def _fn():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def check_inputs(name: str, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bmat: torch.Tensor, Cmat: torch.Tensor, h0: Optional[torch.Tensor]
                 ) -> Tuple[int, int, int, int, int]:
    """Raise on what the forward and backward kernels do not take; returns
    (B, S, H, P, N)."""
    ts = (x, dt, A, Bmat, Cmat) + ((h0,) if h0 is not None else ())
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"{name} needs every input on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if (x.dtype not in _build.DTYPE_CODES or Bmat.dtype != x.dtype or Cmat.dtype != x.dtype
            or any(t.dtype != torch.float32 for t in ts[1:3] + ts[5:])):
        raise TypeError(f"{name} takes f32 or bf16 x, Bmat, Cmat of one dtype and "
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
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous inputs")
    return B, S, H, P, N


def _forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, *, chunk: int, h0: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, final state, the f32 workspace after the call: the C·Bᵀ tiles, the
    states entering each chunk and cum, as ``plan`` lays them out)."""
    global launches
    B, S, H, P, N = check_inputs("ssd_scan_cuda", x, dt, A, Bmat, Cmat, h0)
    p = plan(B, S, H, P, N, chunk)
    y = torch.empty_like(x)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:  # B, H or P is 0: h_final is empty too
        return y, h_final, torch.empty(0, dtype=torch.float32, device=x.device)
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        # from the caching allocator on the current stream, which the kernels run on
        ws = torch.empty(p.workspace_floats, dtype=torch.float32, device=x.device)
        scores = ws.data_ptr()
        states = scores + 4 * p.score_floats
        cum = states + 4 * p.state_floats
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                 h_final.data_ptr(), scores, states, cum, B, S, H, P, N, p.chunk,
                 _build.DTYPE_CODES[x.dtype], stream)
    launches += 1
    _build.check(lib, "ssd_scan", err)
    return y, h_final, ws


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def forward_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
               Cmat: torch.Tensor, h0: Optional[torch.Tensor], chunk: int
               ) -> List[torch.Tensor]:
    """``_forward`` as an op: [y, final state, workspace]."""
    return list(_forward(x, dt, A, Bmat, Cmat, chunk=chunk, h0=h0))


@forward_op.register_fake
def _forward_fake(x, dt, A, Bmat, Cmat, h0, chunk):
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    floats = plan(B, S, H, P, N, chunk).workspace_floats if x.numel() else 0
    return [torch.empty_like(x), x.new_empty((B, H, P, N), dtype=torch.float32),
            x.new_empty((floats,), dtype=torch.float32)]


class SSDScan(torch.autograd.Function):
    """The SSD scan with the CUDA backward kernels as its gradient. The
    forward keeps its f32 workspace (cum, the C·Bᵀ tiles and the entering
    states) for the backward, which reads it instead of computing it again."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, h0, chunk):
        y, h_final, ws = forward_op(x, dt, A, Bmat, Cmat, h0, chunk)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, h0, ws)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # no gradient on the final state: no zeros made
        return y, h_final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_final):
        from .ssd_scan_bwd import backward_op
        x, dt, A, Bmat, Cmat, h0, ws = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh_final = None if dh_final is None else dh_final.contiguous()
        grads = backward_op(x, dt, A, Bmat, Cmat, h0, dy, dh_final, ctx.chunk, ws)
        return (*grads[:5], grads[5] if h0 is not None else None, None)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
                  Cmat: torch.Tensor, *, chunk: int, h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) f32 or bf16, dt (B,S,H) f32, A (H,) f32, Bmat/Cmat (B,S,N) in
    x's dtype, h0 (B,H,P,N) f32 or None, on one CUDA device → (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) f32), differentiable through the
    backward kernels."""
    ts = (x, dt, A, Bmat, Cmat) + ((h0,) if h0 is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return SSDScan.apply(x, dt, A, Bmat, Cmat, h0, chunk)
    y, h_final, _ = forward_op(x, dt, A, Bmat, Cmat, h0, chunk)
    return y, h_final
