"""Wrapper of the CUDA RG-LRU scan backward kernel (``csrc/rglru_scan_bwd.cu``).

The gradient of ``src/repro/kernels/rglru_scan.py:46`` (``rglru_scan_pallas``),
which the JAX package takes by differentiating its associative scan
(``src/repro/kernels/ops.py:248-281``) instead of a kernel. Each call zeroes
the chunks' flags and runs one kernel on the current stream, one block per
(b, chunk, 32-channel tile) in one pass: the block takes its work from a
ticket (``ticket_work``: every row's last chunk first), stages its chunk's
inputs in shared memory once, publishes the chunk's reverse decay product and
local carry, takes the carry into its chunk from the chunk to its right (or
folds one from further right through the chunks between), publishes the
carry it hands its left neighbour, and writes dx and da_log. Every carry is
the same sequential fold of the chunks to its right, wherever the look-back
stops, so the outputs do not depend on the order the blocks ran in and are
bitwise those of the three kernels the pass replaced; what bounds the kernel
on the H100 is in the note at the top of the CUDA source. ``plan`` works out
the blocks, the workspace, the flags and the shared memory here on the host,
from the shapes alone, on the forward's chunks. ``launches`` counts calls. ``backward_op``
(``repro_torch::rglru_scan_bwd``) is the wrapper as a ``torch.library`` op,
with a fake implementation for tracing on fake tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .rglru_scan import MAX_GRID_YZ
from .rglru_scan import plan as forward_plan

launches = 0

MAX_CHUNK = 64  # a block holds its chunk in shared memory
MAX_BLOCKS = 2 ** 31 - 1  # CUDA's bound on a 1-D grid
TILE = 32  # channels of a block
BLOCK_THREADS = 128  # threads of a block, a fixed channel each

# the C entry's arguments: x, a_log, h0, fwd_ws, dy, dh_last, dx, da_log, dh0, ws,
# flags; B, S, W, L, dtype; stream
ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """Chunk length (the forward's), blocks (a 1-D grid of ``threads`` each,
    a block per TILE-channel tile of a chunk), f32 workspace, flags and
    shared memory of one call. The workspace holds, for chunks 1 ..
    n_chunks - 1, their reverse decay products (B, n_chunks - 1, W) and their
    local carries of that shape; it is empty for one chunk. The flags, which
    the call zeroes, are the chunks' carries out, a 64-bit word (two uint32)
    per (b, chunk 1 .. n_chunks - 1, w), then one aggregate flag per (b,
    tile, chunk 1 .. n_chunks - 1), then the ticket counter."""
    chunk: int             # L: steps of every chunk but the last
    n_chunks: int
    tiles: int             # TILE-channel tiles of a row
    blocks: int            # one per (b, chunk, tile)
    threads: int           # of a block
    workspace_floats: int
    flag_words: int
    smem_f32: int          # dynamic shared memory of a block, f32 x
    smem_bf16: int         # the same, bf16 x


def smem_bytes(chunk: int, itemsize: int) -> int:
    """A block's dynamic shared memory: its chunk's a and an f32
    scratch row a step, and dy and x in their dtype, TILE channels each."""
    return chunk * TILE * (2 * 4 + 2 * itemsize)


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, W: int) -> Plan:
    """The call's plan from its shapes (Python ints; nothing on the device is
    read), on the chunks of the forward's plan, whose workspace it reads.
    Raises ValueError for shapes the forward's plan refuses, where the
    forward's chunk is longer than MAX_CHUNK (S past 64 * 65535 steps), and
    past MAX_BLOCKS blocks."""
    fp = forward_plan(B, S, W)
    if fp.chunk > MAX_CHUNK:
        raise ValueError(f"rglru_scan_bwd_cuda takes chunks of at most {MAX_CHUNK} steps, "
                         f"so S at most {MAX_CHUNK * MAX_GRID_YZ}; got S {S} (chunk "
                         f"{fp.chunk})")
    tiles, nc = -(-W // TILE), fp.n_chunks
    if B * nc * tiles > MAX_BLOCKS:
        raise ValueError(f"rglru_scan_bwd_cuda takes at most {MAX_BLOCKS} blocks, got "
                         f"{B * nc * tiles} for B {B}, S {S}, W {W}")
    return Plan(chunk=fp.chunk, n_chunks=nc, tiles=tiles, blocks=B * nc * tiles,
                threads=BLOCK_THREADS, workspace_floats=2 * B * (nc - 1) * W,
                flag_words=2 * B * (nc - 1) * W + B * tiles * (nc - 1) + 1,
                smem_f32=smem_bytes(fp.chunk, 4),
                smem_bf16=smem_bytes(fp.chunk, 2))


def ticket_work(p: Plan, ticket: int) -> Tuple[int, int, int]:
    """The (b, chunk, tile) of the block that draws ``ticket``, as the kernel
    works it out: every row's (b, tile) chunk n_chunks - 1 first, then every
    row's n_chunks - 2, and so on, so the chunks to a chunk's right hold lower
    tickets."""
    rows = p.blocks // p.n_chunks
    step, r = divmod(ticket, rows)
    return r // p.tiles, p.n_chunks - 1 - step, r % p.tiles


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
        # from the caching allocator on the current stream, which the kernel runs on
        ws = torch.empty(p.workspace_floats, dtype=torch.float32, device=x.device)
        flags = torch.empty(p.flag_words, dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), a_log.data_ptr(), h0.data_ptr() if h0 is not None else None,
                 fwd_workspace.data_ptr(), dy.data_ptr(),
                 dh_last.data_ptr() if dh_last is not None else None, dx.data_ptr(),
                 da_log.data_ptr(), dh0.data_ptr() if dh0 is not None else None, ws.data_ptr(),
                 flags.data_ptr(), B, S, W, p.chunk, _build.DTYPE_CODES[x.dtype], stream)
    launches += 1
    _build.check(lib, "rglru_scan_bwd", err)
    return dx, da_log, dh0


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def backward_op(x: torch.Tensor, a_log: torch.Tensor, h0: Optional[torch.Tensor],
                dy: torch.Tensor, dh_last: Optional[torch.Tensor],
                fwd_workspace: torch.Tensor) -> List[torch.Tensor]:
    """``rglru_scan_bwd_cuda`` as an op: [dx, da_log], and dh0 after them where
    h0 is given."""
    dx, da_log, dh0 = rglru_scan_bwd_cuda(x, a_log, h0, dy, dh_last,
                                          fwd_workspace=fwd_workspace)
    return [dx, da_log] + ([dh0] if h0 is not None else [])


@backward_op.register_fake
def _backward_fake(x, a_log, h0, dy, dh_last, fwd_workspace):
    out = [torch.empty_like(x), torch.empty_like(a_log)]
    return out + ([torch.empty_like(h0)] if h0 is not None else [])
