"""Wrapper of the CUDA Mamba-2 SSD scan backward (``csrc/ssd_scan_bwd.cu``).

The gradient of ``src/repro/kernels/ssd_scan.py:66`` (``ssd_scan_pallas``),
which the JAX package takes by differentiating its chunked path
(``src/repro/kernels/ops.py:305``) instead of a kernel. What bounds the
kernels on the H100 and what their design does about it is in the note at the
top of the CUDA source. Each call runs eight kernels on the current stream
(the chunks' state gradients, the reverse pass over the chunks, G and M per
tile pair and head group, dB and dC per head group, their sum over the
groups, dx, ddt, dA), whose grids and f32 workspace ``plan`` works out here
on the host from the shapes alone. ``launches`` counts calls of the wrapper
(eight kernels each). ``backward_op`` (``repro_torch::ssd_scan_bwd``) is the
wrapper as a ``torch.library`` op, with a fake implementation for tracing on
fake tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .ssd_scan import MAX_BLOCKS, MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE, THREADS, TILE, check_inputs
from .ssd_scan import plan as forward_plan

launches = 0

HEAD_GROUP = 8  # heads a block sums for M and for dB and dC
# pitches (bf16 elements) of the tensor-core kernels' operand tiles: 64 and 128
# columns, each row padded by 16 bytes
PITCH_64, PITCH_128 = TILE + 8, MAX_STATE + 8


class Plan(NamedTuple):
    """Grids and f32 workspace of one call. The workspace is one buffer, in
    this order: the head groups' parts of M (B, n_chunks, n_pairs, n_groups,
    TILE, TILE), on the allocator's alignment; their parts of dC and dB
    (B, n_chunks, n_tiles, 2, n_groups, TILE, MAX_STATE); the state gradients
    (B, n_chunks, H, P, N); the row sums and
    the column sums of L∘S∘G (B, n_chunks, n_pairs, H, TILE) each; three
    per-step rows (the carried and the state terms of dcum, Σ_p x·dxdt)
    (B, n_chunks, H, chunk) each; two per-chunk sums (⟨g, h⟩, the chunk's
    part of dA) (B, n_chunks, H) each. The dynamic shared memory of the
    kernels that take it depends on the dtype alone: f32 inputs split every
    operand tile into more parts (``csrc/ssd_scan_bwd.cu``, whose
    ``ssd_scan_bwd_smem`` gives the same numbers)."""
    chunk: int          # Q, the chunk the kernels run: min(chunk, S)
    n_chunks: int
    n_tiles: int        # TILE-row tiles of a chunk
    n_pairs: int        # (query tile, key tile at or below it) pairs of a chunk
    n_groups: int       # groups of HEAD_GROUP heads
    dstate_blocks: int  # one per (row, chunk, head)
    pass_blocks: int    # one thread per (row, head, p, n)
    scores_blocks: int  # one per (row, chunk, tile pair, head group)
    dbc_part_blocks: int  # one per (row, chunk, tile, dB or dC, head group)
    dbc_sum_blocks: int  # one per (row, chunk, tile, dB or dC)
    dx_blocks: int      # one per (row, chunk, head, key tile)
    dt_blocks: int      # one per (row, chunk, head)
    da_blocks: int      # one thread per head
    m_floats: int
    dbc_part_floats: int
    grad_state_floats: int
    partial_floats: int  # the row and the column sums together
    row_floats: int      # the three per-step rows together
    chunk_floats: int    # the two per-chunk sums together
    dstate_smem: int     # bytes of dynamic shared memory a block
    scores_smem: int
    dbc_part_smem: int
    dbc_sum_smem: int
    dx_smem: int

    @property
    def workspace_floats(self) -> int:
        return (self.m_floats + self.dbc_part_floats + self.grad_state_floats
                + self.partial_floats + self.row_floats + self.chunk_floats)


def _smem(dtype: torch.dtype) -> Dict[str, int]:
    """Dynamic shared memory (bytes) of dstate, scores, dbc_part, dbc_sum
    and dx for inputs of ``dtype``, laid out as the CUDA source lays it out:
    each tensor-core operand as bf16 tiles, one for a raw bf16 input, two for
    an f32 operand of a bf16 call, three for every operand of an f32 call."""
    size = torch.empty((), dtype=dtype).element_size()
    raw, f32 = (3, 3) if dtype == torch.float32 else (1, 2)  # tiles an operand takes
    a_tile, b_tile = 2 * TILE * PITCH_64, 2 * TILE * PITCH_128  # bf16 bytes
    state = 2 * MAX_HEAD_DIM * PITCH_128  # one tile of a head's P x N state
    return dict(dstate_smem=4 * (TILE * MAX_HEAD_DIM + TILE * MAX_STATE + MAX_CHUNK),
                scores_smem=2 * (2 * raw * a_tile + 3 * TILE * 4) + 6 * TILE * 4,
                dbc_part_smem=raw * a_tile + f32 * state + TILE * PITCH_128 * size + 3 * TILE * 4,
                dbc_sum_smem=4 * (TILE * (TILE + 4) + TILE * MAX_STATE),
                dx_smem=raw * b_tile + f32 * state + (MAX_CHUNK + 8 + 2 * TILE) * 4)


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, H: int, P: int, N: int, chunk: int,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The call's plan from its shapes and the inputs' dtype (nothing on the
    device is read). Raises ValueError where the kernels' compile-time bounds
    or a one-dimensional grid refuse the shapes, the forward's bounds among
    them."""
    f = forward_plan(B, S, H, P, N, chunk)
    Q, nc, nt, n_pairs = f.chunk, f.n_chunks, f.n_tiles, f.n_pairs
    bc, ng = B * nc, -(-H // HEAD_GROUP)
    p = Plan(chunk=Q, n_chunks=nc, n_tiles=nt, n_pairs=n_pairs, n_groups=ng,
             dstate_blocks=bc * H, pass_blocks=-(-B * H * P * N // THREADS),
             scores_blocks=bc * n_pairs * ng, dbc_part_blocks=2 * bc * nt * ng,
             dbc_sum_blocks=2 * bc * nt, dx_blocks=bc * H * nt,
             dt_blocks=bc * H, da_blocks=-(-H // THREADS),
             m_floats=bc * n_pairs * ng * TILE * TILE,
             dbc_part_floats=2 * bc * nt * ng * TILE * MAX_STATE,
             grad_state_floats=bc * H * P * N,
             partial_floats=2 * bc * n_pairs * H * TILE, row_floats=3 * bc * H * Q,
             chunk_floats=2 * bc * H, **_smem(dtype))
    if max(p.dx_blocks, p.pass_blocks, p.dstate_blocks, p.scores_blocks,
           p.dbc_part_blocks) > MAX_BLOCKS:
        raise ValueError(f"ssd_scan_bwd_cuda: a grid of more than {MAX_BLOCKS} blocks for "
                         f"B {B}, S {S}, H {H}, chunk {Q}, P {P}, N {N}")
    return p


def _fn():
    lib = _build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bmat: torch.Tensor, Cmat: torch.Tensor, h0: Optional[torch.Tensor],
                      dy: torch.Tensor, dh_final: Optional[torch.Tensor], *, chunk: int,
                      fwd_workspace: torch.Tensor
                      ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradients (dx in x's dtype, ddt f32, dA f32, dB and dC in Bmat's
    dtype, dh0 f32 or None when h0 is None) of ``ssd_scan_cuda`` with the
    inputs of its forward call, the outputs' gradients dy (x's shape and
    dtype) and dh_final ((B,H,P,N) f32, or None for none), and the f32
    workspace that forward call left (``ssd_scan._forward``)."""
    global launches
    B, S, H, P, N = check_inputs("ssd_scan_bwd_cuda", x, dt, A, Bmat, Cmat, h0)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"ssd_scan_bwd_cuda needs dy contiguous, of x's shape "
                         f"{tuple(x.shape)} and dtype {x.dtype} on {x.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if dh_final is not None and (tuple(dh_final.shape) != (B, H, P, N)
                                 or dh_final.dtype != torch.float32
                                 or dh_final.device != x.device
                                 or not dh_final.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd_cuda needs dh_final contiguous (B,H,P,N) f32 on "
                         f"{x.device}, got {tuple(dh_final.shape)} {dh_final.dtype} on "
                         f"{dh_final.device}")
    p = plan(B, S, H, P, N, chunk, x.dtype)
    f = forward_plan(B, S, H, P, N, chunk)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bmat), torch.empty_like(Cmat)
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    dh0 = torch.empty_like(h0) if h0 is not None else None
    if x.numel() == 0:  # B, H or P is 0: no output, so every gradient is 0
        for t in (dx, ddt, dA, dB, dC) + ((dh0,) if dh0 is not None else ()):
            t.zero_()
        return dx, ddt, dA, dB, dC, dh0
    if (fwd_workspace.dtype != torch.float32 or fwd_workspace.device != x.device
            or fwd_workspace.numel() != f.workspace_floats):
        raise ValueError(f"ssd_scan_bwd_cuda needs the forward's f32 workspace of "
                         f"{f.workspace_floats} floats on {x.device}, got "
                         f"{fwd_workspace.numel()} {fwd_workspace.dtype} on "
                         f"{fwd_workspace.device}")
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        # from the caching allocator on the current stream, which the kernels run on
        ws = torch.empty(p.workspace_floats, dtype=torch.float32, device=x.device)
        scores = fwd_workspace.data_ptr()
        states = scores + 4 * f.score_floats
        cum = states + 4 * f.state_floats
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
                 dy.data_ptr(), dh_final.data_ptr() if dh_final is not None else None,
                 scores, states, cum, dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                 dB.data_ptr(), dC.data_ptr(), dh0.data_ptr() if dh0 is not None else None,
                 ws.data_ptr(), B, S, H, P, N, p.chunk, _build.DTYPE_CODES[x.dtype], stream)
    launches += 1
    _build.check(lib, "ssd_scan_bwd", err)
    return dx, ddt, dA, dB, dC, dh0


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def backward_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
                Cmat: torch.Tensor, h0: Optional[torch.Tensor], dy: torch.Tensor,
                dh_final: Optional[torch.Tensor], chunk: int, fwd_workspace: torch.Tensor
                ) -> List[torch.Tensor]:
    """``ssd_scan_bwd_cuda`` as an op: [dx, ddt, dA, dB, dC], and dh0 after
    them where h0 is given."""
    grads = ssd_scan_bwd_cuda(x, dt, A, Bmat, Cmat, h0, dy, dh_final, chunk=chunk,
                              fwd_workspace=fwd_workspace)
    return list(grads[:5]) + ([grads[5]] if h0 is not None else [])


@backward_op.register_fake
def _backward_fake(x, dt, A, Bmat, Cmat, h0, dy, dh_final, chunk, fwd_workspace):
    out = [torch.empty_like(t) for t in (x, dt, A, Bmat, Cmat)]
    return out + ([torch.empty_like(h0)] if h0 is not None else [])
