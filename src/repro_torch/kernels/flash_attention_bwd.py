"""Wrapper of the CUDA flash-attention backward kernel
(``csrc/flash_attention_bwd.cu``).

The gradient of ``src/repro/kernels/flash_attention.py:92``
(``flash_attention_pallas``), which the JAX package takes through its chunked
path instead of a kernel. What bounds the kernel on the H100 and what its
design does about it is in the note at the top of the CUDA source.
``launches`` counts calls, each of which launches the source's three kernels
(row dots, dK/dV, dQ), and a fourth where the plan spreads a GQA group over
several dK/dV blocks (the sum of their partials). ``plan`` works out the
grids, the head subsets, the f32 workspace and each kernel's dynamic shared
memory on the host, from the shapes and the dtype alone. ``backward_op``
(``repro_torch::flash_attention_bwd``) is the launcher as a ``torch.library``
op, with a fake implementation for tracing on fake tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from . import _build

launches = 0

# past 128 the bf16 body gives each 16 rows a pair of warps that split the
# output columns, and may spread a GQA group over blocks (see the CUDA source)
MAX_HEAD_DIM = 256

SMS = 132                # the H100's streaming multiprocessors
TILE = 64                # keys of a bf16 dK/dV block, query rows of a bf16 dQ block
WIDE_PAIRS = 4           # warp pairs of a wide-body block (8 warps)
DOT_ROWS = 8             # rows a block of the row-dot kernel takes (one a warp)
SUM_THREADS = 256        # threads of a block of the partial sum, four elements each

# q, k, v, o, dout, lse, delta, dq, dk, dv, workspace; B, Sq, Skv, H, Hkv, Dh,
# causal, window, q_offset, head_subsets; scale; dtype; stream
ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


class Plan(NamedTuple):
    """One call's launches. Grids are (x, y, z) in blocks; a kernel that does
    not run has the grid (0, 1, 1). The bodies: ``"f32"`` (FMAs on the CUDA
    cores), ``"mma"`` (bf16 up to Dh 128, one warp a 16 rows) and ``"wide"``
    (bf16 past Dh 128, a pair of warps a 16 rows). ``head_subsets`` holds the
    [first, end) heads of the GQA group that each dK/dV block of a kv tile
    sums, in the order their partials are added; with more than one the
    kernels write f32 partials of dK and dV, ``workspace_bytes`` of them
    ([subset][dK, dV][B][Skv][Hkv][Dh]), and the sum kernel adds them."""
    body: str
    head_subsets: Tuple[Tuple[int, int], ...]
    dot_grid: Tuple[int, int, int]
    dkdv_grid: Tuple[int, int, int]
    sum_grid: Tuple[int, int, int]
    dq_grid: Tuple[int, int, int]
    workspace_bytes: int
    dkdv_smem: int  # bytes of dynamic shared memory a block
    dq_smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem(Dh: int, dtype: torch.dtype) -> Tuple[str, int, int]:
    """(body, dK/dV bytes, dQ bytes) of dynamic shared memory at head dim Dh,
    laid out as the CUDA source lays it out (``flash_attention_bwd_smem`` in
    the library gives the same numbers)."""
    if dtype == torch.float32:
        tt = 32 if Dh > 128 else 64  # tile rows: four row tiles at pitch Dh + 1, two scores
        b = 4 * (4 * tt * (Dh + 1) + 2 * tt * (tt + 1) + 2 * tt)
        return "f32", b, b
    if Dh > 128:  # K, V, two Q/dO stages, lse and D; per pair P f32 and dS bf16 of 16 x 64
        rows, xch = 2 * (256 + 8), WIDE_PAIRS * 16 * TILE * (4 + 2)
        return ("wide", (2 * TILE + 4 * TILE) * rows + 4 * TILE * 4 + xch,
                (2 * TILE + 4 * TILE) * rows + xch)
    dh = 32 if Dh <= 32 else 64 if Dh <= 64 else 128
    rows, bq = 2 * (dh + 8), 32 if dh == 64 else 64  # bytes of a padded row; queries a step
    return "mma", (2 * TILE + 4 * bq) * rows + 4 * bq * 4, (2 * TILE + 4 * TILE) * rows


@functools.lru_cache(maxsize=256)
def plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, Dh: int,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The call's plan from its shapes and the inputs' dtype (nothing on the
    device is read). The wide body's dK/dV blocks take a kv tile's whole GQA
    group unless the kv tiles give fewer than two waves of one block an SM;
    then each group is cut into the fewest contiguous head subsets that give
    two waves (at most one head a subset). Raises ValueError where a grid
    cannot take the shapes."""
    if min(B, Sq, Skv, H, Hkv) < 1 or H % Hkv or Dh % 16 or not 16 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd_cuda: no plan for B {B}, Sq {Sq}, Skv {Skv}, "
                         f"H {H}, Hkv {Hkv}, Dh {Dh}")
    body, dkdv_smem, dq_smem = _smem(Dh, dtype)
    group = H // Hkv
    dot = (_cdiv(B * Sq * H, DOT_ROWS), 1, 1)
    none = (0, 1, 1)
    if body == "f32":
        tt = 32 if Dh > 128 else 64
        return Plan(body, ((0, group),), dot, (_cdiv(Skv, tt), Hkv, B), none,
                    (_cdiv(Sq, tt), H, B), 0, dkdv_smem, dq_smem)
    tiles = _cdiv(Skv, TILE) * Hkv * B
    n = 1 if body == "mma" or tiles >= 2 * SMS else min(group, _cdiv(2 * SMS, tiles))
    subsets = tuple((s * group // n, (s + 1) * group // n) for s in range(n))
    elems = B * Skv * Hkv * Dh  # of dk, and of dv
    p = Plan(body, subsets, dot, (tiles * n, 1, 1),
             (_cdiv(2 * elems // 4, SUM_THREADS), 1, 1) if n > 1 else none,
             (_cdiv(Sq, TILE) * H * B, 1, 1), 4 * 2 * elems * n if n > 1 else 0,
             dkdv_smem, dq_smem)
    if max(p.dot_grid[0], p.dkdv_grid[0], p.sum_grid[0], p.dq_grid[0]) > 2 ** 31 - 1:
        raise ValueError(f"flash_attention_bwd_cuda: a grid of more than 2^31 - 1 blocks "
                         f"for B {B}, Sq {Sq}, Skv {Skv}, H {H}, Hkv {Hkv}")
    return p


def _fn():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: int, q_offset: int,
                             softmax_scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of flash attention, in q's dtype, from the
    forward's inputs, its output ``out`` and logsumexp ``lse`` (B,H,Sq) f32,
    and the output's gradient ``dout``."""
    global launches
    from .flash_attention import check_aligned, check_inputs
    check_inputs("flash_attention_bwd_cuda", q, k, v, MAX_HEAD_DIM)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype
            or dout.dtype != q.dtype or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype}, dout {tuple(dout.shape)} "
                         f"{dout.dtype} and lse {tuple(lse.shape)} {lse.dtype} do not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if any(t.device != q.device or not t.is_contiguous() for t in (out, lse, dout)):
        raise ValueError("flash_attention_bwd_cuda needs out, lse and dout contiguous "
                         "on q's device")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_bwd_cuda takes at most 65535 batch rows and "
                         f"heads, got {B}, {H}")
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if Skv == 0 or q.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    check_aligned("flash_attention_bwd_cuda", q=q, k=k, v=v, out=out, dout=dout)
    p = plan(B, Sq, Skv, H, Hkv, Dh, q.dtype)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    ws = (torch.empty(p.workspace_bytes // 4, dtype=torch.float32, device=q.device)
          if p.workspace_bytes else None)
    lib, fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), None if ws is None else ws.data_ptr(), B, Sq, Skv, H, Hkv, Dh,
                 int(causal), int(window), int(q_offset), len(p.head_subsets),
                 float(softmax_scale), _build.DTYPE_CODES[q.dtype], stream)
    launches += 1
    _build.check(lib, "flash_attention_bwd", err)
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                lse: torch.Tensor, dout: torch.Tensor, causal: bool, window: int,
                q_offset: int, softmax_scale: float) -> List[torch.Tensor]:
    """``flash_attention_bwd_cuda`` as an op: [dq, dk, dv]. A bf16 ``dout``
    off a 16-byte boundary (a view into another buffer) is copied first: the
    bf16 bodies move rows 16 bytes at a time."""
    if dout.dtype == torch.bfloat16 and dout.data_ptr() % 16:
        dout = dout.clone()
    return list(flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal,
                                         window=window, q_offset=q_offset,
                                         softmax_scale=softmax_scale))


@backward_op.register_fake
def _backward_fake(q, k, v, out, lse, dout, causal, window, q_offset, softmax_scale):
    return [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
