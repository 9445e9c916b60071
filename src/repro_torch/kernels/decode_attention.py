"""Wrapper of the CUDA decode-attention kernels (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention.py:62`` (``decode_attention_pallas``).
What bounds the kernels on the H100 and what their design does about it is in
the note at the top of the CUDA source. Each call runs two kernels on the
current stream: the partial pass over the cache's splits, which ``plan_splits``
plans here on the host, and the combine of the splits in a fixed order.
``launches`` counts calls of the wrapper (one partial pass and one combine
each). The plan and the launch run inside a ``torch.library`` op,
``repro_torch::decode_attention`` (``decode_op``), whose CUDA implementation
reads the card's SM count and whose fake implementation gives the output's
shape and dtype, so that a decode step traces on fake tensors. Its twin
``repro_torch::decode_attention_lse`` (``decode_lse_op``) also returns each
(row, head)'s logsumexp of the scaled scores, (B, H) f32 (-inf on a row
with no valid slot), which the combine writes beside the output: the merge
of context-sharded decode's slot shares (``parallel.axes.merge_over_model``)
weighs each rank's partial output by it. The output's bits are the same
either way.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from . import _build
from .flash_attention import check_aligned

launches = 0
# f32 workspace of the partial states, one per (device, stream), grown to the
# largest call: calls on one stream run in order, so a call's partial pass
# writes it only after the previous call's combine has read it
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}

TILE = 64  # keys per tile of both partial bodies; split boundaries are multiples of it


class Plan(NamedTuple):
    """Splits of ``split_keys`` cache slots, ``n_splits`` of them (split i
    holds slots i split_keys up to C), and the body that the C entry point
    picks for the call by the same rule as ``plan_splits``: "mma" (bf16 on
    the tensor cores) or "fma" (f32 FMAs)."""
    split_keys: int
    n_splits: int
    body: str


@functools.lru_cache(maxsize=256)
def plan_splits(B: int, C: int, Hkv: int, group: int, Dh: int, dtype: torch.dtype,
                n_sm: int) -> Plan:
    """The partial pass's plan from the shapes and the SM count alone (it
    never reads ``cache_len``, which lives on the device). Splits of whole
    64-key tiles, as many as make the grid (n_splits, Hkv, B) at least one
    block per SM where the cache has that many tiles, and no smaller: each
    split's state costs a workspace row per query head and a term of the
    combine. bf16 with Dh a multiple of 8 runs on mma.sync (16-byte rows),
    everything else on f32 FMAs."""
    tiles = max(1, -(-C // TILE))
    per_wave = -(-n_sm // max(1, B * Hkv))  # splits that give one block per SM
    tiles_per_split = max(1, tiles // per_wave)
    n_splits = -(-tiles // tiles_per_split) if C > 0 else 1
    body = "mma" if dtype == torch.bfloat16 and Dh % 8 == 0 else "fma"
    return Plan(tiles_per_split * TILE, n_splits, body)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            cache_len: torch.Tensor, scale: float, plan: Plan, with_lse: bool = False):
    """Both kernels under ``plan``, on inputs ``decode_attention_cuda`` checked:
    the output, or with ``with_lse`` (output, logsumexp (B, H) f32).

    Decode is host-bound, so this path keeps to the cheap calls: the raw
    current stream (``torch.cuda.current_stream()`` builds a Stream object),
    the device switch only when the caller's device is another, and the
    stream's cached workspace."""
    global launches
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch(q, k_cache, v_cache, cache_len, scale, plan, with_lse)
    B, H, Dh = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    numel = B * H * plan.n_splits * (Dh + 2)
    ws = _workspaces.get((q.device.index, stream))
    if ws is None or ws.numel() < numel:
        ws = _workspaces[(q.device.index, stream)] = torch.empty(
            numel, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if with_lse else None
    lib, fn = _fn()
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
             out.data_ptr(), ws.data_ptr(), B, C, H, Hkv, Dh, plan.split_keys,
             plan.n_splits, float(scale), _build.DTYPE_CODES[q.dtype], stream,
             None if lse is None else lse.data_ptr())
    launches += 1
    _build.check(lib, "decode_attention", err)
    return (out, lse) if with_lse else out


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                          softmax_scale: float, return_lse: bool = False):
    """q (B,H,Dh), caches (B,C,Hkv,Dh), cache_len (B,) int32, one CUDA device
    → (B,H,Dh), or with ``return_lse`` (out, the logsumexp (B,H) f32 of the
    scaled scores over the valid slots, -inf where there is none). bf16
    inputs with Dh a multiple of 8 must start on 16-byte boundaries (the mma
    body moves 16-byte rows)."""
    dev = q.device
    if (dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev
            or cache_len.device != dev):
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
    if q.numel() == 0:
        out = torch.empty_like(q)
        return (out, torch.full((B, H), -math.inf, device=dev)) if return_lse else out
    if return_lse:
        return decode_lse_op(q, k_cache, v_cache, cache_len, softmax_scale)
    return decode_op(q, k_cache, v_cache, cache_len, softmax_scale)


def planned_launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   cache_len: torch.Tensor, softmax_scale: float, with_lse: bool = False):
    """The split plan from the card's SM count, then both kernels: the
    launcher that ``decode_op`` and ``decode_lse_op`` wrap, on inputs
    ``decode_attention_cuda`` checked."""
    B, H, Dh = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    plan = plan_splits(B, C, Hkv, H // Hkv, Dh, q.dtype, _sm_count(q.device.index))
    if plan.body == "mma":
        check_aligned("decode_attention_cuda", q=q, k_cache=k_cache, v_cache=v_cache)
    return _launch(q, k_cache, v_cache, cache_len, softmax_scale, plan, with_lse)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              cache_len: torch.Tensor, softmax_scale: float) -> torch.Tensor:
    """``planned_launch`` as an op."""
    return planned_launch(q, k_cache, v_cache, cache_len, softmax_scale)


@decode_op.register_fake
def _decode_fake(q, k_cache, v_cache, cache_len, softmax_scale):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::decode_attention_lse", mutates_args=())
def decode_lse_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  cache_len: torch.Tensor, softmax_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``planned_launch`` with the logsumexp, as an op."""
    return planned_launch(q, k_cache, v_cache, cache_len, softmax_scale, with_lse=True)


@decode_lse_op.register_fake
def _decode_lse_fake(q, k_cache, v_cache, cache_len, softmax_scale):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)
