"""The work of one call of each kernel that a model step reaches: its FLOP
and the bytes its function must move (each input read once, each output
written once), from the shapes alone.

One function per kernel. Two users read them and must agree: the bound
rows of ``chip_smoke.py``'s ``time`` phase (``bound_ms``) and the dry run's
op counter (``repro_torch.parallel.op_counter``), which adds these FLOP to
its dot FLOP and these bytes to its HBM bytes. Where the work depends on the
data, the caller says how much there is: decode's valid cache slots (the
bound rows count this run's valid slots; the counter reads no tensor's
values and counts every slot, as the JAX package's static count does).

FLOP are the products a fused kernel needs, on the bf16 tensor cores
(``Work.f32`` False) or, for the RG-LRU scans, on the f32 CUDA cores. A
kernel's workspace (the SSD scan's C·Bᵀ tiles, the RG-LRU scan's chunk
states) is the design's, not the function's, and is not counted.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Work(NamedTuple):
    flops: float
    bytes: float
    f32: bool = False  # FLOP on the f32 CUDA cores, not the bf16 tensor cores


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """Visible (query, key) pairs per (row, head) under the causal and window
    masks of ``ref.attention_mask``: query i sits at position i + q_offset."""
    pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, Skv - 1) if causal else np.full(Sq, Skv - 1, dtype=np.int64)
    lo = np.maximum(pos - window + 1, 0) if window and window > 0 else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_forward(q_shape, k_shape, itemsize: int, *, causal: bool, window: int,
                  q_offset: int = 0, with_lse: bool = False) -> Work:
    """q (B,Sq,H,Dh), k and v (B,Skv,Hkv,Dh): 4·Dh FLOP per visible pair and
    head (the scores and P·V); q, k, v read, the output written, and the f32
    logsumexp (B,H,Sq) where the train path asks for it."""
    B, Sq, H, Dh = q_shape
    Skv, Hkv = k_shape[1], k_shape[2]
    q, kv = B * Sq * H * Dh, B * Skv * Hkv * Dh
    pairs = visible_pairs(Sq, Skv, causal, window, q_offset)
    return Work(4 * Dh * pairs * B * H,
                itemsize * (2 * q + 2 * kv) + (4 * B * H * Sq if with_lse else 0))


def flash_backward(q_shape, k_shape, itemsize: int, *, causal: bool, window: int,
                   q_offset: int = 0) -> Work:
    """10·Dh FLOP per visible pair and head (the scores again, dP, dV, dK,
    dQ); q, the output, dO and k, v read, dq, dk, dv written, and the f32
    logsumexp read."""
    B, Sq, H, Dh = q_shape
    Skv, Hkv = k_shape[1], k_shape[2]
    q, kv = B * Sq * H * Dh, B * Skv * Hkv * Dh
    pairs = visible_pairs(Sq, Skv, causal, window, q_offset)
    return Work(10 * Dh * pairs * B * H, itemsize * (4 * q + 4 * kv) + 4 * B * H * Sq)


def decode(q_shape, k_shape, itemsize: int, valid_slots: int, with_lse: bool = False) -> Work:
    """q (B,H,Dh) over caches (B,C,Hkv,Dh) with ``valid_slots`` slots valid
    over all rows: 4·Dh FLOP per valid slot and query head; q read, the
    output written, the valid K and V read, the int32 lengths, and the f32
    logsumexp (B,H) written where context-sharded decode asks for it."""
    B, H, Dh = q_shape
    Hkv = k_shape[2]
    return Work(4 * Dh * H * valid_slots,
                itemsize * 2 * B * H * Dh + itemsize * 2 * valid_slots * Hkv * Dh + 4 * B
                + (4 * B * H if with_lse else 0))


def ssd_forward(B: int, S: int, H: int, P: int, N: int, chunk: int, itemsize: int,
                h0: bool = False) -> Work:
    """x (B,S,H,P) read and y written in x's dtype, dt (B,S,H) and A (H,)
    f32, Bmat and Cmat (B,S,N), the f32 final state written and h0 read
    where given. FLOP: the chunked form's products over lower triangles, C·Bᵀ
    per (row, chunk) and the intra-chunk, carried and state products per
    (row, chunk, head)."""
    Q = min(chunk, S)
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    state = B * H * P * N * 4
    nbytes = (2 * B * S * H * P * itemsize + B * S * H * 4 + H * 4 + 2 * B * S * N * itemsize
              + state * (2 if h0 else 1))
    return Work(B * nc * (2 * tri * N + H * (2 * tri * P + 2 * 2 * Q * P * N)), nbytes)


def ssd_backward(B: int, S: int, H: int, P: int, N: int, chunk: int, itemsize: int,
                 h0: bool = False, dh_final: bool = False) -> Work:
    """x and dy read, dx written; dt and A read, ddt and dA written (f32);
    Bmat and Cmat read, dB and dC written; h0 read and dh0 written where
    given, dh_final read where given. FLOP, lower triangles only: per (row,
    chunk, head) four P x N-by-chunk products (the chunk's state gradient,
    g B, dY^T h_c, XDT^T g) and two over the triangle (G and (L o S)^T dY);
    per (row, chunk) M B and M^T C."""
    Q = min(chunk, S)
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    state = B * H * P * N * 4
    nbytes = (3 * B * S * H * P * itemsize + 2 * B * S * H * 4 + 2 * H * 4
              + 4 * B * S * N * itemsize + (2 * state if h0 else 0)
              + (state if dh_final else 0))
    return Work(B * nc * (4 * tri * N + H * (8 * Q * P * N + 4 * tri * P)), nbytes)


def rglru_forward(B: int, S: int, W: int, itemsize: int, h0: bool = False) -> Work:
    """x read and y written in x's dtype, a_log (f32) read, h_last written,
    h0 (f32) read where given. Per element: exp, a*a, 1 - a^2, max, sqrt,
    the product with x, one FMA, on the f32 CUDA cores."""
    n = B * S * W
    nbytes = n * (itemsize + 4 + itemsize) + B * W * itemsize + (4 * B * W if h0 else 0)
    return Work(7 * n, nbytes, f32=True)


def rglru_backward(B: int, S: int, W: int, itemsize: int, h0: bool = False,
                   dh_last: bool = False) -> Work:
    """x, a_log and dy read, dx and da_log written (h0 read and dh0 written,
    f32, where given; dh_last read where given). Per element: exp, a*a,
    1 - a^2, max, sqrt, the carry's add and product, s g, a x / s, the
    difference, two products, and the forward step's three."""
    n = B * S * W
    return Work(16 * n, n * (itemsize + 4 + itemsize + itemsize + 4)
                + (8 * B * W if h0 else 0) + (itemsize * B * W if dh_last else 0), f32=True)
