"""The yardstick's work counts: the card's peaks, the operations and bytes
of one call of each kernel op from its argument shapes (a frozen copy of
the program's ``kernels/costs.py`` at the time this benchmark was written:
each input read once, each output written once), and the model FLOP of a
step from the configuration alone (no recompute).

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s bf16
on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


class Work(NamedTuple):
    flops: float
    bytes: float

    def bound_s(self) -> float:
        """The least time the card needs: the larger of its two terms."""
        return max(self.flops / PEAK_FLOPS_BF16, self.bytes / PEAK_BYTES_PER_S)


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """Visible (query, key) pairs per (row, head) under the causal and window
    masks; query i sits at position i + q_offset."""
    pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, Skv - 1) if causal else np.full(Sq, Skv - 1, dtype=np.int64)
    lo = np.maximum(pos - window + 1, 0) if window and window > 0 else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_forward(q_shape, k_shape, itemsize: int, *, causal: bool, window: int,
                  q_offset: int = 0, with_lse: bool = False) -> Work:
    """4·Dh FLOP per visible pair and head; q, k, v read, the output written,
    and the f32 logsumexp where asked."""
    B, Sq, H, Dh = q_shape
    Skv, Hkv = k_shape[1], k_shape[2]
    q, kv = B * Sq * H * Dh, B * Skv * Hkv * Dh
    pairs = visible_pairs(Sq, Skv, causal, window, q_offset)
    return Work(4 * Dh * pairs * B * H,
                itemsize * (2 * q + 2 * kv) + (4 * B * H * Sq if with_lse else 0))


def flash_backward(q_shape, k_shape, itemsize: int, *, causal: bool, window: int,
                   q_offset: int = 0) -> Work:
    """10·Dh FLOP per visible pair and head; q, the output, dO, k and v read,
    dq, dk, dv written, the f32 logsumexp read."""
    B, Sq, H, Dh = q_shape
    Skv, Hkv = k_shape[1], k_shape[2]
    q, kv = B * Sq * H * Dh, B * Skv * Hkv * Dh
    pairs = visible_pairs(Sq, Skv, causal, window, q_offset)
    return Work(10 * Dh * pairs * B * H, itemsize * (4 * q + 4 * kv) + 4 * B * H * Sq)


def ssd_forward(B: int, S: int, H: int, P: int, N: int, chunk: int, itemsize: int,
                h0: bool = False) -> Work:
    """x read and y written in x's dtype, dt and A f32, Bmat and Cmat, the
    f32 final state written (h0 read where given). FLOP of the chunked form
    over lower triangles: C·Bᵀ per (row, chunk), the intra-chunk, carried
    and state products per (row, chunk, head)."""
    Q = min(chunk, S)
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    state = B * H * P * N * 4
    nbytes = (2 * B * S * H * P * itemsize + B * S * H * 4 + H * 4 + 2 * B * S * N * itemsize
              + state * (2 if h0 else 1))
    return Work(B * nc * (2 * tri * N + H * (2 * tri * P + 2 * 2 * Q * P * N)), nbytes)


def ssd_backward(B: int, S: int, H: int, P: int, N: int, chunk: int, itemsize: int,
                 h0: bool = False, dh_final: bool = False) -> Work:
    """x and dy read, dx written; dt, A read, ddt, dA written (f32); Bmat,
    Cmat read, dB, dC written. FLOP over lower triangles: per (row, chunk,
    head) four P x N-by-chunk products and two over the triangle; per (row,
    chunk) two more."""
    Q = min(chunk, S)
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    state = B * H * P * N * 4
    nbytes = (3 * B * S * H * P * itemsize + 2 * B * S * H * 4 + 2 * H * 4
              + 4 * B * S * N * itemsize + (2 * state if h0 else 0)
              + (state if dh_final else 0))
    return Work(B * nc * (4 * tri * N + H * (8 * Q * P * N + 4 * tri * P)), nbytes)


# -- model FLOP from the configuration ---------------------------------------

def matmul_params(model: dict) -> tuple:
    """(parameters a token meets in matrix products in the layers, in the
    output layer). Embedding lookups, convs, norms and biases are not
    products."""
    D, L, V = model["d_model"], model["n_layers"], model["vocab_size"]
    if model["family"] == "ssm":
        d_in = model["ssm_expand"] * D
        H = d_in // model["ssm_head_dim"]
        per = D * (2 * d_in + 2 * model["ssm_state"] + H) + d_in * D
    elif model["family"] in ("dense", "encoder"):
        H, Hkv, F = model["n_heads"], model["n_kv_heads"], model["d_ff"]
        Dh = model.get("head_dim") or D // H
        mlp = (3 if model["act"] == "silu" else 2) * D * F
        per = D * H * Dh * 2 + 2 * D * Hkv * Dh + mlp
    else:
        raise ValueError(f"no FLOP formula for the family {model['family']!r}")
    return L * per, V * D


def attention_flops(model: dict, B: int, S: int) -> float:
    """Forward: 4·Dh per visible pair and head, every layer."""
    if model["family"] not in ("dense", "encoder"):
        return 0.0
    H = model["n_heads"]
    Dh = model.get("head_dim") or model["d_model"] // H
    pairs = visible_pairs(S, S, bool(model["causal"]), model.get("window") or 0)
    return float(model["n_layers"] * 4 * Dh * pairs * B * H)


def ssd_dims(model: dict, B: int, S: int) -> tuple:
    d_in = model["ssm_expand"] * model["d_model"]
    P = model["ssm_head_dim"]
    return B, S, d_in // P, P, model["ssm_state"], model["ssm_chunk"]


def train_step_flops(model: dict, B: int, S: int) -> float:
    """Model FLOP of one training step of B x S tokens: 6 per product
    parameter and token, attention's forward tripled, the SSD scan's forward
    and backward once a layer."""
    body, head = matmul_params(model)
    flops = 6.0 * (body + head) * B * S + 3 * attention_flops(model, B, S)
    if model["family"] == "ssm":
        dims = ssd_dims(model, B, S)
        flops += model["n_layers"] * (ssd_forward(*dims, 2).flops
                                      + ssd_backward(*dims, 2).flops)
    return flops


def prefill_flops(model: dict, B: int, S: int) -> float:
    """Model FLOP of one prefill of B prompts of S tokens: 2 per product
    parameter and token in the layers, the output layer at the last position
    only, attention's forward, the SSD scan's forward."""
    body, head = matmul_params(model)
    flops = 2.0 * body * B * S + 2.0 * head * B + attention_flops(model, B, S)
    if model["family"] == "ssm":
        flops += model["n_layers"] * ssd_forward(*ssd_dims(model, B, S), 2).flops
    return flops
