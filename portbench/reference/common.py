"""Pieces of the plain reference that every family shares: the precision of
its matrix products, the norms, RoPE, the GELU MLP, the cross-entropy and
the weights' generator helpers.

Plain PyTorch, float32 with TF32 off. The reference imports nothing of the
program under test; it reads the parameters by the key names and layouts
that the configuration's file describes (stacked leaves: every layer's
tensor under one leaf with a leading layer axis).

``Precision("fp8")`` is the control: every operand of every matrix product
(the projections, attention's two products, the SSD scan's products)
rounded to float8 e4m3 with a per-tensor scale from its largest magnitude,
products and sums in float32; norms, the residual stream and elementwise
work stay in float32, as float8 training keeps them in a wider type. Gradients pass the rounding unchanged
(straight through); the backward's products then read the rounded values
the forward saved.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def strict_f32() -> None:
    """Matrix products in full float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in t's dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Precision:
    """How the reference multiplies: ``f32`` exactly, ``fp8`` (the control)
    with both operands rounded to float8."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r}: f32 or fp8")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return t
        if t.requires_grad:
            return t + (round_fp8(t) - t).detach()
        return round_fp8(t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.operand(a) @ self.operand(b)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * f32(scale)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * f32(scale) + f32(bias)


def norm(model: dict, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if model["norm"] == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], model["norm_eps"])
    return rms_norm(x, p["scale"], model["norm_eps"])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B,S,H,Dh) at positions 0..S-1; the first half of Dh pairs with the
    second half."""
    S, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    return 0.5 * u * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (u + 0.044715 * u ** 3)))


def xent_sum(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             prec: Precision) -> torch.Tensor:
    """Sum over tokens of -log softmax(h wᵀ)[label]; labels -100 count 0."""
    logits = prec.mm(h, f32(w).t())
    valid = labels != -100
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
    return torch.where(valid, lse - picked, 0.0).sum()


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of nested dicts and lists, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            yield from leaves(c, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def layer(stacked, i: int):
    """Layer ``i`` of a stacked tree (views)."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]


class Draw:
    """The weights' generator: one ``torch.Generator`` on the weights' device
    seeded from the run's seed, one call a stacked leaf, in the served dtype.
    The same seed, device and order give the same weights bit for bit."""

    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))
        self.device, self.dtype = torch.device(device), dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, dtype=self.dtype, device=self.device)
        return t.mul_(std)

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, dtype=dtype, device=self.device)

    def full(self, shape, value: float, dtype=None) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype or self.dtype, device=self.device)


def checkpointed(fn, *args):
    """``fn(*args)`` keeping only its inputs for the backward where autograd
    records (the layer runs again in the backward), plainly otherwise."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
