"""The split-KV algorithm of the decode kernels, on the CPU.

``csrc/decode_attention.cu`` runs in two passes: a partial pass over splits
of the cache that ``decode_attention.plan_splits`` plans on the host, and a
combine of the splits' states in split order. The kernels run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); here the planner is
checked directly, and a plain f32 mirror of partial-then-combine, written in
this file and on no path of the port, follows the planner's splits and is
held to 1e-6 against ``decode_attention_pallas`` in interpret mode and
against the port's plain ``ref.decode_attention``, on inputs drawn from a
numpy seed. The cases cover empty rows, splits that start past len, len one
key either side of a tile edge, C not a multiple of the tile, GQA groups 1,
2, 12 and 16 and head dims 16, 64 and 256.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import TILE, Plan, plan_splits
from repro_torch.kernels.decode_sweep import SHAPES

H100_SMS = 132
MIRROR_TOL = 1e-6
SERVE_SHAPES = {arch: shape[:5] for arch, shape in SHAPES.items()}
# B, C, H, Hkv, Dh: the shapes of chip_smoke.py's DECODE_CASES, then edge
# shapes (an empty cache, one slot, one tile, long caches, many rows)
PLAN_SHAPES = [
    (4, 300, 4, 2, 64), (3, 128, 6, 3, 16), (2, 200, 8, 1, 256), (2, 200, 8, 2, 128),
    (2, 300, 12, 1, 64), (5, 300, 2, 2, 64), (2, 1000, 16, 2, 128), (3, 256, 6, 1, 24),
    (2, 200, 16, 1, 20), (4, 544, 16, 8, 128), (4, 2048, 16, 1, 256),
    (1, 0, 2, 1, 64), (1, 1, 2, 1, 64), (2, 64, 4, 4, 32), (1, 32768, 16, 1, 256),
    (64, 4096, 32, 8, 128)]


def _bounds(plan, C):
    """The (start, end) slots of each split, in split order, as the kernels
    cut them: split i holds slots i split_keys up to the next split or C."""
    return [(i * plan.split_keys, min((i + 1) * plan.split_keys, C))
            for i in range(plan.n_splits)]


def _plan(shape, dtype=torch.bfloat16, n_sm=H100_SMS):
    B, C, H, Hkv, Dh = shape
    return plan_splits(B, C, Hkv, H // Hkv, Dh, dtype, n_sm)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("n_sm", [H100_SMS, 16, 1])
def test_plan_covers_every_slot_once_in_tiles(shape, n_sm):
    C = shape[1]
    plan = _plan(shape, n_sm=n_sm)
    assert plan.split_keys > 0 and plan.split_keys % TILE == 0
    bounds = _bounds(plan, C)
    assert len(bounds) == plan.n_splits >= 1
    covered = [slot for lo, hi in bounds for slot in range(lo, hi)]
    assert covered == list(range(C))  # each slot once, in increasing split order
    assert all(lo % TILE == 0 and lo < max(C, 1) for lo, _ in bounds)
    assert all(hi % TILE == 0 for _, hi in bounds[:-1])


@pytest.mark.parametrize("arch", sorted(SERVE_SHAPES))
def test_plan_fills_the_card_at_the_serve_shapes(arch):
    """About one wave or more on the H100's 132 SMs, with the K and V of a
    (row, split) read once for the whole group on the tensor cores."""
    B, C, H, Hkv, Dh = SERVE_SHAPES[arch]
    plan = _plan(SERVE_SHAPES[arch])
    assert plan.n_splits * Hkv * B >= 128
    assert plan.body == "mma"


@pytest.mark.parametrize("dtype,Dh,body", [
    (torch.bfloat16, 256, "mma"), (torch.bfloat16, 128, "mma"), (torch.bfloat16, 24, "mma"),
    (torch.bfloat16, 20, "fma"), (torch.bfloat16, 7, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma")])
def test_plan_picks_the_body_by_dtype_and_row_width(dtype, Dh, body):
    """bf16 rows of a multiple of 16 bytes go to mma.sync; f32 keeps f32
    FMAs (the tensor cores would round it to TF32), as do other bf16 rows."""
    assert plan_splits(4, 2048, 1, 16, Dh, dtype, H100_SMS).body == body


def _split_mirror(q, kc, vc, lens, scale, plan):
    """Partial then combine, in f32: per split, the max m (-inf where the
    split holds no key below len), the sum l and the unnormalised
    accumulator of its keys; then the splits merged in split order with
    exp(m_i - max m) weights, 0 where every split is empty."""
    B, H, Dh = q.shape
    C, Hkv = kc.shape[1], kc.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, Dh)
    states = []
    for lo, hi in _bounds(plan, C):
        s = torch.einsum("bhgd,bshd->bhgs", qg, kc[:, lo:hi]) * scale
        valid = torch.arange(lo, hi)[None] < lens[:, None]
        s = s.masked_fill(~valid[:, None, None], float("-inf"))
        m = s.amax(-1)
        p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
        states.append((m, p.sum(-1), torch.einsum("bhgs,bshd->bhgd", p, vc[:, lo:hi])))
    m_all = torch.stack([m for m, _, _ in states]).amax(0)
    m_use = torch.where(torch.isinf(m_all), 0.0, m_all)
    num = torch.zeros(B, Hkv, H // Hkv, Dh)
    den = torch.zeros(B, Hkv, H // Hkv)
    for m, l, acc in states:  # split order
        f = torch.exp(m - m_use)  # an empty split: exp(-inf) = 0
        den = den + f * l
        num = num + f[..., None] * torch.where(torch.isinf(m)[..., None], 0.0, acc)
    out = torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None], 0.0)
    return out.reshape(B, H, Dh)


MIRROR_CASES = [
    # B, C, H, Hkv, Dh, cache_len
    (5, 300, 2, 2, 64, (0, 1, TILE - 1, TILE + 1, 300)),   # group 1; splits past len
    (5, 200, 4, 2, 16, (TILE + 1, 0, 200, 1, TILE - 1)),   # group 2, Dh 16
    (3, 300, 12, 1, 64, (TILE + 1, 300, 1)),               # group 12
    (4, 200, 16, 1, 256, (200, TILE - 1, 0, 130)),         # group 16, Dh 256
]


@functools.lru_cache(maxsize=None)
def _mirror_inputs(case):
    B, C, H, Hkv, Dh, lens = case
    rng = np.random.default_rng(20)
    q = rng.standard_normal((B, H, Dh), dtype=np.float32)
    kc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
    vc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
    cl = np.asarray(lens, np.int32)
    pallas = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cl), blk_k=128,
        interpret=True), np.float32)
    return q, kc, vc, cl, pallas


def _case_plans(case):
    """The H100's plan, splits of two tiles, and one split over the whole cache."""
    B, C, H, Hkv, Dh, _ = case
    return {"h100": plan_splits(B, C, Hkv, H // Hkv, Dh, torch.float32, H100_SMS),
            "two_tiles": Plan(2 * TILE, -(-C // (2 * TILE)), "fma"),
            "one_split": plan_splits(B, C, Hkv, H // Hkv, Dh, torch.float32, 1)}


@pytest.mark.parametrize("case", MIRROR_CASES, ids=lambda c: "-".join(map(str, c[:5])))
@pytest.mark.parametrize("plan_name", ["h100", "two_tiles", "one_split"])
def test_split_mirror_vs_pallas_and_plain(case, plan_name):
    q, kc, vc, cl, pallas = _mirror_inputs(case)
    plan = _case_plans(case)[plan_name]
    scale = q.shape[-1] ** -0.5
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, kc, vc, cl))
    got = _split_mirror(tq, tk, tv, tl, scale, plan)
    assert bool(torch.isfinite(got).all())  # no NaN from an empty split
    np.testing.assert_allclose(got.numpy(), pallas, atol=MIRROR_TOL, rtol=MIRROR_TOL)
    plain = ref.decode_attention(tq, tk, tv, tl, softmax_scale=scale)
    torch.testing.assert_close(got, plain, atol=MIRROR_TOL, rtol=MIRROR_TOL)
    empty = [i for i, n in enumerate(case[5]) if n == 0]
    assert torch.count_nonzero(got[empty]) == 0
    if plan_name == "h100":  # at least one split starts past a row's len
        assert any(lo >= n for n in case[5] for lo, _ in _bounds(plan, case[1]))
