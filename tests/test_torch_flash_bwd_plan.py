"""The flash backward's launches on the CPU: the host plan of its CUDA
kernels, and a plain mirror of the wide body's decomposition.

* ``repro_torch.kernels.flash_attention_bwd.plan`` works out, on the host and
  from the shapes and dtype alone, which body runs (f32, bf16 up to Dh 128,
  the wide bf16 body past it), the grids of the row dots, dK/dV, the partial
  sum and dQ, the head subsets each kv tile's GQA group is cut into, the f32
  workspace of their partials and each kernel's dynamic shared memory. Its
  numbers here are worked out by hand from the note of
  ``csrc/flash_attention_bwd.cu``: 64-key tiles and 64-row query tiles; the
  whole group a dK/dV block unless the kv tiles give fewer than two waves of
  one block on the 132 SMs, else the fewest contiguous subsets that do; a
  workspace of subsets x 2 x B x Skv x Hkv x Dh floats; every (kv tile, head)
  pair summed by exactly one block.
* A plain f32 mirror of the wide body, written in this file with torch and
  on no path of the port, follows the kernels' blocks: dK and dV per (kv
  tile, head subset) over the query tiles that can see the tile, the
  subsets' partials added in order and dK scaled after; dQ per 64-row query
  tile over the kv tiles its rows can see. It is held within the bound of
  ``tests/test_torch_flash_bwd.py`` (1e-4 (1 + max |ref|)) against
  ``ref.mha_bwd`` and against ``jax.vjp`` of the JAX package's chunked path,
  at Dh 160, 192 and 256 with a window, q_offset, ragged Sq and Skv and rows
  that see no key, with the plan's subsets and with others (uneven ones
  included). Inputs are drawn from a numpy seed.

The kernels themselves run on the card only (tests/test_torch_cuda.py, which
also holds the plan's shared memory against the library's).
"""
import ast
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ref

TOL = 1e-4  # as tests/test_torch_flash_bwd.py
TRAIN = (4, 3072, 3072, 16, 1, 256)  # recurrentgemma-9b's train shape (window 2048)
WIDE_DKDV_SMEM, WIDE_DQ_SMEM = 228352, 227328
SMEM_PER_BLOCK = 232448  # the dynamic shared memory a block may opt in to on the H100

# (B, Sq, Skv, H, Hkv, Dh) -> (head subsets, dK/dV blocks, sum blocks, dQ blocks,
# workspace bytes), bf16
PLANS = {
    # 48 kv tiles x 4 rows = 192 < 264: two subsets of 8 heads, 384 blocks
    TRAIN: (((0, 8), (8, 16)), 384, 6144, 3072, 50331648),
    # qwen3-1.7b's train shape: the Dh 128 body, the whole group a block
    (4, 2048, 2048, 16, 8, 128): (((0, 2),), 1024, 0, 2048, 0),
    # 288 kv tiles: one subset, no workspace
    (4, 1100, 1100, 16, 4, 256): (((0, 4),), 288, 0, 1152, 0),
    # 132 kv tiles: two subsets of group 3, one of 1 head and one of 2
    (2, 2112, 2112, 6, 2, 160): (((0, 1), (1, 3)), 264, 2640, 396, 21626880),
    # 4 kv tiles: one head a subset
    (1, 200, 200, 16, 1, 256): (tuple((h, h + 1) for h in range(16)), 64, 100, 64, 6553600),
    # group 1: nothing to split
    (1, 130, 130, 4, 4, 256): (((0, 1),), 12, 0, 12, 0),
}


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("shape", list(PLANS), ids=lambda s: "-".join(map(str, s)))
def test_plan_subsets_grids_and_workspace(shape):
    p = fb.plan(*shape)
    subsets, dkdv, sums, dq, ws = PLANS[shape]
    assert (p.head_subsets, p.dkdv_grid, p.sum_grid, p.dq_grid, p.workspace_bytes) == (
        subsets, (dkdv, 1, 1), (sums if sums else 0, 1, 1), (dq, 1, 1), ws)
    B, Sq, Skv, H, Hkv, Dh = shape
    assert p.dot_grid == (_cdiv(B * Sq * H, 8), 1, 1)
    assert p.body == ("wide" if Dh > 128 else "mma")


def _blocks(p, B, Skv, H, Hkv):
    """(batch row, kv head, first key, heads) of each dK/dV block, as the wide
    kernel reads its block index: batch rows and kv heads fastest, then the
    subsets, then the kv tiles."""
    group, n = H // Hkv, len(p.head_subsets)
    for blk in range(p.dkdv_grid[0]):
        hb, rest = blk % (Hkv * B), blk // (Hkv * B)
        sub, kt = rest % n, rest // n
        kvh, b = hb % Hkv, hb // Hkv
        lo, hi = p.head_subsets[sub]
        yield b, kvh, kt * fb.TILE, range(kvh * group + lo, kvh * group + hi)


@pytest.mark.parametrize("shape", list(PLANS) + [(3, 70, 333, 12, 3, 192), (1, 1, 1, 7, 1, 160),
                                                 (5, 64, 64, 40, 8, 144)],
                         ids=lambda s: "-".join(map(str, s)))
def test_every_kv_tile_and_head_is_summed_by_one_block(shape):
    B, Sq, Skv, H, Hkv, Dh = shape
    p = fb.plan(*shape)
    if p.body != "wide":
        assert len(p.head_subsets) == 1
        return
    group = H // Hkv
    # the subsets cut the group into contiguous, non-empty, ordered pieces
    assert p.head_subsets[0][0] == 0 and p.head_subsets[-1][1] == group
    assert all(a[1] == b[0] for a, b in zip(p.head_subsets, p.head_subsets[1:]))
    assert all(hi > lo for lo, hi in p.head_subsets)
    seen = {}
    for b, kvh, k0, heads in _blocks(p, B, Skv, H, Hkv):
        assert 0 <= k0 < Skv
        for h in heads:
            assert h // group == kvh
            seen[(b, k0, h)] = seen.get((b, k0, h), 0) + 1
    want = {(b, k0, h) for b in range(B) for k0 in range(0, Skv, fb.TILE) for h in range(H)}
    assert set(seen) == want and set(seen.values()) == {1}


def test_train_shape_gives_two_waves_of_dkdv_blocks_and_a_small_workspace():
    p = fb.plan(*TRAIN)
    assert p.dkdv_grid[0] >= 2 * fb.SMS
    assert p.workspace_bytes < 128 * 10 ** 6  # the step peaks at 76.80 GB of 80
    assert len(p.head_subsets) == 2


@pytest.mark.parametrize("B,Skv,Hkv,group", [(1, 1, 1, 64), (1, 16896, 1, 64), (4, 64, 1, 256),
                                             (1, 16832, 1, 2), (132, 64, 1, 3), (2, 4096, 8, 4)])
def test_wide_plan_reaches_two_waves_where_the_group_allows(B, Skv, Hkv, group):
    p = fb.plan(B, 64, Skv, Hkv * group, Hkv, 256)
    tiles = _cdiv(Skv, fb.TILE) * Hkv * B
    n = len(p.head_subsets)
    assert p.dkdv_grid[0] == tiles * n
    if n < group:
        assert p.dkdv_grid[0] >= 2 * fb.SMS
    if n > 1:  # the fewest subsets that give two waves
        assert tiles * (n - 1) < 2 * fb.SMS
        assert p.workspace_bytes == 4 * 2 * B * Skv * Hkv * 256 * n < 128 * 10 ** 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", range(16, 257, 16))
def test_shared_memory_fits_a_block(dtype, Dh):
    p = fb.plan(*TRAIN[:5], Dh, dtype)
    assert max(p.dkdv_smem, p.dq_smem) <= SMEM_PER_BLOCK
    if dtype == torch.bfloat16 and Dh > 128:
        assert (p.dkdv_smem, p.dq_smem) == (WIDE_DKDV_SMEM, WIDE_DQ_SMEM)
    if dtype == torch.float32:
        assert p.head_subsets == ((0, 16),) and p.workspace_bytes == 0


def test_plan_of_the_f32_body():
    p = fb.plan(*TRAIN, torch.float32)
    assert (p.body, p.dkdv_grid, p.dq_grid, p.sum_grid) == ("f32", (96, 1, 4), (96, 16, 4),
                                                          (0, 1, 1))
    assert p.dkdv_smem == p.dq_smem == 4 * (4 * 32 * 257 + 2 * 32 * 33 + 2 * 32)


@pytest.mark.parametrize("shape", [(0, 8, 8, 2, 1, 64), (1, 0, 8, 2, 1, 64), (1, 8, 0, 2, 1, 64),
                                   (1, 8, 8, 3, 2, 64), (1, 8, 8, 2, 1, 72), (1, 8, 8, 2, 1, 272)])
def test_plan_refuses_what_the_kernels_do_not_take(shape):
    with pytest.raises(ValueError, match="flash_attention_bwd_cuda"):
        fb.plan(*shape)


def test_plan_reads_nothing_on_the_device(monkeypatch):
    """The plan is pure host arithmetic: no .item(), no synchronize."""
    def boom(*a, **k):
        raise AssertionError("the plan touched the device")
    monkeypatch.setattr(torch.Tensor, "item", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    monkeypatch.setattr(torch.cuda, "get_device_properties", boom)
    fb.plan.cache_clear()
    assert fb.plan(*TRAIN).head_subsets == PLANS[TRAIN][0]


def test_argtypes_match_the_c_entry():
    """ctypes passes each argument as the wrapper declares it: a pointer or
    the stream as a 64-bit void*, an int as a C int, the scale as a float, in
    the C entry's order."""
    src = (Path(fb.__file__).parent / "csrc" / "flash_attention_bwd.cu").read_text()
    params = re.search(r'extern "C" int flash_attention_bwd\(([^)]*)\)', src).group(1)
    kinds = [_ctypes_kind(p) for p in params.split(",")]
    assert kinds == [t.__name__ for t in fb.ARGTYPES]
    # the wrapper passes the plan's subsets and workspace where the C entry takes them
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    call = next(n for n in ast.walk(ast.parse(inspect.getsource(fb.flash_attention_bwd_cuda)))
                if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "fn")
    assert len(call.args) == len(names)
    assert ast.unparse(call.args[names.index("head_subsets")]) == "len(p.head_subsets)"
    assert (ast.unparse(call.args[names.index("workspace")])
            == "None if ws is None else ws.data_ptr()")


def _ctypes_kind(param: str) -> str:
    param = " ".join(param.split())
    if "*" in param:
        return "c_void_p"
    return {"int": "c_int", "float": "c_float"}[param.rsplit(" ", 1)[0]]


def test_plans_cover_chip_smokes_wide_cases():
    """chip_smoke.py's flash backward cases past Dh 128 include one with a
    single head subset, one with uneven subsets and the train shape."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    cases = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "FLASH_BWD_CASES")
    subsets = [fb.plan(*c[:6]).head_subsets for c in cases if c[5] > 128]
    assert ((0, 4),) in subsets                       # one subset, group 4
    assert ((0, 1), (1, 3)) in subsets                # uneven
    assert PLANS[TRAIN][0] in subsets


# --------------------------------------------------------------------------
# the mirror of the wide body
# --------------------------------------------------------------------------

def mirror(q, k, v, out, lse, dout, *, causal, window, q_offset, scale, subsets):
    """(dq, dk, dv) in f32 as the wide body's kernels compute them, block by
    block: the row dots D = rowsum(dO O); per (kv tile, head subset, kv head,
    batch row) the subset's sums of P^T dO and dS^T Q over the query tiles
    that can see the tile (rows past Sq skipped, as they are zero in the
    kernel); the subsets added in order, dK scaled after; per (64-row query
    tile, head, batch row) dS K over the kv tiles from the first its rows can
    see. P and dS come from the forward's lse, masked element by element."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group, T = H // Hkv, fb.TILE
    D = (dout * out).sum(-1)  # (B, Sq, H)

    def p_ds(b, h, q0, k0):
        qs, ks = slice(q0, min(q0 + T, Sq)), slice(k0, min(k0 + T, Skv))
        kvh = h // group
        qpos = torch.arange(qs.start, qs.stop)[:, None] + q_offset
        kpos = torch.arange(ks.start, ks.stop)[None, :]
        ok = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = q[b, qs, h] @ k[b, ks, kvh].T
        p = torch.where(ok, torch.exp(s * scale - lse[b, h, qs, None]), torch.zeros(()))
        ds = p * (dout[b, qs, h] @ v[b, ks, kvh].T - D[b, qs, h, None])
        return qs, ks, p, ds

    parts = torch.zeros(len(subsets), 2, B, Skv, Hkv, Dh)
    for sub, (lo, hi) in enumerate(subsets):
        for b in range(B):
            for kvh in range(Hkv):
                for k0 in range(0, Skv, T):
                    nk = min(T, Skv - k0)
                    q_lo = max(0, k0 - q_offset) if causal else 0
                    q_hi = (max(0, min(Sq, k0 + nk - 1 + window - q_offset)) if window > 0
                            else Sq)
                    for g in range(lo, hi):
                        h = kvh * group + g
                        for q0 in range(q_lo, q_hi, T):
                            qs, ks, p, ds = p_ds(b, h, q0, k0)
                            parts[sub, 1, b, ks, kvh] += p.T @ dout[b, qs, h]
                            parts[sub, 0, b, ks, kvh] += ds.T @ q[b, qs, h]
    dkdv = parts[0]
    for sub in range(1, len(subsets)):
        dkdv = dkdv + parts[sub]
    dk, dv = dkdv[0] * scale, dkdv[1]

    dq = torch.zeros(B, Sq, H, Dh)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, Sq, T):
                nq = min(T, Sq - q0)
                kv_lo, kv_hi = 0, Skv
                if causal:
                    kv_hi = max(0, min(Skv, q0 + nq - 1 + q_offset + 1))
                if window > 0:
                    kv_lo = max(0, q0 + q_offset - window + 1)
                for k0 in range(kv_lo, kv_hi, T):
                    qs, ks, _, ds = p_ds(b, h, q0, k0)
                    dq[b, qs, h] += ds @ k[b, ks, h // group]
    return dq * scale, dk, dv


def _inputs(seed, case):
    B, Sq, Skv, H, Hkv, Dh = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, Dh), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32),
            rng.standard_normal((B, Sq, H, Dh), dtype=np.float32))


def _saved(q, k, v, *, causal, window, q_offset, scale):
    """The forward's output and logsumexp (B, H, Sq), +inf on a row with no
    visible key."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    out = ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  softmax_scale=scale)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, H // Hkv, Dh), k) * scale
    mask = ref.attention_mask(Sq, k.shape[1], causal=causal, window=window, q_offset=q_offset)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1).reshape(B, H, Sq)
    return out, torch.where(torch.isinf(lse), torch.inf, lse)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * (1 + float(np.abs(want).max()))


MIRROR_CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset
    (1, 150, 150, 16, 1, 256, True, 40, 0),    # a window that cuts keys, group 16
    (2, 70, 135, 6, 2, 160, True, 50, 65),     # q_offset, ragged Sq and Skv, group 3
    (1, 80, 80, 8, 2, 192, True, 0, -16),      # rows with no visible key
    (1, 100, 100, 5, 1, 160, False, 0, 0),     # not causal, group 5
    (1, 130, 130, 2, 2, 256, True, 0, 0),      # group 1: one subset
]


@pytest.mark.parametrize("case", MIRROR_CASES, ids=lambda c: "-".join(map(str, c)))
def test_mirror_on_the_plans_subsets_vs_plain_and_jax(case):
    causal, window, q_offset = case[6:]
    scale = case[5] ** -0.5
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, dout = _inputs(1, case)
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    out, lse = _saved(*t[:3], scale=scale, **mask)
    subsets = fb.plan(*case[:6]).head_subsets
    got = mirror(*t[:3], out, lse, t[3], scale=scale, subsets=subsets, **mask)
    want = ref.mha_bwd(*t[:3], out, lse, t[3], softmax_scale=scale, **mask)
    for g, w in zip(got, want):
        _close(g, w)
    if q_offset < 0:  # jax's chunked path gives empty rows a uniform softmax
        return

    def f(q_, k_, v_):
        return jops.flash_attention(q_, k_, v_, softmax_scale=scale, impl="chunked",
                                    q_chunk=16, **mask)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(dout))):
        _close(g, w)


@pytest.mark.parametrize("subsets", [((0, 5),), ((0, 2), (2, 5)), ((0, 1), (1, 3), (3, 5)),
                                     tuple((h, h + 1) for h in range(5))],
                         ids=["whole", "2+3", "1+2+2", "each"])
def test_mirror_with_other_head_subsets_vs_plain(subsets):
    """However the group is cut, the subsets' sums added in order give the
    gradient: the plan's choice changes rounding only."""
    case = (2, 90, 110, 10, 2, 160, True, 48, 20)
    causal, window, q_offset = case[6:]
    scale = case[5] ** -0.5
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    t = [torch.from_numpy(a) for a in _inputs(2, case)]
    out, lse = _saved(*t[:3], scale=scale, **mask)
    got = mirror(*t[:3], out, lse, t[3], scale=scale, subsets=subsets, **mask)
    want = ref.mha_bwd(*t[:3], out, lse, t[3], softmax_scale=scale, **mask)
    for g, w in zip(got, want):
        _close(g, w)
