"""The SSD scan's gradient on the CPU: the plain backward, the backward
kernels' plan, and the autograd.Function around them.

* ``ref.ssd_scan_bwd`` (explicit formulas, in the phase order of the CUDA
  backward) against ``jax.vjp`` of the JAX package's chunked SSD
  (``repro.kernels.ops.ssd_scan(..., impl="chunked")``) with random
  cotangents on y and on the final state, and against ``torch.autograd``
  through the port's ``ref.ssd_scan``. Inputs from numpy with a seed, f32.
  Both sides compute the same sums in another order in f32: each gradient
  within 1e-4 of its largest magnitude (about 1e-6 is measured; a wrong
  decay, mask or head sum moves a gradient by order 100% of it).
* ``ssd_scan_bwd.plan``: grids and workspace worked out by hand from the
  kernels' layouts (the note at the top of ``csrc/ssd_scan_bwd.cu``), and
  its refusals.
* ``ssd_scan.SSDScan`` with its two kernel calls replaced by the plain
  versions: what it saves, what it hands the backward and what it returns
  for inputs without a gradient. The kernels themselves run on the card only
  (``tests/test_torch_cuda.py``).
"""
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import ssd_scan_bwd as tbwd
from repro_torch.models.registry import get_config

GRAD_OF_MAX = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")

# B, S, H, P, N, chunk, h0, a cotangent on the final state
CASES = [
    (2, 32, 3, 8, 16, 8, True, True),      # S a multiple of the chunk, N > P, H > 1
    (2, 37, 3, 8, 16, 8, True, True),      # S ragged: the last chunk padded by 3
    (1, 50, 2, 16, 8, 16, False, True),    # ragged, P > N, no h0
    (2, 40, 3, 16, 32, 1, True, False),    # chunk 1: every step its own chunk
    (1, 64, 4, 4, 6, 64, False, False),    # one chunk; only y has a cotangent
    (1, 100, 2, 5, 7, 32, True, True),     # P and N not multiples of 4
]


def _inputs(case, seed=0):
    B, S, H, P, N, _, with_h0, with_dh = case
    rng = np.random.default_rng(seed)
    a = dict(x=rng.standard_normal((B, S, H, P), dtype=np.float32),
             dt=(np.abs(rng.standard_normal((B, S, H))) * 0.3 + 0.01).astype(np.float32),
             A=(-np.abs(rng.standard_normal(H)) - 0.1).astype(np.float32),
             Bm=rng.standard_normal((B, S, N), dtype=np.float32),
             Cm=rng.standard_normal((B, S, N), dtype=np.float32),
             dy=rng.standard_normal((B, S, H, P), dtype=np.float32))
    a["h0"] = rng.standard_normal((B, H, P, N), dtype=np.float32) if with_h0 else None
    a["dh"] = rng.standard_normal((B, H, P, N), dtype=np.float32) if with_dh else None
    return a


def _plain_bwd(a, chunk):
    t = {k: (torch.from_numpy(v) if v is not None else None) for k, v in a.items()}
    return ref.ssd_scan_bwd(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"], t["dy"],
                            t["dh"], chunk=chunk)


def _assert_close(name, got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bound = GRAD_OF_MAX * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{name}: max abs diff {err} > {bound}"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_jax_vjp_of_the_chunked_ssd(case):
    chunk, with_h0 = case[5], case[6]
    a = _inputs(case)
    names = ("x", "dt", "A", "Bm", "Cm") + (("h0",) if with_h0 else ())

    def fwd(*args):
        kw = dict(zip(names, args))
        return jops.ssd_scan(kw["x"], kw["dt"], kw["A"], kw["Bm"], kw["Cm"], chunk=chunk,
                             h0=kw.get("h0"), impl="chunked")
    (y, hf), vjp = jax.vjp(fwd, *(jnp.asarray(a[k]) for k in names))
    dh = a["dh"] if a["dh"] is not None else np.zeros(hf.shape, np.float32)
    want = vjp((jnp.asarray(a["dy"]), jnp.asarray(dh)))
    got = _plain_bwd(a, chunk)
    assert (got[5] is None) == (not with_h0)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(name, g, w)
    assert got[0].dtype == torch.float32 and got[3].dtype == torch.float32


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_autograd_through_the_plain_forward(case):
    chunk, with_h0 = case[5], case[6]
    a = _inputs(case, seed=1)
    leaves = [torch.from_numpy(a[k]).requires_grad_(True) for k in ("x", "dt", "A", "Bm", "Cm")]
    h0 = torch.from_numpy(a["h0"]).requires_grad_(True) if with_h0 else None
    y, hf = ref.ssd_scan(*leaves, chunk=chunk, h0=h0)
    loss = (y * torch.from_numpy(a["dy"])).sum()
    if a["dh"] is not None:
        loss = loss + (hf * torch.from_numpy(a["dh"])).sum()
    want = torch.autograd.grad(loss, leaves + ([h0] if with_h0 else []))
    got = _plain_bwd(a, chunk)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(name, g, w.numpy())


def test_plain_backward_rounds_its_outputs_to_the_input_dtype():
    a = _inputs(CASES[1])
    t = {k: (torch.from_numpy(v) if v is not None else None) for k, v in a.items()}
    bf = {k: (t[k].to(torch.bfloat16) if k in ("x", "Bm", "Cm", "dy") else t[k]) for k in t}
    got = ref.ssd_scan_bwd(bf["x"], bf["dt"], bf["A"], bf["Bm"], bf["Cm"], bf["h0"],
                           bf["dy"], bf["dh"], chunk=8)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16, torch.float32]
    want = ref.ssd_scan_bwd(*(bf[k].float() if bf[k] is not None else None
                              for k in ("x", "dt", "A", "Bm", "Cm", "h0", "dy", "dh")),
                            chunk=8)
    for g, w in zip(got, want):  # the f32 math of the rounded inputs, rounded once
        assert torch.equal(g, w.to(g.dtype))


# -- the plan of the backward kernels ----------------------------------------------

# The dynamic shared memory (bytes) of dstate, scores, dbc_part, dbc_sum and dx
# for bf16 inputs, the same at every shape: f32 tiles of 64 x 64, 64 x 128 and
# 256 cum (dstate); two stages of dy and x as 64 x 72 bf16 with three rows of
# 64 floats, 4 x 64 column sums and 2 x 64 row sums (scores); a 64 x 72 bf16 row tile, hi and
# lo of a 64 x 136 bf16 state, the rows' own C or B as 64 x 136 bf16 and
# three rows of 64 floats (dbc_part); M 64 x 68 and 64 x 128 rows, f32
# (dbc_sum);
# B as 64 x 136 bf16, hi and lo of g as 64 x 136 bf16, 256 cum, 8 warp sums
# and 2 x 64 row sums (dx).
BF16_SMEM = (4 * (64 * 64 + 64 * 128 + 256), 2 * (2 * 64 * 72 * 2 + 3 * 64 * 4) + 6 * 64 * 4,
             64 * 72 * 2 + 2 * 64 * 136 * 2 + 64 * 136 * 2 + 3 * 64 * 4,
             4 * (64 * 68 + 64 * 128), 64 * 136 * 2 + 2 * 64 * 136 * 2 + (256 + 8 + 128) * 4)
# f32 inputs split every operand into three bf16 tiles: two more of dy and of
# x in each stage (scores), of the row tile, one more of the state, and the own
# rows in f32 (dbc_part), two more of B and one more of g (dx)
F32_SMEM = (BF16_SMEM[0], BF16_SMEM[1] + 2 * 2 * 2 * 64 * 72 * 2,
            BF16_SMEM[2] + 2 * 64 * 72 * 2 + 64 * 136 * 2 + 64 * 136 * 2, BF16_SMEM[3],
            BF16_SMEM[4] + 2 * 64 * 136 * 2 + 64 * 136 * 2)

# (B, S, H, P, N, chunk) -> (chunk run, chunks, tiles, tile pairs, head groups;
#  dstate, pass, scores, dbc_part, dbc_sum, dx, dt and dA blocks; M, dB/dC part,
#  state-gradient, partial, row and chunk floats) + BF16_SMEM
PLANS = {
    # mamba2-1.3b train: 4 sequences of 2048
    (4, 2048, 64, 64, 128, 256): (256, 8, 4, 10, 8, 2048, 8192, 2560, 2048, 256, 8192, 2048,
                                  1, 10485760, 16777216, 16777216, 2621440, 1572864, 4096)
                                 + BF16_SMEM,
    # chip_smoke.py's SSD backward checks
    (2, 300, 8, 64, 128, 256): (256, 2, 4, 10, 1, 32, 512, 40, 32, 32, 128, 32, 1,
                                163840, 262144, 262144, 40960, 24576, 64) + BF16_SMEM,
    (2, 37, 3, 8, 16, 8): (8, 5, 1, 1, 1, 30, 3, 10, 20, 20, 30, 30, 1,
                           40960, 163840, 3840, 3840, 720, 60) + BF16_SMEM,
    (2, 40, 3, 16, 32, 1): (1, 40, 1, 1, 1, 240, 12, 80, 160, 160, 240, 240, 1,
                            327680, 1310720, 122880, 30720, 720, 480) + BF16_SMEM,
    (1, 1024, 4, 64, 128, 128): (128, 8, 2, 3, 1, 32, 128, 24, 32, 32, 64, 32, 1,
                                 98304, 262144, 262144, 12288, 12288, 64) + BF16_SMEM,
    # the smoke config trained on the CPU: 2 sequences of 32
    (2, 32, 8, 16, 16, 8): (8, 4, 1, 1, 1, 64, 16, 8, 16, 16, 64, 64, 1,
                            32768, 131072, 16384, 8192, 1536, 128) + BF16_SMEM,
}
SMEM_FIELDS = ("dstate_smem", "scores_smem", "dbc_part_smem", "dbc_sum_smem", "dx_smem")


@pytest.mark.parametrize("shape", list(PLANS), ids=lambda s: "-".join(map(str, s)))
def test_backward_plan_grids_and_workspace(shape):
    p = tbwd.plan(*shape)
    assert tuple(p) == PLANS[shape]
    assert p.workspace_floats == (p.m_floats + p.dbc_part_floats + p.grad_state_floats
                                  + p.partial_floats + p.row_floats + p.chunk_floats)
    f = tssd.plan(*shape)  # the forward's chunking, which the backward reads back
    assert (p.chunk, p.n_chunks, p.n_tiles, p.n_pairs) == (f.chunk, f.n_chunks, f.n_tiles,
                                                           f.n_pairs)
    assert p.grad_state_floats == f.state_floats
    assert p.m_floats == p.n_groups * f.score_floats  # a C·Bᵀ-sized tile per head group


def test_backward_plan_at_the_train_shape_follows_the_config():
    cfg = get_config("mamba2-1.3b")
    p = tbwd.plan(4, 2048, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)
    assert tuple(p) == PLANS[(4, 2048, 64, 64, 128, 256)]
    assert 4 * p.workspace_floats == 192954368  # bytes: the CUDA source note's 193 MB
    # the 64 heads' sums for M and for dB and dC run over 8 groups of 8: a
    # part per group (not per head), 8 x the blocks of one group of 64
    assert p.n_groups == 8 and p.dbc_part_blocks == 8 * p.dbc_sum_blocks == 8 * 2 * 4 * 32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", list(PLANS), ids=lambda s: "-".join(map(str, s)))
def test_backward_plan_shared_memory_fits_a_block_at_every_shape(shape, dtype):
    p = tbwd.plan(*shape, dtype)
    smem = tuple(getattr(p, f) for f in SMEM_FIELDS)
    assert smem == (BF16_SMEM if dtype == torch.bfloat16 else F32_SMEM)
    assert all(0 < b <= 232448 for b in smem)  # the H100's shared memory a block
    # the grids and the workspace do not depend on the dtype
    assert tuple(p)[:-5] == tuple(tbwd.plan(*shape))[:-5]


@pytest.mark.parametrize("shape", [
    (1, 512, 2, 8, 16, 0),          # chunk 0
    (1, 512, 2, 8, 16, 257),        # chunk past 256
    (1, 512, 2, 65, 16, 64),        # head dim past 64
    (1, 512, 2, 8, 129, 64),        # state past 128
    (1, 0, 2, 8, 16, 64),           # S 0
    (70000, 2 ** 20, 64, 64, 128, 1),  # a grid past 2^31 - 1 blocks
])
def test_backward_plan_refuses_past_the_kernels_bounds(shape):
    with pytest.raises(ValueError, match="ssd_scan(_bwd)?_cuda"):
        tbwd.plan(*shape)


def test_backward_wrapper_refuses_cpu_tensors_and_mixed_dtypes():
    a = {k: torch.from_numpy(v) for k, v in _inputs(CASES[1]).items() if v is not None}
    args = (a["x"], a["dt"], a["A"], a["Bm"], a["Cm"], a["h0"], a["dy"], a["dh"])
    with pytest.raises(ValueError, match="one CUDA device"):
        tbwd.ssd_scan_bwd_cuda(*args, chunk=8, fwd_workspace=torch.empty(0))
    assert tbwd.launches == 0


def test_the_backward_wrapper_never_syncs_with_the_host():
    tree = ast.parse(inspect.getsource(tbwd))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"item", "synchronize", "tolist", "cpu", "numpy"}


# -- the autograd.Function, its kernels replaced by the plain versions -------------

@pytest.fixture
def plain_kernels(monkeypatch):
    """SSDScan with ``_forward`` and ``ssd_scan_bwd_cuda`` on the plain
    versions; records what the backward was handed."""
    seen = {}

    def forward(x, dt, A, Bm, Cm, *, chunk, h0):
        y, hf = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        return y, hf, torch.full((3,), 7.0)  # a workspace the backward must be handed

    def backward(x, dt, A, Bm, Cm, h0, dy, dh_final, *, chunk, fwd_workspace):
        seen.update(chunk=chunk, ws=fwd_workspace, dh_final=dh_final, dy=dy)
        return ref.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh_final, chunk=chunk)
    monkeypatch.setattr(tssd, "_forward", forward)
    monkeypatch.setattr(tbwd, "ssd_scan_bwd_cuda", backward)
    return seen


@pytest.mark.parametrize("case", [CASES[1], CASES[2]], ids=["h0", "no-h0"])
def test_ssd_scan_function_gradients_and_saved_workspace(plain_kernels, case):
    chunk, with_h0 = case[5], case[6]
    a = _inputs(case, seed=2)
    leaves = [torch.from_numpy(a[k]).requires_grad_(True) for k in ("x", "dt", "A", "Bm", "Cm")]
    h0 = torch.from_numpy(a["h0"]).requires_grad_(True) if with_h0 else None
    want_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    want_h0 = h0.detach().clone().requires_grad_(True) if with_h0 else None
    dy, dh = torch.from_numpy(a["dy"]), torch.from_numpy(a["dh"])

    y, hf = tssd.SSDScan.apply(*leaves, h0, chunk)
    got = torch.autograd.grad((y * dy).sum() + (hf * dh).sum(),
                              leaves + ([h0] if with_h0 else []))
    yw, hw = ref.ssd_scan(*want_leaves, chunk=chunk, h0=want_h0)
    want = torch.autograd.grad((yw * dy).sum() + (hw * dh).sum(),
                               want_leaves + ([want_h0] if with_h0 else []))
    assert torch.equal(plain_kernels["ws"], torch.full((3,), 7.0))
    assert plain_kernels["chunk"] == chunk and torch.equal(plain_kernels["dh_final"], dh)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(name, g, w.numpy())


def test_ssd_scan_function_makes_no_zeros_for_an_unused_final_state(plain_kernels):
    a = _inputs(CASES[0], seed=3)
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    rest = [torch.from_numpy(a[k]) for k in ("dt", "A", "Bm", "Cm")]
    y, _ = tssd.SSDScan.apply(x, *rest, None, 8)
    (dx,) = torch.autograd.grad(y.sum(), [x])
    assert plain_kernels["dh_final"] is None  # training's case: the final state unused
    want = ref.ssd_scan_bwd(x.detach(), *rest, None, torch.ones_like(x), None, chunk=8)[0]
    assert torch.equal(dx, want)


def test_ssd_scan_cuda_takes_the_function_only_under_autograd(plain_kernels, monkeypatch):
    calls = []
    monkeypatch.setattr(tssd.SSDScan, "apply",
                        staticmethod(lambda *a: calls.append(a) or ("y", "h")))
    a = {k: torch.from_numpy(v) for k, v in _inputs(CASES[0]).items() if v is not None}
    x = a["x"].requires_grad_(True)
    assert tssd.ssd_scan_cuda(x, a["dt"], a["A"], a["Bm"], a["Cm"], chunk=8) == ("y", "h")
    with torch.no_grad():
        y, _ = tssd.ssd_scan_cuda(x, a["dt"], a["A"], a["Bm"], a["Cm"], chunk=8)
    assert len(calls) == 1 and y.shape == x.shape and y.grad_fn is None
