"""The RG-LRU scan's chunked algorithm on the CPU: the plan of its CUDA
kernels, and a plain mirror of the kernels' three phases.

* ``repro_torch.kernels.rglru_scan.plan`` works out, on the host and from
  the shapes alone, the chunk length L, the grids of the three kernels
  (chunk products and end states, the pass over the chunks, the outputs)
  and their f32 workspace. Its numbers here are worked out by hand from the
  header note of ``csrc/rglru_scan.cu``: L = min(64, S) unless S needs more
  than 65535 chunks; ceil(S / L) chunks; grids of ceil(W / 128) blocks of
  128 channels by (chunks - 1, B), (B, 1) and (chunks, B); a workspace of
  2 B (chunks - 1) W floats.
* A plain f32 mirror of chunk -> pass -> out, written in this file with
  numpy and on no path of the port, follows the plan's chunks: each chunk's
  decay product and end state from h = 0, the pass h <- P h + E from h0,
  then each chunk's steps from the state entering it. It is held within
  1e-5 (relative, and absolute near 0) against ``rglru_scan_pallas`` in
  interpret mode, against the JAX package's associative scan
  (``repro.kernels.ops.rglru_scan``) and against the port's sequential
  ``ref.rglru_scan``, with and without h0, where S is one step, L - 1, L,
  L + 1, 3L + 5 and not a multiple of L, at ragged W, at other chunk
  lengths, and where a_log is 0 so that a is 1 and the gate is 1e-6.
  Inputs are drawn from a numpy seed.

The kernels themselves run on the card only (tests/test_torch_cuda.py).
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
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as trglru
from repro_torch.models.registry import get_config

MIRROR_TOL = 1e-5

# (B, S, W) -> (L, chunks, chunk grid, pass grid, out grid, workspace floats)
PLANS = {
    # recurrentgemma-9b prefill: 4 prompts of 3072, 6144 chunk and out blocks
    (4, 3072, 4096): (64, 48, (32, 47, 4), (32, 4, 1), (32, 48, 4), 1540096),
    # chip_smoke.py's RG-LRU checks
    (3, 1001, 1000): (64, 16, (8, 15, 3), (8, 3, 1), (8, 16, 3), 90000),  # last chunk 41 steps
    (2, 7, 33): (7, 1, (1, 0, 2), (1, 2, 1), (1, 1, 2), 0),          # S < L: one chunk
    (1, 256, 512): (64, 4, (4, 3, 1), (4, 1, 1), (4, 4, 1), 3072),
    (2, 1, 33): (1, 1, (1, 0, 2), (1, 2, 1), (1, 1, 2), 0),          # S 1
    (2, 65, 33): (64, 2, (1, 1, 2), (1, 2, 1), (1, 2, 2), 132),      # S = L + 1
    (2, 197, 33): (64, 4, (1, 3, 2), (1, 2, 1), (1, 4, 2), 396),     # S = 3L + 5
    (2, 63, 33): (63, 1, (1, 0, 2), (1, 2, 1), (1, 1, 2), 0),        # S = L - 1
    (2, 64, 33): (64, 1, (1, 0, 2), (1, 2, 1), (1, 1, 2), 0),        # S = L
    # one prompt of 3072: 1536 blocks, under one wave of full SMs
    (1, 3072, 4096): (64, 48, (32, 47, 1), (32, 1, 1), (32, 48, 1), 385024),
    # a large grid, the last chunk of 1 step
    (66, 2113, 4096): (64, 34, (32, 33, 66), (32, 66, 1), (32, 34, 66), 17842176),
    # 65535 chunks of 64 fill a grid dimension; one step more and L grows to 65
    (1, 64 * 65535, 1): (64, 65535, (1, 65534, 1), (1, 1, 1), (1, 65535, 1), 131068),
    (1, 64 * 65535 + 1, 1): (65, 64527, (1, 64526, 1), (1, 1, 1), (1, 64527, 1), 129052),
    (1, 2 ** 31 - 1, 1): (32769, 65535, (1, 65534, 1), (1, 1, 1), (1, 65535, 1), 131068),
}


@pytest.mark.parametrize("shape", list(PLANS), ids=lambda s: "-".join(map(str, s)))
def test_plan_chunk_grids_and_workspace(shape):
    p = trglru.plan(*shape)
    assert tuple(p) == PLANS[shape]
    B, S, W = shape
    assert p.chunk * (p.n_chunks - 1) < S <= p.chunk * p.n_chunks
    assert max(p.chunk_grid[1:] + p.out_grid[1:]) <= trglru.MAX_GRID_YZ
    assert p.workspace_floats == 2 * B * (p.n_chunks - 1) * W


def test_plans_cover_chip_smokes_rglru_checks():
    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    cases = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "RGLRU_CASES")
    assert {case[:3] for case in cases} <= set(PLANS)


def test_plan_at_the_prefill_shape_follows_the_config():
    cfg = get_config("recurrentgemma-9b")
    W = cfg.lru_width or cfg.d_model
    p = trglru.plan(4, 3072, W)
    assert tuple(p) == PLANS[(4, 3072, 4096)]
    # 6144 chunk and out blocks (786 432 threads), where one thread per (b, w)
    # gave 128 blocks; the workspace is 6.16 MB of f32
    assert 4 * p.workspace_floats == 6160384
    assert 128 * p.out_grid[0] * p.out_grid[1] * p.out_grid[2] == 786432


@pytest.mark.parametrize("shape", [(0, 8, 8), (1, 0, 8), (1, 8, 0), (65536, 8, 8)])
def test_plan_refuses_what_the_grids_cannot_take(shape):
    with pytest.raises(ValueError, match="rglru_scan_cuda"):
        trglru.plan(*shape)


def test_plan_reads_nothing_on_the_device(monkeypatch):
    """The plan is pure host arithmetic: no .item(), no synchronize."""
    def boom(*a, **k):
        raise AssertionError("the plan touched the device")
    monkeypatch.setattr(torch.Tensor, "item", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    trglru.plan.cache_clear()
    assert tuple(trglru.plan(4, 3072, 4096)) == PLANS[(4, 3072, 4096)]


def test_the_wrapper_never_syncs_with_the_host():
    """No call in the wrapper module waits on the device or reads a device
    value back: what the launch needs comes from shapes and pointers."""
    tree = ast.parse(inspect.getsource(trglru))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"item", "synchronize", "tolist", "cpu", "numpy"}


def test_argtypes_match_the_c_entry():
    """ctypes passes each argument as the wrapper declares it: a pointer or
    the stream as a 64-bit void*, an int as a C int, in the C entry's order."""
    src = (Path(trglru.__file__).parent / "csrc" / "rglru_scan.cu").read_text()
    params = re.search(r'extern "C" int rglru_scan_fwd\(([^)]*)\)', src).group(1).split(",")
    kinds = [ctypes_kind(p) for p in params]
    assert kinds == [t.__name__ for t in trglru.ARGTYPES]


def ctypes_kind(param: str) -> str:
    param = " ".join(param.split())
    return "c_void_p" if "*" in param else {"int": "c_int"}[param.rsplit(" ", 1)[0]]


# --------------------------------------------------------------------------
# the mirror of the three kernels
# --------------------------------------------------------------------------

def _gates(np_like):
    def gates(x, a_log):
        a = np_like.exp(a_log)
        return a, np_like.sqrt(np_like.maximum(1.0 - a * a, 1e-12)) * x
    return gates


def torch_gates(x, a_log):
    """a and the gated input as ``ref.rglru_scan`` computes them."""
    a = torch.exp(torch.from_numpy(a_log))
    g = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * torch.from_numpy(x)
    return a.numpy(), g.numpy()


def jnp_gates(x, a_log):
    """As the JAX package's associative path computes them, op by op."""
    a, g = _gates(jnp)(jnp.asarray(x), jnp.asarray(a_log))
    return np.asarray(a), np.asarray(g)


def jit_gates(x, a_log):
    """As XLA compiles the Pallas body's elementwise prologue in interpret
    mode, fused into one jitted computation."""
    a, g = jax.jit(_gates(jnp))(jnp.asarray(x), jnp.asarray(a_log))
    return np.asarray(a), np.asarray(g)


def mirror(a, g, h0, L):
    """chunk -> pass -> out in f32 numpy over the decays a and the gated
    inputs g (B, S, W), chunks of L steps (the last may be shorter); returns
    (y, h_last) with h_last y's last row. a and g come from the reference the
    mirror is held against: near a = 1, where 1 - a^2 cancels, one ulp of a
    moves the gate by up to half, and XLA's and PyTorch's exp and fused
    elementwise code differ in the last ulp. What the mirror checks is the
    order of the scan."""
    B, S, W = a.shape
    nc = -(-S // L)
    f32 = np.float32
    # 1. each chunk but the last from h = 0: decay product and end state
    prod = np.empty((B, nc - 1, W), f32)
    end = np.empty((B, nc - 1, W), f32)
    for c in range(nc - 1):
        h, p = np.zeros((B, W), f32), np.ones((B, W), f32)
        for t in range(c * L, (c + 1) * L):
            h = a[:, t] * h + g[:, t]
            p = p * a[:, t]
        prod[:, c], end[:, c] = p, h
    # 2. the states entering each chunk, folded in chunk order
    h = h0.astype(f32) if h0 is not None else np.zeros((B, W), f32)
    enter = [h]
    for c in range(nc - 1):
        h = prod[:, c] * h + end[:, c]
        enter.append(h)
    # 3. each chunk's steps from the state entering it
    y = np.empty((B, S, W), f32)
    for c in range(nc):
        h = enter[c]
        for t in range(c * L, min((c + 1) * L, S)):
            h = a[:, t] * h + g[:, t]
            y[:, t] = h
    return y, y[:, -1]


def _inputs(seed, B, S, W, *, unit_decay=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W), dtype=np.float32)
    a_log = (-np.abs(rng.standard_normal((B, S, W))) * 0.5).astype(np.float32)
    if unit_decay:  # a = 1: the gate is sqrt(1e-12) = 1e-6, and h0 carries through
        a_log = np.where(rng.random((B, S, W)) < 0.5, 0.0, -1e-9).astype(np.float32)
    h0 = rng.standard_normal((B, W), dtype=np.float32)
    return x, a_log, h0


def _close(got, want):
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=MIRROR_TOL,
                               atol=MIRROR_TOL)


# (B, S, W, blk_s, blk_w of the Pallas kernel, which must divide S and W)
MIRROR_CASES = [
    (2, 1, 33, 1, 33),          # S 1
    (2, 63, 33, 63, 33),        # S = L - 1: one chunk
    (2, 64, 33, 64, 33),        # S = L
    (2, 65, 33, 65, 33),        # S = L + 1: a last chunk of one step
    (2, 197, 33, 197, 33),      # S = 3L + 5
    (1, 256, 512, 256, 512),    # chip_smoke.py's check, 4 chunks
    (3, 1001, 1000, 143, 1000),  # chip_smoke.py's ragged check, 16 chunks
]


@pytest.mark.parametrize("B,S,W,blk_s,blk_w", MIRROR_CASES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("with_h0", [False, True])
def test_mirror_on_the_plans_chunks_vs_pallas_jax_and_plain(B, S, W, blk_s, blk_w, with_h0):
    x, a_log, h0 = _inputs(21, B, S, W)
    h0 = h0 if with_h0 else None
    L = trglru.plan(B, S, W).chunk
    jh0 = None if h0 is None else jnp.asarray(h0)
    py, ph = rglru_scan_pallas(jnp.asarray(x), jnp.asarray(a_log), h0=jh0, blk_s=blk_s,
                               blk_w=blk_w, interpret=True)
    jy, jh = jops.rglru_scan(jnp.asarray(x), jnp.asarray(a_log), h0=jh0, impl="chunked")
    ry, rh = ref.rglru_scan(torch.from_numpy(x), torch.from_numpy(a_log),
                            h0=None if h0 is None else torch.from_numpy(h0))
    for gates, want_y, want_h in ((jit_gates, py, ph), (jnp_gates, jy, jh),
                                  (torch_gates, ry, rh)):
        y, h_last = mirror(*gates(x, a_log), h0, L)
        _close(y, want_y)
        _close(h_last, want_h)


@pytest.mark.parametrize("S,L", [(200, 8), (192, 32), (130, 16), (64, 1)])
def test_mirror_at_other_chunk_lengths_vs_plain(S, L):
    """The three phases hold for any L: a multiple of L, a short last
    chunk, L 1 (every step its own chunk), with h0."""
    x, a_log, h0 = _inputs(22, 2, S, 40)
    y, h_last = mirror(*torch_gates(x, a_log), h0, L)
    ry, rh = ref.rglru_scan(torch.from_numpy(x), torch.from_numpy(a_log),
                            h0=torch.from_numpy(h0))
    _close(y, ry)
    _close(h_last, rh)
    jy, _ = jops.rglru_scan(jnp.asarray(x), jnp.asarray(a_log), h0=jnp.asarray(h0),
                            impl="chunked")
    _close(mirror(*jnp_gates(x, a_log), h0, L)[0], jy)


def test_mirror_with_unit_decay_carries_h0_across_chunks():
    """a_log 0 (a = 1 in f32): the decay products are 1, the gate 1e-6, and
    h0 reaches every chunk through the pass."""
    B, S, W = 2, 197, 33
    x, a_log, h0 = _inputs(23, B, S, W, unit_decay=True)
    L = trglru.plan(B, S, W).chunk
    assert -(-S // L) == 4
    y, h_last = mirror(*jit_gates(x, a_log), h0, L)
    py, ph = rglru_scan_pallas(jnp.asarray(x), jnp.asarray(a_log), h0=jnp.asarray(h0),
                               interpret=True)
    ry, _ = ref.rglru_scan(torch.from_numpy(x), torch.from_numpy(a_log),
                           h0=torch.from_numpy(h0))
    _close(y, py)
    _close(h_last, ph)
    _close(mirror(*torch_gates(x, a_log), h0, L)[0], ry)
    np.testing.assert_allclose(y[:, -1], h0 + 1e-6 * x.sum(1), rtol=1e-6, atol=1e-6)
