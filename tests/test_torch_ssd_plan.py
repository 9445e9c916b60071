"""The SSD scan on the CPU: the plan of its CUDA kernels, and the plain
version against the Pallas kernel at the chunk boundaries those kernels touch.

* ``repro_torch.kernels.ssd_scan.plan`` works out, on the host and from the
  shapes alone, the grids of the four kernels (chunk states, C·Bᵀ once per
  chunk, the state pass, the outputs) and the f32 workspace they share. Its
  numbers here are worked out by hand from the kernels' layouts (the header
  note of ``csrc/ssd_scan.cu``): at mamba2-1.3b's prefill, at the shapes of
  ``chip_smoke.py``'s SSD checks and at the smoke config's serve shape.
* ``ref.ssd_scan`` (what a CPU tensor takes) against ``ssd_scan_pallas`` in
  interpret mode, f32, where S is one chunk, several whole chunks, and
  chunk 1: within 5e-4, the bound of tests/test_torch_recurrent.py.

The kernels themselves run on the card only (tests/test_torch_cuda.py).
"""
import ast
import inspect

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.registry import get_config, get_smoke_config

# (B, S, H, P, N, chunk) -> (chunk run, chunks, tiles, tile pairs,
#  state, score, pass and output blocks, score, state and cum floats)
PLANS = {
    # mamba2-1.3b prefill: 4 prompts of 2048
    (4, 2048, 64, 64, 128, 256): (256, 8, 4, 10, 2048, 320, 8192, 8192,
                                  1310720, 16777216, 524288),
    # chip_smoke.py's SSD checks
    (2, 300, 8, 64, 128, 256): (256, 2, 4, 10, 32, 40, 512, 128, 163840, 262144, 8192),
    (2, 37, 3, 8, 16, 8): (8, 5, 1, 1, 30, 10, 3, 30, 40960, 3840, 240),
    (1, 100, 4, 16, 32, 32): (32, 4, 1, 1, 16, 4, 8, 16, 16384, 8192, 512),
    (2, 48, 2, 64, 128, 64): (48, 1, 1, 1, 4, 2, 128, 4, 8192, 32768, 192),
    (1, 1024, 4, 64, 128, 128): (128, 8, 2, 3, 32, 24, 128, 64, 98304, 262144, 4096),
    (2, 40, 3, 16, 32, 1): (1, 40, 1, 1, 240, 80, 12, 240, 327680, 122880, 240),
    # the smoke config served on the CPU: 2 prompts of 20
    (2, 20, 8, 16, 16, 8): (8, 3, 1, 1, 48, 6, 16, 48, 24576, 12288, 384),
}


@pytest.mark.parametrize("shape", list(PLANS), ids=lambda s: "-".join(map(str, s)))
def test_plan_grids_and_workspace(shape):
    p = tssd.plan(*shape)
    assert tuple(p) == PLANS[shape]
    assert p.workspace_floats == p.score_floats + p.state_floats + p.cum_floats


def test_plan_at_the_prefill_shape_follows_the_config():
    cfg = get_config("mamba2-1.3b")
    p = tssd.plan(4, 2048, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)
    assert tuple(p) == PLANS[(4, 2048, 64, 64, 128, 256)]
    # 8192 output blocks fill 132 SMs many times over, where one block per
    # (head, row) gave 256; C·Bᵀ is computed once per (row, chunk): 320 tiles
    assert 4 * p.workspace_floats == 74448896  # bytes of the f32 workspace
    smoke = get_smoke_config("mamba2-1.3b")
    assert (smoke.n_ssm_heads, smoke.ssm_head_dim, smoke.ssm_state,
            smoke.ssm_chunk) == (8, 16, 16, 8)


def test_plan_takes_the_chunk_as_at_most_s():
    assert tssd.plan(1, 100, 2, 8, 16, 256).chunk == 100
    assert tssd.plan(1, 256, 2, 8, 16, 300).chunk == 256


@pytest.mark.parametrize("shape", [
    (1, 512, 2, 8, 16, 0),          # chunk 0
    (1, 512, 2, 8, 16, 257),        # chunk past 256
    (1, 512, 2, 65, 16, 64),        # head dim past 64
    (1, 512, 2, 8, 129, 64),        # state past 128
    (1, 0, 2, 8, 16, 64),           # S 0
    (70000, 2 ** 20, 64, 64, 128, 1),  # a grid past 2^31 - 1 blocks
])
def test_plan_refuses_past_the_kernels_bounds(shape):
    with pytest.raises(ValueError, match="ssd_scan_cuda"):
        tssd.plan(*shape)


def test_plan_reads_nothing_on_the_device(monkeypatch):
    """The plan is pure host arithmetic: no .item(), no synchronize."""
    def boom(*a, **k):
        raise AssertionError("the plan touched the device")
    monkeypatch.setattr(torch.Tensor, "item", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    tssd.plan.cache_clear()
    assert tuple(tssd.plan(4, 2048, 64, 64, 128, 256)) == PLANS[(4, 2048, 64, 64, 128, 256)]


def test_the_wrapper_never_syncs_with_the_host():
    """No call in the wrapper module waits on the device or reads a device
    value back: what the launch needs comes from shapes and pointers."""
    tree = ast.parse(inspect.getsource(tssd))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"item", "synchronize", "tolist", "cpu", "numpy"}


def _ssd_np(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((B, S, H, P), dtype=np.float32),
                dt=(np.abs(rng.standard_normal((B, S, H))) * 0.3 + 0.01).astype(np.float32),
                A=(-np.abs(rng.standard_normal(H)) - 0.1).astype(np.float32),
                Bm=rng.standard_normal((B, S, N), dtype=np.float32),
                Cm=rng.standard_normal((B, S, N), dtype=np.float32))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 32, 64),     # S is one chunk of one kernel tile
    (1, 256, 2, 8, 16, 256),    # S is one chunk of four kernel tiles (10 tile pairs)
    (2, 192, 3, 8, 16, 64),     # three whole chunks: the state pass carries twice
    (1, 512, 2, 8, 16, 128),    # four whole chunks of two tiles
    (1, 8, 2, 4, 8, 1),         # chunk 1: every step its own chunk
])
def test_ssd_plain_vs_pallas_at_chunk_boundaries(B, S, H, P, N, chunk):
    a = _ssd_np(11, B, S, H, P, N)
    want_y, want_h = ssd_scan_pallas(*(jnp.asarray(a[k]) for k in ("x", "dt", "A", "Bm", "Cm")),
                                     chunk=chunk, interpret=True)
    y, h = ref.ssd_scan(*(torch.from_numpy(a[k]) for k in ("x", "dt", "A", "Bm", "Cm")),
                        chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=5e-4, rtol=5e-4)
