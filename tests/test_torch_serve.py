"""The port's serve path on the CPU against the JAX package's.

qwen3-1.7b's smoke config (4 layers, d 64, 4 heads, 2 kv heads, vocabulary
512) with the JAX package's params copied over by ``params_from_jax``, and
prompts drawn from a numpy seed, through ``lm.prefill`` and
``lm.decode_step`` of both packages.

Bounds. In f32 the two packages do the same arithmetic in another order
(XLA's fused dots against PyTorch's matmuls, and the JAX chunked attention
against the port's plain one), so logits agree to a few f32 ulps of the
hidden state; 1e-4 absolute on logits of size ~0.1-1 leaves room for that
growth over 4 layers and still catches any wrong mask, rotation or slot. In
bf16 each package rounds its intermediates to bf16 at different points
(bf16 keeps 8 bits, a relative step of 2^-8 = 3.9e-3), so the bound is
3e-2 absolute, a few bf16 steps of the largest logits. (On these inputs the
largest differences seen were 2.4e-7 in f32 and 3.9e-3 in bf16, on logits up
to 1.34.)
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs.qwen3_1p7b import SMOKE_CONFIG as JAX_SMOKE
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs.qwen3_1p7b import SMOKE_CONFIG
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import layers, lm

F32_TOL = 1e-4
BF16_TOL = 3e-2

F32 = dict(param_dtype="float32", compute_dtype="float32")
RING = dict(attention_kind="sliding", window=8)


def _configs(**kw):
    return JAX_SMOKE.replace(**kw), SMOKE_CONFIG.replace(**kw)


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)


def _f32(x):
    return np.asarray(x, np.float32)


def _run_both(jcfg, tcfg, *, B, S, steps, max_len, seed=0):
    """Prefill then ``steps`` greedy decode steps in both packages. Returns
    the per-step logits and tokens of each."""
    jp, tp = _params(jcfg, tcfg, seed)
    prompt = np.random.default_rng(seed).integers(0, jcfg.vocab_size, size=(B, S))
    jl, jcache = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                             max_len)
    tl, tcache = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(prompt)}, max_len)
    out = {"jax": [(_f32(jl), np.argmax(_f32(jl), -1))],
           "torch": [(tl.float().numpy(), tl.float().argmax(-1).numpy())]}
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    for i in range(steps):
        jl, jcache = jlm.decode_step(jcfg, jp, jcache, jtok,
                                     jnp.full((B,), S + i, jnp.int32))
        tl, tcache = lm.decode_step(tcfg, tp, tcache, ttok,
                                    torch.full((B,), S + i, dtype=torch.int32))
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        out["jax"].append((_f32(jl), np.asarray(jtok)))
        out["torch"].append((tl.float().numpy(), ttok.numpy()))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype):
    kw = F32 if dtype == "float32" else {}
    jcfg, tcfg = _configs(**kw)
    out = _run_both(jcfg, tcfg, B=2, S=24, steps=2, max_len=32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for (jl, _), (tl, _) in zip(out["jax"], out["torch"]):
        assert tl.shape == (2, jcfg.vocab_size) and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, atol=tol, rtol=0)


def test_greedy_tokens_match_jax_f32():
    jcfg, tcfg = _configs(**F32)
    out = _run_both(jcfg, tcfg, B=3, S=16, steps=8, max_len=24, seed=1)
    jt = np.stack([t for _, t in out["jax"]], 1)
    tt = np.stack([t for _, t in out["torch"]], 1)
    np.testing.assert_array_equal(tt, jt)


def test_ring_cache_prefill_and_decode_match_jax():
    """A sliding window of 8 over a 16-token prompt: the cache holds 8 slots,
    prefill rotates the last 8 keys so slot = pos % 8, and decode inserts at
    pos % 8 over the oldest entry."""
    jcfg, tcfg = _configs(**F32, **RING)
    out = _run_both(jcfg, tcfg, B=2, S=16, steps=4, max_len=24, seed=2)
    for (jl, jt), (tl, tt) in zip(out["jax"], out["torch"]):
        np.testing.assert_allclose(tl, jl, atol=F32_TOL, rtol=0)
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("cache_size", [5, 16, 20])
def test_attention_prefill_kv_matches_jax(cache_size):
    """Ring rotation (C < S), exact fit and zero padding (C > S); the fused
    prefill's attention output against JAX's ``apply_attention``."""
    jcfg, tcfg = _configs(**F32)
    jp, tp = _params(jcfg, tcfg)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["backbone"]["units"][0]["attn"])
    tattn = {k: v[0] for k, v in tp["backbone"]["units"][0]["attn"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(3, 19, dtype=np.int32), (2, 16))
    jk, jv = jlayers.attention_prefill_kv(jcfg, jattn, jnp.asarray(x),
                                          jnp.asarray(pos), cache_size)
    jy = jlayers.apply_attention(jcfg, jattn, jnp.asarray(x), jnp.asarray(pos))
    ty, tk, tv = layers.apply_attention_prefill(tcfg, tattn, torch.from_numpy(x),
                                                torch.from_numpy(pos.copy()), cache_size)
    assert tk.shape == (2, cache_size, jcfg.n_kv_heads, jcfg.head_dim)
    np.testing.assert_allclose(ty.numpy(), _f32(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), _f32(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), _f32(jv), atol=1e-5, rtol=0)


def test_forward_hidden_matches_jax():
    """The full-sequence stack (no cache), as training will run it."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer
    jcfg, tcfg = _configs(**F32)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want, _ = jtransformer.forward_hidden(jcfg, jp["backbone"], jnp.asarray(x),
                                          jnp.asarray(pos), remat=False)
    got, aux = transformer.forward_hidden(tcfg, tp["backbone"], torch.from_numpy(x),
                                          torch.from_numpy(pos))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=F32_TOL, rtol=0)


def test_rope_matches_jax_split_halves():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=2e-5, rtol=0)


def test_serve_main_runs_on_cpu_when_asked():
    result = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                         "--requests", "4", "--batch", "2", "--prompt-len", "12",
                         "--gen-len", "3"])
    assert result["finite"]
    assert result["total_tokens"] == 2 * 2 * 3
    assert result["ttft"].count == 2 and result["tpot"].count == 6
    assert tuple(result["tokens"].shape) == (4, 4)


def test_serve_main_refuses_to_run_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke", "--requests", "2",
                    "--batch", "2", "--prompt-len", "8", "--gen-len", "2"])


def test_registry_names_roadmap_for_unported_archs():
    from repro.configs.qwen3_1p7b import CONFIG as JAX_CONFIG
    from repro_torch.models.registry import get_config
    assert dataclasses.asdict(get_config("qwen3-1.7b")) == dataclasses.asdict(JAX_CONFIG)
    assert dataclasses.asdict(SMOKE_CONFIG) == dataclasses.asdict(JAX_SMOKE)
    assert get_config("qwen3-1.7b").param_count() == JAX_CONFIG.param_count()
    with pytest.raises(KeyError, match="ROADMAP.md"):
        get_config("hubert-xxlarge")  # an id the JAX package's registry lacks too


def test_moe_config_raises():
    """An MoE config's cache has JAX's (n_units, unit, B, C, Hkv, Dh) shape,
    and only a depth that is not whole units of moe_every raises, as the JAX
    package's ``_n_units`` asserts."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer
    kw = dict(family="moe", n_experts=4, experts_per_token=1, moe_every=2)
    jcfg, tcfg = _configs(**kw)
    got = transformer.init_cache(tcfg, 3, 8, "cpu")
    want = jtransformer.init_cache(jcfg, 3, 8)
    assert tuple(got["k"].shape) == want["k"].shape == (2, 2, 3, 8, 2, 16)
    assert got["k"].dtype == got["v"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="moe_every"):
        transformer.init_cache(tcfg.replace(n_layers=5), 1, 8, "cpu")
