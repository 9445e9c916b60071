"""The transformer family's other archs on the CPU against the JAX package.

granite-8b, phi4-mini-3.8b and llama3.2-3b (dense), mixtral-8x7b and
llama4-maverick-400b-a17b (moe, the local path), each on its smoke config
with the full config's ``rope_theta`` (the phi4 and llama3.2 smoke configs
are otherwise the same), the JAX package's params copied over by
``params_from_jax`` and prompts and batches drawn from a numpy seed, through
``lm.prefill``, ``lm.decode_step`` and ``lm.train_loss`` of both packages.
mixtral's smoke window of 32 is passed by a 40-token prompt, so that prefill
rotates the ring cache and decode overwrites its oldest slots.

Bounds, set from the dtype before the comparison. Logits as
tests/test_kernels.py bounds a kernel, atol = rtol = 2e-5 in f32 and 2e-2 in
bf16: the two packages do the same arithmetic in another order (XLA's fused
dots and chunked attention against PyTorch's matmuls and the port's plain
attention), and in bf16 they round at other points; f32 greedy tokens must be
equal. Training (dense archs) as tests/test_torch_train.py: the loss within
1e-5 relative and every gradient within 1e-4 of its leaf's largest magnitude.
Parameter counts exactly.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, synth_tokens
from repro_torch.models import lm
from repro_torch.models.registry import ARCHS as PORTED
from repro_torch.runtime import steps

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_REL, GRAD_OF_MAX = 1e-5, 1e-4
# arch id -> config module (the same name in both packages), prompt length
ARCHS = {"granite-8b": ("granite_8b", 24), "phi4-mini-3.8b": ("phi4_mini_3p8b", 24),
         "llama3.2-3b": ("llama3p2_3b", 24), "mixtral-8x7b": ("mixtral_8x7b", 40),
         "llama4-maverick-400b-a17b": ("llama4_maverick", 24)}
DENSE = [a for a in ARCHS if a in ("granite-8b", "phi4-mini-3.8b", "llama3.2-3b")]
DECODE_STEPS = 3


def _modules(name):
    return (importlib.import_module(f"repro.configs.{name}"),
            importlib.import_module(f"repro_torch.configs.{name}"))


def _configs(arch, **kw):
    jmod, tmod = _modules(ARCHS[arch][0])
    kw = dict(rope_theta=jmod.CONFIG.rope_theta, **kw)
    return jmod.SMOKE_CONFIG.replace(**kw), tmod.SMOKE_CONFIG.replace(**kw)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(_np_tree(jp), tcfg)


def _f32(x):
    return np.asarray(x, np.float32)


def _run_both(arch, dtype, *, B=2, steps, teacher_forced, seed=0):
    """Prefill, then ``steps`` decode steps in both packages: the tokens of
    each step are the JAX run's argmax in both when ``teacher_forced``, else
    each package's own. Returns each package's (logits, tokens) per step."""
    jcfg, tcfg = _configs(arch, **(F32 if dtype == "float32" else {}))
    jp, tp = _params(jcfg, tcfg, seed)
    S = ARCHS[arch][1]
    prompt = np.random.default_rng(seed).integers(0, jcfg.vocab_size, size=(B, S))
    max_len = S + steps + 1
    jl, jcache = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt, jnp.int32)}, max_len)
    tl, tcache = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(prompt)}, max_len)
    out = {"jax": [(_f32(jl), np.argmax(_f32(jl), -1))],
           "torch": [(tl.float().numpy(), tl.float().argmax(-1).numpy())]}
    for i in range(steps):
        jtok = out["jax"][-1][1].astype(np.int32)
        ttok = jtok if teacher_forced else out["torch"][-1][1].astype(np.int32)
        jl, jcache = jlm.decode_step(jcfg, jp, jcache, jnp.asarray(jtok),
                                     jnp.full((B,), S + i, jnp.int32))
        tl, tcache = lm.decode_step(tcfg, tp, tcache, torch.from_numpy(ttok),
                                    torch.full((B,), S + i, dtype=torch.int32))
        out["jax"].append((_f32(jl), np.argmax(_f32(jl), -1)))
        out["torch"].append((tl.float().numpy(), tl.float().argmax(-1).numpy()))
    return out, tcache


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(arch, dtype):
    out, cache = _run_both(arch, dtype, steps=DECODE_STEPS, teacher_forced=True)
    _, tcfg = _configs(arch)
    S = ARCHS[arch][1]
    if tcfg.window:  # the ring: fewer slots than the prompt
        assert cache["k"].shape[3] == tcfg.window < S
    for (jl, _), (tl, _) in zip(out["jax"], out["torch"]):
        assert tl.shape == (2, tcfg.vocab_size) and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_f32(arch):
    out, _ = _run_both(arch, "float32", B=3, steps=6, teacher_forced=False, seed=1)
    jt = np.stack([t for _, t in out["jax"]], 1)
    tt = np.stack([t for _, t in out["torch"]], 1)
    np.testing.assert_array_equal(tt, jt)


def _assert_tree_close(got, want, of_max):
    g, w = tree.leaf_paths(got), tree.leaf_paths(_np_tree(want))
    assert sorted(g) == sorted(w)
    for key in w:
        want_leaf = _f32(w[key])
        got_leaf = g[key].detach().float().numpy()
        bound = of_max * max(float(np.abs(want_leaf).max()), 1e-30)
        err = float(np.abs(got_leaf - want_leaf).max())
        assert err <= bound, f"{key}: max abs diff {err} > {bound}"


@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_and_every_gradient_match_jax(arch):
    """A ragged batch (S 37, the last 5 labels of one row ignored)."""
    jcfg, tcfg = _configs(arch, **F32)
    jp, tp = _params(jcfg, tcfg)
    host = {k: v.copy() for k, v in synth_tokens(
        tcfg, DataConfig(seq_len=37, global_batch=2, seed=3), 0, 1, 0).items()}
    host["labels"][1, -5:] = -100
    (jl, jm), jg = jax.value_and_grad(lambda p: jlm.train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in host.items()}), has_aux=True)(jp)
    tl, tm, tg = steps.loss_and_grads(tcfg, tp, {k: torch.from_numpy(v)
                                                 for k, v in host.items()})
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 37 - 5
    _assert_tree_close(tg, jg, GRAD_OF_MAX)


@pytest.mark.parametrize("arch", sorted(PORTED))
def test_configs_and_param_counts_match_jax(arch):
    """Every registered arch: the port's configs equal the JAX package's, and
    so do param_count and active_param_count (an MoE layer counts its
    experts_per_token routed experts as active)."""
    jmod, tmod = _modules(PORTED[arch])
    for jc, tc in ((jmod.CONFIG, tmod.CONFIG), (jmod.SMOKE_CONFIG, tmod.SMOKE_CONFIG)):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert (tc.active_param_count() < tc.param_count()) == (tc.n_experts > 0)
