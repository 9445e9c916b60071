"""The encoder and the VLM on the CPU against the JAX package: their layers
(LayerNorm, the GELU MLP), the two frontends, and hubert-xlarge and
internvl2-26b through ``lm.prefill``, ``lm.decode_step`` and
``lm.train_loss``.

Each arch runs its smoke config with the full config's ``rope_theta``, the
JAX package's params copied over by ``params_from_jax`` and inputs drawn
from numpy seeds (frames, patches, tokens; batches from the shared
pipeline).

Bounds, set from the dtype before the comparison, as
tests/test_torch_archs.py sets them. Logits and layer outputs: atol = rtol
= 2e-5 in f32 and 2e-2 in bf16 (tests/test_kernels.py's kernel bounds: the
same arithmetic in another order, and in bf16 rounded at other points). f32
greedy tokens equal. The loss within 1e-5 relative, every gradient within
1e-4 of its leaf's largest magnitude, and a leaf whose JAX gradient is all
zero (hubert-xlarge's ``embed.tok``: no frame reads it) exactly zero. The
GELU is the tanh form that ``jax.nn.gelu`` computes by default: within 2e-6
of it over [-8, 8] in f32, where torch's default erf form is more than 1e-4
off.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, synth_tokens
from repro_torch.models import layers, lm
from repro_torch.runtime import steps

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_REL, GRAD_OF_MAX = 1e-5, 1e-4
MODULES = {"hubert-xlarge": "hubert_xlarge", "internvl2-26b": "internvl2_26b"}
S_TEXT = 24      # the VLM's prompt text; its smoke config puts 16 patches before it
S_FRAMES = 40    # the encoder's frames
DECODE_STEPS = 3


def _configs(arch, **kw):
    name = MODULES[arch]
    jmod = importlib.import_module(f"repro.configs.{name}")
    tmod = importlib.import_module(f"repro_torch.configs.{name}")
    kw = dict(rope_theta=jmod.CONFIG.rope_theta, **kw)
    return jmod.SMOKE_CONFIG.replace(**kw), tmod.SMOKE_CONFIG.replace(**kw)


def _dtype_kw(dtype):
    return F32 if dtype == "float32" else {}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(_np_tree(jp), tcfg)


def _f32(x):
    return np.asarray(x, np.float32)


def _both(host, dtype=None):
    """A numpy batch as each package's inputs (floats cast to ``dtype``
    where given, in both alike)."""
    jb, tb = {}, {}
    for k, v in host.items():
        if v.dtype.kind == "f" and dtype is not None:
            jb[k] = jnp.asarray(v, jnp.dtype(dtype))
            tb[k] = torch.from_numpy(np.asarray(v, np.float32)).to(getattr(torch, dtype))
        else:
            jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(np.ascontiguousarray(v))
    return jb, tb


def _assert_tree_close(got, want, of_max):
    g, w = tree.leaf_paths(got), tree.leaf_paths(_np_tree(want))
    assert sorted(g) == sorted(w)
    for key in w:
        want_leaf = _f32(w[key])
        got_leaf = g[key].detach().float().numpy()
        bound = of_max * max(float(np.abs(want_leaf).max()), 1e-30)
        err = float(np.abs(got_leaf - want_leaf).max())
        assert err <= bound, f"{key}: max abs diff {err} > {bound}"
        if not want_leaf.any():  # a leaf the loss does not reach
            assert not got_leaf.any(), f"{key}: JAX's gradient is all zero, the port's not"


# -- the layers ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype, seed):
    """A learned scale and bias (not the init's ones and zeros), inputs with
    an offset so that the mean matters, eps from the config."""
    jcfg, tcfg = _configs("hubert-xlarge", param_dtype=dtype, compute_dtype=dtype)
    rng = np.random.default_rng(seed)
    D = jcfg.d_model
    x = (rng.standard_normal((3, 17, D)) * 2.0 + rng.standard_normal(D)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(D)).astype(np.float32)}
    jx, tx = _both({"x": x}, dtype)
    jp, tp = _both(p, dtype)
    want = _f32(jlayers.apply_norm(jcfg, jp, jx["x"]))
    got = layers.apply_norm(tcfg, tp, tx["x"])
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=TOL[dtype])


def test_init_norm_has_the_layernorm_bias():
    jcfg, tcfg = _configs("hubert-xlarge")
    want = _np_tree(jlayers.init_norm(jcfg))
    got = layers.init_norm(tcfg, "cpu")
    assert sorted(got) == sorted(want) == ["bias", "scale"]
    for k in want:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(), _f32(want[k]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype, seed):
    """The JAX package's init (biases made non-zero) and inputs large enough
    that u reaches the GELU's curved part."""
    jcfg, tcfg = _configs("hubert-xlarge", param_dtype=dtype, compute_dtype=dtype)
    jp = jlayers.init_mlp(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = {k: (v + jnp.asarray(rng.standard_normal(v.shape) * 0.5, v.dtype)
              if k.startswith("b_") else v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(_f32(v).copy()).to(getattr(torch, dtype)) for k, v in jp.items()}
    assert sorted(tp) == ["b_down", "b_up", "w_down", "w_up"]
    x = (rng.standard_normal((2, 13, jcfg.d_model)) * 20.0).astype(np.float32)
    jx, tx = _both({"x": x}, dtype)
    want = _f32(jlayers.apply_mlp(jcfg, jp, jx["x"]))
    got = layers.apply_mlp(tcfg, tp, tx["x"])
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=TOL[dtype])


def test_init_mlp_keys_and_shapes_match_jax():
    jcfg, tcfg = _configs("hubert-xlarge")
    want = _np_tree(jlayers.init_mlp(jcfg, jax.random.PRNGKey(0)))
    got = layers.init_mlp(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert not got["b_up"].any() and not got["b_down"].any()


def test_gelu_is_the_tanh_form_jax_computes():
    x = np.linspace(-8, 8, 20001, dtype=np.float32)
    want = _f32(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    assert float(np.abs(got - want).max()) <= 2e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert float(np.abs(erf - want).max()) > 1e-4  # the trap: torch's default form


# -- the frontends ------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(MODULES))
def test_embed_inputs_match_jax(arch):
    """x, positions and labels of each frontend: the frames cast to the
    compute dtype; the patches before the embedded text, P leading -100s."""
    jcfg, tcfg = _configs(arch, **F32)
    jp, tp = _params(jcfg, tcfg)
    host = synth_tokens(tcfg, DataConfig(seq_len=37, global_batch=2, seed=1), 0, 1, 0)
    jb, tb = _both(host)
    jx, jpos, jlab = jlm._embed_inputs(jcfg, jp, jb)
    tx, tpos, tlab = lm._embed_inputs(tcfg, tp, tb)
    assert tx.shape == jx.shape == (2, 37, jcfg.d_model)
    np.testing.assert_allclose(tx.numpy(), _f32(jx), atol=0, rtol=0)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    if arch == "internvl2-26b":
        assert (tlab[:, :tcfg.n_patches] == -100).all()


# -- hubert-xlarge ---------------------------------------------------------------------

def _frames(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(
        np.float32) * 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_prefill_logits_match_jax(dtype):
    jcfg, tcfg = _configs("hubert-xlarge", **_dtype_kw(dtype))
    assert not tcfg.causal and not tcfg.has_decode
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _both({"frames": _frames(jcfg, 2, S_FRAMES, 3)}, jcfg.compute_dtype)
    jl, jcache = jlm.prefill(jcfg, jp, jb, S_FRAMES)
    tl, tcache = lm.prefill(tcfg, tp, tb, S_FRAMES)
    assert tl.shape == (2, tcfg.vocab_size) and bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.float().numpy(), _f32(jl), atol=TOL[dtype], rtol=TOL[dtype])
    # the caches hold every layer's keys, which pass through all the layers before
    np.testing.assert_allclose(tcache["k"].float().numpy(), _f32(jcache["k"]),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_hubert_train_loss_and_every_gradient_match_jax():
    """A ragged batch (S 37, the last 5 labels of one row ignored); the
    embedding no frame reads has a zero gradient in both packages."""
    jcfg, tcfg = _configs("hubert-xlarge", **F32)
    jp, tp = _params(jcfg, tcfg)
    host = {k: v.copy() for k, v in synth_tokens(
        tcfg, DataConfig(seq_len=37, global_batch=2, seed=3), 0, 1, 0).items()}
    host["labels"][1, -5:] = -100
    jb, tb = _both(host)
    (jl, jm), jg = jax.value_and_grad(lambda p: jlm.train_loss(jcfg, p, jb), has_aux=True)(jp)
    tl, tm, tg = steps.loss_and_grads(tcfg, tp, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 37 - 5
    assert not np.asarray(jg["embed"]["tok"]).any()
    assert tg["embed"]["tok"].shape == tp["embed"]["tok"].shape
    assert tg["embed"]["tok"].dtype == tp["embed"]["tok"].dtype
    _assert_tree_close(tg, jg, GRAD_OF_MAX)
    assert not any(p.requires_grad for p in tree.leaf_paths(tp).values())


def test_hubert_is_bidirectional():
    """A frame changed at the end moves the first position's hidden state
    (an encoder's attention sees both ways) in both packages alike."""
    jcfg, tcfg = _configs("hubert-xlarge", **F32)
    jp, tp = _params(jcfg, tcfg)
    f = _frames(jcfg, 1, 12, 5)
    g = f.copy()
    g[:, -1] = _frames(jcfg, 1, 1, 6)[:, 0]  # a new last frame (a constant shift would
    # vanish in the LayerNorm)
    outs = []
    for frames in (f, g):
        jb, tb = _both({"frames": frames})
        x, pos, _ = lm._embed_inputs(tcfg, tp, tb)
        h, _ = lm.backbone(tcfg).forward_hidden(tcfg, tp["backbone"], x, pos)
        jx, jpos, _ = jlm._embed_inputs(jcfg, jp, jb)
        jh, _ = jlm.backbone(jcfg).forward_hidden(jcfg, jp["backbone"], jx, jpos)
        np.testing.assert_allclose(h.numpy(), _f32(jh), atol=2e-5, rtol=2e-5)
        outs.append(h[0, 0].numpy())
    assert float(np.abs(outs[0] - outs[1]).max()) > 1e-3


# -- internvl2-26b -----------------------------------------------------------------------

def _vlm_prompt(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S_TEXT)).astype(np.int32),
            "patches": (rng.standard_normal((B, cfg.n_patches, cfg.d_model)) * 0.02
                        ).astype(np.float32)}


def _vlm_run_both(dtype, *, B=2, steps_, teacher_forced, seed=0):
    """Prefill of the patches and text, then ``steps_`` decode steps at
    positions P + S_text + i, in both packages: the tokens of each step are
    the JAX run's argmax in both when ``teacher_forced``, else each
    package's own."""
    jcfg, tcfg = _configs("internvl2-26b", **_dtype_kw(dtype))
    jp, tp = _params(jcfg, tcfg, seed)
    jb, tb = _both(_vlm_prompt(jcfg, B, seed), jcfg.compute_dtype)
    S = jcfg.n_patches + S_TEXT
    max_len = S + steps_ + 1
    jl, jcache = jlm.prefill(jcfg, jp, jb, max_len)
    tl, tcache = lm.prefill(tcfg, tp, tb, max_len)
    assert tcache["k"].shape[3] == max_len
    out = {"jax": [(_f32(jl), np.argmax(_f32(jl), -1))],
           "torch": [(tl.float().numpy(), tl.float().argmax(-1).numpy())]}
    for i in range(steps_):
        jtok = out["jax"][-1][1].astype(np.int32)
        ttok = jtok if teacher_forced else out["torch"][-1][1].astype(np.int32)
        jl, jcache = jlm.decode_step(jcfg, jp, jcache, jnp.asarray(jtok),
                                     jnp.full((B,), S + i, jnp.int32))
        tl, tcache = lm.decode_step(tcfg, tp, tcache, torch.from_numpy(ttok),
                                    torch.full((B,), S + i, dtype=torch.int32))
        out["jax"].append((_f32(jl), np.argmax(_f32(jl), -1)))
        out["torch"].append((tl.float().numpy(), tl.float().argmax(-1).numpy()))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_internvl2_prefill_and_decode_logits_match_jax(dtype):
    out = _vlm_run_both(dtype, steps_=DECODE_STEPS, teacher_forced=True)
    assert len(out["torch"]) == DECODE_STEPS + 1
    for (jl, _), (tl, _) in zip(out["jax"], out["torch"]):
        assert tl.shape == (2, 512) and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, atol=TOL[dtype], rtol=TOL[dtype])


def test_internvl2_greedy_tokens_match_jax_f32():
    out = _vlm_run_both("float32", B=3, steps_=6, teacher_forced=False, seed=1)
    jt = np.stack([t for _, t in out["jax"]], 1)
    tt = np.stack([t for _, t in out["torch"]], 1)
    np.testing.assert_array_equal(tt, jt)


def test_internvl2_patches_move_the_logits():
    """The text attends to the patches before it (early fusion): other
    patches, other logits, in both packages alike."""
    jcfg, tcfg = _configs("internvl2-26b", **F32)
    jp, tp = _params(jcfg, tcfg)
    host = _vlm_prompt(jcfg, 1, 2)
    outs = []
    for scale in (1.0, 50.0):
        h = {**host, "patches": host["patches"] * scale}
        jb, tb = _both(h)
        jl, _ = jlm.prefill(jcfg, jp, jb, 48)
        tl, _ = lm.prefill(tcfg, tp, tb, 48)
        np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-5, rtol=2e-5)
        outs.append(tl.numpy())
    assert float(np.abs(outs[0] - outs[1]).max()) > 1e-3


@pytest.mark.parametrize("seq_len", [37, 48])
def test_internvl2_train_loss_and_every_gradient_match_jax(seq_len):
    """The pipeline's VLM batch (seq_len - 16 text tokens after 16 patches),
    the last 5 text labels of one row ignored: ``tokens`` counts the valid
    text labels only, the patch positions never."""
    jcfg, tcfg = _configs("internvl2-26b", **F32)
    jp, tp = _params(jcfg, tcfg)
    host = {k: v.copy() for k, v in synth_tokens(
        tcfg, DataConfig(seq_len=seq_len, global_batch=2, seed=3), 0, 1, 0).items()}
    host["labels"][1, -5:] = -100
    s_text = seq_len - tcfg.n_patches
    assert host["tokens"].shape == host["labels"].shape == (2, s_text)
    jb, tb = _both(host)
    (jl, jm), jg = jax.value_and_grad(lambda p: jlm.train_loss(jcfg, p, jb), has_aux=True)(jp)
    tl, tm, tg = steps.loss_and_grads(tcfg, tp, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * s_text - 5
    _assert_tree_close(tg, jg, GRAD_OF_MAX)
