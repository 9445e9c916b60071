"""The port's MoE layer (local path) on the CPU against the JAX package's.

mixtral-8x7b's smoke config (4 experts, top-2, MoE every layer) and
llama4-maverick's (8 experts, top-1, MoE every 2nd layer, a shared expert),
with the JAX package's params copied over by ``params_from_jax`` and inputs
drawn from a numpy seed. Each smoke config also runs at capacity_factor 0.5,
where the expert buffers overflow, so that drops happen and must match.

Bounds, set from the dtype before the comparison:
* integers exactly: the routed expert indices, the capacity and the dispatch
  buffer positions (drops included) are bit-equal;
* the combine weights within 1e-6 relative: a softmax over the k top logits,
  whose f32 ``exp`` differs between XLA and PyTorch in the last bit for some
  inputs (about 9% of f32 inputs on the CPU for XLA against the correctly
  rounded value, 1% for PyTorch), so equal indices need not mean equal bits;
  with k = 1 both are exactly 1;
* the aux loss within 1e-6 relative (a few f32 ulps of sums over E experts);
* the layer output as tests/test_kernels.py bounds a kernel, atol = rtol =
  2e-5 in f32 and 2e-2 in bf16: the same products summed in another order, in
  bf16 rounded at other points;
* the re-blocked expert weights exactly (a permutation of the same values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama4_maverick as j_llama4
from repro.configs import mixtral_8x7b as j_mixtral
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch.configs import llama4_maverick as t_llama4
from repro_torch.configs import mixtral_8x7b as t_mixtral
from repro_torch.convert import params_from_jax
from repro_torch.models import moe, transformer

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REL = 1e-6
ARCHS = {"mixtral-8x7b": (j_mixtral, t_mixtral), "llama4-maverick": (j_llama4, t_llama4)}
CAPACITY = [1.25, 0.5]  # the configs' own factor, and one that overflows the buffers


def _configs(arch, **kw):
    jmod, tmod = ARCHS[arch]
    return jmod.SMOKE_CONFIG.replace(**kw), tmod.SMOKE_CONFIG.replace(**kw)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _moe_params(jcfg, tcfg, seed=0):
    """The last (MoE) position of the first unit: JAX's blocked layer and the
    port's copy of it."""
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(_np_tree(jp), tcfg)
    j = jax.tree_util.tree_map(lambda a: a[0], jp["backbone"]["units"][-1]["moe"])
    t = jax.tree_util.tree_map(lambda a: a[0], tp["backbone"]["units"][-1]["moe"])
    return j, t


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_tokens", [4, 96])  # a decode batch, a prefill
def test_route_matches_jax(arch, n_tokens):
    jcfg, tcfg = _configs(arch, **F32)
    jp, tp = _moe_params(jcfg, tcfg)
    x = _x(jcfg, (n_tokens, jcfg.d_model))
    jidx, jw, jaux = jmoe._route(jcfg, jp["router"], jnp.asarray(x))
    tidx, tw, taux = moe.route(tcfg, tp["router"], torch.from_numpy(x))
    assert tidx.shape == tw.shape == (n_tokens, jcfg.experts_per_token)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=REL, atol=0)
    if jcfg.experts_per_token == 1:
        assert (tw == 1.0).all()
    assert tw.dtype == torch.float32
    assert _rel(taux, jaux) <= REL


def test_route_breaks_ties_to_the_lower_expert_as_top_k():
    """Equal logits (a zero router) go to the lowest expert indices in
    ascending order, as ``jax.lax.top_k`` orders them."""
    jcfg, tcfg = _configs("mixtral-8x7b", **F32)
    router = np.zeros((jcfg.d_model, jcfg.n_experts), np.float32)
    x = _x(jcfg, (5, jcfg.d_model))
    jidx, jw, _ = jmoe._route(jcfg, jnp.asarray(router), jnp.asarray(x))
    tidx, tw, _ = moe.route(tcfg, torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx.numpy(), np.tile(np.arange(2), (5, 1)))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_capacity_matches_jax(arch, capacity_factor):
    for full in (False, True):
        jmod, tmod = ARCHS[arch]
        jcfg = (jmod.CONFIG if full else jmod.SMOKE_CONFIG).replace(
            capacity_factor=capacity_factor)
        tcfg = (tmod.CONFIG if full else tmod.SMOKE_CONFIG).replace(
            capacity_factor=capacity_factor)
        for n_tokens in (1, 4, 7, 96, 2048, 18432):
            assert moe.capacity(tcfg, n_tokens) == jmoe._capacity(jcfg, n_tokens)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_dispatch_indices_match_jax(arch, capacity_factor):
    """The buffer position of every assignment, -1 for a drop, from the same
    routed indices."""
    jcfg, tcfg = _configs(arch, **F32, capacity_factor=capacity_factor)
    jp, _ = _moe_params(jcfg, tcfg)
    x = _x(jcfg, (96, jcfg.d_model), seed=2)
    jidx, _, _ = jmoe._route(jcfg, jp["router"], jnp.asarray(x))
    E = jcfg.n_experts
    cap = jmoe._capacity(jcfg, 96)
    want, _ = jmoe._dispatch_indices(jcfg, jidx, jnp.int32(0), jnp.int32(E), E, cap)
    got = moe.dispatch_indices(torch.from_numpy(np.array(jidx)).long(), E, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dropped = int((got < 0).sum())
    if capacity_factor < 1:
        assert dropped > 0  # the overflow case really drops
    kept = got[got >= 0]
    assert len(torch.unique(kept)) == len(kept) and int(kept.max()) < E * cap


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_moe_layer_matches_jax(arch, dtype, capacity_factor):
    """``apply_moe`` (the local path and the shared expert) against the JAX
    package's ``apply_moe`` without a mesh (``_moe_compute_local`` plus the
    shared expert), on a prefill-shaped and a decode-shaped input."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype, capacity_factor=capacity_factor)
    jcfg, tcfg = _configs(arch, **kw)
    jp, tp = _moe_params(jcfg, tcfg)
    assert ("shared" in tp) == (jcfg.n_shared_experts > 0)
    for shape in ((2, 48, jcfg.d_model), (4, 1, jcfg.d_model)):
        x = _x(jcfg, shape, seed=3)
        jx = jnp.asarray(x).astype(dtype)
        jy, jaux = jmoe.apply_moe(jcfg, jp, jx)
        ty, taux = moe.apply_moe(tcfg, tp, torch.from_numpy(x).to(getattr(torch, dtype)))
        assert ty.dtype == getattr(torch, dtype) and ty.shape == shape
        np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert _rel(taux, jaux) <= REL


@pytest.mark.parametrize("arch,n_experts,blocks", [("mixtral-8x7b", 8, (8, 2)),
                                                   ("llama4-maverick", 128, (16, 1))])
def test_params_from_jax_reblocks_experts(arch, n_experts, blocks):
    """JAX's blocked (tp_hint 16, E/ep, D, F/fp) expert leaves become the
    port's (E, D, F) and (E, F, D), equal to what ``_moe_compute_local``
    reassembles, at the published expert counts (mixtral: ep 8 × fp 2,
    llama4: ep 16 × fp 1) and the smoke widths."""
    jcfg, tcfg = _configs(arch, n_experts=n_experts)
    assert moe.ep_fp(tcfg, 16) == jmoe._ep_fp(jcfg, 16) == blocks
    jp = _np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, tcfg)
    ep, fp = blocks
    E, D, F = n_experts, jcfg.d_model, jcfg.d_ff
    e_loc, f_loc = E // ep, F // fp
    for j_unit, t_unit in zip(jp["backbone"]["units"], tp["backbone"]["units"]):
        assert ("moe" in j_unit) == ("moe" in t_unit)
        if "moe" not in j_unit:
            continue
        j, t = j_unit["moe"], t_unit["moe"]
        n_units = j["w_gate"].shape[0]
        assert j["w_gate"].shape == (n_units, 16, e_loc, D, f_loc)
        for u in range(n_units):  # _moe_compute_local's reassembly, layer by layer
            for name in ("w_gate", "w_up"):
                want = np.concatenate(
                    [j[name][u].reshape(ep, fp, e_loc, D, f_loc)[:, i] for i in range(fp)],
                    axis=-1).reshape(E, D, F)
                np.testing.assert_array_equal(t[name][u].float().numpy(),
                                              want.astype(np.float32))
            want = np.concatenate(
                [j["w_down"][u].reshape(ep, fp, e_loc, f_loc, D)[:, i] for i in range(fp)],
                axis=-2).reshape(E, F, D)
            np.testing.assert_array_equal(t["w_down"][u].float().numpy(),
                                          want.astype(np.float32))
        assert t["router"].dtype == torch.float32  # the router stays f32 in a bf16 model
        assert t["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_sums_the_aux_loss_as_jax(arch):
    """The full-sequence stack: hidden states and the aux loss summed over
    the MoE layers."""
    jcfg, tcfg = _configs(arch, **F32)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), tcfg)
    x = _x(jcfg, (2, 20, jcfg.d_model), seed=5)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want, jaux = jtransformer.forward_hidden(jcfg, jp["backbone"], jnp.asarray(x),
                                             jnp.asarray(pos), remat=False)
    got, taux = transformer.forward_hidden(tcfg, tp["backbone"], torch.from_numpy(x),
                                           torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL["float32"], rtol=TOL["float32"])
    assert float(jaux) > 0 and _rel(taux, jaux) <= REL


def test_unit_structure_matches_jax():
    """llama4: units of (dense, MoE); mixtral: every layer MoE; a depth that
    is not whole units raises."""
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch)
        u = jtransformer._unit_size(jcfg)
        assert transformer._unit_size(tcfg) == u
        assert transformer._n_units(tcfg) == jtransformer._n_units(jcfg)
        assert [transformer._layer_is_moe(tcfg, i) for i in range(u)] == \
            [jtransformer._layer_is_moe(jcfg, i) for i in range(u)]
    _, tcfg = _configs("llama4-maverick", n_layers=3)
    with pytest.raises(ValueError, match="moe_every"):
        transformer.init_cache(tcfg, 1, 8, "cpu")
