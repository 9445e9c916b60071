"""The port's MoE train path on the CPU against the JAX package's.

mixtral-8x7b's smoke config (4 experts, top-2, MoE every layer, a 32-key
window) and llama4-maverick's (8 experts, top-1, MoE every 2nd layer, a
shared expert), in f32 where numbers are compared, with the JAX params and
optimizer state copied over by ``repro_torch.convert`` and batches from the
numpy pipeline. Each runs at its config's capacity factor (1.25) and at 0.5,
where the expert buffers overflow and assignments are dropped.

Bounds, set from the dtype before the comparison, as
tests/test_torch_train.py sets them: the loss within 1e-5 relative (the same
f32 arithmetic in another order); every gradient within 1e-4 of its leaf's
largest magnitude (4 layers of such sums); the aux loss within 1e-6 relative
(a few f32 ulps of sums over E experts, as tests/test_torch_moe.py bounds
it). Layout changes (re-blocking the experts), checkpoints, the routes of a
recompute and the gradient a dropped token gets are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama4_maverick as j_llama4
from repro.configs import mixtral_8x7b as j_mixtral
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import stream_factory as jax_stream_factory
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import llama4_maverick as t_llama4
from repro_torch.configs import mixtral_8x7b as t_mixtral
from repro_torch.convert import (block_experts, map_experts, opt_state_from_jax,
                                 params_from_jax, unblock_experts)
from repro_torch.data.pipeline import DataConfig, synth_tokens
from repro_torch.launch import train as train_launch
from repro_torch.models import layers, lm, moe, transformer
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime, TrainerState

F32 = dict(param_dtype="float32", compute_dtype="float32")
LOSS_REL, GRAD_OF_MAX, AUX_REL = 1e-5, 1e-4, 1e-6
CPU = torch.device("cpu")
ARCHS = {"mixtral-8x7b": (j_mixtral, t_mixtral),
         "llama4-maverick-400b-a17b": (j_llama4, t_llama4)}
CAPACITY = [1.25, 0.5]  # the configs' own factor, and one that drops assignments
TP_HINT = 16  # the blocking of jax's init_moe_layer


def _configs(arch, **kw):
    jmod, tmod = ARCHS[arch]
    return jmod.SMOKE_CONFIG.replace(**kw), tmod.SMOKE_CONFIG.replace(**kw)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(_np_tree(jp), tcfg)


def _batch(cfg, seq_len=37, global_batch=2, seed=3, step=0):
    """A host batch with a ragged S and the last 5 labels of row 1 ignored."""
    host = synth_tokens(cfg, DataConfig(seq_len=seq_len, global_batch=global_batch,
                                        seed=seed), 0, 1, step)
    host = {k: v.copy() for k, v in host.items()}  # labels view the tokens' array
    host["labels"][1, -5:] = -100
    return host


def _unblocked(jtree, cfg):
    """A numpy copy of a JAX param-shaped tree in the port's expert layout."""
    return map_experts(_np_tree(jtree), lambda m: unblock_experts(m, cfg))


def _assert_close(got, want, of_max, what=""):
    """Each leaf of the port's tree within ``of_max`` of the numpy tree's
    leaf's largest magnitude; both trees keyed alike."""
    g, w = tree.leaf_paths(got), tree.leaf_paths(want)
    assert sorted(g) == sorted(w)
    for key in w:
        want_leaf = np.asarray(w[key], np.float32)
        got_leaf = g[key].detach().float().numpy()
        assert got_leaf.shape == want_leaf.shape, key
        bound = of_max * max(float(np.abs(want_leaf).max()), 1e-30)
        err = float(np.abs(got_leaf - want_leaf).max())
        assert err <= bound, f"{what}{key}: max abs diff {err} > {bound}"


def _assert_bit_equal(a, b):
    ga, gb = tree.leaf_paths(a), tree.leaf_paths(b)
    assert sorted(ga) == sorted(gb)
    for key in ga:
        x, y = ga[key], gb[key]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), key
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tobytes() == y.tobytes(), key


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


# -- loss and gradients -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_train_loss_and_every_gradient_match_jax(arch, capacity_factor):
    """``steps.loss_and_grads`` against ``jax.value_and_grad(jlm.train_loss)``
    (the JAX gradients re-blocked), drops included at capacity factor 0.5."""
    jcfg, tcfg = _configs(arch, capacity_factor=capacity_factor, **F32)
    jp, tp = _params(jcfg, tcfg)
    host = _batch(tcfg)
    (jl, jm), jg = jax.value_and_grad(lambda p: jlm.train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in host.items()}), has_aux=True)(jp)
    tl, tm, tg = steps.loss_and_grads(tcfg, tp, {k: torch.from_numpy(v)
                                                 for k, v in host.items()})
    assert _rel(tl, jl) <= LOSS_REL and _rel(tm["xent"], jm["xent"]) <= LOSS_REL
    assert float(jm["aux"]) > 0 and _rel(tm["aux"], jm["aux"]) <= AUX_REL
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 37 - 5
    _assert_close(tg, _unblocked(jg, tcfg), GRAD_OF_MAX)
    for u in tg["backbone"]["units"]:  # the experts of every MoE layer are reached
        if "moe" in u:
            assert all(bool(u["moe"][n].abs().amax(dim=(1, 2, 3)).min() > 0)
                       for n in ("w_gate", "w_up", "w_down"))
    assert not any(p.requires_grad for p in tree.leaf_paths(tp).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` of each package from the same params and
    optimizer state (carried over by params_from_jax and opt_state_from_jax),
    then a second: the metrics, the first moment (0.1 of the clipped
    gradient) and |g| read back from the second moment, at the gradients'
    bound; the second step's loss, which reads the updated params, at the
    loss bound."""
    jcfg, tcfg = _configs(arch, **F32)
    jp, tp = _params(jcfg, tcfg, seed=2)
    jopt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    topt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    js = jadamw.init(jopt, jp)
    ts = opt_state_from_jax(_np_tree(js), tcfg)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    tstep = steps.make_train_step(tcfg, topt)
    for i in range(2):
        host = _batch(tcfg, seed=5, step=i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in host.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in host.items()})
        assert _rel(tm["loss"], jm["loss"]) <= LOSS_REL, i
        assert _rel(tm["aux"], jm["aux"]) <= AUX_REL, i
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= LOSS_REL, i
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6 and int(ts.step) == int(js.step) == i + 1
        if i == 0:
            _assert_close(ts.m, _unblocked(js.m, tcfg), GRAD_OF_MAX, "m/")
            g_abs = jax.tree_util.tree_map(lambda v: np.sqrt(np.asarray(v) / (1 - jopt.beta2)),
                                           js.v)
            _assert_close(tree.tree_map(lambda v: torch.sqrt(v / (1 - topt.beta2)), ts.v),
                          _unblocked(g_abs, tcfg), GRAD_OF_MAX, "|g|/")


# -- the expert layouts -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", [1, 2, 8, TP_HINT])
def test_block_experts_inverts_unblock_experts(arch, tp):
    """block_experts ∘ unblock_experts is the identity, bit for bit, on the
    JAX init's experts (re-blocked from tp 16 into ``tp`` by the port's
    layout), numpy or torch, f32 or bf16; at tp 16, block_experts of the
    port's copy is the JAX init tree."""
    jcfg, tcfg = _configs(arch)  # bf16 experts
    jp, tp_params = _params(jcfg, tcfg)
    for ju, tu in zip(jp["backbone"]["units"], tp_params["backbone"]["units"]):
        if "moe" not in ju:
            continue
        jmoe = _np_tree(ju["moe"])
        whole = unblock_experts(jmoe, tcfg)
        blocked = block_experts(whole, tcfg, tp)
        assert blocked["w_gate"].shape[:2] == (jmoe["w_gate"].shape[0], tp)
        _assert_bit_equal(unblock_experts(blocked, tcfg), whole)
        # torch leaves, bf16 as the port holds them
        back = block_experts(tu["moe"], tcfg, tp)
        _assert_bit_equal(unblock_experts(back, tcfg), tu["moe"])
        if tp == TP_HINT:
            _assert_bit_equal(block_experts(whole, tcfg, tp), jmoe)
            got = tree.tree_map(lambda t: t.float().numpy(), back)
            want = tree.tree_map(lambda a: np.asarray(a, np.float32), jmoe)
            _assert_bit_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_from_jax_reblocks_the_expert_moments(arch):
    """A JAX optimizer state after one step (non-zero moments): the port's
    copy holds every master, m and v leaf of the JAX state, the experts
    re-blocked, exactly; block_experts gives the JAX leaves back; without the
    config the MoE state is refused."""
    jcfg, tcfg = _configs(arch, **F32)
    jp, _ = _params(jcfg, tcfg)
    jopt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    js = jadamw.init(jopt, jp)
    host = _batch(tcfg)
    _, js, _ = jax.jit(jax_make_train_step(jcfg, jopt))(
        jp, js, {k: jnp.asarray(v) for k, v in host.items()})
    ts = opt_state_from_jax(_np_tree(js), tcfg)
    assert int(ts.step) == 1
    for name in ("master", "m", "v"):
        got = tree.tree_map(lambda t: t.numpy(), getattr(ts, name))
        _assert_bit_equal(got, _unblocked(getattr(js, name), tcfg))
        assert float(tree.leaf_paths(getattr(ts, name))[
            "backbone/units/0/moe/w_gate" if arch == "mixtral-8x7b"
            else "backbone/units/1/moe/w_gate"].abs().max()) > 0
        _assert_bit_equal(map_experts(got, lambda m: block_experts(m, tcfg, TP_HINT)),
                          _np_tree(getattr(js, name)))
    with pytest.raises(ValueError, match="config"):
        opt_state_from_jax(_np_tree(js))


# -- drops, recompute, determinism ------------------------------------------------------

def _dropped_token(cfg, p, h):
    """The first token all of whose assignments are past capacity."""
    idx, _, _ = moe.route(cfg, p["router"], h.reshape(-1, cfg.d_model))
    buf_pos = moe.dispatch_indices(idx, cfg.n_experts, moe.capacity(cfg, idx.shape[0]))
    dropped = (buf_pos.view(idx.shape) < 0).all(dim=1)
    assert bool(dropped.any()) and not bool(dropped.all())
    return int(dropped.nonzero()[0, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_token_with_every_assignment_dropped_gets_the_residual_gradient(arch):
    """Capacity factor 0.5 over 64 tokens: with a cotangent on one token
    whose every assignment is dropped, the MoE layer's input gets exactly the
    gradient the layer gives without its routed experts (the residual, and
    llama4-maverick's shared expert), and no expert weight nor the router
    gets any (the aux term left out: it reaches every token's logits)."""
    _, tcfg = _configs(arch, capacity_factor=0.5, **F32)
    gen = torch.Generator().manual_seed(0)
    layer = transformer.init_layer(tcfg, gen, CPU, is_moe=True)
    x = torch.randn((1, 64, tcfg.d_model), generator=gen).requires_grad_(True)
    t = _dropped_token(tcfg, layer["moe"], layers.apply_norm(tcfg, layer["mlp_norm"], x))
    cot = torch.zeros_like(x)
    cot[0, t] = torch.randn(tcfg.d_model, generator=gen)
    leaves = [layer["moe"][n].requires_grad_(True)
              for n in ("router", "w_gate", "w_up", "w_down")]
    out, _ = transformer._ffn(tcfg, layer, x)
    gx, *gw = torch.autograd.grad((out * cot).sum(), [x, *leaves])

    def without_routed(x):
        if "shared" not in layer["moe"]:
            return x
        return x + layers.apply_mlp(tcfg, layer["moe"]["shared"],
                                    layers.apply_norm(tcfg, layer["mlp_norm"], x))
    want, = torch.autograd.grad((without_routed(x) * cot).sum(), [x])
    assert torch.equal(gx, want)
    assert all(not bool(g.any()) for g in gw)


@pytest.mark.parametrize("arch", ARCHS)
def test_recompute_routes_as_the_forward(arch, monkeypatch):
    """Under per-layer recompute, every MoE layer routes twice in a step (its
    forward, and its recompute in the backward), both times to the same
    experts, drops included."""
    jcfg, tcfg = _configs(arch, capacity_factor=0.5, **F32)
    _, tp = _params(jcfg, tcfg)
    routes, route = {}, moe.route

    def recorded(cfg, router, x2d):
        out = route(cfg, router, x2d)
        routes.setdefault(router.data_ptr(), []).append(out[0].clone())
        return out
    monkeypatch.setattr(moe, "route", recorded)
    steps.loss_and_grads(tcfg, tp, {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()})
    assert len(routes) == tcfg.n_layers // tcfg.moe_every
    assert all(len(r) == 2 and torch.equal(r[0], r[1]) for r in routes.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_repeat_bitwise(arch):
    """Two runs of a bf16 train step from the same params, state and batch:
    the loss and every gradient bit-equal."""
    _, tcfg = _configs(arch)
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    la, _, ga = steps.loss_and_grads(tcfg, params, batch)
    lb, _, gb = steps.loss_and_grads(tcfg, params, batch)
    assert torch.equal(la, lb)
    _assert_bit_equal(ga, gb)


# -- checkpoints ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restore_and_continue_is_bit_equal(arch, tmp_path):
    """bf16 params with the f32 master copy: 4 train steps straight against
    2 steps, a save, a restore into a zeroed tree and 2 more steps; every
    param, master, moment and the step bit-equal, the experts kept (E, D,
    F) on disk."""
    _, tcfg = _configs(arch)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    step_fn = steps.make_train_step(tcfg, opt)
    batches = [{k: torch.from_numpy(v) for k, v in _batch(tcfg, seed=7, step=i).items()}
               for i in range(4)]

    def fresh():
        params = lm.init_params(tcfg, torch.Generator().manual_seed(1), CPU)
        return params, adamw.init(opt, params)

    def run(params, state, bs):
        for b in bs:
            params, state, _ = step_fn(params, state, b)
        return params, state
    straight = dict(zip(("params", "opt"), run(*fresh(), batches)))
    p, s = run(*fresh(), batches[:2])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"params": p, "opt": s}, block=True)
    like = tree.tree_map(torch.zeros_like, {"params": p, "opt": s})
    restored, step, _ = mgr.restore(None, like)
    assert step == 2
    _assert_bit_equal(restored, {"params": p, "opt": s})
    key = next(k for k in tree.leaf_paths(p) if k.endswith("moe/w_gate"))
    assert tuple(tree.leaf_paths(restored["params"])[key].shape[1:]) == (
        tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    resumed = dict(zip(("params", "opt"), run(restored["params"], restored["opt"],
                                              batches[2:])))
    _assert_bit_equal(resumed, straight)


# -- the trainer and the launcher ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_losses_match_the_jax_train_step(arch):
    """The port's TrainerRuntime (bypass feed) from converted JAX params and
    optimizer state against the JAX train step looped over the JAX stream."""
    jcfg, tcfg = _configs(arch, **F32)
    jp, tp = _params(jcfg, tcfg, seed=1)
    jopt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    topt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    js = jadamw.init(jopt, jp)
    ts = opt_state_from_jax(_np_tree(js), tcfg)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    want = []
    for batch in jax_stream_factory(jcfg, JaxDataConfig(seq_len=32, global_batch=2, seed=6),
                                    n_steps=3)(0, 1):
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(m["loss"]))
    rt = TrainerRuntime(tcfg, DataConfig(seq_len=32, global_batch=2, seed=6),
                        TrainerConfig(steps=3, feed="bypass", log_every=1), topt, device=CPU)
    state = rt.run(TrainerState(params=tp, opt_state=ts))
    got = [m["loss"] for m in rt.metrics_log]
    assert state.step == 3 and rt.feed.stats.batches == 3 and len(got) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * abs(w), (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_moe_on_the_cpu(arch):
    rt = train_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                            "--seq-len", "32", "--global-batch", "2", "--log-every", "1"])
    assert [m["step"] for m in rt.metrics_log] == [1, 2]
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for m in rt.metrics_log)
    assert rt.feed.stats.batches == 2 and len(rt.step_times_s) == 2
