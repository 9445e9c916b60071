"""The port's train path for the hybrid family on the CPU against the JAX package's.

recurrentgemma-9b's smoke config (5 layers: one (rglru, rglru, attn) unit and
a tail of two RG-LRU layers; d 64, 4 heads on 1 kv head, a 16-token local
window, vocabulary 512), with the JAX params and optimizer state copied over
by ``repro_torch.convert`` and batches from each package's numpy pipeline.
The sequences are longer than the window, so the local attention cuts keys.
On the CPU the RG-LRU scan and attention take the plain versions, and their
gradients are autograd through them; the CUDA backward kernels are held
against the same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Bounds as in tests/test_torch_train.py, set from the dtype before the
comparison. In f32 both packages do the same arithmetic in another order
(the JAX associative scan and chunked attention against the port's
sequential scan and plain attention), so a loss of about 6 agrees within
1e-5 relative and each gradient within 1e-4 of its leaf's largest magnitude.
AdamW is elementwise f32 after one global norm: within 1e-6 of the leaf's
largest magnitude, a bf16 param within one bf16 step. Checkpoints are
bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs.recurrentgemma_9b import SMOKE_CONFIG as JAX_SMOKE
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import stream_factory as jax_stream_factory
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.recurrentgemma_9b import SMOKE_CONFIG
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import DataConfig, synth_tokens
from repro_torch.kernels import ref
from repro_torch.launch import train as train_launch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime, TrainerState

F32 = dict(param_dtype="float32", compute_dtype="float32")
LOSS_REL = 1e-5
GRAD_OF_MAX = 1e-4
ADAM_REL = 1e-6
CPU = torch.device("cpu")
# leaves that only the kernels' backward gives a gradient on the card: the
# RG-LRU's decay parameter, and the attention projections
RGLRU_LEAVES = ("lam",)
ATTN_LEAVES = ("wq", "wk", "wv")


def _configs(**kw):
    return JAX_SMOKE.replace(**kw), SMOKE_CONFIG.replace(**kw)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(_np_tree(jp), tcfg)


def _assert_tree_close(got, want, of_max):
    g, w = tree.leaf_paths(got), tree.leaf_paths(_np_tree(want))
    assert sorted(g) == sorted(w)
    for key in w:
        want_leaf = np.asarray(w[key], np.float32)
        got_leaf = g[key].detach().float().numpy()
        bound = of_max * max(float(np.abs(want_leaf).max()), 1e-30)
        err = float(np.abs(got_leaf - want_leaf).max())
        assert err <= bound, f"{key}: max abs diff {err} > {bound}"


def test_smoke_config_is_one_unit_and_a_tail_past_its_window():
    assert SMOKE_CONFIG.block_pattern == ("rglru", "rglru", "attn")
    assert SMOKE_CONFIG.n_layers == 5 and SMOKE_CONFIG.window == 16


@pytest.mark.parametrize("seq_len", [24, 41])  # past the 16-token window; 41 ragged
def test_train_loss_and_every_gradient_match_jax(seq_len):
    jcfg, tcfg = _configs(**F32)
    jp, tp = _params(jcfg, tcfg)
    host = {k: v.copy() for k, v in synth_tokens(
        tcfg, DataConfig(seq_len=seq_len, global_batch=2, seed=3), 0, 1, 0).items()}
    host["labels"][1, -5:] = -100
    (jl, jm), jg = jax.value_and_grad(lambda p: jlm.train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in host.items()}), has_aux=True)(jp)
    ref.calls = 0
    tl, tm, tg = steps.loss_and_grads(tcfg, tp, {k: torch.from_numpy(v)
                                                 for k, v in host.items()})
    # per layer the forward and its recompute, each one plain scan or attention
    assert ref.calls == 2 * tcfg.n_layers
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    for k in ("xent", "aux", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_REL * max(1.0, abs(float(jm[k])))
    assert float(tm["tokens"]) == 2 * seq_len - 5
    _assert_tree_close(tg, jg, GRAD_OF_MAX)
    leaves = tree.leaf_paths(tg)
    for key, g in leaves.items():  # the scan's and attention's own leaves get a gradient
        if key.split("/")[-1] in RGLRU_LEAVES + ATTN_LEAVES:
            assert float(g.abs().max()) > 0, key


def test_forward_hidden_recomputes_each_layer():
    """Under autograd each layer runs twice (the forward, then its recompute
    in the backward); without grad once."""
    _, tcfg = _configs(**F32)
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    batch = {k: torch.from_numpy(v) for k, v in synth_tokens(
        tcfg, DataConfig(seq_len=20, global_batch=1, seed=1), 0, 1, 0).items()}
    ref.calls = 0
    with torch.no_grad():
        lm.train_loss(tcfg, tp, batch)
    assert ref.calls == tcfg.n_layers
    ref.calls = 0
    steps.loss_and_grads(tcfg, tp, batch)
    assert ref.calls == 2 * tcfg.n_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_on_the_hybrid_tree_matches_jax(dtype):
    """AdamW over the hybrid tree: stacked units and a tail, bf16 matrices
    beside the f32 ``lam``. The clip is inactive here, as in the ssm test."""
    jcfg, tcfg = _configs(param_dtype=dtype, compute_dtype=dtype)
    jp, tp = _params(jcfg, tcfg)
    assert tp["backbone"]["units"][0]["rglru"]["lam"].dtype == torch.float32
    assert tp["backbone"]["tail"][0]["rglru"]["lam"].dtype == torch.float32
    assert tp["backbone"]["units"][2]["attn"]["wq"].dtype == getattr(torch, dtype)
    cfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=100.0)
    tcfg_opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=100.0)
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.05, _np_tree(jp))
    jstate = jadamw.init(cfg, jp)
    tstate = opt_state_from_jax(_np_tree(jstate))
    for _ in range(2):
        jgr = jax.tree_util.tree_map(lambda g, p: jnp.asarray(g, p.dtype), grads, jp)
        jp, jstate, jmet = jadamw.apply_updates(cfg, jp, jgr, jstate)
        tgr = tree.tree_map(lambda g, p: torch.from_numpy(np.asarray(g)).to(p.dtype),
                            params_from_jax(grads, tcfg.replace(param_dtype="float32")), tp)
        tp, tstate, tmet = adamw.apply_updates(tcfg_opt, tp, tgr, tstate)
        gn = float(jmet["grad_norm"])
        assert gn < 100.0  # the clip is inactive
        assert abs(float(tmet["grad_norm"]) - gn) <= 1e-5 * gn
        for name in ("master", "m", "v"):
            _assert_tree_close(getattr(tstate, name), getattr(jstate, name), ADAM_REL)
        g, w = tree.leaf_paths(tp), tree.leaf_paths(_np_tree(jp))
        for key in w:
            want = np.asarray(w[key], np.float32)
            bound = ADAM_REL * np.abs(want).max()
            if g[key].dtype == torch.bfloat16:
                bound = np.maximum(np.abs(want) * 2.0 ** -7, bound)
            assert (np.abs(g[key].float().numpy() - want) <= bound).all(), key
            assert str(g[key].dtype).removeprefix("torch.") == str(w[key].dtype), key


def test_one_train_step_matches_the_jax_train_step():
    """make_train_step (loss, gradients, AdamW) once from the same params
    and state, f32: the loss within 1e-5 relative, the grad norm within
    1e-4, and AdamW's first moments (a tenth of the gradients) within 1e-4
    of each leaf's largest, as the gradients are. The params themselves are
    held after apply_updates on equal gradients (above): after a first step
    AdamW moves each element by about lr sign(g), so a gradient element near
    0 whose sign differs in the last bits moves its param by up to 2 lr."""
    jcfg, tcfg = _configs(**F32)
    jp, tp = _params(jcfg, tcfg, seed=2)
    jopt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    topt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    js = jadamw.init(jopt, jp)
    ts = opt_state_from_jax(_np_tree(js))
    host = synth_tokens(tcfg, DataConfig(seq_len=24, global_batch=2, seed=4), 0, 1, 0)
    jp, js, jm = jax.jit(jax_make_train_step(jcfg, jopt))(
        jp, js, {k: jnp.asarray(v) for k, v in host.items()})
    tp, ts, tm = steps.make_train_step(tcfg, topt)(
        tp, ts, {k: torch.from_numpy(v) for k, v in host.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_REL * abs(float(jm["loss"]))
    gn = float(jm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gn) <= 1e-4 * gn
    assert int(ts.step) == int(js.step) == 1
    _assert_tree_close(ts.m, js.m, GRAD_OF_MAX)


def test_checkpoint_of_the_hybrid_tree_crosses_both_ways(tmp_path):
    """A bf16 hybrid model with its optimizer state: written by either
    package, restored bit-equal by the other."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    js = jadamw.init(jadamw.AdamWConfig(), jp)._replace(step=jnp.int32(5))
    jtree, ttree = {"params": jp, "opt": js}, {"params": tp,
                                               "opt": opt_state_from_jax(_np_tree(js))}
    JaxCheckpointManager(str(tmp_path / "j")).save(5, jtree, block=True)
    restored, step, _ = CheckpointManager(str(tmp_path / "j")).restore(
        None, tree.tree_map(torch.zeros_like, ttree))
    CheckpointManager(str(tmp_path / "t")).save(5, ttree, block=True)
    back, jstep, _ = JaxCheckpointManager(str(tmp_path / "t")).restore(
        None, jax.tree_util.tree_map(jnp.zeros_like, jtree))
    assert step == jstep == 5
    g, w, b = (tree.leaf_paths(restored), tree.leaf_paths(_np_tree(jtree)),
               tree.leaf_paths(_np_tree(back)))
    assert sorted(g) == sorted(w) == sorted(b)
    for key in w:
        got = g[key]
        bits = (got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
                else got.numpy())
        want_bits = w[key].view(np.int16) if got.dtype == torch.bfloat16 else w[key]
        np.testing.assert_array_equal(bits, want_bits, err_msg=key)
        np.testing.assert_array_equal(np.asarray(b[key]).reshape(-1).view(np.uint8),
                                      np.asarray(w[key]).reshape(-1).view(np.uint8),
                                      err_msg=key)


def test_trainer_losses_match_the_jax_train_step():
    """The port's TrainerRuntime (bypass feed) from converted JAX params against
    the JAX train step (jitted, no donation) looped over the JAX stream."""
    jcfg, tcfg = _configs(**F32)
    jp, tp = _params(jcfg, tcfg, seed=1)
    jopt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    topt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    js = jadamw.init(jopt, jp)
    ts = opt_state_from_jax(_np_tree(js))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    jstream = jax_stream_factory(jcfg, JaxDataConfig(seq_len=24, global_batch=2, seed=6),
                                 n_steps=4)(0, 1)
    want = []
    for batch in jstream:
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(m["loss"]))
    rt = TrainerRuntime(tcfg, DataConfig(seq_len=24, global_batch=2, seed=6),
                        TrainerConfig(steps=4, feed="bypass", log_every=1), topt, device=CPU)
    state = rt.run(TrainerState(params=tp, opt_state=ts))
    got = [m["loss"] for m in rt.metrics_log]
    assert state.step == 4 and [m["step"] for m in rt.metrics_log] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * abs(w), (got, want)
    assert got[-1] < got[0]


def test_trainer_checkpoint_restart_determinism(tmp_path):
    """6 steps straight against 4 steps, then a fresh runtime that restores
    the step-4 checkpoint and replays the stream to 6."""
    cfg = SMOKE_CONFIG.replace(**F32)
    dcfg = DataConfig(seq_len=20, global_batch=2, seed=5)

    def losses_of(run_steps, ckpt_dir):
        t = TrainerRuntime(cfg, dcfg, TrainerConfig(steps=run_steps, ckpt_every=2,
                                                    ckpt_dir=ckpt_dir, feed="bypass",
                                                    log_every=1), device=CPU)
        t.run()
        return {m["step"]: m["loss"] for m in t.metrics_log}

    full = losses_of(6, str(tmp_path / "a"))
    first = losses_of(4, str(tmp_path / "b"))
    resumed = losses_of(6, str(tmp_path / "b"))
    assert sorted(resumed) == [5, 6] and sorted(first) == [1, 2, 3, 4]
    for s in (5, 6):
        assert abs(full[s] - resumed[s]) < 1e-4, f"step {s}: {full[s]} vs {resumed[s]}"


def test_train_main_runs_recurrentgemma_on_the_cpu(tmp_path):
    rt = train_launch.main(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
                            "--steps", "3", "--seq-len", "24", "--global-batch", "2",
                            "--log-every", "1", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "2"])
    losses = [m["loss"] for m in rt.metrics_log]
    assert [m["step"] for m in rt.metrics_log] == [1, 2, 3]
    assert all(np.isfinite(losses))
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
