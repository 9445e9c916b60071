"""The port's train path on the CPU against the JAX package's.

qwen3-1.7b's smoke config (4 layers, d 64, 4 heads, 2 kv heads, vocabulary
512) in f32, with the JAX params and optimizer state copied over by
``repro_torch.convert``, and batches from the numpy pipeline of each package.

Bounds, all set before the comparison from the dtype. In f32 the two
packages do the same arithmetic in another order (XLA's fused dots and the
JAX chunked attention against PyTorch's matmuls and the port's plain
attention), so a loss of about 6 agrees to a few f32 ulps: 1e-5 relative.
Gradients pass through 4 layers of such sums: each leaf within 1e-4 of its
largest magnitude. An AdamW step is elementwise f32 after one global norm:
each leaf within 1e-6 of its largest magnitude (the update subtracts numbers
of that size, so an element near 0 keeps their absolute, not its own
relative, rounding); a bf16 param is the f32 master copy rounded, so within
one bf16 step (2^-7 of its magnitude) where the master copies differ in the
last f32 bits. Integer, byte and checkpoint outputs must be equal.
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs.qwen3_1p7b import SMOKE_CONFIG as JAX_SMOKE
from repro.core.dataplane import KernelStackFeed as JaxKernelStackFeed
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import stream_factory as jax_stream_factory
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.qwen3_1p7b import SMOKE_CONFIG
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core.dataplane import BypassDataplane, KernelStackFeed, make_feed
from repro_torch.data.pipeline import DataConfig, stream_factory, synth_tokens
from repro_torch.kernels import _build
from repro_torch.launch import train as train_launch
from repro_torch.models import layers
from repro_torch.models.registry import get_smoke_config
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime, TrainerState

F32 = dict(param_dtype="float32", compute_dtype="float32")
LOSS_REL = 1e-5
GRAD_OF_MAX = 1e-4
ADAM_REL = 1e-6
CPU = torch.device("cpu")


def _configs(**kw):
    return JAX_SMOKE.replace(**kw), SMOKE_CONFIG.replace(**kw)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(_np_tree(jp), tcfg)


def _batch(cfg, seq_len=32, global_batch=2, seed=3, step=0):
    return synth_tokens(cfg, DataConfig(seq_len=seq_len, global_batch=global_batch, seed=seed),
                        0, 1, step)


def _f32(x):
    return np.asarray(x, np.float32)


def _assert_tree_close(got, want, of_max):
    """Each leaf of the port's tree within ``of_max`` of the JAX leaf's
    largest magnitude; both trees keyed alike."""
    g, w = tree.leaf_paths(got), tree.leaf_paths(_np_tree(want))
    assert sorted(g) == sorted(w)
    for key in w:
        want_leaf = _f32(w[key])
        got_leaf = g[key].detach().float().numpy()
        bound = of_max * max(float(np.abs(want_leaf).max()), 1e-30)
        err = float(np.abs(got_leaf - want_leaf).max())
        assert err <= bound, f"{key}: max abs diff {err} > {bound}"


# -- loss and gradients --------------------------------------------------------

def test_chunked_softmax_xent_matches_jax():
    """Ragged last chunk (S 40 in chunks of 16) and ignored labels, with the
    gradients of the hidden states and of the tied embedding."""
    jcfg, tcfg = _configs(**F32)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    labels = rng.integers(0, 512, size=(2, 40)).astype(np.int32)
    labels[0, :7] = -100
    labels[1, 30:] = -100

    def jloss(x, embed):
        s, n = jlayers.chunked_softmax_xent(jcfg, embed, x, jnp.asarray(labels), s_chunk=16)
        return s, n
    js, jn = jloss(jnp.asarray(x), jp["embed"])
    jgx, jge = jax.grad(lambda x, e: jloss(x, e)[0], argnums=(0, 1))(jnp.asarray(x), jp["embed"])

    tx = torch.from_numpy(x).requires_grad_(True)
    tok = tp["embed"]["tok"].requires_grad_(True)
    ts, tn = layers.chunked_softmax_xent(tcfg, {"tok": tok}, tx, torch.from_numpy(labels),
                                         s_chunk=16)
    ts.backward()
    assert float(tn) == float(jn) == float((labels != -100).sum())
    assert abs(ts.item() - float(js)) <= LOSS_REL * abs(float(js))
    _assert_tree_close({"x": tx.grad, "tok": tok.grad}, {"x": jgx, "tok": jge["tok"]},
                       GRAD_OF_MAX)


def test_train_loss_and_every_gradient_match_jax():
    jcfg, tcfg = _configs(**F32)
    jp, tp = _params(jcfg, tcfg)
    host = {k: v.copy() for k, v in _batch(tcfg).items()}  # labels view the tokens' array
    host["labels"][1, -5:] = -100
    (jl, jm), jg = jax.value_and_grad(lambda p: jlm.train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in host.items()}), has_aux=True)(jp)
    tl, tm, tg = steps.loss_and_grads(tcfg, tp, {k: torch.from_numpy(v)
                                                 for k, v in host.items()})
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    for k in ("xent", "aux", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_REL * max(1.0, abs(float(jm[k])))
    assert float(tm["tokens"]) == 2 * 32 - 5
    _assert_tree_close(tg, jg, GRAD_OF_MAX)
    loss, _ = steps.make_loss_fn(tcfg)(tp, {k: torch.from_numpy(v) for k, v in host.items()})
    assert float(loss) == float(tl)
    assert not any(p.requires_grad for p in tree.leaf_paths(tp).values())


# -- the autograd guard of kernels without a backward ---------------------------

def test_refuse_grad_raises_only_when_a_gradient_would_be_lost():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        _build.refuse_grad("rglru_scan_cuda", y, x, None)
    _build.refuse_grad("rglru_scan_cuda", y, None)
    with torch.no_grad():
        _build.refuse_grad("rglru_scan_cuda", x, y)
    _build.refuse_grad("rglru_scan_cuda", x.detach())


# -- AdamW ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(dtype):
    jcfg, tcfg = _configs(param_dtype=dtype, compute_dtype=dtype)
    jp, tp = _params(jcfg, tcfg)
    cfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=0.5)
    tcfg_opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=0.5)
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.05, _np_tree(jp))
    jstate = jadamw.init(cfg, jp)
    tstate = opt_state_from_jax(_np_tree(jstate))
    for step in range(2):  # two steps: the second reads moments the first wrote
        jgr = jax.tree_util.tree_map(lambda g, p: jnp.asarray(g, p.dtype), grads, jp)
        jp, jstate, jmet = jadamw.apply_updates(cfg, jp, jgr, jstate)
        tgr = tree.tree_map(lambda g, p: torch.from_numpy(np.asarray(g)).to(p.dtype),
                            params_from_jax(grads, tcfg.replace(param_dtype="float32")), tp)
        tp, tstate, tmet = adamw.apply_updates(tcfg_opt, tp, tgr, tstate)
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert abs(float(tmet["lr"]) - float(jmet["lr"])) <= ADAM_REL * float(jmet["lr"])
        # the norm sums 2e5 squares in another order: f32 pairwise sums keep
        # about log2(2e5) * 6e-8 = 1e-6 relative, so bound it at 1e-5
        gn = float(jmet["grad_norm"])
        assert abs(float(tmet["grad_norm"]) - gn) <= 1e-5 * gn
        for name in ("master", "m", "v"):
            _assert_tree_close(getattr(tstate, name), getattr(jstate, name), ADAM_REL)
        g, w = tree.leaf_paths(tp), tree.leaf_paths(_np_tree(jp))
        for key in w:
            want = _f32(w[key])
            bound = ADAM_REL * np.abs(want).max()
            if dtype == "bfloat16":
                bound = np.maximum(np.abs(want) * 2.0 ** -7, bound)
            assert (np.abs(g[key].float().numpy() - want) <= bound).all(), key
            assert g[key].dtype == getattr(torch, dtype)


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, decay_steps=1000,
                            grad_clip=100.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = adamw.init(cfg, params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw ||w||^2
        params, state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_clipping():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in tree.leaf_paths(clipped).values()))
    assert abs(float(total) - 1.0) < 1e-5
    assert g["a"][0] == 100.0  # the input is left as it was


def test_schedule_shape_matches_jax():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    jcfg = jadamw.AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    lrs = [float(adamw.schedule(cfg, s)) for s in range(0, 120, 5)]
    assert lrs[0] < lrs[1]                       # warming up
    assert abs(lrs[2] - 1.0) < 0.05              # peak ≈ lr
    assert lrs[-1] <= 0.12                       # decayed to min_lr_frac
    assert all(lr >= 0 for lr in lrs)
    want = [float(jadamw.schedule(jcfg, jnp.int32(s))) for s in range(0, 120, 5)]
    np.testing.assert_allclose(lrs, want, rtol=ADAM_REL)


def test_int8_compression_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    g = (rng.normal(size=(256, 64)) * 0.01).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]  # scaled halves, where rounding modes differ
    q, scale = adamw.compress_int8(torch.from_numpy(g))
    back = adamw.decompress_int8(q, scale)
    assert q.dtype == torch.int8
    assert float((back - torch.from_numpy(g)).abs().max()) <= float(scale) * 0.51
    jq, jscale = jadamw.compress_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    half = torch.tensor([0.5, 1.5, 2.5, -0.5]) * (127.0 / 2.5)
    q, _ = adamw.compress_int8(half)  # amax 2.5·127/2.5: g/scale lands on halves
    jq, _ = jadamw.compress_int8(jnp.asarray(half.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_bf16_params_master_fp32_update():
    cfg = adamw.AdamWConfig(lr=0.01, warmup_steps=1, decay_steps=10)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = adamw.init(cfg, params)
    grads = {"w": torch.full((4,), 1e-4)}
    new_params, new_state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert new_params["w"].dtype == torch.bfloat16
    assert new_state.master["w"].dtype == torch.float32
    # master moved even though bf16 params may round
    assert float((new_state.master["w"] - 1.0).abs().max()) > 0


def test_init_never_aliases_an_f32_param():
    params = {"w": torch.ones(3)}
    state = adamw.init(adamw.AdamWConfig(), params)
    assert state.master["w"].data_ptr() != params["w"].data_ptr()
    assert state.m["w"].data_ptr() != state.v["w"].data_ptr()


def test_opt_state_from_jax():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    js = jadamw.init(jadamw.AdamWConfig(), jp)
    ts = opt_state_from_jax(_np_tree(js))
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for name in ("master", "m", "v"):
        g, w = tree.leaf_paths(getattr(ts, name)), tree.leaf_paths(_np_tree(getattr(js, name)))
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == torch.float32
            np.testing.assert_array_equal(g[key].numpy(), _f32(w[key]))
    off = jadamw.init(jadamw.AdamWConfig(master_fp32=False), jp)
    assert opt_state_from_jax(_np_tree(off)).master == ()


# -- checkpoints ----------------------------------------------------------------

def _ckpt_trees():
    """A bf16 model and its optimizer state in both packages, equal values."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    js = jadamw.init(jadamw.AdamWConfig(), jp)
    js = js._replace(step=jnp.int32(7))
    ts = opt_state_from_jax(_np_tree(js))
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def _zeros_like(t):
    return tree.tree_map(torch.zeros_like, t)


def _assert_bit_equal(torch_tree, jax_tree):
    g, w = tree.leaf_paths(torch_tree), tree.leaf_paths(_np_tree(jax_tree))
    assert sorted(g) == sorted(w)
    for key in w:
        got = g[key]
        if got.dtype == torch.bfloat16:
            got_bits, want_bits = got.view(torch.int16).numpy(), w[key].view(np.int16)
        else:
            got_bits, want_bits = got.numpy(), w[key]
        assert str(got.dtype).removeprefix("torch.") == str(w[key].dtype), key
        np.testing.assert_array_equal(got_bits, want_bits, err_msg=key)


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    jtree, ttree = _ckpt_trees()
    JaxCheckpointManager(str(tmp_path)).save(3, jtree, extra={"note": "jax"}, block=True)
    restored, step, extra = CheckpointManager(str(tmp_path)).restore(None, _zeros_like(ttree))
    assert step == 3 and extra == {"note": "jax"}
    _assert_bit_equal(restored, jtree)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    jtree, ttree = _ckpt_trees()
    CheckpointManager(str(tmp_path / "t")).save(3, ttree, extra={"note": "torch"}, block=True)
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    restored, step, extra = JaxCheckpointManager(str(tmp_path / "t")).restore(None, like)
    assert step == 3 and extra == {"note": "torch"}
    _assert_bit_equal(ttree, restored)
    # the same tree gives the same manifest (leaf keys, files, dtypes, digests)
    JaxCheckpointManager(str(tmp_path / "j")).save(3, jtree, extra={"note": "torch"},
                                                    block=True)
    manifests = [json.load(open(tmp_path / d / "step_000000003" / "manifest.json"))
                 for d in ("t", "j")]
    assert manifests[0] == manifests[1]


def _small_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _small_tree()
    mgr.save(5, t, extra={"note": "x"})
    t["a"].add_(1)  # the save snapshotted before this in-place update
    mgr.wait()
    restored, step, extra = mgr.restore(None, _zeros_like(t))
    assert step == 5 and extra["note"] == "x"
    assert torch.equal(restored["a"], torch.arange(12, dtype=torch.float32).reshape(3, 4))
    assert torch.equal(restored["b"]["c"], t["b"]["c"])


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _small_tree(), block=True)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_000000003", "step_000000004"]
    assert mgr.latest_step() == 4
    assert open(tmp_path / "LATEST").read() == "step_000000004"


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _small_tree(), block=True)
    d = os.path.join(tmp_path, "step_000000001", "arrays")
    f = os.path.join(d, sorted(os.listdir(d))[0])
    raw = bytearray(open(f, "rb").read())
    raw[-1] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        mgr.restore(1, _small_tree())


def test_checkpoint_shape_mismatch_and_missing_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _small_tree(), block=True)
    with pytest.raises(ValueError):
        mgr.restore(1, {"a": torch.zeros(2, 2), "b": {"c": torch.zeros(2, dtype=torch.bfloat16)}})
    with pytest.raises(KeyError):
        mgr.restore(1, {**_small_tree(), "d": torch.zeros(1)})


def test_checkpoint_survives_torn_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(8.0)}, block=True)
    os.makedirs(tmp_path / ".tmp_step_000000002" / "arrays")  # crash mid-write
    os.makedirs(tmp_path / "step_000000003")                 # published without manifest
    restored, step, _ = mgr.restore(None, {"w": torch.zeros(8)})
    assert step == 1
    assert torch.equal(restored["w"], torch.arange(8.0))


# -- dataplane ----------------------------------------------------------------------

def test_pipeline_batches_are_byte_identical_to_jax():
    jcfg, tcfg = _configs()
    for port, n_ports, step in ((0, 1, 0), (1, 2, 5), (0, 4, 17)):
        jit = jax_stream_factory(jcfg, JaxDataConfig(seq_len=40, global_batch=8, seed=2),
                                 start_step=step)(port, n_ports)
        tit = stream_factory(tcfg, DataConfig(seq_len=40, global_batch=8, seed=2),
                             start_step=step)(port, n_ports)
        a, b = next(jit), next(tit)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_feeds_deliver_identical_batches():
    """Both feeds of the port give the JAX kernel-stack feed's batches, then a
    clean end of stream."""
    jcfg, tcfg = _configs()
    jf = JaxKernelStackFeed(jax_stream_factory(
        jcfg, JaxDataConfig(seq_len=16, global_batch=4, seed=9), n_steps=3)(0, 1))
    factory = stream_factory(tcfg, DataConfig(seq_len=16, global_batch=4, seed=9), n_steps=3)
    kf = KernelStackFeed(factory(0, 1), CPU)
    bp = BypassDataplane(factory, device=CPU, depth=2, ports=1)
    try:
        for _ in range(3):
            want = jf.next_batch()
            for feed in (kf, bp):
                got = feed.next_batch()
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == torch.int32
                    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert bp.next_batch() is None and kf.next_batch() is None  # clean end of stream
        assert bp.stats.batches == kf.stats.batches == 3
        assert bp.stats.bytes == kf.stats.bytes == 3 * 2 * 4 * 16 * 4
    finally:
        bp.stop()


def test_multiport_feed_covers_global_batch():
    cfg = get_smoke_config("qwen3-1.7b")
    bp = BypassDataplane(stream_factory(cfg, DataConfig(seq_len=16, global_batch=8, seed=4),
                                        n_steps=2), device=CPU, depth=2, ports=2)
    try:
        seen = [bp.next_batch() for _ in range(4)]  # 2 steps × 2 ports
        assert all(s is not None for s in seen)
        assert all(tuple(s["tokens"].shape) == (4, 16) for s in seen)  # 8 / 2 ports
        assert bp.next_batch() is None
    finally:
        bp.stop()


def _stalling_factory(cfg, dcfg, release, stall_port, stall_after):
    healthy = stream_factory(cfg, dcfg, n_steps=50)

    def factory(port, n_ports):
        it = healthy(port, n_ports)
        if port != stall_port:
            return it

        def stalling():
            for _ in range(stall_after):
                yield next(it)
            release.wait(timeout=30)  # the node hangs until released
            yield from it
        return stalling()
    return factory


def test_feed_times_out_when_no_port_delivers():
    cfg = get_smoke_config("qwen3-1.7b")
    release = threading.Event()
    bp = BypassDataplane(_stalling_factory(cfg, DataConfig(seq_len=16, global_batch=4),
                                           release, 0, 1), device=CPU, depth=2, ports=1)
    try:
        assert bp.next_batch(timeout_s=5.0) is not None
        with pytest.raises(TimeoutError):
            bp.next_batch(timeout_s=0.2)
        release.set()
        assert bp.next_batch(timeout_s=5.0) is not None
    finally:
        release.set()
        bp.stop()


def test_stalled_port_does_not_stall_the_feed():
    """A producer port that hangs must not hold back the healthy one."""
    cfg = get_smoke_config("qwen3-1.7b")
    release = threading.Event()
    bp = BypassDataplane(_stalling_factory(cfg, DataConfig(seq_len=16, global_batch=4),
                                           release, 1, 1),
                         device=CPU, depth=2, ports=2, staging_capacity=2)
    try:
        got = [bp.next_batch(timeout_s=5.0) for _ in range(6)]
        assert all(b is not None for b in got)
    finally:
        release.set()
        bp.stop()


def test_make_feed_kinds():
    cfg = get_smoke_config("qwen3-1.7b")
    factory = stream_factory(cfg, DataConfig(seq_len=16, global_batch=2), n_steps=1)
    assert isinstance(make_feed("kernel", factory, device=CPU, depth=3), KernelStackFeed)
    bp = make_feed("bypass", factory, device=CPU, depth=2, ports=1)
    bp.stop()
    with pytest.raises(ValueError):
        make_feed("socket", factory, device=CPU)


# -- trainer ------------------------------------------------------------------------

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
    jstream = jax_stream_factory(jcfg, JaxDataConfig(seq_len=32, global_batch=2, seed=6),
                                 n_steps=4)(0, 1)
    want = []
    for batch in jstream:
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(m["loss"]))
    rt = TrainerRuntime(tcfg, DataConfig(seq_len=32, global_batch=2, seed=6),
                        TrainerConfig(steps=4, feed="bypass", log_every=1), topt, device=CPU)
    state = rt.run(TrainerState(params=tp, opt_state=ts))
    got = [m["loss"] for m in rt.metrics_log]
    assert state.step == 4 and [m["step"] for m in rt.metrics_log] == [1, 2, 3, 4]
    assert len(rt.step_times_s) == 4 and rt.feed.stats.batches == 4
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * abs(w), (got, want)
    assert got[-1] < got[0]


def test_trainer_checkpoint_restart_determinism(tmp_path):
    """6 steps straight against 4 steps, then a fresh runtime that restores
    the step-4 checkpoint and replays the stream to 6."""
    cfg = get_smoke_config("qwen3-1.7b").replace(**F32)
    dcfg = DataConfig(seq_len=32, global_batch=2, seed=5)

    def losses_of(run_steps, ckpt_dir):
        t = TrainerRuntime(cfg, dcfg, TrainerConfig(steps=run_steps, ckpt_every=2,
                                                    ckpt_dir=ckpt_dir, feed="bypass",
                                                    log_every=1), device=CPU)
        t.run()
        return {m["step"]: m["loss"] for m in t.metrics_log}

    full = losses_of(6, str(tmp_path / "a"))
    d2 = str(tmp_path / "b")
    first = losses_of(4, d2)
    resumed = losses_of(6, d2)
    assert sorted(resumed) == [5, 6] and sorted(first) == [1, 2, 3, 4]
    for s in (5, 6):
        assert abs(full[s] - resumed[s]) < 1e-4, f"step {s}: {full[s]} vs {resumed[s]}"


def test_trainer_drops_and_refills_on_a_straggler(monkeypatch):
    """The only port hangs after two batches: the step's poll deadline fires,
    the runtime counts a straggler event, drops what is in flight, and its
    retry gets the next batch once the port is back."""
    cfg = get_smoke_config("qwen3-1.7b").replace(**F32)
    dcfg = DataConfig(seq_len=16, global_batch=2)
    release = threading.Event()
    factory = _stalling_factory(cfg, dcfg, release, 0, 2)
    drop = BypassDataplane.drop_inflight

    def drop_and_recover(self):
        release.set()  # the node comes back while the runtime retries
        return drop(self)
    monkeypatch.setattr(BypassDataplane, "drop_inflight", drop_and_recover)
    monkeypatch.setattr("repro_torch.runtime.trainer.stream_factory",
                        lambda *a, **k: factory)
    rt = TrainerRuntime(cfg, dcfg, TrainerConfig(steps=4, feed="bypass", log_every=1,
                                                 step_deadline_s=0.5), device=CPU)
    try:
        state = rt.run()
    finally:
        release.set()
    assert state.step == 4 and rt.straggler_events == 1
    assert all(np.isfinite(m["loss"]) for m in rt.metrics_log)


# -- launcher -------------------------------------------------------------------------

def test_train_main_runs_on_the_cpu(tmp_path):
    rt = train_launch.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                            "--steps", "3", "--seq-len", "16", "--global-batch", "2",
                            "--feed", "kernel", "--log-every", "1",
                            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert [m["step"] for m in rt.metrics_log] == [1, 2, 3]
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_train_main_refuses_without_a_gpu_and_with_a_mesh(monkeypatch, tmp_path):
    """Without a GPU the default device raises; ``--mesh`` in a one-rank
    world raises naming the ranks its production mesh needs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'world'}", rank=0,
                            world_size=1)
    try:
        for mesh, ranks in (("single", 256), ("multi", 512)):
            with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
                train_launch.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                                   "--mesh", mesh])
    finally:
        dist.destroy_process_group()
