"""The encoder's and the VLM's train and serve paths on the CPU against the
JAX package: their pipeline batches, the two feeds carrying them, an AdamW
step on hubert-xlarge's tree (the decay of the embedding no frame reads
included), the trainer's per-step losses, and the launchers.

Smoke configs, f32 where a number is compared. Bounds as
tests/test_torch_train.py sets them, before the comparison: the pipeline's
and the feeds' arrays byte-equal; an AdamW step elementwise within 1e-6 of
each leaf's largest magnitude on the same gradients; the trainer's losses,
which pass through whole train steps, within 1e-5 relative.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hubert_xlarge as j_hubert
from repro.configs import internvl2_26b as j_vlm
from repro.core.dataplane import KernelStackFeed as JaxKernelStackFeed
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import stream_factory as jax_stream_factory
from repro.data.pipeline import synth_tokens as jax_synth_tokens
from repro.launch import serve as jax_serve
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.configs import hubert_xlarge as t_hubert
from repro_torch.configs import internvl2_26b as t_vlm
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core.dataplane import BypassDataplane, KernelStackFeed
from repro_torch.data.pipeline import DataConfig, stream_factory, synth_tokens
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime, TrainerState

F32 = dict(param_dtype="float32", compute_dtype="float32")
LOSS_REL, ADAM_REL = 1e-5, 1e-6
CPU = torch.device("cpu")
ARCHS = {"hubert-xlarge": (j_hubert, t_hubert), "internvl2-26b": (j_vlm, t_vlm)}


def _configs(arch, **kw):
    jmod, tmod = ARCHS[arch]
    kw = dict(rope_theta=jmod.CONFIG.rope_theta, **kw)
    return jmod.SMOKE_CONFIG.replace(**kw), tmod.SMOKE_CONFIG.replace(**kw)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(_np_tree(jp), tcfg)


def _f32(x):
    return np.asarray(x, np.float32)


# -- the pipeline and the feeds ----------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("seed, port, n_ports, step", [(0, 0, 1, 0), (2, 1, 2, 5),
                                                       (7, 0, 4, 17), (3, 3, 4, 1)])
def test_synth_tokens_byte_equal_to_jax(arch, seed, port, n_ports, step):
    """Frames f32 (B,S,D) with labels; patches f32 (B,P,D) with the text's
    tokens and labels (S - P): every array byte-equal, keys and dtypes too."""
    jcfg, tcfg = _configs(arch)
    want = jax_synth_tokens(jcfg, JaxDataConfig(seq_len=40, global_batch=8, seed=seed),
                            port, n_ports, step)
    got = synth_tokens(tcfg, DataConfig(seq_len=40, global_batch=8, seed=seed),
                       port, n_ports, step)
    assert sorted(got) == sorted(want)
    B = 8 // n_ports
    if arch == "hubert-xlarge":
        assert sorted(got) == ["frames", "labels"]
        assert got["frames"].shape == (B, 40, tcfg.d_model) and got["frames"].dtype == np.float32
    else:
        assert sorted(got) == ["labels", "patches", "tokens"]
        assert got["patches"].shape == (B, tcfg.n_patches, tcfg.d_model)
        assert got["tokens"].shape == got["labels"].shape == (B, 40 - tcfg.n_patches)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_feeds_carry_the_float_batches(arch):
    """Both feeds of the port give the JAX kernel-stack feed's batches, float
    frames and patches as they are, then a clean end of stream; the bytes
    counted are the host arrays'."""
    jcfg, tcfg = _configs(arch)
    jf = JaxKernelStackFeed(jax_stream_factory(
        jcfg, JaxDataConfig(seq_len=24, global_batch=4, seed=9), n_steps=3)(0, 1))
    factory = stream_factory(tcfg, DataConfig(seq_len=24, global_batch=4, seed=9), n_steps=3)
    kf = KernelStackFeed(factory(0, 1), CPU)
    bp = BypassDataplane(factory, device=CPU, depth=2, ports=1)
    nbytes = sum(v.nbytes for v in synth_tokens(
        tcfg, DataConfig(seq_len=24, global_batch=4, seed=9), 0, 1, 0).values())
    try:
        for _ in range(3):
            want = jf.next_batch()
            for feed in (kf, bp):
                got = feed.next_batch()
                assert sorted(got) == sorted(want)
                for k in want:
                    w = np.asarray(want[k])
                    assert got[k].numpy().dtype == w.dtype
                    assert got[k].numpy().tobytes() == np.ascontiguousarray(w).tobytes()
        assert bp.next_batch() is None and kf.next_batch() is None
        assert bp.stats.batches == kf.stats.batches == 3
        assert bp.stats.bytes == kf.stats.bytes == 3 * nbytes
    finally:
        bp.stop()


# -- AdamW ----------------------------------------------------------------------------

def test_adamw_step_on_hubert_matches_jax():
    """One AdamW step on hubert-xlarge's smoke tree from the same gradients
    (JAX's, whose ``embed.tok`` is all zero): params, master copy and moments
    within 1e-6 of each leaf's largest; ``embed.tok`` moves by its weight
    decay alone, equal in both."""
    jcfg, tcfg = _configs("hubert-xlarge", **F32)
    jp, tp = _params(jcfg, tcfg)
    host = synth_tokens(tcfg, DataConfig(seq_len=32, global_batch=2, seed=4), 0, 1, 0)
    (_, _), jg = jax.value_and_grad(lambda p: jlm.train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in host.items()}), has_aux=True)(jp)
    _, _, tg_own = steps.loss_and_grads(tcfg, tp, {k: torch.from_numpy(v)
                                                   for k, v in host.items()})
    assert not np.asarray(jg["embed"]["tok"]).any() and not tg_own["embed"]["tok"].any()
    jopt = jadamw.AdamWConfig(lr=1e-2, warmup_steps=1, decay_steps=10)
    topt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, decay_steps=10)
    jstate = jadamw.init(jopt, jp)
    tstate = opt_state_from_jax(_np_tree(jstate))
    tok0 = tp["embed"]["tok"].clone()
    jp1, jstate1, jmet = jadamw.apply_updates(jopt, jp, jg, jstate)
    tp1, tstate1, tmet = adamw.apply_updates(topt, tp, params_from_jax(_np_tree(jg), tcfg),
                                             tstate)
    assert float(jmet["lr"]) > 0 and abs(float(tmet["lr"]) - float(jmet["lr"])) <= \
        ADAM_REL * float(jmet["lr"])
    for got, want in ((tp1, jp1), (tstate1.master, jstate1.master), (tstate1.m, jstate1.m),
                      (tstate1.v, jstate1.v)):
        g, w = tree.leaf_paths(got), tree.leaf_paths(_np_tree(want))
        assert sorted(g) == sorted(w)
        for key in w:
            bound = ADAM_REL * max(float(np.abs(_f32(w[key])).max()), 1e-30)
            assert float(np.abs(g[key].float().numpy() - _f32(w[key])).max()) <= bound, key
    decayed = tok0 * (1 - float(tmet["lr"]) * topt.weight_decay)
    assert float((tp1["embed"]["tok"] - tok0).abs().max()) > 0
    torch.testing.assert_close(tp1["embed"]["tok"], decayed, atol=1e-7, rtol=1e-6)


# -- the trainer ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_trainer_losses_match_the_jax_train_step(arch):
    """The port's TrainerRuntime (bypass feed) from converted JAX params and
    optimizer state against the JAX train step looped over the JAX stream,
    and hubert-xlarge's ``embed.tok`` after the steps, decayed alike."""
    jcfg, tcfg = _configs(arch, **F32)
    jp, tp = _params(jcfg, tcfg, seed=1)
    jopt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    topt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=8)
    js = jadamw.init(jopt, jp)
    ts = opt_state_from_jax(_np_tree(js))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    jstream = jax_stream_factory(jcfg, JaxDataConfig(seq_len=32, global_batch=2, seed=6),
                                 n_steps=3)(0, 1)
    want = []
    for batch in jstream:
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(m["loss"]))
    rt = TrainerRuntime(tcfg, DataConfig(seq_len=32, global_batch=2, seed=6),
                        TrainerConfig(steps=3, feed="bypass", log_every=1), topt, device=CPU)
    state = rt.run(TrainerState(params=tp, opt_state=ts))
    got = [m["loss"] for m in rt.metrics_log]
    assert state.step == 3 and rt.feed.stats.batches == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * abs(w), (got, want)
    if arch == "hubert-xlarge":
        w = _f32(jp["embed"]["tok"])
        g = state.params["embed"]["tok"].numpy()
        assert float(np.abs(g - w).max()) <= ADAM_REL * float(np.abs(w).max())


# -- the launchers ------------------------------------------------------------------------

def test_serve_main_runs_internvl2_on_the_cpu():
    res = serve_launch.main(["--arch", "internvl2-26b", "--smoke", "--device", "cpu",
                             "--requests", "3", "--batch", "2", "--prompt-len", "8",
                             "--gen-len", "3"])
    assert res["finite"] and res["total_tokens"] == 2 * 2 * 3
    assert tuple(res["tokens"].shape) == (4, 4)


def test_serve_places_the_patches_before_the_text(monkeypatch):
    """The prefill gets n_patches patches drawn after the prompt's tokens
    from the same rng, in the compute dtype; the cache holds patches,
    prompt and generated tokens; decode starts at n_patches + prompt_len."""
    from repro_torch.models import lm
    cfg = t_vlm.SMOKE_CONFIG
    seen = {}
    prefill, decode_step = lm.prefill, lm.decode_step

    def spy_prefill(c, p, batch, max_len):
        seen["batch"], seen["max_len"] = batch, max_len
        return prefill(c, p, batch, max_len)

    def spy_decode(c, p, cache, token, pos):
        seen.setdefault("pos", []).append(int(pos[0]))
        return decode_step(c, p, cache, token, pos)
    monkeypatch.setattr(lm, "prefill", spy_prefill)
    monkeypatch.setattr(lm, "decode_step", spy_decode)
    params = serve_launch.init_params(cfg, 0, CPU)
    serve_launch.serve(cfg, params, requests=2, batch=2, prompt_len=8, gen_len=2, seed=5,
                       device=CPU)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 8))
    patches = rng.standard_normal((2, cfg.n_patches, cfg.d_model)) * 0.02
    assert seen["max_len"] == cfg.n_patches + 8 + 2
    np.testing.assert_array_equal(seen["batch"]["tokens"].numpy(), tokens)
    assert seen["batch"]["patches"].dtype == torch.bfloat16
    np.testing.assert_array_equal(seen["batch"]["patches"].float().numpy(),
                                  torch.from_numpy(patches).to(torch.bfloat16).float().numpy())
    assert seen["pos"] == [cfg.n_patches + 8, cfg.n_patches + 9]


def test_serve_refuses_the_encoder_as_jax_does(monkeypatch):
    with pytest.raises(ValueError, match="encoder-only: no decode serving"):
        serve_launch.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "hubert-xlarge", "--smoke"])
    with pytest.raises(SystemExit, match="encoder-only: no decode serving"):
        jax_serve.main()


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("feed", ["bypass", "kernel"])
def test_train_main_runs_on_the_cpu(arch, feed):
    rt = train_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                            "--seq-len", "32", "--global-batch", "2", "--feed", feed,
                            "--log-every", "1"])
    assert [m["step"] for m in rt.metrics_log] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for m in rt.metrics_log)
    assert rt.feed.stats.batches == 3
