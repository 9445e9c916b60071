"""Tensor parallelism of the port's dense layers over ``model`` (Megatron
style, ``models/layers.py`` with ``parallel/axes.py``), on gloo ranks on the
CPU, held against the JAX package and the port's unsharded functions.

Three worlds of 8 ranks run while the references are computed here:

* ``torch_mesh_worlds.vocab_job``: the vocab-parallel embedding, logits and
  chunked cross-entropy alone on a (2, 4) mesh under ``single_pod_rules``
  (qwen3-1.7b's smoke widths, tied, and granite-8b's, untied; f32), with
  labels of -100 and two equal largest logits in the blocks of two model
  ranks, against the same functions without a mesh: the embedding bitwise,
  the loss within 1e-5 relative, logits and gradients within 1e-4 of each
  tensor's largest magnitude, the argmax equal (the first of the tie);
* ``torch_mesh_worlds.train_job``: one f32 train step of qwen3-1.7b,
  granite-8b, phi4-mini-3.8b and hubert-xlarge (the GELU MLP's biases,
  LayerNorm, audio frames) at smoke widths on (2, 4) under
  ``single_pod_rules`` and on (2, 2, 2) under ``multi_pod_rules``, against
  the JAX package's unsharded ``value_and_grad`` of ``lm.train_loss``: the
  loss within 1e-5 relative and every gradient within 1e-4 of its leaf's
  largest, the bounds of tests/test_torch_sharded_train.py. phi4's 6 smoke
  heads do not split over 4, so on (2, 4) its attention runs whole while
  its MLP and vocab split; on (2, 2, 2) they split 3 a rank on 1 kv head;
* ``torch_serve_worlds.serve_job``: prefill and 4 greedy decode steps of
  qwen3-1.7b and mixtral-8x7b (past its smoke window) on (2, 4) under
  ``single_pod_rules``, against the port's unsharded run (which the other
  test_torch_* files hold to JAX): logits and caches within 1e-4 of each
  tensor's largest magnitude (tests/test_torch_sharded_serve.py's bound),
  the tokens equal, each rank's cache holding its C/4 slots of both kv
  heads (the context-sharded layout, tests/test_torch_kv_seq.py).

And in a fake world of 8 ranks (``launch/dryrun``), the per-rank dot FLOP
of a qwen3-1.7b smoke prefill under the ``tp`` layout equals, exactly, the
unsharded count with the split products divided by 4 and the k and v
projections at the rank's kv heads. The choice of what splits is checked at
(16, 16) for every arch's production config.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.registry import get_smoke_config as jax_smoke_config
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, synth_tokens
from repro_torch.models import layers, lm, mamba2, rglru, transformer
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.parallel import axes
from repro_torch.parallel.axes import multi_pod_rules, single_pod_rules
from repro_torch.optim import adamw
from torch_mesh_worlds import World, train_job, vocab_job
from torch_serve_worlds import serve, serve_job

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL, OF_MAX = 1e-5, 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
TRAIN_ARCHS = ["qwen3-1.7b", "granite-8b", "phi4-mini-3.8b", "hubert-xlarge"]
MESHES = {"single": ((2, 4), single_pod_rules()), "multi": ((2, 2, 2), multi_pod_rules())}
TRAIN_CASES = [(a, m) for a in TRAIN_ARCHS for m in MESHES]
SERVE_ARCHS = ["qwen3-1.7b", "mixtral-8x7b"]
PROMPT = {"qwen3-1.7b": 12, "mixtral-8x7b": 40}  # mixtral: past its smoke window of 32
GEN = 4
VOCAB_ARCHS = {"tied": "qwen3-1.7b", "untied": "granite-8b"}
TIE = (5, 300)  # two vocab rows, in the blocks of model ranks 0 and 2 of 4
DCFG = dict(seq_len=16, global_batch=8, seed=3)


def _f32(arch, jax_side=False):
    cfg = (jax_smoke_config if jax_side else get_smoke_config)(arch).replace(**F32)
    return cfg.replace(capacity_factor=8.0) if cfg.n_experts else cfg


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, what, of_max=OF_MAX):
    bound = of_max * max(float(want.abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= bound, (what, err, bound)


# -- the inputs and references ---------------------------------------------------------

def _vocab_case(arch, seed):
    cfg = _f32(arch)
    g = torch.Generator().manual_seed(seed)
    embed = layers.init_embedding(cfg, g, "cpu")
    B, S, D, V = 4, 10, cfg.d_model, cfg.vocab_size
    w = embed["tok" if cfg.tie_embeddings else "unembed"]
    for row in TIE:  # two equal rows, whose logit is exactly 100 at every h_last
        w[row] = 0.0
        w[row, 0] = 100.0
    h_last = torch.randn((B, D), generator=g) * 0.1
    h_last[:, 0] = 1.0
    labels = torch.randint(0, V, (B, S), generator=g)
    labels[0, :3] = -100
    labels[3, -1] = -100
    labels[1, 2], labels[2, 4] = TIE  # labels in two ranks' blocks
    return dict(cfg=cfg, embed=embed, tokens=torch.randint(0, V, (B, S), generator=g),
                h=torch.randn((B, S, D), generator=g), h_last=h_last, labels=labels,
                dy=torch.randn((B, S, D), generator=g), dlogits=torch.randn((B, V), generator=g),
                s_chunk=4)


def _vocab_reference(case):
    """The same functions without a mesh, whole batch."""
    cfg, p = case["cfg"], tree.tree_map(torch.clone, case["embed"])
    leaves = tree.leaf_paths(p)
    for t in leaves.values():
        t.requires_grad_(True)
    h = case["h"].clone().requires_grad_(True)
    h_last = case["h_last"].clone().requires_grad_(True)
    emb = layers.embed_tokens(cfg, p, case["tokens"])
    logits = layers.logits_for(cfg, p, h_last)
    loss_sum, n_valid = layers.chunked_softmax_xent(cfg, p, h, case["labels"],
                                                    s_chunk=case["s_chunk"])
    total = (emb * case["dy"]).sum() + loss_sum + (logits * case["dlogits"]).sum()
    grads = torch.autograd.grad(total, [h, h_last] + list(leaves.values()))
    return {"emb": emb.detach(), "logits": logits.detach(), "argmax": torch.argmax(logits, -1),
            "loss_sum": loss_sum.detach(), "n_valid": n_valid, "dh": grads[0],
            "dh_last": grads[1], "grads": dict(zip(leaves, grads[2:]))}


def _train_batch(cfg):
    host = synth_tokens(cfg, DataConfig(**DCFG), 0, 1, 0)
    host = {k: v.copy() for k, v in host.items()}  # labels view the tokens' array
    host["labels"][5, -3:] = -100
    return host


def _jax_step(arch, host):
    """(loss, whole gradients as the port's tree) of the JAX package's
    unsharded train loss, and the port's params from the same JAX init."""
    jcfg = _f32(arch, jax_side=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(jcfg, p, b)[0]))(jp, {k: jax.numpy.asarray(v)
                                                         for k, v in host.items()})
    cfg = _f32(arch)
    return float(loss), params_from_jax(_np_tree(grads), cfg), params_from_jax(_np_tree(jp), cfg)


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    def start(job, cases, name):
        d = tmp_path_factory.mktemp(name)
        torch.save({"cases": cases}, d / "inputs.pt")
        return World(job, 8, d)

    vocab_cases = {k: _vocab_case(a, i) for i, (k, a) in enumerate(VOCAB_ARCHS.items())}
    vocab_world = start(vocab_job, vocab_cases, "vocab_world")

    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    train_cases, train_refs = {}, {}
    for arch in TRAIN_ARCHS:
        cfg = _f32(arch)
        host = _train_batch(cfg)
        loss, grads, params = _jax_step(arch, host)
        train_refs[arch] = (loss, grads)
        for name, (shape, rules) in MESHES.items():
            train_cases[f"{arch}/{name}"] = dict(
                cfg=cfg, opt=opt, params=params, rules=rules, mesh=shape,
                batches=[{k: torch.from_numpy(v) for k, v in host.items()}])
    train_world = start(train_job, train_cases, "tp_train_world")

    serve_cases, serve_refs = {}, {}
    for arch in SERVE_ARCHS:
        cfg = _f32(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompt = {"tokens": _tokens(cfg, (4, PROMPT[arch]), 11)}
        case = dict(cfg=cfg, params=params, prompt=prompt, tokens=None, mesh=(2, 4),
                    rules=single_pod_rules(), max_len=PROMPT[arch] + GEN)
        serve_cases[arch] = case
        logits, fed, cache = serve(cfg, params, prompt, case["max_len"])
        serve_refs[arch] = {"logits": logits, "tokens": fed, "cache": tree.leaf_paths(cache)}
    serve_world = start(serve_job, serve_cases, "tp_serve_world")

    vocab_refs = {k: _vocab_reference(c) for k, c in vocab_cases.items()}
    return ((vocab_world.result(), vocab_refs), (train_world.result(), train_refs),
            (serve_world.result(), serve_refs))


# -- (a) the vocab-parallel embedding, logits and cross-entropy --------------------------

@pytest.mark.parametrize("case", list(VOCAB_ARCHS))
def test_vocab_parallel_embedding_logits_and_loss_match_the_unsharded_ones(worlds, case):
    (got_all, refs), _, _ = worlds
    got, want = got_all[case], refs[case]
    cfg = get_smoke_config(VOCAB_ARCHS[case])
    assert got["local_rows"] == cfg.vocab_size // 4  # each rank holds its block of V
    assert torch.equal(got["emb"], want["emb"])
    assert got["logits"].shape == want["logits"].shape
    _close(got["logits"], want["logits"], "logits")
    assert float(got["n_valid"]) == float(want["n_valid"]) == 4 * 10 - 4
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= \
        LOSS_REL * abs(float(want["loss_sum"]))
    _close(got["dh"], want["dh"], "dh")
    _close(got["dh_last"], want["dh_last"], "dh_last")
    g = tree.leaf_paths(got["grads"])
    assert sorted(g) == sorted(want["grads"])
    for k, w in want["grads"].items():
        _close(g[k], w, k)


@pytest.mark.parametrize("case", list(VOCAB_ARCHS))
def test_gathered_logits_break_a_tie_across_ranks_as_the_unsharded_argmax(worlds, case):
    (got_all, refs), _, _ = worlds
    got, want = got_all[case], refs[case]
    assert torch.equal(got["logits"][:, TIE[0]], got["logits"][:, TIE[1]])
    assert torch.equal(got["argmax"], want["argmax"])
    assert (got["argmax"] == TIE[0]).all()


# -- (b) train steps against the JAX package's unsharded step ------------------------------

@pytest.mark.parametrize("arch,mesh", TRAIN_CASES)
def test_tensor_parallel_train_step_matches_the_jax_unsharded_step(worlds, arch, mesh):
    _, (results, refs), _ = worlds
    r = results[f"{arch}/{mesh}"]
    loss, grads = refs[arch]
    step = r["steps"][0]
    assert abs(step["loss"] - loss) <= LOSS_REL * abs(loss), (step["loss"], loss)
    assert step["tokens"] == 8 * 16 - 3
    assert r["grads_laid_out"]  # each gradient placed as its param, Shard on model too
    got, want = tree.leaf_paths(r["grads"]), tree.leaf_paths(grads)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)


# -- (c) prefill and greedy decode ------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_tensor_parallel_greedy_serving_matches_the_unsharded_run(worlds, arch):
    _, _, (results, refs) = worlds
    got, want = results[arch], refs[arch]
    assert got["shards"] == 2 and not got["replicated"]
    # the caches' slots split over model (kv_seq; 4 divides qwen3's 16 and
    # mixtral's 32-slot ring): C/4 slots of both smoke kv heads a rank
    C = transformer.cache_size_for(_f32(arch), PROMPT[arch] + GEN)
    assert got["local_kv_heads"] == 2 and got["local_shapes"]["k"][-3] == C // 4
    assert len(got["logits"]) == len(want["logits"]) == GEN + 1
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert g.shape == w.shape
        _close(g, w, f"logits of step {i}")
    for i, (g, w) in enumerate(zip(got["tokens"], want["tokens"])):
        assert torch.equal(g, w), (i, g, w)
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, w in want["cache"].items():
        assert got["cache"][k].shape == w.shape, k
        _close(got["cache"][k], w, k)


# -- (d) the per-rank dot FLOP under the tp layout ----------------------------------------------

_FLOPS = """
    import json
    from repro_torch.launch.dryrun import count_step, fake_world
    from repro_torch.launch.mesh import make_auto_mesh, rules_for
    from repro_torch.models.registry import get_smoke_config
    cfg = get_smoke_config("qwen3-1.7b")
    B, S = 4, 64
    plain = count_step(cfg, "prefill", S, B // 2)["cost"]
    with fake_world(8):
        mesh = make_auto_mesh((2, 4), ("data", "model"), "cuda")
        tp = count_step(cfg, "prefill", S, B, mesh=mesh, rules=rules_for(mesh, "tp"))
    print(json.dumps({"plain": [plain.dot_flops, plain.kernel_flops],
                      "tp": [tp["cost"].dot_flops, tp["cost"].kernel_flops],
                      "rows": tp["rows_per_rank"],
                      "collectives": tp["cost"].collective_counts,
                      "model_groups": {k: list(v) for k, v in
                                       tp["cost"].collective_groups.items()}}))
"""


def test_per_rank_dot_flops_of_a_tp_prefill_are_the_split_products():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_FLOPS)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = get_smoke_config("qwen3-1.7b")
    m, B, S = 4, 2, 64  # the rank's rows
    T, L, D, H, Hkv, Dh, F, V = (B * S, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    q = o = L * 2 * T * D * H * Dh
    kv = L * 2 * 2 * T * D * Hkv * Dh
    mlp = L * 3 * 2 * T * D * F
    logits = 2 * B * D * V  # the last position's
    plain, plain_kernel = got["plain"]
    assert got["rows"] == B
    assert plain == q + kv + o + mlp + logits + plain_kernel  # nothing else is a product
    kv_local = max(1, (H // m) // (H // Hkv))  # the kv heads of the rank's q heads: 1
    want = (q + o + mlp + logits) / m + kv * kv_local / Hkv + plain_kernel / m
    tp, tp_kernel = got["tp"]
    assert tp_kernel == plain_kernel / m
    assert tp == want, (tp, want, plain)
    # two all-reduces over model a layer (attention, MLP), the embedding's
    # and the logits' all-gather, each in groups of 4
    assert got["collectives"]["all-reduce"] >= 2 * L + 1
    assert 4 in got["model_groups"]["all-reduce"]


# -- what splits, at (16, 16) --------------------------------------------------------------

class _Mesh:
    """A stand-in (16, 16) mesh: sizes and this rank's place on model."""
    shape = {"data": 16, "model": 16}
    mesh_dim_names = ("data", "model")

    def __init__(self, model_rank):
        self.rank = model_rank

    def get_local_rank(self, axis):
        return self.rank if axis == "model" else 0


# arch → (q heads a rank, kv heads a rank) at model 16, or None: attention whole
# (mamba2-1.3b has no attention)
HEADS_AT_16 = {"qwen3-1.7b": (1, 1), "granite-8b": (2, 1), "mixtral-8x7b": (2, 1),
               "internvl2-26b": (3, 1), "recurrentgemma-9b": (1, 1), "hubert-xlarge": (1, 1),
               "phi4-mini-3.8b": None, "llama3.2-3b": None,
               "llama4-maverick-400b-a17b": None, "mamba2-1.3b": None}


def _recurrent_split_at_16(cfg, r):
    """The recurrent blocks' split at model 16, rank r: mamba2's 4 of its 64
    SSD heads, the RG-LRU's 256 of 4096 columns, whose gate blocks of 512
    straddle two ranks (the rank's whole block is its conv's columns)."""
    if cfg.family == "ssm":
        assert cfg.n_ssm_heads == 64
        assert mamba2.heads_split(cfg) == (16, r)
        spans = mamba2.in_proj_spans(cfg, 16, r)
        d_in, N = cfg.d_inner, cfg.ssm_state
        assert [hi - lo for lo, hi in spans] == [d_in // 16, d_in // 16, 2 * N, 4]
        assert spans[2] == (2 * d_in, 2 * d_in + 2 * N)  # B and C whole on every rank
        assert mamba2.conv_spans(cfg, 16, r) == [(r * 256, (r + 1) * 256), (d_in, d_in + 2 * N)]
    if cfg.family == "hybrid":
        assert cfg.lru_width == 4096
        block = (r // 2) * 512
        assert rglru.width_share(cfg) == rglru.WidthShare((r * 256, (r + 1) * 256),
                                                          (block, block + 512))


@pytest.mark.parametrize("arch", sorted(HEADS_AT_16))
def test_what_the_single_pod_rules_split_at_16_by_16(arch):
    cfg = get_config(arch)
    want = HEADS_AT_16[arch]
    for r in (0, 7, 15):
        with axes.axis_rules(single_pod_rules(), _Mesh(r)):
            if cfg.n_heads:
                local = layers.kv_heads_local(cfg)
                if want is None:
                    assert local is None and layers.n_kv_heads_cached(cfg) == cfg.n_kv_heads
                else:
                    q, n = want
                    assert local == ((r * q) // (cfg.n_heads // cfg.n_kv_heads), n), (r, local)
                    assert layers.n_kv_heads_cached(cfg) == n
            assert axes.tp_split("ffn", cfg.d_ff) == (16, r)
            v_split = cfg.vocab_size % 16 == 0
            assert axes.tp_split("vocab", cfg.vocab_size) == ((16, r) if v_split else (1, 0))
            _recurrent_split_at_16(cfg, r)
        with axes.axis_rules(axes.pure_fsdp_rules(), _Mesh(r)):
            if cfg.n_heads:
                assert layers.kv_heads_local(cfg) is None
            assert axes.tp_split("ffn", cfg.d_ff) == (1, 0)
            assert mamba2.heads_split(cfg) == (1, 0) and rglru.width_share(cfg) is None


def test_a_model_axis_of_one_splits_nothing():
    class One(_Mesh):
        shape = {"data": 1, "model": 1}
    cfg = get_config("qwen3-1.7b")
    with axes.axis_rules(single_pod_rules(), One(0)):
        assert layers.kv_heads_local(cfg) is None
        assert axes.tp_split("ffn", cfg.d_ff) == (1, 0)
        assert axes.tp_split("vocab", cfg.vocab_size) == (1, 0)
        for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
            rcfg = get_config(arch)
            assert mamba2.heads_split(rcfg) == (1, 0)
            assert rglru.width_share(rcfg) is None
        assert layers.kv_heads_local(get_config("recurrentgemma-9b")) is None
