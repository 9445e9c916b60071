"""Tensor parallelism of the port's recurrent blocks over ``model``: mamba2's
SSD blocks by heads (``models/mamba2.py``) and the RG-LRU blocks by width
(``models/rglru.py``), on gloo ranks on the CPU, held against the JAX
package and the port's unsharded functions.

Three worlds run while the references are computed here:

* ``torch_mesh_worlds.train_job`` (8 ranks): one f32 train step of
  mamba2-1.3b and recurrentgemma-9b at smoke widths on (2, 4) under
  ``single_pod_rules`` and on (2, 2, 2) under ``multi_pod_rules``, against
  the JAX package's unsharded ``value_and_grad`` of ``lm.train_loss``: the
  loss within 1e-5 relative and every gradient within 1e-4 of its leaf's
  largest, the bounds of tests/test_torch_sharded_train.py. The smoke
  mamba2 has 8 heads, 2 a rank on (2, 4); its ``in_proj`` of 296 columns is
  stored in contiguous shards of 74, which straddle its z, x, B, C and dt
  groups, so a rank that read its stored shard in place of its heads'
  columns would fail. The smoke RG-LRU's width of 64 is 16 columns, two of
  its 8 gate blocks, a rank on (2, 4);
* ``torch_serve_worlds.serve_job`` (8 ranks): prefill and 4 greedy decode
  steps of both on (2, 4) under ``single_pod_rules``, against the port's
  unsharded run (which the other test_torch_* files hold to JAX): logits
  and states within 1e-4 of each tensor's largest magnitude, the tokens
  equal, each rank's ``ssm``, ``h`` and ``conv`` holding its share;
* ``torch_mesh_worlds.rglru_block_job`` (16 ranks): the RG-LRU block alone
  at smoke width on (1, 16), where each of the 8 gate blocks straddles two
  ranks (4 columns a rank, blocks of 8): output, the gradients of x and of
  every param, and a decode step from the prefill's states, against the
  unsharded block within 1e-4 of each tensor's largest magnitude.

And in a fake world of 8 ranks (``launch/dryrun``), the per-rank dot FLOP
of a mamba2-1.3b smoke prefill under the ``tp`` layout equals, exactly, the
unsharded count with ``in_proj``'s z, x and dt columns over m, its B and C
columns whole and ``out_proj`` over m, and the SSD op's counted work is its
work at H/m heads.
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
from repro_torch.kernels import costs
from repro_torch.models import lm, rglru
from repro_torch.models.registry import get_smoke_config
from repro_torch.optim import adamw
from repro_torch.parallel.axes import multi_pod_rules, single_pod_rules
from torch_mesh_worlds import World, rglru_block_job, train_job
from torch_serve_worlds import serve, serve_job

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL, OF_MAX = 1e-5, 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ["mamba2-1.3b", "recurrentgemma-9b"]
MESHES = {"single": ((2, 4), single_pod_rules()), "multi": ((2, 2, 2), multi_pod_rules())}
TRAIN_CASES = [(a, m) for a in ARCHS for m in MESHES]
PROMPT = {"mamba2-1.3b": 12, "recurrentgemma-9b": 24}  # recurrentgemma: past its window of 16
GEN = 4
DCFG = dict(seq_len=16, global_batch=8, seed=3)
STRADDLE = (1, 16)  # the RG-LRU's 8 gate blocks over 16 model ranks


def _f32(arch, jax_side=False):
    return (jax_smoke_config if jax_side else get_smoke_config)(arch).replace(**F32)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, what, of_max=OF_MAX):
    bound = of_max * max(float(want.abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= bound, (what, err, bound)


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


def _block_case(seed):
    """An RG-LRU block at smoke width with drawn biases (the init's are 0),
    its input, cotangent and a decode token."""
    cfg = _f32("recurrentgemma-9b")
    g = torch.Generator().manual_seed(seed)
    p = rglru.init_rglru_block(cfg, g, "cpu")
    for k in ("b_a", "b_i", "conv_b"):
        p[k] = torch.randn(p[k].shape, generator=g) * 0.1
    B, S, D = 2, 10, cfg.d_model
    return dict(cfg=cfg, params=p, rules=single_pod_rules(), mesh=STRADDLE,
                x=torch.randn((B, S, D), generator=g), dy=torch.randn((B, S, D), generator=g),
                x_t=torch.randn((B, 1, D), generator=g))


def _block_reference(case):
    cfg, p = case["cfg"], tree.tree_map(torch.clone, case["params"])
    leaves = tree.leaf_paths(p)
    for t in leaves.values():
        t.requires_grad_(True)
    x = case["x"].clone().requires_grad_(True)
    y, h_last, xb = rglru._rglru_mix(cfg, p, x)
    grads = torch.autograd.grad((y * case["dy"]).sum(), [x] + list(leaves.values()))
    with torch.no_grad():
        state = {"h": h_last.detach().float(),
                 "conv": xb[:, -(cfg.conv_width - 1):].detach().float()}
        out, new = rglru.rglru_block_decode(cfg, p, case["x_t"], state)
    return {"y": y.detach(), "dx": grads[0], "grads": dict(zip(leaves, grads[1:])),
            "state": state, "decode": {"out": out, **new}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    def start(job, cases, name, n=8):
        d = tmp_path_factory.mktemp(name)
        torch.save({"cases": cases}, d / "inputs.pt")
        return World(job, n, d)

    block_case = {"straddle": _block_case(5)}
    block_world = start(rglru_block_job, block_case, "rglru_block_world", n=16)

    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    train_cases, train_refs = {}, {}
    for arch in ARCHS:
        cfg = _f32(arch)
        host = _train_batch(cfg)
        loss, grads, params = _jax_step(arch, host)
        train_refs[arch] = (loss, grads)
        for name, (shape, rules) in MESHES.items():
            train_cases[f"{arch}/{name}"] = dict(
                cfg=cfg, opt=opt, params=params, rules=rules, mesh=shape,
                batches=[{k: torch.from_numpy(v) for k, v in host.items()}])
    train_world = start(train_job, train_cases, "recurrent_train_world")

    serve_cases, serve_refs = {}, {}
    for arch in ARCHS:
        cfg = _f32(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompt = {"tokens": _tokens(cfg, (4, PROMPT[arch]), 11)}
        case = dict(cfg=cfg, params=params, prompt=prompt, tokens=None, mesh=(2, 4),
                    rules=single_pod_rules(), max_len=PROMPT[arch] + GEN)
        serve_cases[arch] = case
        logits, fed, cache = serve(cfg, params, prompt, case["max_len"])
        serve_refs[arch] = {"logits": logits, "tokens": fed, "cache": tree.leaf_paths(cache)}
    serve_world = start(serve_job, serve_cases, "recurrent_serve_world")

    block_refs = {k: _block_reference(c) for k, c in block_case.items()}
    return ((train_world.result(), train_refs), (serve_world.result(), serve_refs),
            (block_world.result(), block_refs))


# -- (a) train steps against the JAX package's unsharded step ------------------------------

@pytest.mark.parametrize("arch,mesh", TRAIN_CASES)
def test_recurrent_tensor_parallel_train_step_matches_the_jax_unsharded_step(worlds, arch,
                                                                              mesh):
    (results, refs), _, _ = worlds
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


# -- (b) prefill and greedy decode ------------------------------------------------------------

def _local_states(arch):
    """The shapes of rank 0's recurrent states on (2, 4): (B rows 2, model 4)."""
    cfg = get_smoke_config(arch)
    B, K = 2, cfg.conv_width
    if arch == "mamba2-1.3b":
        H, P, N, L = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.n_layers
        return {"ssm": (L, B, H // 4, P, N), "conv": (L, B, K - 1, cfg.d_inner // 4 + 2 * N)}
    W = cfg.lru_width // 4  # two whole gate blocks a rank
    return {"units/0/h": (1, B, W), "units/0/conv": (1, B, K - 1, W),
            "units/1/h": (1, B, W), "units/1/conv": (1, B, K - 1, W),
            "tail/0/h": (B, W), "tail/0/conv": (B, K - 1, W),
            "tail/1/h": (B, W), "tail/1/conv": (B, K - 1, W)}


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_tensor_parallel_greedy_serving_matches_the_unsharded_run(worlds, arch):
    _, (results, refs), _ = worlds
    got, want = results[arch], refs[arch]
    assert got["shards"] == 2 and not got["replicated"]
    for path, shape in _local_states(arch).items():
        assert got["local_shapes"][path] == shape, path
    if arch == "recurrentgemma-9b":
        # its one kv head at C/4 of the 16 ring slots a rank (kv_seq)
        assert got["local_kv_heads"] == 1 and got["local_shapes"]["units/2/k"][-3] == 4
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


# -- (c) the RG-LRU block where its gate blocks straddle model ranks ---------------------------

def test_rglru_block_at_model_16_straddling_its_gate_blocks_matches_the_unsharded_block(worlds):
    _, _, (results, refs) = worlds
    got, want = results["straddle"], refs["straddle"]
    cfg = get_smoke_config("recurrentgemma-9b")
    W, kb = cfg.lru_width, cfg.lru_width // rglru.N_DIAG_BLOCKS
    assert got["share"] == rglru.WidthShare((0, W // 16), (0, kb))  # rank 0: half of block 0
    assert got["state_shapes"] == {"h": (2, W // 16), "conv": (2, cfg.conv_width - 1, kb)}
    _close(got["y"], want["y"], "y")
    _close(got["dx"], want["dx"], "dx")
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        _close(got["grads"][k], w, k)
    for k in ("h", "conv"):
        _close(got["state"][k], want["state"][k], f"prefill {k}")
    for k in ("out", "h", "conv"):
        _close(got["decode"][k], want["decode"][k], f"decode {k}")


# -- (d) the per-rank dot FLOP of a mamba2 prefill under the tp layout -------------------------

_FLOPS = """
    import json
    from repro_torch.launch.dryrun import count_step, fake_world
    from repro_torch.launch.mesh import make_auto_mesh, rules_for
    from repro_torch.models.registry import get_smoke_config
    cfg = get_smoke_config("mamba2-1.3b")
    B, S = 4, 64
    plain = count_step(cfg, "prefill", S, B // 2)["cost"]
    with fake_world(8):
        mesh = make_auto_mesh((2, 4), ("data", "model"), "cuda")
        tp = count_step(cfg, "prefill", S, B, mesh=mesh, rules=rules_for(mesh, "tp"))
    print(json.dumps({"plain": [plain.dot_flops, plain.kernel_flops],
                      "tp": [tp["cost"].dot_flops, tp["cost"].kernel_flops],
                      "kernel_calls": tp["cost"].kernel_calls,
                      "rows": tp["rows_per_rank"],
                      "collectives": tp["cost"].collective_counts,
                      "model_groups": {k: list(v) for k, v in
                                       tp["cost"].collective_groups.items()}}))
"""


def test_per_rank_dot_flops_of_a_tp_mamba2_prefill_split_the_heads():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_FLOPS)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = get_smoke_config("mamba2-1.3b")
    m, B, S = 4, 2, 64  # the rank's rows
    T, L, D, V = B * S, cfg.n_layers, cfg.d_model, cfg.vocab_size
    d_in, H, P, N, Q = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    zx_dt = L * 2 * T * D * (2 * d_in + H)  # in_proj's z, x and dt columns
    bc = L * 2 * T * D * 2 * N              # its B and C columns, which every head reads
    out_proj = L * 2 * T * d_in * D
    logits = 2 * B * D * V                  # the last position's, vocab-parallel
    ssd = L * costs.ssd_forward(B, S, H, P, N, Q, 4).flops
    plain, plain_kernel = got["plain"]
    assert got["rows"] == B
    assert plain_kernel == ssd
    assert plain == zx_dt + bc + out_proj + logits + ssd  # nothing else is a product
    tp, tp_kernel = got["tp"]
    # the SSD op at H/m heads, on the shared B and C
    assert tp_kernel == L * costs.ssd_forward(B, S, H // m, P, N, Q, 4).flops
    assert tp == (zx_dt + out_proj + logits) / m + bc + tp_kernel, (tp, plain)
    assert got["kernel_calls"] == {"ssd_scan": L}
    # one all-reduce over model a layer (the block's output) and one for the
    # gated norm's statistic, in groups of 4
    assert got["collectives"]["all-reduce"] >= 2 * L
    assert 4 in got["model_groups"]["all-reduce"]
