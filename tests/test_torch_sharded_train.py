"""The port's train step and trainer on a mesh, on gloo ranks on the CPU.

One world of 8 ranks (``torch_mesh_worlds.train_job``) runs, for the smoke
configs of qwen3-1.7b, mixtral-8x7b (capacity factor 8.0),
llama4-maverick (its shared expert), mamba2-1.3b and recurrentgemma-9b, in
f32 on a global batch of 8 × 16 tokens (row 5's last 3 labels ignored, so
that the ranks' token counts differ):

* two train steps on a (2, 4) mesh under ``single_pod_rules`` and one under
  ``pure_fsdp_rules``, each rank on its rows: the first step's loss and
  every gradient, and each step's metrics;
* the trainer on a (2, 4) mesh (mixtral-8x7b, two steps, a checkpoint each
  step) and the elastic restore of its last checkpoint onto a (4, 2) mesh
  (tests/test_fault_tolerance.py:68's case): every param, master copy,
  moment and the step bit-exact, each leaf on the new mesh.

A world of one rank holds a (1, 1) mesh's step bitwise to the step without
a mesh (bf16, the configs' own dtype).

References: qwen3-1.7b and mixtral-8x7b against the JAX package
(``value_and_grad`` of ``lm.train_loss`` and ``adamw.apply_updates``),
their params converted from the JAX init; the other three against the
port's own unsharded step, which the other test_torch_* files hold to JAX.
The MoE archs' reference takes the aux loss as their sharded layers do, as
in the JAX package: each data block of the batch is a routing pool and the
aux loss is the mean of the pools' (tests/test_torch_sharded_moe.py); so
the reference loss is the sum over the two data blocks of the block's
cross-entropy sum over the global token count plus half the block's aux
loss. Bounds as tests/test_torch_train.py sets them: losses within 1e-5
relative, gradients within 1e-4 of each leaf's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.registry import get_smoke_config as jax_smoke_config
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.convert import map_experts, params_from_jax, unblock_experts
from repro_torch.data.pipeline import DataConfig, stream_factory, synth_tokens
from repro_torch.models import lm
from repro_torch.models.registry import get_smoke_config
from repro_torch.optim import adamw
from repro_torch.parallel.axes import pure_fsdp_rules, single_pod_rules
from repro_torch.parallel.specs import batch_rows
from torch_mesh_worlds import World, one_rank_job, train_job

LOSS_REL, GRAD_OF_MAX = 1e-5, 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ["qwen3-1.7b", "mixtral-8x7b", "llama4-maverick-400b-a17b", "mamba2-1.3b",
         "recurrentgemma-9b"]
JAX_REFERENCE = ("qwen3-1.7b", "mixtral-8x7b")
RULES = {"single": (single_pod_rules(), 2), "fsdp": (pure_fsdp_rules(), 1)}  # rules, steps
CASES = [(a, r) for a in ARCHS for r in RULES]
N_BLOCKS = 2  # the data blocks of a (2, 4) mesh: the MoE layers' routing pools
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
DCFG = dict(seq_len=16, global_batch=8, seed=3)


def _config(arch, jax_side=False):
    cfg = (jax_smoke_config if jax_side else get_smoke_config)(arch).replace(**F32)
    return cfg.replace(capacity_factor=8.0) if cfg.n_experts else cfg


def _batches(cfg, n=2):
    out = []
    for step in range(n):
        host = synth_tokens(cfg, DataConfig(**DCFG), 0, 1, step)
        host = {k: v.copy() for k, v in host.items()}  # labels view the tokens' array
        host["labels"][5, -3:] = -100
        out.append(host)
    return out


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_params(arch):
    jp = jlm.init_params(_config(arch, True), jax.random.PRNGKey(0))
    return jp, params_from_jax(_np_tree(jp), _config(arch))


def _jax_reference(arch, jp, batches):
    """(per step (loss, grad_norm), the first step's gradients) by the JAX
    package from its params ``jp``; the MoE arch's aux loss per data block."""
    jcfg, tcfg = _config(arch, True), _config(arch)
    jopt = jadamw.AdamWConfig(**OPT)
    js = jadamw.init(jopt, jp)
    blocks = N_BLOCKS if jcfg.n_experts else 1

    def share(p, b, n_tokens):
        _, m = jlm.train_loss(jcfg, p, b)
        return m["xent"] * (m["tokens"] / n_tokens) + m["aux"] / blocks

    grad_fn = jax.jit(jax.value_and_grad(share))
    update = jax.jit(lambda p, g, s: jadamw.apply_updates(jopt, p, g, s))
    out, first = [], None
    for host in batches:
        n_tokens = float((host["labels"] != -100).sum())
        loss, grads = 0.0, None
        for i in range(blocks):
            b = {k: jnp.asarray(v[i * 8 // blocks:(i + 1) * 8 // blocks]) for k, v in host.items()}
            l_i, g_i = grad_fn(jp, b, n_tokens)
            loss += float(l_i)
            grads = g_i if grads is None else jax.tree_util.tree_map(jnp.add, grads, g_i)
        if first is None:
            first = map_experts(_np_tree(grads), lambda m: unblock_experts(m, tcfg))
        jp, js, om = update(jp, grads, js)
        out.append((loss, float(om["grad_norm"])))
    return out, tree.tree_map(torch.from_numpy, first)


def _port_reference(cfg, params, batches, blocks=1):
    """The port's unsharded steps, the aux loss per data block for MoE:
    (per step (loss, grad_norm), the first step's gradients)."""
    opt = adamw.AdamWConfig(**OPT)
    p = tree.tree_map(torch.clone, params)
    state = adamw.init(opt, p)
    out, first = [], None
    for host in batches:
        b = {k: torch.from_numpy(v) for k, v in host.items()}
        n_tokens = float((b["labels"] != -100).sum())
        leaves = tree.leaf_paths(p)
        for t in leaves.values():
            t.requires_grad_(True)
        loss = 0.0
        grads = [torch.zeros_like(t) for t in leaves.values()]
        for i in range(blocks):
            _, m = lm.train_loss(cfg, p, batch_rows(b, blocks, i))
            share = m["xent"] * (m["tokens"] / n_tokens) + m["aux"] / blocks
            g = torch.autograd.grad(share, list(leaves.values()), allow_unused=True)
            grads = [a + (0 if c is None else c) for a, c in zip(grads, g)]
            loss += float(share.detach())
        for t in leaves.values():
            t.requires_grad_(False)
        grads = tree.unflatten_like(p, dict(zip(leaves, grads)))
        if first is None:
            first = grads
        p, state, om = adamw.apply_updates(opt, p, grads, state)
        out.append((loss, float(om["grad_norm"])))
    return out, first


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    opt = adamw.AdamWConfig(**OPT)
    one_cases = {}
    for arch in ("qwen3-1.7b", "mixtral-8x7b"):
        cfg = get_smoke_config(arch)  # bf16, as on the card
        one_cases[arch] = dict(
            cfg=cfg, opt=opt, params=lm.init_params(cfg, torch.Generator().manual_seed(1), "cpu"),
            batches=[{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(cfg)])
    one = tmp_path_factory.mktemp("one_rank_world")
    torch.save({"cases": one_cases}, one / "inputs.pt")
    one_rank = World(one_rank_job, 1, one)  # runs while the references are computed

    cases, jax_params, port_inputs = {}, {}, {}
    for arch in ARCHS:
        cfg = _config(arch)
        batches = _batches(cfg)
        if arch in JAX_REFERENCE:
            jax_params[arch], params = _jax_params(arch)
        else:
            params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        port_inputs[arch] = (cfg, params, batches)
        for name, (rules, n_steps) in RULES.items():
            cases[f"{arch}/{name}"] = dict(
                cfg=cfg, opt=opt, params=params, rules=rules, mesh=(2, 4),
                batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                         for b in batches[:n_steps]])
    # the trainer: its own init, its stream's batches
    cfg = _config("mixtral-8x7b")
    dcfg = DataConfig(**DCFG)
    trainer = dict(cfg=cfg, dcfg=dcfg, opt=opt, rules=single_pod_rules(), steps=2, seed=4)
    eight = tmp_path_factory.mktemp("train_world")
    torch.save({"cases": cases, "trainer": trainer}, eight / "inputs.pt")
    world = World(train_job, 8, eight)  # runs while the references are computed

    refs = {}
    for arch, (cfg, params, batches) in port_inputs.items():
        if arch in JAX_REFERENCE:
            refs[arch] = _jax_reference(arch, jax_params[arch], batches)
        else:
            refs[arch] = _port_reference(cfg, params, batches, N_BLOCKS if cfg.n_experts else 1)
    cfg = trainer["cfg"]
    init = lm.init_params(cfg, torch.Generator().manual_seed(trainer["seed"]), "cpu")
    stream = [{k: v.copy() for k, v in b.items()}
              for b in stream_factory(cfg, dcfg, n_steps=2)(0, 1)]
    refs["trainer"] = _port_reference(cfg, init, stream, N_BLOCKS)[0]
    return world.result(), refs, one_rank.result()


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("arch,rules", CASES)
def test_first_step_loss_and_every_gradient(worlds, arch, rules):
    results, refs, _ = worlds
    r = results[f"{arch}/{rules}"]
    per_step, first = refs[arch]
    assert _rel(r["steps"][0]["loss"], per_step[0][0]) <= LOSS_REL
    assert r["steps"][0]["tokens"] == 8 * 16 - 3
    got, want = tree.leaf_paths(r["grads"]), tree.leaf_paths(first)
    assert sorted(got) == sorted(want)
    for k in want:
        bound = GRAD_OF_MAX * max(float(want[k].abs().max()), 1e-30)
        err = float((got[k] - want[k].float()).abs().max())
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("arch,rules", CASES)
def test_train_steps_match_the_unsharded_steps(worlds, arch, rules):
    """Each step's loss and grad norm; the second step reads the params the
    first step's sharded AdamW update wrote."""
    results, refs, _ = worlds
    r = results[f"{arch}/{rules}"]
    per_step = refs[arch][0]
    assert len(r["steps"]) == RULES[rules][1]
    for got, (loss, gnorm) in zip(r["steps"], per_step):
        assert _rel(got["loss"], loss) <= LOSS_REL, (got["loss"], loss)
        assert _rel(got["grad_norm"], gnorm) <= LOSS_REL, (got["grad_norm"], gnorm)


def test_trainer_on_a_mesh_matches_the_unsharded_steps(worlds):
    results, refs, _ = worlds
    losses = results["trainer"]["losses"]
    assert len(losses) == 2
    for got, (want, _) in zip(losses, refs["trainer"]):
        assert _rel(got, want) <= LOSS_REL, (losses, refs["trainer"])


def test_elastic_restore_onto_another_mesh_is_bit_exact(worlds):
    """Saved on (2, 4) by the trainer, restored onto (4, 2): every leaf
    bit-equal, each a DTensor of the new mesh."""
    results, _, _ = worlds
    t = results["trainer"]
    assert t["restored_step"] == 2 and t["bit_equal"]
    assert t["mesh_shapes"] == [(4, 2)] and t["n_dtensor_leaves"] > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b"])
def test_one_by_one_mesh_step_is_bitwise_the_step_without_a_mesh(worlds, arch):
    _, _, one = worlds
    plain, mesh = one[arch]
    assert torch.equal(plain["loss"], mesh["loss"])
    for k in plain["metrics"]:
        assert torch.equal(plain["metrics"][k], mesh["metrics"][k]), k
    for name in ("grads", "params"):
        a, b = tree.leaf_paths(plain[name]), tree.leaf_paths(mesh[name])
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)
    for sa, sb in zip(plain["steps"], mesh["steps"]):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
