"""The port's prefill and decode on a mesh, and a batch whose rows do not
split over the data-parallel ranks, on gloo ranks on the CPU.

One world of 8 ranks (``torch_serve_worlds.serve_job``) runs, for
qwen3-1.7b's and mixtral-8x7b's smoke configs in f32 (mixtral at capacity
factor 8.0, so that no routing pool drops an assignment), on a (2, 4) mesh
under ``single_pod_rules``:

* a batch of 4 prompts (two rows a data block), prefill and 4 decode steps
  fed the same tokens as the reference (teacher forcing, so that a near tie
  cannot fork the runs), every rank on its rows, params DTensors gathered
  where they are read, MoE layers on the sharded path;
* a batch of 1 prompt, which does not split over the 2 data blocks: every
  rank holds and runs it whole (``specs.batch_rules``, ``batch_rows``).

Mixtral's prompt (40 tokens) passes its smoke window of 32, so prefill
rotates the ring cache and each decode step overwrites a slot. Every step's
logits and the final cache (the ranks' rows gathered) are held to the
port's unsharded run, which the other test_torch_* files hold to the JAX
package, within 1e-4 of each tensor's largest magnitude (the gradient bound
of tests/test_torch_sharded_train.py).

A second world of 8 ranks (``replicated_train_job``) takes one train step's
loss and gradients on a batch of 1 under ``single_pod_rules`` (2 data
blocks) and on a batch of 6 under ``pure_fsdp_rules`` (8 ranks split the
batch): neither splits, so the batch is replicated, the loss counts it
once and the gradients are not summed over the ranks; held to the
unsharded step within 1e-5 relative on the loss and 1e-4 of each leaf's
largest gradient, the bounds of tests/test_torch_sharded_train.py.

A world of one rank holds a (1, 1) mesh's prefill and greedy decode
bitwise to the run without a mesh (bf16, the configs' own dtype), as
tests/test_torch_sharded_train.py holds its train step.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.models import lm
from repro_torch.models.registry import get_smoke_config
from repro_torch.parallel.axes import pure_fsdp_rules, single_pod_rules
from repro_torch.parallel.specs import batch_rows, batch_rules
from repro_torch.runtime import steps
from torch_mesh_worlds import World
from torch_serve_worlds import one_rank_serve_job, replicated_train_job, serve, serve_job

LOSS_REL, OF_MAX = 1e-5, 1e-4
ARCHS = ["qwen3-1.7b", "mixtral-8x7b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
PROMPT = {"qwen3-1.7b": 12, "mixtral-8x7b": 40}  # mixtral: past its smoke window of 32
GEN = 4
SERVE_CASES = [(a, b) for a in ARCHS for b in (4, 1)]
TRAIN_CASES = [(a, r, b) for a in ARCHS for r, b in (("single", 1), ("fsdp", 6))]
RULES = {"single": single_pod_rules(), "fsdp": pure_fsdp_rules()}


def _config(arch, f32=True):
    cfg = get_smoke_config(arch)
    if f32:
        cfg = cfg.replace(**F32)
    return cfg.replace(capacity_factor=8.0) if cfg.n_experts else cfg


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    serve_cases, train_cases, one_cases, refs = {}, {}, {}, {}
    for arch in ARCHS:
        cfg = _config(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        for b in (4, 1):
            prompt = {"tokens": _tokens(cfg, (b, PROMPT[arch]), 1 + b)}
            fed = _tokens(cfg, (b, GEN), 2 + b)
            serve_cases[f"{arch}/{b}"] = dict(cfg=cfg, params=params, prompt=prompt,
                                              tokens=fed, mesh=(2, 4), rules=RULES["single"],
                                              max_len=PROMPT[arch] + GEN)
        for rules, b in (("single", 1), ("fsdp", 6)):
            toks = _tokens(cfg, (b, 17), 7 + b)
            batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
            train_cases[f"{arch}/{rules}/{b}"] = dict(cfg=cfg, params=params, batch=batch,
                                                      mesh=(2, 4), rules=RULES[rules])
        bf16 = _config(arch, f32=False)
        one_cases[arch] = dict(cfg=bf16, params=lm.init_params(bf16, torch.Generator()
                                                                .manual_seed(1), "cpu"),
                               prompt={"tokens": _tokens(bf16, (2, PROMPT[arch]), 5)},
                               max_len=PROMPT[arch] + GEN)
    started = []
    for job, cases, n in ((serve_job, serve_cases, 8), (replicated_train_job, train_cases, 8),
                          (one_rank_serve_job, one_cases, 1)):
        d = tmp_path_factory.mktemp(job.__name__)
        torch.save({"cases": cases}, d / "inputs.pt")
        started.append(World(job, n, d))  # runs while the references are computed
    for name, c in serve_cases.items():
        logits, _, cache = serve(c["cfg"], c["params"], c["prompt"], c["max_len"], c["tokens"])
        refs[name] = {"logits": logits, "cache": tree.leaf_paths(cache)}
    for name, c in train_cases.items():
        loss, metrics, grads = steps.loss_and_grads(c["cfg"], c["params"], c["batch"])
        refs[name] = {"loss": loss, "metrics": metrics, "grads": tree.leaf_paths(grads)}
    return [w.result() for w in started], refs


def _close(got, want, what):
    bound = OF_MAX * max(float(want.abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("arch,batch", SERVE_CASES)
def test_prefill_and_decode_on_a_mesh_match_the_unsharded_run(worlds, arch, batch):
    (served, _, _), refs = worlds
    got, want = served[f"{arch}/{batch}"], refs[f"{arch}/{batch}"]
    assert got["replicated"] == (batch == 1) and got["shards"] == (1 if batch == 1 else 2)
    assert len(got["logits"]) == len(want["logits"]) == GEN + 1
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert g.shape == w.shape
        _close(g, w, f"logits of step {i}")
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, w in want["cache"].items():
        assert got["cache"][k].shape == w.shape, k
        _close(got["cache"][k], w, k)


@pytest.mark.parametrize("arch,rules,batch", TRAIN_CASES)
def test_a_batch_that_does_not_split_is_replicated(worlds, arch, rules, batch):
    (_, trained, _), refs = worlds
    got, want = trained[f"{arch}/{rules}/{batch}"], refs[f"{arch}/{rules}/{batch}"]
    assert got["replicated"] and got["shards"] == 1 and got["rows"] == batch
    assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_REL * abs(float(want["loss"]))
    for k in ("loss", "xent", "tokens"):
        assert abs(float(got["metrics"][k]) - float(want["metrics"][k])) <= \
            LOSS_REL * abs(float(want["metrics"][k])), k
    g = tree.leaf_paths(got["grads"])
    assert sorted(g) == sorted(want["grads"])
    for k, w in want["grads"].items():
        _close(g[k], w, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_serving_is_bitwise_the_run_without_a_mesh(worlds, arch):
    (_, _, one), _ = worlds
    plain, mesh = one[arch]
    for a, b in zip(plain["logits"], mesh["logits"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(plain["tokens"], mesh["tokens"]):
        assert torch.equal(a, b)
    assert sorted(plain["cache"]) == sorted(mesh["cache"])
    for k in plain["cache"]:
        assert torch.equal(plain["cache"][k], mesh["cache"][k]), k


def test_batch_rules_replicate_only_a_batch_that_does_not_split():
    class Mesh:
        shape = {"data": 2, "model": 4}
    single, fsdp = single_pod_rules(), pure_fsdp_rules()
    assert batch_rules(single, Mesh(), 4) is single
    assert batch_rules(single, Mesh(), 1).resolve("batch") is None
    assert batch_rules(fsdp, Mesh(), 8) is fsdp
    assert batch_rules(fsdp, Mesh(), 6).resolve("batch") is None
    assert batch_rules(single, None, 3) is single
    b = {"tokens": torch.arange(12).reshape(6, 2)}
    assert torch.equal(batch_rows(b, 3, 1)["tokens"], b["tokens"][2:4])
    assert torch.equal(batch_rows(b, 4, 1)["tokens"], b["tokens"])  # replicated
