"""Worlds of gloo ranks on the CPU, and the jobs the port's sharding tests
run in them (tests/test_torch_sharded_moe.py, test_torch_sharded_train.py).

``run_world(job, n_ranks, workdir)`` (or ``World``, which returns at once)
spawns ``n_ranks`` processes (the ``spawn`` start method) that join one gloo
process group initialised from a file in ``workdir``, so that tests running
in parallel never race for a port, and each runs ``job(rank, workdir)``. Jobs read their inputs from
``workdir/inputs.pt`` and rank 0 writes its results to
``workdir/results.pt``. This module imports torch and the port, never JAX,
so that each rank starts quickly: the tests compute the JAX references in
their own process and pass every array as a tensor.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time
import traceback
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree
from repro_torch.convert import experts_whole
from repro_torch.launch.mesh import make_auto_mesh, make_smoke_mesh
from repro_torch.models import moe
from repro_torch.models.layers import layer_of
from repro_torch.optim import adamw
from repro_torch.parallel import axes
from repro_torch.parallel.axes import AxisRules, single_pod_rules
from repro_torch.parallel.specs import (batch_rows, expert_blocks, make_param_specs,
                                        make_shardings, place_tree)
from repro_torch.runtime import steps
from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime

CPU = torch.device("cpu")
# the rules of the JAX package's distributed MoE test (tests/test_moe_distributed.py)
MOE_TEST_RULES = AxisRules(rules={"batch": ("data",), "fsdp": ("data",),
                                  "experts": "model", "ffn": "model"})


class World:
    """``n_ranks`` processes (the ``spawn`` start method) running ``job`` in
    one gloo world; ``result`` waits for them and returns rank 0's results.
    A rank that raises fails the world with its traceback."""

    def __init__(self, job: Callable[[int, str], None], n_ranks: int, workdir,
                 timeout_s: float = 300.0):
        self.workdir, self.n_ranks = str(workdir), n_ranks
        self.deadline = time.monotonic() + timeout_s
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(job, rank, n_ranks, self.workdir),
                                  daemon=True) for rank in range(n_ranks)]
        for p in self.procs:
            p.start()

    def result(self) -> Dict[str, Any]:
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        errors = []
        for rank in range(self.n_ranks):
            path = os.path.join(self.workdir, f"error.{rank}")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {rank}:\n{f.read()}")
        codes = [p.exitcode for p in self.procs]
        if errors or alive or any(c != 0 for c in codes):
            raise RuntimeError(f"world of {self.n_ranks} failed (exit codes {codes}, "
                               f"timed out: {bool(alive)})\n" + "\n".join(errors))
        return torch.load(os.path.join(self.workdir, "results.pt"), weights_only=False)


def run_world(job: Callable[[int, str], None], n_ranks: int, workdir,
              timeout_s: float = 300.0) -> Dict[str, Any]:
    """Run ``job`` on ``n_ranks`` gloo ranks; returns rank 0's results."""
    return World(job, n_ranks, workdir, timeout_s).result()


def _entry(job, rank: int, n_ranks: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/world", rank=rank,
                            world_size=n_ranks, timeout=datetime.timedelta(seconds=120))
    try:
        job(rank, workdir)
    except BaseException:
        with open(os.path.join(workdir, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _inputs(workdir: str) -> Dict[str, Any]:
    return torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)


def _save(rank: int, workdir: str, results: Dict[str, Any]) -> None:
    if rank == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))


def placed(params, cfg, rules, mesh):
    """A copy of whole params laid out on ``mesh`` as the trainer lays them
    out."""
    blocked = expert_blocks(tree.tree_map(torch.clone, params), mesh)
    return place_tree(blocked, make_shardings(make_param_specs(blocked, rules, mesh), mesh))


def whole_tree(t):
    """A tree of DTensors (any placements) as whole tensors in the port's
    whole expert layout: a collective."""
    def full(x):
        if isinstance(x, torch.distributed.tensor.DTensor):
            return x.full_tensor()
        return x
    return experts_whole(tree.tree_map(full, t))


def _rows(x, n, i):
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _gather_rows(x, mesh):
    """A rank's batch rows gathered from every batch block, in block order."""
    n = axes.batch_shards()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    by_block = {}
    for r, part in enumerate(parts):
        by_block.setdefault(_block_of(mesh, r), part)
    return torch.cat([by_block[i] for i in range(n)])


def _block_of(mesh, rank: int) -> int:
    coord = (mesh.mesh == rank).nonzero()[0].tolist()
    i = 0
    for a in axes.batch_axes():
        d = mesh.mesh_dim_names.index(a)
        i = i * mesh.mesh.shape[d] + coord[d]
    return i


# -- the MoE job ---------------------------------------------------------------------

def moe_job(rank: int, workdir: str) -> None:
    """Each case: one MoE layer (stacked over one unit, so that the param
    paths and ranks are the model's) placed on its mesh under its rules;
    ``apply_moe`` on this rank's rows in the case's mode; the objective
    sum(y·dy) + aux (this rank's share: its rows, and aux over the ranks
    that split the batch); outputs, aux, the kept assignments per rank and
    whole gradients."""
    inp = _inputs(workdir)
    results = {}
    for name, case in inp["cases"].items():
        cfg = case["cfg"]
        mesh = make_auto_mesh(case["mesh"], ("data", "model"), "cpu")
        rules = case["rules"]
        params = {"moe": tree.tree_map(lambda t: t[None], case["params"])}
        with axes.axis_rules(rules, mesh):
            p = placed(params, cfg, rules, mesh)
            for leaf in tree.leaf_paths(p).values():
                leaf.requires_grad_(True)
            n, i = axes.batch_shards(), axes.batch_index()
            x = _rows(case["x"], n, i).clone().requires_grad_(True)
            kept = []
            real = moe.dispatch_indices

            def counting(idx, n_experts, cap):
                out = real(idx, n_experts, cap)
                kept.append(out)
                return out
            moe.dispatch_indices = counting
            try:
                y, aux = moe.apply_moe(cfg, layer_of(p["moe"], 0), x,
                                       force_gather=case["gather"])
            finally:
                moe.dispatch_indices = real
            share = (y * _rows(case["dy"], n, i)).sum() + aux / n
            leaves = tree.leaf_paths(p)
            grads = torch.autograd.grad(share, [x] + list(leaves.values()))
            gx = _gather_rows(grads[0], mesh)
            gp = {k: steps._laid_out_as(g, leaves[k]) for k, g in zip(leaves, grads[1:])}
            gp = whole_tree(tree.unflatten_like(p, gp))
            y_all = _gather_rows(y.detach(), mesh)
            # the pool's kept assignments, over all experts (each model rank
            # routes its pool alike), gathered from every rank
            mine = (kept[0] >= 0).sum().reshape(1)
            kept_all = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
            dist.all_gather(kept_all, mine)
        results[name] = {"y": y_all, "aux": aux.detach(), "dx": gx,
                         "grads": tree.tree_map(lambda t: t[0], gp["moe"]),
                         "kept": torch.cat(kept_all)}
    _save(rank, workdir, results)


# -- the train jobs -------------------------------------------------------------------

def _step_metrics(m) -> Dict[str, float]:
    return {k: float(v) for k, v in m.items()}


def mesh_axes(shape) -> tuple:
    """The production mesh's axis names for a mesh of two or three dims."""
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def train_job(rank: int, workdir: str) -> None:
    """Each case: whole params placed on its mesh (two dims: data, model;
    three: pod, data, model) under its rules, then a
    train step on each of the case's batches, each rank on its rows: the
    metrics of each and the first step's whole gradients. Then
    the trainer on a (2, 4) mesh saving a checkpoint every step, and the
    elastic restore of its last checkpoint onto a (4, 2) mesh."""
    inp = _inputs(workdir)
    results: Dict[str, Any] = {}
    for name, case in inp["cases"].items():
        cfg, opt = case["cfg"], case["opt"]
        mesh = make_auto_mesh(case["mesh"], mesh_axes(case["mesh"]), "cpu")
        with axes.axis_rules(case["rules"], mesh):
            params = placed(case["params"], cfg, case["rules"], mesh)
            state = adamw.init(opt, params)
            n, i = axes.batch_shards(), axes.batch_index()
            out = {"steps": []}
            for b in case["batches"]:  # make_train_step's two halves, to keep the gradients
                _, metrics, grads = steps.loss_and_grads(cfg, params, batch_rows(b, n, i))
                params, state, om = adamw.apply_updates(opt, params, grads, state)
                out["steps"].append(_step_metrics({**metrics, **om}))
                if "grads" not in out:
                    out["grads"] = whole_tree(grads)
                    out["grads_laid_out"] = _laid_out_like(grads, params)
        results[name] = out
    if "trainer" in inp:
        results["trainer"] = _trainer_and_restore(inp["trainer"], workdir)
    _save(rank, workdir, results)


def _laid_out_like(grads, params) -> bool:
    """Every gradient a DTensor on its param's mesh with its param's
    placements (``steps._laid_out_as``)."""
    g, p = tree.leaf_paths(grads), tree.leaf_paths(params)
    return sorted(g) == sorted(p) and all(
        isinstance(g[k], torch.distributed.tensor.DTensor)
        and g[k].device_mesh == p[k].device_mesh
        and tuple(g[k].placements) == tuple(p[k].placements) for k in p)


def _trainer_and_restore(case, workdir):
    ckpt = os.path.join(workdir, "ckpt")
    meshes = [make_auto_mesh(shape, ("data", "model"), "cpu") for shape in ((2, 4), (4, 2))]
    runs = []
    for mesh in meshes:
        tcfg = TrainerConfig(steps=case["steps"], ckpt_every=1, ckpt_dir=ckpt, feed="kernel",
                             log_every=1, seed=case["seed"])
        runs.append(TrainerRuntime(case["cfg"], case["dcfg"], tcfg, case["opt"], device=CPU,
                                   mesh=mesh, rules=case["rules"]))
    trained = runs[0].run()
    with axes.axis_rules(case["rules"], meshes[0]):
        saved = whole_tree({"params": trained.params, "opt": trained.opt_state})
    restored = runs[1].maybe_restore(runs[1].init_state())
    leaves = [t for t in tree.leaf_paths({"p": restored.params, "o": restored.opt_state}).values()
              if isinstance(t, torch.distributed.tensor.DTensor)]
    got = whole_tree({"params": restored.params, "opt": restored.opt_state})
    a, b = tree.leaf_paths(saved), tree.leaf_paths(got)
    return {"losses": [m["loss"] for m in runs[0].metrics_log],
            "restored_step": restored.step,
            "bit_equal": sorted(a) == sorted(b) and all(
                a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a),
            "mesh_shapes": sorted({tuple(t.device_mesh.shape) for t in leaves}),
            "n_dtensor_leaves": len(leaves)}


def vocab_job(rank: int, workdir: str) -> None:
    """Each case: an embedding tree placed on a (2, 4) mesh under the
    single-pod rules, and on this rank's rows the embedding of ``tokens``,
    the logits of ``h_last`` (B, D) and the chunked cross-entropy of ``h``
    (B, S, D) against ``labels``; then the gradients of sum(emb·dy) plus the
    token-loss sum of the rank's rows. Returns the outputs and the gradients
    of the hidden states (the ranks' rows gathered) and of the tables
    (whole), and the vocab rows of this rank's unembedding."""
    from repro_torch.models import layers
    inp = _inputs(workdir)
    results = {}
    for name, case in inp["cases"].items():
        cfg = case["cfg"]
        mesh = make_auto_mesh((2, 4), ("data", "model"), "cpu")
        rules = single_pod_rules()
        with axes.axis_rules(rules, mesh):
            p = placed({"embed": case["embed"]}, cfg, rules, mesh)["embed"]
            leaves = tree.leaf_paths(p)
            for t in leaves.values():
                t.requires_grad_(True)
            n, i = axes.batch_shards(), axes.batch_index()
            h = _rows(case["h"], n, i).clone().requires_grad_(True)
            h_last = _rows(case["h_last"], n, i).clone().requires_grad_(True)
            emb = layers.embed_tokens(cfg, p, _rows(case["tokens"], n, i))
            logits = layers.logits_for(cfg, p, h_last)
            loss_sum, n_valid = layers.chunked_softmax_xent(
                cfg, p, h, _rows(case["labels"], n, i), s_chunk=case["s_chunk"])
            share = ((emb * _rows(case["dy"], n, i)).sum() + loss_sum
                     + (logits * _rows(case["dlogits"], n, i)).sum())
            grads = torch.autograd.grad(share, [h, h_last] + list(leaves.values()))
            gp = {k: steps._laid_out_as(g, leaves[k]) for k, g in zip(leaves, grads[2:])}
            results[name] = {
                "emb": _gather_rows(emb.detach(), mesh),
                "logits": _gather_rows(logits.detach(), mesh),
                "argmax": _gather_rows(torch.argmax(logits, -1), mesh),
                "loss_sum": axes.sum_over(loss_sum.detach(), axes.batch_axes()),
                "n_valid": axes.sum_over(n_valid, axes.batch_axes()),
                "dh": _gather_rows(grads[0], mesh), "dh_last": _gather_rows(grads[1], mesh),
                "grads": whole_tree(tree.unflatten_like(p, gp)),
                "local_rows": layers.unembed_matrix(cfg, p).shape[0]}
    _save(rank, workdir, results)


def one_rank_job(rank: int, workdir: str) -> None:
    """Each case without a mesh, then on a (1, 1) mesh under the single-pod
    rules: the first batch's loss, metrics and gradients, then the train
    steps' metrics and the params they leave."""
    inp = _inputs(workdir)
    mesh = make_smoke_mesh(1, device_type="cpu")
    results = {}
    for name, case in inp["cases"].items():
        cfg, opt = case["cfg"], case["opt"]
        runs = []
        for rules in (None, single_pod_rules()):
            with axes.axis_rules(rules, mesh) if rules else contextlib.nullcontext():
                params = tree.tree_map(torch.clone, case["params"])
                if rules:
                    params = placed(params, cfg, rules, mesh)
                state = adamw.init(opt, params)
                loss, metrics, grads = steps.loss_and_grads(cfg, params, case["batches"][0])
                step = steps.make_train_step(cfg, opt)
                ms = []
                for b in case["batches"]:
                    params, state, m = step(params, state, b)
                    ms.append({k: v.clone() for k, v in m.items()})
                runs.append({"loss": loss, "metrics": metrics, "grads": whole_tree(grads),
                             "steps": ms, "params": whole_tree(params)})
        results[name] = runs
    _save(rank, workdir, results)


def rglru_block_job(rank: int, workdir: str) -> None:
    """Each case: one RG-LRU block placed on a (1, m) mesh under its rules
    (``{"rglru": params}``, the model's param paths), on the whole batch:
    the block's output and the gradients of sum(y·dy) (x's and every
    param's, whole), then one decode step from the states the prefill leaves
    (``_rglru_mix``'s last state and conv input), its output and the new
    states, whole (each part from the model rank that holds it), and this
    rank's width share and state shapes."""
    from repro_torch.models import rglru
    from repro_torch.parallel.specs import cache_share
    from torch_serve_worlds import _whole_of_shares
    inp = _inputs(workdir)
    results = {}
    for name, case in inp["cases"].items():
        cfg, rules = case["cfg"], case["rules"]
        mesh = make_auto_mesh(case["mesh"], ("data", "model"), "cpu")
        K = cfg.conv_width
        with axes.axis_rules(rules, mesh):
            p = placed({"rglru": case["params"]}, cfg, rules, mesh)
            leaves = tree.leaf_paths(p)
            for t in leaves.values():
                t.requires_grad_(True)
            x = case["x"].clone().requires_grad_(True)
            y, h_last, xb = rglru._rglru_mix(cfg, p["rglru"], x)
            grads = torch.autograd.grad((y * case["dy"]).sum(), [x] + list(leaves.values()))
            gp = {k: steps._laid_out_as(g, leaves[k]) for k, g in zip(leaves, grads[1:])}
            with torch.no_grad():
                state = {"h": h_last.detach().float(), "conv": xb[:, -(K - 1):].detach().float()}
                out, new = rglru.rglru_block_decode(cfg, p["rglru"], case["x_t"], state)

            def whole(t, leaf):
                share = cache_share(cfg, leaf)
                return t if share is None else _whole_of_shares(t, *share)
            results[name] = {
                "y": y.detach(), "dx": grads[0],
                "grads": whole_tree(tree.unflatten_like(p, gp))["rglru"],
                "state": {k: whole(v, k) for k, v in state.items()},
                "decode": {"out": out, "h": whole(new["h"], "h"),
                           "conv": whole(new["conv"], "conv")},
                "share": rglru.width_share(cfg),
                "state_shapes": {k: tuple(v.shape) for k, v in new.items()}}
    _save(rank, workdir, results)
