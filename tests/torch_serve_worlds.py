"""Jobs for gloo worlds of the port's serving and replicated-batch tests
(tests/test_torch_sharded_serve.py), run by ``torch_mesh_worlds.World``.

Each job reads its cases from ``workdir/inputs.pt``; rank 0 writes the
results to ``workdir/results.pt``. Like torch_mesh_worlds, this module
imports torch and the port, never JAX.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.launch.mesh import make_auto_mesh, make_smoke_mesh
from repro_torch.models.transformer import cache_size_for
from repro_torch.parallel import axes
from repro_torch.parallel.axes import single_pod_rules
from repro_torch.parallel.specs import _cache_axes, batch_rows, batch_rules, cache_share
from repro_torch.runtime import steps
from torch_mesh_worlds import _gather_rows, _inputs, _save, placed, whole_tree


def serve(cfg, params, prompt, max_len: int, tokens=None, gen: int = 4):
    """Prefill ``prompt``, then ``gen`` decode steps: on ``tokens`` (B, gen)
    where given (teacher forcing), else greedy. Returns (the logits of
    prefill and of each decode step, the tokens fed, the cache)."""
    logits, cache = steps.make_prefill_step(cfg, max_len)(params, prompt)
    decode = steps.make_decode_step(cfg, max_len)
    B, S = prompt["tokens"].shape
    pos = torch.full((B,), S, dtype=torch.int32)
    out, fed = [logits], []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for t in range(gen):
        if tokens is not None:
            tok = tokens[:, t]
        fed.append(tok)
        tok, logits, cache = decode(params, cache, tok, pos)
        out.append(logits)
        pos = pos + 1
    return out, fed, cache


def _gather_cache(cfg, cache: Any, mesh, max_len: int) -> Dict[str, torch.Tensor]:
    """Every rank's batch rows of every cache leaf, in block order, and of a
    leaf that holds a rank's share under tensor parallelism (a KV cache's
    slots or kv heads, a recurrent state's heads or width:
    ``specs.cache_share``) the whole, each part from a model rank that holds
    it."""
    out = {}
    n_slots = cache_size_for(cfg, max_len)
    for path, leaf in tree.leaf_paths(cache).items():
        dim = _cache_axes(path, leaf.dim()).index("batch")
        share = cache_share(cfg, path, n_slots)
        if share is not None:
            leaf = _whole_of_shares(leaf, *share)
        out[path] = _gather_rows(leaf.movedim(dim, 0), mesh).movedim(0, dim)
    return out


def _whole_of_shares(leaf: torch.Tensor, dim: int, spans) -> torch.Tensor:
    """A cache leaf of this rank's share, which holds ``spans`` of the whole
    dim ``dim`` in order, as the whole: the shares of the ranks of this
    rank's model group, gathered (where two ranks hold a span, as B and C of
    mamba2's conv state, the later rank's is kept)."""
    group = axes._model_group()
    m = dist.get_world_size(group)
    parts = [torch.empty_like(leaf) for _ in range(m)]
    dist.all_gather(parts, leaf.contiguous(), group=group)
    mine = torch.tensor(spans, dtype=torch.int64)
    all_spans = [torch.empty_like(mine) for _ in range(m)]
    dist.all_gather(all_spans, mine, group=group)
    shape = list(leaf.shape)
    shape[dim] = max(int(s[:, 1].max()) for s in all_spans)
    whole = leaf.new_zeros(shape)
    for part, sp in zip(parts, all_spans):
        at = 0
        for lo, hi in sp.tolist():
            whole.narrow(dim, lo, hi - lo).copy_(part.narrow(dim, at, hi - lo))
            at += hi - lo
    return whole


def serve_job(rank: int, workdir: str) -> None:
    """Each case: whole params placed on a (2, 4) mesh under its rules (the
    batch replicated where its rows do not split), prefill and decode on this
    rank's rows, teacher-forced where the case gives tokens, else greedy;
    every step's logits, the tokens fed and the final cache, gathered, the
    kv heads of this rank's cache and the shape of each of its leaves."""
    inp = _inputs(workdir)
    results = {}
    for name, case in inp["cases"].items():
        cfg = case["cfg"]
        mesh = make_auto_mesh(case["mesh"], ("data", "model"), "cpu")
        n_rows = next(iter(case["prompt"].values())).shape[0]
        rules = batch_rules(case["rules"], mesh, n_rows)
        with axes.axis_rules(rules, mesh):
            params = placed(case["params"], cfg, rules, mesh)
            n, i = axes.batch_shards(), axes.batch_index()
            tokens = (None if case["tokens"] is None  # greedy
                      else batch_rows({"t": case["tokens"]}, n, i)["t"])
            logits, fed, cache = serve(cfg, params, batch_rows(case["prompt"], n, i),
                                       case["max_len"], tokens)
            leaves = tree.leaf_paths(cache)
            kv = [t for k, t in leaves.items() if k.split("/")[-1] == "k"]
            results[name] = {"logits": [_gather_rows(x, mesh) for x in logits],
                             "tokens": [_gather_rows(t, mesh) for t in fed],
                             "local_kv_heads": kv[0].shape[-2] if kv else None,
                             "local_shapes": {k: tuple(t.shape) for k, t in leaves.items()},
                             "cache": _gather_cache(cfg, cache, mesh, case["max_len"]),
                             "replicated": rules is not case["rules"], "shards": n}
    _save(rank, workdir, results)


def replicated_train_job(rank: int, workdir: str) -> None:
    """Each case: whole params placed on a (2, 4) mesh under its rules, and
    the loss, metrics and whole gradients of one batch whose rows do not
    split over the data-parallel ranks, so every rank runs all of them."""
    inp = _inputs(workdir)
    results = {}
    for name, case in inp["cases"].items():
        cfg = case["cfg"]
        mesh = make_auto_mesh(case["mesh"], ("data", "model"), "cpu")
        n_rows = case["batch"]["tokens"].shape[0]
        rules = batch_rules(case["rules"], mesh, n_rows)
        with axes.axis_rules(rules, mesh):
            params = placed(case["params"], cfg, rules, mesh)
            n, i = axes.batch_shards(), axes.batch_index()
            rows = batch_rows(case["batch"], n, i)
            loss, metrics, grads = steps.loss_and_grads(cfg, params, rows)
            results[name] = {"loss": loss, "metrics": metrics, "grads": whole_tree(grads),
                             "replicated": rules is not case["rules"], "shards": n,
                             "rows": rows["tokens"].shape[0], "world": dist.get_world_size()}
    _save(rank, workdir, results)


def one_rank_serve_job(rank: int, workdir: str) -> None:
    """Each case without a mesh, then on a (1, 1) mesh under the single-pod
    rules: prefill and greedy decode, every step's logits, the tokens and the
    cache."""
    inp = _inputs(workdir)
    mesh = make_smoke_mesh(1, device_type="cpu")
    results = {}
    for name, case in inp["cases"].items():
        cfg = case["cfg"]
        runs = []
        for rules in (None, single_pod_rules()):
            with axes.axis_rules(rules, mesh) if rules else contextlib.nullcontext():
                params = tree.tree_map(torch.clone, case["params"])
                if rules:
                    params = placed(params, cfg, rules, mesh)
                logits, fed, cache = serve(cfg, params, case["prompt"], case["max_len"])
                runs.append({"logits": logits, "tokens": fed,
                             "cache": tree.leaf_paths(cache)})
        results[name] = runs
    _save(rank, workdir, results)
