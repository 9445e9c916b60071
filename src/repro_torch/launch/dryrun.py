"""Multi-pod dry run: trace every (architecture × shape) cell's step on the
production meshes, on fake tensors in a fake world, and count what it costs
(port of ``src/repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun.jsonl

Where the JAX package lowers and compiles each cell on 512 host devices, the
port runs each cell's step eagerly as rank 0 of a world of 256 (16 × 16) or
512 (2 × 16 × 16) ranks over the ``"fake"`` process-group backend: every
collective returns at once, every tensor is a fake CUDA tensor
(``FakeTensorMode``: shapes, dtypes and devices, no memory), and the kernel
ops (``torch.library`` ops, ``repro_torch::*``) run their fake
implementations. ``parallel/op_counter.OpCounter`` counts the step, and
``parallel/analysis.Roofline`` turns the counts into the roofline terms of
an H100. Each record carries the JAX package's keys: ``memory``
(``argument_size_in_bytes``: this rank's params, optimizer state and inputs;
``output_size_in_bytes``; ``temp_size_in_bytes``: the peak of what the step
made, above the arguments), ``collective_counts``, ``collective_op_bytes``,
``collective_wire_bytes`` and ``roofline``; ``trace_s`` in place of
``lower_s`` and ``compile_s``; ``cache_layout`` on decode cells;
``flop_counter`` (``FlopCounterMode``'s total with the kernel ops' formulas,
which equals the counter's dot FLOP).

Layouts are the JAX package's choices: decode cells and cells whose global
batch does not split over every rank take "tp", the rest the arch's own;
``--layout`` overrides (the JAX package's ``REPRO_FORCE_LAYOUT``). A batch
that does not split over the data-parallel ranks (long_500k's batch of 1) is
replicated (``specs.batch_rules``). Under "tp" (``single_pod_rules``,
``multi_pod_rules``) the dense layers run tensor-parallel over ``model``
(``models/layers.py``): a record counts what one rank dispatches, its
heads, ``d_ff / m`` and ``vocab / m`` of the split products (where the
model axis divides them), the k and v projections at the kv heads its q
heads read, and the all-reduces and all-gathers over ``model`` that join
them, with their bytes and groups; so do the recurrent blocks: mamba2's
SSD blocks at H/m heads (``in_proj``'s z, x and dt columns over m, its B
and C columns on every rank) and the RG-LRU blocks at W/m columns (where
its gate blocks straddle ranks, m > 8, ``w_x`` and the conv over the
rank's whole block). A decode cell's KV caches take the JAX package's
``kv_seq`` layout where the model axis divides their slots: each rank holds
its rows' C/m slots of every kv head, attends all q heads over them and
merges the ranks' partials over ``model`` (one all-gather of q and one
all-to-all of the partials a layer where the heads split, one all-gather of
the partials where they do not); a prefill hands each rank its slots (one
all-to-all a layer where the kv heads split). Its recurrent states are the
rank's share (``cache_layout``).

Importing this module sets no environment variable and starts no process
group: ``run_cell`` makes the world and destroys it. The autograd engine of a
CPU-only PyTorch build has no CUDA device guard, so under the dry run's mode
the C++ side of a fake tensor reads its device as "meta", where its data
lives; its Python ``.device`` stays "cuda", which routes it to the kernels.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.launch.inputs import step_specs
from repro_torch.launch.mesh import make_auto_mesh, make_production_mesh, rules_for
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (ARCHS, SHAPES, STEP_KIND, all_cells, cell_status,
                                         get_config, get_smoke_config)
from repro_torch.models.transformer import cache_size_for
from repro_torch.optim import adamw
from repro_torch.parallel import analysis, axes
from repro_torch.parallel.op_counter import OpCounter, fresh_storages
from repro_torch.parallel.specs import (batch_rules, expert_blocks, make_param_specs,
                                        make_shardings, place_tree)
from repro_torch.runtime.steps import make_decode_step, make_prefill_step, make_train_step

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
CACHE_LAYOUT = ("kv_seq: each rank holds its own batch rows' k and v caches at C/m of "
                "the slots, [r C/m, (r+1) C/m) of model rank r, of every kv head, as the "
                "JAX package splits the cache's sequence over 'model'; decode attends "
                "every q head over the rank's slots and merges the ranks' partial outputs "
                "by their logsumexps over 'model', in rank order")
CACHE_WHOLE = ("rows whole: each rank holds its own batch rows' caches over every slot "
               "(the model axis does not divide the cache's slots), of the kv heads its "
               "q heads read under tensor parallelism")
SSM_STATE_LAYOUT = ("mamba2: ssm (L, B, H/m, P, N), the rank's heads, split over 'model' as "
                    "the JAX package's ssm_heads; conv (L, B, K-1, d_inner/m + 2N), the "
                    "rank's heads' x columns and B and C whole, where the JAX package "
                    "splits conv_dim in contiguous blocks over 'model' (ffn)")
LRU_STATE_LAYOUT = ("RG-LRU: h (..., B, W/m), the rank's columns, split over 'model' as the "
                    "JAX package's ffn; conv (..., B, K-1, W/m) the same, but where the gate "
                    "blocks straddle ranks (m > 8) the rank's whole block of W/8 columns, "
                    "whose conv it computes")


def cache_layout(cfg: ModelConfig, split_slots: bool = True) -> str:
    """A decode record's ``cache_layout``: the port's KV-cache layout
    (``split_slots``: whether the model axis divides the cache's slots) and,
    for the recurrent families, their states'."""
    kv = CACHE_LAYOUT if split_slots else CACHE_WHOLE
    if cfg.family == "ssm":
        return SSM_STATE_LAYOUT
    if cfg.family == "hybrid":
        return f"{kv}. {LRU_STATE_LAYOUT}"
    return kv


class CudaOnMeta(TorchDispatchMode):
    """Under ``FakeTensorMode``: the C++ device query of a fake tensor reads
    "meta" (see the module's note), and a tensor that C++ makes on the device
    it read (a wrapped scalar, a backward formula's zeros) is made on the
    fake tensors' CUDA device."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first, into ops on its local tensors
        if func is torch.ops.prim.device.default and isinstance(args[0], FakeTensor):
            return torch.device("meta")
        kwargs = kwargs or {}
        if isinstance(kwargs.get("device"), torch.device) and kwargs["device"].type == "meta":
            kwargs = {**kwargs, "device": self.device}
        return func(*args, **kwargs)


@contextlib.contextmanager
def fake_mode(device="cuda") -> Iterator[FakeTensorMode]:
    """A new ``FakeTensorMode`` with ``CudaOnMeta`` over it, for fake tensors
    on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)  # a fake CUDA tensor's device
    with FakeTensorMode() as mode, CudaOnMeta(device):
        yield mode


@contextlib.contextmanager
def fake_world(n_ranks: int) -> Iterator[None]:
    """Rank 0 of ``n_ranks`` over the ``"fake"`` backend, as the default
    process group, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process without a default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def choose_layout(cfg: ModelConfig, kind: str, global_batch: int, n_devices: int,
                  override: Optional[str] = None) -> str:
    """The JAX package's choice (``src/repro/launch/dryrun.py:74-84``)."""
    layout = cfg.parallel_layout
    if kind == "decode" or global_batch % n_devices != 0:
        layout = "tp"
    return override or layout


def place_params(params: Any, rules, mesh) -> Any:
    """Whole params laid out on ``mesh`` as the trainer lays them out."""
    blocked = expert_blocks(params, mesh)
    return place_tree(blocked, make_shardings(make_param_specs(blocked, rules, mesh), mesh))


def count_step(cfg: ModelConfig, kind: str, seq_len: int, global_batch: int, *, mesh=None,
               rules=None, device="cuda", params=None, opt_state=None, inputs=None
               ) -> Dict[str, Any]:
    """Run one ``kind`` step of ``cfg`` at (``seq_len``, ``global_batch``)
    under ``OpCounter`` and ``FlopCounterMode``. Without ``params``, on fake
    tensors (``fake_mode``; params from a CPU generator, as ``lm.init_params``
    draws them). With real ``params`` (laid out already on a mesh), on real
    tensors: the train step's ``opt_state`` (made here where None) and the
    step's ``inputs`` (zeros of ``step_specs``' shapes where None). On a mesh
    under ``rules``, the inputs are this rank's batch rows, or the whole
    batch where it is replicated. Returns the cost, the memory record's parts
    and the step's wall time."""
    fake = params is None
    replicated = False
    if mesh is not None:
        split = rules
        rules = batch_rules(rules, mesh, global_batch)
        replicated = rules is not split
    ctx = axes.axis_rules(rules, mesh) if rules is not None else contextlib.nullcontext()
    with ctx, (fake_mode(device) if fake else contextlib.nullcontext()) as mode:
        rows = global_batch // axes.batch_shards()
        if fake:
            params = lm.init_params(cfg, torch.Generator().manual_seed(0), device)
            if mesh is not None:
                params = place_params(params, rules, mesh)
            inputs = step_specs(cfg, kind, seq_len, rows, device=device, mode=mode)
        elif inputs is None:
            with FakeTensorMode() as shapes:
                specs = step_specs(cfg, kind, seq_len, rows, device=device, mode=shapes)
            inputs = tree.tree_map(
                lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), specs)
        if kind == "train":
            opt_cfg = adamw.AdamWConfig()
            if opt_state is None:
                opt_state = adamw.init(opt_cfg, params)
            args = (params, opt_state, *inputs)
            step = make_train_step(cfg, opt_cfg)
        else:
            args = (params, *inputs)
            step = (make_prefill_step(cfg, seq_len) if kind == "prefill"
                    else make_decode_step(cfg, seq_len))
        arg_bytes = fresh_storages(args)
        with FlopCounterMode(display=False) as flops, OpCounter() as counter:
            t0 = time.perf_counter()
            out = step(*args)
            if not fake and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            trace_s = time.perf_counter() - t0
    cost = counter.cost
    return {"cost": cost, "flop_counter": float(flops.get_total_flops()),
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": fresh_storages(out, held=args),
                       "temp_size_in_bytes": cost.peak_live_bytes},
            "trace_s": trace_s, "rows_per_rank": rows, "replicated": replicated}


def run_cell(arch: str, shape: str, multi_pod: bool, *, layout: Optional[str] = None,
             lower_only: bool = False, smoke: bool = False,
             mesh_shape: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """One cell's record. ``smoke`` takes the arch's smoke config and
    ``mesh_shape`` another mesh (("data", "model") for two dims, ("pod",
    "data", "model") for three), as the tests run it."""
    cfg = (get_smoke_config if smoke else get_config)(arch)
    ok, reason = cell_status(cfg, shape)
    shape_axes = PRODUCTION[multi_pod]
    if mesh_shape is not None:
        shape_axes = (tuple(mesh_shape), PRODUCTION[len(mesh_shape) == 3][1])
    mesh_name = "x".join(str(n) for n in shape_axes[0])
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "step": STEP_KIND[shape]}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    dims = SHAPES[shape]
    kind = STEP_KIND[shape]
    n_dev = math.prod(shape_axes[0])
    with fake_world(n_dev):
        mesh = (make_production_mesh(multi_pod=multi_pod, device_type="cuda")
                if mesh_shape is None else make_auto_mesh(*shape_axes, "cuda"))
        rec["layout"] = choose_layout(cfg, kind, dims["global_batch"], n_dev, layout)
        rules = rules_for(mesh, rec["layout"])
        if lower_only:
            rec["status"] = "lowered"
            return rec
        got = count_step(cfg, kind, dims["seq_len"], dims["global_batch"], mesh=mesh,
                         rules=rules)
        with axes.axis_rules(rules, mesh):
            split_slots = axes.kv_seq_span(cache_size_for(cfg, dims["seq_len"])) is not None
    cost = got["cost"]
    roof = analysis.Roofline(
        flops_per_device=cost.dot_flops, hbm_bytes_per_device=cost.hbm_bytes,
        wire_bytes_per_device=cost.total_wire_bytes, n_devices=n_dev,
        model_flops_total=analysis.model_flops_for_step(cfg, kind, dims["seq_len"],
                                                        dims["global_batch"]),
        nvlink_wire_bytes_per_device=cost.nvlink_wire_bytes)
    rec.update(
        status="ok", n_devices=n_dev, params=cfg.param_count(),
        active_params=cfg.active_param_count(), memory=got["memory"],
        collective_counts=cost.collective_counts,
        collective_op_bytes={k: round(v) for k, v in cost.collective_op_bytes.items()},
        collective_wire_bytes={k: round(v) for k, v in cost.collective_wire_bytes.items()},
        collective_groups={k: {str(g): v for g, v in by.items()}
                           for k, by in cost.collective_groups.items()},
        roofline=roof.as_dict(), trace_s=round(got["trace_s"], 2),
        flop_counter=got["flop_counter"], elementwise_bytes=cost.elementwise_bytes,
        kernel_calls=dict(sorted(cost.kernel_calls.items())),
        batch={"rows_per_rank": got["rows_per_rank"], "replicated": got["replicated"]})
    if kind == "decode":
        rec["cache_layout"] = cache_layout(cfg, split_slots)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch × shape) cell")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--lower-only", action="store_true",
                    help="lay out the world, mesh and rules, trace nothing")
    ap.add_argument("--layout", choices=["tp", "fsdp"], default=None,
                    help="override the layout choice (the JAX package's REPRO_FORCE_LAYOUT)")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_f = open(args.out, "a") if args.out else None
    n_fail = 0
    for arch, shape in cells:
        for multi in meshes:
            try:
                rec = run_cell(arch, shape, multi, layout=args.layout,
                               lower_only=args.lower_only)
            except Exception as e:  # noqa: BLE001 — a failed cell is a bug
                rec = {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi else "16x16",
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                n_fail += 1
            line = json.dumps(rec)
            print(line if rec.get("status") != "error"
                  else json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "status",
                                                       "error")}), flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
    if out_f:
        out_f.close()
    if n_fail:
        raise SystemExit(f"{n_fail} cell(s) failed")


if __name__ == "__main__":
    main()
