"""Training launcher: the bypass-fed trainer on one CUDA device or a mesh of
them (or, when asked, the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \
        --steps 50 --feed bypass --ports 2 --ckpt-dir build/ckpt

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``). Without a CUDA device the default raises; ``--device cpu`` runs the
plain kernel versions on the CPU, which is meant for small configs. ``--arch``
takes the registry's ids, and every family trains: dense (qwen3-1.7b,
granite-8b, phi4-mini-3.8b, llama3.2-3b), moe (mixtral-8x7b,
llama4-maverick-400b-a17b), encoder (hubert-xlarge), vlm (internvl2-26b),
hybrid (recurrentgemma-9b) and ssm (mamba2-1.3b).

``--mesh single|multi`` trains on the production mesh, (16, 16) or (2, 16,
16), over the process group ``torchrun`` sets up (``init_process_group``
over its environment, ``nccl`` for ``cuda``, ``gloo`` for ``cpu``; rank r
takes card r modulo the cards present), with ``rules_for``'s axis rules. A
world of another size raises, naming the size it needs:

    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch mixtral-8x7b --mesh single --global-batch 256
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.launch.serve import resolve_device
from repro_torch.models.registry import ARCHS, get_config, get_smoke_config
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--feed", choices=["bypass", "kernel"], default="bypass")
    ap.add_argument("--ports", type=int, default=1)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> TrainerRuntime:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch, seed=args.seed)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, feed=args.feed, feed_ports=args.ports,
                         feed_depth=args.depth, log_every=args.log_every, seed=args.seed)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                                decay_steps=args.steps)
    if args.mesh == "none":
        return _train(cfg, dcfg, tcfg, opt_cfg, device)
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        if device.type == "cuda":
            device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
            torch.cuda.set_device(device)
        mesh = make_production_mesh(multi_pod=args.mesh == "multi", device_type=device.type)
        return _train(cfg, dcfg, tcfg, opt_cfg, device, mesh, rules_for(mesh))
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(cfg, dcfg, tcfg, opt_cfg, device, mesh=None, rules=None) -> TrainerRuntime:
    runtime = TrainerRuntime(cfg, dcfg, tcfg, opt_cfg, device=device, mesh=mesh, rules=rules)
    state = runtime.run()
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[train] finished at step {state.step}; "
              f"stragglers={runtime.straggler_events}")
        if runtime.metrics_log:
            first, last = runtime.metrics_log[0], runtime.metrics_log[-1]
            print(f"[train] loss {first['loss']:.4f} -> {last['loss']:.4f}")
    return runtime


if __name__ == "__main__":
    main()
