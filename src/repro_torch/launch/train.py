"""Training launcher: the bypass-fed trainer on one CUDA device (or, when
asked, the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \
        --steps 50 --feed bypass --ports 2 --ckpt-dir build/ckpt

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``). Without a CUDA device the default raises; ``--device cpu`` runs the
plain kernel versions on the CPU, which is meant for small configs. ``--arch``
takes the ported ids, and only the dense family trains. ``--mesh`` other than
``none`` raises: sharding is not ported (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.data.pipeline import DataConfig
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
    if args.mesh != "none":
        raise NotImplementedError(f"--mesh {args.mesh}: sharding is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 10)")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch, seed=args.seed)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, feed=args.feed, feed_ports=args.ports,
                         feed_depth=args.depth, log_every=args.log_every, seed=args.seed)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                                decay_steps=args.steps)
    runtime = TrainerRuntime(cfg, dcfg, tcfg, opt_cfg, device=device)
    state = runtime.run()
    print(f"[train] finished at step {state.step}; stragglers={runtime.straggler_events}")
    if runtime.metrics_log:
        first, last = runtime.metrics_log[0], runtime.metrics_log[-1]
        print(f"[train] loss {first['loss']:.4f} -> {last['loss']:.4f}")
    return runtime


if __name__ == "__main__":
    main()
