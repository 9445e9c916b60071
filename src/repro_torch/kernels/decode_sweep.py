"""The decode kernels' device time under the split planner's plan and others.

    PYTHONPATH=src python -m repro_torch.kernels.decode_sweep

Runs on one CUDA device only. At the two serve decode shapes, in bf16, it
launches the partial pass and the combine (``decode_attention._launch``)
under splits of 1, 2, 4 and 8 64-key tiles and under one split over the
whole cache, reads their device time per call from torch.profiler, holds
each plan's output against that of the plan ``plan_splits`` picks (2e-2,
the bf16 tolerance of the kernel checks) and prints one JSON line per plan.
It exits non-zero if a plan disagrees. The planner's split size rests on
these numbers.
"""
from __future__ import annotations

import json
import sys

import torch

from . import decode_attention as kdec

# B, C, H, Hkv, Dh, len of every row: qwen3-1.7b's middle decode step of a
# 512-token prompt and 32 generated tokens, and recurrentgemma-9b's full ring
SHAPES = {"qwen3-1.7b": (4, 544, 16, 8, 128, 529),
          "recurrentgemma-9b": (4, 2048, 16, 1, 256, 2048)}
TOL = 2e-2
ITERS = 50


def device_ms(fn) -> float:
    """Device time per call of the decode kernels, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and "decode_attn_" in e.name) / ITERS / 1e3


def sweep(arch: str, dev: torch.device):
    B, C, H, Hkv, Dh, n = SHAPES[arch]
    gen = torch.Generator().manual_seed(4)
    q, kc, vc = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                 for shape in ((B, H, Dh), (B, C, Hkv, Dh), (B, C, Hkv, Dh)))
    cl = torch.full((B,), n, dtype=torch.int32, device=dev)
    scale = Dh ** -0.5
    chosen = kdec.plan_splits(B, C, Hkv, H // Hkv, Dh, q.dtype, kdec._sm_count(dev.index))
    want = kdec._launch(q, kc, vc, cl, scale, chosen)
    tiles = -(-C // kdec.TILE)
    for t in sorted({1, 2, 4, 8, tiles} & set(range(1, tiles + 1))):
        plan = chosen._replace(split_keys=t * kdec.TILE, n_splits=-(-tiles // t))
        got = kdec._launch(q, kc, vc, cl, scale, plan)
        diff = (got.float() - want.float()).abs()
        row = {"arch": arch, **plan._asdict(), "blocks": plan.n_splits * Hkv * B,
               "chosen": plan == chosen,
               "device_ms": device_ms(lambda: kdec._launch(q, kc, vc, cl, scale, plan)),
               "max_abs_vs_chosen": float(diff.max())}
        print(json.dumps(row), flush=True)
        if not bool((diff <= TOL + TOL * want.float().abs()).all()):
            sys.exit(f"decode plan {plan} disagrees with the planner's {chosen}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("decode_sweep: no CUDA device; it times the kernels on the card only")
    dev = torch.device("cuda", 0)
    for arch in SHAPES:
        sweep(arch, dev)


if __name__ == "__main__":
    main()
