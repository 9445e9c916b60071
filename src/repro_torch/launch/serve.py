"""Serving launcher: batched prefill + greedy decode, with TTFT and per-token
latency, on one CUDA device (or, when asked, the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 8 --batch 4 --prompt-len 512 --gen-len 32

``--arch`` takes the registry's ids: qwen3-1.7b, granite-8b, phi4-mini-3.8b,
llama3.2-3b (dense), mixtral-8x7b, llama4-maverick-400b-a17b (moe, the local
path: no expert sharding), mamba2-1.3b (ssm), recurrentgemma-9b (hybrid),
internvl2-26b (vlm: each batch of prompts also gets ``n_patches`` image
patches, put before the text); hubert-xlarge (encoder) has no decode step
and is refused, as the JAX package refuses it.

The flags are those of ``repro.launch.serve`` plus ``--device`` (default
``cuda``). Without a CUDA device the default raises; ``--device cpu`` runs the
plain kernel versions on the CPU, which is meant for small configs.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.telemetry import LatencyRecorder
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ARCHS, get_config, get_smoke_config
from repro_torch.runtime.steps import make_decode_step, make_prefill_step


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device is available; the "
                           "launchers do not fall back to the CPU (pass --device cpu "
                           "to run the plain versions there on purpose)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_params(cfg: ModelConfig, seed: int, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return lm.init_params(cfg, gen, device)


def serve(cfg: ModelConfig, params, *, requests: int, batch: int,
          prompt_len: int, gen_len: int, seed: int,
          device: torch.device) -> Dict[str, Any]:
    """Serve ``requests`` random prompts in batches of ``batch``: one prefill
    and ``gen_len`` greedy decode steps per batch. Returns the latency stats,
    the token count and whether every logit was finite."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.arch_id} is encoder-only: no decode serving")
    B = batch
    # the vlm's patches come before the prompt's text in the fused sequence
    n_patches = cfg.n_patches if cfg.frontend == "vision_patches" else 0
    max_len = prompt_len + gen_len + n_patches
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)

    rng = np.random.default_rng(seed)
    ttft, tpot = LatencyRecorder(), LatencyRecorder()
    finite = torch.ones((), dtype=torch.bool, device=device)
    tokens_out: List[torch.Tensor] = []
    total_tokens = 0
    _sync(device)
    t_start = time.perf_counter_ns()
    for _ in range((requests + B - 1) // B):
        prompt = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, size=(B, prompt_len)), dtype=torch.long).to(device)}
        if n_patches:  # drawn after the tokens from the same rng, as the JAX package does
            prompt["patches"] = torch.as_tensor(
                rng.standard_normal((B, n_patches, cfg.d_model)) * 0.02).to(
                    device=device, dtype=getattr(torch, cfg.compute_dtype))
        t0 = time.perf_counter_ns()
        logits, cache = prefill(params, prompt)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        _sync(device)
        ttft.record(time.perf_counter_ns() - t0)
        finite &= torch.isfinite(logits).all()
        generated = [tok]
        for i in range(gen_len):
            t1 = time.perf_counter_ns()
            pos = torch.full((B,), n_patches + prompt_len + i, dtype=torch.int32,
                             device=device)
            tok, logits, cache = decode(params, cache, tok, pos)
            _sync(device)
            tpot.record(time.perf_counter_ns() - t1)
            finite &= torch.isfinite(logits).all()
            generated.append(tok)
            total_tokens += B
        tokens_out.append(torch.stack(generated, dim=1))
    _sync(device)
    wall_s = (time.perf_counter_ns() - t_start) / 1e9
    return {
        "ttft": ttft.stats(),
        "tpot": tpot.stats(),
        "total_tokens": total_tokens,
        "wall_s": wall_s,
        "tok_per_s": total_tokens / wall_s,
        "finite": bool(finite.item()),
        "tokens": torch.cat(tokens_out).cpu(),
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, args.seed, device)
    result = serve(cfg, params, requests=args.requests, batch=args.batch,
                   prompt_len=args.prompt_len, gen_len=args.gen_len,
                   seed=args.seed, device=device)
    print(f"[serve] {args.requests} requests, {result['total_tokens']} generated "
          f"tokens in {result['wall_s']:.2f}s ({result['tok_per_s']:.1f} tok/s) "
          f"on {device}")
    print(f"[serve] TTFT: {result['ttft']}")
    print(f"[serve] per-token: {result['tpot']}")
    return result


if __name__ == "__main__":
    main()
