"""Stand-ins for every model input of the dry run's steps, with no device
memory (port of ``src/repro/launch/inputs.py``).

``input_specs(cfg, shape_name)`` returns the inputs of the step function
that the shape cell runs, other than params and optimizer state:

  train_4k             → train_step(params, opt_state, batch)
  prefill_32k          → prefill_step(params, batch)
  decode_32k/long_500k → decode_step(params, cache, token, pos)

Where the JAX package returns ``jax.ShapeDtypeStruct``s, these are fake
tensors (``torch._subclasses.fake_tensor``) of the same shapes and dtypes,
made in the given ``FakeTensorMode`` (a new one if none is given) on
``device``; the steps run on them as on real tensors. The cache is
``lm.init_cache`` run in that mode.

The dtypes are the JAX package's: tokens, labels, decode tokens and
positions int32, and hubert-xlarge's frames and internvl2-26b's patches
bf16. The port's data pipeline and ``chip_smoke.py``'s hubert cell feed f32
frames and patches, which ``lm._embed_inputs`` casts on entry; the dry run
follows the JAX package's specs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import SHAPES, STEP_KIND


def _mode(mode: Optional[FakeTensorMode]) -> FakeTensorMode:
    return mode if mode is not None else FakeTensorMode()


def batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int, *, device="cpu",
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    B, S = global_batch, seq_len
    with _mode(mode):
        if cfg.frontend == "audio_frames":
            return {
                "frames": torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                                      device=device),
                "labels": torch.empty((B, S), dtype=torch.int32, device=device),
            }
        if cfg.frontend == "vision_patches":
            s_text = S - cfg.n_patches
            return {
                "tokens": torch.empty((B, s_text), dtype=torch.int32, device=device),
                "patches": torch.empty((B, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
                                       device=device),
                "labels": torch.empty((B, s_text), dtype=torch.int32, device=device),
            }
        return {
            "tokens": torch.empty((B, S), dtype=torch.int32, device=device),
            "labels": torch.empty((B, S), dtype=torch.int32, device=device),
        }


def prompt_specs(cfg: ModelConfig, seq_len: int, global_batch: int, *, device="cpu",
                 mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    b = batch_specs(cfg, seq_len, global_batch, device=device, mode=mode)
    b.pop("labels", None)
    return b


def cache_specs(cfg: ModelConfig, global_batch: int, max_len: int, *, device="cpu",
                mode: Optional[FakeTensorMode] = None) -> Any:
    with _mode(mode):
        return lm.init_cache(cfg, global_batch, max_len, device)


def step_specs(cfg: ModelConfig, kind: str, seq_len: int, global_batch: int, *,
               device="cpu", mode: Optional[FakeTensorMode] = None) -> Tuple[Any, ...]:
    """The inputs of a ``kind`` step ("train", "prefill" or "decode") at
    ``seq_len`` and ``global_batch`` (a rank's rows, where the dry run
    passes them)."""
    S, B = seq_len, global_batch
    mode = _mode(mode)
    if kind == "train":
        return (batch_specs(cfg, S, B, device=device, mode=mode),)
    if kind == "prefill":
        return (prompt_specs(cfg, S, B, device=device, mode=mode),)
    if kind == "decode":
        cache = cache_specs(cfg, B, S, device=device, mode=mode)
        with mode:
            token = torch.empty((B,), dtype=torch.int32, device=device)
            pos = torch.empty((B,), dtype=torch.int32, device=device)
        return (cache, token, pos)
    raise ValueError(kind)


def input_specs(cfg: ModelConfig, shape_name: str, *, device="cpu",
                mode: Optional[FakeTensorMode] = None) -> Tuple[Any, ...]:
    dims = SHAPES[shape_name]
    return step_specs(cfg, STEP_KIND[shape_name], dims["seq_len"], dims["global_batch"],
                      device=device, mode=mode)
