"""Synthetic token, audio-frame and image-patch streams that feed the
dataplane (own copy of the reference's ``src/repro/data/pipeline.py:21-85``).

Deterministic, seeded and shardable: each producer port of the dataplane
pulls batches from its own slice of the stream, so multi-port ingest is
reproducible and restart-exact (``start_step`` fast-forwards the stream to a
checkpointed step). numpy only; the batches are byte-identical to the JAX
package's for the same seed, port and step.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic corpus parameters: a mixture of zipfian unigrams and short
    # repeated motifs so the LM loss actually decreases during examples
    zipf_alpha: float = 1.1
    motif_len: int = 16
    motif_prob: float = 0.5


def _rng_for(seed: int, port: int, step: int) -> np.random.Generator:
    mix = hashlib.blake2s(f"{seed}:{port}:{step}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(mix, "little"))


def synth_tokens(cfg: ModelConfig, dcfg: DataConfig, port: int, n_ports: int,
                 step: int) -> Dict[str, np.ndarray]:
    """One host batch: this port's slice of the global batch. ``tokens`` and
    ``labels`` (B, S) int32; for audio frames ``frames`` (B, S, D) f32 and
    ``labels``; for vision patches ``patches`` (B, P, D) f32 and the text's
    ``tokens`` and ``labels`` (B, S - P), so the fused sequence is S long.
    The frames and patches are drawn after the tokens from the same rng, as
    the JAX package draws them."""
    rng = _rng_for(dcfg.seed, port, step)
    B = dcfg.global_batch // n_ports
    S = dcfg.seq_len
    V = cfg.vocab_size

    # zipfian unigram stream
    ranks = rng.zipf(dcfg.zipf_alpha, size=(B, S + 1)).astype(np.int64)
    toks = np.minimum(ranks, V - 1).astype(np.int32)
    # inject repeated motifs (predictable structure for the loss to learn)
    n_motifs = max(1, S // (4 * dcfg.motif_len))
    motif = rng.integers(0, V, size=(B, dcfg.motif_len), dtype=np.int32)
    for _ in range(n_motifs):
        if rng.random() < dcfg.motif_prob:
            pos = rng.integers(0, S + 1 - dcfg.motif_len)
            toks[:, pos:pos + dcfg.motif_len] = motif

    if cfg.frontend == "audio_frames":
        frames = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32) * 0.02
        return {"frames": frames, "labels": toks[:, :S] % V}
    if cfg.frontend == "vision_patches":
        s_text = S - cfg.n_patches
        patches = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
        return {"tokens": toks[:, :s_text],
                "patches": patches,
                "labels": toks[:, 1:s_text + 1]}
    return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}


def make_stream(cfg: ModelConfig, dcfg: DataConfig, port: int, n_ports: int,
                start_step: int = 0, n_steps: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic per-port batch iterator (resume via start_step)."""
    step = start_step
    while n_steps is None or step < start_step + n_steps:
        yield synth_tokens(cfg, dcfg, port, n_ports, step)
        step += 1


def stream_factory(cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0,
                   n_steps: Optional[int] = None):
    """Factory with the (port, n_ports) signature the dataplane expects."""
    def factory(port: int, n_ports: int):
        return make_stream(cfg, dcfg, port, n_ports, start_step, n_steps)
    return factory
