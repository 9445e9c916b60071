"""The training batches, made again for the reference: a frozen copy of the
synthetic stream that the program's data pipeline draws (zipfian unigrams
with repeated motifs; for audio frames, f32 frames drawn after the tokens
from the same generator). Numpy only. Batch ``step`` of port ``port`` of a
seed is the same array, byte for byte, as the pipeline hands the feed.
"""
from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np

ZIPF_ALPHA, MOTIF_LEN, MOTIF_PROB = 1.1, 16, 0.5


def _rng_for(seed: int, port: int, step: int) -> np.random.Generator:
    mix = hashlib.blake2s(f"{seed}:{port}:{step}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(mix, "little"))


def batch(model: dict, seq_len: int, global_batch: int, seed: int, step: int,
          port: int = 0, n_ports: int = 1) -> Dict[str, np.ndarray]:
    """``tokens`` and ``labels`` (B, S) int32, or for audio frames ``frames``
    (B, S, D) f32 and ``labels``."""
    rng = _rng_for(seed, port, step)
    B, S, V = global_batch // n_ports, seq_len, model["vocab_size"]
    toks = np.minimum(rng.zipf(ZIPF_ALPHA, size=(B, S + 1)).astype(np.int64),
                      V - 1).astype(np.int32)
    motif = rng.integers(0, V, size=(B, MOTIF_LEN), dtype=np.int32)
    for _ in range(max(1, S // (4 * MOTIF_LEN))):
        if rng.random() < MOTIF_PROB:
            pos = rng.integers(0, S + 1 - MOTIF_LEN)
            toks[:, pos:pos + MOTIF_LEN] = motif
    if model["frontend"] == "audio_frames":
        frames = rng.standard_normal((B, S, model["d_model"])).astype(np.float32) * 0.02
        return {"frames": frames, "labels": toks[:, :S] % V}
    if model["frontend"] != "none":
        raise ValueError(f"frontend {model['frontend']!r} has no frozen stream here")
    return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
