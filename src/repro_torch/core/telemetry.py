"""Latency statistics (own copy of the reference's ``LatencyStats`` and
``LatencyRecorder``): mean, median, spread and tail percentiles of
per-request or per-token times in nanoseconds."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class LatencyStats:
    count: int
    mean_ns: float
    median_ns: float
    std_ns: float
    p95_ns: float
    p99_ns: float
    p999_ns: float
    max_ns: float
    min_ns: float

    def as_dict(self) -> Dict[str, float]:
        return dict(
            count=self.count, mean_ns=self.mean_ns, median_ns=self.median_ns,
            std_ns=self.std_ns, p95_ns=self.p95_ns, p99_ns=self.p99_ns,
            p999_ns=self.p999_ns, max_ns=self.max_ns, min_ns=self.min_ns,
        )

    def __str__(self) -> str:
        us = 1e3
        return (
            f"n={self.count} mean={self.mean_ns/us:.2f}us med={self.median_ns/us:.2f}us "
            f"std={self.std_ns/us:.2f}us p95={self.p95_ns/us:.2f}us "
            f"p99={self.p99_ns/us:.2f}us p99.9={self.p999_ns/us:.2f}us "
            f"max={self.max_ns/us:.2f}us"
        )


class LatencyRecorder:
    """Append-only latency recorder with percentile stats."""

    def __init__(self, capacity_hint: int = 1 << 16):
        self._buf = np.zeros(max(16, capacity_hint), dtype=np.int64)
        self._n = 0

    def record(self, rtt_ns: int) -> None:
        if self._n == len(self._buf):
            self._buf = np.concatenate([self._buf, np.zeros_like(self._buf)])
        self._buf[self._n] = rtt_ns
        self._n += 1

    def values(self) -> np.ndarray:
        return self._buf[: self._n]

    def stats(self) -> Optional[LatencyStats]:
        if self._n == 0:
            return None
        v = self.values().astype(np.float64)
        return LatencyStats(
            count=self._n,
            mean_ns=float(v.mean()),
            median_ns=float(np.median(v)),
            std_ns=float(v.std()),
            p95_ns=float(np.percentile(v, 95)),
            p99_ns=float(np.percentile(v, 99)),
            p999_ns=float(np.percentile(v, 99.9)),
            max_ns=float(v.max()),
            min_ns=float(v.min()),
        )
