"""Per-packet telemetry: RTT stats, drop accounting, histograms, throughput.

This is the measurement half of EtherLoadGen (paper §3.3): "reports mean,
median, standard deviation, and tail latency of network packets ... also
produces a packet drop percentage and a histogram of packet forwarding
latency."

Own copy, in the PyTorch port, of ``src/repro/core/telemetry.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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

    def __str__(self) -> str:  # human-readable one-liner for stats files
        us = 1e3
        return (
            f"n={self.count} mean={self.mean_ns/us:.2f}us med={self.median_ns/us:.2f}us "
            f"std={self.std_ns/us:.2f}us p95={self.p95_ns/us:.2f}us "
            f"p99={self.p99_ns/us:.2f}us p99.9={self.p999_ns/us:.2f}us "
            f"max={self.max_ns/us:.2f}us"
        )


class LatencyRecorder:
    """Append-only RTT recorder with percentile stats + log-bucket histogram."""

    def __init__(self, capacity_hint: int = 1 << 16):
        self._buf = np.zeros(max(16, capacity_hint), dtype=np.int64)
        self._n = 0

    def record(self, rtt_ns: int) -> None:
        if self._n == len(self._buf):
            self._buf = np.concatenate([self._buf, np.zeros_like(self._buf)])
        self._buf[self._n] = rtt_ns
        self._n += 1

    def record_many(self, rtts_ns: np.ndarray) -> None:
        m = len(rtts_ns)
        while self._n + m > len(self._buf):
            self._buf = np.concatenate([self._buf, np.zeros_like(self._buf)])
        self._buf[self._n : self._n + m] = rtts_ns
        self._n += m

    @property
    def count(self) -> int:
        return self._n

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

    def histogram(self, n_buckets: int = 24) -> List[Dict[str, float]]:
        """Log-spaced latency histogram (the paper's 'histogram of packet
        forwarding latency')."""
        if self._n == 0:
            return []
        v = self.values().astype(np.float64)
        lo = max(1.0, float(v.min()))
        hi = max(lo * 1.0001, float(v.max()))
        edges = np.logspace(math.log10(lo), math.log10(hi), n_buckets + 1)
        counts, _ = np.histogram(v, bins=edges)
        return [
            {"lo_ns": float(edges[i]), "hi_ns": float(edges[i + 1]), "count": int(counts[i])}
            for i in range(n_buckets)
        ]


def writeback_extras(ports: List[object], prefix: str = "") -> Dict[str, float]:
    """Per-RX-ring descriptor-writeback telemetry, RunReport.extras-shaped.

    For every (port, queue) RX ring: the number of writeback DMA events
    (``writebacks``), the mean/max writeback burst size (the distribution the
    paper's Fig. 4 studies — large bursts are the LLC-thrashing regime), and
    how many of those events were forced by the idle-timeout timer
    (``timeout_flushes``, the ITR analogue).  ``prefix`` namespaces the keys
    for multi-host reports (e.g. ``n0_``).
    """
    out: Dict[str, float] = {}
    for pi, port in enumerate(ports):
        for qi, ring in enumerate(port.rx_queues):
            k = f"{prefix}p{pi}q{qi}"
            sizes = ring.writeback_sizes
            out[f"{k}_writebacks"] = float(ring.writebacks)
            out[f"{k}_wb_size_mean"] = float(np.mean(sizes)) if sizes else 0.0
            out[f"{k}_wb_size_max"] = float(max(sizes)) if sizes else 0.0
            out[f"{k}_timeout_flushes"] = float(ring.timeout_flushes)
    return out


def rss_skew(per_queue_counts: List[int]) -> Dict[str, float]:
    """RSS load-imbalance summary over per-queue packet counts.

    ``max_over_mean`` is the classic imbalance factor (1.0 == perfectly
    balanced; a queue at 2.0 is the hot queue bottlenecking core scaling);
    ``cov`` is the coefficient of variation across queues.
    """
    counts = np.asarray(per_queue_counts, dtype=np.float64)
    if counts.size == 0 or counts.sum() == 0:
        return {"max_over_mean": 0.0, "cov": 0.0}
    mean = counts.mean()
    return {
        "max_over_mean": float(counts.max() / mean),
        "cov": float(counts.std() / mean),
    }


class QueueTelemetry:
    """Per-(port, queue) RX-descriptor occupancy sampler.

    Sample once per poll/scheduling round; summarizes mean and high-water
    occupancy per queue plus the RSS skew of total per-queue traffic — the
    observable that shows whether flows actually spread across queues
    (paper Fig. 3(a) core scaling needs balance).
    """

    def __init__(self) -> None:
        self._sum: Dict[tuple, int] = {}
        self._high: Dict[tuple, int] = {}
        self._n = 0

    def sample(self, ports: List[object]) -> None:
        self._n += 1
        for pi, port in enumerate(ports):
            for qi, occ in enumerate(port.queue_occupancy()):
                key = (pi, qi)
                self._sum[key] = self._sum.get(key, 0) + occ
                self._high[key] = max(self._high.get(key, 0), occ)

    @property
    def samples(self) -> int:
        return self._n

    def mean_occupancy(self) -> Dict[tuple, float]:
        return {k: v / self._n for k, v in self._sum.items()} if self._n else {}

    def high_water(self) -> Dict[tuple, int]:
        return dict(self._high)

    def summary(self, ports: List[object]) -> Dict[str, float]:
        """Flat metrics dict (RunReport.extras-shaped)."""
        out: Dict[str, float] = {}
        means = self.mean_occupancy()
        for (pi, qi), m in sorted(means.items()):
            out[f"p{pi}q{qi}_occ_mean"] = m
            out[f"p{pi}q{qi}_occ_high"] = float(self._high[(pi, qi)])
        for pi, port in enumerate(ports):
            skew = rss_skew(port.rx_queue_delivered())
            out[f"p{pi}_rss_imbalance"] = skew["max_over_mean"]
            out[f"p{pi}_rss_cov"] = skew["cov"]
        return out


@dataclass
class ThroughputMeter:
    """Counts packets/bytes over an interval → Gbps / Mpps."""

    packets: int = 0
    bytes: int = 0
    start_ns: Optional[int] = None
    end_ns: Optional[int] = None

    def open_window(self, start_ns: int) -> None:
        """Anchor the measurement window at the run's first emission.

        Without this, a run whose completions all publish in one terminal
        writeback flush would measure its throughput over the (tiny) drain
        burst instead of the traffic interval and report absurd rates.
        """
        if self.start_ns is None:
            self.start_ns = start_ns

    def on_packet(self, length: int, now_ns: int) -> None:
        if self.start_ns is None:
            self.start_ns = now_ns
        self.end_ns = now_ns
        self.packets += 1
        self.bytes += length

    def merge_counts(self, packets: int, nbytes: int, start_ns: int, end_ns: int) -> None:
        self.packets += packets
        self.bytes += nbytes
        self.start_ns = start_ns if self.start_ns is None else min(self.start_ns, start_ns)
        self.end_ns = end_ns if self.end_ns is None else max(self.end_ns, end_ns)

    @property
    def elapsed_s(self) -> float:
        if self.start_ns is None or self.end_ns is None:
            return 0.0
        if self.end_ns <= self.start_ns:
            # degenerate window: every completion landed on one clock tick
            # (e.g. a single packet published by a terminal writeback flush).
            # Measure over the 1 ns tick floor instead of claiming the run
            # moved zero traffic.
            return 1e-9 if self.packets > 0 else 0.0
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def gbps(self) -> float:
        el = self.elapsed_s
        return (self.bytes * 8 / 1e9 / el) if el > 0 else 0.0

    @property
    def mpps(self) -> float:
        el = self.elapsed_s
        return (self.packets / 1e6 / el) if el > 0 else 0.0


@dataclass
class RunReport:
    """One benchmark run's stats file — EtherLoadGen's 'statistics file'."""

    offered_gbps: float = 0.0
    achieved_gbps: float = 0.0
    achieved_mpps: float = 0.0
    sent: int = 0
    received: int = 0
    dropped: int = 0
    latency: Optional[LatencyStats] = None
    histogram: List[Dict[str, float]] = field(default_factory=list)
    extras: Dict[str, float] = field(default_factory=dict)

    @property
    def drop_pct(self) -> float:
        return 100.0 * self.dropped / self.sent if self.sent else 0.0

    def to_dict(self) -> Dict[str, object]:
        """JSON-safe plain-data form (suite-runner artifacts; round-trips
        through :meth:`from_dict`)."""
        return {
            "offered_gbps": self.offered_gbps,
            "achieved_gbps": self.achieved_gbps,
            "achieved_mpps": self.achieved_mpps,
            "sent": self.sent,
            "received": self.received,
            "dropped": self.dropped,
            "latency": None if self.latency is None else self.latency.as_dict(),
            "histogram": [dict(b) for b in self.histogram],
            "extras": dict(self.extras),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "RunReport":
        d = dict(d)
        if d.get("latency") is not None:
            d["latency"] = LatencyStats(**d["latency"])
        return cls(**d)

    def summary(self) -> str:
        lines = [
            f"offered={self.offered_gbps:.3f}Gbps achieved={self.achieved_gbps:.3f}Gbps "
            f"({self.achieved_mpps:.3f}Mpps) sent={self.sent} rx={self.received} "
            f"drops={self.dropped} ({self.drop_pct:.3f}%)"
        ]
        if self.latency is not None:
            lines.append(f"latency: {self.latency}")
        for k, v in self.extras.items():
            lines.append(f"{k}={v}")
        return "\n".join(lines)
