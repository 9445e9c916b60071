"""DCA (direct cache access) burst analysis — paper §5.2 / Fig. 4 analogue.

The paper studies how the L2Fwd *burst size* interacts with DCA: forwarding in
bursts of 32 overlaps packet processing with NIC→LLC DMA and lets L2 demand
misses make LLC room, while waiting for 1024 packets before processing floods
the LLC ring buffer and causes writeback storms.

The measurable analogue here is staging-queue dynamics: with a fixed arrival
process, a small processing burst keeps descriptor-ring / staging occupancy low
(DMA overlapped with compute), while a large burst lets occupancy build to the
full train before any draining happens.  We trace occupancy over time and
summarize it with a high-water mark and an "overflow pressure" integral — the
stand-ins for LLC ring-buffer contention and writeback rate.

On the device side the same knob exists as the :class:`BurstPlan` used by the
bypass dataplane and by the burst gather kernel
(``kernels/csrc/burst_gather.cu``: how many packets one call gathers).

Own copy, in the PyTorch port, of ``src/repro/core/dca.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class BurstPlan:
    """Processing-burst configuration shared by host + device paths.

    Applies **per-lcore**: each polling engine resolves its own burst via
    :meth:`burst_for`, so heterogeneous lcores (e.g. one queue carrying an
    elephant flow) can run different DCA-overlap depths in one experiment.
    ``per_lcore=None`` keeps the uniform seed behaviour.
    """

    burst_size: int = 32        # packets processed per poll (DPDK burst)
    prefetch_depth: int = 2     # transfers in flight (DCA overlap depth)
    per_lcore: Optional[Tuple[int, ...]] = None  # per-lcore burst overrides

    def __post_init__(self) -> None:
        if self.burst_size < 1 or self.prefetch_depth < 1:
            raise ValueError("burst_size and prefetch_depth must be >= 1")
        if self.per_lcore is not None:
            if len(self.per_lcore) == 0 or any(b < 1 for b in self.per_lcore):
                raise ValueError("per_lcore bursts must be a nonempty tuple of >= 1")

    def validate_lcores(self, n_lcores: int) -> "BurstPlan":
        """Attach-time check: a ``per_lcore`` tuple must name exactly one
        burst per lcore of the stack adopting this plan.  A 3-entry tuple on
        a 4-lcore stack would silently recycle entry 0 for lcore 3 through
        the :meth:`burst_for` modulo fallback — a misconfiguration, not a
        layout choice, so stacks reject it loudly."""
        if self.per_lcore is not None and len(self.per_lcore) != n_lcores:
            raise ValueError(
                f"BurstPlan.per_lcore has {len(self.per_lcore)} entries for a "
                f"stack with {n_lcores} lcores; pass exactly one burst per "
                "lcore (the burst_for modulo wrap is a fallback for direct "
                "calls, not a layout policy)")
        return self

    def burst_for(self, lcore_id: int) -> int:
        """The burst size lcore ``lcore_id`` polls with.

        When ``per_lcore`` is set, out-of-range lcore ids wrap modulo the
        tuple length — **documented fallback only**, for direct callers that
        probe a plan without a stack; stacks validate exact length at attach
        time via :meth:`validate_lcores`."""
        if self.per_lcore is None:
            return self.burst_size
        return self.per_lcore[lcore_id % len(self.per_lcore)]


@dataclass
class OccupancyTrace:
    """Queue-occupancy samples over a run (one per poll iteration)."""

    samples: List[int] = field(default_factory=list)
    capacity: int = 0

    def record(self, occupancy: int) -> None:
        self.samples.append(occupancy)

    @property
    def high_water(self) -> int:
        return max(self.samples) if self.samples else 0

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    def pressure(self, threshold_frac: float = 0.5) -> float:
        """Fraction of samples above threshold_frac of capacity.

        This is the LLC-contention stand-in: time spent with the staging
        buffer more than half full == time the 'cache' is being thrashed by
        DMA faster than demand misses can make room (paper Fig. 4(b)).
        """
        if not self.samples or self.capacity == 0:
            return 0.0
        thr = threshold_frac * self.capacity
        return float(np.mean([s > thr for s in self.samples]))


def run_burst_experiment(
    n_packets: int,
    burst_size: int,
    ring_size: int = 2048,
    writeback_threshold: Optional[int] = 32,
    arrival_chunk: int = 64,
    process_cost_fn: Optional[Callable[[np.ndarray], None]] = None,
    packet_size: int = 1024,
    clock: Optional["SimClock"] = None,
    tick_ns: int = 1_000,
) -> Tuple[OccupancyTrace, "np.ndarray"]:
    """Reproduce the Fig. 4 setup: deliver ``n_packets`` in a short interval,
    process them in ``burst_size`` chunks, trace occupancy + per-packet delay.

    Runs on a :class:`~repro_torch.core.simclock.SimClock` (one service round ==
    ``tick_ns`` of virtual time); pass an existing clock to compose with a
    larger virtual-time experiment.  Returns (occupancy trace, per-packet
    queue delay in virtual ns).
    """
    from .descriptor import RxDescriptorRing
    from .packet import PacketPool, swap_macs
    from .simclock import SimClock

    pool = PacketPool(ring_size, packet_size)
    ring = RxDescriptorRing(ring_size, writeback_threshold=writeback_threshold)
    process = process_cost_fn or swap_macs
    clock = clock if clock is not None else SimClock()

    trace = OccupancyTrace(capacity=ring_size)
    enqueue_tick = np.full(n_packets, -1, dtype=np.int64)
    dequeue_tick = np.full(n_packets, -1, dtype=np.int64)

    delivered = 0
    processed = 0
    # Service capacity per tick covers the arrival rate (and a whole burst
    # once one is ready) for every configuration — the paper's Fig. 4
    # asymmetry is about WHEN processing starts (overlapped small bursts vs.
    # accumulate-then-forward), not about a slower server.
    service_per_tick = max(arrival_chunk, burst_size)
    while processed < n_packets:
        tick = clock.advance(tick_ns)
        # Arrival process: the whole train arrives "in a short time interval"
        # — arrival_chunk packets per tick.
        for _ in range(arrival_chunk):
            if delivered >= n_packets:
                break
            slot = pool.alloc()
            if slot is None:
                break
            pool.write_packet(slot, seq=delivered, length=packet_size, fill=0)
            if ring.nic_deliver(slot, packet_size):
                enqueue_tick[delivered] = tick
                delivered += 1
            else:
                pool.free(slot)
        ring.flush()
        # occupancy is sampled post-DMA / pre-processing: the staging pressure
        # the LLC sees in the paper's Fig. 4
        trace.record(ring.in_flight)
        # L2Fwd aggregates a full burst before forwarding — Fig. 4(b) "waits
        # until 1024 packets are received and then starts the forwarding"
        if ring.in_flight < burst_size and delivered < n_packets:
            continue
        served = 0
        while served < service_per_tick:
            batch = ring.poll(min(burst_size, service_per_tick - served)
                              if burst_size < n_packets else burst_size)
            if not batch:
                break
            for slot, length in batch:
                buf = pool.view(slot, length)
                process(buf)
                dequeue_tick[processed] = tick  # FIFO ring → in-order
                processed += 1
                pool.free(slot)
            served += len(batch)
            if burst_size >= n_packets:
                break  # one mega-burst per tick
    delay = (dequeue_tick - enqueue_tick).astype(np.int64)
    return trace, delay
