"""Polling-mode driver (PMD) engine — the DPDK analogue.

Implements the two DPDK execution models from the paper (§2), both on the
unified :class:`~repro_torch.core.netstack.NetworkStack` lcore machinery:

* **Run-to-completion**: "(1) retrieve RX packets through polling mode driver
  (PMD) RX API, (2) process packets on the same logical core, (3) send pending
  packets through PMD TX API."  → :class:`BypassL2FwdServer`, one lcore per
  (port, queue) pair by default.
* **Pipeline**: "lets cores pass packets between each other via a ring buffer"
  → :class:`PipelineServer` (rx/work/tx stage lcores linked by SPSC rings;
  sequential ``poll_once`` or optional threads).

The NIC model is multi-queue: a :class:`Port` owns ``n_queues`` RX/TX
descriptor-ring pairs over the shared :class:`~repro_torch.core.packet.PacketPool`,
and received frames are steered to a queue by Toeplitz RSS over the flow
fields in the frame header (:mod:`repro_torch.core.rss`) — the mechanism that makes
bandwidth scale with cores in the paper's Fig. 3(a).

Zero-copy discipline: a packet never leaves its arena slot between RX and TX —
processing operates on numpy views, and TX posts the same slot the NIC DMA'd
into.  Compare :mod:`repro_torch.core.kernel_stack`, which copies twice and allocates
per packet.

Own copy, in the PyTorch port, of ``src/repro/core/pmd.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .descriptor import RxDescriptorRing, TxDescriptorRing
from .netstack import Lcore, NetworkStack, ServerStats
from .packet import (PacketPool, read_flow_bytes, read_flow_bytes_vec,
                     swap_macs, swap_macs_vec)
from .rings import SpscRing
from .rss import RssIndirection

ProcessFn = Callable[[np.ndarray], None]  # in-place packet transform
# in-place burst transform over (pool, slots, lengths)
BurstProcessFn = Callable[[PacketPool, np.ndarray, np.ndarray], None]

_EMPTY_I64 = np.empty(0, dtype=np.int64)
_EMPTY_I32 = np.empty(0, dtype=np.int32)


class Port:
    """One NIC port: ``n_queues`` RX/TX descriptor-ring pairs + RSS steering
    over a shared packet pool.

    .. deprecated:: the public device API is :class:`repro_torch.core.ethdev.EthDev`
       (the ``rte_ethdev``-faithful facade, which owns a ``Port`` as its
       internal engine).  Direct ``Port``/``Port.make`` construction remains
       supported for existing code and tests, but new scenarios should go
       through ``EthDev`` / ``repro_torch.exp.ExperimentConfig``.
    """

    def __init__(
        self,
        pool: PacketPool,
        rx_queues: Sequence[RxDescriptorRing],
        tx_queues: Sequence[TxDescriptorRing],
        rss: Optional[RssIndirection] = None,
        link_gbps: float = 0.0,
        link_latency_ns: int = 0,
    ):
        if not rx_queues or len(rx_queues) != len(tx_queues):
            raise ValueError("need equal, nonzero RX and TX queue counts")
        if link_latency_ns < 0:
            raise ValueError("link_latency_ns must be >= 0")
        self.pool = pool
        self.rx_queues = list(rx_queues)
        self.tx_queues = list(tx_queues)
        self.rss = rss if rss is not None else RssIndirection(len(self.rx_queues))
        # wire parameters consumed by the virtual-time load generator:
        # serialization runs at link_gbps (<= 0 == ideal wire) and every frame
        # pays link_latency_ns of propagation each way
        self.link_gbps = float(link_gbps)
        self.link_latency_ns = int(link_latency_ns)

    @staticmethod
    def make(
        pool: PacketPool,
        ring_size: int = 256,
        writeback_threshold: Optional[int] = 32,
        n_queues: int = 1,
        rss: Optional[RssIndirection] = None,
        link_gbps: float = 0.0,
        link_latency_ns: int = 0,
    ) -> "Port":
        return Port(
            pool,
            rx_queues=[
                RxDescriptorRing(ring_size, writeback_threshold=writeback_threshold,
                                 queue_id=q)
                for q in range(n_queues)
            ],
            tx_queues=[TxDescriptorRing(ring_size, queue_id=q)
                       for q in range(n_queues)],
            rss=rss,
            link_gbps=link_gbps,
            link_latency_ns=link_latency_ns,
        )

    @property
    def n_queues(self) -> int:
        return len(self.rx_queues)

    # -- burst dataplane (the rte_ethdev contract; EthDev delegates here) ----
    def rx_burst(self, queue_id: int, nb_pkts: int) -> Tuple[np.ndarray, np.ndarray]:
        """``rte_eth_rx_burst`` semantics: harvest up to ``nb_pkts`` completed
        descriptors from one RX queue → (slots, lengths), zero copy."""
        return self.rx_queues[queue_id].poll_burst(nb_pkts)

    def tx_burst(self, queue_id: int, slots: np.ndarray,
                 lengths: np.ndarray) -> int:
        """``rte_eth_tx_burst`` semantics: post a burst on one TX queue;
        returns the number accepted (the rest is the caller's to free)."""
        return self.tx_queues[queue_id].post_burst_vec(slots, lengths)

    # -- legacy single-queue views (the seed-era API; queue 0) ---------------
    @property
    def rx(self) -> RxDescriptorRing:
        return self.rx_queues[0]

    @property
    def tx(self) -> TxDescriptorRing:
        return self.tx_queues[0]

    # -- NIC-side delivery (the RSS steering point) --------------------------
    def deliver(self, packet_slot: int, length: int) -> bool:
        """Steer one received frame to its RSS queue.  On ring overflow the
        frame is dropped at the NIC and its buffer recycled; returns False."""
        if self.n_queues == 1:
            q = 0
        else:
            # scalar path: a zero-copy flow-bytes view + table-lookup hash —
            # no per-frame numpy temporaries
            q = self.rss.steer_one(read_flow_bytes(self.pool, packet_slot))
        if not self.rx_queues[q].nic_deliver(packet_slot, length):
            self.pool.free(packet_slot)
            return False
        return True

    def deliver_burst(self, packet_slots: np.ndarray, lengths: np.ndarray) -> int:
        """RSS-steered burst delivery: one hash + one indirection lookup for
        the whole burst, then one ``nic_deliver_burst`` per touched queue.
        Dropped frames (per-queue ring overflow) are freed back to the pool.
        Returns the number accepted."""
        n = len(packet_slots)
        if n == 0:
            return 0
        if self.n_queues == 1:
            ring = self.rx_queues[0]
            accepted = ring.nic_deliver_burst(packet_slots, lengths)
            if accepted < n:
                self.pool.free_burst([int(s) for s in packet_slots[accepted:]])
            return accepted
        queues = self.rss.steer(read_flow_bytes_vec(self.pool, packet_slots))
        accepted = 0
        for q in range(self.n_queues):
            mask = queues == q
            if not mask.any():
                continue
            qslots = packet_slots[mask]
            qlens = lengths[mask]
            take = self.rx_queues[q].nic_deliver_burst(qslots, qlens)
            accepted += take
            if take < len(qslots):
                self.pool.free_burst([int(s) for s in qslots[take:]])
        return accepted

    def flush_rx(self) -> None:
        """Timeout-driven descriptor-cache writeback, all queues."""
        for ring in self.rx_queues:
            ring.flush()

    # -- wire-side TX drain (the loadgen pulls from every queue) -------------
    def drain_tx(self, max_n_per_queue: int) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for ring in self.tx_queues:
            out.extend(ring.drain(max_n_per_queue))
        return out

    def drain_tx_bursts(self, max_n_per_queue: int) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized drain across all TX queues → concatenated arrays."""
        slots_parts: List[np.ndarray] = []
        len_parts: List[np.ndarray] = []
        for ring in self.tx_queues:
            s, l = ring.drain_burst(max_n_per_queue)
            if len(s):
                slots_parts.append(s)
                len_parts.append(l)
        if not slots_parts:
            return _EMPTY_I64, _EMPTY_I32
        return np.concatenate(slots_parts), np.concatenate(len_parts)

    # -- aggregates / telemetry ----------------------------------------------
    @property
    def tx_pending(self) -> int:
        return sum(r.pending for r in self.tx_queues)

    @property
    def tx_posted(self) -> int:
        return sum(r.posted for r in self.tx_queues)

    @property
    def rx_delivered(self) -> int:
        return sum(r.delivered for r in self.rx_queues)

    @property
    def rx_dropped(self) -> int:
        return sum(r.dropped for r in self.rx_queues)

    def rx_queue_delivered(self) -> List[int]:
        return [r.delivered for r in self.rx_queues]

    def rx_queue_dropped(self) -> List[int]:
        return [r.dropped for r in self.rx_queues]

    def queue_occupancy(self) -> List[int]:
        """Per-RX-queue descriptor occupancy (the RSS-skew observable)."""
        return [r.in_flight for r in self.rx_queues]


class BypassL2FwdServer(NetworkStack):
    """Run-to-completion DPDK L2Fwd over N multi-queue ports.

    Each lcore quantum on a (port, queue) pair is one DPDK loop iteration:
    rx_burst → process in place → tx_burst on the same queue.  ``burst_size``
    is the DPDK burst knob the DCA use-case (paper §5.2) sweeps — pass a
    :class:`~repro_torch.core.dca.BurstPlan` for per-lcore bursts.  ``n_lcores``
    defaults to one lcore per (port, queue) pair.

    **DCA accumulate mode** (:meth:`enable_dca_accumulate`, virtual time
    only): the paper's Fig. 4(b) variant "waits until [burst] packets are
    received and then starts the forwarding".  A queue whose written-back
    backlog is below the lcore's burst is left to accumulate; the wait is
    bounded by a give-up deadline (``wait_timeout_ns`` past the first
    observation of a partial backlog, surfaced to the event loop through
    ``next_free_ns``), so tail packets are forwarded even when the offered
    train ends mid-burst.  This is what makes the burst-size knob move
    measured end-to-end RTT percentiles instead of only queue-occupancy
    proxies.
    """

    def __init__(
        self,
        ports: Sequence[Port],
        burst_size: int = 32,
        process_fn: Optional[ProcessFn] = None,
        burst_process_fn: Optional[BurstProcessFn] = None,
        n_lcores: Optional[int] = None,
        plan: Optional[object] = None,
    ):
        if burst_size <= 0:
            raise ValueError("burst_size must be positive")
        if process_fn is not None and burst_process_fn is not None:
            raise ValueError("pass either process_fn or burst_process_fn, not both")
        super().__init__(ports, n_lcores=n_lcores, burst_size=burst_size, plan=plan)
        self.burst_size = burst_size
        self.process_fn = process_fn
        # default: vectorized L2Fwd header rewrite over the whole burst
        self.burst_process_fn = burst_process_fn if burst_process_fn is not None else (
            None if process_fn is not None else swap_macs_vec
        )

    def _service_queue(self, lcore: Lcore, port_idx: int, queue_idx: int,
                       qstats: ServerStats) -> int:
        port = self.ports[port_idx]
        if self._dca_wait_ns is not None and self.clock is not None:
            ring = port.rx_queues[queue_idx]
            avail = ring.done_count
            key = (port_idx, queue_idx)
            if avail == 0:
                qstats.poll_iterations += 1
                qstats.empty_polls += 1
                self._queue_deadline.pop(key, None)
                return 0
            if self._dca_accumulate_wait(key, avail, lcore.burst_size):
                qstats.poll_iterations += 1
                return 0
        # the DPDK loop iteration, verbatim: rx_burst → process → tx_burst
        slots, lengths = port.rx_burst(queue_idx, lcore.burst_size)
        qstats.poll_iterations += 1
        n = len(slots)
        if n == 0:
            qstats.empty_polls += 1
            return 0
        qstats.record_burst(n)
        if self.burst_process_fn is not None:
            self.burst_process_fn(port.pool, slots, lengths)  # zero copy, amortized
        else:
            for slot, length in zip(slots, lengths):
                self.process_fn(port.pool.view(int(slot), int(length)))
        posted = port.tx_burst(queue_idx, slots, lengths)
        if posted < n:
            port.pool.free_burst([int(s) for s in slots[posted:]])  # TX full: drop
        qstats.rx_packets += n
        qstats.rx_bytes += int(lengths.sum())
        qstats.tx_packets += posted
        if self.clock is not None:
            # virtual-time mode: real code no longer sets the pace, so the
            # PMD loop's work is charged explicitly (empty polls are free —
            # a spinning PMD would otherwise never let simulated time end)
            self.charge_ns(self.sim_cost.pmd_burst_ns(n))
        return n


class PipelineServer(NetworkStack):
    """DPDK pipeline mode: RX lcore → worker lcore → TX lcore, linked by rings.

    The three stages are stage-lcores on the NetworkStack scheduler: a
    sequential ``poll_once`` runs rx → work → tx deterministically (the
    1-core measurement mode), while ``start()`` runs each stage in its own
    thread (GIL-serialized on a 1-core host; see DESIGN.md).  Multi-queue
    aware: the RX stage polls every RX queue and frames return on the TX
    queue they arrived on.
    """

    _RX, _WORK, _TX = 0, 1, 2

    def __init__(
        self,
        port: Port,
        process_fn: Optional[ProcessFn] = None,
        stage_ring_capacity: int = 1024,
        burst_size: int = 32,
    ):
        super().__init__([port], n_lcores=1, burst_size=burst_size)
        # stage lcores replace the default queue-parallel layout
        all_queues = [(0, qi) for qi in range(port.n_queues)]
        self.lcores = [Lcore(self._RX, all_queues, burst_size),
                       Lcore(self._WORK, all_queues, burst_size),
                       Lcore(self._TX, all_queues, burst_size)]
        self.port = port
        self.burst_size = burst_size
        self.process_fn = process_fn if process_fn is not None else swap_macs
        self.rx_to_work = SpscRing(stage_ring_capacity)
        self.work_to_tx = SpscRing(stage_ring_capacity)

    # each stage is a polling pass — no blocking anywhere
    def run_lcore(self, lcore: Lcore) -> int:
        if lcore.lcore_id == self._RX:
            return self._rx_pass(lcore.burst_size)
        if lcore.lcore_id == self._WORK:
            return self._work_pass(lcore.burst_size)
        return self._tx_pass(lcore.burst_size)

    def _rx_pass(self, burst: int) -> int:
        # DCA accumulate-then-forward parity with the bypass stack (virtual
        # time only): a queue whose written-back backlog is below the RX
        # stage's burst is left to accumulate, bounded by the give-up
        # deadline, before the stage pushes anything downstream.
        accumulate = self._dca_wait_ns is not None and self.clock is not None
        for qi, ring in enumerate(self.port.rx_queues):
            qstats = self.queue_stats[(0, qi)]
            if accumulate:
                avail = ring.done_count
                key = (0, qi)
                if avail == 0:
                    qstats.poll_iterations += 1
                    qstats.empty_polls += 1
                    self._queue_deadline.pop(key, None)
                    continue
                if self._dca_accumulate_wait(key, avail, burst):
                    qstats.poll_iterations += 1
                    continue
            batch = ring.poll(burst)
            qstats.poll_iterations += 1
            if not batch:
                qstats.empty_polls += 1
                continue
            qstats.record_burst(len(batch))
            items = [(slot, length, qi) for slot, length in batch]
            pushed = self.rx_to_work.push_burst(items)
            for slot, _len, _q in items[pushed:]:
                self.port.pool.free(slot)  # stage ring full → drop
        return 0

    def _work_pass(self, burst: int) -> int:
        batch = self.rx_to_work.pop_burst(burst)
        for slot, length, qi in batch:
            self.process_fn(self.port.pool.view(slot, length))
            qstats = self.queue_stats[(0, qi)]
            qstats.rx_packets += 1
            qstats.rx_bytes += length
        if batch:
            pushed = self.work_to_tx.push_burst(batch)
            for slot, _len, _q in batch[pushed:]:
                self.port.pool.free(slot)  # stage ring full → drop
            if self.clock is not None:
                # the worker stage carries the per-packet processing cost;
                # rx/tx stages are descriptor shuffling (folded into it)
                self.charge_ns(self.sim_cost.pmd_burst_ns(len(batch)))
        return len(batch)

    def _tx_pass(self, burst: int) -> int:
        batch = self.work_to_tx.pop_burst(burst)
        for slot, length, qi in batch:
            if self.port.tx_queues[qi].post(slot, length):
                self.queue_stats[(0, qi)].tx_packets += 1
            else:
                self.port.pool.free(slot)
        return 0

    # seed-era thread API, now on the shared lcore-thread machinery
    def start(self) -> None:
        self.start_lcore_threads()

    def stop(self) -> None:
        self.stop_lcore_threads()
