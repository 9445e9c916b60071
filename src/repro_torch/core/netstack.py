"""Unified NetworkStack interface: per-lcore engines over (port, queue) pairs.

DPDK's execution model assigns each *lcore* (logical core) a set of
(port, queue) pairs that it polls run-to-completion; with RSS steering flows
to queues, cores scale without sharing — the paper's Fig. 3(a) core axis.
This module is the common machinery all three servers
(:class:`~repro_torch.core.pmd.BypassL2FwdServer`,
:class:`~repro_torch.core.pmd.PipelineServer`,
:class:`~repro.core.kernel_stack.KernelStackServer`) now run on:

* :class:`Lcore` — one engine: an ordered list of (port, queue) assignments
  plus its processing burst size (per-lcore via
  :class:`~repro.core.dca.BurstPlan`).
* :class:`NetworkStack` — owns the lcores and per-queue
  :class:`ServerStats`.  ``poll_once`` schedules the lcores **sequentially
  round-robin**, which is GIL-aware and deterministic: on a 1-core host it
  measures exactly one core's worth of work in a reproducible order.
  Threads are optional (``start_lcore_threads``) for hosts with real
  parallelism.

Stats discipline: every (port, queue) pair has its own :class:`ServerStats`
written by exactly one lcore (no sharing, like DPDK's per-queue counters);
``stack.stats`` aggregates them on read, so the seed-era single-stats API
keeps working.

Virtual-time mode: :meth:`NetworkStack.attach_clock` installs a
:class:`~repro_torch.core.simclock.SimClock`.  Each lcore then carries its own
*busy-until* timestamp: costs charged while it services queues
(:meth:`NetworkStack.charge_ns`) extend that lcore's busy window instead of
busy-waiting the host, and :meth:`NetworkStack.poll_at` only runs lcores
whose busy window has passed.  N lcores therefore process packets in
*parallel virtual time* even on a 1-core GIL-bound host — which is what lets
the Fig. 3(a) core-scaling axis actually scale in this container.

Own copy, in the PyTorch port, of ``src/repro/core/netstack.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost import HostCostModel, spin_ns
from .simclock import SimClock

# Power-of-two burst-size bins: bucket i counts bursts of [2^i, 2^(i+1)).
# Fixed size => stats memory is O(1) regardless of run length.
N_BURST_BUCKETS = 12


@dataclass
class ServerStats:
    rx_packets: int = 0
    tx_packets: int = 0
    rx_bytes: int = 0
    poll_iterations: int = 0
    empty_polls: int = 0
    burst_count: int = 0
    burst_packets: int = 0
    burst_buckets: np.ndarray = field(
        default_factory=lambda: np.zeros(N_BURST_BUCKETS, dtype=np.int64)
    )

    def record_burst(self, n: int) -> None:
        self.burst_count += 1
        self.burst_packets += int(n)
        self.burst_buckets[min(max(int(n), 1).bit_length() - 1,
                               N_BURST_BUCKETS - 1)] += 1

    @property
    def avg_burst(self) -> float:
        return self.burst_packets / self.burst_count if self.burst_count else 0.0

    @property
    def burst_histogram(self) -> List[Dict[str, int]]:
        """Fixed-bin view of burst sizes: [{lo, hi, count}], empty bins omitted."""
        return [
            {"lo": 1 << i, "hi": (1 << (i + 1)) - 1, "count": int(c)}
            for i, c in enumerate(self.burst_buckets)
            if c
        ]

    def merge_from(self, other: "ServerStats") -> "ServerStats":
        """Accumulate another stats object (per-queue → aggregate).

        Exhaustive over the dataclass fields: numeric fields add, array
        fields add elementwise, and anything else raises — a stats subclass
        adding a field of an unmergeable type must override this method
        rather than have its counters silently dropped from aggregates.
        """
        for f in dataclasses.fields(other):
            v = getattr(other, f.name)
            if isinstance(v, np.ndarray):
                getattr(self, f.name).__iadd__(v)
            elif isinstance(v, (int, float, np.integer, np.floating)):
                setattr(self, f.name, getattr(self, f.name, 0) + v)
            else:
                raise TypeError(
                    f"{type(self).__name__}.merge_from cannot merge field "
                    f"{f.name!r} of type {type(v).__name__}; override "
                    "merge_from in the subclass")
        return self


@dataclass
class Lcore:
    """One polling engine: services its (port_idx, queue_idx) pairs in order."""

    lcore_id: int
    assignments: List[Tuple[int, int]]
    burst_size: int = 32


class NetworkStack:
    """Base class every server implements: lcores + per-queue stats.

    Subclasses implement :meth:`_service_queue` (one lcore quantum on one
    queue) or override :meth:`run_lcore` for non-queue-parallel topologies
    (the pipeline's stage lcores).
    """

    stats_cls = ServerStats

    def __init__(
        self,
        ports: Sequence[object],
        n_lcores: Optional[int] = None,
        burst_size: int = 32,
        plan: Optional[object] = None,  # duck-typed BurstPlan (burst_for)
    ):
        self.ports = list(ports)
        self.queue_pairs: List[Tuple[int, int]] = [
            (pi, qi)
            for pi, p in enumerate(self.ports)
            for qi in range(getattr(p, "n_queues", 1))
        ]
        if n_lcores is None:
            n_lcores = len(self.queue_pairs)  # DPDK default: one lcore per queue
        if n_lcores < 1:
            raise ValueError("n_lcores must be >= 1")
        if plan is not None and hasattr(plan, "validate_lcores"):
            # a per_lcore tuple must name exactly one burst per lcore —
            # silent modulo recycling misassigns bursts (see BurstPlan)
            plan.validate_lcores(n_lcores)
        self.lcores: List[Lcore] = []
        for i in range(n_lcores):
            assigned = [pr for j, pr in enumerate(self.queue_pairs)
                        if j % n_lcores == i]
            b = plan.burst_for(i) if plan is not None else burst_size
            self.lcores.append(Lcore(i, assigned, b))
        self.queue_stats: Dict[Tuple[int, int], ServerStats] = {
            pr: self.stats_cls() for pr in self.queue_pairs
        }
        self._stop_evt = threading.Event()
        self._threads: List[threading.Thread] = []
        # virtual-time state (installed by attach_clock; None == wall-clock)
        self.clock: Optional[SimClock] = None
        self.sim_cost: HostCostModel = HostCostModel()
        self._lcore_next_free: List[int] = []
        self._accum_ns: float = 0.0
        self._poll_now_ns: int = 0  # virtual now of the current poll_at round
        # per-(port, queue) give-up deadlines for stacks that *accumulate*
        # toward a full burst before forwarding (the Fig. 4 DCA semantics);
        # next_free_ns surfaces them so event loops advance time to them
        self._queue_deadline: Dict[Tuple[int, int], int] = {}
        self._dca_wait_ns: Optional[int] = None

    # -- DCA accumulate-then-forward (paper Fig. 4(b)) ------------------------
    def enable_dca_accumulate(self, wait_timeout_ns: int) -> "NetworkStack":
        """Turn on Fig. 4 accumulate-then-forward: a queue whose written-back
        backlog is below the servicing burst size is left to accumulate, with
        a give-up deadline ``wait_timeout_ns`` past the first observation of a
        partial backlog (surfaced to event loops via :meth:`next_free_ns`).
        Only meaningful with an attached SimClock — wall-clock mode ignores
        it, there the host's real pacing is the measurement."""
        if wait_timeout_ns < 0:
            raise ValueError("wait_timeout_ns must be >= 0")
        self._dca_wait_ns = int(wait_timeout_ns)
        return self

    def _dca_accumulate_wait(self, key: Tuple[int, int], avail: int,
                             burst: int) -> bool:
        """Accumulate-gate decision for one nonempty queue: True → leave the
        backlog to keep growing toward a full burst.  Maintains the per-queue
        give-up deadline (armed at first sight of a partial backlog, cleared
        on forward)."""
        if avail >= burst:
            self._queue_deadline.pop(key, None)
            return False
        now = self._poll_now_ns
        deadline = self._queue_deadline.get(key)
        if deadline is None:
            # first sight of a partial burst: start the give-up timer
            self._queue_deadline[key] = now + self._dca_wait_ns
            return True
        if now < deadline:
            return True
        # deadline expired: forward the partial burst (bounds the worst-case
        # latency of a train that ends mid-burst)
        self._queue_deadline.pop(key, None)
        return False

    # -- virtual time ---------------------------------------------------------
    def attach_clock(self, clock: SimClock,
                     cost: Optional[HostCostModel] = None) -> "NetworkStack":
        """Switch the stack to virtual-time execution.

        ``cost`` supplies the polling-path cycle figures
        (``pmd_poll_cycles``/``pmd_per_packet_cycles``) charged per serviced
        burst; interrupt-driven stacks keep charging their own constructor
        cost model, just onto the clock instead of a busy-wait.
        """
        self.clock = clock
        if cost is not None:
            self.sim_cost = cost
        self._lcore_next_free = [clock.now_ns] * len(self.lcores)
        return self

    def charge_ns(self, ns: float) -> None:
        """Account ``ns`` of host work on the currently-running lcore.

        Wall-clock mode burns it for real (:func:`spin_ns`); virtual-time
        mode accumulates it into the lcore's busy window (applied by
        :meth:`poll_at` when the lcore quantum finishes).
        """
        if self.clock is None:
            spin_ns(ns)
        else:
            self._accum_ns += ns

    def poll_at(self, now_ns: int) -> int:
        """One virtual-time scheduling round at ``now_ns``: every lcore whose
        busy window has passed runs once; the costs it charges push its
        next-free time forward.  Falls back to :meth:`poll_once` when no
        clock is attached."""
        if self.clock is None:
            return self.poll_once()
        self._poll_now_ns = now_ns
        total = 0
        for i, lcore in enumerate(self.lcores):
            if self._lcore_next_free[i] > now_ns:
                continue  # core still busy with earlier packets
            self._accum_ns = 0.0
            total += self.run_lcore(lcore)
            if self._accum_ns > 0:
                self._lcore_next_free[i] = now_ns + int(round(self._accum_ns))
        return total

    def next_free_ns(self, now_ns: int) -> Optional[int]:
        """Earliest future time any busy lcore frees up, or any queue's
        burst-accumulation deadline expires (None if neither) — the event
        the load generator waits on when the wire is quiet."""
        future = [t for t in self._lcore_next_free if t > now_ns]
        future += [t for t in self._queue_deadline.values() if t > now_ns]
        return min(future) if future else None

    # -- scheduling -----------------------------------------------------------
    def poll_once(self) -> int:
        """One scheduling round: every lcore runs once, sequentially.

        Deterministic (fixed lcore order, fixed assignment order within each
        lcore) so single-core measurements are exactly reproducible.
        """
        total = 0
        for lcore in self.lcores:
            total += self.run_lcore(lcore)
        return total

    def run_lcore(self, lcore: Lcore) -> int:
        """One run-to-completion pass over the lcore's assigned queues."""
        total = 0
        for pi, qi in lcore.assignments:
            total += self._service_queue(lcore, pi, qi, self.queue_stats[(pi, qi)])
        return total

    def _service_queue(self, lcore: Lcore, port_idx: int, queue_idx: int,
                       qstats: ServerStats) -> int:
        raise NotImplementedError

    # -- optional threaded execution (real-parallelism hosts) -----------------
    def start_lcore_threads(self) -> None:
        """Run each lcore in its own thread (GIL-serialized on 1-core hosts;
        use sequential ``poll_once`` for bandwidth numbers there)."""
        if self.clock is not None:
            # threads pace themselves on the host clock; with a SimClock
            # attached, charges would race on _accum_ns and never apply to
            # any lcore busy window — measurements would silently be wrong
            raise RuntimeError(
                "lcore threads are a wall-clock execution mode; build the "
                "testbed with TrafficConfig(sim_time=False) (or don't "
                "attach_clock) before start_lcore_threads()")
        if self._threads:
            return
        self._stop_evt.clear()

        def loop(lc: Lcore) -> None:
            while not self._stop_evt.is_set():
                self.run_lcore(lc)

        self._threads = [
            threading.Thread(target=loop, args=(lc,), daemon=True,
                             name=f"lcore-{lc.lcore_id}")
            for lc in self.lcores
        ]
        for t in self._threads:
            t.start()

    def stop_lcore_threads(self) -> None:
        self._stop_evt.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    # -- stats ----------------------------------------------------------------
    def per_queue_stats(self) -> Dict[Tuple[int, int], ServerStats]:
        """Per-(port, queue) counters; each written by exactly one lcore."""
        return dict(self.queue_stats)

    @property
    def stats(self) -> ServerStats:
        """Aggregate across all queues (seed-compatible single-stats view)."""
        agg = self.stats_cls()
        for st in self.queue_stats.values():
            agg.merge_from(st)
        return agg
