"""Epoch-batched fast path for the open-loop virtual-time simulation.

:meth:`repro_torch.core.loadgen.LoadGen.run_sim` advances the sim event by event —
every emission, wire hop, RSS steer, descriptor writeback, harvest, and TX
drain is a Python-level round, which caps throughput near ~1e5 simulated
packets/s.  This engine advances the same run one *epoch* at a time
(SimBricks-style: the epoch length is never below the minimum link latency,
scaled up so each pass covers ~64k packets) and processes each epoch's slice
of the analytic emission schedule as whole-array passes
(:mod:`repro_torch.kernels.epoch_pass`):

* **emission → arrival**: the FIFO wire recursion closed into one
  cumsum + cummax pass per port (bit-identical to per-frame
  :meth:`~repro_torch.core.simclock.Wire.transmit` calls);
* **steer**: RSS queue choice as a gather through a per-flow-id queue table
  (the loadgen's synthetic flow tuples cycle mod ``n_flows``, so the
  Toeplitz hash + indirection lookup is hoisted out of the per-packet path);
* **writeback**: with no ring-full event, descriptor publishes are
  poll-independent — the k-th writeback of a queue happens exactly when its
  ``k*W``-th frame arrives (threshold ``W``), so publish times are a strided
  slice of the arrival array;
* **harvest/charge**: each lcore's service history is a short burst-level
  cascade — ``t = max(lcore_free, earliest publish)``, harvest
  ``min(burst, backlog)`` per assigned queue in order, accumulate
  ``pmd_burst_ns`` in Python floats exactly like
  :meth:`~repro_torch.core.netstack.NetworkStack.poll_at`, then
  ``free = t + int(round(accum))`` — followed by a terminal flush phase at
  ``T_flush = max(last arrival, all lcore frees)`` mirroring the event
  loop's quiet-wire ``flush_rx``;
* **drain/RTT**: TX drains happen in the same round as the harvest that
  posted them, so return-wire arrivals are one more array pass per port,
  with RTTs recorded in the event loop's global (time, port, queue) order
  (latency stats such as ``np.mean`` are float-order-sensitive).

**Exactness contract**: the engine plans the whole run *purely* (no state
mutated), validates that the run stays inside the fast-path regime — no RX
ring ever fills (no drops, no full-triggered writeback), the packet pool
never exhausts, no writeback-timeout timers, no DCA accumulate mode, default
burst transform — and only then commits counters, latency samples, meter
windows, lcore busy times, and the final clock in one step.  Any unsupported
configuration or validation failure falls back to ``loadgen.run_sim`` before
anything is touched, so **RunReports are bit-identical to the event loop in
every case** — either computed by the closed forms proven equivalent, or by
the event loop itself.

Known (documented) divergences outside the RunReport: per-queue
``ServerStats.poll_iterations``/``empty_polls`` count only harvesting polls
(the event loop also counts empty polls each round), and internal ring/arena
arrays (slot contents, frame bytes) are not written since no report reads
them.  Pool free-list order after a run also differs (frames are never
actually allocated).

Own copy, in the PyTorch port, of ``src/repro/core/fastpath.py``: the same
numpy and plain Python, with these changes.

* **Where the pass runs.** :func:`run_epoch_sim` takes ``device`` in place of
  the reference's ``use_jax``. ``"cuda"`` (the default) runs the epoch pass
  as the hand-written CUDA kernel (``kernels/csrc/epoch_pass.cu``), ``"cpu"``
  runs its plain torch version, and None runs the numpy pass. The engine
  names map so: the reference's ``engine="epoch"`` is the port's
  ``device=None`` (``info.engine == "epoch"``); its ``engine="epoch-jit"``
  (``use_jax=True``) is the port's ``device="cuda"`` or ``"cpu"``
  (``info.engine == "epoch-torch"``), and ``EpochRunInfo.used_jax`` is
  ``pass_device`` (the pass's device, None for numpy). All three passes
  give the same bits.
* **No fallback that hides the pass.** The reference falls back to the event
  loop on any exception while planning, which is how it survives a broken
  JAX pass. Here an error raised by the pass, or by its device, propagates:
  ``device="cuda"`` raises where no CUDA device is present or the kernel
  fails to build or launch, and never runs another pass instead. The
  configuration-driven fallbacks stay as they are, the closed
  :data:`EPOCH_FALLBACK_REASONS` and ``"planning failed: ..."`` for the
  planner's own numpy work: they are the simulator's semantics, and keep
  RunReports bit-identical to the event loop.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..kernels.epoch_pass import (epoch_pass_np, make_pass,
                                  serialization_ns_vec, wire_arrival_pass_np)
from .packet import DEFAULT_DST_IP, DEFAULT_SRC_IP_BASE, swap_macs_vec
from .pmd import BypassL2FwdServer
from .simclock import SimClock
from .telemetry import RunReport

__all__ = ["EpochRunInfo", "EPOCH_FALLBACK_REASONS", "PARTITIONED_REASON",
           "run_epoch_sim", "iter_epoch_slices", "default_epoch_ns",
           "validate_epoch_fallback_reason"]

# fallback-taxonomy reason for topology runs executing under a partition
# engine (TopologyConfig.partition != "shared-clock"): domains advance on
# private clocks, so the single-testbed epoch planner does not apply.  The
# run falls back cleanly to the (partitioned) event loop and surfaces this
# reason in EpochRunInfo rather than erroring.
PARTITIONED_REASON = "partitioned domain execution"

# The closed taxonomy of epoch fallback reasons.  Every string assigned to
# ``EpochRunInfo.fallback_reason`` must be one of these literals or match
# one of the parameterized patterns below — a typo'd or ad-hoc reason fails
# loudly at assignment instead of silently fragmenting the taxonomy that
# ``tests/test_fallback_taxonomy.py`` and sweep tooling key on.
EPOCH_FALLBACK_REASONS: Tuple[str, ...] = (
    "no SimClock attached",
    "custom packet-processing function",
    "DCA accumulate mode",
    "pending queue accumulation deadlines",
    "integrity verification enabled",
    "DCTCP rate-adaptive loadgen active",
    "pending scheduler events",
    "no ports",
    "server and loadgen port lists differ",
    "zero-cost host model",
    "writeback-timeout timers armed",
    "writeback DMA latency armed",
    "RX ring not idle",
    "TX ring not idle",
    "lcore burst exceeds loadgen max_tx_burst (TX would linger)",
    "lcore burst exceeds TX ring size",
    "RX ring would fill (overflow writeback/drop regime)",
    "packet pool would exhaust",
    PARTITIONED_REASON,
)

# reasons carrying an interpolated server type / exception repr
_EPOCH_REASON_PATTERNS = (
    re.compile(r"server type \S+ is not BypassL2FwdServer"),
    re.compile(r"planning failed: .*", re.DOTALL),
)


def validate_epoch_fallback_reason(reason: Optional[str]) -> None:
    """Raise ``ValueError`` unless ``reason`` is None, a literal from
    :data:`EPOCH_FALLBACK_REASONS`, or matches a parameterized pattern."""
    if reason is None or reason in EPOCH_FALLBACK_REASONS:
        return
    for pat in _EPOCH_REASON_PATTERNS:
        if pat.fullmatch(reason):
            return
    raise ValueError(
        f"unknown epoch fallback reason {reason!r}: not in the closed "
        "EPOCH_FALLBACK_REASONS taxonomy (repro_torch.core.fastpath)")

# target packets per epoch pass: large enough to amortize numpy/torch dispatch,
# small enough that slicing is exercised (and memory stays bounded per pass)
_EPOCH_TARGET_PKTS = 1 << 16


def iter_epoch_slices(times: np.ndarray, epoch_ns: int,
                      ) -> Iterator[Tuple[int, int]]:
    """Yield (lo, hi) index pairs slicing a sorted emission schedule into
    epochs of ``epoch_ns``: slice k covers times in
    ``[t0 + k*epoch_ns, t0 + (k+1)*epoch_ns)``.  Empty epochs are skipped;
    the slices partition ``[0, len(times))`` in order (no packet lost or
    reordered at a boundary)."""
    n = len(times)
    if n == 0:
        return
    if epoch_ns <= 0:
        yield 0, n
        return
    t0 = int(times[0])
    lo = 0
    while lo < n:
        k = (int(times[lo]) - t0) // epoch_ns
        bound = t0 + (k + 1) * epoch_ns
        hi = int(np.searchsorted(times, bound, side="left"))
        if hi <= lo:  # defensive: always make progress
            hi = lo + 1
        yield lo, hi
        lo = hi


def default_epoch_ns(ports, times: np.ndarray) -> int:
    """SimBricks-style epoch bound: at least the minimum (nonzero) link
    latency across the ports, scaled up so the run is covered in roughly
    ``_EPOCH_TARGET_PKTS``-packet passes."""
    n = len(times)
    if n == 0:
        return 1
    lats = [int(getattr(p, "link_latency_ns", 0)) for p in ports]
    base = min((l for l in lats if l > 0), default=0)
    span = int(times[-1]) - int(times[0]) + 1
    n_chunks = max(1, -(-n // _EPOCH_TARGET_PKTS))
    chunk = -(-span // n_chunks)
    return max(1, base, chunk)


@dataclass
class EpochRunInfo:
    """Out-of-band run descriptor (NOT in the RunReport, which must stay
    bit-identical across engines).  Pass an instance to :func:`run_epoch_sim`
    to learn whether the fast path ran and why it fell back."""

    engine: str = "epoch"
    fastpath: bool = False
    fallback_reason: Optional[str] = None
    pass_device: Optional[str] = None
    n_epochs: int = 0
    n_packets: int = 0

    def __setattr__(self, name: str, value) -> None:
        # dataclass __init__ assigns via setattr, so construction-time
        # reasons are validated too
        if name == "fallback_reason":
            validate_epoch_fallback_reason(value)
        object.__setattr__(self, name, value)


class _QueuePlan:
    """Planned per-(port, queue) arrival stream + harvest history."""

    __slots__ = ("pi", "qi", "ring", "arr", "orig", "n", "W", "n_full",
                 "batch_times", "pos", "wb_ptr", "tail_time", "harvests")

    def __init__(self, pi: int, qi: int, ring, arr: np.ndarray,
                 orig: np.ndarray):
        self.pi, self.qi, self.ring = pi, qi, ring
        self.arr = arr      # arrival times at the NIC, sorted (wire FIFO)
        self.orig = orig    # global emission indices, arrival order
        self.n = len(arr)
        thr = ring.writeback_threshold
        self.W = ring.size if thr is None else int(thr)
        self.n_full = self.n // self.W
        # the k-th threshold writeback publishes when frame (k+1)*W-1 lands
        self.batch_times = arr[self.W - 1::self.W][:self.n_full]
        self.pos = 0         # descriptors harvested so far (the PMD tail)
        self.wb_ptr = 0      # full batches published by current cascade time
        self.tail_time: Optional[int] = None  # T_flush once the tail phase runs
        self.harvests: List[Tuple[int, int]] = []  # [(t, n)], time order

    def next_pub_time(self) -> Optional[int]:
        """When the first not-yet-harvested descriptor becomes PMD-visible."""
        if self.pos < self.n_full * self.W:
            return int(self.batch_times[self.pos // self.W])
        if self.tail_time is not None and self.pos < self.n:
            return self.tail_time
        return None

    def published_at(self, t: int) -> int:
        """Total descriptors written back at time <= t (t must be
        non-decreasing across calls — it is, per lcore)."""
        while self.wb_ptr < self.n_full and self.batch_times[self.wb_ptr] <= t:
            self.wb_ptr += 1
        if self.tail_time is not None and t >= self.tail_time:
            return self.n
        return self.wb_ptr * self.W


@dataclass
class _Plan:
    """Everything the commit step needs, computed without side effects."""

    n: int
    start: int
    open_window_at: int = 0
    sizes: Optional[np.ndarray] = None
    qplans: List[_QueuePlan] = field(default_factory=list)
    lcore_free: List[int] = field(default_factory=list)
    final_now: int = 0
    rtts: Optional[np.ndarray] = None
    meter_bytes: int = 0
    meter_start: int = 0
    meter_end: int = 0


def _fallback_reason(lg, server, sched) -> Optional[str]:
    """None when the config is inside the fast-path regime, else why not."""
    if type(server) is not BypassL2FwdServer:
        return f"server type {type(server).__name__} is not BypassL2FwdServer"
    if server.clock is None:
        return "no SimClock attached"
    if server.process_fn is not None or server.burst_process_fn is not swap_macs_vec:
        return "custom packet-processing function"
    if server._dca_wait_ns is not None:
        return "DCA accumulate mode"
    if server._queue_deadline:
        return "pending queue accumulation deadlines"
    if lg.verify_integrity:
        return "integrity verification enabled"
    if getattr(lg, "cc", None) is not None:
        # DCTCP adapts the offered rate mid-trial on echo feedback; the
        # epoch planner precomputes the whole emission schedule up front
        return "DCTCP rate-adaptive loadgen active"
    if sched is not None and len(sched) > 0:
        return "pending scheduler events"
    if not lg.ports:
        return "no ports"
    if len(server.ports) != len(lg.ports) or any(
            a is not b for a, b in zip(server.ports, lg.ports)):
        return "server and loadgen port lists differ"
    # a harvest must advance the lcore's busy window or the event loop polls
    # the same instant forever; the cascade's termination leans on this too
    if int(round(server.sim_cost.pmd_burst_ns(1))) < 1:
        return "zero-cost host model"
    for port in lg.ports:
        for ring in port.rx_queues:
            if ring._sched is not None and ring._timeout_ns > 0:
                return "writeback-timeout timers armed"
            if ring._sched is not None and ring._dma_ns > 0:
                return "writeback DMA latency armed"
            if ring.head != ring.tail or ring.published != ring.tail \
                    or ring._cached != 0 or ring._dma_pending != 0:
                return "RX ring not idle"
        for ring in port.tx_queues:
            if ring.pending != 0:
                return "TX ring not idle"
    for lc in server.lcores:
        if lc.burst_size > lg.max_tx_burst:
            return "lcore burst exceeds loadgen max_tx_burst (TX would linger)"
        for pi, qi in lc.assignments:
            if lc.burst_size > lg.ports[pi].tx_queues[qi].size:
                return "lcore burst exceeds TX ring size"
    return None


def _flow_queue_table(port, n_flows: int, src_ip_base: Optional[int],
                      dst_ip: Optional[int]) -> Optional[np.ndarray]:
    """Per-flow-id RSS queue table for one port (None for single-queue).

    Builds the same big-endian flow-tuple bytes as
    :func:`repro_torch.core.packet.write_flow_ids_vec` and steers them through the
    port's real Toeplitz hash + indirection table, so the gathered queue of
    frame ``seq`` equals ``rss.steer_one(read_flow_bytes(...))`` bit-for-bit.
    """
    if port.n_queues <= 1:
        return None
    ids = np.arange(n_flows, dtype=np.int64)
    base = DEFAULT_SRC_IP_BASE if src_ip_base is None else int(src_ip_base)
    dst = DEFAULT_DST_IP if dst_ip is None else int(dst_ip)
    mat = np.empty((n_flows, 12), dtype=np.uint8)
    mat[:, 0:4] = (base | (ids & 0xFFFF)).astype(">u4").view(np.uint8).reshape(-1, 4)
    mat[:, 4:8] = np.full(n_flows, dst, dtype=">u4").view(np.uint8).reshape(-1, 4)
    mat[:, 8:10] = (1024 + (ids % 60000)).astype(">u2").view(np.uint8).reshape(-1, 2)
    mat[:, 10:12] = np.full(n_flows, 443, dtype=">u2").view(np.uint8).reshape(-1, 2)
    return port.rss.steer(mat).astype(np.int64)


def _cascade(group: List[_QueuePlan], free: int, burst: int, cost_fn,
             events: List[Tuple[int, _QueuePlan, int, int]]) -> int:
    """Replay one lcore's harvest history against its planned queues.

    Each iteration is one event-loop round the lcore actually harvests in:
    the earliest time both the lcore is free and something is published.
    Queues are serviced in assignment order with the same float cost
    accumulation as ``poll_at`` (order matters for the final rounding).
    """
    while True:
        t_next: Optional[int] = None
        for qp in group:
            pt = qp.next_pub_time()
            if pt is not None and (t_next is None or pt < t_next):
                t_next = pt
        if t_next is None:
            return free
        t = t_next if t_next > free else free
        accum = 0.0
        for qp in group:
            avail = qp.published_at(t) - qp.pos
            if avail <= 0:
                continue
            h = burst if avail > burst else avail
            events.append((t, qp, qp.pos, h))
            qp.harvests.append((t, h))
            qp.pos += h
            accum += cost_fn(h)
        free = t + int(round(accum))


class _PassFailed(Exception):
    """An error raised by the epoch pass or its device, carried past the
    fallback that catches the planner's own errors (its ``__cause__``)."""


def _build_plan(lg, server, pattern, clock, duration_s: float,
                epoch_ns: Optional[int], pass_fn,
                info: EpochRunInfo) -> Optional[_Plan]:
    """Pure planning pass: returns a complete :class:`_Plan`, or None (with
    ``info.fallback_reason`` set) when a validation shows the run would
    leave the fast-path regime.  Mutates nothing.  ``pass_fn`` has
    ``epoch_pass_np``'s signature; an error it raises comes out as
    :class:`_PassFailed`."""
    rng = np.random.default_rng(pattern.seed)
    times, sizes = pattern.emission_schedule(int(duration_s * 1e9), rng)
    n = len(times)
    start = clock.now_ns
    info.n_packets = n
    if n == 0:
        return _Plan(n=0, start=start, final_now=start)
    times_abs = times + start

    if epoch_ns is None:
        epoch_ns = default_epoch_ns(lg.ports, times_abs)

    ports = lg.ports
    nports = len(ports)
    seq0 = lg._next_seq
    qplans: Dict[Tuple[int, int], _QueuePlan] = {}
    empty_i64 = np.empty(0, dtype=np.int64)

    # -- phase A: per-port wire pass + RSS split over epoch slices ----------
    for pi, port in enumerate(ports):
        e_p = times_abs[pi::nports]
        orig_p = np.arange(pi, n, nports, dtype=np.int64)
        sz_p = sizes[pi::nports]
        gbps = float(getattr(port, "link_gbps", 0.0))
        lat = int(getattr(port, "link_latency_ns", 0))
        if len(e_p) == 0:
            for qi in range(port.n_queues):
                qplans[(pi, qi)] = _QueuePlan(pi, qi, port.rx_queues[qi],
                                              empty_i64, empty_i64)
            continue
        ser_p = serialization_ns_vec(sz_p, gbps)
        table = _flow_queue_table(port, lg.n_flows, lg.src_ip_base, lg.dst_ip)
        fids = ((seq0 + orig_p) % lg.n_flows) if table is not None else None
        busy = 0
        arr_parts: List[np.ndarray] = []
        q_parts: List[np.ndarray] = []
        for lo, hi in iter_epoch_slices(e_p, epoch_ns):
            try:
                a, busy, q = pass_fn(e_p[lo:hi], ser_p[lo:hi], busy, lat, table,
                                     None if fids is None else fids[lo:hi])
            except Exception as exc:
                raise _PassFailed() from exc
            arr_parts.append(np.asarray(a))
            if q is not None:
                q_parts.append(np.asarray(q))
            info.n_epochs += 1
        arr_p = np.concatenate(arr_parts)
        if table is None:
            qplans[(pi, 0)] = _QueuePlan(pi, 0, port.rx_queues[0], arr_p, orig_p)
        else:
            q_all = np.concatenate(q_parts)
            for qi in range(port.n_queues):
                mask = q_all == qi
                qplans[(pi, qi)] = _QueuePlan(pi, qi, port.rx_queues[qi],
                                              arr_p[mask], orig_p[mask])

    # -- phase B: per-lcore harvest cascade + terminal flush ----------------
    cost_fn = server.sim_cost.pmd_burst_ns
    lcore_free = list(server._lcore_next_free)
    events: List[Tuple[int, _QueuePlan, int, int]] = []
    for i, lc in enumerate(server.lcores):
        group = [qplans[pr] for pr in lc.assignments]
        lcore_free[i] = _cascade(group, lcore_free[i], lc.burst_size,
                                 cost_fn, events)
    a_last = max(int(qp.arr[-1]) for qp in qplans.values() if qp.n)
    # the event loop's quiet-wire flush_rx fires once no emission, wire
    # arrival, or future lcore-free candidate remains
    t_flush = max([a_last] + lcore_free)
    for qp in qplans.values():
        qp.tail_time = t_flush
    for i, lc in enumerate(server.lcores):
        group = [qplans[pr] for pr in lc.assignments]
        lcore_free[i] = _cascade(group, lcore_free[i], lc.burst_size,
                                 cost_fn, events)
    final_now = max([t_flush] + lcore_free)

    # -- validation 1: no RX ring ever fills --------------------------------
    # before accepting arrival j (0-indexed), in_flight is j minus harvests
    # strictly earlier (same-round harvests run after delivery); require the
    # post-accept occupancy j+1-hb to stay < size, which rules out both the
    # drop path and the full-triggered early writeback
    for qp in qplans.values():
        if qp.n == 0:
            continue
        ht = np.fromiter((t for t, _ in qp.harvests), dtype=np.int64,
                         count=len(qp.harvests))
        hc = np.cumsum(np.fromiter((h for _, h in qp.harvests),
                                   dtype=np.int64, count=len(qp.harvests)))
        idx = np.searchsorted(ht, qp.arr, side="left")
        hb = np.where(idx > 0, hc[np.maximum(idx - 1, 0)], 0)
        occ = np.arange(1, qp.n + 1, dtype=np.int64) - hb
        if int(occ.max()) >= qp.ring.size:
            info.fallback_reason = (
                "RX ring would fill (overflow writeback/drop regime)")
            return None

    # -- validation 2: the packet pool never exhausts -----------------------
    # +1 at each emission, -1 at the harvest round that drains the frame
    # (the event loop frees at drain time, not at return-wire arrival);
    # same-time allocs precede frees (loop step order: emit ... drain)
    free_t = np.empty(n, dtype=np.int64)
    for t, qp, s, h in events:
        free_t[qp.orig[s:s + h]] = t
    pool_ports: Dict[int, Tuple[object, List[int]]] = {}
    for pi, port in enumerate(ports):
        pool_ports.setdefault(id(port.pool), (port.pool, []))[1].append(pi)
    for pool, pis in pool_ports.values():
        alloc_t = np.concatenate([times_abs[pi::nports] for pi in pis])
        freed_t = np.concatenate([free_t[pi::nports] for pi in pis])
        if len(alloc_t) == 0:
            continue
        ev_t = np.concatenate([alloc_t, freed_t])
        delta = np.concatenate([np.ones(len(alloc_t), dtype=np.int64),
                                -np.ones(len(freed_t), dtype=np.int64)])
        kind = np.concatenate([np.zeros(len(alloc_t), dtype=np.int8),
                               np.ones(len(freed_t), dtype=np.int8)])
        order = np.lexsort((kind, ev_t))
        occ = np.cumsum(delta[order])
        if int(occ.max()) > pool.n_free:
            info.fallback_reason = "packet pool would exhaust"
            return None

    # -- phase C: TX drains through the return wires ------------------------
    # drains happen in the same round as their harvest; per round the event
    # loop drains ports in order and queues in order within a port, and the
    # RTT sample order must match exactly (mean/std are order-sensitive)
    ev_by_port: Dict[int, List[Tuple[int, int, _QueuePlan, int, int]]] = {}
    for t, qp, s, h in events:
        ev_by_port.setdefault(qp.pi, []).append((t, qp.qi, qp, s, h))
    tagged: List[Tuple[int, int, int, np.ndarray]] = []
    meter_bytes = 0
    meter_start: Optional[int] = None
    meter_end: Optional[int] = None
    for pi, evs in ev_by_port.items():
        evs.sort(key=lambda e: (e[0], e[1]))
        handed = np.concatenate(
            [np.full(h, t, dtype=np.int64) for t, _qi, _qp, _s, h in evs])
        origs = np.concatenate([qp.orig[s:s + h] for _t, _qi, qp, s, h in evs])
        lens = sizes[origs]
        port = ports[pi]
        gbps = float(getattr(port, "link_gbps", 0.0))
        lat = int(getattr(port, "link_latency_ns", 0))
        ser_b = serialization_ns_vec(lens, gbps)
        arr_b, _ = wire_arrival_pass_np(handed, ser_b, 0, lat)
        rtts_p = np.maximum(0, arr_b - times_abs[origs])
        meter_bytes += int(lens.sum())
        ms, me = int(arr_b[0]), int(arr_b[-1])  # FIFO: endpoints are min/max
        meter_start = ms if meter_start is None else min(meter_start, ms)
        meter_end = me if meter_end is None else max(meter_end, me)
        off = 0
        for t, qi, _qp, _s, h in evs:
            tagged.append((t, pi, qi, rtts_p[off:off + h]))
            off += h
    tagged.sort(key=lambda e: (e[0], e[1], e[2]))
    rtts = (np.concatenate([e[3] for e in tagged]) if tagged
            else np.empty(0, dtype=np.int64))

    return _Plan(n=n, start=start, open_window_at=int(times_abs[0]),
                 sizes=sizes, qplans=list(qplans.values()),
                 lcore_free=lcore_free, final_now=final_now, rtts=rtts,
                 meter_bytes=meter_bytes, meter_start=int(meter_start),
                 meter_end=int(meter_end))


def _commit(lg, server, pattern, clock, plan: _Plan) -> RunReport:
    """Apply a validated plan: every counter the event loop would have
    touched, in one step, then the final report."""
    if plan.n:
        lg.meter.open_window(plan.open_window_at)
        lg.flight.sent += plan.n
        lg._next_seq += plan.n
        for qp in plan.qplans:
            if qp.n == 0:
                continue
            nbytes = int(plan.sizes[qp.orig].sum())
            ring = qp.ring
            ring.delivered += qp.n
            ring.delivered_bytes += nbytes
            ring.head += qp.n
            ring.tail += qp.n
            ring.published += qp.n
            rem = qp.n - qp.n_full * qp.W
            ring.writebacks += qp.n_full + (1 if rem else 0)
            ring.writeback_sizes.extend([qp.W] * qp.n_full)
            if rem:
                ring.writeback_sizes.append(rem)
            txr = lg.ports[qp.pi].tx_queues[qp.qi]
            txr.posted += qp.n
            txr.posted_bytes += nbytes
            txr.transmitted += qp.n
            txr.transmitted_bytes += nbytes
            txr.head += qp.n
            txr.tail += qp.n
            qs = server.queue_stats[(qp.pi, qp.qi)]
            qs.rx_packets += qp.n
            qs.rx_bytes += nbytes
            qs.tx_packets += qp.n
            qs.poll_iterations += len(qp.harvests)
            for _t, h in qp.harvests:
                qs.record_burst(h)
        server._lcore_next_free[:] = plan.lcore_free
        lg.latency.record_many(plan.rtts)
        lg.flight.received += plan.n
        lg.meter.merge_counts(plan.n, plan.meter_bytes,
                              plan.meter_start, plan.meter_end)
        clock.advance_to(plan.final_now)
    rep = lg._report(
        offered_gbps=pattern.rate_gbps if pattern.trace is None else 0.0)
    rep.extras["sim_time"] = 1.0
    rep.extras["virtual_elapsed_ns"] = float(clock.now_ns - plan.start)
    return rep


def run_epoch_sim(loadgen, server, pattern, duration_s: float = 0.25,
                  clock: Optional[SimClock] = None, sched=None,
                  device="cuda", epoch_ns: Optional[int] = None,
                  max_rounds: int = 50_000_000,
                  info: Optional[EpochRunInfo] = None) -> RunReport:
    """Run one open-loop virtual-time measurement through the epoch-batched
    fast path, falling back to ``loadgen.run_sim`` for any configuration the
    fast path cannot reproduce bit-identically.

    Drop-in replacement for :meth:`~repro_torch.core.loadgen.LoadGen.run_sim`
    (same clock/sched resolution, same RunReport).  ``device`` is where the
    epoch pass runs: ``"cuda"`` (the default) the CUDA kernel, ``"cpu"`` its
    plain torch version, None the numpy pass (the module docstring maps
    these onto the reference's engines).  ``device="cuda"`` raises where no
    CUDA device is present, even for a run that would fall back; an error of
    the pass propagates and never falls back to the event loop.
    ``epoch_ns`` overrides the epoch length (default: see
    :func:`default_epoch_ns`); ``info`` receives fast-path/fallback details.
    """
    if info is None:
        info = EpochRunInfo()
    pass_fn = epoch_pass_np if device is None else make_pass(device)
    info.engine = "epoch" if device is None else "epoch-torch"
    info.pass_device = None if device is None else str(device)
    if clock is None:
        clock = getattr(server, "clock", None)
    if clock is None:
        clock = SimClock()
    if hasattr(server, "attach_clock") \
            and getattr(server, "clock", None) is not clock:
        server.attach_clock(clock)
    if sched is None:
        sched = next((s for s in (getattr(p, "event_sched", None)
                                  for p in loadgen.ports) if s is not None),
                     None)
    plan: Optional[_Plan] = None
    try:
        reason = _fallback_reason(loadgen, server, sched)
        if reason is not None:
            info.fallback_reason = reason
        else:
            plan = _build_plan(loadgen, server, pattern, clock, duration_s,
                               epoch_ns, pass_fn, info)
    except _PassFailed as exc:  # the pass or its device failed: never hidden
        raise exc.__cause__ from None
    except Exception as exc:  # planning is pure — always safe to fall back
        info.fallback_reason = f"planning failed: {exc!r}"
        plan = None
    if plan is None:
        info.fastpath = False
        return loadgen.run_sim(server, pattern, duration_s=duration_s,
                               clock=clock, max_rounds=max_rounds,
                               sched=sched)
    info.fastpath = True
    return _commit(loadgen, server, pattern, clock, plan)
