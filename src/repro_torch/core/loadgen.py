"""LoadGen — the EtherLoadGen hardware load-generator model (paper §3.3).

"The hardware load generator model can generate packets at arbitrary rates and
sizes ... parameters are packet rate, packet size, and protocol ... a packet
trace can be passed ... adds a timestamp to each outgoing packet at a
configurable offset and compares the timestamp with the current tick on
incoming packets to compute per-packet round-trip latency ... reports mean,
median, standard deviation, and tail latency ... a packet drop percentage and
a histogram ... also supports a bandwidth test mode where it gradually
increases the bandwidth to find the maximum sustainable bandwidth."

This class implements all of the above against in-process servers
(:class:`~repro_torch.core.pmd.BypassL2FwdServer` or
:class:`~repro.core.kernel_stack.KernelStackServer`).  It plays the NIC role on
the wire side: it DMAs frames into RX descriptor rings and drains TX rings.
Like its hardware counterpart, the generator itself never drops or delays
packets — all loss is attributable to the system under test (ring overflow /
pool exhaustion / link saturation), which is what "maximum sustainable
bandwidth" measures.

Timing comes in two modes:

* **Virtual time** (:meth:`LoadGen.run_sim`, the default through
  :mod:`repro.exp`): packet emission times are computed *analytically* from
  the :class:`TrafficPattern` (uniform spacing, pre-drawn exponential
  inter-arrivals for Poisson, burst trains, trace replay) and a
  :class:`~repro_torch.core.simclock.SimClock` advances event-by-event — the
  paper's "compares the timestamp with the current tick" semantics.  Results
  are deterministic and independent of host speed: 400 Gbps of offered load
  simulates fine on a laptop.  Frames cross a :class:`~repro_torch.core.simclock.
  Wire` per direction, so RTTs include per-link serialization
  (``bytes*8/link_gbps``) and propagation latency.

* **Wall clock** (:meth:`LoadGen.run`): the same analytic schedule is paced
  against ``time.perf_counter_ns()`` — kept for host-overhead studies where
  the real Python execution cost *is* the measurement.

Own copy, in the PyTorch port, of ``src/repro/core/loadgen.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from .packet import (
    DEFAULT_TS_OFFSET,
    FLOW_OFFSET,
    FLOW_SIZE,
    MIN_FRAME,
    PacketPool,
    echo_payload_checksum,
    flow_tuple_for_id,
    payload_checksum,
    read_ce,
    read_ce_vec,
    read_seq,
    read_seqs_vec,
    read_stamp,
    read_stamps_vec,
    stamp,
    write_flow,
    write_flow_ids_vec,
    write_packets_vec,
)
from .pmd import Port
from .simclock import EventScheduler, SimClock, Wire
from .telemetry import (LatencyRecorder, RunReport, ThroughputMeter, rss_skew,
                        writeback_extras)

TRAFFIC_KINDS = ("uniform", "poisson", "bursty")


class Server(Protocol):
    def poll_once(self) -> int: ...


@dataclass(frozen=True)
class TrafficPattern:
    """Static traffic description (rate/size/pattern), or trace replay.

    ``kind``:

    * ``uniform`` — constant inter-arrival ``1/pps``;
    * ``poisson`` — pre-drawn i.i.d. exponential inter-arrivals with mean
      ``1/pps`` (a true Poisson process; the seed implementation re-drew
      ``rng.poisson(cumulative_target)`` each iteration, which is
      non-monotonic in expectation and has the wrong marginal distribution);
    * ``bursty`` — back-to-back trains of ``burst_len`` packets, trains
      spaced so the long-run rate matches ``rate_gbps``.
    """

    rate_gbps: float = 1.0
    packet_size: int = 1518
    kind: str = "uniform"          # uniform | poisson | bursty
    burst_len: int = 32            # for kind="bursty": packets per burst train
    trace: Optional[Sequence[Tuple[int, int]]] = None  # [(t_ns_offset, size)]
    seed: int = 0

    def packets_per_second(self) -> float:
        return self.rate_gbps * 1e9 / 8.0 / self.packet_size

    def emission_schedule(
        self, duration_ns: int, rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Analytic per-packet emission times for one run.

        Returns ``(times_ns int64, sizes int32)``, times non-decreasing and
        ``< duration_ns`` (bursty trains may start before the cutoff and
        finish their train).  Fully determined by the pattern + rng state, so
        two runs with the same seed emit identical schedules — the root of
        run-to-run determinism.

        The schedule is materialized up front (12 bytes/packet): high-rate
        runs should use short simulated durations — a 1 ms window at
        400 Gbps/64B is ~780k packets.  Chunked/streaming schedules for
        multi-minute trace replays are a ROADMAP item.
        """
        empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32))
        if self.trace is not None:
            raw = [(int(t), max(MIN_FRAME, int(s))) for t, s in self.trace]
            if any(t < 0 for t, _ in raw):
                raise ValueError("trace time offsets must be >= 0")
            # the contract is "times non-decreasing": an out-of-order trace
            # would silently corrupt both run_sim's event loop and run's
            # searchsorted credit, so sort here (stable: equal-time entries
            # keep their input order)
            raw.sort(key=lambda e: e[0])
            entries = [e for e in raw if e[0] < duration_ns]
            if not entries:
                return empty
            times = np.array([t for t, _ in entries], dtype=np.int64)
            sizes = np.array([s for _, s in entries], dtype=np.int32)
            return times, sizes
        pps = self.packets_per_second()
        if pps <= 0 or duration_ns <= 0:
            return empty
        gap_ns = 1e9 / pps
        if self.kind == "uniform":
            n = int(duration_ns * 1e-9 * pps)
            times = (np.arange(n, dtype=np.float64) * gap_ns).astype(np.int64)
        elif self.kind == "poisson":
            rng = rng if rng is not None else np.random.default_rng(self.seed)
            chunks: List[np.ndarray] = []
            last = 0.0
            block = max(64, int(duration_ns * 1e-9 * pps) + 64)
            while last < duration_ns:
                cum = np.cumsum(rng.exponential(gap_ns, size=block)) + last
                chunks.append(cum)
                last = float(cum[-1])
            cat = np.concatenate(chunks)
            times = cat[cat < duration_ns].astype(np.int64)
        elif self.kind == "bursty":
            train_gap = gap_ns * self.burst_len
            n_trains = max(1, int(np.ceil(duration_ns / train_gap)))
            starts = (np.arange(n_trains, dtype=np.float64) * train_gap)
            starts = starts[starts < duration_ns]
            times = np.repeat(starts.astype(np.int64), self.burst_len)
        else:
            raise ValueError(
                f"unknown traffic kind {self.kind!r}; expected one of "
                f"{TRAFFIC_KINDS}")
        sizes = np.full(len(times), self.packet_size, dtype=np.int32)
        return times, sizes


@dataclass
class _Flight:
    sent: int = 0
    received: int = 0
    integrity_errors: int = 0
    # emissions that found the generator out of buffers: counted as sent
    # (offered load) but never put on a wire.  Without this counter the
    # loss shows up as generic "dropped" with nothing attributing it —
    # pool-level ``alloc_failures`` (rx_nombuf) aggregates every consumer
    # of the pool, not the generator's own starvation.
    alloc_failures: int = 0
    # completions whose frame came back with the ECN CE bit set (an AQM on
    # the fabric marked instead of dropping); only surfaced in reports when
    # nonzero or when a rate controller is attached
    ce_marked: int = 0
    checksums: dict = field(default_factory=dict)


def _port_wire(port: Port) -> Wire:
    """One direction of the port's attached link (ideal if unconfigured)."""
    return Wire(gbps=getattr(port, "link_gbps", 0.0),
                latency_ns=getattr(port, "link_latency_ns", 0))


class DctcpRateController:
    """DCTCP-style rate adaptation over virtual-time windows.

    The hardware generator has no TCP stack, so congestion control is modeled
    the way DCTCP's fluid model describes it: per *window* (a fixed slice of
    virtual time, standing in for an RTT round) the controller measures the
    fraction ``F`` of echoes that carried a CE mark — plus any sends old
    enough that their echo is overdue, inferred lost — and keeps an EWMA

        ``alpha <- (1 - g) * alpha + g * F``

    A window with any marks/losses cuts the offered rate by ``alpha/2``
    (DCTCP's proportional backoff); the ``k``-th consecutive clean window
    grows it additively by ``k * increase_gbps`` (DCQCN-style fast
    recovery: near the operating point marks are frequent, the clean run
    stays short and steps stay small, while after a deep cut a long clean
    run ramps the rate back in O(sqrt(deficit)) windows instead of
    O(deficit)).  Multiplicative decrease with additive increase (AIMD)
    is what makes competing clients converge toward a fair share — a
    multiplicative increase would leave per-client rates wandering apart.
    The rate is clamped to ``[min_gbps, max_gbps]`` where ``max_gbps`` is
    the attachment link's line rate.

    Everything is plain arithmetic on counters fed by the generator
    (``on_send`` / ``on_ack``) — no RNG, no wall clock — so runs are
    bit-identical per config + seed.  Loss inference is evidence-based: a
    send is only written off once an echo for a *later* send has come back —
    FIFO proof that the fabric already had its chance to deliver it (the
    topology fabric is in-order per client path).  Batching stalls (NIC-side
    writeback holding a whole in-order tail) therefore never masquerade as
    congestion loss; the flip side is that losses at the very end of a run,
    with no later echo to prove them, go uninferred — harmless, since there
    is no window left to adapt.
    """

    __slots__ = ("rate_gbps", "window_ns", "gain", "min_gbps", "max_gbps",
                 "increase_gbps", "max_inflight", "alpha", "window_end",
                 "sent", "acked", "marked", "lost_accounted", "windows",
                 "rate_min", "rate_max", "_acked_at_roll", "_marked_at_roll",
                 "_hist", "_max_acked_sent", "_clean_run")

    def __init__(self, rate_gbps: float, window_ns: int,
                 gain: float = 0.0625, min_gbps: float = 0.05,
                 max_gbps: float = float("inf"),
                 increase_gbps: float = 0.25, max_inflight: int = 0,
                 start_ns: int = 0):
        if rate_gbps <= 0:
            raise ValueError("rate_gbps must be > 0")
        if window_ns < 1:
            raise ValueError("window_ns must be >= 1")
        if not (0.0 < gain <= 1.0):
            raise ValueError("gain must be in (0, 1]")
        if min_gbps <= 0 or min_gbps > max_gbps:
            raise ValueError("need 0 < min_gbps <= max_gbps")
        if increase_gbps <= 0.0:
            raise ValueError("increase_gbps must be > 0")
        if max_inflight < 0:
            raise ValueError("max_inflight must be >= 0 (0 == uncapped)")
        self.rate_gbps = min(max(rate_gbps, min_gbps), max_gbps)
        self.window_ns = int(window_ns)
        self.gain = gain
        self.min_gbps = min_gbps
        self.max_gbps = max_gbps
        self.increase_gbps = increase_gbps
        self.max_inflight = int(max_inflight)
        # alpha starts saturated (as in the Linux DCTCP implementation):
        # the first congested window then cuts the rate in half instead of
        # waiting ~1/gain windows for the EWMA to warm up, which matters
        # during an incast transient where every window is fully marked.
        self.alpha = 1.0
        self.window_end = int(start_ns) + self.window_ns
        self.sent = 0
        self.acked = 0
        self.marked = 0
        self.lost_accounted = 0
        self.windows = 0
        self.rate_min = self.rate_gbps
        self.rate_max = self.rate_gbps
        self._acked_at_roll = 0
        self._marked_at_roll = 0
        # (window boundary, cumulative sends with stamp < boundary) per roll,
        # consumed left-to-right as echo evidence advances past boundaries
        self._hist: deque = deque()
        self._max_acked_sent = -1  # newest send stamp seen on any echo
        self._clean_run = 0        # consecutive clean windows (fast recovery)

    def _roll_to(self, t_ns: int) -> None:
        while t_ns >= self.window_end:
            delivered = self.acked - self._acked_at_roll
            fresh_marked = self.marked - self._marked_at_roll
            # FIFO-evidence loss inference: the newest send stamp seen on an
            # echo proves every send from before that boundary is either
            # delivered or gone; count the gone ones (once each)
            hist = self._hist
            while len(hist) > 1 and hist[1][0] <= self._max_acked_sent:
                hist.popleft()
            new_lost = 0
            if hist and hist[0][0] <= self._max_acked_sent:
                overdue = hist[0][1] - self.acked - self.lost_accounted
                new_lost = overdue if overdue > 0 else 0
            self.lost_accounted += new_lost
            denom = delivered + new_lost
            if denom > 0:
                frac = (fresh_marked + new_lost) / denom
                self.alpha = (1.0 - self.gain) * self.alpha + self.gain * frac
                if frac > 0.0:
                    self.rate_gbps *= 1.0 - self.alpha / 2.0
                    self._clean_run = 0
                else:
                    self._clean_run += 1
                    self.rate_gbps += self.increase_gbps * self._clean_run
                if self.rate_gbps < self.min_gbps:
                    self.rate_gbps = self.min_gbps
                elif self.rate_gbps > self.max_gbps:
                    self.rate_gbps = self.max_gbps
                if self.rate_gbps < self.rate_min:
                    self.rate_min = self.rate_gbps
                elif self.rate_gbps > self.rate_max:
                    self.rate_max = self.rate_gbps
                self.windows += 1
            self._acked_at_roll = self.acked
            self._marked_at_roll = self.marked
            hist.append((self.window_end, self.sent))
            if len(hist) > 4096:   # bound memory under pathological stalls
                hist.popleft()
            self.window_end += self.window_ns

    def on_send(self, t_ns: int) -> None:
        self._roll_to(int(t_ns))
        self.sent += 1

    def on_ack(self, t_ns: int, ce: bool,
               sent_ns: Optional[int] = None) -> None:
        self._roll_to(int(t_ns))
        self.acked += 1
        if ce:
            self.marked += 1
        if sent_ns is not None and int(sent_ns) > self._max_acked_sent:
            self._max_acked_sent = int(sent_ns)

    def on_acks(self, t_ns: int, n: int, n_marked: int,
                max_sent_ns: Optional[int] = None) -> None:
        self._roll_to(int(t_ns))
        self.acked += int(n)
        self.marked += int(n_marked)
        if max_sent_ns is not None and int(max_sent_ns) > self._max_acked_sent:
            self._max_acked_sent = int(max_sent_ns)

    @property
    def outstanding(self) -> int:
        """Sends neither echoed back nor written off as lost."""
        return self.sent - self.acked - self.lost_accounted

    def can_send(self) -> bool:
        """Self-clocking guard (TX-credit / cwnd analogue): with
        ``max_inflight`` set, refuse new sends while that many frames are
        outstanding.  Pure rate pacing keeps integrating overshoot into the
        bottleneck queue for a full feedback delay; the in-flight cap is
        the ack-clocked backpressure that stops it instantly, the way a
        TCP sender can never exceed its window."""
        return self.max_inflight <= 0 or self.outstanding < self.max_inflight

    def gap_ns(self, size_bytes: int) -> float:
        """Inter-emission gap (ns) at the current rate for one frame."""
        return size_bytes * 8.0 / self.rate_gbps


class LoadGen:
    """Software model of a hardware traffic generator wired to N ports."""

    def __init__(
        self,
        ports: Sequence[Port],
        ts_offset: int = DEFAULT_TS_OFFSET,
        verify_integrity: bool = False,
        max_tx_burst: int = 64,
        latency_capacity_hint: int = 1 << 16,
        n_flows: int = 256,
        src_ip_base: Optional[int] = None,
        dst_ip: Optional[int] = None,
    ):
        if n_flows < 1:
            raise ValueError("n_flows must be >= 1")
        # the flow 4-tuple occupies fixed bytes FLOW_OFFSET..FLOW_OFFSET+12;
        # a timestamp stamped inside that window would be overwritten and
        # every RTT would silently be garbage
        if ts_offset + 8 > FLOW_OFFSET and ts_offset < FLOW_OFFSET + FLOW_SIZE:
            raise ValueError(
                f"ts_offset={ts_offset} overlaps the flow fields at "
                f"[{FLOW_OFFSET}, {FLOW_OFFSET + FLOW_SIZE})"
            )
        self.ports = list(ports)
        self.ts_offset = ts_offset
        self.verify_integrity = verify_integrity
        self.max_tx_burst = max_tx_burst
        # distinct flow 4-tuples emitted round-robin; RSS spreads them over
        # the port's RX queues (the Fig. 3(a) core-scaling traffic shape).
        # Topology scenarios pin src_ip_base (this generator's client /16,
        # what a switch routes replies back on) and dst_ip (the target node).
        self.n_flows = n_flows
        self.src_ip_base = src_ip_base
        self.dst_ip = dst_ip
        self.latency = LatencyRecorder(latency_capacity_hint)
        self.meter = ThroughputMeter()
        self.flight = _Flight()
        self._next_seq = 0
        # optional DCTCP-style rate controller (attach_cc); when set,
        # run_sim generates its emission schedule incrementally and every
        # completion feeds the controller its CE bit
        self.cc: Optional[DctcpRateController] = None

    def attach_cc(self, cc: DctcpRateController) -> None:
        """Attach a rate controller; subsequent sends/completions feed it."""
        self.cc = cc

    # -- wire-side primitives ------------------------------------------------
    def _write_frame(self, pool: PacketPool, slot: int, size: int,
                     stamp_ns: int, rng: Optional[np.random.Generator],
                     record_checksum: bool = True) -> int:
        """Fill one allocated slot: seq, timestamp, flow tuple, checksum.
        Fabric emitters pass ``record_checksum=False`` and record their own
        (echo-safe) checksum over the byte copy instead."""
        seq = self._next_seq
        self._next_seq += 1
        pool.write_packet(
            slot, seq=seq, length=size, ts_offset=self.ts_offset,
            timestamp_ns=stamp_ns, fill=(seq & 0xFF) if rng is None else None,
            rng=rng,
        )
        write_flow(pool.arena[slot], *flow_tuple_for_id(
            seq % self.n_flows, src_ip_base=self.src_ip_base,
            dst_ip=self.dst_ip))
        if self.verify_integrity and record_checksum:
            self.flight.checksums[seq] = payload_checksum(
                pool.view(slot, size), self.ts_offset
            )
        return seq

    def _send_one(self, port: Port, size: int, now_ns: int,
                  rng: Optional[np.random.Generator]) -> bool:
        slot = port.pool.alloc()
        if slot is None:
            # Generator out of buffers == system not recycling fast enough.
            self.flight.sent += 1
            self.flight.alloc_failures += 1
            return False
        self._write_frame(port.pool, slot, size, now_ns, rng)
        self.flight.sent += 1
        # RSS steers the frame to a queue; ring overflow → drop at the NIC
        # (the Port recycles the buffer)
        return port.deliver(slot, size)

    def _send_burst(self, port: Port, n: int, size: int, now_ns: int) -> int:
        """Vectorized burst emit (non-integrity fast path). Returns #delivered."""
        slots = port.pool.alloc_burst(n)
        self.flight.sent += n
        if len(slots) < n:
            self.flight.alloc_failures += n - len(slots)
        if not slots:
            return 0
        slots_arr = np.asarray(slots, dtype=np.int64)
        seqs = np.arange(self._next_seq, self._next_seq + len(slots), dtype=np.int64)
        self._next_seq += len(slots)
        write_packets_vec(port.pool, slots_arr, seqs, size, self.ts_offset, now_ns)
        write_flow_ids_vec(port.pool, slots_arr, seqs % self.n_flows,
                           src_ip_base=self.src_ip_base, dst_ip=self.dst_ip)
        lengths = np.full(len(slots), size, dtype=np.int32)
        # RSS routes the burst across the port's RX queues; per-queue ring
        # overflow drops at the NIC (the Port recycles those buffers)
        return port.deliver_burst(slots_arr, lengths)

    def _drain_port(self, port: Port, now_ns: int,
                    back_wire: Optional[Wire] = None) -> int:
        """Collect forwarded packets from every TX queue; timestamp-compare
        for RTT.  With ``back_wire`` (virtual time), every frame pays the
        return link's serialization + latency before its RTT is recorded."""
        if not self.verify_integrity:
            slots, lengths = port.drain_tx_bursts(self.max_tx_burst)
            n = len(slots)
            if n == 0:
                return 0
            stamps = read_stamps_vec(port.pool, slots, self.ts_offset)
            if back_wire is None:
                rtts = np.maximum(0, now_ns - stamps)
                t0 = t1 = now_ns
            else:
                arrivals = back_wire.transmit_burst(now_ns, lengths)
                rtts = np.maximum(0, arrivals - stamps)
                t0, t1 = int(arrivals[0]), int(arrivals[-1])
            self.latency.record_many(rtts)
            self.meter.merge_counts(n, int(lengths.sum()), t0, t1)
            self.flight.received += n
            if self.cc is not None:
                n_marked = int(read_ce_vec(port.pool, slots).sum())
                self.flight.ce_marked += n_marked
                self.cc.on_acks(t1, n, n_marked,
                                max_sent_ns=int(stamps.max()))
            port.pool.free_burst([int(s) for s in slots])
            return n
        done = port.drain_tx(self.max_tx_burst)
        for slot, length in done:
            buf = port.pool.view(slot, length)
            sent_ns = read_stamp(buf, self.ts_offset)
            rx_ns = (now_ns if back_wire is None
                     else back_wire.transmit(now_ns, length))
            rtt = max(0, rx_ns - sent_ns)
            self.latency.record(rtt)
            self.meter.on_packet(length, rx_ns)
            seq = read_seq(buf)
            want = self.flight.checksums.pop(seq, None)
            if want is not None and payload_checksum(buf, self.ts_offset) != want:
                self.flight.integrity_errors += 1
            self.flight.received += 1
            if self.cc is not None:
                ce = read_ce(buf)
                if ce:
                    self.flight.ce_marked += 1
                self.cc.on_ack(rx_ns, ce, sent_ns=sent_ns)
            port.pool.free(slot)
        return len(done)

    # -- fabric attachment (switch/topology mode) -----------------------------
    # A generator attached to a :class:`~repro.core.switch.Switch` port does
    # not own the far NIC: its frames leave as raw bytes on the fabric and
    # completions come back the same way.  These two primitives are the
    # switch-port counterparts of _send_one/_drain_port; the topology driver
    # (:mod:`repro.exp.topology`) supplies the timing.

    def make_frame(self, pool: PacketPool, size: int, stamp_ns: int,
                   rng: Optional[np.random.Generator] = None,
                   ) -> Optional[np.ndarray]:
        """Emit one frame for a fabric attachment: format it in ``pool``
        (this generator's own buffer arena) and hand back a byte copy — the
        serialized form a wire carries between address spaces.  Returns None
        (and counts the send, so the loss is attributed) when the generator
        is out of buffers."""
        slot = pool.alloc()
        self.flight.sent += 1
        if self.cc is not None:
            # alloc failures still count: a starved generator is offered
            # load that will never echo, which the controller must see
            self.cc.on_send(int(stamp_ns))
        if slot is None:
            self.flight.alloc_failures += 1
            return None
        seq = self._write_frame(pool, slot, size, stamp_ns, rng,
                                record_checksum=False)
        frame = pool.view(slot, size).copy()
        pool.free(slot)
        if self.verify_integrity:
            # the fabric's echo server legitimately rewrites macs + flow IPs,
            # so integrity is checked past the flow tuple
            self.flight.checksums[seq] = echo_payload_checksum(frame)
        return frame

    def complete_frame(self, frame: np.ndarray, now_ns: int) -> None:
        """Record one completion arriving off the fabric at virtual
        ``now_ns`` (the switch's egress wire already charged serialization +
        propagation): timestamp-compare for RTT, throughput, integrity."""
        sent_ns = read_stamp(frame, self.ts_offset)
        self.latency.record(max(0, int(now_ns) - sent_ns))
        self.meter.on_packet(len(frame), int(now_ns))
        if self.verify_integrity:
            want = self.flight.checksums.pop(read_seq(frame), None)
            if want is not None and echo_payload_checksum(frame) != want:
                self.flight.integrity_errors += 1
        ce = read_ce(frame)
        if ce:
            self.flight.ce_marked += 1
        if self.cc is not None:
            self.cc.on_ack(int(now_ns), ce, sent_ns=sent_ns)
        self.flight.received += 1

    # -- closed-loop (deterministic, for tests) -------------------------------
    def run_closed_loop(self, server: Server, n_packets: int,
                        packet_size: int = 256, window: int = 32,
                        rng: Optional[np.random.Generator] = None,
                        clock: Optional[SimClock] = None,
                        round_ns: int = 1_000,
                        max_rounds: int = 2_000_000) -> RunReport:
        """Send exactly n packets keeping ≤window in flight; fully drain.

        With a :class:`SimClock`, each scheduling round advances virtual time
        by ``round_ns`` (a processing quantum), so RTTs and stats are exact
        and bit-identical run-to-run; without one, the seed wall-clock
        behaviour is preserved.
        """
        sent = 0
        if clock is not None and hasattr(server, "attach_clock") \
                and getattr(server, "clock", None) is not clock:
            server.attach_clock(clock)
        poll_at = getattr(server, "poll_at", None) if clock is not None else None
        start = time.perf_counter_ns() if clock is None else clock.now_ns  # simlint: disable=SL001 -- wall-clock pacing mode
        rounds = 0
        while self.flight.received < n_packets:
            rounds += 1
            now = time.perf_counter_ns() if clock is None else clock.now_ns  # simlint: disable=SL001 -- wall-clock pacing mode
            while sent < n_packets and (sent - self.flight.received) < window:
                self._send_one(self.ports[sent % len(self.ports)], packet_size, now, rng)
                sent += 1
            for port in self.ports:
                port.flush_rx()  # closed loop: no idle traffic to trigger writeback
            if clock is None:
                server.poll_once()
                now = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock pacing mode
            else:
                clock.advance(round_ns)  # the quantum packets spend in service
                if poll_at is not None:
                    poll_at(clock.now_ns)
                else:
                    server.poll_once()
                now = clock.now_ns
            for port in self.ports:
                self._drain_port(port, now)
            if clock is None:
                if time.perf_counter_ns() - start > 60e9:  # simlint: disable=SL001 -- wall-clock pacing mode
                    break  # safety: never hang a test
            elif rounds >= max_rounds:
                break  # safety: never hang a test (virtual-time analogue)
        return self._report(offered_gbps=0.0)

    # -- open-loop virtual-time run (the default measurement mode) ------------
    def run_sim(self, server: Server, pattern: TrafficPattern,
                duration_s: float = 0.25,
                clock: Optional[SimClock] = None,
                max_rounds: int = 50_000_000,
                sched: Optional[EventScheduler] = None) -> RunReport:
        """Offered-load run in virtual time: event-by-event over the analytic
        emission schedule.  Deterministic, host-speed-independent, and able
        to simulate arbitrary rates (100 Gbps on one laptop core).

        Event loop: the next event is the earliest of (next scheduled
        emission, next frame landing off a wire, next lcore finishing its
        modeled work or giving up on burst accumulation, next event on
        ``sched``).  At each event time we emit due frames onto the forward
        wires, deliver due frames into RX rings (RSS + overflow drops), fire
        due scheduler events (descriptor-cache writeback timeouts), give the
        server one scheduling round, and drain TX rings through the return
        wires (recording RTT at return-arrival time).

        ``sched`` carries NIC-side timers (the DCA writeback-timeout events
        armed via :meth:`~repro.core.ethdev.EthDev.attach_dca`); when not
        passed explicitly it is discovered from the ports, so factory-built
        setups (MSB trials) keep their timers firing.
        """
        if clock is None:
            clock = getattr(server, "clock", None)
        if clock is None:
            clock = SimClock()
        if hasattr(server, "attach_clock") \
                and getattr(server, "clock", None) is not clock:
            server.attach_clock(clock)
        if sched is None:
            sched = next((s for s in (getattr(p, "event_sched", None)
                                      for p in self.ports) if s is not None),
                         None)
        rng = np.random.default_rng(pattern.seed)
        use_rng_payload = self.verify_integrity
        start = clock.now_ns
        cc = self.cc
        cc_next: Optional[float] = None
        cc_end = start + int(duration_s * 1e9)
        if cc is not None:
            # rate-adaptive mode: each emission gap depends on the
            # controller's rate *at that moment*, so the schedule is
            # generated incrementally instead of precomputed
            times = np.empty(0, dtype=np.int64)
            sizes = np.empty(0, dtype=np.int32)
            if pattern.packets_per_second() > 0 and cc_end > start:
                cc_next = float(start)
                self.meter.open_window(start)
        else:
            times, sizes = pattern.emission_schedule(int(duration_s * 1e9),
                                                     rng)
            if len(times):
                times = times + start
                # anchor throughput at the first emission so a terminal
                # writeback-flush drain can't shrink the measurement window
                self.meter.open_window(int(times[0]))
        nports = len(self.ports)
        fwd = [_port_wire(p) for p in self.ports]
        back = [_port_wire(p) for p in self.ports]
        # frames in flight on each forward wire: FIFO of (arrival, slot, size)
        on_wire: List[deque] = [deque() for _ in self.ports]
        poll_at = getattr(server, "poll_at", None)
        next_free = getattr(server, "next_free_ns", None)
        i, n = 0, len(times)
        flushed_idle = False
        for _ in range(max_rounds):
            now = clock.now_ns
            moved = 0
            # 1) emissions due: stamp with the *scheduled* time and put the
            #    frame on its port's forward wire
            while i < n and times[i] <= now:
                t_emit = int(times[i])
                size = int(sizes[i])
                port = self.ports[i % nports]
                slot = port.pool.alloc()
                self.flight.sent += 1
                if slot is not None:
                    self._write_frame(port.pool, slot, size, t_emit,
                                      rng if use_rng_payload else None)
                    arrival = fwd[i % nports].transmit(t_emit, size)
                    on_wire[i % nports].append((arrival, slot, size))
                else:
                    # out of buffers: the emission still counts as offered
                    # load, but attribute the vanished frame explicitly
                    self.flight.alloc_failures += 1
                i += 1
                moved += 1
            # 1b) rate-adaptive emissions: same body, but the next emission
            #     time is minted per frame from the controller's current rate
            while cc_next is not None and int(cc_next) <= now:
                t_emit = int(cc_next)
                size = pattern.packet_size
                # a tick finding the in-flight cap exhausted is forfeited
                # (paced probing); the cursor still advances
                if cc.can_send():
                    port = self.ports[i % nports]
                    slot = port.pool.alloc()
                    self.flight.sent += 1
                    cc.on_send(t_emit)
                    if slot is not None:
                        self._write_frame(port.pool, slot, size, t_emit,
                                          rng if use_rng_payload else None)
                        arrival = fwd[i % nports].transmit(t_emit, size)
                        on_wire[i % nports].append((arrival, slot, size))
                    else:
                        self.flight.alloc_failures += 1
                    i += 1
                moved += 1
                cc_next += cc.gap_ns(size)
                if cc_next >= cc_end:
                    cc_next = None
            # 2) wire arrivals due: NIC-side delivery (RSS steering; ring
            #    overflow drops here, exactly like hardware)
            for pi, dq in enumerate(on_wire):
                port = self.ports[pi]
                while dq and dq[0][0] <= now:
                    _, slot, size = dq.popleft()
                    port.deliver(slot, size)
                    moved += 1
            # 2b) scheduler events due: descriptor-cache writeback timeouts
            #     fire after deliveries at `now` (a threshold crossing at the
            #     same instant cancels the timer first), before the PMD polls
            if sched is not None:
                moved += sched.run_until(now)
            # 3) one server scheduling round at virtual `now`
            if poll_at is not None:
                moved += poll_at(now)
            else:
                moved += server.poll_once()
            # 4) wire-side TX drain; RTT recorded at return-link arrival
            for pi, port in enumerate(self.ports):
                moved += self._drain_port(port, now, back_wire=back[pi])
            # 5) advance to the next event
            cands = []
            if i < n:
                cands.append(int(times[i]))
            if cc_next is not None:
                cands.append(int(cc_next))
            for dq in on_wire:
                if dq:
                    cands.append(dq[0][0])
            if next_free is not None:
                nf = next_free(now)
                if nf is not None:
                    cands.append(nf)
            if sched is not None:
                nt = sched.next_time_ns()
                if nt is not None:
                    cands.append(nt)
            if cands:
                flushed_idle = False
                clock.advance_to(min(cands))
                continue
            if moved > 0:
                flushed_idle = False
                continue
            if not flushed_idle:
                # quiet wire: the NIC's timeout-driven descriptor-cache
                # writeback fires, releasing sub-threshold completions
                for port in self.ports:
                    port.flush_rx()
                flushed_idle = True
                continue
            break  # nothing scheduled, nothing moving: remaining == drops
        rep = self._report(
            offered_gbps=pattern.rate_gbps if pattern.trace is None else 0.0)
        rep.extras["sim_time"] = 1.0
        rep.extras["virtual_elapsed_ns"] = float(clock.now_ns - start)
        return rep

    # -- open-loop timed run (wall-clock mode, for host-overhead studies) -----
    def run(self, server: Server, pattern: TrafficPattern,
            duration_s: float = 0.25, drain_timeout_s: float = 0.5) -> RunReport:
        """Offered-load run paced against the host clock.

        Uses the same analytic :meth:`TrafficPattern.emission_schedule` as
        virtual time (so Poisson pacing is a true Poisson process here too);
        the credit at elapsed wall time t is the number of scheduled
        emissions ≤ t.
        """
        rng = np.random.default_rng(pattern.seed)
        use_rng_payload = self.verify_integrity
        duration_ns = int(duration_s * 1e9)
        times, sizes = pattern.emission_schedule(duration_ns, rng)
        n_sched = len(times)
        fixed_size = pattern.trace is None
        start = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock pacing mode
        end = start + duration_ns
        if n_sched:
            self.meter.open_window(start + int(times[0]))
        sent_i = 0
        while True:
            now = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock pacing mode
            if now >= end:
                break
            # how many scheduled emissions are due by now?
            credit = int(np.searchsorted(times, now - start, side="right"))
            burst = min(credit - sent_i, self.max_tx_burst)
            if burst > 0:
                if fixed_size and not use_rng_payload:
                    # vectorized emit, split evenly across ports (multi-NIC)
                    nports = len(self.ports)
                    share = burst // nports
                    extra = burst % nports
                    for pi, port in enumerate(self.ports):
                        k = share + (1 if pi < extra else 0)
                        if k > 0:
                            self._send_burst(port, k, pattern.packet_size, now)
                    sent_i += burst
                else:
                    for _ in range(burst):
                        port = self.ports[sent_i % len(self.ports)]
                        self._send_one(port, int(sizes[sent_i]), now,
                                       rng if use_rng_payload else None)
                        sent_i += 1
            server.poll_once()
            now = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock pacing mode
            for port in self.ports:
                self._drain_port(port, now)
        # drain in-flight tail so drop accounting is exact
        drain_end = time.perf_counter_ns() + int(drain_timeout_s * 1e9)  # simlint: disable=SL001 -- wall-clock pacing mode
        while (self.flight.received < self.flight.sent
               and time.perf_counter_ns() < drain_end):  # simlint: disable=SL001 -- wall-clock pacing mode
            for port in self.ports:
                port.flush_rx()
            if server.poll_once() == 0 and all(p.tx_pending == 0 for p in self.ports):
                # nothing moving and nothing queued: remaining packets were dropped
                break
            now = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock pacing mode
            for port in self.ports:
                self._drain_port(port, now)
        return self._report(
            offered_gbps=pattern.rate_gbps if pattern.trace is None else 0.0)

    def _report(self, offered_gbps: float) -> RunReport:
        rep = RunReport(
            offered_gbps=offered_gbps,
            achieved_gbps=self.meter.gbps,
            achieved_mpps=self.meter.mpps,
            sent=self.flight.sent,
            received=self.flight.received,
            dropped=self.flight.sent - self.flight.received,
            latency=self.latency.stats(),
            histogram=self.latency.histogram(),
        )
        rep.extras["integrity_errors"] = float(self.flight.integrity_errors)
        # generator buffer starvation (offered load that never hit a wire)
        rep.extras["loadgen_alloc_failures"] = float(self.flight.alloc_failures)
        # ECN / congestion-control telemetry, only when the fabric actually
        # marked something or a controller is attached (keeps pre-AQM
        # reports byte-identical)
        if self.flight.ce_marked or self.cc is not None:
            rep.extras["ce_marked"] = float(self.flight.ce_marked)
        if self.cc is not None:
            rep.extras["cc_windows"] = float(self.cc.windows)
            rep.extras["cc_final_rate_gbps"] = self.cc.rate_gbps
            rep.extras["cc_min_rate_gbps"] = self.cc.rate_min
            rep.extras["cc_max_rate_gbps"] = self.cc.rate_max
            rep.extras["cc_alpha"] = self.cc.alpha
            rep.extras["cc_lost_inferred"] = float(self.cc.lost_accounted)
        # per-RX-ring descriptor-writeback telemetry (the Fig. 4 observable)
        rep.extras.update(writeback_extras(self.ports))
        # per-queue NIC-side accounting (the RSS-skew observable); only
        # reported for multi-queue ports to keep single-queue reports terse
        for pi, port in enumerate(self.ports):
            if port.n_queues <= 1:
                continue
            delivered = port.rx_queue_delivered()
            dropped = port.rx_queue_dropped()
            for qi in range(port.n_queues):
                rep.extras[f"p{pi}q{qi}_rx_delivered"] = float(delivered[qi])
                rep.extras[f"p{pi}q{qi}_rx_dropped"] = float(dropped[qi])
            skew = rss_skew(delivered)
            rep.extras[f"p{pi}_rss_imbalance"] = skew["max_over_mean"]
            rep.extras[f"p{pi}_rss_cov"] = skew["cov"]
        return rep


# -- bandwidth test mode ------------------------------------------------------

def find_max_sustainable_bandwidth(
    make_setup: Callable[[], Tuple[Server, List[Port]]],
    packet_size: int = 1518,
    start_gbps: float = 0.25,
    max_gbps: float = 400.0,
    trial_s: float = 0.2,
    drop_tolerance_pct: float = 0.0,
    refine_iters: int = 5,
    pattern_kind: str = "uniform",
    sim_time: Optional[bool] = None,
    engine: str = "event",
    device: str = "cuda",
) -> Tuple[float, List[RunReport]]:
    """EtherLoadGen bandwidth-test mode: "gradually increases the bandwidth to
    find the maximum sustainable bandwidth ... without packet drops."

    Multiplicative increase until the system drops packets, then bisection
    between the last sustainable and first unsustainable rates.  The reported
    MSB is the highest *offered* rate whose trial actually sustained (the
    per-trial achieved rates live in the returned reports) — and the
    bisection's lower bound is always a rate that was probed and sustained:
    if the very first ramp trial fails, the search probes downward before
    refining instead of assuming an unvalidated ``bad/2`` floor.  Every trial
    uses a fresh server/rings via ``make_setup`` so state never leaks.

    ``sim_time``: True runs each trial in virtual time (deterministic,
    host-independent — the default through :mod:`repro.exp`); False forces
    wall-clock; None auto-detects (virtual when the factory's server carries
    an attached :class:`SimClock`).  ``engine`` selects the virtual-time
    execution engine per trial: ``"event"`` (the per-event loop),
    ``"epoch"`` (the epoch-batched fast path of
    :mod:`repro_torch.core.fastpath` with the numpy pass, bit-identical
    reports), or ``"epoch-torch"`` (same, with the pass in torch on
    ``device``: ``"cuda"`` runs the hand-written kernel, ``"cpu"`` the plain
    version). ``"epoch-torch"`` takes the place of the reference's
    ``"epoch-jit"``.  Returns (msb_gbps, all trial reports).
    """

    reports: List[RunReport] = []

    def trial(rate: float) -> RunReport:
        server, ports = make_setup()
        lg = LoadGen(ports)
        pattern = TrafficPattern(rate_gbps=rate, packet_size=packet_size,
                                 kind=pattern_kind)
        use_sim = sim_time
        if use_sim is None:
            use_sim = getattr(server, "clock", None) is not None
        if use_sim:
            if engine in ("epoch", "epoch-torch"):
                from .fastpath import run_epoch_sim  # avoid import cycle
                rep = run_epoch_sim(lg, server, pattern, duration_s=trial_s,
                                    device=device if engine == "epoch-torch"
                                    else None)
            else:
                rep = lg.run_sim(server, pattern, duration_s=trial_s)
        else:
            rep = lg.run(server, pattern, duration_s=trial_s)
        reports.append(rep)
        return rep

    def sustained(rep: RunReport) -> bool:
        return rep.drop_pct <= drop_tolerance_pct and rep.sent > 0

    # Phase 1: multiplicative ramp.  ``good`` tracks the highest *offered*
    # rate that sustained (achieved rates stay in the reports).
    good, bad = 0.0, None
    rate = start_gbps
    while rate <= max_gbps:
        if sustained(trial(rate)):
            good = max(good, rate)
            rate *= 2.0
        else:
            bad = rate
            break
    if bad is None:
        return good, reports
    lo, hi = bad / 2.0, bad
    if good == 0.0:
        # The very first ramp trial failed, so ``lo`` was never validated as
        # sustainable.  Probe downward until a sustainable floor is found
        # (restoring the bisection invariant) or give up at 0.
        found = False
        for _ in range(12):
            if sustained(trial(lo)):
                good, found = lo, True
                break
            lo, hi = lo / 2.0, lo
        if not found:
            return 0.0, reports
    # Phase 2: bisection between a validated-sustainable lo and a failing hi
    for _ in range(refine_iters):
        mid = 0.5 * (lo + hi)
        if sustained(trial(mid)):
            good = max(good, mid)
            lo = mid
        else:
            hi = mid
    return good, reports
