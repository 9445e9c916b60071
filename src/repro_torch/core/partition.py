"""Partitioned-parallel execution of multi-host topologies.

The shared-clock :meth:`repro_torch.exp.topology.Cluster.run` loop advances every
client, node, and the switch in one round per virtual instant — correct, but
serial by construction.  This module splits the same scenario into
per-endpoint **simulation domains** (one per client, one per node, one for
the switch), each with a private :class:`~repro_torch.core.simclock.SimClock` and
scheduler, exchanging frames only at domain boundaries: the fabric's wires.
Because every boundary has at least ``link_latency_ns`` of propagation, a
frame emitted at ``t`` cannot affect any other domain before ``t +
link_latency_ns`` — SimBricks' conservative-parallel invariant
(arXiv:2012.14219).  Domains therefore advance in lockstep **windows**: each
window ends ``link_latency_ns`` past the earliest pending activity, every
domain runs freely up to the window end, and the frames minted inside it
(``Crossing`` records) are delivered at the start of a later window.

**Bit-identical ordering.**  The shared loop breaks simultaneous-event ties
with a global FIFO sequence number.  Domains cannot share a counter, so every
event instead carries a **birth key** — a tuple encoding *when and where it
was minted*:

* phase-0 client emissions: ``(t, 0, client_index, k)``;
* events minted while executing another event: ``(t, 1, *parent_birth, k)``;
* phase-2 node poll/drain rounds: ``(t, 2, node_index, k)``;

with ``k`` a per-(t, phase) running counter.  Lexicographic order over these
tuples reproduces the shared loop's mint order exactly: earlier virtual
mint-time first, then the shared round's phase order (client emissions,
scheduler events, node rounds), then client/node index, then per-phase FIFO.
Heaps order on ``(fire_time, birth)``, so the order crossings *arrive* in is
irrelevant — which is what makes the multiprocessing mode deterministic.

Policy (which configs are provably equivalent, how domains are built from a
``TopologyConfig``, report assembly) lives in :mod:`repro_torch.exp.topology`; this
module is pure mechanism and imports nothing from ``repro_torch.exp``.

Own copy, in the PyTorch port, of ``src/repro/core/partition.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import heapq
import multiprocessing
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .simclock import SimClock, Wire
from .switch import Switch
from .telemetry import writeback_extras

__all__ = [
    "Crossing", "DomainScheduler", "ClientDomain", "NodeDomain",
    "SwitchDomain", "DomainSwitch", "PartitionEngine", "MpPartitionEngine",
    "PartitionRunInfo", "PartitionSanitizer", "CausalityError",
    "PARTITION_FALLBACK_REASONS", "assign_groups",
    "validate_partition_fallback_reason",
]

# one frame crossing a domain boundary:
# (dst_domain, fire_t_ns, birth, kind, payload) where kind is "fwd"
# (endpoint uplink -> switch ingress, payload (in_port_id, frame)) or
# "deliver" (switch egress -> endpoint, payload frame)
Crossing = Tuple[int, int, tuple, str, object]

_PRE_RUN_CTX = (-1,)  # births minted before any phase/event context

# The closed taxonomy of partition fallback reasons.  Every string stamped
# into ``PartitionRunInfo.fallback_reason`` must fullmatch one of these
# patterns (``.+`` spans the ``{name!r}``/``{kind!r}`` interpolations of
# ``repro_torch.exp.topology.partition_fallback_reason``).  Keeping the list here,
# next to the dataclass that enforces it, means a typo'd or ad-hoc reason
# fails loudly at assignment instead of silently fragmenting the taxonomy
# that tests and sweep tooling key on.
PARTITION_FALLBACK_REASONS: Tuple[str, ...] = (
    r"serving topology: balancer reads live cross-domain state",
    r"zero-latency links leave no conservative lookahead window",
    r"node .+: zero-cost PMD model needs the shared loop's "
    r"every-round polling",
    r"node .+: zero-cost kernel model needs the shared loop's "
    r"every-round polling",
    r"node .+: stack kind .+ not proven partition-equivalent",
    r"AQM policy .+ not proven partition-equivalent",
    r"DCTCP rate-adaptive clients adapt on cross-domain echo feedback",
    r"multi-switch trunk fabric not proven partition-equivalent",
)

_PARTITION_REASON_RES = tuple(re.compile(p) for p in
                              PARTITION_FALLBACK_REASONS)


def validate_partition_fallback_reason(reason: Optional[str]) -> None:
    """Raise ``ValueError`` unless ``reason`` is None or matches the closed
    :data:`PARTITION_FALLBACK_REASONS` taxonomy."""
    if reason is None:
        return
    for pat in _PARTITION_REASON_RES:
        if pat.fullmatch(reason):
            return
    raise ValueError(
        f"unknown partition fallback reason {reason!r}: not in the closed "
        "PARTITION_FALLBACK_REASONS taxonomy (repro_torch.core.partition)")


@dataclass
class PartitionRunInfo:
    """Out-of-band partition-run descriptor (NOT in the RunReport, which must
    stay bit-identical across execution modes)."""

    mode_requested: str = "shared-clock"
    mode_used: str = "shared-clock"
    fallback_reason: Optional[str] = None
    n_domains: int = 0
    n_windows: int = 0
    n_workers: int = 0
    n_sanitized: int = 0  # crossings checked by PartitionSanitizer (0 = off)

    def __setattr__(self, name: str, value) -> None:
        # dataclass __init__ assigns via setattr, so construction-time
        # reasons are validated too
        if name == "fallback_reason":
            validate_partition_fallback_reason(value)
        object.__setattr__(self, name, value)


class CausalityError(RuntimeError):
    """A crossing violated the conservative-parallel invariant: it fired
    before its link-latency bound, before its destination's clock, or out of
    (fire_t, birth) order — any of which means domain state diverged from the
    shared-clock loop (a determinism race, not a modeling choice)."""


class PartitionSanitizer:
    """Always-available runtime race detector for crossing delivery.

    :mod:`tests.test_partition_property` proves (via hypothesis) that every
    crossing respects the conservative bound; this class promotes that
    property into a production check the engines can run on every delivery.
    Three invariants, all cheap enough to leave on for whole parity corpora:

    1. **Link-latency bound.**  Every crossing is minted by a wire transmit
       at its birth instant, so a frame can never legally fire before
       ``birth_t + serialization_ns(len(frame)) + latency_ns`` — the
       fresh-wire (idle-FIFO) lower bound of
       :meth:`repro_torch.core.simclock.Wire.transmit`.
    2. **Destination clock.**  Due crossings are delivered at a window start;
       the destination domain only ever advanced strictly below the previous
       window end, which the crossing's fire time must meet or exceed.
    3. **Per-destination delivery order.**  ``_deliver_due`` hands each
       domain its crossings sorted by ``(fire_t, birth)`` under a monotone
       window end, so the delivery key per destination must never decrease.

    ``latency_ns`` is the conservative (minimum) link latency — the engines'
    ``delta``.  ``gbps <= 0`` drops the serialization term, keeping the bound
    sound for mixed-rate fabrics.
    """

    def __init__(self, latency_ns: int, gbps: float = 0.0):
        self.latency_ns = int(latency_ns)
        self.gbps = float(gbps)
        self.checked = 0
        self._last: Dict[int, Tuple[int, tuple]] = {}

    def _serialization_ns(self, nbytes: int) -> int:
        if self.gbps <= 0:
            return 0
        return int(round(nbytes * 8 / self.gbps))

    @staticmethod
    def _frame_len(crossing: Crossing) -> int:
        payload = crossing[4]
        if crossing[3] == "fwd":
            payload = payload[1]
        try:
            return len(payload)
        except TypeError:
            return 0

    def check(self, crossing: Crossing,
              dst_clock_ns: Optional[int] = None) -> None:
        """Validate one crossing just before delivery; raises
        :class:`CausalityError` on any invariant breach."""
        dst, fire_t, birth, kind, _payload = crossing
        self.checked += 1
        bound = (int(birth[0]) + self._serialization_ns(
            self._frame_len(crossing)) + self.latency_ns)
        if fire_t < bound:
            raise CausalityError(
                f"crossing to domain {dst} ({kind}) fires at {fire_t} ns, "
                f"before its conservative bound {bound} ns (birth "
                f"{birth!r} + serialization + link latency "
                f"{self.latency_ns} ns)")
        if dst_clock_ns is not None and fire_t < dst_clock_ns:
            raise CausalityError(
                f"crossing to domain {dst} ({kind}) fires at {fire_t} ns, "
                f"behind the destination clock at {dst_clock_ns} ns — the "
                "domain already simulated past the delivery instant")
        key = (int(fire_t), tuple(birth))
        prev = self._last.get(dst)
        if prev is not None and key < prev:
            raise CausalityError(
                f"crossing to domain {dst} ({kind}) delivered out of order: "
                f"key {key!r} after {prev!r} — (fire_t, birth) delivery "
                "order per destination must be non-decreasing")
        self._last[dst] = key


class DomainScheduler:
    """An :class:`~repro_torch.core.simclock.EventScheduler` drop-in whose tie-break
    is a birth key instead of a process-local FIFO counter.

    The EventScheduler API (``schedule_at``/``schedule_in``/``cancel``/
    ``next_time_ns``/``run_until``/``run_next``/``__len__``/``.clock``) is
    preserved so descriptor-ring writeback timers and DCA plumbing attach to
    a domain unchanged.  On top of it: :meth:`begin_phase` establishes the
    mint context for a client-emission or node-round phase, and every
    ``schedule_*`` call (or explicit :meth:`mint_birth`) stamps the next
    birth in that context.  While an event executes, the context is the
    event's own birth — children sort after their parent, in FIFO order
    among siblings, exactly like fresh sequence numbers in the shared loop.
    """

    def __init__(self, clock: SimClock):
        self.clock = clock
        self._heap: List[Tuple[int, tuple, int, Callable[[], None]]] = []
        self._live: set = set()
        self._next_token = 0
        self._ctx: tuple = _PRE_RUN_CTX
        self._k = 0
        self._phase_key: Optional[tuple] = None
        # per-(t, phase, idx) counters persist across re-rounds at one
        # instant (the quiet-fabric flush re-round); cleared on time change
        self._phase_t = -1
        self._phase_k: Dict[tuple, int] = {}

    # -- birth minting --------------------------------------------------------
    def begin_phase(self, t: int, phase: int, idx: int) -> None:
        """Enter mint context ``(t, phase, idx)`` — phase 0 for client
        emissions, 2 for node poll/drain rounds (1 is reserved for event
        execution).  The per-context counter resumes where a previous round
        at the same instant left it."""
        t = int(t)
        if t != self._phase_t:
            self._phase_k.clear()
            self._phase_t = t
        key = (t, phase, idx)
        self._ctx = key
        self._phase_key = key
        self._k = self._phase_k.get(key, 0)

    def mint_birth(self) -> tuple:
        birth = self._ctx + (self._k,)
        self._k += 1
        if self._phase_key is not None:
            self._phase_k[self._phase_key] = self._k
        return birth

    # -- EventScheduler-compatible API ----------------------------------------
    def schedule_at(self, t_ns: int, fn: Callable[[], None]) -> int:
        return self.schedule_with_birth(t_ns, self.mint_birth(), fn)

    def schedule_in(self, delay_ns: int, fn: Callable[[], None]) -> int:
        return self.schedule_at(self.clock.now_ns + int(delay_ns), fn)

    def schedule_with_birth(self, t_ns: int, birth: tuple,
                            fn: Callable[[], None]) -> int:
        token = self._next_token
        self._next_token += 1
        self._live.add(token)
        heapq.heappush(self._heap, (int(t_ns), birth, token, fn))
        return token

    def cancel(self, token: int) -> bool:
        if token not in self._live:
            return False
        self._live.discard(token)
        if len(self._heap) > 64 and len(self._heap) > 4 * len(self._live):
            self._heap = [e for e in self._heap if e[2] in self._live]
            heapq.heapify(self._heap)
        return True

    def __len__(self) -> int:
        return len(self._live)

    def _drop_dead(self) -> None:
        heap = self._heap
        while heap and heap[0][2] not in self._live:
            heapq.heappop(heap)

    def next_time_ns(self) -> Optional[int]:
        self._drop_dead()
        return self._heap[0][0] if self._heap else None

    def run_next(self) -> bool:
        self._drop_dead()
        if not self._heap:
            return False
        t, birth, token, fn = heapq.heappop(self._heap)
        self._live.discard(token)
        self.clock.advance_to(t)
        saved = (self._ctx, self._k, self._phase_key)
        self._ctx = (t, 1) + birth
        self._k = 0
        self._phase_key = None
        try:
            fn()
        finally:
            self._ctx, self._k, self._phase_key = saved
        return True

    def run_until(self, t_ns: int) -> int:
        fired = 0
        while True:
            nt = self.next_time_ns()
            if nt is None or nt > t_ns:
                break
            self.run_next()
            fired += 1
        self.clock.advance_to(t_ns)
        return fired


class DomainSwitch(Switch):
    """The switch, rehomed into its own domain.

    Endpoints no longer call :meth:`send` — each endpoint domain owns its
    port's uplink :class:`~repro_torch.core.simclock.Wire` (only that endpoint ever
    transmits on it, so the FIFO arithmetic is unchanged) and emits a ``fwd``
    crossing instead.  The forward pipeline (classify -> route -> AQM ->
    enqueue) is inherited verbatim from :class:`~repro_torch.core.switch.Switch`;
    only the emission stage differs — delivery becomes a ``deliver`` crossing
    to the egress port's owner domain.  Tx counters are charged at crossing
    mint time (the shared loop charges them at delivery, and nothing reads
    them before the final report, so end state is identical).
    """

    def __init__(self, n_ports: int, sched: DomainScheduler, gbps: float,
                 latency_ns: int, egress_capacity: int,
                 domain_of_port: Sequence[int], outbox: List[Crossing]):
        super().__init__(n_ports, sched, gbps=gbps, latency_ns=latency_ns,
                         egress_capacity=egress_capacity)
        self._domain_of_port = list(domain_of_port)
        self._outbox = outbox

    def send(self, port_id: int, frame: np.ndarray,
             t_ns: Optional[int] = None) -> None:
        raise RuntimeError(
            "partitioned fabric: endpoints transmit on their own uplink "
            "wires (ClientDomain/NodeDomain emit crossings), not Switch.send")

    def _emit(self, out, frame: np.ndarray, arrival: int) -> None:
        out.tx_frames += 1
        out.tx_bytes += len(frame)
        self._outbox.append((self._domain_of_port[out.port_id], arrival,
                             self.sched.mint_birth(), "deliver", frame))


class _DomainBase:
    """Window-bounded free-running: process local candidates strictly below
    the window end, one round per candidate instant."""

    ds: DomainScheduler
    outbox: List[Crossing]

    @property
    def clock(self) -> SimClock:
        return self.ds.clock

    def next_candidate(self) -> Optional[int]:
        raise NotImplementedError

    def round_at(self, now: int) -> int:
        raise NotImplementedError

    def run_window(self, w_end: int) -> int:
        moved = 0
        while True:
            c = self.next_candidate()
            if c is None or c >= w_end:
                return moved
            self.clock.advance_to(c)
            moved += self.round_at(self.clock.now_ns)


class ClientDomain(_DomainBase):
    """One fabric-attached load generator: analytic emission schedule in,
    RTT completions (``deliver`` crossings) out."""

    kind = "client"

    def __init__(self, index: int, ds: DomainScheduler, lg, pool, port_id: int,
                 uplink: Wire, times: np.ndarray, sizes: Optional[np.ndarray],
                 rng, verify_integrity: bool, switch_domain: int,
                 outbox: List[Crossing]):
        self.index = index
        self.ds = ds
        self.lg = lg
        self.pool = pool
        self.port_id = port_id
        self.uplink = uplink
        self.times = times
        self.sizes = sizes
        self.rng = rng
        self.verify_integrity = verify_integrity
        self.switch_domain = switch_domain
        self.outbox = outbox
        self.cursor = 0

    def next_candidate(self) -> Optional[int]:
        cands = []
        if self.cursor < len(self.times):
            cands.append(int(self.times[self.cursor]))
        nt = self.ds.next_time_ns()
        if nt is not None:
            cands.append(nt)
        return min(cands) if cands else None

    def round_at(self, now: int) -> int:
        ds = self.ds
        ds.begin_phase(now, 0, self.index)
        times, sizes, i = self.times, self.sizes, self.cursor
        n = len(times)
        while i < n and times[i] <= now:
            t_emit = int(times[i])
            frame = self.lg.make_frame(
                self.pool, int(sizes[i]), t_emit,
                self.rng if self.verify_integrity else None)
            if frame is not None:
                arrival = self.uplink.transmit(t_emit, len(frame))
                self.outbox.append((self.switch_domain, arrival,
                                    ds.mint_birth(), "fwd",
                                    (self.port_id, frame)))
            i += 1
        moved = i - self.cursor
        self.cursor = i
        moved += ds.run_until(now)
        return moved

    def accept(self, crossing: Crossing) -> None:
        _dst, fire_t, birth, kind, frame = crossing
        assert kind == "deliver", kind
        lg = self.lg
        self.ds.schedule_with_birth(
            fire_t, birth, lambda: lg.complete_frame(frame, fire_t))

    def chunk(self) -> Dict[str, object]:
        m = self.lg.meter
        return {"sent": self.lg.flight.sent,
                "received": self.lg.flight.received,
                "integrity_errors": self.lg.flight.integrity_errors,
                "latency": self.lg.latency.values().copy(),
                "meter": (m.packets, m.bytes, m.start_ns, m.end_ns)}


class NodeDomain(_DomainBase):
    """One simulated host: NIC deliveries in, served/echoed frames out."""

    kind = "node"

    def __init__(self, index: int, ds: DomainScheduler, dev, pool, server,
                 port_id: int, uplink: Wire, max_tx_burst: int,
                 switch_domain: int, outbox: List[Crossing]):
        self.index = index
        self.ds = ds
        self.dev = dev
        self.pool = pool
        self.server = server
        self.port_id = port_id
        self.uplink = uplink
        self.max_tx_burst = max_tx_burst
        self.switch_domain = switch_domain
        self.outbox = outbox

    def next_candidate(self) -> Optional[int]:
        cands = []
        nt = self.ds.next_time_ns()
        if nt is not None:
            cands.append(nt)
        nf = self.server.next_free_ns(self.clock.now_ns)
        if nf is not None:
            cands.append(nf)
        return min(cands) if cands else None

    def round_at(self, now: int) -> int:
        moved = self.ds.run_until(now)
        self.ds.begin_phase(now, 2, self.index)
        moved += self.server.poll_at(now)
        moved += self._drain_tx(now)
        return moved

    def _drain_tx(self, now: int) -> int:
        slots, lengths = self.dev.drain_tx_bursts(self.max_tx_burst)
        n = len(slots)
        for k in range(n):
            slot = int(slots[k])
            frame = self.pool.view(slot, int(lengths[k])).copy()
            self.pool.free(slot)
            arrival = self.uplink.transmit(now, len(frame))
            self.outbox.append((self.switch_domain, arrival,
                                self.ds.mint_birth(), "fwd",
                                (self.port_id, frame)))
        return n

    def accept(self, crossing: Crossing) -> None:
        _dst, fire_t, birth, kind, frame = crossing
        assert kind == "deliver", kind
        self.ds.schedule_with_birth(
            fire_t, birth, lambda: self._nic_deliver(frame))

    def _nic_deliver(self, frame: np.ndarray) -> None:
        slot = self.pool.alloc()
        if slot is None:
            return  # arena exhausted: the dev's rx_nombuf counter records it
        n = len(frame)
        self.pool.arena[slot, :n] = frame
        self.pool.lengths[slot] = n
        self.dev.deliver(slot, n)

    def flush(self) -> None:
        self.dev.flush_rx()

    def chunk(self) -> Dict[str, object]:
        st = self.dev.stats()
        out: Dict[str, object] = {
            "ipackets": st.ipackets, "imissed": st.imissed,
            "rx_nombuf": st.rx_nombuf,
            "writeback": writeback_extras([self.dev]),
        }
        if hasattr(self.server, "extras"):
            out["stack"] = dict(self.server.extras())
        return out


class SwitchDomain(_DomainBase):
    """The fabric: ``fwd`` crossings in, ``deliver`` crossings out."""

    kind = "switch"

    def __init__(self, index: int, ds: DomainScheduler, switch: DomainSwitch):
        self.index = index
        self.ds = ds
        self.switch = switch
        self.outbox = switch._outbox

    def next_candidate(self) -> Optional[int]:
        return self.ds.next_time_ns()

    def round_at(self, now: int) -> int:
        return self.ds.run_until(now)

    def accept(self, crossing: Crossing) -> None:
        _dst, fire_t, birth, kind, payload = crossing
        assert kind == "fwd", kind
        in_port, frame = payload
        sw = self.switch
        self.ds.schedule_with_birth(
            fire_t, birth, lambda: sw._forward(in_port, frame))

    def chunk(self) -> Dict[str, object]:
        return {"extras": self.switch.extras()}


def assign_groups(n_domains: int, n_groups: int) -> List[List[int]]:
    """Deterministic domain → execution-group assignment.  The switch (by
    convention the last domain) talks to everyone, so it gets a group of its
    own when more than one group exists; endpoints round-robin over the
    rest.  Grouping never changes results — domains inside one window are
    independent — only which worker runs them."""
    n_groups = max(1, min(int(n_groups), n_domains))
    if n_groups == 1:
        return [list(range(n_domains))]
    buckets: List[List[int]] = [[] for _ in range(n_groups - 1)]
    for d in range(n_domains - 1):
        buckets[d % (n_groups - 1)].append(d)
    return [b for b in buckets if b] + [[n_domains - 1]]


def _deliver_due(pending: List[Crossing], w_end: int,
                 ) -> Tuple[List[Crossing], List[Crossing]]:
    """Split pending crossings into (due before w_end, still pending); due
    ones are sorted by (fire_t, birth) so delivery order is deterministic
    no matter which worker produced them in what order."""
    due = [c for c in pending if c[1] < w_end]
    rest = [c for c in pending if c[1] >= w_end]
    due.sort(key=lambda c: (c[1], c[2]))
    return due, rest


class PartitionEngine:
    """In-process window loop over a set of domains (mode ``partitioned``).

    Each iteration: the next window ends ``delta`` (the minimum link
    latency) past the earliest pending activity, due crossings enter their
    domains' heaps, every group of domains runs up to the window end, and
    freshly minted crossings join the pending set.  At quiescence the
    quiet-fabric flush mirrors the shared loop: every node advances to the
    global max clock, flushes timeout-held descriptor writebacks, then runs
    one harvest round; a second quiescence ends the run.
    """

    def __init__(self, domains: Sequence[_DomainBase], delta: int,
                 outbox: List[Crossing], n_groups: int = 1,
                 max_rounds: int = 50_000_000,
                 trace: Optional[List[Crossing]] = None,
                 sanitizer: Optional[PartitionSanitizer] = None):
        if delta < 1:
            raise ValueError("partitioned execution needs link latency >= 1ns")
        self.domains = list(domains)
        self.delta = int(delta)
        self.outbox = outbox
        self.groups = assign_groups(len(self.domains), n_groups)
        self.max_rounds = max_rounds
        self.trace = trace
        self.sanitizer = sanitizer
        self.n_windows = 0

    def _drain_outbox(self, pending: List[Crossing]) -> None:
        if self.trace is not None:
            self.trace.extend(self.outbox)
        pending.extend(self.outbox)
        self.outbox.clear()

    def run(self) -> int:
        pending: List[Crossing] = []
        flushed_idle = False
        rounds = 0
        while True:
            cands = [c for c in (d.next_candidate() for d in self.domains)
                     if c is not None]
            cands.extend(c[1] for c in pending)
            if cands:
                flushed_idle = False
                w_end = min(cands) + self.delta
                due, pending = _deliver_due(pending, w_end)
                for c in due:
                    if self.sanitizer is not None:
                        self.sanitizer.check(
                            c, self.domains[c[0]].clock.now_ns)
                    self.domains[c[0]].accept(c)
                for group in self.groups:
                    for di in group:
                        rounds += self.domains[di].run_window(w_end)
                self._drain_outbox(pending)
                self.n_windows += 1
                if rounds > self.max_rounds:
                    raise RuntimeError(
                        f"PartitionEngine exceeded max_rounds="
                        f"{self.max_rounds} without quiescing — a node stack "
                        "is likely re-addressing frames to itself or "
                        "traffic never drains")
                continue
            if not flushed_idle:
                t_flush = max(d.clock.now_ns for d in self.domains)
                for d in self.domains:
                    if d.kind == "node":
                        d.clock.advance_to(t_flush)
                        d.flush()
                for d in self.domains:
                    if d.kind == "node":
                        rounds += d.round_at(t_flush)
                self._drain_outbox(pending)
                flushed_idle = True
                continue
            break
        return rounds

    @property
    def final_clock_ns(self) -> int:
        return max((d.clock.now_ns for d in self.domains), default=0)

    def chunks(self) -> Dict[int, Dict[str, object]]:
        return {i: d.chunk() for i, d in enumerate(self.domains)}


# -- multiprocessing mode -----------------------------------------------------

def _pack_crossings(crossings: List[Crossing]) -> Tuple[list, bytes]:
    """Flatten crossings into (metadata list, one contiguous frame buffer).

    Pickling a window's crossings naively costs one ndarray reduction per
    frame; a 64-frame window is 64 small pickle objects each way.  Packed,
    the same window is one metadata list (ints, birth tuples, kinds) plus a
    single bytes blob every frame is concatenated into — one pickled list
    per (worker, window) message regardless of crossing count.  A payload
    that isn't a plain frame (or ``(port, frame)``) rides in the metadata
    row unpacked, so exotic crossings stay correct, just unoptimized.
    """
    metas: list = []
    buf = bytearray()
    for dst, fire, birth, kind, payload in crossings:
        if kind == "fwd":
            port, frame = payload
        else:
            port, frame = -1, payload
        if not (isinstance(frame, np.ndarray) and frame.dtype == np.uint8
                and frame.ndim == 1):
            metas.append((dst, fire, birth, kind, None, payload))
            continue
        off = len(buf)
        buf += frame.tobytes()
        metas.append((dst, fire, birth, kind, port, (off, len(frame))))
    return metas, bytes(buf)


def _unpack_crossings(metas: list, buf: bytes) -> List[Crossing]:
    """Inverse of :func:`_pack_crossings`.  Frames come back as writable
    disjoint views over one private copy of the buffer (the switch's ECN
    stage writes the CE bit in place), byte-identical to what was packed."""
    arr = np.frombuffer(bytearray(buf), dtype=np.uint8)
    out: List[Crossing] = []
    for dst, fire, birth, kind, port, span in metas:
        if port is None:
            out.append((dst, fire, birth, kind, span))
            continue
        off, ln = span
        frame = arr[off:off + ln]
        payload = (port, frame) if kind == "fwd" else frame
        out.append((dst, fire, birth, kind, payload))
    return out


def _mp_worker_main(conn, builder: Tuple[str, str], cfg_dict: dict,
                    ids: List[int]) -> None:
    """One worker: builds its subset of domains (via the exp-layer builder
    named by ``builder`` — imported lazily so repro_torch.core never imports
    repro_torch.exp at module load) and serves window/flush/report requests."""
    try:
        import importlib
        mod = importlib.import_module(builder[0])
        build = getattr(mod, builder[1])
        outbox: List[Crossing] = []
        domains: Dict[int, _DomainBase] = build(cfg_dict, ids, outbox)
        order = sorted(domains)

        def state() -> Tuple[dict, dict]:
            return ({i: domains[i].next_candidate() for i in order},
                    {i: domains[i].clock.now_ns for i in order})

        conn.send(("ready",) + state())
        while True:
            msg = conn.recv()
            op = msg[0]
            if op == "window":
                _op, w_end, metas, buf = msg
                for c in _unpack_crossings(metas, buf):
                    domains[c[0]].accept(c)
                moved = 0
                for i in order:
                    moved += domains[i].run_window(w_end)
                out = _pack_crossings(outbox)
                outbox.clear()
                conn.send(("done", moved, out) + state())
            elif op == "flush":
                _op, t_flush = msg
                moved = 0
                for i in order:
                    d = domains[i]
                    if d.kind == "node":
                        d.clock.advance_to(t_flush)
                        d.flush()
                for i in order:
                    d = domains[i]
                    if d.kind == "node":
                        moved += d.round_at(t_flush)
                out = _pack_crossings(outbox)
                outbox.clear()
                conn.send(("done", moved, out) + state())
            elif op == "report":
                conn.send(("report", {i: domains[i].chunk() for i in order}))
            else:  # "stop"
                break
    except BaseException:
        import traceback
        try:
            conn.send(("error", traceback.format_exc()))
        except Exception:
            pass
        raise
    finally:
        conn.close()


class MpPartitionEngine:
    """The window loop of :class:`PartitionEngine`, with domain groups living
    in worker processes (mode ``partitioned-mp``).  The coordinator only
    routes candidates and crossings; all simulation state stays worker-local,
    so per-window IPC is O(crossings), not O(state) — and crossings travel
    packed (:func:`_pack_crossings`): one metadata list plus one contiguous
    frame buffer per (worker, window) message instead of one pickled ndarray
    per frame.  Determinism: crossings are delivered sorted by
    (fire_t, birth) and every heap orders on the same key, so worker
    scheduling cannot reorder anything observable."""

    def __init__(self, cfg_dict: dict, builder: Tuple[str, str],
                 n_domains: int, delta: int, n_workers: int,
                 max_rounds: int = 50_000_000,
                 sanitizer: Optional[PartitionSanitizer] = None):
        if delta < 1:
            raise ValueError("partitioned execution needs link latency >= 1ns")
        self.delta = int(delta)
        self.max_rounds = max_rounds
        self.sanitizer = sanitizer
        self.n_windows = 0
        self.final_clock_ns = 0
        groups = assign_groups(n_domains, n_workers)
        methods = multiprocessing.get_all_start_methods()
        ctx = multiprocessing.get_context(
            "fork" if "fork" in methods else "spawn")
        self._owner: List[List[int]] = groups
        self._ownset = [set(g) for g in groups]
        self._conns = []
        self._procs = []
        try:
            for ids in groups:
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_mp_worker_main,
                                args=(child, builder, cfg_dict, ids),
                                daemon=True)
                p.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(p)
        except Exception:
            self.close()
            raise

    @property
    def n_workers(self) -> int:
        return len(self._procs)

    def _recv(self, conn, want: str):
        try:
            msg = conn.recv()
        except EOFError:
            raise RuntimeError("partition worker died mid-run")
        if msg[0] == "error":
            raise RuntimeError(f"partition worker failed:\n{msg[1]}")
        if msg[0] != want:
            raise RuntimeError(f"partition worker sent {msg[0]!r}, "
                               f"expected {want!r}")
        return msg

    def run(self) -> Dict[int, Dict[str, object]]:
        cands: Dict[int, Optional[int]] = {}
        clocks: Dict[int, int] = {}
        for conn in self._conns:
            _tag, wc, wk = self._recv(conn, "ready")
            cands.update(wc)
            clocks.update(wk)
        pending: List[Crossing] = []
        flushed_idle = False
        rounds = 0
        while True:
            cvals = [c for c in cands.values() if c is not None]
            cvals.extend(c[1] for c in pending)
            if cvals:
                flushed_idle = False
                w_end = min(cvals) + self.delta
                due, pending = _deliver_due(pending, w_end)
                if self.sanitizer is not None:
                    for c in due:
                        self.sanitizer.check(c, clocks.get(c[0]))
                active = []
                for wi, conn in enumerate(self._conns):
                    mine = [c for c in due if c[0] in self._ownset[wi]]
                    busy = bool(mine) or any(
                        cands.get(i) is not None and cands[i] < w_end
                        for i in self._owner[wi])
                    if not busy:
                        continue  # whole window is a no-op for this worker
                    conn.send(("window", w_end) + _pack_crossings(mine))
                    active.append(conn)
                for conn in active:
                    _tag, moved, out, wc, wk = self._recv(conn, "done")
                    rounds += moved
                    pending.extend(_unpack_crossings(*out))
                    cands.update(wc)
                    clocks.update(wk)
                self.n_windows += 1
                if rounds > self.max_rounds:
                    raise RuntimeError(
                        f"MpPartitionEngine exceeded max_rounds="
                        f"{self.max_rounds} without quiescing")
                continue
            if not flushed_idle:
                t_flush = max(clocks.values(), default=0)
                for conn in self._conns:
                    conn.send(("flush", t_flush))
                for conn in self._conns:
                    _tag, moved, out, wc, wk = self._recv(conn, "done")
                    rounds += moved
                    pending.extend(_unpack_crossings(*out))
                    cands.update(wc)
                    clocks.update(wk)
                flushed_idle = True
                continue
            break
        self.final_clock_ns = max(clocks.values(), default=0)
        chunks: Dict[int, Dict[str, object]] = {}
        for conn in self._conns:
            conn.send(("report",))
        for conn in self._conns:
            _tag, wchunks = self._recv(conn, "report")
            chunks.update(wchunks)
        return chunks

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("stop",))
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for conn in self._conns:
            try:
                conn.close()
            except Exception:
                pass

    def __enter__(self) -> "MpPartitionEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
