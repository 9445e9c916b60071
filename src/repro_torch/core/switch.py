"""Output-queued switch model — the multi-host fabric.

The paper's testbed faces the load generator at a single simulated host; the
scale-out direction (gem5 stdlib's dist-gem5 topologies, SimBricks-style
composition of independently-built node models) needs a fabric that connects
*several* hosts' NICs on one shared virtual clock.  This module is that
fabric: an output-queued Ethernet switch whose ports carry independently
modeled full-duplex links.

Model (per port):

* **ingress wire** — endpoint → switch: a frame handed to :meth:`Switch.send`
  at ``t`` pays serialization + propagation on its port's uplink
  (:class:`~repro_torch.core.simclock.Wire` FIFO semantics) before it reaches the
  forwarding logic.
* **forwarding pipeline** — on arrival the frame runs a P4sim-style pipeline
  of composable per-port stages: **classify** (parse the header, extract the
  match key — the flow dst_ip the load generator writes and RSS hashes,
  :func:`~repro_torch.core.packet.read_dst_ip`), **route** (longest-prefix-match
  table lookup; unroutable frames are dropped and counted), **AQM** (the
  egress port's queue-management policy decides pass/early-drop/CE-mark —
  see :class:`AqmRed`), and **enqueue** (the bounded egress buffer below).
* **egress queue** — each egress port owns a bounded drop-tail buffer in
  front of its egress wire.  A frame enqueues if fewer than ``capacity``
  frames are queued-or-serializing, serializes FIFO at the wire's rate, and
  lands at the endpoint ``latency_ns`` later; otherwise it is **dropped at
  the switch** — the loss mechanism of every incast workload, distinct from
  NIC-side ring overflow (``imissed``) and pool exhaustion (``rx_nombuf``).

The AQM stage is pluggable per port (:meth:`Switch.set_aqm`): the default is
the drop-tail behavior above (no policy object, no extra arithmetic — runs
bit-identically to the pre-pipeline switch), ``red`` drops probabilistically
before the buffer fills, and ``ecn`` applies the same RED curve as a CE mark
(:func:`~repro_torch.core.packet.set_ce`) instead of a drop.  RED randomness comes
from a counter-seeded splitmix64 stream per (seed, port, decision) — fully
deterministic, no wall-clock or global RNG state (simlint SL002).

Frames on the fabric are raw byte arrays (copies), never pool slots: each
node owns a private :class:`~repro_torch.core.packet.PacketPool`, exactly like
SimBricks peers own private memory, so crossing the fabric serializes out of
one arena and DMAs into another.

All timing runs through one :class:`~repro_torch.core.simclock.EventScheduler` on
the shared :class:`~repro_torch.core.simclock.SimClock` — two events per egress
frame (serialization end frees the buffer slot; arrival delivers to the
endpoint sink), one per ingress frame.  Deterministic: FIFO tie-breaks in the
scheduler plus insertion-ordered route/port structures make two runs of the
same topology bit-identical.

Own copy, in the PyTorch port, of ``src/repro/core/switch.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .packet import read_dst_ip, set_ce
from .simclock import EventScheduler, Wire

# an endpoint's delivery sink: (frame bytes, arrival time in virtual ns).
# The scheduler has already advanced the clock to the arrival time.
Sink = Callable[[np.ndarray, int], None]

# AQM stage verdicts
AQM_PASS = 0
AQM_DROP = 1
AQM_MARK = 2

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 output step — the deterministic per-decision uniform."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def aqm_uniform_u64(seed: int, port_id: int, counter: int) -> int:
    """The k-th uniform u64 of port ``port_id``'s AQM decision stream.

    Counter-seeded (seed, port, decision index) -> u64: replayable from
    counters alone, so partitioned replicas of a switch draw the identical
    stream — no shared-RNG state to keep in sync.
    """
    x = _splitmix64((int(seed) & _M64) ^ 0xD1B54A32D192ED03)
    x = _splitmix64(x ^ ((int(port_id) & _M64) * 0x9E3779B97F4A7C15 & _M64))
    return _splitmix64(x ^ (int(counter) & _M64))


def red_probability(depth: int, min_thresh: int, max_thresh: int,
                    max_p: float) -> float:
    """Classic RED curve on instantaneous queue depth (frames).

    0 below ``min_thresh``; linear ramp to ``max_p`` across the threshold
    band; certain (1.0) at or above ``max_thresh``.  Monotone non-decreasing
    in ``depth`` for any valid thresholds (min <= max) — the property the
    hypothesis suite pins.
    """
    if depth >= max_thresh:
        return 1.0
    if depth < min_thresh:
        return 0.0
    return max_p * (depth - min_thresh) / float(max_thresh - min_thresh)


class AqmRed:
    """RED-family AQM policy for one egress port: early-drop or CE-mark.

    ``kind`` selects the action taken when the RED curve fires: ``"red"``
    drops the arriving frame before it occupies a buffer slot; ``"ecn"``
    sets the CE bit and lets the frame through (the DCTCP fabric half).
    Decisions observe the arriving-frame-inclusive depth (``occupancy + 1``,
    DCTCP's mark-on-enqueue convention) and sample the port's occupancy
    high-water at decision time — so a port whose policy refuses frames at
    depth k still records the demand that reached it (the enqueue-only
    sampling bug this stage fixes).
    """

    __slots__ = ("kind", "min_thresh", "max_thresh", "max_p", "seed",
                 "decisions", "ecn_marked", "early_drops")

    def __init__(self, kind: str, min_thresh: int, max_thresh: int,
                 max_p: float, seed: int):
        if kind not in ("red", "ecn"):
            raise ValueError(f"unknown AQM kind {kind!r}")
        if not 1 <= min_thresh <= max_thresh:
            raise ValueError("need 1 <= min_thresh <= max_thresh")
        if not 0.0 < max_p <= 1.0:
            raise ValueError("max_p must be in (0, 1]")
        self.kind = kind
        self.min_thresh = int(min_thresh)
        self.max_thresh = int(max_thresh)
        self.max_p = float(max_p)
        self.seed = int(seed)
        self.decisions = 0          # the per-port RNG counter
        self.ecn_marked = 0
        self.early_drops = 0

    def decide(self, port: "SwitchPort") -> int:
        depth = port.occupancy + 1
        # satellite fix: record demand when the policy looks, not only on
        # enqueue — a RED drop at depth k must leave occ_high >= k
        if depth > port.occ_high:
            port.occ_high = depth
        k = self.decisions
        self.decisions += 1
        p = red_probability(depth, self.min_thresh, self.max_thresh,
                            self.max_p)
        if p <= 0.0:
            return AQM_PASS
        if aqm_uniform_u64(self.seed, port.port_id, k) >= int(p * 2.0 ** 64):
            return AQM_PASS
        if self.kind == "ecn":
            self.ecn_marked += 1
            return AQM_MARK
        self.early_drops += 1
        return AQM_DROP


class SwitchPort:
    """One full-duplex switch port: uplink + egress wire + bounded buffer."""

    __slots__ = ("port_id", "ingress", "egress", "capacity", "sink",
                 "occupancy", "occ_high", "rx_frames", "tx_frames",
                 "tx_bytes", "egress_enqueued", "egress_drops", "aqm")

    def __init__(self, port_id: int, gbps: float, latency_ns: int,
                 capacity: int):
        if capacity < 1:
            raise ValueError("egress capacity must be >= 1 frame")
        self.port_id = port_id
        self.ingress = Wire(gbps=gbps, latency_ns=latency_ns)
        self.egress = Wire(gbps=gbps, latency_ns=latency_ns)
        self.capacity = capacity
        self.sink: Optional[Sink] = None
        # occupancy counts frames enqueued-or-serializing on the egress side
        self.occupancy = 0
        self.occ_high = 0
        self.rx_frames = 0          # frames that entered the switch here
        self.tx_frames = 0          # frames delivered out of this port
        self.tx_bytes = 0
        self.egress_enqueued = 0
        self.egress_drops = 0       # drop-tail: egress buffer full
        self.aqm: Optional[AqmRed] = None   # None == plain drop-tail stage


class Switch:
    """N-port output-queued switch over one shared :class:`EventScheduler`.

    Endpoints (node NICs, fabric-attached load generators) are wired with
    :meth:`attach`; addresses with :meth:`add_route` (longest-prefix match,
    so a node gets a /32 and a generator's client space a /16).  Frames enter
    with :meth:`send`; every hop after that is an event on the scheduler.
    """

    def __init__(self, n_ports: int, sched: EventScheduler,
                 gbps: float = 100.0, latency_ns: int = 1_000,
                 egress_capacity: int = 64):
        if n_ports < 1:
            raise ValueError("a switch needs at least one port")
        self.sched = sched
        self.ports: List[SwitchPort] = [
            SwitchPort(i, gbps, latency_ns, egress_capacity)
            for i in range(n_ports)
        ]
        # (prefix_len, ip, mask) -> port, kept sorted longest-prefix-first
        self._routes: List[Tuple[int, int, int, int]] = []
        self._route_cache: Dict[int, Optional[int]] = {}
        self.unrouted = 0           # frames with no matching route

    @property
    def n_ports(self) -> int:
        return len(self.ports)

    # -- control plane --------------------------------------------------------
    def attach(self, port_id: int, sink: Sink) -> None:
        """Wire an endpoint's delivery sink to a port."""
        self.ports[port_id].sink = sink

    def set_aqm(self, port_id: int, aqm: Optional[AqmRed]) -> None:
        """Install (or clear) the AQM stage policy on one egress port."""
        self.ports[port_id].aqm = aqm

    def add_route(self, dst_ip: int, port_id: int, prefix_len: int = 32) -> None:
        """Route ``dst_ip/prefix_len`` out of ``port_id`` (LPM on lookup)."""
        if not 0 <= port_id < len(self.ports):
            raise ValueError(f"port {port_id} out of range [0, {len(self.ports)})")
        if not 0 <= prefix_len <= 32:
            raise ValueError("prefix_len must be in [0, 32]")
        mask = 0 if prefix_len == 0 else (0xFFFFFFFF << (32 - prefix_len)) & 0xFFFFFFFF
        self._routes.append((prefix_len, int(dst_ip) & mask, mask, port_id))
        # longest prefix first; insertion order breaks ties deterministically
        self._routes.sort(key=lambda r: -r[0])
        self._route_cache.clear()

    def lookup(self, dst_ip: int) -> Optional[int]:
        """Longest-prefix-match route lookup (None == unroutable)."""
        dst_ip = int(dst_ip)
        if dst_ip in self._route_cache:
            return self._route_cache[dst_ip]
        out: Optional[int] = None
        for _plen, ip, mask, port_id in self._routes:
            if (dst_ip & mask) == ip:
                out = port_id
                break
        self._route_cache[dst_ip] = out
        return out

    # -- data plane -----------------------------------------------------------
    def send(self, port_id: int, frame: np.ndarray,
             t_ns: Optional[int] = None) -> None:
        """An endpoint hands one frame to its port at ``t_ns`` (default: the
        clock's now).  The frame pays the uplink's serialization +
        propagation, then forwards on arrival at the switch."""
        port = self.ports[port_id]
        t = self.sched.clock.now_ns if t_ns is None else int(t_ns)
        arrival = port.ingress.transmit(t, len(frame))
        self.sched.schedule_at(arrival, lambda: self._forward(port_id, frame))

    def _forward(self, in_port_id: int, frame: np.ndarray) -> None:
        """Ingress arrival: run the per-port pipeline — classify -> route ->
        AQM -> enqueue.  Stages are methods so a subclass (the partitioned
        :class:`~repro_torch.core.partition.DomainSwitch`) can replace exactly one
        (egress emission) without forking the forward path."""
        key = self._classify(in_port_id, frame)
        out_id = self._route(key)
        if out_id is None:
            self.unrouted += 1
            return
        out = self.ports[out_id]
        verdict = self._aqm_decide(out)
        if verdict == AQM_DROP:
            return
        if verdict == AQM_MARK:
            set_ce(frame)
        self._enqueue(out, frame)

    # -- pipeline stages ------------------------------------------------------
    def _classify(self, in_port_id: int, frame: np.ndarray) -> int:
        """Parse stage: count the ingress arrival, extract the match key."""
        self.ports[in_port_id].rx_frames += 1
        return read_dst_ip(frame)

    def _route(self, dst_ip: int) -> Optional[int]:
        """Match stage: LPM table lookup (None == unroutable)."""
        return self.lookup(dst_ip)

    def _aqm_decide(self, out: SwitchPort) -> int:
        """AQM stage: the egress port's policy votes on the arriving frame.
        No policy installed == drop-tail: pass with zero extra arithmetic,
        so default configs run bit-identically to the pre-pipeline switch."""
        if out.aqm is None:
            return AQM_PASS
        return out.aqm.decide(out)

    def _enqueue(self, out: SwitchPort, frame: np.ndarray) -> None:
        """Enqueue stage: bounded drop-tail buffer in front of the egress
        wire, then emission (two scheduler events per frame)."""
        if out.occupancy >= out.capacity:
            out.egress_drops += 1   # drop-tail: the incast loss mechanism
            return
        out.occupancy += 1
        out.occ_high = max(out.occ_high, out.occupancy)
        out.egress_enqueued += 1
        nbytes = len(frame)
        now = self.sched.clock.now_ns
        arrival = out.egress.transmit(now, nbytes)
        ser_end = arrival - out.egress.latency_ns
        # the buffer slot frees when serialization completes (the frame has
        # left the switch), not when the frame lands after propagation
        self.sched.schedule_at(ser_end, lambda: self._egress_done(out))
        self._emit(out, frame, arrival)

    def _emit(self, out: SwitchPort, frame: np.ndarray, arrival: int) -> None:
        """Emission: hand the serialized frame to the egress wire's far end.
        The one stage partitioned execution overrides (a crossing record
        instead of a local delivery event)."""
        self.sched.schedule_at(arrival,
                               lambda: self._deliver(out, frame, arrival))

    def _egress_done(self, port: SwitchPort) -> None:
        port.occupancy -= 1

    def _deliver(self, port: SwitchPort, frame: np.ndarray,
                 arrival_ns: int) -> None:
        port.tx_frames += 1
        port.tx_bytes += len(frame)
        if port.sink is not None:
            port.sink(frame, arrival_ns)

    # -- telemetry ------------------------------------------------------------
    @property
    def egress_drops(self) -> int:
        """Total frames lost to full egress buffers, all ports."""
        return sum(p.egress_drops for p in self.ports)

    def extras(self, prefix: str = "sw") -> Dict[str, float]:
        """Per-port drop/occupancy counters, RunReport.extras-shaped.

        AQM keys appear only for ports with a policy installed — default
        (drop-tail) extras stay byte-identical to the pre-pipeline switch.
        """
        out: Dict[str, float] = {f"{prefix}_unrouted": float(self.unrouted)}
        for p in self.ports:
            out[f"{prefix}_p{p.port_id}_egress_drops"] = float(p.egress_drops)
            out[f"{prefix}_p{p.port_id}_egress_forwarded"] = float(p.tx_frames)
            out[f"{prefix}_p{p.port_id}_occ_high"] = float(p.occ_high)
            if p.aqm is not None:
                out[f"{prefix}_p{p.port_id}_ecn_marked"] = float(
                    p.aqm.ecn_marked)
                out[f"{prefix}_p{p.port_id}_aqm_early_drops"] = float(
                    p.aqm.early_drops)
        return out
