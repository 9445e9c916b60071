"""Multi-host topology builder + driver: N node testbeds and N fabric-attached
load-generator clients around one :class:`~repro_torch.core.switch.Switch`.

This is the SimBricks-style composition the ROADMAP called for: every node is
an independently-built model (its own :class:`~repro_torch.core.packet.PacketPool`,
its own :class:`~repro_torch.core.ethdev.EthDev`, its own server stack from the
same registry single-host testbeds use), and the pieces meet only on the
fabric — frames cross between address spaces as byte copies over modeled
wires.

The traffic shape is client/server: each client is a
:class:`~repro_torch.core.loadgen.LoadGen` attached to a switch port through the
fabric primitives (``make_frame``/``complete_frame``), addressing one target
node (``TopologyConfig.target``, or per-client ``client_targets``).  The
target's stack echoes each frame back to its sender (macs + flow IPs
swapped), so every client measures true four-hop RTTs: uplink → switch
egress queue → server NIC/stack → and the same in reverse.  With N clients
on one target this is the classic **incast**: the switch egress port facing
the target saturates first, and losses show up in the *switch's* per-port
drop counters while every NIC stays loss-free — exactly the observable the
incast benchmark asserts.

Two execution engines share this module, selected by ``cfg.partition``:

* ``shared-clock`` — :meth:`Cluster.run`, the reference loop: ONE
  :class:`~repro_torch.core.simclock.SimClock`, one
  :class:`~repro_torch.core.simclock.EventScheduler`, one round per virtual
  instant across every component.
* ``partitioned`` / ``partitioned-mp`` — :func:`run_partitioned_topology`
  splits the same config into per-endpoint domains driven by
  :class:`~repro_torch.core.partition.PartitionEngine` (optionally across worker
  processes).  :func:`partition_fallback_reason` names the configs the
  partition engine cannot prove equivalent for; those fall back to the
  shared loop, recording the reason in a
  :class:`~repro_torch.core.partition.PartitionRunInfo`.  For everything else the
  contract is **bit-identical** reports — both engines assemble their
  :class:`~repro_torch.core.telemetry.RunReport` from the same plain-data *chunks*
  (:func:`assemble_echo_report`), so they cannot drift apart structurally.

Determinism: one virtual timeline, birth-key/FIFO event tie-breaks,
per-client seeds derived from the config's content hash
(:mod:`repro_torch.exp.seeding` — NOT positional counters), and insertion-ordered
build/dispatch loops — the same ``TopologyConfig`` produces a bit-identical
``RunReport`` every run, under every engine.

Own copy, in the PyTorch port, of ``src/repro/exp/topology.py``: the same
numpy and plain Python, with its imports pointing into ``repro_torch``.
:data:`PARTITION_BUILDER` names this module, so the ``partitioned-mp``
workers import the port and never the JAX package.  The port has no serving
layer yet: the branches that would build serving clients raise
``NotImplementedError`` (:func:`repro_torch.exp.config.serving_unported`),
and the config refuses ``serving`` before a cluster is built.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (AqmRed, DctcpRateController, EthConf, EthDev,
                              EventScheduler, LatencyRecorder, LoadGen,
                              NetworkStack, PacketPool, RunReport, SimClock, Switch,
                              ThroughputMeter, TrafficPattern, Wire,
                              writeback_extras)
from repro_torch.core.packet import (l2fwd_echo, l2fwd_echo_vec, swap_macs,
                                     swap_macs_vec)
from repro_torch.core.partition import (ClientDomain, Crossing, DomainScheduler,
                                        DomainSwitch, MpPartitionEngine, NodeDomain,
                                        PartitionEngine, PartitionRunInfo,
                                        PartitionSanitizer, SwitchDomain)

from .config import CostConfig, NodeConfig, TopologyConfig, serving_unported
from .seeding import config_fingerprint, derive_seed
from .testbed import (apply_dca, build_stack, effective_stack_config,
                      effective_writeback_threshold)

CLIENT_IP_BASE = 0x0A000000   # client g owns 10.(g+1).0.0/16 on the fabric
NODE_AUTO_IP_BASE = 0xC0A80001  # auto-assigned node i: 192.168.0.(i+1)

# exp-layer builder the mp partition workers import to reconstruct their
# domain subset from a config dict (repro_torch.core stays exp-agnostic)
PARTITION_BUILDER = ("repro_torch.exp.topology", "build_partition_domains_subset")


@dataclass
class Node:
    """One live simulated host: private arena, one NIC, a server stack, and
    the switch port it hangs off."""

    cfg: NodeConfig
    ip: int
    pool: PacketPool
    dev: EthDev
    server: NetworkStack
    port_id: int


@dataclass
class Client:
    """One fabric-attached client population and its private buffer arena.

    Echo workloads drive a :class:`~repro_torch.core.loadgen.LoadGen`; serving
    topologies (``TopologyConfig.serving``, not ported yet) would drive the
    reference's ``ServingClient`` instead, with ``lg`` None."""

    lg: Optional[LoadGen]
    pool: PacketPool
    port_id: int
    seed: int
    serving: Optional[object] = None  # the reference's ServingClient


def _node_sink(node: Node) -> Callable[[np.ndarray, int], None]:
    """Switch egress → node NIC: DMA the wire bytes into the node's private
    arena and deliver through the normal NIC path (RSS steering, ring
    overflow drops, writeback thresholds all apply)."""
    pool, dev = node.pool, node.dev

    def sink(frame: np.ndarray, t_ns: int) -> None:
        slot = pool.alloc()
        if slot is None:
            return  # arena exhausted: the dev's rx_nombuf counter records it
        n = len(frame)
        pool.arena[slot, :n] = frame
        pool.lengths[slot] = n
        dev.deliver(slot, n)

    return sink


def _client_sink(client: Client) -> Callable[[np.ndarray, int], None]:
    """Switch egress → client: the reply is home; record RTT (echo) or
    token-stream SLO state (serving) at arrival."""

    if client.serving is not None:
        serving = client.serving

        def sink(frame: np.ndarray, t_ns: int) -> None:
            serving.complete_frame(frame, t_ns)

        return sink

    def sink(frame: np.ndarray, t_ns: int) -> None:
        client.lg.complete_frame(frame, t_ns)

    return sink


def _merge_extras(extras: Dict[str, float], new: Dict[str, float],
                  source: str) -> None:
    """Merge a component's extras into a RunReport, refusing key collisions.

    Every merge point used to be a blind ``dict.update``; a collision (two
    nodes exporting the same counter name, a stack reusing a switch key)
    silently replaced the earlier value and corrupted the report.  Now it
    raises, naming the offender."""
    for k in new:
        if k in extras:
            raise ValueError(
                f"RunReport extras key collision: {source} re-exports {k!r}")
    extras.update(new)


# -- shared build helpers (Cluster + partition domains) -----------------------

def _resolve_node_ips(cfg: TopologyConfig) -> List[int]:
    """Node fabric addresses, resolved up front so collisions fail loudly
    instead of silently shadowing a route (stable LPM sort keeps
    first-added)."""
    ips = [nc.ip if nc.ip else NODE_AUTO_IP_BASE + i
           for i, nc in enumerate(cfg.nodes)]
    if len(set(ips)) != len(ips):
        raise ValueError(
            f"resolved node ips collide: {[hex(ip) for ip in ips]}; "
            "auto-assignment uses 192.168.0.(index+1) — pick explicit "
            "ips outside that range")
    for ip in ips:
        if any(ip & 0xFFFF0000 == CLIENT_IP_BASE | ((g + 1) << 16)
               for g in range(cfg.n_clients)):
            raise ValueError(
                f"node ip {hex(ip)} falls inside a client /16 "
                f"(10.1.0.0 .. 10.{cfg.n_clients}.255.255); replies to "
                "that client would be shadowed")
    return ips


def _client_target_ip(cfg: TopologyConfig, g: int, ips: List[int]) -> int:
    """Client ``g``'s destination node address (``client_targets`` entry, or
    the topology-wide ``target``, or the first node)."""
    if cfg.client_targets is not None:
        name = cfg.client_targets[g]
    else:
        name = cfg.target or cfg.nodes[0].name
    for i, nc in enumerate(cfg.nodes):
        if nc.name == name:
            return ips[i]
    raise ValueError(f"target {name!r} names no node")  # config validates this


def _build_node_parts(nc: NodeConfig, i: int, clock: SimClock,
                      sched) -> Tuple[PacketPool, EthDev, NetworkStack]:
    """One node's private arena, NIC, and server stack — identical wiring for
    the shared-clock Cluster and a partitioned NodeDomain (``sched`` is an
    EventScheduler or a DomainScheduler; same API)."""
    pool = PacketPool(nc.pool.n_slots, nc.pool.slot_size)
    # the node NIC's own link is ideal: the switch port's wires carry
    # all link timing for this host
    dev = EthDev(pool, dev_id=i).configure(EthConf(
        n_rx_queues=nc.port.n_queues, n_tx_queues=nc.port.n_queues,
        rss_key=nc.port.rss.key,
        rss_table_size=nc.port.rss.table_size))
    for q in range(nc.port.n_queues):
        dev.rx_queue_setup(
            q, nc.port.ring_size,
            writeback_threshold=effective_writeback_threshold(
                nc.dca, nc.port.writeback_threshold, q))
        dev.tx_queue_setup(q, nc.port.ring_size)
    dev.dev_start()
    server = build_stack(effective_stack_config(nc.stack, nc.dca), [dev])
    if hasattr(server, "attach_clock"):
        cost = nc.stack.cost if nc.stack.cost is not None else CostConfig()
        server.attach_clock(clock, cost.to_host_cost_model())
    # the node's writeback timers ride the domain/cluster scheduler, so they
    # interleave deterministically with fabric events; same wiring as a
    # single-host testbed by construction
    apply_dca(nc.dca, [dev], server, sched)
    # a switched fabric needs replies re-addressed to their sender: upgrade
    # the stock L2Fwd transform to the echo variant (custom process fns
    # registered by scenario stacks are left alone)
    if getattr(server, "burst_process_fn", None) is swap_macs_vec:
        server.burst_process_fn = l2fwd_echo_vec
    if getattr(server, "process_fn", None) is swap_macs:
        server.process_fn = l2fwd_echo
    return pool, dev, server


def _echo_schedule(t, seed: int, dur_ns: int, start: int):
    """One client's analytic emission plan: (times, sizes, rng) — THE
    function both engines call, so a schedule can never diverge between
    them."""
    pattern = TrafficPattern(
        rate_gbps=t.rate_gbps, packet_size=t.packet_size, kind=t.kind,
        burst_len=t.burst_len, seed=seed)
    rng = np.random.default_rng(seed)
    times, sizes = pattern.emission_schedule(dur_ns, rng)
    if len(times):
        times = times + start
    return times, sizes, rng


class TrunkFabric:
    """Two switches joined by a trunk link, presenting the single-switch
    control/data-plane surface (``attach``/``add_route``/``send``/
    ``set_aqm``/``extras``) in the global endpoint namespace the builder
    already speaks (nodes ``0..N-1``, clients ``N..N+G-1``).

    Each switch carries its local endpoints plus one **trunk port** (always
    the switch's last port, pseudo ids ``N+G`` for switch 0 and ``N+G+1``
    for switch 1 in ``set_aqm``).  The trunk port's egress wire carries the
    trunk link's timing — set ``trunk.gbps`` below the aggregate edge rate
    and the core oversubscribes: the trunk egress queue builds and its
    drop/mark counters (``sw0_p*_...``/``sw1_p*_...`` extras) light up
    first.  Frames landing off one switch's trunk egress enter the peer's
    forward pipeline at arrival, so a cross-switch path pays: uplink →
    switch A queue+egress → trunk wire → switch B queue+egress → endpoint.

    Everything rides the one shared :class:`EventScheduler`, so the trunk
    fabric is exactly as deterministic as the single switch.
    """

    def __init__(self, cfg: TopologyConfig, sched: EventScheduler):
        link, trunk = cfg.switch.link, cfg.switch.trunk
        N, G = len(cfg.nodes), cfg.n_clients
        node_sw = cfg.node_switch or tuple(0 for _ in range(N))
        client_sw = cfg.client_switch or tuple(1 for _ in range(G))
        self.place: List[int] = list(node_sw) + list(client_sw)
        self.n_endpoints = N + G
        counts = [self.place.count(0), self.place.count(1)]
        self.switches: List[Switch] = [
            Switch(counts[si] + 1, sched, gbps=link.gbps,
                   latency_ns=link.latency_ns,
                   egress_capacity=cfg.switch.egress_capacity)
            for si in (0, 1)
        ]
        self.trunk_port = [counts[0], counts[1]]
        # local port ids assigned in global endpoint order (deterministic)
        self.local: List[int] = []
        next_id = [0, 0]
        for si in self.place:
            self.local.append(next_id[si])
            next_id[si] += 1
        for si, sw in enumerate(self.switches):
            tp = sw.ports[self.trunk_port[si]]
            # the trunk port's wires carry the trunk link's timing (the
            # ingress wire is unused — peer frames enter via _forward — but
            # is kept consistent for anyone reading port state)
            tp.egress = Wire(gbps=trunk.gbps, latency_ns=trunk.latency_ns)
            tp.ingress = Wire(gbps=trunk.gbps, latency_ns=trunk.latency_ns)
            peer, ptp = self.switches[1 - si], self.trunk_port[1 - si]
            sw.attach(self.trunk_port[si],
                      lambda frame, t_ns, _p=peer, _t=ptp:
                          _p._forward(_t, frame))

    def _home(self, eid: int) -> Tuple[int, Switch, int]:
        si = self.place[eid]
        return si, self.switches[si], self.local[eid]

    # -- the single-switch surface the builder/driver speak -------------------
    def attach(self, eid: int, sink) -> None:
        _, sw, lp = self._home(eid)
        sw.attach(lp, sink)

    def add_route(self, dst_ip: int, eid: int, prefix_len: int = 32) -> None:
        """Route on the home switch directly; on the peer, via its trunk."""
        si, sw, lp = self._home(eid)
        sw.add_route(dst_ip, lp, prefix_len)
        other = 1 - si
        self.switches[other].add_route(dst_ip, self.trunk_port[other],
                                       prefix_len)

    def send(self, eid: int, frame: np.ndarray,
             t_ns: Optional[int] = None) -> None:
        _, sw, lp = self._home(eid)
        sw.send(lp, frame, t_ns=t_ns)

    def set_aqm(self, pid: int, aqm: Optional[AqmRed]) -> None:
        if pid >= self.n_endpoints:   # pseudo ids: the two trunk ports
            si = pid - self.n_endpoints
            self.switches[si].set_aqm(self.trunk_port[si], aqm)
            return
        _, sw, lp = self._home(pid)
        sw.set_aqm(lp, aqm)

    def switch_index(self, pid: int) -> int:
        """Which physical switch owns fabric port ``pid`` (seed salt)."""
        if pid >= self.n_endpoints:
            return pid - self.n_endpoints
        return self.place[pid]

    @property
    def egress_drops(self) -> int:
        return sum(sw.egress_drops for sw in self.switches)

    def extras(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for si, sw in enumerate(self.switches):
            out.update(sw.extras(prefix=f"sw{si}"))
        return out


def _install_aqm(cfg: TopologyConfig, fabric) -> None:
    """Apply ``switch.pipeline`` to a built fabric: one fresh
    :class:`~repro_torch.core.switch.AqmRed` per non-drop-tail egress port.

    Port ids are global endpoint ids; a trunk fabric has two extra ports
    (``N+G`` = switch 0's trunk, ``N+G+1`` = switch 1's).  ``per_port_aqm``
    may cover just the endpoints (trunk ports fall through to the default
    policy) or every port.  On a trunk fabric the owning switch's index is
    added to the policy seed, so the two replicas draw distinct streams."""
    pipe = cfg.switch.pipeline
    if pipe is None:
        return
    n_end = len(cfg.nodes) + cfg.n_clients
    n_ports = n_end + (2 if cfg.switch.trunk is not None else 0)
    if pipe.per_port_aqm is not None \
            and len(pipe.per_port_aqm) not in (n_end, n_ports):
        raise ValueError(
            f"per_port_aqm has {len(pipe.per_port_aqm)} entries; this fabric "
            f"has {n_ports} ports ({n_end} endpoint-facing)")
    for pid in range(n_ports):
        ac = pipe.aqm_for(pid)
        if ac.kind == "drop-tail":
            continue
        salt = fabric.switch_index(pid) if isinstance(fabric, TrunkFabric) \
            else 0
        fabric.set_aqm(pid, AqmRed(
            kind=ac.kind, min_thresh=ac.min_thresh,
            max_thresh=ac.max_thresh, max_p=ac.max_p, seed=ac.seed + salt))


class Cluster:
    """Live multi-host scenario built from one :class:`TopologyConfig`."""

    def __init__(self, cfg: TopologyConfig, clock: SimClock,
                 sched: EventScheduler, switch: Switch, nodes: List[Node],
                 clients: List[Client]):
        self.cfg = cfg
        self.clock = clock
        self.sched = sched
        self.switch = switch
        self.nodes = nodes
        self.clients = clients

    @classmethod
    def build(cls, cfg: TopologyConfig) -> "Cluster":
        if cfg.serving is not None:
            raise serving_unported()
        clock = SimClock()
        sched = EventScheduler(clock)
        if cfg.switch.trunk is not None:
            switch = TrunkFabric(cfg, sched)
        else:
            switch = Switch(len(cfg.nodes) + cfg.n_clients, sched,
                            gbps=cfg.switch.link.gbps,
                            latency_ns=cfg.switch.link.latency_ns,
                            egress_capacity=cfg.switch.egress_capacity)
        _install_aqm(cfg, switch)
        ips = _resolve_node_ips(cfg)
        nodes: List[Node] = []
        for i, nc in enumerate(cfg.nodes):
            pool, dev, server = _build_node_parts(nc, i, clock, sched)
            node = Node(cfg=nc, ip=ips[i], pool=pool, dev=dev, server=server,
                        port_id=i)
            switch.attach(i, _node_sink(node))
            switch.add_route(ips[i], i, prefix_len=32)
            nodes.append(node)
        t = cfg.traffic
        # per-client seeds derive from the config's content hash, not the
        # client's position in some loop — a sweep runner can shuffle,
        # shard, or replay this config and always get the same streams
        fp = config_fingerprint(cfg.to_dict())
        clients: List[Client] = []
        for g in range(cfg.n_clients):
            port_id = len(nodes) + g
            pool = PacketPool(cfg.client_pool.n_slots, cfg.client_pool.slot_size)
            src_base = CLIENT_IP_BASE | ((g + 1) << 16)
            seed = derive_seed(fp, g, "client")
            lg = LoadGen([], ts_offset=t.ts_offset,
                         verify_integrity=t.verify_integrity,
                         max_tx_burst=t.max_tx_burst, n_flows=t.n_flows,
                         src_ip_base=src_base,
                         dst_ip=_client_target_ip(cfg, g, ips))
            client = Client(lg=lg, pool=pool, port_id=port_id, seed=seed)
            switch.attach(port_id, _client_sink(client))
            switch.add_route(src_base, port_id, prefix_len=16)
            clients.append(client)
        return cls(cfg, clock, sched, switch, nodes, clients)

    # -- driver ---------------------------------------------------------------
    def run(self, duration_s: Optional[float] = None,
            max_rounds: int = 50_000_000) -> RunReport:
        """Drive the whole cluster event-by-event in virtual time.

        Per round: due client emissions enter the fabric (stamped with their
        *scheduled* times), due fabric events fire (wire arrivals, egress
        completions, deliveries into NICs and clients), every node gets one
        scheduling round at virtual now and its TX drains back onto the
        fabric, then the clock advances to the earliest pending event.
        """
        t = self.cfg.traffic
        dur_ns = int((t.duration_s if duration_s is None else duration_s) * 1e9)
        clock, sched = self.clock, self.sched
        start = clock.now_ns
        end_t = start + dur_ns
        cc_on = t.cc_mode == "dctcp" and self.cfg.serving is None
        # per-client analytic schedules: [times, sizes, cursor, rng].  DCTCP
        # clients have no precomputed schedule (times=None): their cursor is
        # the next emission instant (float ns, None == done), minted per
        # frame from the controller's current rate.
        scheds: List[list] = []
        for client in self.clients:
            if client.serving is not None:
                times = client.serving.plan(dur_ns, start)
                scheds.append([times, None, 0, None])
                continue
            if cc_on:
                # Stagger window phases across clients so rate cuts and
                # recoveries do not synchronise (synchronised windows make
                # all clients overshoot and back off in lockstep, idling
                # the bottleneck).  The offset is a pure function of the
                # client index, so runs stay deterministic.
                phase = (len(scheds) * t.cc_window_ns) // max(
                    1, len(self.clients))
                client.lg.attach_cc(DctcpRateController(
                    rate_gbps=t.rate_gbps, window_ns=t.cc_window_ns,
                    gain=t.cc_gain, min_gbps=t.cc_min_gbps,
                    max_gbps=self.cfg.switch.link.gbps,
                    increase_gbps=t.cc_increase_gbps,
                    max_inflight=t.cc_max_inflight,
                    start_ns=start + phase))
                if dur_ns > 0:
                    client.lg.meter.open_window(start)
                scheds.append([None, None,
                               float(start) if dur_ns > 0 else None,
                               np.random.default_rng(client.seed)])
                continue
            times, sizes, rng = _echo_schedule(t, client.seed, dur_ns, start)
            if len(times):
                client.lg.meter.open_window(int(times[0]))
            scheds.append([times, sizes, 0, rng])
        flushed_idle = False
        for _ in range(max_rounds):
            now = clock.now_ns
            moved = 0
            # 1) due emissions, client order then time order (deterministic)
            for client, st in zip(self.clients, scheds):
                times, sizes, i, rng = st
                if times is None:   # DCTCP rate-adaptive client
                    cc = client.lg.cc
                    nxt = i
                    while nxt is not None and int(nxt) <= now:
                        t_emit = int(nxt)
                        # a tick that finds the in-flight cap exhausted is
                        # forfeited (paced probing): the cursor still
                        # advances, and the freed slot is used by the next
                        # tick after echoes drain the window
                        if cc.can_send():
                            frame = client.lg.make_frame(
                                client.pool, t.packet_size, t_emit,
                                rng if t.verify_integrity else None)
                            if frame is not None:
                                self.switch.send(client.port_id, frame,
                                                 t_ns=t_emit)
                        moved += 1
                        nxt += cc.gap_ns(t.packet_size)
                        if nxt >= end_t:
                            nxt = None
                    st[2] = nxt
                    continue
                n = len(times)
                while i < n and times[i] <= now:
                    t_emit = int(times[i])
                    if client.serving is not None:
                        # one due request == its whole frame flow; the
                        # uplink wire's FIFO serialization spaces the frames
                        for frame in client.serving.emit_request(i, t_emit):
                            self.switch.send(client.port_id, frame,
                                             t_ns=t_emit)
                    else:
                        frame = client.lg.make_frame(
                            client.pool, int(sizes[i]), t_emit,
                            rng if t.verify_integrity else None)
                        if frame is not None:
                            self.switch.send(client.port_id, frame,
                                             t_ns=t_emit)
                    i += 1
                    moved += 1
                st[2] = i
            # 2) fabric events due at now
            moved += sched.run_until(now)
            # 3) one scheduling round per node; TX drains onto the fabric
            for node in self.nodes:
                moved += node.server.poll_at(now)
                moved += self._drain_node_tx(node, now)
            # 4) advance to the next event
            cands: List[int] = []
            for st in scheds:
                if st[0] is None:
                    if st[2] is not None:
                        cands.append(int(st[2]))
                elif st[2] < len(st[0]):
                    cands.append(int(st[0][st[2]]))
            nt = sched.next_time_ns()
            if nt is not None:
                cands.append(nt)
            for node in self.nodes:
                nf = node.server.next_free_ns(now)
                if nf is not None:
                    cands.append(nf)
            if cands:
                flushed_idle = False
                clock.advance_to(min(cands))
                continue
            if moved > 0:
                flushed_idle = False
                continue
            if not flushed_idle:
                # quiet fabric: NIC timeout-driven descriptor writebacks fire
                for node in self.nodes:
                    node.dev.flush_rx()
                flushed_idle = True
                continue
            break  # nothing scheduled, nothing moving: remaining == drops
        else:
            raise RuntimeError(
                f"Cluster.run exceeded max_rounds={max_rounds} without "
                "quiescing — a node stack is likely re-addressing frames to "
                "itself (echo must swap flow IPs) or traffic never drains")
        return self._report(start)

    def _drain_node_tx(self, node: Node, now_ns: int) -> int:
        """Node NIC TX → fabric: serialize each reply out of the node's arena
        and hand it to the node's switch port."""
        slots, lengths = node.dev.drain_tx_bursts(self.cfg.traffic.max_tx_burst)
        n = len(slots)
        for k in range(n):
            slot = int(slots[k])
            frame = node.pool.view(slot, int(lengths[k])).copy()
            node.pool.free(slot)
            self.switch.send(node.port_id, frame, t_ns=now_ns)
        return n

    # -- reporting ------------------------------------------------------------
    def _report(self, start_ns: int) -> RunReport:
        """Merge every client's telemetry into one RunReport, with per-switch-
        port drop/occupancy counters and per-node NIC counters in extras.

        The echo path goes through the same plain-data *chunks* the
        partition engines report through (:func:`assemble_echo_report`), so
        the two execution modes share one assembly and cannot drift."""
        elapsed = float(self.clock.now_ns - start_ns)
        node_chunks = [_node_chunk(n.dev, n.server) for n in self.nodes]
        if self.cfg.serving is not None:
            rep = self._serving_report()
            _append_infra_extras(rep, self.cfg, node_chunks,
                                 self.switch.extras(), elapsed)
            return rep
        return assemble_echo_report(
            self.cfg, [_client_chunk(c.lg) for c in self.clients],
            node_chunks, self.switch.extras(), elapsed)

    def _serving_report(self) -> RunReport:
        """Serving semantics: sent/received count *requests*, the latency
        column is request E2E completion time, and the serving SLOs (TTFT /
        TPOT percentiles, virtual ns) ride in extras."""
        s = self.cfg.serving
        scs = [c.serving for c in self.clients]
        sent = sum(sc.requests_sent for sc in scs)
        received = sum(sc.requests_completed for sc in scs)
        e2e, ttft, tpot = LatencyRecorder(), LatencyRecorder(), LatencyRecorder()
        for sc in scs:
            for rec, merged in ((sc.e2e, e2e), (sc.ttft, ttft),
                                (sc.tpot, tpot)):
                vals = rec.values()
                if len(vals):
                    merged.record_many(vals)
        meter = ThroughputMeter()
        for sc in scs:
            m = sc.meter
            if m.start_ns is not None and m.end_ns is not None:
                meter.merge_counts(m.packets, m.bytes, m.start_ns, m.end_ns)
        rep = RunReport(
            offered_gbps=(s.qps * s.request_frame_bytes * 8 / 1e9
                          * len(self.clients)),
            achieved_gbps=meter.gbps,
            achieved_mpps=meter.mpps,
            sent=sent,
            received=received,
            dropped=sent - received,
            latency=e2e.stats(),
            histogram=e2e.histogram(),
        )
        x = rep.extras
        x["serving"] = 1.0
        x["offered_qps"] = float(s.qps * len(self.clients))
        for name, rec in (("ttft", ttft), ("tpot", tpot)):
            st = rec.stats()
            x[f"{name}_p50_ns"] = float(st.median_ns) if st else 0.0
            x[f"{name}_p99_ns"] = float(st.p99_ns) if st else 0.0
            x[f"{name}_mean_ns"] = float(st.mean_ns) if st else 0.0
            x[f"{name}_count"] = float(rec.count)
        for gi, sc in enumerate(scs):
            _merge_extras(x,
                          {f"g{gi}_{k}": v for k, v in sc.extras().items()},
                          f"client {gi} serving extras")
        return rep


# -- chunk-based report assembly (shared-clock AND partitioned) ---------------

def _client_chunk(lg: LoadGen) -> Dict[str, object]:
    """One echo client's contribution to the report, as plain picklable data
    (mirrors :meth:`repro_torch.core.partition.ClientDomain.chunk`)."""
    m = lg.meter
    out: Dict[str, object] = {
        "sent": lg.flight.sent,
        "received": lg.flight.received,
        "integrity_errors": lg.flight.integrity_errors,
        "latency": lg.latency.values().copy(),
        "meter": (m.packets, m.bytes, m.start_ns, m.end_ns)}
    # congestion telemetry keys exist only when the fabric marked something
    # or a rate controller ran — pre-AQM chunks (and the partition replicas
    # that mirror this function) stay byte-identical
    if lg.flight.ce_marked or lg.cc is not None:
        out["ce_marked"] = lg.flight.ce_marked
    if lg.cc is not None:
        out["cc_final_rate_gbps"] = lg.cc.rate_gbps
        out["cc_min_rate_gbps"] = lg.cc.rate_min
        out["cc_windows"] = lg.cc.windows
        out["cc_lost_inferred"] = lg.cc.lost_accounted
    return out


def _node_chunk(dev: EthDev, server: NetworkStack) -> Dict[str, object]:
    """One node's NIC/stack counters as plain data (mirrors
    :meth:`repro_torch.core.partition.NodeDomain.chunk`)."""
    st = dev.stats()
    out: Dict[str, object] = {
        "ipackets": st.ipackets, "imissed": st.imissed,
        "rx_nombuf": st.rx_nombuf,
        "writeback": writeback_extras([dev]),
    }
    if hasattr(server, "extras"):
        out["stack"] = dict(server.extras())
    return out


def _append_infra_extras(rep: RunReport, cfg: TopologyConfig,
                         node_chunks: Sequence[Dict[str, object]],
                         switch_extras: Dict[str, float],
                         virtual_elapsed_ns: float) -> None:
    """The report tail every topology run shares: sim provenance, per-node
    NIC counters + descriptor-writeback telemetry, switch port counters.
    Merge order is load-bearing (extras is insertion-ordered) — this one
    function defines it for both execution engines."""
    rep.extras["sim_time"] = 1.0
    rep.extras["virtual_elapsed_ns"] = virtual_elapsed_ns
    for ni, chunk in enumerate(node_chunks):
        name = cfg.nodes[ni].name
        rep.extras[f"n{ni}_rx_packets"] = float(chunk["ipackets"])
        rep.extras[f"n{ni}_imissed"] = float(chunk["imissed"])
        rep.extras[f"n{ni}_rx_nombuf"] = float(chunk["rx_nombuf"])
        # per-ring descriptor-writeback telemetry (the Fig. 4 observable)
        _merge_extras(rep.extras,
                      {f"n{ni}_{k}": v for k, v in chunk["writeback"].items()},
                      f"node {name!r} writeback telemetry")
        if "stack" in chunk:
            _merge_extras(
                rep.extras,
                {f"n{ni}_{k}": v for k, v in chunk["stack"].items()},
                f"node {name!r} stack extras")
    _merge_extras(rep.extras, switch_extras, "switch telemetry")


def assemble_echo_report(cfg: TopologyConfig,
                         client_chunks: Sequence[Dict[str, object]],
                         node_chunks: Sequence[Dict[str, object]],
                         switch_extras: Dict[str, float],
                         virtual_elapsed_ns: float) -> RunReport:
    """One echo RunReport from per-component chunks.  Every aggregation is
    order-fixed (client index, node index), so any engine that produces
    identical chunks produces a bit-identical report."""
    t = cfg.traffic
    sent = sum(c["sent"] for c in client_chunks)
    received = sum(c["received"] for c in client_chunks)
    lat = LatencyRecorder()
    for c in client_chunks:
        vals = c["latency"]
        if len(vals):
            lat.record_many(vals)
    meter = ThroughputMeter()
    for c in client_chunks:
        packets, nbytes, start_ns, end_ns = c["meter"]
        if start_ns is not None and end_ns is not None:
            meter.merge_counts(packets, nbytes, start_ns, end_ns)
    rep = RunReport(
        offered_gbps=t.rate_gbps * len(client_chunks),
        achieved_gbps=meter.gbps,
        achieved_mpps=meter.mpps,
        sent=sent,
        received=received,
        dropped=sent - received,
        latency=lat.stats(),
        histogram=lat.histogram(),
    )
    rep.extras["integrity_errors"] = float(
        sum(c["integrity_errors"] for c in client_chunks))
    for gi, c in enumerate(client_chunks):
        rep.extras[f"g{gi}_sent"] = float(c["sent"])
        rep.extras[f"g{gi}_received"] = float(c["received"])
        for key in ("ce_marked", "cc_final_rate_gbps", "cc_min_rate_gbps",
                    "cc_windows", "cc_lost_inferred"):
            if key in c:
                rep.extras[f"g{gi}_{key}"] = float(c[key])
    _append_infra_extras(rep, cfg, node_chunks, switch_extras,
                         virtual_elapsed_ns)
    return rep


# -- partitioned execution ----------------------------------------------------

def partition_fallback_reason(cfg: TopologyConfig) -> Optional[str]:
    """Why this config must run on the shared clock — or None if partitioned
    execution is provably bit-identical.

    The conservative-window argument needs (a) ≥ 1 ns of link latency (the
    lookahead window), and (b) every endpoint to expose its next activity as
    a candidate time.  A node whose host-cost model rounds to zero ns
    processes frames only when *polled*, and the shared loop polls every
    node at every global event time while a domain only rounds at its own —
    so zero-cost stacks (and stack kinds we haven't proven self-scheduling,
    e.g. the pipeline stack's zero-charge passes) stay on the shared clock.
    Serving topologies share live balancer state across nodes and are out of
    scope entirely.  The fabric features are conservatively excluded until
    proven: an active AQM policy reorders its decision counter relative to
    the shared loop's arrival interleaving, a trunk fabric inserts a
    switch-to-switch hop the single-SwitchDomain layout cannot express, and
    DCTCP clients adapt their *emission schedule* on echo feedback — the one
    thing the partition contract assumes is precomputable per domain."""
    if cfg.serving is not None:
        return "serving topology: balancer reads live cross-domain state"
    if cfg.switch.link.latency_ns < 1:
        return "zero-latency links leave no conservative lookahead window"
    if cfg.switch.trunk is not None:
        return "multi-switch trunk fabric not proven partition-equivalent"
    pipe = cfg.switch.pipeline
    if pipe is not None:
        kinds = {pipe.aqm.kind}
        for entry in pipe.per_port_aqm or ():
            if entry is not None:
                kinds.add(entry.kind)
        kinds.discard("drop-tail")   # explicit drop-tail == the default path
        if kinds:
            return (f"AQM policy {sorted(kinds)[0]!r} not proven "
                    "partition-equivalent")
    if cfg.traffic.cc_mode != "fixed":
        return "DCTCP rate-adaptive clients adapt on cross-domain echo feedback"
    for nc in cfg.nodes:
        kind = effective_stack_config(nc.stack, nc.dca).kind
        m = (nc.stack.cost if nc.stack.cost is not None
             else CostConfig()).to_host_cost_model()
        if kind == "bypass":
            if int(round(m.pmd_burst_ns(1))) < 1:
                return (f"node {nc.name!r}: zero-cost PMD model needs the "
                        "shared loop's every-round polling")
        elif kind == "kernel":
            if (int(round(m.ns(m.interrupt_cycles))) < 1
                    or int(round(m.ns(m.syscall_cycles
                                      + m.per_packet_kernel_cycles))) < 1):
                return (f"node {nc.name!r}: zero-cost kernel model needs the "
                        "shared loop's every-round polling")
        else:
            return (f"node {nc.name!r}: stack kind {kind!r} not proven "
                    "partition-equivalent")
    return None


def _build_domain(cfg: TopologyConfig, idx: int, outbox: List[Crossing]):
    """Domain ``idx`` of a partitioned topology, built standalone.

    Layout: clients 0..G-1, nodes G..G+N-1, the switch at G+N.  Every domain
    derives all shared facts (addresses, seeds, schedules) from ``cfg``
    alone, so workers can build disjoint subsets with no cross-talk."""
    G, N = cfg.n_clients, len(cfg.nodes)
    switch_domain = G + N
    link = cfg.switch.link
    ips = _resolve_node_ips(cfg)
    clock = SimClock()
    ds = DomainScheduler(clock)
    t = cfg.traffic
    if idx < G:  # client domain
        g = idx
        fp = config_fingerprint(cfg.to_dict())
        seed = derive_seed(fp, g, "client")
        pool = PacketPool(cfg.client_pool.n_slots, cfg.client_pool.slot_size)
        src_base = CLIENT_IP_BASE | ((g + 1) << 16)
        lg = LoadGen([], ts_offset=t.ts_offset,
                     verify_integrity=t.verify_integrity,
                     max_tx_burst=t.max_tx_burst, n_flows=t.n_flows,
                     src_ip_base=src_base,
                     dst_ip=_client_target_ip(cfg, g, ips))
        times, sizes, rng = _echo_schedule(
            t, seed, int(t.duration_s * 1e9), start=0)
        if len(times):
            lg.meter.open_window(int(times[0]))
        return ClientDomain(
            index=g, ds=ds, lg=lg, pool=pool, port_id=N + g,
            uplink=Wire(gbps=link.gbps, latency_ns=link.latency_ns),
            times=times, sizes=sizes, rng=rng,
            verify_integrity=t.verify_integrity,
            switch_domain=switch_domain, outbox=outbox)
    if idx < G + N:  # node domain
        ni = idx - G
        pool, dev, server = _build_node_parts(cfg.nodes[ni], ni, clock, ds)
        return NodeDomain(
            index=ni, ds=ds, dev=dev, pool=pool, server=server, port_id=ni,
            uplink=Wire(gbps=link.gbps, latency_ns=link.latency_ns),
            max_tx_burst=t.max_tx_burst, switch_domain=switch_domain,
            outbox=outbox)
    # switch domain: owns routes, egress wires/queues, and all drop counters
    domain_of_port = [G + i for i in range(N)] + list(range(G))
    sw = DomainSwitch(N + G, ds, gbps=link.gbps, latency_ns=link.latency_ns,
                      egress_capacity=cfg.switch.egress_capacity,
                      domain_of_port=domain_of_port, outbox=outbox)
    for i in range(N):
        sw.add_route(ips[i], i, prefix_len=32)
    for g in range(G):
        sw.add_route(CLIENT_IP_BASE | ((g + 1) << 16), N + g, prefix_len=16)
    return SwitchDomain(index=switch_domain, ds=ds, switch=sw)


def build_partition_domains_subset(cfg_dict: dict, ids: Sequence[int],
                                   outbox: List[Crossing]) -> Dict[int, object]:
    """mp-worker entry point (imported by name via
    :data:`PARTITION_BUILDER`): rebuild domains ``ids`` from a config
    dict."""
    cfg = TopologyConfig.from_dict(cfg_dict)
    return {i: _build_domain(cfg, i, outbox) for i in ids}


def _report_from_chunks(cfg: TopologyConfig, chunks: Dict[int, Dict[str, object]],
                        final_clock_ns: int) -> RunReport:
    G, N = cfg.n_clients, len(cfg.nodes)
    return assemble_echo_report(
        cfg,
        [chunks[g] for g in range(G)],
        [chunks[G + ni] for ni in range(N)],
        chunks[G + N]["extras"],
        float(final_clock_ns))


def _sanitize_enabled(cfg: TopologyConfig) -> bool:
    """Sanitizer opt-in: the config flag, or the env override (any value but
    '' / '0' turns it on — CI sets REPRO_PARTITION_SANITIZE=1 for the parity
    corpus)."""
    if cfg.partition_sanitize:
        return True
    return os.environ.get("REPRO_PARTITION_SANITIZE", "0") not in ("", "0")


def run_partitioned_topology(cfg: TopologyConfig, *,
                             info: Optional[PartitionRunInfo] = None,
                             n_groups: int = 1,
                             trace: Optional[List[Crossing]] = None
                             ) -> RunReport:
    """Run one topology config under its requested partition mode.

    Configs the engine cannot prove equivalent for (see
    :func:`partition_fallback_reason`) fall back to the shared-clock loop;
    ``info`` (if given) records what actually ran.  ``n_groups`` only
    regroups in-process domain execution (results are identical by
    construction); ``trace``, if a list, collects every boundary
    :data:`~repro_torch.core.partition.Crossing` for property tests.  With
    ``cfg.partition_sanitize`` (or env ``REPRO_PARTITION_SANITIZE=1``) every
    crossing delivery additionally runs through a
    :class:`~repro_torch.core.partition.PartitionSanitizer`, raising
    :class:`~repro_torch.core.partition.CausalityError` on any conservative-bound
    or ordering breach; ``info.n_sanitized`` counts the checks."""
    if info is None:
        info = PartitionRunInfo()
    info.mode_requested = cfg.partition
    reason = partition_fallback_reason(cfg) if cfg.partition != "shared-clock" \
        else None
    if cfg.partition == "shared-clock" or reason is not None:
        info.mode_used = "shared-clock"
        info.fallback_reason = reason
        info.n_workers = 1
        return Cluster.build(cfg).run()
    G, N = cfg.n_clients, len(cfg.nodes)
    n_domains = G + N + 1
    delta = cfg.switch.link.latency_ns
    info.n_domains = n_domains
    workers = cfg.partition_workers
    if cfg.partition == "partitioned-mp" and workers == 0:
        workers = max(2, os.cpu_count() or 1)
    sanitizer = (PartitionSanitizer(delta, gbps=cfg.switch.link.gbps)
                 if _sanitize_enabled(cfg) else None)
    if cfg.partition == "partitioned-mp" and workers > 1:
        eng = MpPartitionEngine(cfg.to_dict(), PARTITION_BUILDER, n_domains,
                                delta, workers, sanitizer=sanitizer)
        try:
            chunks = eng.run()
        finally:
            eng.close()
        info.mode_used = "partitioned-mp"
        info.n_windows = eng.n_windows
        info.n_workers = eng.n_workers
        if sanitizer is not None:
            info.n_sanitized = sanitizer.checked
        return _report_from_chunks(cfg, chunks, eng.final_clock_ns)
    # in-process: mode "partitioned", or "partitioned-mp" pinned to 1 worker
    outbox: List[Crossing] = []
    domains = [_build_domain(cfg, i, outbox) for i in range(n_domains)]
    eng = PartitionEngine(domains, delta, outbox, n_groups=n_groups,
                          trace=trace, sanitizer=sanitizer)
    eng.run()
    info.mode_used = "partitioned"
    info.n_windows = eng.n_windows
    info.n_workers = 1
    if sanitizer is not None:
        info.n_sanitized = sanitizer.checked
    return _report_from_chunks(cfg, eng.chunks(), eng.final_clock_ns)
