"""DPDK-faithful ``rte_ethdev`` facade over the :class:`~repro_torch.core.pmd.Port`
engine.

The paper's contribution is making gem5's NIC model speak the userspace-driver
contract DPDK expects.  This module is that contract for this repo: an
:class:`EthDev` walks the exact ``rte_ethdev`` lifecycle —

    UNCONFIGURED --configure()--> CONFIGURED
    CONFIGURED   --rx/tx_queue_setup() per queue, then dev_start()--> STARTED
    STARTED      --dev_stop()--> STOPPED
    STOPPED      --dev_start()--> STARTED   (counters persist, like hardware)
    STOPPED      --configure()--> CONFIGURED (reconfigure wipes queue setups)

Invalid transitions raise :class:`EthDevError` instead of silently doing the
wrong thing, exactly like DPDK's ``-EBUSY``/``-EINVAL`` returns.  The burst
dataplane calls — ``rx_burst(queue, nb)`` and ``tx_burst(queue, slots,
lengths)`` — are only legal while STARTED.

Stats follow DPDK's two-tier scheme: :meth:`EthDev.stats` returns the basic
``rte_eth_stats`` aggregate (``ipackets``/``opackets``/``imissed``/
``rx_nombuf``/…), while :meth:`EthDev.xstats` returns the *extended* named
counters (``rx_q{N}_packets``, ``rx_q{N}_errors``, ``tx_q{N}_packets``, …)
that wrap the existing descriptor-ring counters under one naming scheme.

The wire side (what the load generator drives: ``deliver``/``drain_tx``/…)
delegates to the owned :class:`Port`, so an ``EthDev`` drops into every slot
that previously took a ``Port``.

Own copy, in the PyTorch port, of ``src/repro/core/ethdev.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .descriptor import RxDescriptorRing, TxDescriptorRing
from .packet import PacketPool
from .pmd import Port
from .rss import DEFAULT_TABLE_SIZE, RssIndirection


class EthDevState(enum.Enum):
    UNCONFIGURED = "unconfigured"
    CONFIGURED = "configured"
    STARTED = "started"
    STOPPED = "stopped"


class EthDevError(RuntimeError):
    """Invalid lifecycle transition or dataplane call in the wrong state —
    the exception analogue of DPDK's ``-EBUSY``/``-EINVAL`` returns."""


@dataclass(frozen=True)
class EthConf:
    """``rte_eth_conf`` analogue: what ``configure()`` fixes for the device.

    Queue counts are set here (like ``nb_rx_q``/``nb_tx_q`` in
    ``rte_eth_dev_configure``); per-queue descriptor counts come later in
    ``rx_queue_setup``/``tx_queue_setup``, exactly like DPDK.
    """

    n_rx_queues: int = 1
    n_tx_queues: int = 1
    rss_key: Optional[bytes] = None          # None == the Microsoft default key
    rss_table_size: int = DEFAULT_TABLE_SIZE
    # wire parameters (virtual-time mode): serialization rate of the attached
    # link (<= 0 == ideal wire, the legacy behaviour) + one-way propagation
    link_gbps: float = 0.0
    link_latency_ns: int = 0

    def __post_init__(self) -> None:
        if self.n_rx_queues < 1 or self.n_tx_queues < 1:
            raise ValueError("queue counts must be >= 1")
        if self.n_rx_queues != self.n_tx_queues:
            # the Port engine pairs RX/TX queues one-to-one
            raise ValueError("n_rx_queues must equal n_tx_queues")
        if self.link_latency_ns < 0:
            raise ValueError("link_latency_ns must be >= 0")


@dataclass(frozen=True)
class EthStats:
    """Basic ``rte_eth_stats``: the aggregate counter block every DPDK app
    reads first."""

    ipackets: int = 0    # received by the host (delivered into RX rings)
    opackets: int = 0    # accepted for transmission (posted to TX rings)
    ibytes: int = 0      # bytes delivered into RX rings
    obytes: int = 0      # bytes accepted for transmission (pairs opackets;
    #                      wire-drained bytes are xstats tx_q*_transmitted_bytes)
    imissed: int = 0     # dropped at the NIC: no free RX descriptor
    ierrors: int = 0     # malformed input (always 0 in this model)
    oerrors: int = 0     # TX post failures (TX ring full)
    rx_nombuf: int = 0   # mbuf allocation failures (pool-scoped: the mempool
    #                      may be shared between devices, like a shared DPDK
    #                      mempool; since stats_reset on this device)

    def as_dict(self) -> Dict[str, int]:
        return dict(ipackets=self.ipackets, opackets=self.opackets,
                    ibytes=self.ibytes, obytes=self.obytes,
                    imissed=self.imissed, ierrors=self.ierrors,
                    oerrors=self.oerrors, rx_nombuf=self.rx_nombuf)


class EthDev:
    """One NIC device speaking the ``rte_ethdev`` lifecycle + burst API.

    Owns a :class:`~repro_torch.core.pmd.Port` as its internal engine once started;
    everything the legacy wire side needs (``deliver``, ``drain_tx``,
    per-queue counters) is delegated so an ``EthDev`` is a drop-in for a
    ``Port`` in servers and the load generator.
    """

    def __init__(self, pool: PacketPool, dev_id: int = 0):
        self.pool = pool
        self.dev_id = int(dev_id)
        self._state = EthDevState.UNCONFIGURED
        self._conf: Optional[EthConf] = None
        self._rx_rings: List[Optional[RxDescriptorRing]] = []
        self._tx_rings: List[Optional[TxDescriptorRing]] = []
        self._port: Optional[Port] = None
        self._rss: Optional[RssIndirection] = None
        # rx_nombuf baseline: the mempool may be shared between devices
        # (pool.alloc_failures is pool-scoped); the baseline makes
        # stats_reset() restart this device's view of the counter.
        self._nombuf_base = 0
        # event scheduler driving this device's descriptor-cache writeback
        # timeout timers (virtual-time DCA mode; see attach_dca)
        self.event_sched = None

    # -- lifecycle ------------------------------------------------------------
    @property
    def state(self) -> EthDevState:
        return self._state

    @property
    def conf(self) -> Optional[EthConf]:
        return self._conf

    def configure(self, conf: EthConf) -> "EthDev":
        """``rte_eth_dev_configure``: fix queue counts + RSS.  Legal from
        UNCONFIGURED, CONFIGURED (re-configure) and STOPPED; a running device
        must be stopped first.  Reconfiguring wipes all queue setups."""
        if self._state is EthDevState.STARTED:
            raise EthDevError(
                f"dev {self.dev_id}: configure() while STARTED; call dev_stop() first")
        self._conf = conf
        self._rx_rings = [None] * conf.n_rx_queues
        self._tx_rings = [None] * conf.n_tx_queues
        self._port = None
        # RSS state lives with the configuration: it survives stop/start
        # cycles (indirection-table rebalances persist, like hardware) and
        # resets on reconfigure.
        self._rss = RssIndirection(conf.n_rx_queues,
                                   table_size=conf.rss_table_size,
                                   key=conf.rss_key)
        self._state = EthDevState.CONFIGURED
        return self

    def rx_queue_setup(self, queue_id: int, nb_desc: int,
                       writeback_threshold: Optional[int] = 32) -> "EthDev":
        """``rte_eth_rx_queue_setup``: size one RX descriptor ring.  The
        writeback threshold is the paper's §3.1.4 parameter."""
        self._check_queue_setup("rx", queue_id, len(self._rx_rings), nb_desc)
        self._rx_rings[queue_id] = RxDescriptorRing(
            nb_desc, writeback_threshold=writeback_threshold, queue_id=queue_id)
        return self

    def tx_queue_setup(self, queue_id: int, nb_desc: int) -> "EthDev":
        """``rte_eth_tx_queue_setup``: size one TX descriptor ring."""
        self._check_queue_setup("tx", queue_id, len(self._tx_rings), nb_desc)
        self._tx_rings[queue_id] = TxDescriptorRing(nb_desc, queue_id=queue_id)
        return self

    def _check_queue_setup(self, side: str, queue_id: int, n_queues: int,
                           nb_desc: int) -> None:
        if self._state is EthDevState.UNCONFIGURED:
            raise EthDevError(
                f"dev {self.dev_id}: {side}_queue_setup before configure()")
        if self._state is EthDevState.STARTED:
            raise EthDevError(
                f"dev {self.dev_id}: {side}_queue_setup while STARTED; "
                "call dev_stop() first")
        if not 0 <= queue_id < n_queues:
            raise EthDevError(
                f"dev {self.dev_id}: {side} queue {queue_id} out of range "
                f"[0, {n_queues})")
        if nb_desc < 1:
            raise EthDevError(f"dev {self.dev_id}: nb_desc must be >= 1")

    def dev_start(self) -> "EthDev":
        """``rte_eth_dev_start``: assemble the Port engine and open the
        dataplane.  Every queue must have been set up."""
        if self._state is EthDevState.STARTED:
            raise EthDevError(f"dev {self.dev_id}: already STARTED")
        if self._state is EthDevState.UNCONFIGURED:
            raise EthDevError(f"dev {self.dev_id}: dev_start before configure()")
        missing = [i for i, r in enumerate(self._rx_rings) if r is None]
        missing += [i for i, r in enumerate(self._tx_rings) if r is None]
        if missing:
            raise EthDevError(
                f"dev {self.dev_id}: dev_start with unset queues {sorted(set(missing))}")
        # Re-assemble the engine from the current rings every start, so a
        # queue re-setup done while STOPPED takes effect on the next start
        # (DPDK semantics).  Counters persist because the rings persist.
        assert self._conf is not None
        self._port = Port(self.pool, self._rx_rings, self._tx_rings,
                          rss=self._rss,
                          link_gbps=self._conf.link_gbps,
                          link_latency_ns=self._conf.link_latency_ns)
        self._state = EthDevState.STARTED
        return self

    def dev_stop(self) -> "EthDev":
        """``rte_eth_dev_stop``: close the dataplane.  Descriptor caches are
        flushed (a stopping NIC publishes completed descriptors); counters and
        rings persist so a later ``dev_start`` resumes, DPDK-style."""
        if self._state is not EthDevState.STARTED:
            raise EthDevError(
                f"dev {self.dev_id}: dev_stop in state {self._state.name}")
        assert self._port is not None
        self._port.flush_rx()
        self._state = EthDevState.STOPPED
        return self

    def attach_dca(self, sched, writeback_timeout_ns: int,
                   writeback_dma_ns: int = 0) -> "EthDev":
        """Arm the descriptor-cache **writeback timeout** (ITR analogue) on
        every RX ring: completions idling in a ring's descriptor cache are
        flushed ``writeback_timeout_ns`` after the first one arrives, as an
        event on ``sched``.  ``writeback_dma_ns`` additionally models the
        writeback DMA transfer time — descriptors become PMD-visible that
        many ns after the threshold crossing (0 == instantaneous, the legacy
        behaviour).  Call after the queues are set up (a later
        ``configure()`` builds fresh rings and must be re-attached); the
        scheduler is also what the virtual-time load generator drives, so it
        must share the testbed's SimClock."""
        if self._state is EthDevState.UNCONFIGURED:
            raise EthDevError(
                f"dev {self.dev_id}: attach_dca before configure()")
        self.event_sched = sched
        for ring in self._rx_rings:
            if ring is not None:
                ring.attach_scheduler(sched, writeback_timeout_ns,
                                      writeback_dma_ns)
        return self

    def _started_port(self) -> Port:
        if self._state is not EthDevState.STARTED or self._port is None:
            raise EthDevError(
                f"dev {self.dev_id}: dataplane call in state {self._state.name}")
        return self._port

    # -- burst dataplane (PMD side; STARTED only) -----------------------------
    def rx_burst(self, queue_id: int, nb_pkts: int) -> Tuple[np.ndarray, np.ndarray]:
        """``rte_eth_rx_burst``: harvest up to ``nb_pkts`` completed RX
        descriptors from one queue → (slots, lengths) arrays, zero copy."""
        return self._started_port().rx_burst(queue_id, nb_pkts)

    def tx_burst(self, queue_id: int, slots: np.ndarray,
                 lengths: np.ndarray) -> int:
        """``rte_eth_tx_burst``: post a burst on one TX queue; returns the
        number accepted (the rest is the caller's to free, like DPDK)."""
        return self._started_port().tx_burst(queue_id, slots, lengths)

    # -- stats (DPDK two-tier scheme) -----------------------------------------
    def stats(self) -> EthStats:
        """``rte_eth_stats_get``: the basic aggregate counter block."""
        port = self._port
        if port is None:
            return EthStats()
        return EthStats(
            ipackets=port.rx_delivered,
            opackets=port.tx_posted,
            ibytes=sum(r.delivered_bytes for r in port.rx_queues),
            obytes=sum(r.posted_bytes for r in port.tx_queues),
            imissed=port.rx_dropped,
            ierrors=0,
            oerrors=sum(r.rejected for r in port.tx_queues),
            rx_nombuf=self.pool.alloc_failures - self._nombuf_base,
        )

    def xstats(self) -> Dict[str, int]:
        """``rte_eth_xstats_get``: named extended counters.

        Naming follows DPDK PMDs: per-queue ``rx_q{N}_packets`` (delivered
        into the ring), ``rx_q{N}_errors`` (dropped: ring full),
        ``tx_q{N}_packets`` (posted), plus device-level ``imissed``,
        ``rx_nombuf`` and the paper-specific descriptor-writeback counters.
        Sums are exact over the legacy Port counters:
        ``sum(rx_q*_packets) == Port.rx_delivered`` etc.
        """
        out: Dict[str, int] = {}
        port = self._port
        if port is None:
            return out
        for q, ring in enumerate(port.rx_queues):
            out[f"rx_q{q}_packets"] = ring.delivered
            out[f"rx_q{q}_errors"] = ring.dropped
            out[f"rx_q{q}_writebacks"] = ring.writebacks
            out[f"rx_q{q}_timeout_flushes"] = ring.timeout_flushes
        for q, ring in enumerate(port.tx_queues):
            out[f"tx_q{q}_packets"] = ring.posted
            out[f"tx_q{q}_errors"] = ring.rejected
            out[f"tx_q{q}_transmitted"] = ring.transmitted
            out[f"tx_q{q}_transmitted_bytes"] = ring.transmitted_bytes
        out["rx_good_packets"] = port.rx_delivered
        out["tx_good_packets"] = port.tx_posted
        out["imissed"] = port.rx_dropped
        out["rx_nombuf"] = self.pool.alloc_failures - self._nombuf_base
        return out

    def stats_reset(self) -> None:
        """``rte_eth_stats_reset``: zero every ring counter and restart this
        device's view of the pool-scoped rx_nombuf counter."""
        self._nombuf_base = self.pool.alloc_failures
        port = self._port
        if port is None:
            return
        for ring in port.rx_queues:
            ring.delivered = 0
            ring.delivered_bytes = 0
            ring.dropped = 0
            ring.writebacks = 0
            ring.writeback_sizes = []
            ring.timeout_flushes = 0
        for ring in port.tx_queues:
            ring.posted = 0
            ring.posted_bytes = 0
            ring.rejected = 0
            ring.transmitted = 0
            ring.transmitted_bytes = 0

    # -- engine / wire-side delegation ---------------------------------------
    # An EthDev is a drop-in for a Port: servers poll its queues, the load
    # generator plays the wire.  All of these require the dataplane open.
    @property
    def port(self) -> Port:
        """The internal engine (STARTED only) — the legacy object, for code
        that still needs raw ring access."""
        return self._started_port()

    @property
    def n_queues(self) -> int:
        if self._conf is None:
            return 0
        return self._conf.n_rx_queues

    @property
    def link_gbps(self) -> float:
        return self._conf.link_gbps if self._conf is not None else 0.0

    @property
    def link_latency_ns(self) -> int:
        return self._conf.link_latency_ns if self._conf is not None else 0

    @property
    def rx_queues(self) -> List[RxDescriptorRing]:
        return self._started_port().rx_queues

    @property
    def tx_queues(self) -> List[TxDescriptorRing]:
        return self._started_port().tx_queues

    @property
    def rss(self) -> RssIndirection:
        return self._started_port().rss

    def deliver(self, packet_slot: int, length: int) -> bool:
        return self._started_port().deliver(packet_slot, length)

    def deliver_burst(self, packet_slots: np.ndarray, lengths: np.ndarray) -> int:
        return self._started_port().deliver_burst(packet_slots, lengths)

    def flush_rx(self) -> None:
        self._started_port().flush_rx()

    def drain_tx(self, max_n_per_queue: int):
        return self._started_port().drain_tx(max_n_per_queue)

    def drain_tx_bursts(self, max_n_per_queue: int):
        return self._started_port().drain_tx_bursts(max_n_per_queue)

    @property
    def tx_pending(self) -> int:
        return self._started_port().tx_pending

    @property
    def tx_posted(self) -> int:
        return self._started_port().tx_posted

    @property
    def rx_delivered(self) -> int:
        return self._started_port().rx_delivered

    @property
    def rx_dropped(self) -> int:
        return self._started_port().rx_dropped

    def rx_queue_delivered(self) -> List[int]:
        return self._started_port().rx_queue_delivered()

    def rx_queue_dropped(self) -> List[int]:
        return self._started_port().rx_queue_dropped()

    def queue_occupancy(self) -> List[int]:
        return self._started_port().queue_occupancy()

    # -- convenience ----------------------------------------------------------
    @classmethod
    def make(
        cls,
        pool: PacketPool,
        ring_size: int = 256,
        writeback_threshold: Optional[int] = 32,
        n_queues: int = 1,
        rss_key: Optional[bytes] = None,
        rss_table_size: int = DEFAULT_TABLE_SIZE,
        dev_id: int = 0,
        link_gbps: float = 0.0,
        link_latency_ns: int = 0,
    ) -> "EthDev":
        """configure + set up every queue + start, in one call (the shape
        every DPDK example's ``port_init()`` takes)."""
        dev = cls(pool, dev_id=dev_id).configure(EthConf(
            n_rx_queues=n_queues, n_tx_queues=n_queues,
            rss_key=rss_key, rss_table_size=rss_table_size,
            link_gbps=link_gbps, link_latency_ns=link_latency_ns))
        for q in range(n_queues):
            dev.rx_queue_setup(q, ring_size, writeback_threshold=writeback_threshold)
            dev.tx_queue_setup(q, ring_size)
        return dev.dev_start()
