"""Frozen, declarative experiment configs — the orchestration contract.

Every testbed this repo can build (pool → EthDevs → server stack → load
generator → telemetry) is described by one :class:`ExperimentConfig`: a tree
of frozen dataclasses that round-trips losslessly through plain dicts
(``cfg == ExperimentConfig.from_dict(cfg.to_dict())``), so experiments can be
stored as JSON, diffed, swept programmatically, and reproduced exactly —
the SimBricks/gem5-stdlib lesson applied to this repo.

The configs are *pure data*: nothing here imports the dataplane.  Building
live objects from a config is :mod:`repro_torch.exp.testbed`'s job; running one is
:func:`repro_torch.exp.runner.run_experiment`'s.

Own copy, in the PyTorch port, of ``src/repro/exp/config.py``: the same plain
Python, with its imports pointing into ``repro_torch``, and one change.

* **Engines.** :data:`TRAFFIC_ENGINES` is ``("event", "epoch",
  "epoch-torch")``: ``"epoch-torch"`` takes the place of the reference's
  ``"epoch-jit"`` and runs the epoch pass in torch (on the card, the
  hand-written kernel ``kernels/csrc/epoch_pass.cu``), and it is the
  default, so a default run uses the card. ``"epoch"`` stays the numpy pass.
  A config that names ``"epoch-jit"`` raises ``ValueError``. The engine is
  scrubbed from seed fingerprints (:mod:`repro_torch.exp.seeding`), so the
  port derives the reference's seeds from the same config whichever engine
  it names.

``TopologyConfig.serving`` takes the port's own
:class:`repro_torch.serving.config.ServingConfig`.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.cost import HostCostModel
from repro_torch.core.loadgen import TRAFFIC_KINDS
from repro_torch.core.packet import DEFAULT_MTU, DEFAULT_TS_OFFSET
from repro_torch.core.rss import DEFAULT_TABLE_SIZE

TRAFFIC_MODES = ("open_loop", "closed_loop", "msb")
TRAFFIC_ENGINES = ("event", "epoch", "epoch-torch")
# the switch pipeline's AQM stage policies (repro_torch.core.switch)
AQM_KINDS = ("drop-tail", "red", "ecn")
# loadgen congestion control: fixed offered rate (the paper's EtherLoadGen)
# or DCTCP-style multiplicative adaptation on CE-mark/loss feedback
CC_MODES = ("fixed", "dctcp")
# how a topology's event loop executes: one shared SimClock (reference),
# per-domain clocks synchronized in link-latency epochs (SimBricks,
# arXiv:2012.14219), or the same partitioning spread across worker processes.
# All three produce bit-identical RunReports; the knob only trades wall time.
PARTITION_MODES = ("shared-clock", "partitioned", "partitioned-mp")


def _plain(value: Any) -> Any:
    """Recursively convert a config value to JSON-safe plain data."""
    if hasattr(value, "to_dict"):
        return value.to_dict()
    if isinstance(value, tuple):
        return [_plain(v) for v in value]
    return value


def _config_to_dict(cfg: Any) -> Dict[str, Any]:
    return {f.name: _plain(getattr(cfg, f.name)) for f in fields(cfg)}


@dataclass(frozen=True)
class PoolConfig:
    """The packet arena (DPDK mempool / pinned hugepages analogue)."""

    n_slots: int = 16384
    slot_size: int = DEFAULT_MTU

    def __post_init__(self) -> None:
        if self.n_slots < 1 or self.slot_size < 64:
            raise ValueError("pool needs >= 1 slot of >= 64 bytes")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PoolConfig":
        return cls(**d)


@dataclass(frozen=True)
class RssConfig:
    """RSS steering: indirection-table size + optional key override.

    The key is carried as a hex string so configs stay JSON-safe; ``None``
    means the Microsoft default key.
    """

    table_size: int = DEFAULT_TABLE_SIZE
    key_hex: Optional[str] = None

    def __post_init__(self) -> None:
        if self.key_hex is not None:
            if len(bytes.fromhex(self.key_hex)) < 16:
                raise ValueError("RSS key must be at least 16 bytes")

    @property
    def key(self) -> Optional[bytes]:
        return None if self.key_hex is None else bytes.fromhex(self.key_hex)

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RssConfig":
        return cls(**d)


@dataclass(frozen=True)
class LinkConfig:
    """The wire attached to one port (virtual-time semantics).

    ``gbps`` is the serialization rate — a frame occupies the wire for
    ``bytes*8/gbps`` ns, and back-to-back frames queue FIFO behind it —
    and ``latency_ns`` is one-way propagation.  ``gbps <= 0`` models an
    ideal (infinitely fast) wire, the pre-SimClock behaviour.  The default
    is a 100GbE link with 1 µs of cable+PHY latency, the paper's testbed
    fabric.  Ignored in wall-clock mode, where the host *is* the wire.
    """

    gbps: float = 100.0
    latency_ns: int = 1_000

    def __post_init__(self) -> None:
        if self.latency_ns < 0:
            raise ValueError("latency_ns must be >= 0")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LinkConfig":
        return cls(**d)


@dataclass(frozen=True)
class PortConfig:
    """One NIC device: queue count, per-queue ring size, writeback threshold
    (the paper's §3.1.4 parameter), RSS, and the attached link."""

    n_queues: int = 1
    ring_size: int = 1024
    writeback_threshold: Optional[int] = 32
    rss: RssConfig = field(default_factory=RssConfig)
    link: LinkConfig = field(default_factory=LinkConfig)

    def __post_init__(self) -> None:
        if self.n_queues < 1:
            raise ValueError("n_queues must be >= 1")
        if self.ring_size < 1:
            raise ValueError("ring_size must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PortConfig":
        d = dict(d)
        d["rss"] = RssConfig.from_dict(d.get("rss", {}))
        d["link"] = LinkConfig.from_dict(d.get("link", {}))
        return cls(**d)


@dataclass(frozen=True)
class DcaConfig:
    """The paper's §3.1.4/§5.2 DCA knobs, as one sim-time unit.

    When set on an :class:`ExperimentConfig` (or :class:`NodeConfig`), the
    descriptor path runs the full virtual-time DCA model and these values
    override the scattered legacy knobs (``PortConfig.writeback_threshold``,
    ``StackConfig.burst_size``/``per_lcore_bursts``):

    * ``writeback_threshold`` — completions per descriptor-cache writeback
      DMA (``None`` == the pathological pre-fix "whole ring" behaviour);
    * ``writeback_timeout_ns`` — the ITR analogue: an idle timer (an
      :class:`~repro_torch.core.simclock.EventScheduler` event) flushes cached
      completions this long after the first one arrives, bounding how long a
      frame can sit PMD-invisible.  The same bound caps how long a bypass
      lcore accumulates toward a full burst before forwarding a partial one
      (Fig. 4's tail-of-train case);
    * ``burst_size`` / ``per_lcore_bursts`` — the L2Fwd processing burst the
      paper's Fig. 4 sweeps: in DCA mode the bypass stack *accumulates* a
      full burst of written-back descriptors before forwarding, so this knob
      moves measured RTT percentiles end-to-end.

    Requires ``traffic.sim_time`` — the writeback timer and accumulation
    deadline are virtual-time events.
    """

    burst_size: int = 32
    writeback_threshold: Optional[int] = 32
    writeback_timeout_ns: int = 200_000
    # modeled writeback DMA transfer time: descriptors become PMD-visible
    # this many ns after the threshold crossing starts the writeback
    # (0 == instantaneous — bit-identical to pre-DMA legacy reports)
    writeback_dma_ns: int = 0
    per_lcore_bursts: Optional[Tuple[int, ...]] = None
    # per-RX-queue writeback thresholds (index == queue id); entries override
    # ``writeback_threshold`` for their queue, ``None`` entries fall through
    # to it.  Must match the port's queue count — validated where the config
    # meets a PortConfig (ExperimentConfig/NodeConfig __post_init__).
    per_queue_writeback_thresholds: Optional[Tuple[Optional[int], ...]] = None

    def __post_init__(self) -> None:
        if self.burst_size < 1:
            raise ValueError("burst_size must be >= 1")
        if self.writeback_threshold is not None and self.writeback_threshold < 1:
            raise ValueError("writeback_threshold must be >= 1 or None")
        if self.per_queue_writeback_thresholds is not None:
            if len(self.per_queue_writeback_thresholds) == 0:
                raise ValueError(
                    "per_queue_writeback_thresholds must be nonempty or None")
            for q, thr in enumerate(self.per_queue_writeback_thresholds):
                if thr is not None and thr < 1:
                    raise ValueError(
                        f"per_queue_writeback_thresholds[{q}]={thr} "
                        "must be >= 1 or None")
        if self.writeback_timeout_ns < 1:
            # 0 would mean "never flush" at the NIC timer but "give up
            # immediately" at the PMD — opposite semantics for one knob.
            # The timeout is the model's latency bound; it must exist.
            raise ValueError(
                "writeback_timeout_ns must be >= 1 (it bounds how long a "
                "completion can sit PMD-invisible; to make timeouts "
                "irrelevant use a small writeback_threshold instead)")
        if self.writeback_dma_ns < 0:
            raise ValueError("writeback_dma_ns must be >= 0")
        if self.per_lcore_bursts is not None and (
                len(self.per_lcore_bursts) == 0
                or any(b < 1 for b in self.per_lcore_bursts)):
            raise ValueError("per_lcore_bursts must be a nonempty tuple of >= 1")

    def max_burst(self) -> int:
        """Largest burst any lcore can be asked to accumulate."""
        if self.per_lcore_bursts is not None:
            return max(self.per_lcore_bursts)
        return self.burst_size

    def threshold_for(self, queue_id: int) -> Optional[int]:
        """The effective writeback threshold for one RX queue: the per-queue
        entry when set (and not None), else the global threshold."""
        if self.per_queue_writeback_thresholds is not None:
            if not 0 <= queue_id < len(self.per_queue_writeback_thresholds):
                raise ValueError(
                    f"queue_id={queue_id} out of range for "
                    f"{len(self.per_queue_writeback_thresholds)} per-queue "
                    "writeback thresholds")
            per_q = self.per_queue_writeback_thresholds[queue_id]
            if per_q is not None:
                return per_q
        return self.writeback_threshold

    def validate_queues(self, n_queues: int, what: str) -> None:
        """A per-queue threshold list must cover the port's queues exactly —
        a silent length mismatch would leave queues on the wrong knob."""
        if (self.per_queue_writeback_thresholds is not None
                and len(self.per_queue_writeback_thresholds) != n_queues):
            raise ValueError(
                f"dca.per_queue_writeback_thresholds has "
                f"{len(self.per_queue_writeback_thresholds)} entries but "
                f"{what} port has n_queues={n_queues}")

    def validate_ring(self, ring_size: int, what: str) -> None:
        """A threshold or accumulation burst larger than the ring can never
        be reached — the sweep knob would silently degenerate to
        timeout-only publication/forwarding, so reject it at config time."""
        if (self.writeback_threshold is not None
                and self.writeback_threshold > ring_size):
            raise ValueError(
                f"dca.writeback_threshold={self.writeback_threshold} "
                f"exceeds {what} ring_size={ring_size}")
        if self.per_queue_writeback_thresholds is not None:
            for q, thr in enumerate(self.per_queue_writeback_thresholds):
                if thr is not None and thr > ring_size:
                    raise ValueError(
                        f"dca.per_queue_writeback_thresholds[{q}]={thr} "
                        f"exceeds {what} ring_size={ring_size}")
        if self.max_burst() > ring_size:
            raise ValueError(
                f"dca burst_size={self.max_burst()} exceeds {what} "
                f"ring_size={ring_size}; a full burst could never "
                "accumulate (every forward would wait out the timeout)")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DcaConfig":
        d = dict(d)
        if d.get("per_lcore_bursts") is not None:
            d["per_lcore_bursts"] = tuple(d["per_lcore_bursts"])
        if d.get("per_queue_writeback_thresholds") is not None:
            d["per_queue_writeback_thresholds"] = tuple(
                d["per_queue_writeback_thresholds"])
        return cls(**d)


@dataclass(frozen=True)
class CostConfig:
    """Host-cost model (mirrors :class:`repro_torch.core.cost.HostCostModel`); the
    Fig. 3(b) knobs.  The ``pmd_*`` figures price the polling path in
    virtual-time mode only (in wall-clock mode the PMD's real code is its
    own cost — the paper's asymmetry)."""

    cpu_ghz: float = 2.0
    interrupt_cycles: int = 8000
    syscall_cycles: int = 1400
    per_packet_kernel_cycles: int = 2500
    pmd_poll_cycles: int = 150
    pmd_per_packet_cycles: int = 1100

    def to_host_cost_model(self) -> HostCostModel:
        return HostCostModel(**asdict(self))

    @classmethod
    def from_host_cost_model(cls, m: HostCostModel) -> "CostConfig":
        return cls(cpu_ghz=m.cpu_ghz, interrupt_cycles=m.interrupt_cycles,
                   syscall_cycles=m.syscall_cycles,
                   per_packet_kernel_cycles=m.per_packet_kernel_cycles,
                   pmd_poll_cycles=m.pmd_poll_cycles,
                   pmd_per_packet_cycles=m.pmd_per_packet_cycles)

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CostConfig":
        return cls(**d)


@dataclass(frozen=True)
class StackConfig:
    """Which server stack processes packets, and its knobs.

    ``kind`` selects from the stack registry (:mod:`repro_torch.exp.testbed`):
    ``bypass`` (run-to-completion DPDK L2Fwd), ``pipeline`` (rx→work→tx stage
    lcores), ``kernel`` (the interrupt-driven baseline), or any kind a
    scenario registered via :func:`repro_torch.exp.register_stack`.  Kind names are
    resolved at build time so configs stay pure data.
    """

    kind: str = "bypass"
    burst_size: int = 64
    n_lcores: Optional[int] = None           # None == one lcore per queue
    per_lcore_bursts: Optional[Tuple[int, ...]] = None  # BurstPlan override
    sockbuf_budget: int = 16                 # kernel stack: pkts per read()
    sockbuf_capacity: int = 512              # kernel stack: rmem cap (skbs)
    stage_ring_capacity: int = 1024          # pipeline stack: SPSC ring depth
    # modeled host costs: the kernel stack's syscall/IRQ figures in both
    # timing modes, plus the pmd_* figures pricing polling stacks in
    # virtual time.  None == CostConfig() defaults.
    cost: Optional[CostConfig] = None

    def __post_init__(self) -> None:
        if self.burst_size < 1:
            raise ValueError("burst_size must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StackConfig":
        d = dict(d)
        if d.get("cost") is not None:
            d["cost"] = CostConfig.from_dict(d["cost"])
        if d.get("per_lcore_bursts") is not None:
            d["per_lcore_bursts"] = tuple(d["per_lcore_bursts"])
        return cls(**d)


@dataclass(frozen=True)
class TrafficConfig:
    """What the load generator offers, and how the run is driven.

    Modes:

    * ``open_loop`` — paced offered load (``rate_gbps``/``kind``) for
      ``duration_s``; the EtherLoadGen measurement mode.
    * ``closed_loop`` — exactly ``n_packets`` with ``window`` in flight;
      deterministic, the conservation-test mode.
    * ``msb`` — the bandwidth-test mode: ramp + bisect to the maximum
      sustainable bandwidth (``start_gbps``/``max_gbps``/``trial_s``/
      ``refine_iters``/``drop_tolerance_pct``).

    ``sim_time`` (default on) runs the experiment on a
    :class:`~repro_torch.core.simclock.SimClock`: durations are *virtual* seconds,
    results are deterministic and host-independent, and host costs are
    charged to lcore busy-time.  Turn it off to pace against the host clock
    (the seed behaviour) for host-overhead studies.

    ``engine`` picks how virtual-time open-loop trials are advanced:
    ``"epoch-torch"`` (default) runs the epoch-batched fast path
    (:func:`repro_torch.core.fastpath.run_epoch_sim` — whole-array passes,
    bit-identical reports, automatic fallback to the event loop for configs
    it cannot prove exact) with the pass in torch on the device the runner
    is given (``"cuda"`` by default: the CUDA kernel); ``"epoch"`` runs the
    same fast path with the numpy pass; ``"event"`` forces the per-event
    reference loop.  Ignored in wall-clock mode.
    """

    mode: str = "open_loop"
    packet_size: int = 1518
    sim_time: bool = True
    engine: str = "epoch-torch"
    # open_loop
    rate_gbps: float = 1.0
    kind: str = "uniform"                    # uniform | poisson | bursty
    burst_len: int = 32
    duration_s: float = 0.25
    drain_timeout_s: float = 0.5
    seed: int = 0
    # closed_loop
    n_packets: int = 1000
    window: int = 32
    payload_seed: Optional[int] = None       # rng-filled payloads when set
    # msb
    start_gbps: float = 0.25
    max_gbps: float = 400.0
    trial_s: float = 0.2
    refine_iters: int = 5
    drop_tolerance_pct: float = 0.0
    # loadgen knobs (all modes)
    n_flows: int = 256
    ts_offset: int = DEFAULT_TS_OFFSET
    verify_integrity: bool = False
    max_tx_burst: int = 64
    # congestion control (open_loop + sim_time): "fixed" offers rate_gbps
    # unconditionally; "dctcp" starts at rate_gbps and adapts it per
    # cc_window_ns of virtual time from the fraction of CE-marked/lost
    # echoes (alpha = (1-g)*alpha + g*F; marked window: rate *= 1-alpha/2,
    # clean window: rate += cc_increase_gbps — AIMD, so competing clients
    # converge to a fair share), clamped to
    # [cc_min_gbps, the attached link rate]
    # cc_max_inflight is the TX-credit/cwnd analogue: a client never has
    # more than this many frames outstanding (0 == uncapped).  Rate pacing
    # alone keeps pouring into the bottleneck queue for a full feedback
    # delay after an overshoot; the in-flight cap is the ack-clocked
    # backpressure that stops it immediately.
    cc_mode: str = "fixed"
    cc_window_ns: int = 100_000
    cc_gain: float = 0.0625
    cc_min_gbps: float = 0.05
    cc_increase_gbps: float = 0.25
    cc_max_inflight: int = 0

    def __post_init__(self) -> None:
        if self.mode not in TRAFFIC_MODES:
            raise ValueError(f"traffic mode must be one of {TRAFFIC_MODES}")
        if self.engine == "epoch-jit":
            raise ValueError(
                "traffic engine 'epoch-jit' is the JAX package's; the port "
                "runs the epoch pass in torch as engine 'epoch-torch'")
        if self.engine not in TRAFFIC_ENGINES:
            raise ValueError(
                f"traffic engine must be one of {TRAFFIC_ENGINES}")
        if self.kind not in TRAFFIC_KINDS:
            raise ValueError(f"traffic kind must be one of {TRAFFIC_KINDS}")
        if self.packet_size < 64:
            raise ValueError("packet_size must be >= 64 (MIN_FRAME)")
        if self.cc_mode not in CC_MODES:
            raise ValueError(f"cc_mode must be one of {CC_MODES}")
        if self.cc_mode != "fixed":
            if self.mode != "open_loop" or not self.sim_time:
                raise ValueError(
                    "cc_mode='dctcp' needs open_loop traffic in sim time "
                    "(rates adapt per virtual-time window)")
            if self.cc_window_ns < 1:
                raise ValueError("cc_window_ns must be >= 1")
            if not 0.0 < self.cc_gain <= 1.0:
                raise ValueError("cc_gain must be in (0, 1]")
            if self.cc_min_gbps <= 0.0:
                raise ValueError("cc_min_gbps must be > 0")
            if self.cc_increase_gbps <= 0.0:
                raise ValueError("cc_increase_gbps must be > 0")
            if self.cc_max_inflight < 0:
                raise ValueError("cc_max_inflight must be >= 0 (0 uncapped)")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrafficConfig":
        return cls(**d)


@dataclass(frozen=True)
class ExperimentConfig:
    """One complete, reproducible experiment: pool + devices + stack +
    traffic.  ``from_dict(to_dict())`` round-trips exactly."""

    name: str = "experiment"
    pool: PoolConfig = field(default_factory=PoolConfig)
    ports: Tuple[PortConfig, ...] = (PortConfig(),)
    stack: StackConfig = field(default_factory=StackConfig)
    traffic: TrafficConfig = field(default_factory=TrafficConfig)
    # sim-time DCA model (writeback threshold/timeout + processing burst);
    # None == legacy behaviour (synchronous thresholds, no timers, no
    # burst accumulation)
    dca: Optional[DcaConfig] = None

    def __post_init__(self) -> None:
        if not self.ports:
            raise ValueError("need at least one port")
        if self.stack.kind == "pipeline" and len(self.ports) != 1:
            raise ValueError("the pipeline stack drives exactly one port")
        if self.dca is not None:
            if not self.traffic.sim_time:
                raise ValueError(
                    "DcaConfig is a virtual-time model; it needs "
                    "traffic.sim_time=True")
            for p in self.ports:
                self.dca.validate_ring(p.ring_size, "a port's")
                self.dca.validate_queues(p.n_queues, "a")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        d = dict(d)
        d["pool"] = PoolConfig.from_dict(d.get("pool", {}))
        d["ports"] = tuple(PortConfig.from_dict(p) for p in d.get("ports", [{}]))
        d["stack"] = StackConfig.from_dict(d.get("stack", {}))
        d["traffic"] = TrafficConfig.from_dict(d.get("traffic", {}))
        if d.get("dca") is not None:
            d["dca"] = DcaConfig.from_dict(d["dca"])
        return cls(**d)

    # replace() helpers keep sweep code terse: cfg.with_traffic(rate_gbps=2.0)
    def with_stack(self, **kw: Any) -> "ExperimentConfig":
        return replace(self, stack=replace(self.stack, **kw))

    def with_traffic(self, **kw: Any) -> "ExperimentConfig":
        return replace(self, traffic=replace(self.traffic, **kw))

    def with_ports(self, **kw: Any) -> "ExperimentConfig":
        return replace(self, ports=tuple(replace(p, **kw) for p in self.ports))

    def with_dca(self, **kw: Any) -> "ExperimentConfig":
        """Sweep helper: override fields of ``dca`` (starting from defaults
        when unset) — ``cfg.with_dca(burst_size=1024)``."""
        base = self.dca if self.dca is not None else DcaConfig()
        return replace(self, dca=replace(base, **kw))


# -- multi-host topologies ----------------------------------------------------

@dataclass(frozen=True)
class AqmConfig:
    """One egress port's active-queue-management policy (the pipeline's AQM
    stage — :class:`repro_torch.core.switch.AqmRed`).

    ``kind``: ``"drop-tail"`` (no policy object installed — bit-identical to
    the pre-pipeline switch), ``"red"`` (probabilistic early drop on the
    classic RED curve over instantaneous queue depth), or ``"ecn"`` (the same
    curve applied as a CE mark instead of a drop — the DCTCP fabric half).
    ``seed`` feeds the deterministic counter-seeded per-port RNG stream.
    """

    kind: str = "drop-tail"
    min_thresh: int = 8
    max_thresh: int = 24
    max_p: float = 0.1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.kind not in AQM_KINDS:
            raise ValueError(f"aqm kind must be one of {AQM_KINDS}")
        if not 1 <= self.min_thresh <= self.max_thresh:
            raise ValueError("need 1 <= min_thresh <= max_thresh")
        if not 0.0 < self.max_p <= 1.0:
            raise ValueError("max_p must be in (0, 1]")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AqmConfig":
        return cls(**d)


@dataclass(frozen=True)
class PipelineConfig:
    """The per-port forwarding pipeline's configurable stages.

    ``classify`` names the match key the parse stage extracts (``"dst-ip"``
    is the only key today — the flow dst_ip the LPM table routes on).
    ``aqm`` is the default AQM policy applied to **every** egress port;
    ``per_port_aqm`` (index == port id, entries may be None == fall through
    to ``aqm``) overrides it per port — e.g. RED only on the hot incast
    egress.  Length is validated at build time against the actual port
    count, which a config cannot know (ports = nodes + clients [+ trunk]).
    """

    classify: str = "dst-ip"
    aqm: AqmConfig = field(default_factory=AqmConfig)
    per_port_aqm: Optional[Tuple[Optional[AqmConfig], ...]] = None

    def __post_init__(self) -> None:
        if self.classify != "dst-ip":
            raise ValueError("classify must be 'dst-ip'")
        if self.per_port_aqm is not None and len(self.per_port_aqm) == 0:
            raise ValueError("per_port_aqm must be nonempty or None")

    def aqm_for(self, port_id: int) -> AqmConfig:
        """The effective policy for one port (per-port override or default)."""
        if self.per_port_aqm is not None and \
                0 <= port_id < len(self.per_port_aqm):
            per = self.per_port_aqm[port_id]
            if per is not None:
                return per
        return self.aqm

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        d = dict(d)
        d["aqm"] = AqmConfig.from_dict(d.get("aqm", {}))
        if d.get("per_port_aqm") is not None:
            d["per_port_aqm"] = tuple(
                None if e is None else AqmConfig.from_dict(e)
                for e in d["per_port_aqm"])
        return cls(**d)


@dataclass(frozen=True)
class SwitchConfig:
    """The fabric: an output-queued switch whose ports all carry ``link``
    (full duplex) and buffer at most ``egress_capacity`` frames per egress
    port (drop-tail — the incast loss mechanism).

    ``pipeline`` (optional) configures the per-port forwarding pipeline's
    AQM stage; ``None`` keeps pure drop-tail, bit-identical to pre-pipeline
    reports.  ``trunk`` (optional) turns the fabric into **two** switches
    joined by a trunk link carrying ``trunk`` timing — set ``trunk.gbps``
    below the aggregate endpoint rate for an oversubscribed core.  Endpoint
    placement defaults to nodes on switch 0 / clients on switch 1 and is
    overridden by ``TopologyConfig.node_switch``/``client_switch``.
    """

    egress_capacity: int = 64
    link: LinkConfig = field(default_factory=LinkConfig)
    pipeline: Optional[PipelineConfig] = None
    trunk: Optional[LinkConfig] = None

    def __post_init__(self) -> None:
        if self.egress_capacity < 1:
            raise ValueError("egress_capacity must be >= 1 frame")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SwitchConfig":
        d = dict(d)
        d["link"] = LinkConfig.from_dict(d.get("link", {}))
        if d.get("pipeline") is not None:
            d["pipeline"] = PipelineConfig.from_dict(d["pipeline"])
        if d.get("trunk") is not None:
            d["trunk"] = LinkConfig.from_dict(d["trunk"])
        return cls(**d)


@dataclass(frozen=True)
class NodeConfig:
    """One simulated host on the fabric: its own packet arena, one NIC, and
    a server stack.  ``ip`` is the node's address on the fabric (what the
    switch routes on); 0 auto-assigns ``192.168.0.(index+1)`` at build time.
    The NIC's own ``PortConfig.link`` is ignored in a topology — the switch
    port's wires carry the link timing."""

    name: str = "node"
    ip: int = 0
    pool: PoolConfig = field(default_factory=PoolConfig)
    port: PortConfig = field(default_factory=PortConfig)
    stack: StackConfig = field(default_factory=StackConfig)
    # sim-time DCA model for this node's NIC/stack (topologies always run in
    # virtual time, so no sim_time gate is needed here)
    dca: Optional[DcaConfig] = None

    def __post_init__(self) -> None:
        if not 0 <= self.ip <= 0xFFFFFFFF:
            raise ValueError("ip must be a u32 (0 == auto-assign)")
        if self.dca is not None:
            self.dca.validate_ring(self.port.ring_size, "the node's")
            self.dca.validate_queues(self.port.n_queues, "the node's")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NodeConfig":
        d = dict(d)
        d["pool"] = PoolConfig.from_dict(d.get("pool", {}))
        d["port"] = PortConfig.from_dict(d.get("port", {}))
        d["stack"] = StackConfig.from_dict(d.get("stack", {}))
        if d.get("dca") is not None:
            d["dca"] = DcaConfig.from_dict(d["dca"])
        return cls(**d)


@dataclass(frozen=True)
class TopologyConfig:
    """One complete multi-host scenario: N server nodes and N fabric-attached
    load-generator clients around one switch, all on one shared SimClock.

    ``traffic`` describes each client's *individual* offered load (mode must
    be ``open_loop`` and ``sim_time`` must stay on — topologies are a
    virtual-time construction); client ``g`` derives its emission schedule
    from ``traffic.seed + g``, so the scenario stays deterministic while
    clients stay decorrelated.  ``target`` names the node all clients send to
    ("" == the first node) — the N:1 shape of an incast.

    ``serving`` (optional) turns the scenario into an LLM-inference-serving
    cluster: clients become request populations (QPS, token-length mix) and
    the named balancer/prefill/decode nodes must carry the matching serving
    stack kinds.  ``traffic`` then only contributes duration/seed/engine
    knobs — the offered load comes from ``serving.qps``.

    ``partition`` selects the execution engine (:data:`PARTITION_MODES`):
    ``shared-clock`` is the reference event loop, ``partitioned`` gives every
    client/node/switch its own clock+scheduler advancing in link-latency
    epochs, and ``partitioned-mp`` spreads those domains across worker
    processes (``partition_workers``, 0 == one per CPU).  Reports are
    bit-identical across all three — execution knobs never touch physics, so
    they are also excluded from derived-seed fingerprints
    (:mod:`repro_torch.exp.seeding`).  Configs the partition engine cannot prove
    equivalent (serving, zero-cost hosts, zero-latency links) fall back to
    shared-clock with the reason surfaced in ``PartitionRunInfo``.

    ``client_targets`` (optional) gives client ``g`` its own destination node
    name — an N:M traffic matrix instead of the N:1 ``target`` incast.
    """

    name: str = "topology"
    nodes: Tuple[NodeConfig, ...] = (NodeConfig(),)
    n_clients: int = 1
    client_pool: PoolConfig = field(default_factory=lambda: PoolConfig(n_slots=4096))
    switch: SwitchConfig = field(default_factory=SwitchConfig)
    traffic: TrafficConfig = field(default_factory=TrafficConfig)
    target: str = ""
    # repro_torch.serving.ServingConfig; typed loosely to keep repro_torch.exp
    # importable without the serving package (it imports this module back)
    serving: Optional[Any] = None
    # execution engine (never affects results — see PARTITION_MODES)
    partition: str = "shared-clock"
    partition_workers: int = 0
    # run every partitioned crossing through the PartitionSanitizer race
    # detector (also forced on by env REPRO_PARTITION_SANITIZE=1); execution
    # -only — scrubbed from seed fingerprints like partition itself
    partition_sanitize: bool = False
    # per-client destination node names (len == n_clients); None == all
    # clients send to ``target``
    client_targets: Optional[Tuple[str, ...]] = None
    # two-switch placement (requires switch.trunk): which switch (0 or 1)
    # each node/client attaches to.  None == the default split (nodes on
    # switch 0, clients on switch 1).
    node_switch: Optional[Tuple[int, ...]] = None
    client_switch: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if not self.nodes:
            raise ValueError("need at least one node")
        if not 1 <= self.n_clients <= 255:
            raise ValueError("n_clients must be in [1, 255] (one /16 each)")
        if self.traffic.packet_size > self.client_pool.slot_size:
            raise ValueError("packet_size exceeds the client pool slot size")
        for n in self.nodes:
            if self.traffic.packet_size > n.pool.slot_size:
                raise ValueError(
                    f"packet_size exceeds node {n.name!r} pool slot size")
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"node names must be unique, got {names}")
        ips = [n.ip for n in self.nodes if n.ip != 0]
        if len(set(ips)) != len(ips):
            raise ValueError("explicit node ips must be unique")
        if self.target and self.target not in names:
            raise ValueError(f"target {self.target!r} is not a node name")
        if self.traffic.mode != "open_loop":
            raise ValueError("topology traffic mode must be open_loop")
        if not self.traffic.sim_time:
            raise ValueError("topologies run in virtual time (sim_time=True)")
        if self.partition not in PARTITION_MODES:
            raise ValueError(
                f"partition must be one of {PARTITION_MODES}, "
                f"got {self.partition!r}")
        if self.partition_workers < 0:
            raise ValueError("partition_workers must be >= 0 (0 == auto)")
        if self.client_targets is not None:
            if len(self.client_targets) != self.n_clients:
                raise ValueError(
                    f"client_targets has {len(self.client_targets)} entries "
                    f"but n_clients={self.n_clients}")
            for g, t in enumerate(self.client_targets):
                if t not in names:
                    raise ValueError(
                        f"client_targets[{g}]={t!r} is not a node name "
                        f"(have {names})")
            if self.serving is not None:
                raise ValueError(
                    "client_targets is an echo-topology knob; serving "
                    "clients address the balancer")
        for label, placement, count in (
                ("node_switch", self.node_switch, len(self.nodes)),
                ("client_switch", self.client_switch, self.n_clients)):
            if placement is None:
                continue
            if self.switch.trunk is None:
                raise ValueError(
                    f"{label} needs a two-switch fabric (switch.trunk)")
            if len(placement) != count:
                raise ValueError(
                    f"{label} has {len(placement)} entries, need {count}")
            if any(s not in (0, 1) for s in placement):
                raise ValueError(f"{label} entries must be 0 or 1")
        if self.serving is not None:
            pipe = self.switch.pipeline
            if pipe is not None and (
                    pipe.aqm.kind != "drop-tail" or pipe.per_port_aqm):
                raise ValueError(
                    "serving topologies don't support AQM marking (serving "
                    "frames carry their own header layout)")
            if self.traffic.cc_mode != "fixed":
                raise ValueError(
                    "serving topologies drive load from serving.qps; "
                    "cc_mode must stay 'fixed'")
            self._validate_serving(names)

    def _validate_serving(self, names: List[str]) -> None:
        from repro_torch.serving.config import ServingConfig
        s = self.serving
        if not isinstance(s, ServingConfig):
            raise ValueError(
                f"serving must be a ServingConfig, got {type(s).__name__}")
        by_name = {n.name: n for n in self.nodes}
        roles = [(s.balancer, "balancer"), *[(p, "prefill") for p in s.prefill],
                 *[(d, "decode") for d in s.decode]]
        for node_name, kind in roles:
            if node_name not in by_name:
                raise ValueError(
                    f"serving {kind} node {node_name!r} is not a node name "
                    f"(have {names})")
            nc = by_name[node_name]
            if nc.stack.kind != kind:
                raise ValueError(
                    f"serving {kind} node {node_name!r} has stack kind "
                    f"{nc.stack.kind!r}; it must be {kind!r}")
            # serving nodes exchange full-size request/KV frames
            max_frame = max(s.request_frame_bytes, s.kv_segment_bytes,
                            s.token_frame_bytes)
            if max_frame > nc.pool.slot_size:
                raise ValueError(
                    f"serving frames up to {max_frame}B exceed node "
                    f"{node_name!r} pool slot size {nc.pool.slot_size}")
            # engine iterations park a node's lcore for long virtual
            # windows; frames idling below a >1 writeback threshold would
            # only surface at quiet-fabric flushes, stalling the pipeline.
            # Either expose completions immediately (threshold 1) or model
            # DCA properly (DcaConfig arms the give-up timers).
            if nc.dca is None and nc.port.writeback_threshold != 1:
                raise ValueError(
                    f"serving node {node_name!r} needs "
                    "port.writeback_threshold == 1 (or an explicit "
                    "DcaConfig with writeback timers)")
        if s.request_frame_bytes > self.client_pool.slot_size:
            raise ValueError(
                "serving request_frame_bytes exceeds the client pool slot size")

    def to_dict(self) -> Dict[str, Any]:
        return _config_to_dict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TopologyConfig":
        d = dict(d)
        d["nodes"] = tuple(NodeConfig.from_dict(n) for n in d.get("nodes", [{}]))
        d["client_pool"] = PoolConfig.from_dict(d.get("client_pool", {}))
        d["switch"] = SwitchConfig.from_dict(d.get("switch", {}))
        d["traffic"] = TrafficConfig.from_dict(d.get("traffic", {}))
        if d.get("serving") is not None:
            from repro_torch.serving.config import ServingConfig
            d["serving"] = ServingConfig.from_dict(d["serving"])
        if d.get("client_targets") is not None:
            d["client_targets"] = tuple(d["client_targets"])
        for key in ("node_switch", "client_switch"):
            if d.get(key) is not None:
                d[key] = tuple(d[key])
        return cls(**d)

    def with_traffic(self, **kw: Any) -> "TopologyConfig":
        return replace(self, traffic=replace(self.traffic, **kw))

    def with_switch(self, **kw: Any) -> "TopologyConfig":
        return replace(self, switch=replace(self.switch, **kw))

    def with_partition(self, mode: str, workers: int = 0,
                       sanitize: Optional[bool] = None) -> "TopologyConfig":
        kw: Dict[str, Any] = dict(partition=mode, partition_workers=workers)
        if sanitize is not None:
            kw["partition_sanitize"] = sanitize
        return replace(self, **kw)
