"""Testbed builder: one :class:`ExperimentConfig` → live pool / EthDevs /
server / load generator.

The server stack is chosen from a **registry** keyed by
``StackConfig.kind`` — ``bypass`` / ``pipeline`` / ``kernel`` ship built in,
and scenario PRs can :func:`register_stack` new ones without touching this
module (the gem5-stdlib/SimBricks extension point).

Own copy, in the PyTorch port, of ``src/repro/exp/testbed.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core import (BurstPlan, BypassL2FwdServer, EthConf, EthDev,
                              EventScheduler, KernelStackServer, LoadGen,
                              NetworkStack, PacketPool, PipelineServer,
                              QueueTelemetry, SimClock)

from .config import CostConfig, DcaConfig, ExperimentConfig, StackConfig

StackFactory = Callable[[StackConfig, Sequence[EthDev]], NetworkStack]

_STACKS: Dict[str, StackFactory] = {}


def register_stack(kind: str) -> Callable[[StackFactory], StackFactory]:
    """Register a server-stack factory under ``StackConfig.kind == kind``."""

    def deco(fn: StackFactory) -> StackFactory:
        _STACKS[kind] = fn
        return fn

    return deco


def stack_kinds() -> List[str]:
    return sorted(_STACKS)


def build_stack(cfg: StackConfig, devs: Sequence[EthDev]) -> NetworkStack:
    """Resolve ``cfg.kind`` through the registry and build the server — the
    one lookup point shared by :class:`Testbed` and the topology builder."""
    if cfg.kind not in _STACKS:
        raise ValueError(
            f"unknown stack kind {cfg.kind!r}; registered: {stack_kinds()}")
    return _STACKS[cfg.kind](cfg, devs)


@register_stack("bypass")
def _build_bypass(cfg: StackConfig, devs: Sequence[EthDev]) -> NetworkStack:
    plan = (BurstPlan(burst_size=cfg.burst_size, per_lcore=cfg.per_lcore_bursts)
            if cfg.per_lcore_bursts is not None else None)
    return BypassL2FwdServer(list(devs), burst_size=cfg.burst_size,
                             n_lcores=cfg.n_lcores, plan=plan)


def effective_stack_config(stack: StackConfig,
                           dca: Optional[DcaConfig]) -> StackConfig:
    """Fold a :class:`DcaConfig`'s burst plan into the stack config (DCA
    overrides the legacy burst knobs) — shared by Testbed and Cluster."""
    if dca is None:
        return stack
    return replace(stack, burst_size=dca.burst_size,
                   per_lcore_bursts=dca.per_lcore_bursts)


def effective_writeback_threshold(dca: Optional[DcaConfig],
                                  legacy: Optional[int],
                                  queue_id: int = 0) -> Optional[int]:
    """One RX ring's writeback threshold: the DcaConfig centralizes the
    descriptor-path knobs and overrides the per-port legacy value; a
    per-queue entry (``dca.per_queue_writeback_thresholds``) in turn
    overrides the DcaConfig-global threshold for its queue."""
    return dca.threshold_for(queue_id) if dca is not None else legacy


def apply_dca(dca: Optional[DcaConfig], devs: Sequence[EthDev],
              server: NetworkStack, sched: EventScheduler) -> None:
    """Arm the sim-time DCA model on built devices + stack: writeback-timeout
    timers on every RX ring (ITR analogue, events on ``sched``) and Fig. 4
    accumulate-then-forward on stacks that support it, both bounded by the
    same ``writeback_timeout_ns``.  One code path for single-host testbeds
    and topology nodes, so the two can never diverge on the same DcaConfig."""
    if dca is None:
        return
    for dev in devs:
        dev.attach_dca(sched, dca.writeback_timeout_ns, dca.writeback_dma_ns)
    if hasattr(server, "enable_dca_accumulate"):
        server.enable_dca_accumulate(dca.writeback_timeout_ns)


@register_stack("pipeline")
def _build_pipeline(cfg: StackConfig, devs: Sequence[EthDev]) -> NetworkStack:
    return PipelineServer(devs[0], burst_size=cfg.burst_size,
                          stage_ring_capacity=cfg.stage_ring_capacity)


@register_stack("kernel")
def _build_kernel(cfg: StackConfig, devs: Sequence[EthDev]) -> NetworkStack:
    cost = cfg.cost.to_host_cost_model() if cfg.cost is not None else None
    return KernelStackServer(list(devs), cost_model=cost,
                             sockbuf_budget=cfg.sockbuf_budget,
                             sockbuf_capacity=cfg.sockbuf_capacity,
                             n_lcores=cfg.n_lcores)


class Testbed:
    """Live experiment objects built from one config; the single assembly
    point that replaces the hand-wired pool → rings → Port → server → LoadGen
    setup every benchmark used to copy-paste."""

    __test__ = False  # name starts with "Test" but this is not a test class

    def __init__(self, cfg: ExperimentConfig, pool: PacketPool,
                 devs: List[EthDev], server: NetworkStack, loadgen: LoadGen,
                 clock: Optional[SimClock] = None,
                 sched: Optional[EventScheduler] = None):
        self.cfg = cfg
        self.pool = pool
        self.devs = devs
        self.server = server
        self.loadgen = loadgen
        self.clock = clock  # the testbed's virtual time (None == wall clock)
        self.sched = sched  # event queue on that clock (writeback timers &c.)
        self.telemetry = QueueTelemetry()

    @property
    def ports(self) -> List[EthDev]:
        """The wire-side devices (EthDevs are drop-ins for legacy Ports)."""
        return self.devs

    @classmethod
    def build(cls, cfg: ExperimentConfig) -> "Testbed":
        pool = PacketPool(cfg.pool.n_slots, cfg.pool.slot_size)
        devs: List[EthDev] = []
        for dev_id, pc in enumerate(cfg.ports):
            dev = EthDev(pool, dev_id=dev_id).configure(EthConf(
                n_rx_queues=pc.n_queues, n_tx_queues=pc.n_queues,
                rss_key=pc.rss.key, rss_table_size=pc.rss.table_size,
                link_gbps=pc.link.gbps, link_latency_ns=pc.link.latency_ns))
            for q in range(pc.n_queues):
                thr = effective_writeback_threshold(
                    cfg.dca, pc.writeback_threshold, q)
                dev.rx_queue_setup(q, pc.ring_size, writeback_threshold=thr)
                dev.tx_queue_setup(q, pc.ring_size)
            devs.append(dev.dev_start())
        server = build_stack(effective_stack_config(cfg.stack, cfg.dca), devs)
        clock: Optional[SimClock] = None
        sched: Optional[EventScheduler] = None
        if cfg.traffic.sim_time:
            # one virtual clock per testbed: the loadgen advances it, the
            # server charges lcore busy-time against it, and one event queue
            # on that clock carries NIC-side timers
            clock = SimClock()
            sched = EventScheduler(clock)
            if hasattr(server, "attach_clock"):
                cost = (cfg.stack.cost if cfg.stack.cost is not None
                        else CostConfig())
                server.attach_clock(clock, cost.to_host_cost_model())
            apply_dca(cfg.dca, devs, server, sched)
        t = cfg.traffic
        loadgen = LoadGen(devs, ts_offset=t.ts_offset,
                          verify_integrity=t.verify_integrity,
                          max_tx_burst=t.max_tx_burst, n_flows=t.n_flows)
        return cls(cfg, pool, devs, server, loadgen, clock=clock, sched=sched)

    def xstats(self) -> Dict[str, int]:
        """Merged extended stats over every device, DPDK-named with a
        ``d{dev}_`` prefix."""
        out: Dict[str, int] = {}
        for dev in self.devs:
            for k, v in dev.xstats().items():
                out[f"d{dev.dev_id}_{k}"] = v
        return out
