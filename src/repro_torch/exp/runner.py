"""``run_experiment(cfg) -> RunReport`` — the single entry point.

Every paper benchmark and example drives the dataplane through this function
(or through a :class:`~repro_torch.exp.testbed.Testbed` it built itself when it
needs mid-run access to the server).  The traffic mode selects the drive:

* ``closed_loop`` — deterministic n-packet conservation run;
* ``open_loop``   — paced offered load for a fixed duration;
* ``msb``         — EtherLoadGen bandwidth-test mode (fresh testbed per
  trial, so no state leaks between rates), reporting the best sustainable
  trial with ``extras["msb_gbps"]``.

Own copy, in the PyTorch port, of ``src/repro/exp/runner.py``: the same
numpy and plain Python, with its imports pointing into ``repro_torch``, and
one change.  :func:`run_testbed` and :func:`run_experiment` take ``device``
(keyword, ``"cuda"`` by default), where the epoch pass of an
``engine="epoch-torch"`` run goes: ``"cuda"`` launches the hand-written
kernel, ``"cpu"`` runs its plain torch version.  ``engine="epoch"`` runs the
numpy pass whatever ``device`` says.  ``device`` is an execution argument and
never a config field, so configs stay the reference's data.  A run that asks
for ``"epoch-torch"`` on ``"cuda"`` raises where no CUDA device is present
(:func:`repro_torch.core.fastpath.run_epoch_sim`); it never falls back to the
numpy pass or the CPU, and an error of the pass propagates.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core import (EpochRunInfo, EthDev, NetworkStack, PARTITIONED_REASON,
                              PartitionRunInfo, RunReport, TrafficPattern,
                              find_max_sustainable_bandwidth, run_epoch_sim)

from .config import ExperimentConfig, TopologyConfig
from .testbed import Testbed
from .topology import Cluster, run_partitioned_topology


def make_server_factory(
    cfg: ExperimentConfig,
) -> Callable[[], Tuple[NetworkStack, List[EthDev]]]:
    """Fresh-state ``() -> (server, devs)`` factory — what MSB searches and
    repeated-trial sweeps need (every call builds a brand-new testbed)."""

    def factory() -> Tuple[NetworkStack, List[EthDev]]:
        tb = Testbed.build(cfg)
        return tb.server, tb.devs

    return factory


def run_testbed(tb: Testbed, *, device: str = "cuda") -> RunReport:
    """Drive an already-built testbed per its config's traffic mode
    (``closed_loop`` or ``open_loop``; ``msb`` needs fresh testbeds per trial
    — use :func:`run_experiment`).  ``cfg.traffic.sim_time`` selects virtual
    time (the testbed's SimClock, deterministic) vs. wall-clock pacing.
    ``device`` is where an ``"epoch-torch"`` run's epoch pass goes."""
    t = tb.cfg.traffic
    if t.mode == "closed_loop":
        rng = (np.random.default_rng(t.payload_seed)
               if t.payload_seed is not None else None)
        return tb.loadgen.run_closed_loop(
            tb.server, n_packets=t.n_packets, packet_size=t.packet_size,
            window=t.window, rng=rng, clock=tb.clock)
    if t.mode == "open_loop":
        pattern = TrafficPattern(rate_gbps=t.rate_gbps,
                                 packet_size=t.packet_size, kind=t.kind,
                                 burst_len=t.burst_len, seed=t.seed)
        if tb.clock is not None:
            if t.engine in ("epoch", "epoch-torch"):
                # bit-identical fast path; configs it cannot prove exact
                # (timers, DCA accumulate, custom stacks) fall back to the
                # event loop inside run_epoch_sim, so the report never changes
                return run_epoch_sim(tb.loadgen, tb.server, pattern,
                                     duration_s=t.duration_s, clock=tb.clock,
                                     sched=tb.sched,
                                     device=(device if t.engine == "epoch-torch"
                                             else None))
            return tb.loadgen.run_sim(tb.server, pattern,
                                      duration_s=t.duration_s, clock=tb.clock,
                                      sched=tb.sched)
        return tb.loadgen.run(tb.server, pattern, duration_s=t.duration_s,
                              drain_timeout_s=t.drain_timeout_s)
    raise ValueError(f"run_testbed cannot drive traffic mode {t.mode!r}")


def run_experiment(cfg: ExperimentConfig, *, device: str = "cuda") -> RunReport:
    """Build + run one experiment from config alone; ``device`` is where an
    ``"epoch-torch"`` run's epoch pass goes."""
    t = cfg.traffic
    if t.mode in ("closed_loop", "open_loop"):
        return run_testbed(Testbed.build(cfg), device=device)
    # msb: ramp + bisect over fresh testbeds
    gbps, reports = find_max_sustainable_bandwidth(
        make_server_factory(cfg),
        packet_size=t.packet_size,
        start_gbps=t.start_gbps,
        max_gbps=t.max_gbps,
        trial_s=t.trial_s,
        drop_tolerance_pct=t.drop_tolerance_pct,
        refine_iters=t.refine_iters,
        pattern_kind=t.kind,
        sim_time=t.sim_time,
        engine=t.engine,
        device=device,
    )
    good = [r for r in reports
            if r.drop_pct <= t.drop_tolerance_pct and r.received > 0]
    rep = max(good, key=lambda r: r.achieved_gbps) if good else RunReport()
    rep.extras["msb_gbps"] = gbps
    rep.extras["msb_trials"] = float(len(reports))
    return rep


def run_topology_experiment(cfg: TopologyConfig, *,
                            info: Optional[EpochRunInfo] = None,
                            partition_info: Optional[PartitionRunInfo] = None,
                            ) -> RunReport:
    """Build + run one multi-host topology (N clients → switch → nodes) from
    config alone; the merged RunReport carries per-switch-port
    drop/occupancy telemetry in ``extras``.

    ``cfg.partition`` selects the execution engine — the shared-clock loop
    or the epoch-windowed partitioned engines; the report is bit-identical
    either way (ineligible configs fall back, reason in ``partition_info``).
    Partitioned execution is an *event-loop* engine: if the traffic config
    also asked for the epoch fast path (``traffic.engine != "event"``), that
    request records a :data:`~repro_torch.core.fastpath.PARTITIONED_REASON`
    fallback in ``info`` — the taxonomy composes instead of silently
    ignoring one knob."""
    if cfg.partition == "shared-clock":
        if partition_info is not None:
            partition_info.mode_requested = partition_info.mode_used = \
                "shared-clock"
            partition_info.n_workers = 1
        return Cluster.build(cfg).run()
    if info is not None and cfg.traffic.engine != "event":
        info.engine = cfg.traffic.engine
        info.fastpath = False
        info.fallback_reason = PARTITIONED_REASON
    return run_partitioned_topology(cfg, info=partition_info)
