"""The port's simulator against the JAX package's, on the configs of
``tests/test_fastpath.py`` (fast-path configs here, fallback configs in
``tests/test_torch_netsim_fallback.py``).

Both testbeds are built from one parameter set (``build``'s arguments in
``tests/test_fastpath.py``). For each config, the port's event loop
(``LoadGen.run_sim``) and its epoch engine with the numpy pass
(``run_epoch_sim(device=None)``) and with the torch pass on the CPU
(``device="cpu"``, the plain version of the CUDA kernel) must give the
JAX package's event-loop RunReport, per-queue stats and final clock
bit-for-bit, and the same fast-path outcome and fallback reason as its
epoch engine.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro_torch.core import fastpath as TF
from repro_torch.core import loadgen as TL
from repro_torch.core import packet as TK
from repro_torch.core import pmd as TP
from repro_torch.core import simclock as TS
from repro_torch.core import telemetry as TT
from test_fastpath import FASTPATH_CASES, build, queue_stats_key, report_key


def port_build(n_queues=4, ring=1024, wb=32, burst=64, n_lcores=4, gbps=40.0,
               lat=1000, pool_slots=8192, nports=1):
    """``tests/test_fastpath.py``'s ``build`` on the port's classes."""
    pools = [TK.PacketPool(pool_slots, 2048) for _ in range(nports)]
    ports = [TP.Port.make(pools[i], ring_size=ring, writeback_threshold=wb,
                          n_queues=n_queues, link_gbps=gbps, link_latency_ns=lat)
             for i in range(nports)]
    server = TP.BypassL2FwdServer(ports, burst_size=burst, n_lcores=n_lcores)
    clock = TS.SimClock()
    server.attach_clock(clock)
    return server, ports, clock


def port_pattern(pattern):
    return TL.TrafficPattern(**dataclasses.asdict(pattern))


def observe(rep, server, clock):
    return report_key(rep), queue_stats_key(server), clock.now_ns


def jax_package_runs(pattern, dur, kw):
    """The JAX package's event-loop observation and its epoch engine's info."""
    server, ports, clock = build(**kw)
    rep = R.LoadGen(ports).run_sim(server, pattern, duration_s=dur, clock=clock)
    want = observe(rep, server, clock)
    server, ports, clock = build(**kw)
    info = R.EpochRunInfo()
    rep = R.run_epoch_sim(R.LoadGen(ports), server, pattern, duration_s=dur, clock=clock,
                          info=info)
    assert observe(rep, server, clock) == want
    return want, rep, info


def check_port_engines(pattern, dur, kw):
    want, ref_rep, ref_info = jax_package_runs(pattern, dur, kw)
    server, ports, clock = port_build(**kw)
    rep = TL.LoadGen(ports).run_sim(server, port_pattern(pattern), duration_s=dur,
                                    clock=clock)
    assert observe(rep, server, clock) == want
    for device in (None, "cpu"):
        server, ports, clock = port_build(**kw)
        info = TF.EpochRunInfo()
        rep = TF.run_epoch_sim(TL.LoadGen(ports), server, port_pattern(pattern),
                               duration_s=dur, clock=clock, device=device, info=info)
        assert observe(rep, server, clock) == want
        assert rep.to_dict() == ref_rep.to_dict()
        assert (info.fastpath, info.fallback_reason, info.n_packets) == (
            ref_info.fastpath, ref_info.fallback_reason, ref_info.n_packets)
        assert info.engine == ("epoch" if device is None else "epoch-torch")
        assert info.pass_device == device
        if info.fastpath:
            assert info.n_epochs == ref_info.n_epochs > 0
    return ref_info


@pytest.mark.parametrize("name,pattern,dur,kw", FASTPATH_CASES,
                         ids=[c[0] for c in FASTPATH_CASES])
def test_port_engines_match_jax_package_on_fastpath(name, pattern, dur, kw):
    info = check_port_engines(pattern, dur, kw)
    assert info.fastpath, info.fallback_reason


def test_torch_pass_counts_one_plain_call_an_epoch():
    """On the CPU the engine's pass is the plain version, one call an epoch
    slice of each port (the card's kernel counts one launch each)."""
    from repro_torch.kernels import ref
    name, pattern, dur, kw = FASTPATH_CASES[4]  # two ports
    server, ports, clock = port_build(**kw)
    info = TF.EpochRunInfo()
    before = ref.calls
    TF.run_epoch_sim(TL.LoadGen(ports), server, port_pattern(pattern), duration_s=dur,
                     clock=clock, device="cpu", info=info, epoch_ns=200_000)
    assert info.fastpath and info.n_epochs >= 2 * 10
    assert ref.calls - before == info.n_epochs


def test_run_report_round_trips_from_the_jax_package():
    """The port's RunReport.from_dict takes the JAX package's to_dict()."""
    name, pattern, dur, kw = FASTPATH_CASES[1]
    server, ports, clock = build(**kw)
    rep = R.LoadGen(ports).run_sim(server, pattern, duration_s=dur, clock=clock)
    d = rep.to_dict()
    assert d["latency"] is not None and d["histogram"]
    mine = TT.RunReport.from_dict(d)
    assert mine.to_dict() == d and mine.summary() == rep.summary()
    assert mine.drop_pct == rep.drop_pct


def test_latency_recorder_and_queue_telemetry_match():
    rng = np.random.default_rng(0)
    rtts = rng.integers(100, 100_000, 5000)
    a, b = R.LatencyRecorder(capacity_hint=16), TT.LatencyRecorder(capacity_hint=16)
    for rec in (a, b):
        rec.record(7)
        rec.record_many(rtts)
    assert a.count == b.count == 5001
    assert a.stats().as_dict() == b.stats().as_dict()
    assert a.histogram() == b.histogram() and a.histogram(7) == b.histogram(7)
    assert TT.rss_skew([3, 5, 0, 9]) == R.rss_skew([3, 5, 0, 9])
    assert TT.rss_skew([]) == R.rss_skew([])
    # occupancy sampled after a run, and the writeback extras
    name, pattern, dur, kw = FASTPATH_CASES[0]
    server, ports, clock = build(**kw)
    R.LoadGen(ports).run_sim(server, pattern, duration_s=dur, clock=clock)
    s2, p2, c2 = port_build(**kw)
    TL.LoadGen(p2).run_sim(s2, port_pattern(pattern), duration_s=dur, clock=c2)
    qa, qb = R.QueueTelemetry(), TT.QueueTelemetry()
    qa.sample(ports)
    qb.sample(p2)
    assert qa.summary(ports) == qb.summary(p2) and qb.samples == 1
    assert R.writeback_extras(ports) == TT.writeback_extras(p2)
