"""The port's device layer against the JAX package's: the ``rte_ethdev``
facade (``core/ethdev.py``), the kernel stack (``core/kernel_stack.py``) and
the DCA model (``core/dca.py``).

Each scenario of ``tests/test_ethdev.py`` is written once against a module
namespace and run on both packages' ``core``; every call's outcome (its
value, or its exception's class name and message), every state, counter and
xstat must be the same. The kernel stack's RunReport and counters, the
standalone burst experiment's occupancy trace and delays (bursts 1, 32,
1024) and the Fig. 4 DCA configs through ``run_experiment`` are held
bit-equal too.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as RC
import repro.exp as RX
import repro_torch.core as TC
import repro_torch.exp as TX
from test_fastpath import queue_stats_key
from test_torch_exp import jax_run, port_run, to_port


def plain(value):
    """A call's result as plain comparable data."""
    if isinstance(value, np.ndarray):
        return ("ndarray", str(value.dtype), value.tolist())
    if isinstance(value, (tuple, list)):
        return [plain(v) for v in value]
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if hasattr(value, "as_dict"):
        return value.as_dict()
    if hasattr(value, "state") and hasattr(value, "xstats"):  # an EthDev
        return ("dev", value.state.name)
    return value


class Log:
    """Records each call's outcome: ("ok", value) or ("raise", class, message)."""

    def __init__(self):
        self.items = []

    def __call__(self, label, fn):
        try:
            out = ("ok", plain(fn()))
        except Exception as exc:  # the outcome is what is compared
            out = ("raise", type(exc).__name__, str(exc))
        self.items.append((label, out))

    def note(self, label, value):
        self.items.append((label, plain(value)))


def _dev(C, n_queues=2, ring=64, pool_slots=1024):
    return C.EthDev.make(C.PacketPool(pool_slots, 1518), ring_size=ring, n_queues=n_queues)


def lifecycle(C, log):
    dev = C.EthDev(C.PacketPool(256, 1518))
    log.note("state", dev.state.name)
    log("configure", lambda: dev.configure(C.EthConf(n_rx_queues=2, n_tx_queues=2)))
    for q in range(2):
        log("rx_setup", lambda: dev.rx_queue_setup(q, 64))
        log("tx_setup", lambda: dev.tx_queue_setup(q, 64))
    for op in ("dev_start", "dev_stop", "dev_start"):
        log(op, getattr(dev, op))
        log.note("state", dev.state.name)


def illegal_transitions(C, log):
    dev = C.EthDev(C.PacketPool(256, 1518))
    log("start", dev.dev_start)
    log("rx_setup", lambda: dev.rx_queue_setup(0, 64))
    log("rx_burst", lambda: dev.rx_burst(0, 32))
    log("stop", dev.dev_stop)
    log("configure", lambda: dev.configure(C.EthConf()))
    log("start unset", dev.dev_start)
    log("rx_setup", lambda: dev.rx_queue_setup(0, 64))
    log("tx_setup", lambda: dev.tx_queue_setup(0, 64))
    log("start", dev.dev_start)
    log("configure running", lambda: dev.configure(C.EthConf()))
    log("rx_setup running", lambda: dev.rx_queue_setup(0, 64))
    log("tx_setup running", lambda: dev.tx_queue_setup(0, 64))
    log("start twice", dev.dev_start)
    log("stop", dev.dev_stop)
    log("stop twice", dev.dev_stop)


def dataplane_gated(C, log):
    dev = _dev(C)
    log("stop", dev.dev_stop)
    log("rx_burst", lambda: dev.rx_burst(0, 32))
    log("tx_burst", lambda: dev.tx_burst(0, np.array([0]), np.array([64])))
    log("deliver", lambda: dev.deliver(0, 64))
    log("port", lambda: dev.port)
    log("start", dev.dev_start)
    log("rx_burst", lambda: dev.rx_burst(0, 32))


def reconfigure_after_stop(C, log):
    dev = _dev(C, n_queues=2)
    log("stop", dev.dev_stop)
    log("configure", lambda: dev.configure(C.EthConf(n_rx_queues=4, n_tx_queues=4)))
    log.note("state", dev.state.name)
    log("n_queues", lambda: dev.n_queues)
    log("start", dev.dev_start)
    for q in range(4):
        log("rx_setup", lambda: dev.rx_queue_setup(q, 32))
        log("tx_setup", lambda: dev.tx_queue_setup(q, 32))
    log("start", dev.dev_start)
    log("rx_queues", lambda: [r.size for r in dev.rx_queues])


def queue_setup_bounds(C, log):
    dev = C.EthDev(C.PacketPool(256, 1518)).configure(C.EthConf(n_rx_queues=2, n_tx_queues=2))
    for side, q, n in (("rx", 2, 64), ("rx", -1, 64), ("tx", 5, 64), ("rx", 0, 0),
                       ("rx", 1, 64), ("tx", 0, 64)):
        log(f"{side}_setup {q} {n}", lambda: getattr(dev, f"{side}_queue_setup")(q, n))


def ethconf_validation(C, log):
    log("zero queues", lambda: C.EthConf(n_rx_queues=0))
    log("unpaired", lambda: C.EthConf(n_rx_queues=2, n_tx_queues=4))
    log("fine", lambda: dataclasses.asdict(C.EthConf(n_rx_queues=3, n_tx_queues=3)))


def burst_roundtrip(C, log):
    dev = _dev(C, n_queues=1, ring=64)
    pool = dev.pool
    for i in range(8):
        s = pool.alloc()
        pool.write_packet(s, seq=i, length=128, fill=0)
        log("deliver", lambda: dev.deliver(s, 128))
    dev.flush_rx()
    slots, lengths = dev.rx_burst(0, 64)
    log.note("rx", (slots, lengths))
    log("tx_burst", lambda: dev.tx_burst(0, slots, lengths))
    log("drain", lambda: dev.drain_tx_bursts(64))
    log("stats", dev.stats)


def counters_across_stop_start(C, log):
    dev = _dev(C, n_queues=2, ring=64)
    pool = dev.pool
    s = pool.alloc()
    pool.write_packet(s, seq=0, length=128, fill=0)
    dev.deliver(s, 128)
    dev.dev_stop()
    dev.rx_queue_setup(0, 128)
    dev.tx_queue_setup(1, 32)
    dev.dev_start()
    log("stats", dev.stats)
    log("sizes", lambda: ([r.size for r in dev.rx_queues], [t.size for t in dev.tx_queues]))
    dev.rss.rebalance([1] * 128)
    dev.dev_stop()
    dev.dev_start()
    log("rss", lambda: dev.rss.table)


def _traffic(C, n_queues, n_packets):
    dev = C.EthDev.make(C.PacketPool(4096, 1518), ring_size=256, n_queues=n_queues)
    server = C.BypassL2FwdServer([dev], burst_size=32, n_lcores=n_queues)
    clock = C.SimClock()
    server.attach_clock(clock)
    rep = C.LoadGen([dev]).run_closed_loop(server, n_packets=n_packets, packet_size=256,
                                           clock=clock)
    return dev, server, rep


def stats_and_xstats(C, log):
    dev, server, rep = _traffic(C, 4, 1200)
    log.note("report", rep.to_dict())
    log.note("queues", queue_stats_key(server))
    log("xstats", dev.xstats)
    log("stats", dev.stats)
    log("legacy", lambda: (dev.port.rx_delivered, dev.port.rx_dropped, dev.port.tx_posted))
    dev.stats_reset()
    log("stats after reset", dev.stats)
    log("xstats after reset", dev.xstats)


def imissed_and_nombuf(C, log):
    pool = C.PacketPool(512, 1518)
    dev = C.EthDev.make(pool, ring_size=8, writeback_threshold=8, n_queues=1)
    for i in range(32):  # nobody polls: the ring fills at 8
        s = pool.alloc()
        pool.write_packet(s, seq=i, length=128, fill=0)
        log("deliver", lambda: dev.deliver(s, 128))
    log("stats", dev.stats)
    log("xstats", dev.xstats)
    pool = C.PacketPool(4, 1518)
    dev = C.EthDev.make(pool, ring_size=8, writeback_threshold=8, n_queues=1)
    for _ in range(6):
        log("alloc", pool.alloc)
    log("nombuf", lambda: dev.stats().rx_nombuf)
    dev.stats_reset()
    pool.alloc()
    log("nombuf after reset", lambda: dev.stats().rx_nombuf)


def dropin_for_port(C, log):
    pool = C.PacketPool(4096, 1518)
    devs = [C.EthDev.make(pool, ring_size=256, n_queues=2, dev_id=i) for i in range(2)]
    server = C.BypassL2FwdServer(devs, burst_size=32)
    clock = C.SimClock()
    server.attach_clock(clock)
    rep = C.LoadGen(devs, verify_integrity=True).run_closed_loop(
        server, n_packets=600, packet_size=200, rng=np.random.default_rng(0), clock=clock)
    log.note("report", rep.to_dict())
    log.note("queues", queue_stats_key(server))
    for d in devs:
        log("xstats", d.xstats)


SCENARIOS = [lifecycle, illegal_transitions, dataplane_gated, reconfigure_after_stop,
             queue_setup_bounds, ethconf_validation, burst_roundtrip,
             counters_across_stop_start, stats_and_xstats, imissed_and_nombuf,
             dropin_for_port]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_ethdev_scenario_equal(scenario):
    logs = []
    for C in (RC, TC):
        log = Log()
        scenario(C, log)
        logs.append(log.items)
    assert logs[1] == logs[0]
    if scenario in (illegal_transitions, dataplane_gated, queue_setup_bounds,
                    ethconf_validation):  # the errors were reached, and are equal
        assert any(out[0] == "raise" for _, out in logs[0] if isinstance(out, tuple))


def test_ethdev_names_are_the_jax_package_s():
    assert [s.name for s in TC.EthDevState] == [s.name for s in RC.EthDevState]
    assert [s.value for s in TC.EthDevState] == [s.value for s in RC.EthDevState]
    assert issubclass(TC.EthDevError, RuntimeError)
    assert [f.name for f in dataclasses.fields(TC.EthStats)] == [
        f.name for f in dataclasses.fields(RC.EthStats)]


# -- the kernel stack ---------------------------------------------------------

def _kernel_run(C, cost):
    pool = C.PacketPool(4096, 2048)
    ports = [C.Port.make(pool, ring_size=256, writeback_threshold=8, n_queues=2,
                         link_gbps=40.0, link_latency_ns=1000)]
    server = C.KernelStackServer(ports, cost_model=C.HostCostModel(**cost), n_lcores=2,
                                 sockbuf_budget=8, sockbuf_capacity=64)
    clock = C.SimClock()
    server.attach_clock(clock, cost=C.HostCostModel(**cost))
    pattern = C.TrafficPattern(rate_gbps=8.0, packet_size=1024, kind="bursty", burst_len=16)
    rep = C.LoadGen(ports).run_sim(server, pattern, duration_s=0.0005, clock=clock)
    return (rep.to_dict(), queue_stats_key(server), clock.now_ns,
            plain(dataclasses.asdict(server.stats)), ports[0].rx_delivered,
            ports[0].rx_dropped)


@pytest.mark.parametrize("cost", [{}, {"cpu_ghz": 3.0, "interrupt_cycles": 4000}],
                         ids=["default-cost", "fig3b-cost"])
def test_kernel_stack_equal(cost):
    want = _kernel_run(RC, cost)
    assert want[0]["received"] > 0 and want[3]["interrupts"] > 0
    assert _kernel_run(TC, cost) == want


# -- DCA ----------------------------------------------------------------------

@pytest.mark.parametrize("burst", [1, 32, 1024])
def test_burst_experiment_equal(burst):
    outs = []
    for C in (RC, TC):
        trace, delay = C.run_burst_experiment(n_packets=1024, burst_size=burst,
                                              writeback_threshold=32)
        outs.append((trace.samples, trace.capacity, trace.high_water, trace.mean,
                     trace.pressure(), delay.dtype.str, delay.tolist()))
    assert outs[1] == outs[0]


def test_burst_plan_equal():
    for kw in ({"burst_size": 32}, {"burst_size": 8, "per_lcore": (8, 16)}):
        ref, port = RC.BurstPlan(**kw), TC.BurstPlan(**kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert [port.burst_for(i) for i in range(2)] == [ref.burst_for(i) for i in range(2)]
    with pytest.raises(ValueError) as ref:
        RC.BypassL2FwdServer([_dev(RC)], n_lcores=2, plan=RC.BurstPlan(per_lcore=(8,)))
    with pytest.raises(ValueError) as port:
        TC.BypassL2FwdServer([_dev(TC)], n_lcores=2, plan=TC.BurstPlan(per_lcore=(8,)))
    assert str(port.value) == str(ref.value)


def fig4_config(burst, duration_s=0.002):
    """benchmarks/fig4_dca_burst.py's config at a shorter run."""
    return RX.ExperimentConfig(
        name=f"fig4-burst-{burst}",
        ports=(RX.PortConfig(n_queues=1, ring_size=2048),),
        stack=RX.StackConfig(kind="bypass", n_lcores=1),
        traffic=RX.TrafficConfig(mode="open_loop", rate_gbps=10.0, packet_size=1518,
                                 duration_s=duration_s, seed=3),
        dca=RX.DcaConfig(burst_size=burst, writeback_threshold=32,
                         writeback_timeout_ns=200_000))


@pytest.mark.parametrize("burst", [1, 32, 1024])
def test_fig4_dca_equal(burst):
    cfg = fig4_config(burst)
    want = jax_run(cfg)
    assert want[0]["received"] == want[0]["sent"] > 0
    assert want[0]["extras"]["p0q0_writebacks"] > 0
    for engine in ("epoch", "epoch-torch"):  # DCA timers: the event loop runs
        assert port_run(cfg, engine) == want


def test_dca_pipeline_and_writeback_dma_equal():
    """tests/test_dca_sim.py's pipeline accumulation and writeback-DMA
    configs, and its bandwidth search with DCA timers."""
    base = fig4_config(32, duration_s=0.001)
    for cfg in (base.with_stack(kind="pipeline"), base.with_dca(writeback_dma_ns=20_000)):
        assert port_run(cfg, "epoch-torch") == jax_run(cfg)
    msb = RX.ExperimentConfig(
        name="dca-msb", ports=(RX.PortConfig(ring_size=2048),),
        stack=RX.StackConfig(kind="bypass", n_lcores=1),
        traffic=RX.TrafficConfig(mode="msb", packet_size=1518, start_gbps=1.0,
                                 max_gbps=8.0, trial_s=0.0005, refine_iters=1),
        dca=RX.DcaConfig(burst_size=32, writeback_threshold=32,
                         writeback_timeout_ns=100_000))
    want = RX.run_experiment(msb).to_dict()
    assert TX.run_experiment(to_port(msb), device="cpu").to_dict() == want
