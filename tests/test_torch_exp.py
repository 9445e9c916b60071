"""The port's experiment layer (``repro_torch.exp``) against the JAX
package's (``repro.exp``).

Each config is built once as a JAX ``ExperimentConfig`` and carried over to
the port through ``to_dict`` -> the port's ``from_dict`` (the simulator's
counterpart of carrying weights across). The port must give the same dicts,
fingerprints and derived seeds, and ``run_experiment`` must give the JAX
package's RunReport, per-queue stats, final clock and xstats bit-for-bit:
closed loop, open loop under each engine (``"epoch-torch"`` on the CPU, the
plain version of the CUDA kernel), the bandwidth search on the three stacks,
Fig. 3a's search at 1 and 4 ports and one Fig. 3b step. The configs are
those of ``tests/test_exp.py`` and ``tests/test_config_roundtrip_meta.py``.
"""
import dataclasses
import json

import pytest
import torch

import repro.exp as RX
import repro.exp.config as RCFG
import repro_torch.exp as TX
import repro_torch.exp.config as TCFG
import test_config_roundtrip_meta as META
import test_exp as EXP
from test_fastpath import queue_stats_key


def to_port(cfg):
    """A JAX package config carried over to the port's class of that name."""
    return getattr(TCFG, type(cfg).__name__).from_dict(cfg.to_dict())


def observe_testbed(tb, rep):
    """Everything a testbed run leaves that must be bit-equal across the
    packages: the RunReport, per-queue stats, the clock and each device's
    xstats."""
    return (rep.to_dict(), queue_stats_key(tb.server),
            None if tb.clock is None else tb.clock.now_ns,
            [dev.xstats() for dev in tb.devs])


def jax_run(cfg):
    tb = RX.Testbed.build(cfg)
    return observe_testbed(tb, RX.run_testbed(tb))


def port_run(cfg, engine=None, device="cpu"):
    tcfg = to_port(cfg)
    if engine is not None:
        tcfg = tcfg.with_traffic(engine=engine)
    tb = TX.Testbed.build(tcfg)
    return observe_testbed(tb, TX.run_testbed(tb, device=device))


# -- configs: round trips, defaults, fingerprints ----------------------------

EXP_CLASSES = [c for c in META.CONFIG_CLASSES if c.__module__ == RCFG.__name__]

# test_exp.py's and test_config_roundtrip_meta.py's experiment/topology configs
CONFIGS = {
    "default": RX.ExperimentConfig(),
    "full": EXP._full_config(),
    **{f"closed-{k}": EXP._closed_loop(k) for k in ("bypass", "pipeline", "kernel")},
    "meta-experiment": META.SAMPLES[RX.ExperimentConfig](),
    "meta-topology": META.SAMPLES[RX.TopologyConfig](),
    "default-topology": RX.TopologyConfig(),
}


def test_the_port_has_every_config_class():
    port = sorted(c.__name__ for c in META._config_classes(TCFG))
    assert port == sorted(c.__name__ for c in EXP_CLASSES)
    assert TCFG.TRAFFIC_ENGINES == ("event", "epoch", "epoch-torch")
    for name in ("TRAFFIC_MODES", "AQM_KINDS", "CC_MODES", "PARTITION_MODES"):
        assert getattr(TCFG, name) == getattr(RCFG, name)


@pytest.mark.parametrize("cls", EXP_CLASSES, ids=lambda c: c.__name__)
def test_samples_carry_over_exactly(cls):
    d = META.SAMPLES[cls]().to_dict()
    tcls = getattr(TCFG, cls.__name__)
    port = tcls.from_dict(d)
    assert port.to_dict() == d
    assert tcls.from_dict(json.loads(json.dumps(d))) == port
    assert tcls.from_dict(port.to_dict()) == port


def _engine_free(d):
    """A config dict without its traffic engine, at whatever depth."""
    if isinstance(d, dict):
        return {k: _engine_free(v) for k, v in d.items() if k != "engine"}
    if isinstance(d, list):
        return [_engine_free(v) for v in d]
    return d


@pytest.mark.parametrize("cls", EXP_CLASSES, ids=lambda c: c.__name__)
def test_defaults_equal_apart_from_the_engine(cls):
    ref, port = cls().to_dict(), getattr(TCFG, cls.__name__)().to_dict()
    assert _engine_free(port) == _engine_free(ref)
    if "engine" in port or "traffic" in port:
        engine = port["engine"] if "engine" in port else port["traffic"]["engine"]
        assert engine == "epoch-torch"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fingerprints_and_seeds_equal(name):
    cfg = CONFIGS[name]
    d = cfg.to_dict()
    port = to_port(cfg)
    assert port.to_dict() == d
    fp = RX.config_fingerprint(d)
    assert TX.config_fingerprint(port.to_dict()) == fp
    # the engine is execution-only: scrubbed, so it never moves a seed
    assert TX.config_fingerprint(port.with_traffic(engine="epoch-torch").to_dict()) == fp
    for i in range(3):
        for role in ("client", "replicate"):
            assert TX.derive_seed(fp, i, role) == RX.derive_seed(fp, i, role)


def test_validation_errors_are_the_jax_package_s():
    cases = [
        lambda M: M.TrafficConfig(mode="warp"),
        lambda M: M.PortConfig(n_queues=0),
        lambda M: M.ExperimentConfig(ports=()),
        lambda M: M.ExperimentConfig(stack=M.StackConfig(kind="pipeline"),
                                     ports=(M.PortConfig(), M.PortConfig())),
        lambda M: M.DcaConfig(writeback_timeout_ns=0),
        lambda M: M.ExperimentConfig(dca=M.DcaConfig(burst_size=4096)),
        lambda M: M.TopologyConfig(target="nope"),
    ]
    for make in cases:
        with pytest.raises(ValueError) as ref:
            make(RX)
        with pytest.raises(ValueError) as port:
            make(TX)
        assert str(port.value) == str(ref.value)


def test_epoch_jit_raises_naming_epoch_torch():
    with pytest.raises(ValueError, match="epoch-torch"):
        TX.TrafficConfig(engine="epoch-jit")
    d = RX.ExperimentConfig(traffic=RX.TrafficConfig(engine="epoch-jit")).to_dict()
    with pytest.raises(ValueError, match="epoch-torch"):
        TX.ExperimentConfig.from_dict(d)
    with pytest.raises(ValueError, match="epoch-torch"):
        TX.TopologyConfig.from_dict(RX.TopologyConfig().with_traffic(
            engine="epoch-jit").to_dict())


# -- run_experiment ----------------------------------------------------------

STACKS = ("bypass", "pipeline", "kernel")


@pytest.mark.parametrize("kind", STACKS)
def test_closed_loop_equal(kind):
    cfg = EXP._closed_loop(kind)
    want = jax_run(cfg)
    assert want[0]["received"] == 400
    assert port_run(cfg) == want
    assert TX.run_experiment(to_port(cfg), device="cpu").to_dict() == want[0]


def _open_loop(kind, n_queues=2):
    return RX.ExperimentConfig(
        name=f"open-{kind}",
        pool=RX.PoolConfig(n_slots=4096),
        ports=(RX.PortConfig(n_queues=n_queues, ring_size=256),),
        stack=RX.StackConfig(kind=kind, burst_size=32,
                             n_lcores=None if kind == "pipeline" else n_queues),
        traffic=RX.TrafficConfig(mode="open_loop", rate_gbps=6.0, packet_size=512,
                                 duration_s=0.0005, kind="poisson", seed=5))


@pytest.mark.parametrize("kind", STACKS)
def test_open_loop_equal_under_each_engine(kind):
    cfg = _open_loop(kind)
    want = jax_run(cfg.with_traffic(engine="event"))
    assert jax_run(cfg) == want  # the JAX package's epoch engine, its default
    assert want[0]["received"] > 0
    for engine in TCFG.TRAFFIC_ENGINES:
        assert port_run(cfg, engine) == want, engine


def test_open_loop_wall_clock_config_builds_unclocked():
    tb = TX.Testbed.build(to_port(_open_loop("bypass").with_traffic(sim_time=False)))
    assert tb.clock is None and tb.server.clock is None


def _msb(kind):
    return RX.ExperimentConfig(
        name=f"msb-{kind}",
        ports=(RX.PortConfig(n_queues=2, ring_size=512),),
        stack=RX.StackConfig(kind=kind, burst_size=32),
        traffic=RX.TrafficConfig(mode="msb", trial_s=0.0005, refine_iters=2,
                                 start_gbps=1.0))


@pytest.mark.parametrize("kind", STACKS)
def test_msb_equal(kind):
    cfg = _msb(kind)
    want = RX.run_experiment(cfg).to_dict()
    assert want["extras"]["msb_gbps"] > 0
    # the pipeline and kernel stacks fall back to the event loop under any engine
    for engine in ("epoch", "epoch-torch") if kind == "bypass" else ("epoch-torch",):
        got = TX.run_experiment(to_port(cfg).with_traffic(engine=engine), device="cpu")
        assert got.to_dict() == want, engine


# Fig. 3a's search (benchmarks/common.py's msb and experiment_config): Gbit/s
FIG3A = {("bypass", 1): 24.8, ("bypass", 4): 99.2, ("kernel", 1): 4.4, ("kernel", 4): 17.6}


def fig3a_config(stack, nports, trial_s=0.004, **kw):
    """benchmarks/common.py's experiment_config for a Fig. 3a search."""
    return RX.ExperimentConfig(
        name="bench",
        pool=RX.PoolConfig(n_slots=16384, slot_size=1518),
        ports=tuple(RX.PortConfig(n_queues=kw.get("n_queues", 1), ring_size=kw.get("ring", 1024),
                                  writeback_threshold=32) for _ in range(nports)),
        stack=RX.StackConfig(kind=stack, burst_size=kw.get("burst", 64),
                             n_lcores=kw.get("n_lcores"),
                             sockbuf_budget=kw.get("sockbuf_budget", 16),
                             cost=kw.get("cost")),
        traffic=RX.TrafficConfig(mode="msb", trial_s=trial_s, refine_iters=4,
                                 start_gbps=0.1))


@pytest.mark.parametrize("stack,nports", sorted(FIG3A))
def test_fig3a_msb_equal(stack, nports):
    cfg = fig3a_config(stack, nports)
    want = RX.run_experiment(cfg).to_dict()
    assert want["extras"]["msb_gbps"] == FIG3A[stack, nports]
    got = TX.run_experiment(to_port(cfg).with_traffic(engine="epoch-torch"), device="cpu")
    assert got.to_dict() == want


def test_fig3b_step_with_a_non_default_cost_equal():
    """Fig. 3b's "2x_burst" step (benchmarks/fig3b_sensitivity.py) on the
    kernel stack: 3 GHz, interrupts halved, 32 packets a read, rings and
    burst doubled."""
    cost = RX.CostConfig(cpu_ghz=3.0, interrupt_cycles=4000)
    cfg = fig3a_config("kernel", 1, trial_s=0.002, cost=cost, ring=2048, burst=128,
                       sockbuf_budget=32)
    want = RX.run_experiment(cfg).to_dict()
    port = to_port(cfg)
    assert port.stack.cost == TX.CostConfig(cpu_ghz=3.0, interrupt_cycles=4000)
    assert dataclasses.asdict(port.stack.cost.to_host_cost_model()) == dataclasses.asdict(
        cost.to_host_cost_model())
    assert TX.run_experiment(port, device="cpu").to_dict() == want


# -- devices -----------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no card is")
def test_epoch_torch_on_cuda_raises_without_a_card():
    for cfg in (_open_loop("bypass"), _msb("bypass")):
        port = to_port(cfg).with_traffic(engine="epoch-torch")
        with pytest.raises(RuntimeError, match="CUDA device"):
            TX.run_experiment(port)  # device="cuda" is the default
        with pytest.raises(RuntimeError, match="CUDA device"):
            TX.run_experiment(port, device="cuda")
    # a config's default engine is "epoch-torch"
    with pytest.raises(RuntimeError, match="CUDA device"):
        TX.run_experiment(TX.ExperimentConfig(
            traffic=TX.TrafficConfig(duration_s=0.0001)))


def test_numpy_engine_ignores_device():
    cfg = _open_loop("bypass")
    want = jax_run(cfg)
    assert port_run(cfg, "epoch", device="cuda") == want
