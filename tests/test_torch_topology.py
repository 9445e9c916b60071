"""The port's multi-host layer against the JAX package's: the switch
pipeline (``core/switch.py``), the topology builder and driver
(``exp/topology.py``) and the partitioned engines (``core/partition.py``).

Each ``TopologyConfig`` is built once in the JAX package and carried over
through ``to_dict`` -> the port's ``from_dict``. Under the shared clock the
port's cluster must leave the JAX package's RunReport, final clock, every
node's per-queue stats and xstats; under ``partitioned`` and
``partitioned-mp`` its RunReport and ``PartitionRunInfo``. The configs are
those of ``tests/test_switch.py``, ``tests/test_aqm_pipeline.py`` (drop-tail,
RED, ECN with DCTCP, the trunk fabric), ``tests/test_dca_sim.py`` and
``tests/test_partition.py``; the fallback reasons those of
``tests/test_partition.py`` and ``tests/test_fallback_taxonomy.py``. A
serving topology builds and runs as the JAX package's does (the serving
layer's own cases are in ``tests/test_torch_serving.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as RC
import repro.exp as RX
import repro_torch.core as TC
import repro_torch.exp as TX
import test_aqm_pipeline as AQM
import test_dca_sim as DCA
import test_fallback_taxonomy as TAX
import test_partition as PART
import test_switch as SW
from repro.exp.topology import Cluster as RCluster
from repro_torch.exp.topology import Cluster as TCluster
from test_fastpath import queue_stats_key
from test_torch_exp import to_port

ROOT = Path(__file__).resolve().parents[1]


def observe_cluster(cluster, rep):
    return (rep.to_dict(), cluster.clock.now_ns,
            [queue_stats_key(n.server) for n in cluster.nodes],
            [n.dev.xstats() for n in cluster.nodes])


def shared_clock_runs(cfg):
    ref = RCluster.build(cfg)
    port = TCluster.build(to_port(cfg))
    return observe_cluster(ref, ref.run()), observe_cluster(port, port.run())


ECN = RX.PipelineConfig(aqm=RX.AqmConfig(kind="ecn", min_thresh=4, max_thresh=12,
                                         max_p=0.1, seed=1))
RED = RX.PipelineConfig(aqm=RX.AqmConfig(kind="red", min_thresh=4, max_thresh=12,
                                         max_p=0.1, seed=1))
TRUNK_AQM = RX.PipelineConfig(per_port_aqm=(None,) * 6 + (
    RX.AqmConfig(kind="ecn", min_thresh=2, max_thresh=8, max_p=0.2, seed=3),))
SLOW_TRUNK = RX.LinkConfig(gbps=2.0, latency_ns=2000)

# name -> (config, an extras key the JAX package's run must show above 0, so
# that the feature was exercised)
SHARED_CASES = {
    "switch-incast-2": (SW._incast(2), "sw_p0_egress_forwarded"),
    "switch-incast-6-drops": (SW._incast(6), "sw_p0_egress_drops"),
    "switch-integrity": (SW._incast(2, rate_gbps=1.0, verify=True), "sw_p0_egress_forwarded"),
    "switch-full-topology": (SW._full_topology(), "sw_p0_egress_forwarded"),
    "switch-kernel-node": (RX.TopologyConfig(
        nodes=(RX.NodeConfig(name="kserver", port=RX.PortConfig(writeback_threshold=1),
                             stack=RX.StackConfig(kind="kernel")),),
        n_clients=2, switch=RX.SwitchConfig(link=RX.LinkConfig(gbps=10.0, latency_ns=500)),
        traffic=RX.TrafficConfig(rate_gbps=0.25, packet_size=512, duration_s=0.0003,
                                 seed=5)), "n0_rx_packets"),
    "aqm-drop-tail": (AQM._incast(pipeline=RX.PipelineConfig(
        aqm=RX.AqmConfig(kind="drop-tail"))), "sw_p0_egress_drops"),
    "aqm-ecn-dctcp": (AQM._incast(pipeline=ECN, cc="dctcp"), "sw_p0_ecn_marked"),
    "aqm-red-dctcp": (AQM._incast(pipeline=RED, cc="dctcp"), "sw_p0_aqm_early_drops"),
    "aqm-per-port-ecn": (AQM._incast(pipeline=RX.PipelineConfig(
        per_port_aqm=(ECN.aqm,) + (None,) * 4), cc="dctcp"), "sw_p0_ecn_marked"),
    "trunk": (AQM._incast(trunk=RX.LinkConfig(gbps=40.0, latency_ns=2000)),
              "sw1_p4_egress_forwarded"),
    "trunk-oversubscribed-ecn": (AQM._incast(trunk=SLOW_TRUNK, pipeline=TRUNK_AQM),
                                 "sw1_p4_ecn_marked"),
    "trunk-placement": (AQM._incast(trunk=SLOW_TRUNK, node_switch=(1,),
                                    client_switch=(0, 1, 0, 1)), "sw0_p2_egress_drops"),
    "dca-burst-32": (DCA._topo_cfg(32), "n0_p0q0_writebacks"),
    "dca-burst-1024": (DCA._topo_cfg(1024), "n0_p0q0_timeout_flushes"),
    **{f"partition-corpus-{k}": (v, "sw_p0_egress_forwarded")
       for k, v in PART.PARITY_CASES.items()},
}


@pytest.mark.parametrize("name", sorted(SHARED_CASES))
def test_shared_clock_equal(name):
    cfg, exercised = SHARED_CASES[name]
    want, got = shared_clock_runs(cfg)
    assert want[0]["extras"][exercised] > 0, exercised
    assert want[0]["received"] > 0
    assert got == want
    assert TX.run_topology_experiment(to_port(cfg)).to_dict() == want[0]


def _partition_run(X, cfg, mode):
    info = (RC if X is RX else TC).PartitionRunInfo()
    rep = X.run_topology_experiment(cfg.with_partition(mode, workers=2), partition_info=info)
    return rep.to_dict(), dataclasses.asdict(info)


@pytest.mark.parametrize("case", sorted(PART.PARITY_CASES))
def test_partitioned_equal(case):
    cfg = PART.PARITY_CASES[case]
    want = _partition_run(RX, cfg, "partitioned")
    assert want[1]["mode_used"] == "partitioned" and want[1]["n_windows"] > 0
    assert _partition_run(TX, to_port(cfg), "partitioned") == want


@pytest.mark.parametrize("case", ["multi-node-targets", "incast-drops"])
def test_partitioned_mp_equal(case):
    cfg = PART.PARITY_CASES[case]
    want = _partition_run(RX, cfg, "partitioned-mp")
    assert want[1]["mode_used"] == "partitioned-mp" and want[1]["n_workers"] == 2
    assert _partition_run(TX, to_port(cfg), "partitioned-mp") == want


def test_domain_grouping_equal():
    cfg = PART._topology(nodes=[PART._node(f"n{i}") for i in range(4)], n_clients=4,
                         client_targets=("n0", "n1", "n2", "n3"))
    n_domains = cfg.n_clients + len(cfg.nodes) + 1
    want = RX.run_topology_experiment(cfg).to_dict()
    port = to_port(cfg).with_partition("partitioned")
    for groups in (1, 2, n_domains):
        assert TX.run_partitioned_topology(port, n_groups=groups).to_dict() == want


# the port's mp workers are forked with an import hook that refuses the JAX
# package and JAX: a worker that imported either would fail the run
MP_SCRIPT = """
import importlib.abc, json, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("repro", "jax", "jaxlib"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
from repro_torch.core import PartitionRunInfo
from repro_torch.exp import TopologyConfig, run_topology_experiment
info = PartitionRunInfo()
rep = run_topology_experiment(TopologyConfig.from_dict(json.loads(sys.argv[1])),
                              partition_info=info)
print(json.dumps({"report": rep.to_dict(), "mode_used": info.mode_used,
                  "n_workers": info.n_workers}))
"""


def test_mp_workers_import_only_the_port():
    cfg = PART.PARITY_CASES["bypass-2c"].with_partition("partitioned-mp", workers=2)
    want = RX.run_topology_experiment(cfg).to_dict()
    out = subprocess.run([sys.executable, "-c", MP_SCRIPT, json.dumps(cfg.to_dict())],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert (got["mode_used"], got["n_workers"]) == ("partitioned-mp", 2)
    assert got["report"] == json.loads(json.dumps(want))


# -- fallback reasons ---------------------------------------------------------

FREE = RX.CostConfig(cpu_ghz=2.0, interrupt_cycles=0, syscall_cycles=0,
                     per_packet_kernel_cycles=0, pmd_poll_cycles=0, pmd_per_packet_cycles=0)
PARTITION_FALLBACKS = {
    **{name: cfg for name, cfg, _ in TAX._pr10_cases()},
    "zero-latency": PART._topology(latency_ns=0),
    "zero-cost-bypass": PART._topology(nodes=[PART._node(kind="bypass", cost=FREE)]),
    "zero-cost-kernel": PART._topology(nodes=[PART._node(kind="kernel", cost=FREE)]),
    "pipeline-stack": PART._topology(nodes=[PART._node(kind="pipeline")]),
}


@pytest.mark.parametrize("name", sorted(PARTITION_FALLBACKS))
def test_partition_fallback_equal(name):
    cfg = PARTITION_FALLBACKS[name]
    reason = RX.partition_fallback_reason(cfg)
    assert reason is not None
    assert TX.partition_fallback_reason(to_port(cfg)) == reason
    want = _partition_run(RX, cfg, "partitioned")
    assert want[1]["fallback_reason"] == reason and want[1]["mode_used"] == "shared-clock"
    assert _partition_run(TX, to_port(cfg), "partitioned") == want


def test_partition_taxonomy_is_the_jax_package_s():
    assert TC.PARTITION_FALLBACK_REASONS == RC.PARTITION_FALLBACK_REASONS
    for cfg in PART.PARITY_CASES.values():
        assert TX.partition_fallback_reason(to_port(cfg)) is None


@pytest.mark.parametrize("engine", ["epoch", "epoch-torch"])
def test_epoch_info_under_partitioned_equal(engine):
    """test_fallback_taxonomy.py's partitioned topology: the epoch engine
    refuses with the partitioned reason, in the port under its own engine
    name (the JAX package's "epoch-jit" is the port's "epoch-torch")."""
    ref_engine = "epoch-jit" if engine == "epoch-torch" else engine
    cfg = RX.TopologyConfig(
        name="taxonomy-partitioned",
        nodes=(RX.NodeConfig(name="srv", stack=RX.StackConfig(kind="bypass", burst_size=32)),),
        n_clients=2, switch=RX.SwitchConfig(link=RX.LinkConfig(gbps=40.0, latency_ns=1000)),
        traffic=RX.TrafficConfig(rate_gbps=2.0, duration_s=0.0002, packet_size=512, seed=7,
                                 engine=ref_engine)).with_partition("partitioned")
    infos = []
    for X, C, c in ((RX, RC, cfg), (TX, TC, to_port(cfg.with_traffic(engine="epoch"))
                                    .with_traffic(engine=engine))):
        info = C.EpochRunInfo()
        rep = X.run_topology_experiment(c, info=info).to_dict()
        infos.append((rep, info.engine, info.fastpath, info.fallback_reason))
    assert infos[0][3] == RC.PARTITIONED_REASON and infos[0][1] == ref_engine
    assert infos[1] == (infos[0][0], engine) + infos[0][2:]


def _testbed(ring=1024, burst=32, stack=(), traffic=(), dca=None):
    """A small bypass testbed config with the given changes."""
    return RX.ExperimentConfig(
        name="taxonomy", pool=RX.PoolConfig(n_slots=8192, slot_size=2048),
        ports=(RX.PortConfig(n_queues=2, ring_size=ring),),
        stack=RX.StackConfig(kind="bypass", burst_size=burst, n_lcores=1),
        traffic=RX.TrafficConfig(rate_gbps=5.0, packet_size=1518, duration_s=0.0005),
        dca=dca).with_stack(**dict(stack)).with_traffic(**dict(traffic))


# test_fallback_taxonomy.py's config-reachable epoch reasons, as experiment configs
EPOCH_CASES = {
    "clean": _testbed(),
    "pipeline": _testbed(stack={"kind": "pipeline", "n_lcores": None}),
    "kernel": _testbed(stack={"kind": "kernel"}),
    "integrity": _testbed(traffic={"verify_integrity": True}),
    "zero-cost": _testbed(stack={"cost": RX.CostConfig(pmd_poll_cycles=0,
                                                       pmd_per_packet_cycles=0)}),
    "burst-gt-max-tx": _testbed(burst=64, traffic={"max_tx_burst": 16}),
    "burst-gt-tx-ring": _testbed(burst=64, ring=32),
    "dca": _testbed(dca=RX.DcaConfig(burst_size=32, writeback_timeout_ns=100_000)),
    "dca-dma": _testbed(dca=RX.DcaConfig(burst_size=32, writeback_dma_ns=500)),
}


@pytest.mark.parametrize("name", sorted(EPOCH_CASES))
def test_epoch_fallback_reason_equal(name):
    cfg = EPOCH_CASES[name]
    outs = []
    for X, C, c, kw in ((RX, RC, cfg, {}), (TX, TC, to_port(cfg), {"device": "cpu"})):
        tb = X.Testbed.build(c)
        t = c.traffic
        info = C.EpochRunInfo()
        rep = C.run_epoch_sim(tb.loadgen, tb.server,
                              C.TrafficPattern(rate_gbps=t.rate_gbps, packet_size=t.packet_size),
                              duration_s=t.duration_s, clock=tb.clock, sched=tb.sched,
                              info=info, **kw)
        outs.append((rep.to_dict(), queue_stats_key(tb.server), tb.clock.now_ns,
                     info.fastpath, info.fallback_reason, info.n_packets))
    assert (outs[0][3] and outs[0][4] is None) == (name == "clean"), outs[0][4]
    assert outs[1] == outs[0]


# -- serving -------------------------------------------------------------------

def _serving_topology():
    from repro.serving import RequestMixConfig, ServingConfig
    s = ServingConfig(mix=RequestMixConfig(prompt_mean_tokens=64, prompt_dist="fixed",
                                           output_mean_tokens=4, output_dist="fixed"),
                      qps=10_000.0, kv_bytes_per_token=256, kv_segment_bytes=1024,
                      balancer="lb", prefill=("p0",), decode=("d0",))
    return RX.TopologyConfig(
        name="serving-part",
        nodes=(PART._node("lb", "balancer"), PART._node("p0", "prefill"),
               PART._node("d0", "decode")),
        n_clients=1, traffic=RX.TrafficConfig(duration_s=0.0005, seed=3), serving=s)


def test_serving_topology_equal():
    """The topology that once raised builds and runs in the port: its
    RunReport, clock, per-queue stats and xstats equal the JAX package's, and
    a dict or a config that names no ServingConfig is refused as there."""
    cfg = _serving_topology()
    want, got = shared_clock_runs(cfg)
    assert want[0]["received"] > 0 and want[0]["extras"]["serving"] == 1.0
    assert got == want
    assert TX.run_topology_experiment(to_port(cfg)).to_dict() == want[0]
    with pytest.raises(ValueError, match="must be a ServingConfig"):
        TX.TopologyConfig(serving={"qps": 1.0})


def test_switch_aqm_stream_equal():
    """The AQM stage's counter-seeded splitmix64 stream and the RED curve."""
    for seed, port in ((0, 0), (7, 3), (2**40 + 5, 11), (-1, 2**63)):
        assert [TC.aqm_uniform_u64(seed, port, k) for k in range(512)] == [
            RC.aqm_uniform_u64(seed, port, k) for k in range(512)]
    for occ in range(0, 40):
        assert TC.red_probability(occ, 8, 24, 0.1) == RC.red_probability(occ, 8, 24, 0.1)
