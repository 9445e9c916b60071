"""The port's serving layer (``repro_torch/serving/``) against the JAX
package's (``src/repro/serving/``).

Every ``TopologyConfig`` is built in the JAX package and carried over through
``to_dict`` -> the port's ``from_dict``; both packages' ``run_topology_experiment``
must give equal RunReports (sent, received, dropped, the latency dict and
every extra). The configs are those of ``tests/test_serving.py`` (steady
state, the three balancer policies, the saturation sweep, the KV incast and
its mice control, decode failover), ``benchmarks/fig_serving.py``'s five and
``examples/llm_serving.py``'s. Serving topologies under ``partitioned`` and
``partitioned-mp`` fall back to the shared clock with the JAX package's
reason and report. The pieces below the cluster are held equal too: request
draws and arrival times, frame bytes, the derived cost figures of every arch
the port registers, the balancer's least-loaded pick and the extras guard.
The two registries are equal, and a mix naming the encoder or the VLM
(``hubert-xlarge``, ``internvl2-26b``) gives the JAX package's report. The round-trip
contract of ``tests/test_config_roundtrip_meta.py`` holds for the port's
``RequestMixConfig`` and ``ServingConfig``, and ``chip_smoke.py``'s
``serving_sim`` pins equal the JAX package's reports.
"""
import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import repro.core as RC
import repro.exp as RX
import repro.models.registry as RREG
import repro.serving as RS
import repro_torch.core as TC
import repro_torch.exp as TX
import repro_torch.models.registry as TREG
import repro_torch.serving as TS
import repro_torch.serving.config as TSC
import test_serving as S
from benchmarks import fig_serving as FIG
from test_torch_exp import to_port

ROOT = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location("llm_serving",
                                                  ROOT / "examples" / "llm_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _example()


def _fig_configs():
    """benchmarks/fig_serving.py's five configurations, as its run() builds
    them at its trial of 0.002 s, by chip_smoke.py's labels."""
    out = {f"qps{qps:g}": FIG.topology(FIG.serving(qps=qps, prefill_ns_per_token=2_000),
                                       n_clients=1, duration_s=0.002)
           for qps in (2_000.0, 8_000.0, 24_000.0)}
    out["kv_incast"] = FIG.topology(FIG.serving(kv_bytes_per_token=4096, decode=("decode0",)),
                                    n_clients=2, duration_s=0.002, egress_capacity=16,
                                    link_gbps=10.0)
    out["failover"] = FIG.topology(FIG.serving(fail_node="decode1", fail_at_s=0.002 / 4),
                                   n_clients=2, duration_s=0.002)
    return out


FIG_CONFIGS = _fig_configs()

# name -> a JAX package TopologyConfig whose report the port must equal
CLUSTER_CASES = {
    # tests/test_serving.py
    "steady": S._topology(S._serving()),
    "round-robin": S._topology(S._serving(policy="round_robin")),
    "weighted-3-1": S._topology(S._serving(policy="weighted", prefill_weights=(3, 1))),
    "least-loaded": S._topology(S._serving(policy="least_loaded")),
    **{f"saturation-{q:g}": S._topology(S._serving(qps=q, prefill_ns_per_token=2_000),
                                        n_clients=1) for q in (2_000.0, 8_000.0, 24_000.0)},
    "kv-incast": S._topology(S._serving(kv_bytes_per_token=4096, decode=("decode0",)),
                             n_clients=2, egress_capacity=16, link_gbps=10.0),
    "kv-mice": S._topology(S._serving(kv_bytes_per_token=256, decode=("decode0",)),
                           n_clients=2, egress_capacity=4096, link_gbps=100.0),
    "failover": S._topology(S._serving(fail_node="decode1", fail_at_s=0.0004),
                            n_clients=2, duration_s=0.002),
    # examples/llm_serving.py
    "example-steady": EX.topology(EX.serving()),
    **{f"example-saturation-{q:g}": EX.topology(EX.serving(qps=q, prefill_ns_per_token=2_000),
                                                n_clients=1)
       for q in (2_000.0, 8_000.0, 24_000.0)},
    "example-failover": EX.topology(EX.serving(fail_node="decode1", fail_at_s=0.0005)),
    "example-weighted": EX.topology(EX.serving(policy="weighted", prefill_weights=(3, 1))),
    # benchmarks/fig_serving.py (the KV incast there is chip_smoke.py's pin test's)
    **{f"fig-{k}": v for k, v in FIG_CONFIGS.items() if k != "kv_incast"},
}


# what tests/test_serving.py asserts of these cases' JAX package reports, so
# that the reports the port equals show completions, switch drops, strands
EXERCISED = {
    "steady": lambda r: r.received == r.sent > 50,
    "kv-incast": lambda r: r.extras["sw_p3_egress_drops"] > 0 and r.received < r.sent,
    "failover": lambda r: r.extras["n4_decode_failed_drops"]
    + r.extras["n4_decode_stranded_requests"] > 0,
}


@pytest.mark.parametrize("name", sorted(CLUSTER_CASES))
def test_cluster_report_equal(name):
    cfg = CLUSTER_CASES[name]
    want = RX.run_topology_experiment(cfg)
    got = TX.run_topology_experiment(to_port(cfg))
    assert want.sent > 0 and want.extras["serving"] == 1.0
    assert EXERCISED.get(name, lambda r: True)(want)
    assert S._report_key(got) == S._report_key(want)
    assert got.to_dict() == want.to_dict()


def test_cluster_state_equal():
    """Beyond the report: the final clock, every node's per-queue stats and
    xstats, and each client's request counts."""
    from test_torch_topology import observe_cluster
    cfg = CLUSTER_CASES["failover"]
    ref = RX.Cluster.build(cfg)
    port = TX.Cluster.build(to_port(cfg))
    assert observe_cluster(port, port.run()) == observe_cluster(ref, ref.run())
    assert [c.serving.extras() for c in port.clients] == [
        c.serving.extras() for c in ref.clients]


@pytest.mark.parametrize("mode", ["partitioned", "partitioned-mp"])
@pytest.mark.parametrize("name", ["steady", "failover"])
def test_partition_modes_fall_back_to_the_shared_clock(name, mode):
    cfg = CLUSTER_CASES[name].with_partition(mode, workers=2)
    reason = RX.partition_fallback_reason(cfg)
    assert reason == "serving topology: balancer reads live cross-domain state"
    assert TX.partition_fallback_reason(to_port(cfg)) == reason
    shared = RX.run_topology_experiment(CLUSTER_CASES[name]).to_dict()
    outs = []
    for X, C, c in ((RX, RC, cfg), (TX, TC, to_port(cfg))):
        info = C.PartitionRunInfo()
        rep = X.run_topology_experiment(c, partition_info=info).to_dict()
        outs.append((rep, dataclasses.asdict(info)))
    assert outs[0][0] == shared
    assert outs[0][1]["mode_used"] == "shared-clock"
    assert outs[0][1]["fallback_reason"] == reason
    assert outs[1] == outs[0]


# -- configs -------------------------------------------------------------------

def test_configs_carry_over_exactly():
    s = S._serving(policy="weighted", prefill_weights=(3, 1), fail_node="decode1",
                   fail_at_s=0.001)
    port = TS.ServingConfig.from_dict(s.to_dict())
    assert port.to_dict() == s.to_dict()
    assert TS.ServingConfig.from_dict(port.to_dict()) == port
    topo = S._topology(s)
    ptopo = to_port(topo)
    assert isinstance(ptopo.serving, TS.ServingConfig)
    assert ptopo.to_dict() == topo.to_dict()
    assert TX.TopologyConfig.from_dict(json.loads(json.dumps(ptopo.to_dict()))) == ptopo


@pytest.mark.parametrize("kw, match", [
    ({"policy": "random"}, "policy"),
    ({"policy": "weighted", "prefill_weights": (1,)}, "prefill_weights"),
    ({"fail_node": "prefill0"}, "fail_node"),
    ({"token_frame_bytes": 95}, "MIN_SERVING_FRAME"),
    ({"prefill": ("a", "b"), "decode": ("b", "c")}, "overlap"),
    ({"qps": 0.0}, "qps"),
    ({"mix": {"model": "gpt-17"}}, "unknown model"),
])
def test_serving_config_validation_equal(kw, match):
    """tests/test_serving.py's refusals, raised by both packages with the
    same message (up to the registry each lists for an unknown model)."""
    msgs = []
    for mod in (RS, TS):
        d = {**S._serving().to_dict(), **kw}
        if "mix" in kw:
            d["mix"] = {**S._mix().to_dict(), **kw["mix"]}
        with pytest.raises(ValueError, match=match) as exc:
            mod.ServingConfig.from_dict(d)
        msgs.append(str(exc.value).split("; registry has")[0])
    assert msgs[0] == msgs[1]


def _nodes():
    return (S._node("lb", "balancer"), S._node("prefill0", "prefill"),
            S._node("prefill1", "prefill"), S._node("decode0", "decode"),
            S._node("decode1", "decode"))


TOPOLOGY_REFUSALS = {
    "not-a-node-name": (dict(nodes=_nodes()[:-1]), "not a node name"),
    "stack-kind": (dict(nodes=_nodes()[:1] + (S._node("prefill0", "bypass"),) + _nodes()[2:]),
                   "stack kind"),
    "writeback-threshold": (dict(nodes=_nodes()[:1] + (dataclasses.replace(
        _nodes()[1], port=RX.PortConfig(n_queues=2, ring_size=512, writeback_threshold=32)),)
        + _nodes()[2:]), "writeback_threshold"),
    "client-targets": (dict(nodes=_nodes(), n_clients=1, client_targets=("lb",)),
                       "client_targets"),
    "aqm": (dict(nodes=_nodes(), switch=RX.SwitchConfig(pipeline=RX.PipelineConfig(
        aqm=RX.AqmConfig(kind="ecn")))), "AQM"),
    "cc-mode": (dict(nodes=_nodes(), traffic=RX.TrafficConfig(
        mode="open_loop", sim_time=True, cc_mode="dctcp")), "cc_mode"),
}


@pytest.mark.parametrize("name", sorted(TOPOLOGY_REFUSALS))
def test_topology_serving_validation_equal(name):
    """tests/test_serving.py's topology refusals and the config's other
    serving checks, raised by the port's TopologyConfig as by the JAX
    package's (a dict the JAX package would have refused is built by hand)."""
    kw, match = TOPOLOGY_REFUSALS[name]
    kw = {"traffic": RX.TrafficConfig(mode="open_loop", sim_time=True), **kw}
    with pytest.raises(ValueError, match=match) as want:
        RX.TopologyConfig(serving=S._serving(), **kw)
    ok = RX.TopologyConfig(nodes=_nodes(), traffic=RX.TrafficConfig(mode="open_loop",
                                                                    sim_time=True),
                           serving=S._serving())
    d = ok.to_dict()
    bad = {k: (v.to_dict() if hasattr(v, "to_dict") else
               [n.to_dict() for n in v] if k == "nodes" else v) for k, v in kw.items()}
    d.update(bad)
    with pytest.raises(ValueError, match=match) as got:
        TX.TopologyConfig.from_dict(d)
    assert str(got.value) == str(want.value)


def test_serving_must_be_a_serving_config():
    with pytest.raises(ValueError, match="must be a ServingConfig"):
        TX.TopologyConfig(nodes=_nodes(), traffic=TX.TrafficConfig(mode="open_loop"),
                          serving=S._serving())  # the JAX package's class


@pytest.mark.parametrize("arch", sorted(TREG.ARCHS))
def test_derived_cost_figures_equal(arch):
    """Every arch the port registers derives the JAX package's figures."""
    figures = []
    for mod in (RS, TS):
        s = mod.ServingConfig(mix=mod.RequestMixConfig(model=arch))
        figures.append((s.resolved_prefill_ns_per_token(), s.resolved_decode_ns_per_token(),
                        s.resolved_decode_overhead_ns(), s.resolved_kv_bytes_per_token(),
                        [s.kv_segments(p) for p in (1, 64, 1000, 4096)],
                        [s.request_frames(p) for p in (1, 128, 129, 4096)]))
    assert figures[1] == figures[0]
    assert min(figures[0][:3]) >= 1  # kv bytes are 0 for the attention-free ssm


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-26b"])
def test_topology_naming_the_encoder_or_the_vlm_equal(arch):
    """A mix naming the encoder or the VLM gives the JAX package's report bit
    for bit. No cost figure is set by hand: each derives from the arch's
    config, so the report depends on the arch."""
    serving = S._serving(mix=S._mix(model=arch, prompt_mean_tokens=8, output_mean_tokens=2),
                         prefill_ns_per_token=None, decode_ns_per_token=None,
                         decode_overhead_ns=None)
    assert serving.resolved_prefill_ns_per_token() >= 1
    cfg = S._topology(serving)
    port = to_port(cfg)
    assert port.serving.mix.model == arch
    want = RX.run_topology_experiment(cfg)
    got = TX.run_topology_experiment(port)
    assert want.received > 0 and want.extras["serving"] == 1.0
    assert S._report_key(got) == S._report_key(want)
    assert got.to_dict() == want.to_dict()


def test_the_registries_are_equal():
    """The port registers the JAX package's ten archs, each under the same
    config module name, so no serving mix is refused by one and taken by
    the other."""
    assert TREG.ARCHS == RREG.ARCHS and len(TREG.ARCHS) == 10
    assert not hasattr(TSC, "UNPORTED_ARCHS")


# -- below the cluster ---------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("kind", ["poisson", "bursty", "uniform"])
def test_request_generator_equal(kind, seed):
    s = S._serving(qps=50_000.0, arrival_kind=kind,
                   mix=S._mix(prompt_dist="lognormal", output_dist="exponential"))
    want = RS.RequestGenerator(s, seed=seed).generate(2_000_000)
    got = TS.RequestGenerator(TS.ServingConfig.from_dict(s.to_dict()),
                              seed=seed).generate(2_000_000)
    assert len(want[0]) > 50
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_token_length_draws_equal():
    mix = S._mix(prompt_dist="lognormal", prompt_cv=1.0, prompt_mean_tokens=256,
                 max_prompt_tokens=512, output_dist="exponential", output_mean_tokens=8,
                 min_output_tokens=2, max_output_tokens=16)
    want = mix.sample(np.random.default_rng(0), 500)
    got = TS.RequestMixConfig.from_dict(mix.to_dict()).sample(np.random.default_rng(0), 500)
    for w, g in zip(want, got):
        assert np.array_equal(g, w)


def test_frame_protocol_equal():
    kw = dict(size=256, seq=9, src_ip=0x0A010000, dst_ip=0xC0A80001, stamp_ns=123,
              msg=TS.MSG_REQUEST, req_id=77, seg=2, seg_count=3, prompt_tokens=64,
              output_tokens=4, aux=0xC0A80004, last=True)
    bufs = []
    for mod in (RS, TS):
        buf = np.zeros(256, dtype=np.uint8)
        mod.build_frame(buf, **kw)
        mod.set_dst_ip(buf, 0xC0A80002)
        mod.set_aux(buf, 5)
        assert mod.is_serving_frame(buf)
        bufs.append((buf, dataclasses.asdict(mod.read_header(buf))))
    assert np.array_equal(bufs[1][0], bufs[0][0]) and bufs[1][1] == bufs[0][1]
    assert not TS.is_serving_frame(np.zeros(256, dtype=np.uint8))
    for name in ("MAGIC", "HEADER_END", "FLAG_LAST", "MSG_REQUEST", "MSG_FIRST_TOKEN",
                 "MSG_KV_SEG", "MSG_TOKEN", "SERVING_DST_PORT", "MIN_SERVING_FRAME",
                 "BALANCER_POLICIES", "TOKEN_DISTS"):
        assert getattr(TS, name) == getattr(RS, name), name
    assert TS.__all__ == RS.__all__


def test_least_loaded_prefers_the_idle_replica():
    srv = TS.BalancerServer.__new__(TS.BalancerServer)
    srv.serving = TS.ServingConfig.from_dict(S._serving(policy="least_loaded").to_dict())

    class _Fake:
        def __init__(self, q):
            self.queued_tokens = q

    srv.prefill_servers = [_Fake(500), _Fake(20)]
    assert srv._pick_prefill() == 1


def test_extras_collision_guard():
    from repro_torch.exp.topology import _merge_extras
    extras = {"sw_p0_egress_drops": 3.0}
    _merge_extras(extras, {"sw_p1_egress_drops": 0.0}, "switch telemetry")
    with pytest.raises(ValueError, match="collision.*sw_p0_egress_drops"):
        _merge_extras(extras, {"sw_p0_egress_drops": 9.0}, "rogue component")
    assert extras["sw_p0_egress_drops"] == 3.0


def test_importing_the_port_registers_its_stack_kinds():
    from repro.exp.testbed import stack_kinds as ref_kinds
    from repro_torch.exp.testbed import stack_kinds
    assert {"balancer", "prefill", "decode"} <= set(stack_kinds())
    assert stack_kinds() == ref_kinds()


# -- the round-trip contract of tests/test_config_roundtrip_meta.py ------------

SAMPLES = {
    "RequestMixConfig": RS.RequestMixConfig(prompt_mean_tokens=64, prompt_dist="fixed",
                                            output_mean_tokens=4, model="mixtral-8x7b"),
    "ServingConfig": RS.ServingConfig(
        mix=RS.RequestMixConfig(output_mean_tokens=4), balancer="lb0", prefill=("p0",),
        decode=("d0", "d1"), policy="least_loaded", qps=100.0, prefill_ns_per_token=10,
        decode_overhead_ns=1000, prefill_weights=(2,), fail_node="d1", fail_at_s=0.5),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_config_round_trip_contract(name):
    cls = getattr(TSC, name)
    assert cls.__dataclass_params__.frozen
    inst = cls.from_dict(SAMPLES[name].to_dict())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(inst, dataclasses.fields(cls)[0].name, None)
    d = inst.to_dict()
    assert set(d) == {f.name for f in dataclasses.fields(cls)}
    assert d == SAMPLES[name].to_dict()
    again = cls.from_dict(d)
    assert again == inst
    for f in dataclasses.fields(cls):
        assert getattr(again, f.name) == getattr(inst, f.name), f.name
    assert cls.from_dict(json.loads(json.dumps(d))) == inst
    assert cls.from_dict(cls().to_dict()) == cls()
    assert cls().to_dict() == getattr(RS, name)().to_dict()


def test_every_serving_config_class_has_a_sample():
    names = sorted(n for n, obj in vars(TSC).items()
                   if isinstance(obj, type) and obj.__module__ == TSC.__name__
                   and dataclasses.is_dataclass(obj) and n.endswith("Config"))
    assert names == sorted(SAMPLES)


# -- chip_smoke.py's serving_sim phase -----------------------------------------

@pytest.mark.parametrize("label", sorted(chip_smoke.SERVING_DIGESTS))
def test_chip_smoke_serving_pins_are_the_jax_package_s_reports(label):
    """Each pinned digest is the sha256 of the JAX package's report on
    benchmarks/fig_serving.py's config, and chip_smoke.py builds that config
    on the port's classes (engine aside: the port's default names its own,
    and serving never runs the pass)."""
    want = FIG_CONFIGS[label]
    port_cfg = chip_smoke.serving_configs()[label]
    assert port_cfg == to_port(want).with_traffic(engine=port_cfg.traffic.engine)
    rep = RX.run_topology_experiment(want)
    digest = hashlib.sha256(json.dumps(rep.to_dict(), sort_keys=True).encode()).hexdigest()
    assert chip_smoke.SERVING_DIGESTS[label] == digest
    assert chip_smoke.report_digest(TX.run_topology_experiment(port_cfg)) == digest


def test_chip_smoke_pins_every_fig_serving_config():
    assert set(chip_smoke.SERVING_DIGESTS) == set(FIG_CONFIGS) == set(
        chip_smoke.serving_configs())
