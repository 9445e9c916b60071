"""The port's simulator against the JAX package's, beyond the fast path:
the fallback configs of ``tests/test_fastpath.py``, the fallback taxonomy,
the bandwidth search, closed-loop runs on both server kinds, the packet and
RSS helpers, and the port's device rules (an error of the pass or of its
device propagates; the reference falls back to the event loop instead).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.fastpath as RF
from repro_torch.core import cost as TC
from repro_torch.core import fastpath as TF
from repro_torch.core import loadgen as TL
from repro_torch.core import packet as TK
from repro_torch.core import pmd as TP
from repro_torch.core import rings as TR
from repro_torch.core import rss as TRSS
from repro_torch.core import simclock as TS
from test_fastpath import FALLBACK_CASES, FASTPATH_CASES, build, queue_stats_key, report_key
from test_torch_netsim import check_port_engines, port_build, port_pattern


@pytest.mark.parametrize("name,pattern,dur,kw", FALLBACK_CASES,
                         ids=[c[0] for c in FALLBACK_CASES])
def test_port_engines_match_jax_package_on_fallback(name, pattern, dur, kw):
    info = check_port_engines(pattern, dur, kw)
    assert not info.fastpath and info.fallback_reason


def test_fallback_taxonomy_is_the_jax_package_s():
    assert TF.EPOCH_FALLBACK_REASONS == RF.EPOCH_FALLBACK_REASONS
    assert TF.PARTITIONED_REASON == RF.PARTITIONED_REASON
    assert [p.pattern for p in TF._EPOCH_REASON_PATTERNS] == [
        p.pattern for p in RF._EPOCH_REASON_PATTERNS]
    for reason in (None, "no ports", "server type Foo is not BypassL2FwdServer",
                   "planning failed: ValueError('x')\nmore"):
        TF.validate_epoch_fallback_reason(reason)
        RF.validate_epoch_fallback_reason(reason)
    for bad in ("no port", "server type is not BypassL2FwdServer", "planning failed"):
        for mod in (TF, RF):
            with pytest.raises(ValueError):
                mod.validate_epoch_fallback_reason(bad)
    with pytest.raises(ValueError):
        TF.EpochRunInfo(fallback_reason="typo")
    times = np.array([0, 3, 9, 10, 10, 25, 40], dtype=np.int64)
    for epoch_ns in (0, 1, 7, 10, 100):
        assert list(TF.iter_epoch_slices(times, epoch_ns)) == list(
            RF.iter_epoch_slices(times, epoch_ns))


def _msb_setup(port_classes):
    """A small bypass server whose one lcore saturates near 20 Gbit/s, on the
    JAX package's classes or the port's."""
    if port_classes:
        Pool, Port, Server, Clock, Cost = (TK.PacketPool, TP.Port, TP.BypassL2FwdServer,
                                           TS.SimClock, TC.HostCostModel)
    else:
        Pool, Port, Server, Clock, Cost = (R.PacketPool, R.Port, R.BypassL2FwdServer,
                                           R.SimClock, R.HostCostModel)

    def make():
        pool = Pool(2048, 1518)
        port = Port.make(pool, ring_size=128, writeback_threshold=16, n_queues=2,
                         link_gbps=100.0, link_latency_ns=500)
        server = Server([port], burst_size=32, n_lcores=1)
        server.attach_clock(Clock(), Cost())
        return server, [port]
    return make


@pytest.mark.parametrize("engine", ["event", "epoch", "epoch-torch"])
def test_bandwidth_search_matches_jax_package(engine):
    kw = dict(start_gbps=4.0, max_gbps=64.0, trial_s=0.0002, refine_iters=3)
    want, want_reps = R.find_max_sustainable_bandwidth(_msb_setup(False), engine="event",
                                                       **kw)
    got, reps = TL.find_max_sustainable_bandwidth(_msb_setup(True), engine=engine,
                                                  device="cpu", **kw)
    assert 0 < got == want < 64.0
    assert [r.to_dict() for r in reps] == [r.to_dict() for r in want_reps]


def test_closed_loop_matches_jax_package():
    """run_closed_loop on the bypass server (4 queues) and the pipeline
    server, with integrity checking on."""
    outs = []
    for pkg in ("ref", "port"):
        Pool, Port = (R.PacketPool, R.Port) if pkg == "ref" else (TK.PacketPool, TP.Port)
        Bypass = R.BypassL2FwdServer if pkg == "ref" else TP.BypassL2FwdServer
        Pipe = R.PipelineServer if pkg == "ref" else TP.PipelineServer
        Gen, Clock = (R.LoadGen, R.SimClock) if pkg == "ref" else (TL.LoadGen, TS.SimClock)
        obs = []
        for kind in ("bypass", "pipeline"):
            pool = Pool(1024, 1518)
            port = Port.make(pool, ring_size=256, writeback_threshold=8, n_queues=4)
            server = (Bypass([port], burst_size=16, n_lcores=2) if kind == "bypass"
                      else Pipe(port, burst_size=16))
            clock = Clock()
            server.attach_clock(clock)
            lg = Gen([port], verify_integrity=True)
            rep = lg.run_closed_loop(server, 600, packet_size=512, window=24,
                                     rng=np.random.default_rng(4), clock=clock)
            assert rep.received == 600 and rep.dropped == 0
            obs.append((report_key(rep), queue_stats_key(server), clock.now_ns,
                        lg.flight.integrity_errors, pool.n_free))
        outs.append(obs)
    assert outs[0] == outs[1]


def test_vec_packet_helpers_byte_equal():
    rng = np.random.default_rng(7)
    pools = [R.PacketPool(64, 1518), TK.PacketPool(64, 1518)]
    slots = rng.permutation(64)[:40]
    seqs = rng.integers(0, 1 << 40, 40)
    fids = rng.integers(0, 5000, 40)
    for pool, mod in zip(pools, (R, TK)):
        pool.arena[:] = np.random.default_rng(8).integers(0, 256, pool.arena.shape,
                                                            dtype=np.uint8)
        mod.write_packets_vec(pool, slots, seqs, 1000, mod.DEFAULT_TS_OFFSET, 123456789)
        mod.write_flow_ids_vec(pool, slots[:20], fids[:20])
        mod.write_flow_ids_vec(pool, slots[20:], fids[20:], src_ip_base=0x0B000000,
                               dst_ip=0x0C000001)
        mod.set_ce_vec(pool, slots[::3])
        mod.swap_macs_vec(pool, slots[:10])
        mod.swap_flow_ips_vec(pool, slots[10:20])
        mod.l2fwd_echo_vec(pool, slots[20:])
    assert np.array_equal(pools[0].arena, pools[1].arena)
    assert np.array_equal(pools[0].lengths, pools[1].lengths)
    a, b = pools
    assert np.array_equal(R.read_stamps_vec(a, slots, R.DEFAULT_TS_OFFSET),
                          TK.read_stamps_vec(b, slots, TK.DEFAULT_TS_OFFSET))
    assert np.array_equal(R.read_seqs_vec(a, slots), TK.read_seqs_vec(b, slots))
    assert np.array_equal(R.read_ce_vec(a, slots), TK.read_ce_vec(b, slots))
    assert np.array_equal(R.read_flow_bytes_vec(a, slots), TK.read_flow_bytes_vec(b, slots))
    for s in slots[:5]:
        va, vb = a.view(int(s)), b.view(int(s))
        assert R.read_flow(va) == TK.read_flow(vb) and R.checksum(va) == TK.checksum(vb)
        assert R.payload_checksum(va) == TK.payload_checksum(vb)


def test_rss_matches_jax_package():
    rng = np.random.default_rng(3)
    flows = rng.integers(0, 256, (500, 12), dtype=np.uint8)
    assert np.array_equal(R.toeplitz_hash_vec(flows), TRSS.toeplitz_hash_vec(flows))
    for n_queues in (1, 3, 8):
        a, b = R.RssIndirection(n_queues), TRSS.RssIndirection(n_queues)
        assert np.array_equal(a.steer(flows), b.steer(flows))
        assert [a.steer_one(f) for f in flows[:20]] == [b.steer_one(f) for f in flows[:20]]


def test_spsc_ring_whole_api():
    ring = TR.SpscRing(4)
    assert ring.capacity == 4 and ring.free_space == 4 and len(ring) == 0
    assert ring.push_burst([1, 2, 3, 4, 5]) == 4 and ring.enq_drops == 1 and ring.is_full()
    assert not ring.try_push(6) and ring.enq_drops == 2
    assert ring.pop_burst(3) == [1, 2, 3] and ring.try_pop() == 4 and ring.try_pop() is None
    assert ring.is_empty()


def test_cuda_pass_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal where no CUDA device is present")
    for name, pattern, dur, kw in (FASTPATH_CASES[0], FALLBACK_CASES[0]):
        server, ports, clock = port_build(**kw)
        with pytest.raises(RuntimeError, match="CUDA device"):
            TF.run_epoch_sim(TL.LoadGen(ports), server, port_pattern(pattern),
                             duration_s=dur, clock=clock)
        assert clock.now_ns == 0  # nothing ran


class PassBroke(RuntimeError):
    pass


def _broken_pass(*args):
    raise PassBroke("the pass failed on its device")


def test_an_error_of_the_pass_propagates(monkeypatch):
    """The port's engine never hides a failing pass behind the event loop."""
    monkeypatch.setattr(TF, "make_pass", lambda device: _broken_pass)
    name, pattern, dur, kw = FASTPATH_CASES[0]
    server, ports, clock = port_build(**kw)
    with pytest.raises(PassBroke):
        TF.run_epoch_sim(TL.LoadGen(ports), server, port_pattern(pattern), duration_s=dur,
                         clock=clock, device="cpu")
    assert clock.now_ns == 0


def test_the_reference_falls_back_on_the_same_error(monkeypatch):
    """The difference the port makes: the JAX package's engine catches the
    same error and runs the event loop, with the reason recorded."""
    monkeypatch.setattr(RF, "get_epoch_pass_jax", lambda: _broken_pass)
    name, pattern, dur, kw = FASTPATH_CASES[0]
    server, ports, clock = build(**kw)
    info = R.EpochRunInfo()
    rep = R.run_epoch_sim(R.LoadGen(ports), server, pattern, duration_s=dur, clock=clock,
                          use_jax=True, info=info)
    assert not info.fastpath and info.fallback_reason.startswith("planning failed: PassBroke")
    assert rep.received > 0


def test_planner_errors_still_fall_back(monkeypatch):
    """An error of the planner's own numpy work keeps the reference's
    "planning failed" fallback, and the report stays the event loop's."""
    def broken_table(*args):
        raise ValueError("no table")

    name, pattern, dur, kw = FASTPATH_CASES[0]
    server, ports, clock = port_build(**kw)
    want = TL.LoadGen(ports).run_sim(server, port_pattern(pattern), duration_s=dur,
                                     clock=clock)
    monkeypatch.setattr(TF, "_flow_queue_table", broken_table)
    for device in (None, "cpu"):
        server, ports, clock = port_build(**kw)
        info = TF.EpochRunInfo()
        rep = TF.run_epoch_sim(TL.LoadGen(ports), server, port_pattern(pattern),
                               duration_s=dur, clock=clock, device=device, info=info)
        assert not info.fastpath
        assert info.fallback_reason == "planning failed: ValueError('no table')"
        assert report_key(rep) == report_key(want)
