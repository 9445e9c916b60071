"""The window's arithmetic: rates over the window, the tail over all
requests, busy time and idle share from synthetic intervals, and the
readers over synthetic runs."""
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import manifest, rooflines, stats, work
from portbench.harness.record import Run
from portbench.harness.trace import OpCalls, Trace
from portbench.tests.candidates import with_candidates

ROOT = Path(__file__).resolve().parents[2]
M = manifest.Manifest(with_candidates(manifest.Manifest.load(ROOT).data), ROOT)
TRAIN, SERVE = "mamba2-1.3b.train-bypass-4x2048", "mamba2-1.3b.serve-azure-code"


def reader(name):
    return manifest.load_by_path("metrics", name).read


def test_percentile_is_numpys_over_all_values():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == float(np.percentile(v, 95)) == 95.05
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_busy_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.busy_union(spans) == 3 + 1 + 1
    assert stats.idle_gaps(spans, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.idle_gaps(spans, -1, 9) == [(-1, 0), (3, 5), (6, 8)]
    assert stats.idle_share(5.0, 10.0) == 0.5
    assert stats.busy_union([]) == 0.0


def test_serve_readers_take_every_request():
    cell = M.cell(SERVE)
    # 160 requests: the tails are over every request
    ttft = [0.1 + 0.001 * i for i in range(160)]
    tpot = [0.05 + 0.0001 * i for i in range(150)]
    run = Run(cell=cell, seed=0, window_s=16.0, requests=160, ttft_s=ttft, tpot_s=tpot,
              batch=1, prefill_s=[0.5, 1.0], prefill_lens=[1024, 2048],
              decode_s=[0.06, 0.07, 0.2])
    assert reader("ttft_p95_ms")(run) == pytest.approx(np.percentile(ttft, 95) * 1e3)
    assert reader("tpot_p95_ms")(run) == pytest.approx(np.percentile(tpot, 95) * 1e3)
    assert reader("decode_step_ms.serve")(run) == pytest.approx(70.0)
    flops = work.prefill_flops(cell.model, 1, 1024) + work.prefill_flops(cell.model, 1, 2048)
    assert reader("prefill_mfu.serve")(run) == pytest.approx(100 * flops / 1.5 / 989e12)
    assert reader("train_tokens_per_s")(run) is None


def _trace(ops=None, busy=0.9, window=1.0, units=2, by_kernel=None):
    return Trace(window_s=window, busy_s=busy, host_s=window, units=units,
                 by_kernel=by_kernel or {}, ops=ops or {}, breakdown={})


def test_train_readers():
    cell = M.cell(TRAIN)
    run = Run(cell=cell, seed=0, window_s=12.0, steps=10, tokens=10 * 8192,
              issue_s=[1.0, 1.2], feed_s=[0.001, 0.003], peak_bytes=3 * 2 ** 30,
              trace=_trace(by_kernel={"void at::native::vectorized_elementwise_kernel": 300e3,
                                      "sm90_xmma_gemm": 500e3, "FillFunctor": 100e3}))
    assert reader("train_tokens_per_s")(run) == 10 * 8192 / 12.0
    assert reader("issue_ms.train")(run) == pytest.approx(1100.0)
    assert reader("feed_wait_ms.train")(run) == pytest.approx(2.0)
    assert reader("peak_mem_gib")(run) == 3.0
    assert reader("elementwise_ms.train")(run) == pytest.approx(200.0)
    assert reader("device_idle_share.train")(run) == pytest.approx(10.0)
    assert reader("step_mfu.train")(run) == pytest.approx(
        100 * 10 * work.train_step_flops(cell.model, 4, 2048) / 12.0 / 989e12)
    assert reader("ttft_p95_ms")(run) is None
    assert reader("ssd_scan_roofline.train")(run) is None   # no op in the trace


def test_roofline_scales_lost_events_by_calls():
    cell = M.cell(TRAIN)
    x, bm, h0 = [4, 2048, 64, 64], [4, 2048, 128], []
    shapes = [x, [4, 2048, 64], [64], bm, bm, h0, []]
    # two calls; kernel "a" kept in both, kernel "b" lost in one
    rec = OpCalls(args=[(shapes, [None] * 6 + [256], None)] * 2,
                  kernels={"a": [100.0, 100.0], "b": [50.0]})
    assert rec.device_s() == (100.0 * 2 + 50.0 * 2) / 1e6
    run = Run(cell=cell, seed=0, steps=1, trace=_trace({"repro_torch::ssd_scan_fwd": rec}))
    assert run.trace.scaled() == {"repro_torch::ssd_scan_fwd": {"b": [1, 2]}}
    bound = work.ssd_forward(4, 2048, 64, 64, 128, 256, 2).bound_s()
    got = reader("ssd_scan_roofline.train")(run)
    assert got == pytest.approx(100 * 2 * bound / 300e-6)
    assert rooflines.share(_trace(), {"x": rooflines.ssd_forward}, cell.model) is None


def test_serve_plan_is_one_schedule_for_every_seed():
    from portbench.drivers import serve
    traffic = M.cell(SERVE).traffic
    a = serve.plan(traffic, 30.0)
    assert len(a) == round(traffic["rate_per_s"] * 30.0)
    assert [(r.at, r.prompt_len, r.out_len) for r in a] == [
        (r.at, r.prompt_len, r.out_len) for r in serve.plan(dict(traffic), 30.0)]
    other = serve.plan(dict(traffic, schedule_seed=traffic["schedule_seed"] + 1), 30.0)
    for key in ("prompt_len", "out_len"):   # another schedule: the same sizes, reordered
        assert sorted(getattr(r, key) for r in a) == sorted(getattr(r, key) for r in other)
        assert [getattr(r, key) for r in a] != [getattr(r, key) for r in other]
    assert a[0].at == 0.0 and all(x.at <= y.at for x, y in zip(a, a[1:]))
    assert np.mean(np.diff([r.at for r in a])) == pytest.approx(1 / traffic["rate_per_s"],
                                                                rel=0.1)
    lens = [r.prompt_len for r in a]
    p = traffic["prompt"]
    assert min(lens) >= p["min"] and max(lens) == p["max"]
    assert all(n % p["grid"] == 0 for n in lens)
    assert np.median(lens) == pytest.approx(p["median"], rel=0.1)
    assert np.median([r.out_len for r in a]) == pytest.approx(traffic["output"]["median"], abs=1)


def test_serve_prompts_come_from_the_seed():
    from portbench.drivers import serve
    a = serve.prompt_tokens(2 ** 31 + 11, serve.WINDOW_STREAM, 3, 256, 50288)
    assert (a == serve.prompt_tokens(2 ** 31 + 11, serve.WINDOW_STREAM, 3, 256, 50288)).all()
    assert (a != serve.prompt_tokens(2 ** 31 + 12, serve.WINDOW_STREAM, 3, 256, 50288)).any()


def test_decode_buckets_are_powers_of_two_up_to_the_slots():
    from portbench.drivers import serve
    assert [serve.bucket(n, 64) for n in (1, 2, 3, 5, 8, 9, 33, 64)] == [
        1, 2, 4, 8, 8, 16, 64, 64]
    assert serve.bucket(100, 64) == 64
