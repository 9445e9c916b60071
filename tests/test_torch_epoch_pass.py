"""The port's epoch pass against the JAX package's, bit for bit.

``ref.epoch_pass`` (the plain version the CPU takes), ``make_pass("cpu")``
(what the port's engine calls) and the port's own numpy copies are held
equal to ``repro.kernels.epoch_fastpath.epoch_pass_np`` and
``wire_arrival_pass_np`` on the emission schedules of
``tests/test_fastpath.py``'s fast-path configs, sliced into epochs as the
engine slices them, and on the edge cases; where the JAX package's jitted
pass is available, against it too. A numpy mirror of the CUDA kernel's
tiled pair scan (``kernels/csrc/epoch_pass.cu``) is held to the same bits,
so the kernel's arithmetic is checked here although the kernel runs only on
the card. Every comparison is exact: the pass is integer arithmetic.
"""
import numpy as np
import pytest
import torch

from repro.core.loadgen import TrafficPattern as RefPattern
from repro.kernels import epoch_fastpath as jx
from repro_torch.core.fastpath import iter_epoch_slices
from repro_torch.core.loadgen import TrafficPattern
from repro_torch.kernels import epoch_pass as ep
from repro_torch.kernels import ops, ref

# the emission schedules of tests/test_fastpath.py's FASTPATH_CASES: (name,
# pattern kwargs, duration s, link gbps, link latency ns, queues)
SCHEDULES = [
    ("uniform-4q", dict(rate_gbps=40.0, packet_size=1518), 0.002, 40.0, 1000, 4),
    ("poisson-4q", dict(rate_gbps=40.0, packet_size=1518, kind="poisson", seed=3),
     0.002, 40.0, 1000, 4),
    ("bursty-4q", dict(rate_gbps=40.0, packet_size=1518, kind="bursty", burst_len=32),
     0.002, 40.0, 1000, 4),
    ("uniform-1q", dict(rate_gbps=2.0, packet_size=1518), 0.002, 40.0, 1000, 1),
    ("two-ports", dict(rate_gbps=40.0, packet_size=1518), 0.002, 40.0, 1000, 4),
    ("ideal-wire", dict(rate_gbps=40.0, packet_size=1518), 0.001, 0.0, 0, 4),
    ("one-lcore-4q", dict(rate_gbps=20.0, packet_size=1518), 0.002, 40.0, 1000, 4),
    # the wire saturates: 64-byte frames at 100 Gbit/s over a 40 Gbit/s link
    ("busy-wire-64B", dict(rate_gbps=100.0, packet_size=64, kind="poisson", seed=5),
     0.0005, 40.0, 1000, 8),
]
N_FLOWS = 256


def schedule(kw, dur, gbps):
    """The JAX package's emission schedule and serialisation for one config,
    and the port's, which must be equal."""
    pattern = RefPattern(**kw)
    times, sizes = pattern.emission_schedule(int(dur * 1e9),
                                             np.random.default_rng(pattern.seed))
    mine = TrafficPattern(**kw)
    t2, s2 = mine.emission_schedule(int(dur * 1e9), np.random.default_rng(mine.seed))
    assert np.array_equal(times, t2) and np.array_equal(sizes, s2)
    ser = jx.serialization_ns_vec(sizes, gbps)
    assert np.array_equal(ser, ep.serialization_ns_vec(sizes, gbps))
    return times, ser


def queue_table(n_queues, seed=0):
    if n_queues <= 1:
        return None
    return np.random.default_rng(seed).integers(0, n_queues, N_FLOWS).astype(np.int64)


def plain_pass(handed, ser, busy0, lat, table, fids):
    """ref.epoch_pass on CPU tensors made from numpy, back to numpy."""
    t = None if table is None else torch.from_numpy(table)
    f = None if fids is None else torch.from_numpy(fids)
    a, busy, q = ref.epoch_pass(torch.from_numpy(handed), torch.from_numpy(ser),
                                busy0, lat, t, f)
    return a.numpy(), busy, None if q is None else q.numpy()


def mirror_pass(handed, ser, busy0, lat, table, fids):
    """A numpy mirror of the CUDA kernel: pairs (S, M) per frame, each
    thread's ITEMS frames joined in order, threads joined in a block,
    tiles' totals joined into carry-ins, then each frame's pair from its
    tile's carry-in, its thread's prefix and its own frames; the empty pair
    (0, NONE) on either side of a join."""
    NONE = np.iinfo(np.int64).min

    def join(l, r):
        return (l[0] + r[0], l[1] if r[1] == NONE else max(l[1], r[1] - l[0]))

    n = len(handed)
    if n == 0:
        q = table[fids] if table is not None and fids is not None else None
        return np.empty(0, np.int64), int(busy0), q
    p = ep.plan(n)
    pairs = [(int(s), int(t)) for s, t in zip(ser, handed)]
    threads = [[pairs[i] for i in range(k, min(k + ep.ITEMS, n))]
               for k in range(0, p.tiles * ep.TILE, ep.ITEMS)]
    thread_pair = []
    for items in threads:
        v = (0, NONE)
        for x in items:
            v = join(v, x)
        thread_pair.append(v)
    tile_total, thread_prefix = [], []
    for b in range(p.tiles):
        v = (0, NONE)
        for t in range(b * ep.THREADS, (b + 1) * ep.THREADS):
            thread_prefix.append(v)
            v = join(v, thread_pair[t])
        tile_total.append(v)
    carry, v = [], (0, NONE)
    for total in tile_total:
        carry.append(v)
        v = join(v, total)
    arrivals = np.empty(n, np.int64)
    for t, items in enumerate(threads):
        run = join(carry[t * ep.ITEMS // ep.TILE], thread_prefix[t])
        for k, x in enumerate(items):
            run = join(run, x)
            arrivals[t * ep.ITEMS + k] = max(busy0, run[1]) + run[0] + lat
    q = table[fids] if table is not None and fids is not None else None
    return arrivals, int(arrivals[-1] - lat), q


def assert_same(got, want):
    a, busy, q = got
    wa, wbusy, wq = want
    assert a.dtype == np.int64 and np.array_equal(a, wa)
    assert busy == wbusy and isinstance(busy, int)
    if wq is None:
        assert q is None
    else:
        assert q.dtype == wq.dtype and np.array_equal(q, wq)


PASSES = {"ref.epoch_pass": plain_pass, "make_pass(cpu)": ep.make_pass("cpu"),
          "epoch_pass_np (port)": ep.epoch_pass_np}


@pytest.mark.parametrize("impl", list(PASSES))
@pytest.mark.parametrize("case", SCHEDULES, ids=[c[0] for c in SCHEDULES])
def test_pass_matches_jax_package_over_epochs(case, impl):
    """Each schedule sliced into epochs as the engine slices it (about 8
    epochs a run), busy_until carried from one to the next."""
    name, kw, dur, gbps, lat, nq = case
    times, ser = schedule(kw, dur, gbps)
    table = queue_table(nq)
    fids = np.arange(len(times), dtype=np.int64) % N_FLOWS
    epoch_ns = max(1, (int(times[-1]) - int(times[0])) // 8)
    busy_want = busy_got = 0
    fn = PASSES[impl]
    slices = list(iter_epoch_slices(times, epoch_ns))
    assert len(slices) > 1
    for lo, hi in slices:
        f = None if table is None else fids[lo:hi]
        want = jx.epoch_pass_np(times[lo:hi], ser[lo:hi], busy_want, lat, table, f)
        got = fn(times[lo:hi], ser[lo:hi], busy_got, lat, table, f)
        assert_same(got, want)
        a, busy_want = jx.wire_arrival_pass_np(times[lo:hi], ser[lo:hi], busy_want, lat)
        assert np.array_equal(a, want[0]) and busy_want == want[1]
        busy_got = got[1]


EDGES = {
    "empty": (np.empty(0, np.int64), np.empty(0, np.int64), 5, 7),
    "single": (np.array([100]), np.array([10]), 0, 3),
    "equal-time-burst": (np.full(40, 1000), np.full(40, 121), 0, 1000),
    "busy0-past-all": (np.arange(0, 500, 10), np.full(50, 4), 10_000, 1000),
    "ideal-wire": (np.array([0, 0, 5, 5, 9]), np.zeros(5, np.int64), 0, 0),
    "queueing": (np.array([0, 5, 5, 40]), np.array([10, 10, 10, 10]), 3, 7),
    "mixed-sizes": (np.array([0, 1, 2, 300, 300, 301]), np.array([51, 12, 243, 5, 0, 121]),
                    250, 11),
}


@pytest.mark.parametrize("steer", ["table", "no-table", "table-no-fids"])
@pytest.mark.parametrize("name", list(EDGES))
def test_pass_edge_cases(name, steer):
    handed, ser, busy0, lat = (np.asarray(x, dtype=np.int64) if isinstance(x, np.ndarray)
                               else x for x in EDGES[name])
    table = queue_table(4, seed=1) if steer != "no-table" else None
    fids = (np.arange(len(handed), dtype=np.int64) * 37) % N_FLOWS
    fids = None if steer == "table-no-fids" else fids
    want = jx.epoch_pass_np(handed, ser, busy0, lat, table, fids)
    for fn in (*PASSES.values(), mirror_pass):
        assert_same(fn(handed, ser, busy0, lat, table, fids), want)


def test_negative_flow_ids_index_as_numpy_does():
    handed, ser = np.arange(4, dtype=np.int64), np.ones(4, np.int64)
    table = queue_table(4, seed=2)
    fids = np.array([-1, -N_FLOWS, 3, N_FLOWS - 1], dtype=np.int64)
    want = jx.epoch_pass_np(handed, ser, 0, 0, table, fids)
    for fn in (*PASSES.values(), mirror_pass):
        assert_same(fn(handed, ser, 0, 0, table, fids), want)


@pytest.mark.parametrize("bad", [N_FLOWS, N_FLOWS + 5, -N_FLOWS - 1])
def test_out_of_range_flow_id_raises_index_error(bad):
    handed, ser = np.arange(4, dtype=np.int64), np.ones(4, np.int64)
    table = queue_table(4, seed=2)
    fids = np.array([0, 1, bad, 2], dtype=np.int64)
    with pytest.raises(IndexError):
        jx.epoch_pass_np(handed, ser, 0, 0, table, fids)
    for fn in PASSES.values():
        with pytest.raises(IndexError):
            fn(handed, ser, 0, 0, table, fids)


def test_pass_matches_jitted_jax_pass_when_available():
    jax_pass = jx.get_epoch_pass_jax()
    if jax_pass is None:
        pytest.skip("the JAX package's jitted epoch pass is unavailable "
                    "(get_epoch_pass_jax() returned None)")
    name, kw, dur, gbps, lat, nq = SCHEDULES[1]
    times, ser = schedule(kw, dur, gbps)
    table = queue_table(nq)
    fids = np.arange(len(times), dtype=np.int64) % N_FLOWS
    assert_same(plain_pass(times, ser, 0, lat, table, fids),
                jax_pass(times, ser, 0, lat, table, fids))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 2047, 2048, 2049, 5000])
def test_kernel_mirror_matches_numpy_pass(n):
    """The tiled pair scan at tile edges, on random gaps and sizes (bursts of
    equal times included) and a busy wire at the start."""
    rng = np.random.default_rng(n)
    handed = np.cumsum(rng.integers(0, 3, n) * rng.integers(0, 200, n)).astype(np.int64)
    ser = rng.integers(0, 250, n).astype(np.int64)
    table = queue_table(8, seed=n)
    fids = rng.integers(0, N_FLOWS, n).astype(np.int64)
    busy0 = int(handed[n // 2]) if n > 1 else 5
    assert_same(mirror_pass(handed, ser, busy0, 1000, table, fids),
                jx.epoch_pass_np(handed, ser, busy0, 1000, table, fids))


def test_plan():
    assert ep.TILE == 2048
    assert ep.plan(1) == ep.Plan(tiles=1, kernels=1, workspace=6)
    assert ep.plan(2048) == ep.Plan(tiles=1, kernels=1, workspace=6)
    assert ep.plan(2049) == ep.Plan(tiles=2, kernels=3, workspace=10)
    assert ep.plan(63342) == ep.Plan(tiles=31, kernels=3, workspace=126)
    assert ep.plan(1 << 24).tiles == 8192
    with pytest.raises(ValueError):
        ep.plan(0)


def test_cost_table_matches_jax_package():
    for args in [(64, 180, 110, 2.0), (32, 0, 55, 3.1), (1, 7, 1, 1.0)]:
        assert np.array_equal(ep.pmd_burst_cost_table(*args), jx.pmd_burst_cost_table(*args))
    lengths = np.array([64, 65, 1518, 9000, 1, 0])
    for gbps in (0.0, -1.0, 10.0, 40.0, 100.0, 3.3):
        assert np.array_equal(ep.serialization_ns_vec(lengths, gbps),
                              jx.serialization_ns_vec(lengths, gbps))


def test_ops_dispatch_follows_the_device():
    h, s = torch.arange(4), torch.ones(4, dtype=torch.int64)
    before = ref.calls
    a, busy, q = ops.epoch_pass(h.to(torch.int32), s, 0, 1)  # cast to int64
    assert ref.calls == before + 1 and a.dtype == torch.int64 and q is None
    with pytest.raises(ValueError, match="meta"):
        ops.epoch_pass(h.to("meta"), s.to("meta"), 0, 1)
    # the wrapper of the kernel takes CUDA tensors only
    launches = ep.launches
    with pytest.raises(ValueError, match="CUDA"):
        ep.epoch_pass_cuda(h, s, 0, 1)
    with pytest.raises(TypeError):
        ep.epoch_pass_cuda(h.to(torch.int32), s, 0, 1)
    with pytest.raises(ValueError, match="one shape"):
        ep.epoch_pass_cuda(h, s[:3], 0, 1)
    assert ep.launches == launches


def test_make_pass_refuses_what_it_cannot_run():
    with pytest.raises(ValueError):
        ep.make_pass("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            ep.make_pass("cuda")


def test_make_pass_moves_each_table_once(monkeypatch):
    """The engine hands the same table object every epoch of a port; the
    pass copies it to its device once."""
    pass_fn = ep.make_pass("cpu")
    seen = []
    real = ops.epoch_pass

    def spy(handed, ser, busy0, lat, table, fids):
        seen.append(table)
        return real(handed, ser, busy0, lat, table, fids)

    monkeypatch.setattr(ops, "epoch_pass", spy)
    table = queue_table(4)
    for k in range(3):
        pass_fn(np.arange(5, dtype=np.int64) + 10 * k, np.ones(5, np.int64), 0, 0, table,
                np.arange(5, dtype=np.int64))
    assert seen[0] is seen[1] is seen[2]
    pass_fn(np.arange(5, dtype=np.int64), np.ones(5, np.int64), 0, 0, table.copy(),
            np.arange(5, dtype=np.int64))
    assert seen[3] is not seen[0]
