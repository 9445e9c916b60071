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


NONE = int(np.iinfo(np.int64).min)  # M of the empty pair
AGGREGATE, INCLUSIVE = 0, 4            # a tile's two slots, 4 words from its first


def join(l, r):
    """Pair l, then pair r (the kernel's join; the empty pair on either side)."""
    return (l[0] + r[0], l[1] if r[1] == NONE else max(l[1], r[1] - l[0]))


def halves(v):
    """The low and high 32 bits of an int64."""
    u = v % 2 ** 64
    return u & 0xffffffff, u >> 32


def from_halves(lo, hi):
    u = lo | hi << 32
    return u - 2 ** 64 if u >= 2 ** 63 else u


class MirrorCard:
    """A numpy mirror of the CUDA kernel (``kernels/csrc/epoch_pass.cu``) on
    one device's workspace, kept across calls as the wrapper keeps it: a
    ticket counter never reset, each call's base the tickets issued before
    it, and two slots a tile, an aggregate and an inclusive one, of four
    64-bit words, each a 32-bit tag (ticket + 1) over 32 bits of the pair,
    left as the last call wrote them; and the status pair, left too.

    A call runs its blocks as generators, interleaved at random: a block
    starts when it takes a ticket (at most ``resident`` blocks at once),
    and each of its steps may be followed by another block's, also between
    the two 2-word stores of a slot. A block stages its tile, joins each
    thread's ITEMS consecutive pairs and scans the threads; it publishes the
    tile's aggregate (tile 0 its inclusive pair; the last tile publishes
    neither), then looks back over windows of LOOKBACK tiles, taking a slot
    as this call's only if its four tags are base + its tile + 1, and reads
    again (yields) while a tile has neither slot; it joins the window's
    pairs from its last inclusive pair on, or moves the window down, and
    publishes its inclusive pair. The block steers its frames; tile 0
    stores its count of bad ids into status[1] and marks it stored
    (base + 1), and a block with bad ids waits for that mark and adds its
    count; the thread of frame n - 1 writes busy_until."""

    def __init__(self, seed=0, garbage=0):
        self.rng = np.random.default_rng(seed)
        self.counter = 0   # the workspace's ticket counter
        self.issued = 0    # the wrapper's count of tickets issued
        # by word index, 8 a tile; absent: zero. With ``garbage``, the first
        # ``garbage`` tiles' words hold random halves under tags no call of
        # this test issues (2^31 and up), as words of another life would
        self.words = {w: int(self.rng.integers(2 ** 31, 2 ** 32)) << 32
                      | int(self.rng.integers(0, 2 ** 32)) for w in range(8 * garbage)}
        self.status = [7, 7]  # whatever an earlier call left
        self.counted = 0      # tile 0's mark
        self.stale_words = 0  # words of an earlier call read while this one's were not out

    def __call__(self, handed, ser, busy0, lat, table, fids):
        n = len(handed)
        steer = table is not None and fids is not None
        if n == 0:
            return np.empty(0, np.int64), int(busy0), table[fids] if steer else None
        tiles, base = ep.plan(n).tiles, self.issued
        assert base + tiles < ep.TAGS
        out = (np.empty(n, np.int64), np.empty(n, np.int64) if steer else None)
        resident, started = [], 0
        limit = int(self.rng.integers(1, 9))
        while started < tiles or resident:
            if started < tiles and len(resident) < limit and (
                    not resident or self.rng.random() < 0.5):
                resident.append(self.block(base, handed, ser, busy0, lat, table if steer else
                                           None, fids, out))
                started += 1
            k = int(self.rng.integers(len(resident)))
            try:
                next(resident[k])
            except StopIteration:
                resident.pop(k)
        self.issued += tiles
        assert self.counter == self.issued
        busy, bad = self.status
        if bad:
            raise IndexError(f"{bad} flow ids out of range")
        return out[0], busy, out[1]

    def publish(self, tile, slot, pair, tag):
        """Two stores of two words: S's halves, then M's."""
        w = 8 * tile + slot
        for k, v in enumerate(pair):
            lo, hi = halves(v)
            self.words[w + 2 * k] = tag << 32 | lo
            self.words[w + 2 * k + 1] = tag << 32 | hi
            yield

    def read(self, tile, slot, tag):
        """The slot's pair if its four tags are ``tag``, else None."""
        ws = [self.words.get(8 * tile + slot + x, 0) for x in range(4)]
        self.stale_words += sum(w >> 32 not in (0, tag) for w in ws)
        if any(w >> 32 != tag for w in ws):
            return None
        lo = [w & 0xffffffff for w in ws]
        return from_halves(lo[0], lo[1]), from_halves(lo[2], lo[3])

    def block(self, base, handed, ser, busy0, lat, table, fids, out):
        ticket = self.counter
        self.counter += 1
        tile, tag = ticket - base, (ticket + 1) % 2 ** 32
        n, i0 = len(handed), (ticket - base) * ep.TILE
        cnt = min(ep.TILE, n - i0)
        yield
        frames = [(int(ser[i]), int(handed[i])) for i in range(i0, i0 + cnt)]
        excl, total = [], (0, NONE)  # 2. the threads' pairs, scanned in thread order
        for t in range(ep.THREADS):
            excl.append(total)
            for x in frames[t * ep.ITEMS:(t + 1) * ep.ITEMS]:
                total = join(total, x)
        yield
        carry = (0, NONE)  # 3. the carry into the tile (the last tile's pairs have no reader)
        last = tile == ep.plan(n).tiles - 1
        if not last:
            yield from self.publish(tile, AGGREGATE if tile > 0 else INCLUSIVE, total, tag)
        if tile > 0:
            carry = yield from self.look_back(tile, base)
            if not last:
                yield from self.publish(tile, INCLUSIVE, join(carry, total), tag)
        bad = 0  # 4. steer: a flow id indexes as numpy does, once wrapped
        if table is not None:
            for i in range(i0, i0 + cnt):
                fid = int(fids[i]) + (len(table) if fids[i] < 0 else 0)
                ok = 0 <= fid < len(table)
                out[1][i] = table[fid] if ok else 0
                bad += not ok
        if tile == 0:  # 5. the count of bad ids
            self.status[1] = bad
            self.counted = base + 1
        elif bad:
            while self.counted != base + 1:
                yield  # the kernel waits for tile 0's mark
            self.status[1] += bad
        yield
        for t in range(ep.THREADS):  # 6. each thread's frames from join(carry, its prefix)
            run = join(carry, excl[t])
            for k, x in enumerate(frames[t * ep.ITEMS:(t + 1) * ep.ITEMS]):
                run = join(run, x)
                end = max(busy0, run[1]) + run[0]
                i = i0 + t * ep.ITEMS + k
                out[0][i] = end + lat
                if i == n - 1:
                    self.status[0] = end

    def look_back(self, tile, base):
        acc, k = (0, NONE), tile - 1
        while True:
            window = range(k - ep.LOOKBACK + 1, k + 1)
            pairs = []  # (pair, inclusive) a tile of the window, None while neither is out
            for t in window:
                if t < 0:
                    pairs.append(((0, NONE), False))
                    continue
                tag = (base + t + 1) % 2 ** 32
                c, a = self.read(t, INCLUSIVE, tag), self.read(t, AGGREGATE, tag)
                pairs.append(None if c is None and a is None else (c or a, c is not None))
            if None in pairs:
                yield  # the kernel reads the window again
                continue
            last = [j for j, (_, inc) in enumerate(pairs) if inc]
            w = (0, NONE)
            for pair, _ in pairs[last[-1] if last else 0:]:
                w = join(w, pair)
            acc = join(w, acc)
            if last:
                return acc
            k -= ep.LOOKBACK


def mirror_pass(handed, ser, busy0, lat, table, fids):
    """One call of the mirror on a new workspace."""
    return MirrorCard()(handed, ser, busy0, lat, table, fids)


def random_epoch(n, seed):
    """Random gaps and sizes (bursts of equal times included) and a busy
    wire at the start."""
    rng = np.random.default_rng(seed)
    handed = np.cumsum(rng.integers(0, 3, n) * rng.integers(0, 200, n)).astype(np.int64)
    ser = rng.integers(0, 250, n).astype(np.int64)
    table = queue_table(8, seed=seed)
    fids = rng.integers(-N_FLOWS, N_FLOWS, n).astype(np.int64)  # negative ids wrap
    busy0 = int(handed[n // 2]) if n > 1 else 5
    return handed, ser, busy0, table, fids


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


T = ep.TILE


@pytest.mark.parametrize("n", [1, ep.ITEMS - 1, ep.ITEMS, ep.ITEMS + 1, T - 1, T, T + 1,
                               2 * T + 1, 5000, 63343])
def test_kernel_mirror_matches_numpy_pass(n):
    """The one-pass kernel's tiles, look-backs and flags at the tile's and a
    thread's edges, at 5000 and at the bench epoch of 63 343 frames."""
    handed, ser, busy0, table, fids = random_epoch(n, seed=n)
    want = jx.epoch_pass_np(handed, ser, busy0, 1000, table, fids)
    card = MirrorCard(seed=n)
    assert_same(card(handed, ser, busy0, 1000, table, fids), want)
    assert_same(card(handed, ser, busy0, 1000, None, None), (want[0], want[1], None))
    assert card.issued == 2 * ep.plan(n).tiles


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_mirror_consecutive_calls_take_no_stale_word(seed):
    """Calls of growing and shrinking n on one workspace: slots of earlier
    calls stay where they were, and the look-backs meet their words
    (counted), but take none as this call's."""
    card = MirrorCard(seed=seed, garbage=ep.plan(1 << 16).tiles)
    for n in (1 << 16, 1, 63343, 2049):
        handed, ser, busy0, table, fids = random_epoch(n, seed=seed * 7 + n)
        assert_same(card(handed, ser, busy0, 1000, table, fids),
                    jx.epoch_pass_np(handed, ser, busy0, 1000, table, fids))
    assert card.stale_words > 0
    assert card.counter == card.issued == sum(ep.plan(n).tiles for n in (1 << 16, 1, 63343, 2049))


def test_kernel_mirror_counts_bad_ids_across_tiles():
    """Out-of-range ids in tiles 0, 2 and 3: tile 0 stores its count, the
    others add theirs; the call raises, and the next one counts from 0."""
    n = 3 * T + 5
    handed, ser, busy0, table, fids = random_epoch(n, seed=3)
    bad = fids.copy()
    bad[[4, 2 * T + 1, 3 * T + 2, 3 * T + 4]] = N_FLOWS
    card = MirrorCard(seed=3)
    with pytest.raises(IndexError, match="^4 flow ids"):
        card(handed, ser, busy0, 0, table, bad)
    with pytest.raises(IndexError):
        jx.epoch_pass_np(handed, ser, busy0, 0, table, bad)
    assert_same(card(handed, ser, busy0, 0, table, fids),
                jx.epoch_pass_np(handed, ser, busy0, 0, table, fids))


def test_device_workspace_bookkeeping(monkeypatch):
    """The host side of the kernel's workspace, the launch faked: each
    call's base is the tickets issued before it on the workspace; a call of
    more tiles than it holds makes a new, zeroed one (base 0), and so does
    one whose tickets would reach TAGS (a tag is ticket + 1, 32 bits)."""
    seen = []

    def fake(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(ep, "_launcher", (None, fake, lambda index: 7))
    d = ep._Device(0)
    d.device = torch.device("cpu")
    launches = ep.launches

    def launch(n, status=None):
        d.launch(n, 1, 2, None, None, 0, 3, None, status, 5, 6)
        args = seen[-1]
        return dict(zip(("work", "n", "n_flows", "busy0", "latency", "tiles", "cap", "base",
                         "stream"), args[7:])), args[6]

    got, status = launch(1000)
    assert got["tiles"] == got["cap"] == 2 and got["base"] == 0 and got["stream"] == 7
    assert status == got["work"] + 16  # the workspace's own status pair
    work = got["work"]
    got, status = launch(T, status=99)
    assert (got["base"], got["cap"], got["work"], status) == (2, 2, work, 99)
    got, _ = launch(5000)  # 10 tiles: a new workspace
    assert (got["base"], got["cap"], got["tiles"]) == (0, 10, 10)
    assert d.work.numel() == ep.plan_words(10) and not d.work.any()
    d.issued = ep.TAGS - 3
    got, _ = launch(2 * T)
    assert got["base"] == ep.TAGS - 3 and d.issued == ep.TAGS - 1
    got, _ = launch(1)  # its ticket's tag would be 2^32: a new workspace
    assert got["base"] == 0 and d.issued == 1
    assert ep.launches == launches + 5


@pytest.mark.parametrize("n,tiles", [(1, 1), (T, 1), (T + 1, 2), (2 * T + 1, 3),
                                     (63343, 124), (1 << 24, 32768)])
def test_plan(n, tiles):
    """One kernel of ceil(n / TILE) blocks; the bench epoch fills 124 of the
    H100's 132 SMs."""
    assert ep.TILE == ep.THREADS * ep.ITEMS == 512
    assert ep.plan(n) == ep.Plan(tiles=tiles, workspace=ep.HEAD + 8 * tiles)


@pytest.mark.parametrize("n", [0, -1, (ep.MAX_GRID_X + 1) * T])
def test_plan_refuses(n):
    with pytest.raises(ValueError):
        ep.plan(n)


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
