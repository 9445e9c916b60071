"""The burst gather's flat chunk layout on the CPU: the plan of its CUDA
kernel, and a plain mirror of the kernel's chunk -> (row, column) mapping.

* ``repro_torch.kernels.burst_gather.plan(n, out_width)`` works out, on the
  host and from the shapes alone, the kernel's grid: one thread per 16 flat
  output bytes, ceil(n * out_width / 16) chunks, the last partial where
  n * out_width is not a multiple of 16 (``tail`` bytes), in blocks of 128.
  Its numbers here are worked out by hand.
* A plain mirror, written in this file with numpy and on no path of the
  port, walks every chunk of the plan as the kernel does
  (``csrc/burst_gather.cu``): the rows the chunk touches (at most two where
  out_width >= 16, which the kernel loads together; up to 16 where it is
  narrower, which it walks in turn: the same rows and bytes), each
  with its own descriptor (the slot normalised as JAX indexes, the length
  clamped to [0, min(slot_size, out_width)]), and one byte load for each
  chunk position that the row's valid bytes cover, the other positions 0.
  It records every output byte it writes and every source byte it loads,
  at the arena's real address. Every case asserts that each output byte is
  written exactly once (straddling chunks and the partial tail too), that
  no load reaches a byte at or past its row's valid length, before its row
  or outside the arena, that each valid byte is loaded once, and that the
  assembled output equals the port's plain ``ref.burst_gather``, the JAX
  package's reference and, where there is a packet,
  ``burst_gather_pallas`` in interpret mode (a grid of 0 steps is not a
  Pallas call), byte for byte.

Cases: out_width 1, 15, 16, 17, 40 and 1518, each with slots wider and
narrower than it (width 1 has none narrower: slots of 1 byte instead), at
n 0, 1, 32 and 256, with lengths from -3 to past the slot size; the edge
cases of ``chip_smoke.py``'s gather check (slots past the arena and
negative, lengths negative and past the width); and arenas that are
contiguous views starting at rows 1 to 3 of a larger buffer, so that rows
start off every alignment. Inputs are drawn from a numpy seed.

The kernel itself runs on the card only (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.burst_gather import burst_gather_pallas
from repro_torch.kernels import burst_gather as tgather
from repro_torch.kernels import ref

# (n, out_width) -> (chunks, tail, threads, grid)
PLANS = {
    (256, 1518): (24288, 0, 128, 190),     # the benchmark burst: 388608 bytes
    (4096, 1518): (388608, 0, 128, 3036),  # the whole ring
    (255, 1518): (24194, 2, 128, 190),     # 387090 bytes: a last chunk of 2
    (1, 1518): (95, 14, 128, 1),
    (32, 1): (2, 0, 128, 1),               # 16 rows a chunk
    (37, 1): (3, 5, 128, 1),
    (3, 17): (4, 3, 128, 1),
    (0, 1518): (0, 0, 128, 0),
    (7, 0): (0, 0, 128, 0),
    (8, 16): (8, 0, 128, 1),
    (129, 16): (129, 0, 128, 2),           # one block and one more chunk
}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan_by_hand(shape):
    assert tuple(tgather.plan(*shape)) == PLANS[shape]


@pytest.mark.parametrize("n,width", [(-1, 16), (4, -1), (2 ** 31 - 1, 2 ** 31 - 1)])
def test_plan_refuses_what_the_grid_cannot_take(n, width):
    with pytest.raises(ValueError, match="burst_gather_cuda"):
        tgather.plan(n, width)


def _norm_slot(s, n_slots):
    s = s + n_slots if s < 0 else s
    return min(max(s, 0), n_slots - 1)


def _row_bytes(b, mem, base, src, p0, r, row_lo, row_hi, loads):
    """The kernel's row_bytes: chunk position p in [p0, p0 + r) is the source
    byte at address src + p, one load each. Every load is checked to lie in
    [row_lo, row_hi), the row's valid bytes."""
    for p in range(p0, p0 + r):
        addr = src + p
        assert row_lo <= addr < row_hi, \
            f"a load of {addr} outside the row's valid bytes [{row_lo}, {row_hi})"
        b[p] = mem[addr - base]
        loads.append(addr)


def mirror(arena, base, slots, lengths, out_width):
    """The kernel's output bytes, assembled chunk by chunk from the plan,
    with the times each output byte was written and the source bytes loaded.
    ``arena`` is the (n_slots, slot_size) uint8 array, ``base`` the address
    of its first byte."""
    n_slots, slot_size = arena.shape
    mem = arena.reshape(-1)
    n = len(slots)
    p = tgather.plan(n, out_width)
    width = min(slot_size, out_width)
    out = np.zeros(n * out_width, np.uint8)
    writes = np.zeros(n * out_width, np.int64)
    loads = []
    for c in range(p.chunks):
        length = p.tail if (c == p.chunks - 1 and p.tail) else tgather.CHUNK
        start = c * tgather.CHUNK
        i, j = divmod(start, out_width)
        b = np.zeros(tgather.CHUNK, np.uint8)
        pos, rows = 0, 0
        while pos < length:
            m = min(length - pos, out_width - j)  # the chunk's bytes in row i
            row = base + _norm_slot(int(slots[i]), n_slots) * slot_size
            valid = max(0, min(int(lengths[i]), width))
            _row_bytes(b, mem, base, row + j - pos, pos, min(m, max(0, valid - j)),
                       row, row + valid, loads)
            pos, i, j, rows = pos + m, i + 1, 0, rows + 1
        assert out_width < tgather.CHUNK or rows <= 2
        out[start:start + length] = b[:length]
        writes[start:start + length] += 1
    return out.reshape(n, out_width), writes, loads


def _check(arena_t, slots, lengths, out_width):
    """Every assertion of the module docstring for one call."""
    arena = arena_t.numpy()
    base = arena_t.data_ptr()
    got, writes, loads = mirror(arena, base, slots, lengths, out_width)
    n = len(slots)
    assert got.shape == (n, out_width)
    assert (writes == 1).all(), "an output byte written other than once"
    assert all(base <= a < base + arena.size for a in loads), "a load outside the arena"
    # each row's valid bytes that reach the output are loaded once, no more
    width = min(arena.shape[1], out_width)
    valid = np.clip(lengths.astype(np.int64), 0, width)
    assert len(loads) == int(valid.sum())
    want = ref.burst_gather(arena_t, torch.from_numpy(slots), torch.from_numpy(lengths),
                            out_width).numpy()
    np.testing.assert_array_equal(got, want)
    jargs = (jnp.asarray(arena), jnp.asarray(slots), jnp.asarray(lengths), out_width)
    np.testing.assert_array_equal(got, np.asarray(jref.burst_gather(*jargs)))
    if n:
        np.testing.assert_array_equal(
            got, np.asarray(burst_gather_pallas(*jargs, interpret=True)))


def _random_case(rng, n_slots, slot_size, n, skip=0):
    """An arena that is the contiguous view buffer[skip:], n random slots
    (repeats allowed) and lengths from -3 to past the slot size."""
    buf = torch.from_numpy(rng.integers(0, 256, size=(skip + n_slots, slot_size))
                           .astype(np.uint8))
    arena = buf[skip:]
    assert arena.is_contiguous()
    slots = rng.integers(0, n_slots, size=(n,)).astype(np.int32)
    lengths = rng.integers(-3, slot_size + 6, size=(n,)).astype(np.int32)
    return arena, slots, lengths


# (out_width, slot_size): a slot narrower and one wider than each width
SHAPES = [(1, 1), (1, 9), (15, 7), (15, 33), (16, 5), (16, 40), (17, 3), (17, 64),
          (40, 16), (40, 64), (1518, 1000), (1518, 1518), (1518, 2048)]


@pytest.mark.parametrize("n", [0, 1, 32, 256])
@pytest.mark.parametrize("width,slot_size", SHAPES, ids=lambda v: str(v))
def test_chunk_mapping_covers_reads_and_matches(width, slot_size, n):
    rng = np.random.default_rng(1000 * width + slot_size + n)
    arena, slots, lengths = _random_case(rng, 300, slot_size, n)
    _check(arena, slots, lengths, width)


# the edge cases of chip_smoke.py's GATHER_CASES
EDGE_CASES = {
    # name: (n_slots, slot_size, slots, lengths, out_width)
    "slots_past_the_arena": (4, 16, [5, -1, 3, 1 << 30], [16, 16, 16, 16], 16),
    "negative_slots": (4, 16, [-1, -4, -5, -10, -(1 << 31)], [16, 8, 16, 16, 16], 16),
    "negative_and_zero_lengths": (4, 16, [0, 1, 2], [-3, 0, -(1 << 31)], 16),
    "lengths_past_the_width": (4, 16, [0, 1, 2], [17, 100, (1 << 31) - 1], 12),
    "width_past_the_slot_size": (8, 16, [7, 0, 3], [16, 20, 9], 40),
    "no_packets": (4, 16, [], [], 16),
    "straddling_rows_odd_slots": (5, 7, [4, -1, 9, -7, 2], [7, 3, -1, 100, 6], 15),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_chunk_mapping_edge_cases(case):
    n_slots, slot_size, slots, lengths, width = EDGE_CASES[case]
    arena = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, size=(n_slots, slot_size)).astype(np.uint8))
    _check(arena, np.asarray(slots, np.int32), np.asarray(lengths, np.int32), width)


@pytest.mark.parametrize("width,slot_size,skip,n", [
    (1518, 1518, 1, 64),   # rows 2 mod 4, as buffer[1:] of the card's arena
    (40, 33, 1, 32),       # rows start at each offset mod 4 in turn
    (40, 33, 2, 32),
    (40, 33, 3, 32),
    (17, 35, 1, 33),       # straddling chunks over odd rows
    (16, 4099, 3, 8),      # rows wider than the output, 3 mod 4
])
def test_chunk_mapping_on_an_arena_view(width, slot_size, skip, n):
    rng = np.random.default_rng(skip + slot_size)
    arena, slots, lengths = _random_case(rng, 64, slot_size, n, skip=skip)
    _check(arena, slots, lengths, width)
