"""The port's burst gather on the CPU against the JAX package's.

The plain version (``repro_torch.kernels.ref.burst_gather``, which
``ops.burst_gather`` takes for CPU tensors) must equal the Pallas kernel in
interpret mode and the JAX reference byte for byte on the shapes of
``tests/test_kernels.py``, and the JAX reference on the edge cases: slots
past the arena and negative (JAX indexing adds n_slots once, then clamps),
lengths negative and past the width, a width past the slot size, no packets.
The CUDA wrapper's input checks that need no card run here too; the kernel
itself is held against this plain version on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.burst_gather import burst_gather_pallas
from repro_torch.kernels import burst_gather as kgather
from repro_torch.kernels import ops, ref


def _inputs(rng, n_slots, slot_size, slots, lengths):
    arena = rng.integers(0, 256, size=(n_slots, slot_size)).astype(np.uint8)
    return arena, np.asarray(slots, np.int32), np.asarray(lengths, np.int32)


def _port(arena, slots, lengths, width):
    return ops.burst_gather(torch.from_numpy(arena), torch.from_numpy(slots),
                            torch.from_numpy(lengths), width).numpy()


def _jax_ref(arena, slots, lengths, width):
    return np.asarray(jref.burst_gather(jnp.asarray(arena), jnp.asarray(slots),
                                        jnp.asarray(lengths), width))


@pytest.mark.parametrize("n,slot_size,width", [(16, 256, 256), (8, 128, 300), (32, 64, 32)])
def test_plain_gather_matches_pallas_and_jax_ref(n, slot_size, width):
    rng = np.random.default_rng(n)
    arena, slots, lens = _inputs(rng, 64, slot_size, rng.permutation(64)[:n],
                                 rng.integers(1, slot_size, size=(n,)))
    got = _port(arena, slots, lens, width)
    pallas = np.asarray(burst_gather_pallas(jnp.asarray(arena), jnp.asarray(slots),
                                            jnp.asarray(lens), width, interpret=True))
    assert got.dtype == np.uint8 and got.shape == (n, width)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _jax_ref(arena, slots, lens, width))


EDGE_CASES = {
    # name: (n_slots, slot_size, slots, lengths, out_width)
    "slots_past_the_arena": (4, 16, [5, -1, 3, 1 << 30], [16, 16, 16, 16], 16),
    "negative_slots": (4, 16, [-1, -4, -5, -10, -(1 << 31)], [16, 8, 16, 16, 16], 16),
    "negative_and_zero_lengths": (4, 16, [0, 1, 2], [-3, 0, -(1 << 31)], 16),
    "lengths_past_the_width": (4, 16, [0, 1, 2], [17, 100, (1 << 31) - 1], 12),
    "width_past_the_slot_size": (8, 16, [7, 0, 3], [16, 20, 9], 40),
    "no_packets": (4, 16, [], [], 16),
    "zero_width": (4, 16, [1, 2], [5, 5], 0),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_plain_gather_edge_cases_match_jax_ref(case):
    n_slots, slot_size, slots, lengths, width = EDGE_CASES[case]
    arena, slots, lens = _inputs(np.random.default_rng(7), n_slots, slot_size, slots, lengths)
    got = _port(arena, slots, lens, width)
    assert got.shape == (len(slots), width)
    np.testing.assert_array_equal(got, _jax_ref(arena, slots, lens, width))


def test_slots_past_the_arena_read_its_last_row():
    arena = np.arange(4 * 8, dtype=np.uint8).reshape(4, 8)
    got = _port(arena, np.asarray([5, -1], np.int32), np.asarray([8, 8], np.int32), 8)
    np.testing.assert_array_equal(got, arena[[3, 3]])


def test_bench_shape_matches_jax_ref():
    """The shape the kernels benchmark drives: 256 packets of an arena of 4096
    Ethernet-frame slots, lengths 64-1517."""
    rng = np.random.default_rng(0)
    arena, slots, lens = _inputs(rng, 4096, 1518, rng.permutation(4096)[:256],
                                 rng.integers(64, 1518, size=(256,)))
    np.testing.assert_array_equal(_port(arena, slots, lens, 1518),
                                  _jax_ref(arena, slots, lens, 1518))


def test_ops_takes_the_plain_version_on_the_cpu_and_casts_indices():
    arena = torch.arange(24, dtype=torch.uint8).reshape(3, 8)
    before_calls, before_launches = ref.calls, kgather.launches
    got = ops.burst_gather(arena, torch.tensor([2, 0], dtype=torch.int64),
                           torch.tensor([3, 9], dtype=torch.int64), 8)
    assert ref.calls == before_calls + 1 and kgather.launches == before_launches
    np.testing.assert_array_equal(got.numpy(), [[16, 17, 18, 0, 0, 0, 0, 0],
                                                list(range(8))])


def _args(**over):
    a = dict(arena=torch.zeros(4, 8, dtype=torch.uint8),
             slots=torch.zeros(2, dtype=torch.int32),
             lengths=torch.zeros(2, dtype=torch.int32), out_width=8)
    a.update(over)
    return a


@pytest.mark.parametrize("bad,exc,match", [
    (dict(arena=torch.zeros(4, 8, dtype=torch.int8)), TypeError, "uint8"),
    (dict(slots=torch.zeros(2, dtype=torch.int64)), TypeError, "int32"),
    (dict(lengths=torch.zeros(3, dtype=torch.int32)), ValueError, "shapes"),
    (dict(arena=torch.zeros(8, 4, dtype=torch.uint8).t()), ValueError, "contiguous"),
    (dict(arena=torch.zeros(0, 8, dtype=torch.uint8)), ValueError, "no slots"),
    (dict(out_width=-1), ValueError, "out_width"),
    ({}, ValueError, "CUDA"),
])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(bad, exc, match):
    with pytest.raises(exc, match=match):
        kgather.burst_gather_cuda(**_args(**bad))
