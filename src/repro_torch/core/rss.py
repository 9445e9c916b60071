"""Receive-side scaling: Toeplitz flow hashing + queue indirection table.

Modern NICs steer each received frame to one of ``n_queues`` hardware RX
queues so that every core services its own queue without sharing — the
mechanism behind the paper's Fig. 3(a) core-scaling axis.  Steering is a
two-step function, modeled exactly as the Microsoft RSS spec (and every
real NIC) defines it:

1. a **Toeplitz hash** over the flow fields of the frame header (src/dst
   address + src/dst port, big-endian, in that order), keyed by a 40-byte
   secret so adversarial traffic cannot target one queue;
2. a **128-entry indirection table** indexed by the low bits of the hash,
   whose entries name RX queues.  The table is software-writable, which is
   how drivers rebalance flows without rehashing.

Packets of one flow always land on one queue (no intra-flow reordering);
distinct flows spread across queues in proportion to table occupancy.

The hash here is the real algorithm, vectorized: one ``unpackbits`` +
masked-XOR reduction per burst, no per-packet Python loop.  It matches the
published Microsoft test vectors (see ``tests/test_rss.py``).

Own copy, in the PyTorch port, of ``src/repro/core/rss.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# The de-facto-standard 40-byte RSS key (Microsoft's verification-suite key,
# shipped as the default by ixgbe/i40e/mlx5).  320 bits == enough for a
# 12-byte (96-bit) IPv4 4-tuple input window.
DEFAULT_RSS_KEY = bytes(
    [
        0x6D, 0x5A, 0x56, 0xDA, 0x25, 0x5B, 0x0E, 0xC2,
        0x41, 0x67, 0x25, 0x3D, 0x43, 0xA3, 0x8F, 0xB0,
        0xD0, 0xCA, 0x2B, 0xCB, 0xAE, 0x7B, 0x30, 0xB4,
        0x77, 0xCB, 0x2D, 0xA3, 0x80, 0x30, 0xF2, 0x0C,
        0x6A, 0x42, 0xB7, 0x3B, 0xBE, 0xAC, 0x01, 0xFA,
    ]
)

FLOW_TUPLE_BYTES = 12  # src_ip(4) + dst_ip(4) + src_port(2) + dst_port(2)
DEFAULT_TABLE_SIZE = 128


def _key_windows(key: bytes, n_input_bits: int) -> np.ndarray:
    """Precompute the 32-bit key window for every input bit position.

    Toeplitz: hash = XOR over set input bits i of key[i .. i+31].  With the
    windows precomputed the per-burst cost is one unpackbits + one masked
    XOR-reduction.
    """
    total_bits = len(key) * 8
    if n_input_bits + 32 > total_bits:
        raise ValueError("RSS key too short for input width")
    k = int.from_bytes(key, "big")
    out = np.empty(n_input_bits, dtype=np.uint32)
    for i in range(n_input_bits):
        out[i] = (k >> (total_bits - 32 - i)) & 0xFFFFFFFF
    return out


def _key_byte_tables(windows: np.ndarray) -> List[List[int]]:
    """Per-(byte position, byte value) XOR contributions to the Toeplitz hash.

    tables[p][v] == XOR of the key windows for the set bits of value ``v`` at
    byte position ``p``.  With these, hashing one 12-byte tuple is 12 plain
    list lookups — no numpy temporaries, which is what the single-packet
    delivery hot path needs (burst paths keep the vectorized route).
    """
    tables: List[List[int]] = []
    for p in range(len(windows) // 8):
        w = windows[p * 8 : (p + 1) * 8]
        row = [0] * 256
        for v in range(256):
            h = 0
            for bit in range(8):
                if v & (0x80 >> bit):
                    h ^= int(w[bit])
            row[v] = h
        tables.append(row)
    return tables


_WINDOWS = _key_windows(DEFAULT_RSS_KEY, FLOW_TUPLE_BYTES * 8)
_BYTE_TABLES = _key_byte_tables(_WINDOWS)


def _hash_with_windows(flow_bytes: np.ndarray, windows: np.ndarray) -> np.ndarray:
    fb = np.ascontiguousarray(flow_bytes, dtype=np.uint8)
    if fb.ndim == 1:
        fb = fb.reshape(1, -1)
    if fb.shape[1] != FLOW_TUPLE_BYTES:
        raise ValueError(f"flow tuple must be {FLOW_TUPLE_BYTES} bytes")
    bits = np.unpackbits(fb, axis=1).astype(bool)  # (N, 96), MSB-first
    masked = np.where(bits, windows[None, :], np.uint32(0))
    return np.bitwise_xor.reduce(masked, axis=1)


def toeplitz_hash_vec(flow_bytes: np.ndarray, key: Optional[bytes] = None) -> np.ndarray:
    """Toeplitz hash of a burst of flow tuples.

    ``flow_bytes`` is an (N, 12) uint8 array of big-endian 4-tuples
    (src_ip, dst_ip, src_port, dst_port).  Returns (N,) uint32 hashes.
    """
    windows = _WINDOWS if key is None else _key_windows(key, FLOW_TUPLE_BYTES * 8)
    return _hash_with_windows(flow_bytes, windows)


def toeplitz_hash(flow_bytes: np.ndarray, key: Optional[bytes] = None) -> int:
    """Scalar convenience wrapper: hash one 12-byte flow tuple."""
    return int(toeplitz_hash_vec(flow_bytes, key)[0])


class RssIndirection:
    """Hash → queue steering via a software-writable indirection table.

    The default table round-robins queues across its entries, which is what
    drivers program at init; ``rebalance`` rewrites entries to shift load
    (the knob flow-director scenarios build on).
    """

    def __init__(
        self,
        n_queues: int,
        table_size: int = DEFAULT_TABLE_SIZE,
        key: Optional[bytes] = None,
    ):
        if n_queues < 1:
            raise ValueError("n_queues must be >= 1")
        if table_size < n_queues:
            raise ValueError("table_size must be >= n_queues")
        self.n_queues = int(n_queues)
        self.key = DEFAULT_RSS_KEY if key is None else key
        # key windows precomputed once — steering is on the per-burst hot path
        self._windows = (_WINDOWS if key is None
                         else _key_windows(key, FLOW_TUPLE_BYTES * 8))
        # per-byte lookup tables for the scalar (single-packet) path
        self._byte_tables = (_BYTE_TABLES if key is None
                             else _key_byte_tables(self._windows))
        self.table = (np.arange(table_size) % n_queues).astype(np.int32)
        self._table_list: List[int] = self.table.tolist()

    def steer(self, flow_bytes: np.ndarray) -> np.ndarray:
        """Map a burst of (N, 12) flow tuples to (N,) queue indices."""
        hashes = _hash_with_windows(flow_bytes, self._windows)
        return self.table[hashes % np.uint32(len(self.table))]

    def hash_one(self, flow_bytes: np.ndarray) -> int:
        """Scalar Toeplitz hash of one 12-byte flow tuple.

        Allocation-free: 12 table lookups, for the per-frame delivery path
        (:meth:`repro_torch.core.pmd.Port.deliver`).  Matches
        :func:`toeplitz_hash_vec` bit for bit.
        """
        if len(flow_bytes) != FLOW_TUPLE_BYTES:
            raise ValueError(f"flow tuple must be {FLOW_TUPLE_BYTES} bytes")
        tables = self._byte_tables
        h = 0
        for p in range(FLOW_TUPLE_BYTES):
            h ^= tables[p][flow_bytes[p]]
        return h

    def steer_one(self, flow_bytes: np.ndarray) -> int:
        """Scalar steering: one 12-byte flow tuple → queue index, without the
        per-packet numpy temporaries of the burst path."""
        fb = flow_bytes.reshape(-1) if flow_bytes.ndim > 1 else flow_bytes
        return self._table_list[self.hash_one(fb) % len(self._table_list)]

    def rebalance(self, entries: Sequence[int]) -> None:
        """Reprogram the indirection table (driver-style rebalancing)."""
        table = np.asarray(entries, dtype=np.int32)
        if table.ndim != 1 or len(table) < self.n_queues:
            raise ValueError("table must be 1-D with >= n_queues entries")
        if (table < 0).any() or (table >= self.n_queues).any():
            raise ValueError("table entries must name valid queues")
        self.table = table.copy()
        self._table_list = self.table.tolist()
