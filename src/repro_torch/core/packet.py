"""Packet representation over a pre-pinned buffer arena.

This is the DPDK ``rte_mbuf`` / hugepage-mempool analogue: all packet payloads
live in one contiguous, pre-allocated numpy arena ("pinned hugepages"); a packet
is just (slot index, length) plus zero-copy views into the arena.  The
interrupt-driven baseline (:mod:`repro_torch.core.kernel_stack`) deliberately does NOT
use the pool — it allocates and copies per packet, like sk_buffs.

Wire layout (offsets in bytes), loosely Ethernet-shaped:

    0..5    dst "mac"
    6..11   src "mac"
    12..13  ethertype (we use 0x88B5, local experimental; bit 0 of byte 12
            doubles as the ECN CE mark — see ``set_ce``/``read_ce``)
    14..21  u64 sequence number (little endian)
    22..29  u64 transmit timestamp in ns (the EtherLoadGen stamp; offset is
            configurable per the paper — "adds a timestamp to each outgoing
            packet at a configurable offset")
    30..41  flow 4-tuple, big endian (src_ip u32, dst_ip u32, src_port u16,
            dst_port u16) — the fields RSS hashes to steer the frame to an
            RX queue (see :mod:`repro_torch.core.rss`)
    42..    payload

Own copy, in the PyTorch port, of ``src/repro/core/packet.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

ETH_HEADER_SIZE = 14
SEQ_OFFSET = 14
DEFAULT_TS_OFFSET = 22
FLOW_OFFSET = 30
FLOW_SIZE = 12  # src_ip(4) + dst_ip(4) + src_port(2) + dst_port(2), big endian
MIN_FRAME = 64
DEFAULT_MTU = 1518
ETHERTYPE = 0x88B5

# ECN congestion-experienced mark: bit 0 of the ethertype high byte (0x88 is
# even, so the bit is born clear).  The location is deliberate — outside the
# seq/ts/flow fields the loadgen and echo servers rewrite, untouched by
# ``swap_macs(_vec)``/``swap_flow_ips(_vec)``, and excluded from both
# ``payload_checksum`` and ``echo_payload_checksum`` — so a switch-applied
# mark survives the full echo round-trip back to the client that sent it.
CE_OFFSET = 12
CE_MASK = 0x01


def _u64_to_bytes(value: int) -> np.ndarray:
    return np.frombuffer(int(value).to_bytes(8, "little"), dtype=np.uint8).copy()


def _bytes_to_u64(buf: np.ndarray) -> int:
    return int.from_bytes(bytes(buf[:8]), "little")


class PacketPool:
    """Pre-pinned fixed-slot packet arena + free list (DPDK mempool analogue).

    ``alloc``/``free`` never touch the allocator after construction; payload
    access is by zero-copy numpy views.  Single lock-free-under-GIL free ring.
    """

    def __init__(self, n_slots: int, slot_size: int = DEFAULT_MTU):
        if n_slots <= 0:
            raise ValueError("n_slots must be positive")
        self.n_slots = int(n_slots)
        self.slot_size = int(slot_size)
        self.arena = np.zeros((self.n_slots, self.slot_size), dtype=np.uint8)
        self.lengths = np.zeros(self.n_slots, dtype=np.int32)
        # free list as a ring of slot indices; head==push cursor, tail==pop cursor
        self._free = list(range(self.n_slots - 1, -1, -1))
        self.alloc_failures = 0

    # -- allocation ---------------------------------------------------------
    def alloc(self) -> Optional[int]:
        if not self._free:
            self.alloc_failures += 1
            return None
        return self._free.pop()

    def alloc_burst(self, n: int) -> List[int]:
        take = min(n, len(self._free))
        if take < n:
            self.alloc_failures += n - take
        if take == 0:
            return []
        out = self._free[-take:][::-1]
        del self._free[-take:]
        return out

    def free(self, slot: int) -> None:
        self._free.append(slot)

    def free_burst(self, slots: Sequence[int]) -> None:
        self._free.extend(slots)

    @property
    def n_free(self) -> int:
        return len(self._free)

    # -- packet access ------------------------------------------------------
    def view(self, slot: int, length: Optional[int] = None) -> np.ndarray:
        """Zero-copy view of a packet's bytes."""
        n = self.lengths[slot] if length is None else length
        return self.arena[slot, : int(n)]

    def write_packet(
        self,
        slot: int,
        *,
        seq: int,
        length: int,
        ts_offset: int = DEFAULT_TS_OFFSET,
        timestamp_ns: int = 0,
        fill: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        """Format a frame in-place (header + seq + timestamp + payload)."""
        if length < MIN_FRAME or length > self.slot_size:
            raise ValueError(f"bad frame length {length}")
        buf = self.arena[slot]
        buf[0:6] = 0xFF  # broadcast dst
        buf[6:12] = 0xAB  # loadgen src
        buf[12] = (ETHERTYPE >> 8) & 0xFF
        buf[13] = ETHERTYPE & 0xFF
        buf[SEQ_OFFSET : SEQ_OFFSET + 8] = _u64_to_bytes(seq)
        payload_start = ts_offset + 8
        if rng is not None:
            buf[payload_start:length] = rng.integers(
                0, 256, size=max(0, length - payload_start), dtype=np.uint8
            )
        elif fill is not None:
            buf[payload_start:length] = fill
        stamp(buf, ts_offset, timestamp_ns)
        self.lengths[slot] = length


# -- header/field helpers (operate on raw views) ----------------------------

def stamp(buf: np.ndarray, ts_offset: int, ns: int) -> None:
    buf[ts_offset : ts_offset + 8] = _u64_to_bytes(ns)


def read_stamp(buf: np.ndarray, ts_offset: int) -> int:
    return _bytes_to_u64(buf[ts_offset : ts_offset + 8])


def read_seq(buf: np.ndarray) -> int:
    return _bytes_to_u64(buf[SEQ_OFFSET : SEQ_OFFSET + 8])


def write_seq(buf: np.ndarray, seq: int) -> None:
    buf[SEQ_OFFSET : SEQ_OFFSET + 8] = _u64_to_bytes(seq)


def set_ce(buf: np.ndarray) -> None:
    """Mark a frame congestion-experienced (the ECN-marking switch op)."""
    buf[CE_OFFSET] |= CE_MASK


def clear_ce(buf: np.ndarray) -> None:
    buf[CE_OFFSET] &= 0xFF ^ CE_MASK


def read_ce(buf: np.ndarray) -> bool:
    """True iff the frame carries the congestion-experienced mark."""
    return bool(buf[CE_OFFSET] & CE_MASK)


def swap_macs(buf: np.ndarray) -> None:
    """The L2Fwd operation: swap src/dst 'mac' addresses in place."""
    tmp = buf[0:6].copy()
    buf[0:6] = buf[6:12]
    buf[6:12] = tmp


DEFAULT_SRC_IP_BASE = 0x0A000000  # 10.0.0.0: the loadgen's client space
DEFAULT_DST_IP = 0xC0A80001       # 192.168.0.1: the single-host server


def flow_tuple_for_id(
    flow_id: int,
    src_ip_base: Optional[int] = None,
    dst_ip: Optional[int] = None,
) -> Tuple[int, int, int, int]:
    """Synthetic (src_ip, dst_ip, src_port, dst_port) for an abstract flow id.

    Distinct ids differ in src_ip and src_port — the fields real load
    generators sweep — so distinct flows hash apart under RSS.  Topology
    scenarios override ``src_ip_base`` (a per-generator /16 such as
    ``10.g.0.0``, so a switch can route replies back to the right client)
    and ``dst_ip`` (the target node's address, what the switch forwards on).
    """
    flow_id = int(flow_id)
    base = DEFAULT_SRC_IP_BASE if src_ip_base is None else int(src_ip_base)
    src_ip = base | (flow_id & 0xFFFF)
    src_port = 1024 + (flow_id % 60000)
    dst_port = 443
    return (src_ip,
            DEFAULT_DST_IP if dst_ip is None else int(dst_ip),
            src_port, dst_port)


def write_flow(buf: np.ndarray, src_ip: int, dst_ip: int,
               src_port: int, dst_port: int) -> None:
    """Write the RSS flow 4-tuple (big endian, like the wire)."""
    raw = (int(src_ip).to_bytes(4, "big") + int(dst_ip).to_bytes(4, "big")
           + int(src_port).to_bytes(2, "big") + int(dst_port).to_bytes(2, "big"))
    buf[FLOW_OFFSET : FLOW_OFFSET + FLOW_SIZE] = np.frombuffer(raw, dtype=np.uint8)


def read_flow(buf: np.ndarray) -> Tuple[int, int, int, int]:
    raw = bytes(buf[FLOW_OFFSET : FLOW_OFFSET + FLOW_SIZE])
    return (
        int.from_bytes(raw[0:4], "big"),
        int.from_bytes(raw[4:8], "big"),
        int.from_bytes(raw[8:10], "big"),
        int.from_bytes(raw[10:12], "big"),
    )


def flow_bytes(buf: np.ndarray) -> np.ndarray:
    """Zero-copy view of the 12 flow-tuple bytes (the RSS hash input)."""
    return buf[FLOW_OFFSET : FLOW_OFFSET + FLOW_SIZE]


def read_dst_ip(buf: np.ndarray) -> int:
    """The frame's destination address (flow dst_ip, big endian) — the field
    a :class:`~repro_torch.core.switch.Switch` forwards on."""
    return int.from_bytes(bytes(buf[FLOW_OFFSET + 4 : FLOW_OFFSET + 8]), "big")


def swap_flow_ips(buf: np.ndarray) -> None:
    """Swap the flow src/dst IPs in place — the reply-addressing half of an
    echo server (pairs :func:`swap_macs`), so switched topologies can route
    the reply back to the client that sent the request."""
    tmp = buf[FLOW_OFFSET : FLOW_OFFSET + 4].copy()
    buf[FLOW_OFFSET : FLOW_OFFSET + 4] = buf[FLOW_OFFSET + 4 : FLOW_OFFSET + 8]
    buf[FLOW_OFFSET + 4 : FLOW_OFFSET + 8] = tmp


def l2fwd_echo(buf: np.ndarray) -> None:
    """The topology-aware L2Fwd transform: swap macs AND flow IPs, so the
    forwarded frame is addressed back to its sender."""
    swap_macs(buf)
    swap_flow_ips(buf)


def checksum(buf: np.ndarray) -> int:
    """CRC32 over the whole frame (payload-integrity check, paper §4.2)."""
    return zlib.crc32(buf.tobytes()) & 0xFFFFFFFF


def payload_checksum(buf: np.ndarray, ts_offset: int = DEFAULT_TS_OFFSET) -> int:
    """CRC32 over payload only (excludes header/seq/timestamp, which L2Fwd and
    the loadgen legitimately rewrite)."""
    return zlib.crc32(buf[ts_offset + 8 :].tobytes()) & 0xFFFFFFFF


def echo_payload_checksum(buf: np.ndarray) -> int:
    """CRC32 over payload past the flow tuple — the integrity check for
    switched topologies, where the echo server legitimately rewrites the
    flow IPs (:func:`swap_flow_ips`) in addition to header/seq/timestamp."""
    return zlib.crc32(buf[FLOW_OFFSET + FLOW_SIZE :].tobytes()) & 0xFFFFFFFF


# -- vectorized burst helpers (DPDK-style amortization) ---------------------
#
# DPDK's performance comes from amortizing *everything* over a burst: one
# descriptor-ring sweep, one prefetch train, one header rewrite loop that the
# compiler vectorizes.  The Python analogue is doing each burst operation as a
# single fancy-indexed numpy op over the shared arena instead of a per-packet
# interpreter loop.  The kernel-stack baseline cannot do this: its per-packet
# skb alloc/copy/syscall structure is the bottleneck being modeled.

def write_packets_vec(
    pool: PacketPool,
    slots: np.ndarray,
    seqs: np.ndarray,
    length: int,
    ts_offset: int,
    timestamp_ns: int,
) -> None:
    """Format a burst of identical-size frames in one shot."""
    arena = pool.arena
    arena[slots, 0:6] = 0xFF
    arena[slots, 6:12] = 0xAB
    arena[slots, 12] = (ETHERTYPE >> 8) & 0xFF
    arena[slots, 13] = ETHERTYPE & 0xFF
    arena[slots, SEQ_OFFSET : SEQ_OFFSET + 8] = (
        seqs.astype("<u8").view(np.uint8).reshape(-1, 8)
    )
    ts = np.full(len(slots), timestamp_ns, dtype="<u8")
    arena[slots, ts_offset : ts_offset + 8] = ts.view(np.uint8).reshape(-1, 8)
    payload_start = ts_offset + 8
    arena[slots, payload_start:length] = (
        (seqs & 0xFF).astype(np.uint8)[:, None]
    )
    pool.lengths[slots] = length


def read_stamps_vec(pool: PacketPool, slots: np.ndarray, ts_offset: int) -> np.ndarray:
    """Read a burst of timestamps → int64 ns array."""
    raw = pool.arena[slots, ts_offset : ts_offset + 8]
    return raw.copy().view("<u8").reshape(-1).astype(np.int64)


def read_seqs_vec(pool: PacketPool, slots: np.ndarray) -> np.ndarray:
    raw = pool.arena[slots, SEQ_OFFSET : SEQ_OFFSET + 8]
    return raw.copy().view("<u8").reshape(-1).astype(np.int64)


def write_flow_ids_vec(pool: PacketPool, slots: np.ndarray,
                       flow_ids: np.ndarray,
                       src_ip_base: Optional[int] = None,
                       dst_ip: Optional[int] = None) -> None:
    """Write synthetic flow 4-tuples for a burst (one fancy-indexed store).

    Same mapping as :func:`flow_tuple_for_id` (including its topology
    ``src_ip_base``/``dst_ip`` overrides), vectorized over the burst.
    """
    arena = pool.arena
    ids = flow_ids.astype(np.int64)
    base = DEFAULT_SRC_IP_BASE if src_ip_base is None else int(src_ip_base)
    src_ip = (base | (ids & 0xFFFF)).astype(">u4")
    dst_ip = np.full(len(ids),
                     DEFAULT_DST_IP if dst_ip is None else int(dst_ip),
                     dtype=">u4")
    src_port = (1024 + (ids % 60000)).astype(">u2")
    dst_port = np.full(len(ids), 443, dtype=">u2")
    arena[slots, FLOW_OFFSET : FLOW_OFFSET + 4] = src_ip.view(np.uint8).reshape(-1, 4)
    arena[slots, FLOW_OFFSET + 4 : FLOW_OFFSET + 8] = dst_ip.view(np.uint8).reshape(-1, 4)
    arena[slots, FLOW_OFFSET + 8 : FLOW_OFFSET + 10] = src_port.view(np.uint8).reshape(-1, 2)
    arena[slots, FLOW_OFFSET + 10 : FLOW_OFFSET + 12] = dst_port.view(np.uint8).reshape(-1, 2)


def read_flow_bytes_vec(pool: PacketPool, slots: np.ndarray) -> np.ndarray:
    """(N, 12) raw flow-tuple bytes for a burst — the RSS hash input."""
    return pool.arena[slots, FLOW_OFFSET : FLOW_OFFSET + FLOW_SIZE]


def read_flow_bytes(pool: PacketPool, slot: int) -> np.ndarray:
    """(12,) flow-tuple bytes of one packet, as a zero-copy view.

    The scalar sibling of :func:`read_flow_bytes_vec`: basic slicing of the
    arena row allocates no array data, which is what the single-packet
    delivery hot path (:meth:`repro_torch.core.pmd.Port.deliver`) needs.
    """
    return pool.arena[slot, FLOW_OFFSET : FLOW_OFFSET + FLOW_SIZE]


def set_ce_vec(pool: PacketPool, slots: np.ndarray) -> None:
    """Burst variant of :func:`set_ce`."""
    pool.arena[slots, CE_OFFSET] |= CE_MASK


def read_ce_vec(pool: PacketPool, slots: np.ndarray) -> np.ndarray:
    """Burst variant of :func:`read_ce` — boolean array over the burst."""
    return (pool.arena[slots, CE_OFFSET] & CE_MASK) != 0


def swap_macs_vec(pool: PacketPool, slots: np.ndarray,
                  lengths: Optional[np.ndarray] = None) -> None:
    """L2Fwd header rewrite for a whole burst in one vectorized op."""
    arena = pool.arena
    dst = arena[slots, 0:6].copy()
    arena[slots, 0:6] = arena[slots, 6:12]
    arena[slots, 6:12] = dst


def swap_flow_ips_vec(pool: PacketPool, slots: np.ndarray,
                      lengths: Optional[np.ndarray] = None) -> None:
    """Burst variant of :func:`swap_flow_ips`."""
    arena = pool.arena
    src = arena[slots, FLOW_OFFSET : FLOW_OFFSET + 4].copy()
    arena[slots, FLOW_OFFSET : FLOW_OFFSET + 4] = (
        arena[slots, FLOW_OFFSET + 4 : FLOW_OFFSET + 8])
    arena[slots, FLOW_OFFSET + 4 : FLOW_OFFSET + 8] = src


def l2fwd_echo_vec(pool: PacketPool, slots: np.ndarray,
                   lengths: Optional[np.ndarray] = None) -> None:
    """Burst variant of :func:`l2fwd_echo` (macs + flow IPs swapped)."""
    swap_macs_vec(pool, slots, lengths)
    swap_flow_ips_vec(pool, slots, lengths)


@dataclass
class PacketRef:
    """A packet in flight = (pool, slot, length). Zero-copy handle."""

    pool: PacketPool
    slot: int
    length: int

    @property
    def buf(self) -> np.ndarray:
        return self.pool.view(self.slot, self.length)

    def release(self) -> None:
        self.pool.free(self.slot)
