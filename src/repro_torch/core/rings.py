"""Single-producer/single-consumer object ring (own copy of the reference's
``SpscRing``, ``src/repro/core/rings.py:24``, the DPDK ``rte_ring``
analogue).

Power-of-two capacity, monotonically increasing head/tail cursors, masked
indexing. Under CPython's GIL the single-word cursor updates are atomic, so
one producer thread and one consumer thread share a ring without locks. The
dataplane's producer ports stage host batches through one ring each.
"""
from __future__ import annotations

from typing import Any, List, Optional


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class SpscRing:
    """Lock-free (1P/1C) object ring: the part of the reference's ring the
    dataplane uses (single-item push and pop)."""

    __slots__ = ("_slots", "_mask", "_cap", "_head", "_tail")

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        cap = _round_up_pow2(capacity)
        self._slots: List[Any] = [None] * cap
        self._mask = cap - 1
        self._cap = cap
        self._head = 0  # producer cursor (next write)
        self._tail = 0  # consumer cursor (next read)

    def is_empty(self) -> bool:
        return self._head == self._tail

    # -- producer side --------------------------------------------------------
    def try_push(self, item: Any) -> bool:
        head = self._head
        if head - self._tail >= self._cap:
            return False
        self._slots[head & self._mask] = item
        self._head = head + 1  # publish
        return True

    # -- consumer side ---------------------------------------------------------
    def try_pop(self) -> Optional[Any]:
        tail = self._tail
        if tail == self._head:
            return None
        item = self._slots[tail & self._mask]
        self._slots[tail & self._mask] = None
        self._tail = tail + 1
        return item
