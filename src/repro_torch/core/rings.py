"""Single-producer/single-consumer rings (DPDK ``rte_ring`` analogue).

Power-of-two capacity, monotonically increasing head/tail cursors, masked
indexing.  Under CPython's GIL, the single-word cursor updates are atomic, so
one producer thread and one consumer thread can share a ring without locks —
the same discipline DPDK's SPSC ring uses with store-release/load-acquire.

Used for: (a) pipeline-mode stage hand-off (paper §2 "Pipeline mode ... cores
pass packets between each other via a ring buffer"), (b) descriptor transport
between the loadgen and the device under test.

Own copy, in the PyTorch port, of ``src/repro/core/rings.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class SpscRing:
    """Lock-free (1P/1C) object ring."""

    __slots__ = ("_slots", "_mask", "_cap", "_head", "_tail", "enq_drops")

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        cap = _round_up_pow2(capacity)
        self._slots: List[Any] = [None] * cap
        self._mask = cap - 1
        self._cap = cap
        self._head = 0  # producer cursor (next write)
        self._tail = 0  # consumer cursor (next read)
        self.enq_drops = 0  # producer-side drops on full ring

    # -- capacity ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._cap

    def __len__(self) -> int:
        return self._head - self._tail

    @property
    def free_space(self) -> int:
        return self._cap - (self._head - self._tail)

    def is_empty(self) -> bool:
        return self._head == self._tail

    def is_full(self) -> bool:
        return self._head - self._tail >= self._cap

    # -- producer side --------------------------------------------------------
    def try_push(self, item: Any) -> bool:
        head = self._head
        if head - self._tail >= self._cap:
            self.enq_drops += 1
            return False
        self._slots[head & self._mask] = item
        self._head = head + 1  # publish
        return True

    def push_burst(self, items: Sequence[Any]) -> int:
        """Enqueue up to len(items); returns number enqueued (rest dropped)."""
        head = self._head
        space = self._cap - (head - self._tail)
        take = min(len(items), space)
        mask = self._mask
        slots = self._slots
        for i in range(take):
            slots[(head + i) & mask] = items[i]
        self._head = head + take
        self.enq_drops += len(items) - take
        return take

    # -- consumer side ---------------------------------------------------------
    def try_pop(self) -> Optional[Any]:
        tail = self._tail
        if tail == self._head:
            return None
        item = self._slots[tail & self._mask]
        self._slots[tail & self._mask] = None
        self._tail = tail + 1
        return item

    def pop_burst(self, max_n: int) -> List[Any]:
        tail = self._tail
        avail = self._head - tail
        take = min(max_n, avail)
        mask = self._mask
        slots = self._slots
        out = []
        for i in range(take):
            idx = (tail + i) & mask
            out.append(slots[idx])
            slots[idx] = None
        self._tail = tail + take
        return out
