"""NIC descriptor rings with an on-NIC descriptor cache and a configurable
writeback threshold — the paper's §3.1.4 contribution.

A real NIC holds a handful of completed RX descriptors in an on-chip
*descriptor cache* and writes them back (DMA) to host memory in groups.  The
paper found that gem5's model, when driven by a polling-mode driver, only wrote
descriptors back once the *entire* ring was used — DMA-ing packets to memory in
pathological 32–64-packet batches, hammering the memory subsystem and causing
drops.  Their fix: expose the writeback threshold as a parameter.

We model exactly that:

* ``nic_deliver`` — the "NIC" places a received frame into a descriptor; the
  completion is buffered in the descriptor cache.
* the cache is *written back* (status published to the consumer-visible array)
  when ``writeback_threshold`` completions have accumulated (one writeback
  **per threshold crossing** — a 256-frame burst at threshold 32 is eight
  32-descriptor DMAs, not one 256-descriptor DMA), when the ring becomes
  full, on an explicit ``flush``, or — with a scheduler attached via
  :meth:`RxDescriptorRing.attach_scheduler` — when the **writeback timeout**
  fires (the ITR analogue: an idle timer armed by the first completion that
  enters an empty cache, cancelled when a threshold/full/flush writeback
  empties it).
* ``poll`` / ``poll_burst`` — the PMD side harvests *written-back*
  descriptors without blocking; completions still sitting in the descriptor
  cache are invisible (``done_count`` is the PMD-visible backlog).

``writeback_threshold=None`` reproduces the pathological pre-fix behaviour
(writeback only when all descriptors are used).  Small thresholds reproduce the
paper's fix and are what the DCA burst study (Fig. 4) sweeps.

Own copy, in the PyTorch port, of ``src/repro/core/descriptor.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

STATUS_FREE = 0  # descriptor available to the NIC
STATUS_DONE = 1  # written back; visible to the PMD/driver

_EMPTY_I64 = np.empty(0, dtype=np.int64)
_EMPTY_I32 = np.empty(0, dtype=np.int32)


class RxDescriptorRing:
    def __init__(self, size: int, writeback_threshold: Optional[int] = None,
                 queue_id: int = 0):
        if size <= 0:
            raise ValueError("size must be positive")
        if writeback_threshold is not None and not (1 <= writeback_threshold <= size):
            raise ValueError("writeback_threshold must be in [1, size]")
        self.size = int(size)
        self.queue_id = int(queue_id)  # which HW queue of the port this is
        # None == pathological "writeback only when all descriptors used"
        self.writeback_threshold = writeback_threshold
        self.slots = np.full(self.size, -1, dtype=np.int64)  # packet slot index
        self.lengths = np.zeros(self.size, dtype=np.int32)
        self.status = np.full(self.size, STATUS_FREE, dtype=np.uint8)
        self.head = 0  # NIC cursor (next descriptor the NIC fills)
        self.tail = 0  # driver cursor (next descriptor the PMD inspects)
        self.published = 0  # cursor: total completions written back (DONE)
        self._cached = 0  # completions sitting in the descriptor cache
        # writeback-timeout timer (ITR analogue); armed only when a
        # scheduler is attached (virtual-time mode)
        self._sched = None            # EventScheduler, via attach_scheduler
        self._timeout_ns = 0
        self._timer: Optional[int] = None  # pending timer token
        # modeled writeback DMA latency: with a scheduler attached and
        # _dma_ns > 0, a threshold crossing *starts* a DMA and the
        # descriptors only become PMD-visible _dma_ns later (0 == the legacy
        # instantaneous publish, bit-identical to pre-DMA reports)
        self._dma_ns = 0
        self._dma_pending = 0         # descriptors in DMA flight
        self._dma_tokens: List[object] = []  # cancellable completion events
        # stats
        self.delivered = 0
        self.delivered_bytes = 0
        self.dropped = 0
        self.writebacks = 0  # number of writeback *events* (DMA bursts)
        self.writeback_sizes: List[int] = []  # burst size of each writeback
        self.timeout_flushes = 0  # writebacks forced by the idle timer

    # -- invariant helpers ----------------------------------------------------
    @property
    def in_flight(self) -> int:
        """Descriptors owned by NIC-or-cache-or-consumer (not yet polled)."""
        return self.head - self.tail

    @property
    def free_descriptors(self) -> int:
        return self.size - self.in_flight

    @property
    def done_count(self) -> int:
        """Written-back, not-yet-harvested descriptors — what the PMD can
        see *right now* (completions still in the descriptor cache are
        invisible until a writeback publishes them)."""
        return self.published - self.tail

    def _effective_threshold(self) -> int:
        return self.size if self.writeback_threshold is None else self.writeback_threshold

    # -- writeback timeout (ITR analogue) --------------------------------------
    def attach_scheduler(self, sched, timeout_ns: int,
                         writeback_dma_ns: int = 0) -> "RxDescriptorRing":
        """Enable the descriptor-cache **writeback timeout** on this ring.

        With a scheduler attached, a completion entering an empty cache arms
        an idle timer ``timeout_ns`` in the future; if no threshold/full
        writeback empties the cache before it fires, the timer flushes the
        cached completions (one timeout writeback).  This is the interrupt-
        throttling (ITR) analogue the paper's §3.1.4 discussion calls for:
        it bounds the worst-case time a frame sits PMD-invisible.

        ``writeback_dma_ns`` models the DMA transfer itself: a writeback
        *starts* when the threshold crosses (or the timer fires) but its
        descriptors only become PMD-visible ``writeback_dma_ns`` later, as a
        scheduler event.  The default 0 keeps the legacy instantaneous
        publish, bit-identical to pre-DMA reports.
        """
        if timeout_ns < 0:
            raise ValueError("timeout_ns must be >= 0")
        if writeback_dma_ns < 0:
            raise ValueError("writeback_dma_ns must be >= 0")
        self._sched = sched
        self._timeout_ns = int(timeout_ns)
        self._dma_ns = int(writeback_dma_ns)
        self._update_timer()
        return self

    def _on_timeout(self) -> None:
        self._timer = None
        if self._cached > 0:
            self.timeout_flushes += 1
            self._writeback_n(self._cached)
        self._update_timer()

    def _update_timer(self) -> None:
        """Arm the idle timer when completions wait in an empty-timer cache;
        cancel it when a writeback has emptied the cache."""
        if self._sched is None or self._timeout_ns <= 0:
            return
        if self._cached > 0 and self._timer is None:
            self._timer = self._sched.schedule_in(self._timeout_ns,
                                                  self._on_timeout)
        elif self._cached == 0 and self._timer is not None:
            self._sched.cancel(self._timer)
            self._timer = None

    # -- NIC side ---------------------------------------------------------------
    def nic_deliver(self, packet_slot: int, length: int) -> bool:
        """NIC receives a frame. Returns False (drop) if no free descriptor."""
        if self.in_flight >= self.size:
            self.dropped += 1
            return False
        idx = self.head % self.size
        self.slots[idx] = packet_slot
        self.lengths[idx] = length
        self.head += 1
        self._cached += 1
        self.delivered += 1
        self.delivered_bytes += int(length)
        if self._cached >= self._effective_threshold() or self.in_flight >= self.size:
            self._writeback()
        self._update_timer()
        return True

    def nic_deliver_burst(self, packet_slots: np.ndarray, lengths: np.ndarray) -> int:
        """Vectorized delivery of a frame burst. Returns #accepted (rest drop).

        Writeback semantics match the per-packet path exactly: one DMA burst
        of ``writeback_threshold`` descriptors per threshold *crossing* (a
        256-frame burst at threshold 32 records eight 32-descriptor
        writebacks), plus a final flush of the remainder if the ring filled.
        ``writeback_sizes`` is the quantity the paper's Fig. 4 studies — the
        vectorized path must not coarsen it.
        """
        n = len(packet_slots)
        space = self.size - self.in_flight
        take = min(n, space)
        if take > 0:
            idx = (self.head + np.arange(take)) % self.size
            self.slots[idx] = packet_slots[:take]
            self.lengths[idx] = lengths[:take]
            self.head += take
            self._cached += take
            self.delivered += take
            self.delivered_bytes += int(lengths[:take].sum(dtype=np.int64))
        self.dropped += n - take
        thr = self._effective_threshold()
        while self._cached >= thr:
            self._writeback_n(thr)
        if self.in_flight >= self.size:
            self._writeback()
        self._update_timer()
        return take

    def _writeback_n(self, k: int) -> None:
        """Start a writeback of the ``k`` oldest cached completions — one DMA
        burst of descriptor writebacks (the quantity the paper's Fig. 4 shows
        stressing the cache hierarchy when too large).  With a modeled DMA
        latency the publish happens ``_dma_ns`` later; otherwise it is
        immediate."""
        if k <= 0:
            return
        # the k oldest cached descriptors start right after everything that
        # has already been published or put in DMA flight:
        # published + _dma_pending + _cached == head always holds
        start = self.head - self._cached
        idx = (start + np.arange(k)) % self.size
        self._cached -= k
        if self._sched is not None and self._dma_ns > 0:
            self._dma_pending += k
            self._dma_tokens.append(
                self._sched.schedule_in(self._dma_ns,
                                        lambda: self._dma_complete(idx, k)))
            return
        self._publish(idx, k)

    def _publish(self, idx: np.ndarray, k: int) -> None:
        """Make ``k`` descriptors PMD-visible and record the DMA burst."""
        self.status[idx] = STATUS_DONE
        self.writebacks += 1
        self.writeback_sizes.append(k)
        self.published += k

    def _dma_complete(self, idx: np.ndarray, k: int) -> None:
        """A writeback DMA lands: its descriptors become PMD-visible.
        Equal-delay FIFO scheduling means completions land in start order,
        so the DONE run from ``tail`` stays contiguous."""
        if self._dma_tokens:
            self._dma_tokens.pop(0)
        self._dma_pending -= k
        self._publish(idx, k)

    def _writeback(self) -> None:
        """Publish every cached completion in one DMA burst."""
        self._writeback_n(self._cached)

    def flush(self) -> None:
        """Explicit full writeback (a stopping NIC publishes its cache; the
        pre-timer event loops also call this on a quiet wire).  Idempotent:
        an empty cache records no writeback event.

        Synchronous by contract even with a modeled DMA latency — closed-loop
        drivers flush without pumping the scheduler, so in-flight DMAs are
        cancelled and their descriptors published immediately (one burst)."""
        if self._dma_pending > 0:
            for tok in self._dma_tokens:
                self._sched.cancel(tok)
            self._dma_tokens.clear()
            k = self._dma_pending
            start = self.head - self._cached - k
            idx = (start + np.arange(k)) % self.size
            self._dma_pending = 0
            self._publish(idx, k)
        self._writeback()
        self._update_timer()

    # -- PMD / driver side --------------------------------------------------------
    def poll(self, max_n: int) -> List[Tuple[int, int]]:
        """Harvest up to ``max_n`` completed descriptors. Non-blocking.

        Returns [(packet_slot, length), ...] and recycles the descriptors.
        """
        out: List[Tuple[int, int]] = []
        while len(out) < max_n and self.tail < self.head:
            idx = self.tail % self.size
            if self.status[idx] != STATUS_DONE:
                break  # still in the descriptor cache — not yet written back
            out.append((int(self.slots[idx]), int(self.lengths[idx])))
            self.status[idx] = STATUS_FREE
            self.slots[idx] = -1
            self.tail += 1
        return out

    def poll_burst(self, max_n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized PMD harvest: one status sweep per burst.

        Returns (packet_slots, lengths) arrays of the contiguous DONE run
        starting at tail (completions publish in order, so the run is
        contiguous by construction).
        """
        avail = self.head - self.tail
        k = min(max_n, avail)
        if k <= 0:
            return _EMPTY_I64, _EMPTY_I32
        idx = (self.tail + np.arange(k)) % self.size
        done = self.status[idx] == STATUS_DONE
        n = int(done.argmin()) if not done.all() else k
        if n == 0:
            return _EMPTY_I64, _EMPTY_I32
        idx = idx[:n]
        slots = self.slots[idx].copy()
        lengths = self.lengths[idx].copy()
        self.status[idx] = STATUS_FREE
        self.slots[idx] = -1
        self.tail += n
        return slots, lengths


class TxDescriptorRing:
    """TX side: the driver posts frames, the 'NIC' drains them.

    Symmetric but simpler — completion is immediate on drain; we keep the same
    poll discipline so PMD TX reclaim is burst-based too.
    """

    def __init__(self, size: int, queue_id: int = 0):
        self.size = int(size)
        self.queue_id = int(queue_id)
        self.slots = np.full(self.size, -1, dtype=np.int64)
        self.lengths = np.zeros(self.size, dtype=np.int32)
        self.head = 0  # driver cursor (next post)
        self.tail = 0  # NIC cursor (next transmit)
        self.posted = 0
        self.posted_bytes = 0
        self.rejected = 0
        self.transmitted = 0
        self.transmitted_bytes = 0

    @property
    def pending(self) -> int:
        return self.head - self.tail

    def post(self, packet_slot: int, length: int) -> bool:
        if self.pending >= self.size:
            self.rejected += 1
            return False
        idx = self.head % self.size
        self.slots[idx] = packet_slot
        self.lengths[idx] = length
        self.head += 1
        self.posted += 1
        self.posted_bytes += int(length)
        return True

    def post_burst(self, items: List[Tuple[int, int]]) -> int:
        """Scalar TX post of a burst. Returns #posted — and, like
        :meth:`post_burst_vec`, counts **every** unposted item as rejected
        (a full ring rejects the whole tail, not just the first item)."""
        n = 0
        for slot, length in items:
            if not self.post(slot, length):
                # post() counted the failing item; the untried tail is
                # rejected too, so scalar and vectorized stats agree
                self.rejected += len(items) - n - 1
                break
            n += 1
        return n

    def post_burst_vec(self, packet_slots: np.ndarray, lengths: np.ndarray) -> int:
        """Vectorized TX post. Returns #posted (rest rejected)."""
        n = len(packet_slots)
        space = self.size - self.pending
        take = min(n, space)
        if take > 0:
            idx = (self.head + np.arange(take)) % self.size
            self.slots[idx] = packet_slots[:take]
            self.lengths[idx] = lengths[:take]
            self.head += take
            self.posted += take
            self.posted_bytes += int(lengths[:take].sum(dtype=np.int64))
        self.rejected += n - take
        return take

    def drain(self, max_n: int) -> List[Tuple[int, int]]:
        """NIC transmits up to max_n pending frames."""
        out: List[Tuple[int, int]] = []
        while len(out) < max_n and self.tail < self.head:
            idx = self.tail % self.size
            out.append((int(self.slots[idx]), int(self.lengths[idx])))
            self.slots[idx] = -1
            self.tail += 1
            self.transmitted += 1
            self.transmitted_bytes += int(self.lengths[idx])
        return out

    def drain_burst(self, max_n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized drain: (packet_slots, lengths)."""
        take = min(max_n, self.pending)
        if take <= 0:
            return _EMPTY_I64, _EMPTY_I32
        idx = (self.tail + np.arange(take)) % self.size
        slots = self.slots[idx].copy()
        lengths = self.lengths[idx].copy()
        self.slots[idx] = -1
        self.tail += take
        self.transmitted += take
        self.transmitted_bytes += int(lengths.sum(dtype=np.int64))
        return slots, lengths
