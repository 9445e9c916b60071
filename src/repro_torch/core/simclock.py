"""Virtual-time simulation core: a deterministic clock, an event scheduler,
and a wire (link) model.

The paper's EtherLoadGen "adds a timestamp to each outgoing packet ... and
compares the timestamp with the current tick" — it measures in **simulated
ticks**, exactly like gem5 itself (a discrete-event timing model).  This
module gives the repo the same discipline: every producer of "now" in the
measurement pipeline (load generator pacing, RTT stamps, host-cost charging,
throughput meters) can read one :class:`SimClock` instead of
``time.perf_counter_ns()``, which makes every downstream number

* **deterministic** — same config + seed → bit-identical stats, and
* **host-independent** — 400 Gbps of offered load simulates fine on a laptop,
  because simulated time is decoupled from how fast the host executes.

Wall-clock mode survives (the host-overhead study needs it); the clock is
simply not installed and callers keep reading the host timer.

Components:

* :class:`SimClock` — current virtual time in integer nanoseconds, advancing
  monotonically and only explicitly.
* :class:`EventScheduler` — a lightweight min-heap of (time, callback) events
  with deterministic FIFO tie-breaking, for anything that needs "call me at
  T" semantics on top of the clock.  ``schedule_at``/``schedule_in`` return a
  token that :meth:`EventScheduler.cancel` accepts, so *timers* (events that
  may be superseded before they fire — e.g. the NIC descriptor-cache
  writeback timeout, the ITR analogue) compose with ordinary events.
  Cancellation is lazy: tombstoned entries are purged when they reach the
  heap top, so cancel is O(1) and the heap never fires a dead callback.
  (The load generator's hot loop inlines its own event selection for speed —
  emissions, wire arrivals and lcore-free times are each already sorted —
  but composed scenarios (the Switch/Topology layer, descriptor-writeback
  timers) schedule here, and the loop folds ``next_time_ns()`` into its
  candidate set.)
* :class:`Wire` — one simplex link: serialization delay (``bytes*8/gbps``)
  plus fixed propagation latency, with FIFO busy-until semantics so back-to-
  back frames queue on the wire like they do on real copper/fiber.

Own copy, in the PyTorch port, of ``src/repro/core/simclock.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Tuple

import numpy as np


class SimClock:
    """Current virtual time, in integer nanoseconds.

    Monotonic by construction: ``advance_to`` is a no-op for times in the
    past, ``advance`` rejects negative deltas.  All virtual-time consumers
    (load generator, servers, telemetry) share one instance per testbed.
    """

    __slots__ = ("now_ns",)

    def __init__(self, start_ns: int = 0):
        self.now_ns = int(start_ns)

    def advance_to(self, t_ns: int) -> int:
        """Move the clock forward to ``t_ns`` (never backward)."""
        if t_ns > self.now_ns:
            self.now_ns = int(t_ns)
        return self.now_ns

    def advance(self, dt_ns: int) -> int:
        """Move the clock forward by ``dt_ns`` >= 0."""
        if dt_ns < 0:
            raise ValueError("SimClock cannot run backwards")
        self.now_ns += int(dt_ns)
        return self.now_ns

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SimClock(now_ns={self.now_ns})"


class EventScheduler:
    """Deterministic discrete-event queue over a :class:`SimClock`.

    Events at equal times fire in insertion order (FIFO tie-break via a
    monotone sequence number), so two runs of the same schedule are
    bit-identical — the property every determinism test leans on.

    ``schedule_at``/``schedule_in`` return an opaque token; :meth:`cancel`
    tombstones the matching event (lazy deletion — the entry is discarded
    when it surfaces at the heap top, never fired).  ``len(sched)`` counts
    *live* events only.
    """

    def __init__(self, clock: Optional[SimClock] = None):
        self.clock = clock if clock is not None else SimClock()
        self._heap: List[Tuple[int, int, Callable[[], None]]] = []
        self._seq = 0
        self._live: set = set()  # seq numbers of not-yet-fired, not-cancelled

    def __len__(self) -> int:
        return len(self._live)

    def schedule_at(self, t_ns: int, fn: Callable[[], None]) -> int:
        """Schedule ``fn`` to run when the clock reaches ``t_ns``.  Times in
        the past fire on the next ``run_until``/``run_next`` at current now.
        Returns a token accepted by :meth:`cancel`."""
        heapq.heappush(self._heap, (int(t_ns), self._seq, fn))
        self._live.add(self._seq)
        token = self._seq
        self._seq += 1
        return token

    def schedule_in(self, delay_ns: int, fn: Callable[[], None]) -> int:
        return self.schedule_at(self.clock.now_ns + int(delay_ns), fn)

    def cancel(self, token: int) -> bool:
        """Cancel a pending event by token.  Returns True if it was still
        pending (it will never fire), False if it already fired, was already
        cancelled, or the token is unknown."""
        if token in self._live:
            self._live.discard(token)
            # lazy deletion never fires a dead event, but tombstones below
            # the heap top linger; compact when they dominate so arm/cancel
            # churn (e.g. per-packet writeback timers) stays O(live)
            if len(self._heap) > 64 and len(self._heap) > 4 * len(self._live):
                self._heap = [e for e in self._heap if e[1] in self._live]
                heapq.heapify(self._heap)
            return True
        return False

    def _drop_dead_head(self) -> None:
        """Purge tombstoned (cancelled) entries off the heap top."""
        while self._heap and self._heap[0][1] not in self._live:
            heapq.heappop(self._heap)

    def next_time_ns(self) -> Optional[int]:
        """Timestamp of the earliest *live* pending event, or None if empty."""
        self._drop_dead_head()
        return self._heap[0][0] if self._heap else None

    def run_next(self) -> bool:
        """Advance the clock to the earliest live event and run it.  Returns
        False when no live events are pending."""
        self._drop_dead_head()
        if not self._heap:
            return False
        t, seq, fn = heapq.heappop(self._heap)
        self._live.discard(seq)
        self.clock.advance_to(t)
        fn()
        return True

    def run_until(self, t_ns: int) -> int:
        """Run every live event scheduled at or before ``t_ns`` (in time
        order), then advance the clock to ``t_ns``.  Returns the number of
        events that fired."""
        fired = 0
        while True:
            nt = self.next_time_ns()
            if nt is None or nt > t_ns:
                break
            self.run_next()
            fired += 1
        self.clock.advance_to(t_ns)
        return fired

    def run_all(self, max_events: int = 10_000_000) -> int:
        """Drain the queue (events may schedule further events)."""
        fired = 0
        while self.run_next():
            fired += 1
            if fired >= max_events:
                raise RuntimeError("EventScheduler.run_all exceeded max_events")
        return fired


class Wire:
    """One simplex link: serialization + propagation, FIFO.

    ``gbps <= 0`` models an ideal wire (zero serialization delay) — the
    legacy behaviour for testbeds that never configured a link.  Otherwise a
    frame handed to the wire at ``t`` begins serializing when the wire frees
    up (``busy_until``), occupies it for ``bytes*8/gbps`` ns, and lands at
    the far end a further ``latency_ns`` later.  1 Gbps == 1 bit/ns, so the
    serialization arithmetic stays in exact ns.
    """

    __slots__ = ("gbps", "latency_ns", "busy_until_ns")

    def __init__(self, gbps: float = 0.0, latency_ns: int = 0):
        if latency_ns < 0:
            raise ValueError("latency_ns must be >= 0")
        self.gbps = float(gbps)
        self.latency_ns = int(latency_ns)
        self.busy_until_ns = 0

    def serialization_ns(self, nbytes: int) -> int:
        if self.gbps <= 0.0:
            return 0
        return int(round(nbytes * 8 / self.gbps))

    def transmit(self, t_ns: int, nbytes: int) -> int:
        """Put a frame on the wire at ``t_ns``; returns its arrival time at
        the far end.  Arrival times are non-decreasing (FIFO wire)."""
        start = max(int(t_ns), self.busy_until_ns)
        end = start + self.serialization_ns(nbytes)
        self.busy_until_ns = end
        return end + self.latency_ns

    def transmit_burst(self, t_ns: int, lengths) -> np.ndarray:
        """Vectorized :meth:`transmit` for a back-to-back frame burst handed
        to the wire at ``t_ns``; returns the per-frame arrival times.  An
        empty burst returns an empty array and leaves the wire untouched."""
        n = len(lengths)
        if n == 0:
            return np.empty(0, dtype=np.int64)
        start = max(int(t_ns), self.busy_until_ns)
        if self.gbps <= 0.0:
            self.busy_until_ns = start
            return np.full(n, start + self.latency_ns, dtype=np.int64)
        ser = np.round(np.asarray(lengths, dtype=np.float64) * 8.0
                       / self.gbps).astype(np.int64)
        ends = start + np.cumsum(ser)
        self.busy_until_ns = int(ends[-1])
        return ends + self.latency_ns

    def reset(self) -> None:
        self.busy_until_ns = 0
