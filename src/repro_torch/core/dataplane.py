"""Device ingest dataplane: the kernel-style blocking feed against the
PMD-style bypass feed (port of ``src/repro/core/dataplane.py:38-227``).

The paper's claim at the accelerator boundary: a host→device input path that
allocates a fresh host buffer per batch, copies with a blocking call and then
synchronises the whole device has the kernel stack's costs (per-packet skb
allocation, syscall, interrupt-driven completion). :class:`KernelStackFeed`
is that baseline. :class:`BypassDataplane` is the DPDK analogue: a depth-K
ring of reused pinned host buffers ("hugepages"), asynchronous copies issued
ahead on a side CUDA stream, readiness *polled* with ``Event.query()`` (where
the reference polls ``jax.Array.is_ready``), multi-port host production and
out-of-order completion, so that copies overlap host production and device
compute.

Both feeds yield dicts of tensors on ``device`` and speak the same protocol,
so the trainer swaps them with one flag. On the CPU (the tests) there are no
streams or pinned memory: a transfer is a copy into a fresh tensor and is
ready at once, with the same semantics otherwise.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from .rings import SpscRing

HostBatch = Dict[str, np.ndarray]
DeviceBatch = Dict[str, torch.Tensor]


@dataclass
class FeedStats:
    batches: int = 0
    bytes: int = 0
    wait_ns: int = 0          # time the consumer stalled waiting for data
    put_ns: int = 0           # time spent issuing transfers
    host_alloc_ns: int = 0    # host-side production time on the critical path
    empty_polls: int = 0
    occupancy_sum: int = 0    # ring occupancy integral (for avg occupancy)

    @property
    def avg_occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0


def _host_bytes(host: HostBatch) -> int:
    return sum(v.nbytes for v in host.values())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class KernelStackFeed:
    """Baseline feed: synchronous, copying, interrupt-style.

    Each ``next_batch``: produce the host batch, copy it into a fresh host
    allocation, copy that to the device with a blocking call (pageable
    memory), then synchronise the whole device. No overlap anywhere."""

    def __init__(self, batch_iter: Iterator[HostBatch], device: torch.device):
        self._it = batch_iter
        self._device = torch.device(device)
        self.stats = FeedStats()

    def next_batch(self) -> Optional[DeviceBatch]:
        t0 = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock feed mode
        try:
            host = next(self._it)
        except StopIteration:
            return None
        # defensive copy: the kernel stack never trusts caller buffers (skb copy)
        host = {k: np.array(v) for k, v in host.items()}
        t1 = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock feed mode
        dev = {k: torch.from_numpy(v).to(self._device) for k, v in host.items()}
        _sync(self._device)  # interrupt-driven completion: hard sync
        t2 = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock feed mode
        self.stats.host_alloc_ns += t1 - t0
        self.stats.put_ns += t2 - t1
        self.stats.batches += 1
        self.stats.bytes += _host_bytes(host)
        return dev

    def stop(self) -> None:
        pass


@dataclass
class _Transfer:
    """One in-flight batch: its device tensors, the event recorded after its
    copies on the side stream (None on the CPU), the pinned slot it was
    staged in, and its size."""
    batch: DeviceBatch
    event: Optional[torch.cuda.Event]
    slot: int
    nbytes: int

    def ready(self) -> bool:
        return self.event is None or self.event.query()


class BypassDataplane:
    """PMD-style device feed: pre-issued asynchronous copies + readiness polling.

    * ``depth`` in-flight transfers (descriptor-ring depth), each staged in
      one of ``depth`` pinned host buffers that are reused for the life of
      the feed; a buffer is refilled only after its copy's event completed;
    * ``ports`` host producer threads, each filling an SPSC staging ring with
      numpy batches (multi-NIC analogue); only the consumer thread touches
      torch (pinned copies, stream work), so the producers race nothing;
    * the consumer *polls* ``Event.query()`` instead of blocking, and takes
      the oldest ready transfer, so a not-ready head with ready successors is
      reordered like out-of-order descriptor completion;
    * a batch copied on the side stream is handed to the consumer's current
      stream with ``wait_event`` and ``record_stream``, so the caching
      allocator does not reuse its memory while that stream may still read it.
    """

    def __init__(
        self,
        batch_iter_factory: Callable[[int, int], Iterator[HostBatch]],
        *,
        device: torch.device,
        depth: int = 3,
        ports: int = 1,
        staging_capacity: int = 8,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if ports < 1:
            raise ValueError("ports must be >= 1")
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self._device) if self._cuda else None
        self._depth = depth
        self._ports = ports
        self.stats = FeedStats()
        self._pinned: List[Optional[Dict[str, torch.Tensor]]] = [None] * depth
        self._free_slots = list(range(depth))
        self._stage: List[SpscRing] = [SpscRing(staging_capacity) for _ in range(ports)]
        self._stop_evt = threading.Event()
        self._producers: List[threading.Thread] = []
        self._exhausted = [False] * ports
        self._rr = 0  # round-robin port cursor
        self._inflight: List[_Transfer] = []
        for p in range(ports):
            it = batch_iter_factory(p, ports)
            t = threading.Thread(target=self._producer_loop, args=(p, it), daemon=True,
                                 name=f"dataplane-port{p}")
            self._producers.append(t)
            t.start()

    # -- host producer threads (the "NIC ports") -----------------------------
    def _producer_loop(self, port: int, it: Iterator[HostBatch]) -> None:
        ring = self._stage[port]
        while not self._stop_evt.is_set():
            try:
                host = next(it)
            except StopIteration:
                self._exhausted[port] = True
                return
            while not ring.try_push(host):
                if self._stop_evt.is_set():
                    return
                time.sleep(0)  # staging full: yield (backpressure, no drop)

    # -- DMA issue -------------------------------------------------------------
    def _pinned_for(self, slot: int, host: HostBatch) -> Dict[str, torch.Tensor]:
        bufs = self._pinned[slot]
        if bufs is None or bufs.keys() != host.keys() or any(
                tuple(bufs[k].shape) != v.shape or bufs[k].dtype != torch.from_numpy(v).dtype
                for k, v in host.items()):
            bufs = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, pin_memory=True)
                    for k, v in host.items()}
            self._pinned[slot] = bufs
        return bufs

    def _transfer(self, host: HostBatch) -> _Transfer:
        slot = self._free_slots.pop()
        if not self._cuda:
            batch = {k: torch.from_numpy(v).clone(memory_format=torch.contiguous_format)
                     for k, v in host.items()}
            return _Transfer(batch, None, slot, _host_bytes(host))
        bufs = self._pinned_for(slot, host)
        for k, v in host.items():
            bufs[k].copy_(torch.from_numpy(v))
        with torch.cuda.stream(self._stream):
            batch = {k: b.to(self._device, non_blocking=True) for k, b in bufs.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Transfer(batch, event, slot, _host_bytes(host))

    def _issue_one(self) -> bool:
        """Pop one staged host batch and start its asynchronous transfer."""
        for _ in range(self._ports):
            ring = self._stage[self._rr]
            self._rr = (self._rr + 1) % self._ports
            host = ring.try_pop()
            if host is not None:
                t0 = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock feed mode
                # NOTE: no synchronize — the copy proceeds while we return to
                # compute. Readiness is observed by polling.
                self._inflight.append(self._transfer(host))
                self.stats.put_ns += time.perf_counter_ns() - t0  # simlint: disable=SL001 -- wall-clock feed mode
                return True
        return False

    def _refill(self) -> None:
        while len(self._inflight) < self._depth:
            if not self._issue_one():
                break

    def _hand_over(self, tr: _Transfer) -> DeviceBatch:
        """Free the transfer's pinned slot (its copy has completed) and make
        its tensors safe to use on the consumer's current stream."""
        if tr.event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(tr.event)
            for t in tr.batch.values():
                t.record_stream(cur)
        self._free_slots.append(tr.slot)
        return tr.batch

    # -- consumer API ------------------------------------------------------------
    def next_batch(self, timeout_s: float = 30.0) -> Optional[DeviceBatch]:
        """Poll for the next ready batch (PMD rx_burst of size 1). Returns None
        at the clean end of the stream; raises TimeoutError when no batch
        became ready within ``timeout_s``."""
        deadline = time.perf_counter_ns() + int(timeout_s * 1e9)  # simlint: disable=SL001 -- wall-clock feed mode
        t_start = time.perf_counter_ns()  # simlint: disable=SL001 -- wall-clock feed mode
        self._refill()
        while True:
            # poll in-flight transfers; prefer the oldest ready one
            for i, tr in enumerate(self._inflight):
                if tr.ready():
                    self._inflight.pop(i)
                    batch = self._hand_over(tr)
                    self._refill()  # keep the ring full before returning
                    self.stats.batches += 1
                    self.stats.bytes += tr.nbytes
                    self.stats.occupancy_sum += len(self._inflight) + 1
                    self.stats.wait_ns += time.perf_counter_ns() - t_start  # simlint: disable=SL001 -- wall-clock feed mode
                    return batch
            if not self._inflight:
                if all(self._exhausted) and all(r.is_empty() for r in self._stage):
                    return None  # clean end of stream
                self._refill()
            self.stats.empty_polls += 1
            if time.perf_counter_ns() > deadline:  # simlint: disable=SL001 -- wall-clock feed mode
                raise TimeoutError("dataplane: no batch became ready in time")
            time.sleep(0)  # yield so the producers run

    def drop_inflight(self) -> int:
        """Drop every in-flight transfer (the straggler policy's drop); their
        pinned slots are freed once their copies have completed. Returns the
        number dropped."""
        dropped = len(self._inflight)
        for tr in self._inflight:
            if tr.event is not None:
                tr.event.synchronize()
            self._free_slots.append(tr.slot)
        self._inflight.clear()
        return dropped

    def stop(self) -> None:
        self._stop_evt.set()
        for t in self._producers:
            t.join(timeout=5)
        self.drop_inflight()


def make_feed(kind: str, batch_iter_factory: Callable[[int, int], Iterator[HostBatch]],
              *, device: torch.device, **kw: Any):
    """Factory: kind in {"kernel", "bypass"} — one flag swaps the stacks. The
    kernel feed reads port 0 of 1 and ignores the bypass feed's options."""
    if kind == "kernel":
        return KernelStackFeed(batch_iter_factory(0, 1), device)
    if kind == "bypass":
        return BypassDataplane(batch_iter_factory, device=device, **kw)
    raise ValueError(f"unknown feed kind: {kind}")
