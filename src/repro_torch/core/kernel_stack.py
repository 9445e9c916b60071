"""Interrupt-driven kernel network stack — the baseline (iperf analogue).

This is the path the paper's DPDK work *bypasses*.  We reproduce its three
bottlenecks (paper §2) honestly:

1. **Frequent syscalls** — every user-space read()/sendto() crossing pays a
   modeled syscall cost (see :mod:`repro_torch.core.cost` for why these are modeled
   rather than executed).
2. **Buffer copies** — NIC buffer → freshly-allocated "skb" (copy 1, real numpy
   allocation + copy), then skb → user buffer (copy 2, real), then user buffer
   → fresh NIC TX buffer (copy 3, real).  Per-packet allocation is real too.
3. **Interrupt processing** — packets only become visible to the kernel on an
   interrupt (one per descriptor-writeback event), each paying a modeled
   interrupt cost; per-packet protocol processing pays a modeled kernel cost.

Runs on the unified :class:`~repro_torch.core.netstack.NetworkStack` interface:
each (port, queue) pair — multi-queue NICs expose one IRQ vector per queue —
is serviced by a kernel "lcore" quantum: IRQ bottom half, then the
application half.  Socket receive queues are per-queue ``deque``s (O(1)
drain; the seed's ``list.pop(0)`` was O(n)).

The contrast server, :class:`repro_torch.core.pmd.BypassL2FwdServer`, does none of
these: no syscalls, no interrupts, zero copies, no per-packet allocation.

Own copy, in the PyTorch port, of ``src/repro/core/kernel_stack.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Sequence, Tuple

import numpy as np

from .cost import HostCostModel
from .netstack import Lcore, NetworkStack, ServerStats
from .packet import swap_macs
from .pmd import Port, ProcessFn


@dataclass
class KernelStats(ServerStats):
    interrupts: int = 0
    syscalls: int = 0
    copies: int = 0
    copied_bytes: int = 0
    allocs: int = 0
    sockdrops: int = 0  # skbs dropped on socket-buffer overflow (rmem cap)


class KernelStackServer(NetworkStack):
    """Interrupt-driven echo/forward server over N multi-queue ports.

    Each lcore quantum on a (port, queue) pair mimics the kernel + application
    flow for whatever packets that queue's interrupt has made visible:
    IRQ → skb alloc+copy → protocol processing → read() syscall copy-to-user →
    application processing → sendto() syscall copy-from-user → TX post.
    """

    stats_cls = KernelStats

    def __init__(
        self,
        ports: Sequence[Port],
        cost_model: Optional[HostCostModel] = None,
        sockbuf_budget: int = 16,  # packets drained per read() syscall
        process_fn: Optional[ProcessFn] = None,
        n_lcores: Optional[int] = None,
        sockbuf_capacity: int = 512,  # rmem cap: skbs queued per socket
    ):
        super().__init__(ports, n_lcores=n_lcores)
        if sockbuf_capacity < 1:
            raise ValueError("sockbuf_capacity must be >= 1")
        self.cost = cost_model or HostCostModel()
        self.sockbuf_budget = sockbuf_budget
        self.sockbuf_capacity = sockbuf_capacity
        self.process_fn = process_fn if process_fn is not None else swap_macs
        # socket receive queues (skbs waiting for the app), one per HW queue
        self._sock_queues: Dict[Tuple[int, int], Deque[np.ndarray]] = {
            pair: deque() for pair in self.queue_pairs
        }

    # -- kernel half ----------------------------------------------------------
    def _irq_bottom_half(self, port_idx: int, queue_idx: int,
                         qstats: KernelStats) -> int:
        """Interrupt: move written-back descriptors into the socket queue."""
        port = self.ports[port_idx]
        ring = port.rx_queues[queue_idx]
        batch = ring.poll(ring.size)  # kernel drains what's visible
        if not batch:
            return 0
        qstats.interrupts += 1
        self.charge_ns(self.cost.ns(self.cost.interrupt_cycles))
        q = self._sock_queues[(port_idx, queue_idx)]
        for slot, length in batch:
            if len(q) >= self.sockbuf_capacity:
                # socket buffer full (the rmem cap): the kernel drops the
                # frame — the loss mechanism a saturated iperf actually sees
                port.pool.free(slot)
                qstats.sockdrops += 1
                continue
            # copy 1: NIC DMA buffer -> fresh skb (real alloc + real copy)
            skb = np.array(port.pool.view(slot, length))  # allocates + copies
            qstats.allocs += 1
            qstats.copies += 1
            qstats.copied_bytes += length
            port.pool.free(slot)  # NIC buffer recycled immediately (kernel owns skb)
            self.charge_ns(self.cost.ns(self.cost.per_packet_kernel_cycles))
            q.append(skb)
        return len(batch)

    # -- application half ------------------------------------------------------
    def _app_read_process_send(self, port_idx: int, queue_idx: int,
                               qstats: KernelStats) -> int:
        port = self.ports[port_idx]
        q = self._sock_queues[(port_idx, queue_idx)]
        if not q:
            return 0
        # read() syscall: drains up to sockbuf_budget skbs into user buffers
        qstats.syscalls += 1
        self.charge_ns(self.cost.ns(self.cost.syscall_cycles))
        n = min(self.sockbuf_budget, len(q))
        done = 0
        for _ in range(n):
            skb = q.popleft()
            # copy 2: skb -> user buffer (real alloc + copy)
            user_buf = np.array(skb)
            qstats.allocs += 1
            qstats.copies += 1
            qstats.copied_bytes += len(user_buf)
            self.process_fn(user_buf)
            # sendto() syscall per packet + copy 3: user buffer -> NIC TX buffer
            qstats.syscalls += 1
            self.charge_ns(self.cost.ns(self.cost.syscall_cycles))
            tx_slot = port.pool.alloc()
            if tx_slot is None:
                continue  # pool exhausted: drop on TX
            length = len(user_buf)
            port.pool.arena[tx_slot, :length] = user_buf
            port.pool.lengths[tx_slot] = length
            qstats.copies += 1
            qstats.copied_bytes += length
            self.charge_ns(self.cost.ns(self.cost.per_packet_kernel_cycles))
            if port.tx_queues[queue_idx].post(tx_slot, length):
                qstats.tx_packets += 1
            else:
                port.pool.free(tx_slot)
            qstats.rx_packets += 1
            qstats.rx_bytes += length
            done += 1
        return done

    # -- lcore quantum ---------------------------------------------------------
    def _service_queue(self, lcore: Lcore, port_idx: int, queue_idx: int,
                       qstats: ServerStats) -> int:
        """One scheduling quantum on one queue: service its IRQ, run the app."""
        self._irq_bottom_half(port_idx, queue_idx, qstats)
        done = self._app_read_process_send(port_idx, queue_idx, qstats)
        qstats.poll_iterations += 1
        if done == 0:
            qstats.empty_polls += 1
        return done

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._sock_queues.values())
