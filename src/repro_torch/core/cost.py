"""Host-cost model for the parts of the gem5 timing model this container
cannot execute natively.

Two execution modes share this model:

* **Wall-clock mode** (the seed behaviour, kept for host-overhead studies):
  the copies, allocations, ring operations and packet processing are REAL
  (measured wall-clock on the host CPU), and the kernel-only events gem5
  would time microarchitecturally — interrupt entry/exit, context switches,
  syscall crossings — are modeled as calibrated :func:`spin_ns` busy-waits.

* **Virtual-time mode** (the default since the SimClock refactor): *no* cost
  burns host CPU.  The same cycle figures are charged to the serving lcore's
  virtual busy-time instead (see
  :meth:`repro_torch.core.netstack.NetworkStack.charge_ns`), which is exactly how
  gem5 itself accounts time.  Because real host execution no longer sets the
  pace, the polling-mode (DPDK) path also needs an explicit per-packet cost
  in this mode — ``pmd_poll_cycles``/``pmd_per_packet_cycles`` below,
  calibrated so the bypass:kernel MSB ratio lands in the paper's Fig. 3(a)
  regime (~5-6x at one port).

The frequency knob (``cpu_ghz``) scales every cycle figure — the exact knob
the paper's Fig. 3(b) sensitivity study turns (2 GHz → 3 GHz).

Own copy, in the PyTorch port, of ``src/repro/core/cost.py``: the same numpy and plain
Python, with its imports pointing into ``repro_torch``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class HostCostModel:
    """Cycle costs are rough Linux x86 figures; freq scales them (Fig. 3b)."""

    cpu_ghz: float = 2.0
    interrupt_cycles: int = 8000      # hardirq entry + softirq (NET_RX) schedule
    syscall_cycles: int = 1400        # read()/sendto() user<->kernel crossing
    per_packet_kernel_cycles: int = 2500  # skb setup, protocol demux, socket queue
    # polling-path costs, charged ONLY in virtual-time mode (in wall-clock
    # mode the PMD's real code is its own cost — the paper's asymmetry):
    pmd_poll_cycles: int = 150        # one non-empty rx_burst/tx_burst pass
    pmd_per_packet_cycles: int = 1100  # L2Fwd header rewrite + descriptor work

    def ns(self, cycles: int) -> float:
        return cycles / self.cpu_ghz  # cycles / (GHz) == ns

    def with_freq(self, cpu_ghz: float) -> "HostCostModel":
        return replace(self, cpu_ghz=cpu_ghz)

    def pmd_burst_ns(self, n_packets: int) -> float:
        """Virtual-time cost of one PMD loop iteration forwarding n packets."""
        if n_packets <= 0:
            return 0.0
        return self.ns(self.pmd_poll_cycles + n_packets * self.pmd_per_packet_cycles)


def spin_ns(duration_ns: float) -> None:
    """Calibrated busy-wait (a model 'cost'), burning real host CPU.

    Wall-clock mode only; virtual-time mode charges the same duration to the
    serving lcore's SimClock busy-time instead.
    """
    if duration_ns <= 0:
        return
    deadline = time.perf_counter_ns() + int(duration_ns)  # simlint: disable=SL001 -- wall-mode host-cost spin
    while time.perf_counter_ns() < deadline:  # simlint: disable=SL001 -- wall-mode host-cost spin
        pass


ZERO_COST = HostCostModel(cpu_ghz=2.0, interrupt_cycles=0, syscall_cycles=0,
                          per_packet_kernel_cycles=0, pmd_poll_cycles=0,
                          pmd_per_packet_cycles=0)
