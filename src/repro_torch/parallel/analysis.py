"""Roofline terms and collective inventory of a traced step on H100s (port
of ``src/repro/parallel/hlo_analysis.py``; the port has no HLO, so the
counts come from ``parallel/op_counter.py``, which counts what a step
dispatches, in place of a parse of compiled HLO text).

The hardware figures are the H100 SXM5's datasheet numbers: 989 TFLOP/s of
dense bf16 on the tensor cores and 3.35 TB/s of HBM3 per GPU.

Link model for the collective term: 8 GPUs a node on NVLink 4, 450 GB/s a
direction per GPU; between nodes one 400 Gb/s NIC (50 GB/s) a GPU. A ring
whose ranks span more than one node runs at the NIC's rate, one within a
node at NVLink's. Ranks are laid out in mesh order, 8 consecutive ranks a
node, so at (16, 16) = 256 GPUs (32 nodes) a ``model`` group (16
consecutive ranks) spans 2 nodes and a ``data`` group (stride 16) 16 nodes;
at (2, 16, 16) = 512 GPUs ``pod`` (stride 256) crosses nodes as well. Every
axis of both production meshes crosses nodes, so every collective there is
costed at the NIC's rate; only a group inside one node (a smoke mesh) gets
NVLink's.

Wire bytes use the ring factors of the JAX package (``hlo_analysis.py``):
2(g-1)/g of the operand for an all-reduce, (g-1)/g for an all-gather,
reduce-scatter and all-to-all, the operand once for a permute. As there, an
all-gather's operand is the rank's shard.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

# H100 SXM5 datasheet figures (roofline targets)
PEAK_FLOPS_BF16 = 989e12     # dense bf16 on the tensor cores, per GPU
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU
NVLINK_BW = 450e9            # NVLink 4, bytes/s a direction per GPU, inside a node
NIC_BW = 50e9                # one 400 Gb/s NIC a GPU, between nodes
GPUS_PER_NODE = 8

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_wire_bytes(kind: str, nbytes: float, group_size: int) -> float:
    """Bytes one rank puts on the wire for a collective of ``nbytes`` of
    operand over ``group_size`` ranks (0 for a group of one)."""
    g = max(1, group_size)
    ring = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * ring * nbytes
    if kind == "collective-permute":
        return float(nbytes) if g > 1 else 0.0
    return ring * nbytes


def crosses_nodes(ranks) -> bool:
    """Whether a group of global ranks spans more than one node."""
    return len({r // GPUS_PER_NODE for r in ranks}) > 1


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    op_bytes: Dict[str, int] = field(default_factory=dict)      # Σ operand bytes
    wire_bytes: Dict[str, float] = field(default_factory=dict)  # ring model / GPU

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_op_bytes(self) -> int:
        return sum(self.op_bytes.values())


@dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    n_devices: int
    model_flops_total: float = 0.0
    # the part of wire_bytes_per_device whose groups stay inside a node
    nvlink_wire_bytes_per_device: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        nvlink = self.nvlink_wire_bytes_per_device
        return (self.wire_bytes_per_device - nvlink) / NIC_BW + nvlink / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """Model-flops utilization if the step ran exactly at the roofline."""
        t = self.step_time_lower_bound
        if t <= 0:
            return 0.0
        return self.model_flops_total / (self.n_devices * PEAK_FLOPS_BF16 * t)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_upper_bound": self.mfu_upper_bound,
        }


def model_flops_for_step(cfg, step_kind: str, seq_len: int, global_batch: int) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active params."""
    n_active = cfg.active_param_count()
    tokens = (seq_len * global_batch if step_kind in ("train", "prefill")
              else global_batch)
    mult = 6.0 if step_kind == "train" else 2.0
    return mult * n_active * tokens
