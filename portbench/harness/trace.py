"""The traced run: ``torch.profiler`` over a stretch of the cell's work, and
what the per-layer readers take from it.

Two profiles, each over its own stretch after the window:

* the timed profile records the device alone (CUPTI kernels, copies,
  fills; no host events, whose cost would slow a host-paced step): busy
  time as the union of the device's intervals, the traced window from the
  first of them to the end of the last (the host's stretch around them also
  holds the profiler's start and the first step's wait for its batch),
  device time by kernel name, the elementwise share by name part, and the
  device ops that took most time;
* the attribution profile, over one unit of the same work, records host
  ops with their argument shapes: each program op (``repro_torch::...``,
  the ``torch.library`` ops of the kernels) with its calls' shapes and the
  kernels the profiler links to each call or to ops inside it (the
  profiler drops kernel events; each kernel name of an op is counted as its
  mean event time times the op's calls, or its events where more), and the
  longest idle stretches labelled by the host op running at their middle
  (stretched by the profiler's own cost on the host).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import stats

# name parts (lower case) of ATen's elementwise, fill, add and copy kernels
ELEMENTWISE_PARTS = ("elementwise", "fillfunctor", "functor_add", "add_", "copy")
BREAKDOWN_TOP = 10
NAME_CHARS = 100
OP_PREFIX = "repro_torch::"


@dataclass
class OpCalls:
    # (input shapes, concrete inputs, dtypes) of each call
    args: List[tuple] = field(default_factory=list)
    kernels: Dict[str, List[float]] = field(default_factory=dict)  # name -> event µs

    @property
    def calls(self) -> int:
        return len(self.args)

    def device_s(self) -> float:
        """Device seconds of the op's kernels, each name at its mean event
        time times the calls (or its events where more)."""
        return sum(sum(ev) / len(ev) * max(self.calls, len(ev))
                   for ev in self.kernels.values()) / 1e6

    def scaled(self) -> Dict[str, list]:
        """The kernel names the profiler kept fewer events of than the op
        has calls: name -> [events, calls]."""
        return {k: [len(ev), self.calls] for k, ev in self.kernels.items()
                if len(ev) < self.calls}


@dataclass
class Trace:
    window_s: float                              # first device activity to the last's end
    busy_s: float
    host_s: float                                # the traced stretch by the host clock
    units: int                                   # steps or batches of the timed profile
    by_kernel: Dict[str, float]                  # device µs by kernel name
    ops: Dict[str, OpCalls]                      # of the attribution profile
    breakdown: dict

    def scaled(self) -> Dict[str, Dict[str, list]]:
        """Per program op, the kernels whose device time was scaled by calls."""
        return {op: rec.scaled() for op, rec in self.ops.items() if rec.scaled()}

    def elementwise_s(self) -> float:
        return sum(us for name, us in self.by_kernel.items()
                   if any(p in name.lower() for p in ELEMENTWISE_PARTS)) / 1e6


@contextlib.contextmanager
def profiled(out: dict, sync, host: bool):
    """Profile the block: the device alone, or with ``host`` the host's ops
    and their shapes too. ``out["prof"]`` is the profiler and
    ``out["window_s"]`` the block's host seconds, ended by ``sync()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    if not torch.cuda.is_available():   # the CPU tests: no device to record
        acts = [ProfilerActivity.CPU]
    with profile(activities=acts, record_shapes=host) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _kernels_under(e, into: Dict[str, List[float]]) -> int:
    n = 0
    for k in getattr(e, "kernels", ()):
        into.setdefault(k.name, []).append(float(k.duration))
        n += 1
    for c in e.cpu_children:
        n += _kernels_under(c, into)
    return n


def summarize(timed, attribution, window_s: float, units: int,
              op_prefix: str = OP_PREFIX) -> Trace:
    """``timed``, ``attribution``: the two profilers; ``window_s``: the timed
    stretch's host seconds; ``units``: the steps or batches it ran."""
    from torch.autograd import DeviceType
    device = [e for e in timed.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    by_kernel: Dict[str, float] = {}
    for e in device:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = stats.busy_union(spans)
    span_us = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0.0

    ops: Dict[str, OpCalls] = {}
    host, attributed = [], []
    for e in attribution.events():
        if e.device_type == DeviceType.CUDA:
            attributed.append((e.time_range.start, e.time_range.end))
            continue
        host.append(e)
        if e.name.startswith(op_prefix):
            rec = ops.setdefault(e.name, OpCalls())
            rec.args.append((list(e.input_shapes or []),
                             list(getattr(e, "concrete_inputs", None) or []),
                             getattr(e, "input_dtypes", None)))
            _kernels_under(e, rec.kernels)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    breakdown = {"device_ops": [[name[:NAME_CHARS], us / 1e6] for name, us in top],
                 "idle_gaps": _idle_gaps(attributed, host)}
    return Trace(window_s=span_us / 1e6, busy_s=busy_us / 1e6, host_s=window_s, units=units,
                 by_kernel=by_kernel, ops=ops, breakdown=breakdown)


def _idle_gaps(spans, host) -> list:
    if not spans:
        return []
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    gaps = sorted(stats.idle_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:BREAKDOWN_TOP]
    return [[_host_at(host, (s + e) / 2), (e - s) / 1e6] for s, e in gaps]


def _host_at(host, t: float) -> str:
    """The innermost host op running at ``t``."""
    best = None
    for e in host:
        if e.time_range.start <= t <= e.time_range.end and (
                best is None or e.time_range.start > best.time_range.start):
            best = e
    return "host between ops" if best is None else best.name[:NAME_CHARS]
