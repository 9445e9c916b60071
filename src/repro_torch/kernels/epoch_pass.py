"""The epoch pass of the simulator's epoch-batched engine
(:mod:`repro_torch.core.fastpath`), and the wrapper of its CUDA kernel
(``csrc/epoch_pass.cu``).

Own copy, in the PyTorch port, of ``src/repro/kernels/epoch_fastpath.py``:
``serialization_ns_vec``, ``wire_arrival_pass_np``, ``epoch_pass_np`` and
``pmd_burst_cost_table`` are the same numpy. One epoch slice of the emission
schedule is advanced as whole-array passes:

* **emission → arrival**: the FIFO wire recursion
  ``end_i = max(end_{i-1}, t_i) + ser_i`` is a max-plus scan. With
  ``S_i = cumsum(ser)_i`` it closes to
  ``end_i = max(busy0, cummax_j<=i(t_j - S_{j-1})) + S_i``, bit-identical to
  :meth:`repro_torch.core.simclock.Wire.transmit` called per frame;
* **steer**: the per-frame RSS queue is a gather through a per-flow-id queue
  table (the loadgen's synthetic flow ids cycle mod ``n_flows``);
* **charge**: per-burst lcore busy time ``(poll + n*per_packet)/ghz`` as a
  cost table.

``epoch_pass_cuda`` is the kernel's wrapper, the counterpart of
``get_epoch_pass_jax``'s jitted ``_scan`` and ``_gather``
(``src/repro/kernels/epoch_fastpath.py:126-137``); its plain version is
``ref.epoch_pass`` and its entry point ``ops.epoch_pass``. ``launches`` counts
wrapper calls that launch (one a non-empty call, whatever the number of
kernels). ``make_pass(device)`` gives the engine a function with
``epoch_pass_np``'s signature that runs ``ops.epoch_pass`` on a device. The
port has no counterpart of ``get_epoch_pass_jax``'s self-disabling probe: a
pass on the card either runs the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "serialization_ns_vec",
    "wire_arrival_pass_np",
    "epoch_pass_np",
    "pmd_burst_cost_table",
    "epoch_pass_cuda",
    "make_pass",
    "plan",
]

launches = 0

THREADS = 256           # threads of a tile's block
ITEMS = 8               # consecutive frames of a thread
TILE = THREADS * ITEMS  # frames of a tile
INT64_MIN, INT64_MAX = -2 ** 63, 2 ** 63 - 1
MAX_GRID_X = 2 ** 31 - 1

# the C entry's arguments: handed, ser, table, fids, arrivals, queues, work;
# n, n_flows, busy0, latency, tiles; stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]


def serialization_ns_vec(lengths: np.ndarray, gbps: float) -> np.ndarray:
    """Per-frame serialization delay, matching ``Wire.serialization_ns``
    element-for-element (``int(round(bytes*8/gbps))``, half-to-even)."""
    if gbps <= 0.0:
        return np.zeros(len(lengths), dtype=np.int64)
    return np.round(np.asarray(lengths, dtype=np.float64) * 8.0
                    / gbps).astype(np.int64)


def wire_arrival_pass_np(
    handed_ns: np.ndarray, ser_ns: np.ndarray, busy0_ns: int, latency_ns: int,
) -> Tuple[np.ndarray, int]:
    """Arrival times of frames handed one-at-a-time to a FIFO wire.

    ``handed_ns`` must be non-decreasing (the emission schedule is).  Returns
    ``(arrivals, busy_until)`` — exactly what N sequential
    ``Wire.transmit(t_i, size_i)`` calls would produce.
    """
    n = len(handed_ns)
    if n == 0:
        return np.empty(0, dtype=np.int64), int(busy0_ns)
    handed = np.asarray(handed_ns, dtype=np.int64)
    ser = np.asarray(ser_ns, dtype=np.int64)
    cum = np.cumsum(ser)
    # end_i = max(busy0, max_{j<=i}(t_j - S_{j-1})) + S_i ; S_{-1} = 0
    pre = handed - (cum - ser)
    m = np.maximum(np.maximum.accumulate(pre), np.int64(busy0_ns))
    ends = m + cum
    return ends + np.int64(latency_ns), int(ends[-1])


def epoch_pass_np(
    handed_ns: np.ndarray,
    ser_ns: np.ndarray,
    busy0_ns: int,
    latency_ns: int,
    flow_queue_table: Optional[np.ndarray],
    flow_ids: Optional[np.ndarray],
) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """One epoch slice: wire arrivals + RSS steering in one pass.

    Returns ``(arrival_ns, busy_until, queue_idx)``; ``queue_idx`` is None
    for single-queue ports (no steering).
    """
    arrivals, busy = wire_arrival_pass_np(handed_ns, ser_ns, busy0_ns,
                                          latency_ns)
    queues = None
    if flow_queue_table is not None and flow_ids is not None:
        queues = flow_queue_table[flow_ids]
    return arrivals, busy, queues


def pmd_burst_cost_table(max_burst: int, poll_cycles: int,
                         per_packet_cycles: int, cpu_ghz: float) -> np.ndarray:
    """``cost[n] = pmd_burst_ns(n)`` for n in [0, max_burst] — the vectorized
    charge table the harvest cascade indexes per burst (float64, identical
    arithmetic to :meth:`repro_torch.core.cost.HostCostModel.pmd_burst_ns`)."""
    n = np.arange(max_burst + 1, dtype=np.float64)
    table = (poll_cycles + n * per_packet_cycles) / cpu_ghz
    table[0] = 0.0
    return table


class Plan(NamedTuple):
    """The kernels of one call over n frames: tiles of TILE frames, one block
    each; a call of more than one tile runs reduce, carry and apply, a call
    of one tile apply alone."""
    tiles: int      # ceil(n / TILE)
    kernels: int    # kernels launched: 3, or 1 for one tile
    workspace: int  # int64 words: status (busy_until, bad flow ids), 4 per tile


@functools.lru_cache(maxsize=256)
def plan(n: int) -> Plan:
    """The call's plan from n (a Python int; nothing on the device is read).
    At the engine's epoch of 63 342 frames: 31 tiles, three kernels. Raises
    ValueError for n < 1 or a grid CUDA cannot take."""
    if n < 1:
        raise ValueError(f"epoch_pass_cuda plans n >= 1 frames, got {n}")
    tiles = -(-n // TILE)
    if tiles > MAX_GRID_X:
        raise ValueError(f"epoch_pass_cuda: {n} frames need {tiles} blocks, "
                         f"past CUDA's {MAX_GRID_X}")
    return Plan(tiles=tiles, kernels=3 if tiles > 1 else 1, workspace=2 + 4 * tiles)


def check_args(handed: torch.Tensor, ser: torch.Tensor, busy0: int, latency: int,
               table: Optional[torch.Tensor], fids: Optional[torch.Tensor]) -> Tuple[int, bool]:
    """The wrapper's checks, which need no device; raise on what the kernel
    does not take. Returns n and whether the call steers (a table and flow
    ids both given, as in ``epoch_pass_np``)."""
    steer = table is not None and fids is not None
    ts = (handed, ser) + ((table, fids) if steer else ())
    if any(t.dtype != torch.int64 for t in ts):
        raise TypeError(f"epoch_pass_cuda takes int64 tensors, got "
                        f"{[t.dtype for t in ts]}")
    n = handed.shape[0] if handed.dim() == 1 else -1
    if n < 0 or ser.shape != handed.shape or (steer and (table.dim() != 1
                                                          or fids.shape != handed.shape)):
        raise ValueError(f"epoch_pass_cuda takes handed, ser and fids of one shape (n,) "
                         f"and a table (n_flows,), got {[tuple(t.shape) for t in ts]}")
    if not all(INT64_MIN <= int(v) <= INT64_MAX for v in (busy0, latency)):
        raise ValueError(f"epoch_pass_cuda: busy0 {busy0} and latency {latency} must fit int64")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("epoch_pass_cuda needs contiguous inputs")
    index = handed.get_device()  # -1 on the CPU
    if not handed.is_cuda or any(t.get_device() != index for t in ts):
        raise ValueError(f"epoch_pass_cuda needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    return n, steer


# (library, its epoch_pass_fwd, torch's raw current-stream accessor by device
# index), resolved at the first launch: CPU builds of torch lack the accessor
_launcher = None


def _fn():
    global _launcher
    if _launcher is None:
        lib = _build.load("epoch_pass")
        fn = lib.epoch_pass_fwd
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _launcher = lib, fn, torch._C._cuda_getCurrentRawStream
    return _launcher


def epoch_pass_cuda(handed: torch.Tensor, ser: torch.Tensor, busy0: int, latency: int,
                    table: Optional[torch.Tensor] = None, fids: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """handed, ser (n,) int64 (handed non-decreasing), busy0 and latency ints,
    table (n_flows,) and fids (n,) int64 or None, on one CUDA device →
    (arrivals (n,) int64, busy_until int, queues (n,) int64 or None), every
    output bit-equal to ``epoch_pass_np``.

    Edge cases as ``epoch_pass_np``: n = 0 launches nothing and returns an
    empty arrival tensor and busy0, with an empty queue tensor where a table
    and flow ids are given; a flow id indexes as numpy does (a negative one
    has n_flows added once), and one still outside [0, n_flows) raises
    IndexError. The kernel counts those ids beside busy_until, so the one
    read-back that busy_until needs (a synchronisation) carries the check:
    checking on the host before the launch would need a read of the ids of
    its own."""
    global launches
    n, steer = check_args(handed, ser, busy0, latency, table, fids)
    dev = handed.device
    arrivals = torch.empty(n, dtype=torch.int64, device=dev)
    queues = torch.empty(n, dtype=torch.int64, device=dev) if steer else None
    if n == 0:
        return arrivals, int(busy0), queues
    p = plan(n)
    work = torch.empty(p.workspace, dtype=torch.int64, device=dev)
    lib, fn, raw_stream = _launcher or _fn()
    index = handed.get_device()
    args = (handed.data_ptr(), ser.data_ptr(), table.data_ptr() if steer else None,
            fids.data_ptr() if steer else None, arrivals.data_ptr(),
            queues.data_ptr() if steer else None, work.data_ptr(),
            n, table.shape[0] if steer else 0, int(busy0), int(latency), p.tiles)
    if index == torch.cuda.current_device():
        err = fn(*args, raw_stream(index))
    else:  # the launch goes to the current device: make it the tensors'
        with torch.cuda.device(index):
            err = fn(*args, raw_stream(index))
    launches += 1
    _build.check(lib, "epoch_pass", err)
    busy, bad = work[:2].tolist()
    if bad:
        raise IndexError(f"epoch_pass: {bad} flow ids outside [-{table.shape[0]}, "
                         f"{table.shape[0]}) for a table of {table.shape[0]} flows")
    return arrivals, busy, queues


def make_pass(device) -> Callable:
    """A function with ``epoch_pass_np``'s signature (numpy in,
    ``(arrivals, busy_until, queue_idx)`` numpy out) that runs
    ``ops.epoch_pass`` on ``device``: ``"cuda"`` launches the kernel,
    ``"cpu"`` runs the plain version. Raises at once for ``"cuda"`` where
    no CUDA device is present. The flow-queue table goes to the device once
    for each table object it is given (the engine builds one a port), not
    once an epoch."""
    from . import ops

    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the epoch pass runs on cpu or cuda, not {device.type!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the epoch pass on 'cuda' needs a CUDA device and none is "
                           "present; pass device='cpu' (plain torch) or None (numpy)")
    table_cache = [None, None]  # the last table given, and its copy on the device

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    def epoch_pass_torch(handed_ns, ser_ns, busy0_ns, latency_ns, flow_queue_table,
                         flow_ids):
        table = None
        if flow_queue_table is not None:
            if table_cache[0] is not flow_queue_table:
                table_cache[:] = flow_queue_table, up(flow_queue_table)
            table = table_cache[1]
        fids = None if flow_ids is None else up(flow_ids)
        arr, busy, q = ops.epoch_pass(up(handed_ns), up(ser_ns), int(busy0_ns),
                                      int(latency_ns), table, fids)
        return arr.cpu().numpy(), busy, None if q is None else q.cpu().numpy()

    return epoch_pass_torch
