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
the kernel's launches: one a non-empty call. ``make_pass(device)`` gives the
engine a function with ``epoch_pass_np``'s signature that runs the pass on a
device: on the card through pinned staging buffers, one upload, the kernel,
one download and one synchronisation a call. The port has no counterpart of
``get_epoch_pass_jax``'s self-disabling probe: a pass on the card either runs
the kernel or raises.

Each CUDA device has one workspace (``_Device``), made at its first call and
kept: the kernel's ticket counter and tagged slots of published pairs, a
status pair for ``epoch_pass_cuda``, and ``make_pass``'s pinned and device
buffers (see ``csrc/epoch_pass.cu``: a tag never repeats over a workspace's
life, so no call clears anything). A lock
holds it from a call's launch to its read-back, so calls on one device, from
any thread or stream, run one after another.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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

THREADS = 128           # threads of a tile's block
ITEMS = 4               # consecutive frames of a thread
TILE = THREADS * ITEMS  # frames of a tile: 124 tiles at the bench epoch of 63 343
LOOKBACK = THREADS      # tiles a step of the look-back reads (one a thread)
TAGS = 2 ** 32 - 1      # tickets a workspace issues at most: a slot's tag is ticket + 1, 32 bits
HEAD = 4                # workspace words before the flags: the ticket counter, tile 0's
                        # mark of its stored count of bad ids, the status pair
INT64_MIN, INT64_MAX = -2 ** 63, 2 ** 63 - 1
MAX_GRID_X = 2 ** 31 - 1

# the C entry's arguments: handed, ser, table, fids, arrivals, queues, status,
# work; n, n_flows, busy0, latency, tiles, cap; base; stream
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 6
            + [ctypes.c_ulonglong, ctypes.c_void_p])


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
    """The one kernel of a call over n frames: a block a tile of TILE
    frames, each taking one ticket."""
    tiles: int      # ceil(n / TILE): blocks, and the tickets the call takes
    workspace: int  # int64 words of the device's workspace it needs: HEAD, then 8 a tile


def plan_words(tiles: int) -> int:
    """int64 words of a workspace for ``tiles`` tiles."""
    return HEAD + 8 * tiles


@functools.lru_cache(maxsize=256)
def plan(n: int) -> Plan:
    """The call's plan from n (a Python int; nothing on the device is read).
    At the engine's bench epoch of 63 343 frames: 124 tiles, one wave over
    the H100's 132 SMs (TILE is the fastest there of the shapes that
    ``chip_smoke.epoch_tile_sweep`` times). Raises ValueError for n < 1 or a
    grid CUDA cannot take."""
    if n < 1:
        raise ValueError(f"epoch_pass_cuda plans n >= 1 frames, got {n}")
    tiles = -(-n // TILE)
    if tiles > MAX_GRID_X:
        raise ValueError(f"epoch_pass_cuda: {n} frames need {tiles} blocks, "
                         f"past CUDA's {MAX_GRID_X}")
    return Plan(tiles=tiles, workspace=plan_words(tiles))


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
    check_ints(busy0, latency)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("epoch_pass_cuda needs contiguous inputs")
    index = handed.get_device()  # -1 on the CPU
    if not handed.is_cuda or any(t.get_device() != index for t in ts):
        raise ValueError(f"epoch_pass_cuda needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    return n, steer


def check_ints(busy0: int, latency: int) -> None:
    if not all(INT64_MIN <= int(v) <= INT64_MAX for v in (busy0, latency)):
        raise ValueError(f"epoch_pass_cuda: busy0 {busy0} and latency {latency} must fit int64")


def bad_ids(bad: int, n_flows: int) -> IndexError:
    return IndexError(f"epoch_pass: {bad} flow ids outside [-{n_flows}, {n_flows}) for a "
                      f"table of {n_flows} flows")


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


def _grow(buf: Optional[torch.Tensor], words: int, **kw) -> torch.Tensor:
    """buf if it holds ``words`` int64 words, else a new one of at least twice
    its size (contents not kept)."""
    if buf is not None and buf.numel() >= words:
        return buf
    return torch.empty(max(words, 2 * (0 if buf is None else buf.numel())),
                       dtype=torch.int64, **kw)


class _Device:
    """One CUDA device's workspace, kept across calls (see the module's
    docstring); take ``lock`` for a call, from launch to read-back."""

    def __init__(self, index: int):
        self.index = index
        self.device = torch.device("cuda", index)
        self.lock = threading.Lock()
        self.work: Optional[torch.Tensor] = None  # plan().workspace words, zeroed when made
        self.cap = 0         # tiles the workspace holds
        self.issued = 0      # tickets taken from its counter
        self.status: Optional[torch.Tensor] = None  # words 2 and 3 of the workspace
        self.host_in = self.dev_in = self.dev_out = self.host_out = None  # make_pass's

    def launch(self, n: int, handed: int, ser: int, table: Optional[int], fids: Optional[int],
               n_flows: int, arrivals: int, queues: Optional[int], status: Optional[int],
               busy0: int, latency: int) -> None:
        """Launch the kernel over n >= 1 frames (device pointers; table, fids
        and queues None for no steering, status None for the workspace's own
        pair, words 2 and 3) on the current stream of this device, which must
        be current."""
        global launches
        p = plan(n)
        if p.tiles > self.cap or self.issued + p.tiles >= TAGS:
            # a new workspace: no slot of any call, tickets (and tags) from 0
            cap = max(p.tiles, 2 * self.cap)
            self.work = torch.zeros(plan_words(cap), dtype=torch.int64, device=self.device)
            self.status, self.cap, self.issued = self.work[2:4], cap, 0
        lib, fn, raw_stream = _launcher or _fn()
        work = self.work.data_ptr()
        err = fn(handed, ser, table, fids, arrivals, queues,
                 work + 16 if status is None else status, work, n, n_flows, int(busy0),
                 int(latency), p.tiles, self.cap, self.issued, raw_stream(self.index))
        launches += 1
        _build.check(lib, "epoch_pass", err)
        self.issued += p.tiles

    def stage(self, n: int) -> int:
        """make_pass's buffers for n frames: pinned input words (t, s and
        flow ids, each from a 16-byte boundary) and their copy on the card;
        output words on the card (status, arrivals, queues) and their pinned
        copy. Returns the stride m of one array (n rounded up to even)."""
        m = n + (n & 1)
        self.host_in = _grow(self.host_in, 3 * m, pin_memory=True)
        self.dev_in = _grow(self.dev_in, 3 * m, device=self.device)
        self.dev_out = _grow(self.dev_out, 2 + 2 * m, device=self.device)
        self.host_out = _grow(self.host_out, 2 + 2 * m, pin_memory=True)
        return m


_devices: Dict[int, _Device] = {}
_devices_lock = threading.Lock()


def _device(index: int) -> _Device:
    d = _devices.get(index)
    if d is None:
        with _devices_lock:
            d = _devices.setdefault(index, _Device(index))
    return d


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
    IndexError. The kernel counts those ids beside busy_until, so the call's
    one read-back (16 bytes, a synchronisation) carries the check: checking
    on the host before the launch would need a read of the ids of its own."""
    n, steer = check_args(handed, ser, busy0, latency, table, fids)
    dev = handed.device
    arrivals = torch.empty(n, dtype=torch.int64, device=dev)
    queues = torch.empty(n, dtype=torch.int64, device=dev) if steer else None
    if n == 0:
        return arrivals, int(busy0), queues
    d = _device(handed.get_device())
    with d.lock:
        args = (n, handed.data_ptr(), ser.data_ptr(), table.data_ptr() if steer else None,
                fids.data_ptr() if steer else None, table.shape[0] if steer else 0,
                arrivals.data_ptr(), queues.data_ptr() if steer else None, None, busy0,
                latency)
        if d.index == torch.cuda.current_device():
            d.launch(*args)
        else:  # the launch goes to the current device: make it the tensors'
            with torch.cuda.device(d.index):
                d.launch(*args)
        busy, bad = d.status.tolist()
    if bad:
        raise bad_ids(bad, table.shape[0])
    return arrivals, busy, queues


class _CardPass:
    """``make_pass("cuda")``'s function: ``epoch_pass_np``'s signature, numpy
    in and out, the kernel on one device. A call copies its inputs into the
    device's pinned buffer (``np.copyto`` takes the engine's strided slices
    as they are), uploads them in one copy, launches the kernel, downloads
    status, arrivals and queues in one copy into the device's pinned output
    buffer and synchronises once. It returns copies of the arrays, since
    the engine keeps them while the next call rewrites the buffer (a fresh
    pinned buffer a call, from torch's caching host allocator, spared the
    copies but paid a page-locked allocation for each array the engine
    held at once: PERF.md, Findings). The steps are methods, so that
    ``chip_smoke.py`` can time each."""

    def __init__(self, device: torch.device):
        index = device.index if device.index is not None else torch.cuda.current_device()
        self.dev = _device(index)
        self.table = (None, None)  # the last table given, and its copy on the device

    def __call__(self, handed_ns, ser_ns, busy0_ns, latency_ns, flow_queue_table, flow_ids):
        steer = flow_queue_table is not None and flow_ids is not None
        n = len(handed_ns)
        if len(ser_ns) != n or (steer and len(flow_ids) != n):
            raise ValueError(f"epoch pass: {n} handed times, {len(ser_ns)} serialisation "
                             f"times and {len(flow_ids) if steer else 0} flow ids")
        check_ints(busy0_ns, latency_ns)
        if n == 0:
            empty = np.empty(0, dtype=np.int64)
            return empty, int(busy0_ns), empty.copy() if steer else None
        with self.dev.lock, torch.cuda.device(self.dev.index):
            m = self.stage(handed_ns, ser_ns, flow_ids if steer else None)
            self.upload(n, m, steer)
            n_flows = self.launch(n, m, busy0_ns, latency_ns,
                                  flow_queue_table if steer else None)
            self.download(n, m, steer)
            torch.cuda.current_stream().synchronize()
            return self.finish(n, m, steer, n_flows)

    # the steps of a call, on the device's current stream with its lock held

    def stage(self, handed_ns, ser_ns, flow_ids) -> int:
        m = self.dev.stage(len(handed_ns))
        host = self.dev.host_in.numpy()
        n = len(handed_ns)
        np.copyto(host[:n], handed_ns, casting="unsafe")
        np.copyto(host[m:m + n], ser_ns, casting="unsafe")
        if flow_ids is not None:
            np.copyto(host[2 * m:2 * m + n], flow_ids, casting="unsafe")
        return m

    def upload(self, n: int, m: int, steer: bool) -> None:
        k = (2 * m if steer else m) + n
        self.dev.dev_in[:k].copy_(self.dev.host_in[:k], non_blocking=True)

    def launch(self, n: int, m: int, busy0_ns, latency_ns, flow_queue_table) -> int:
        """The kernel on the staged inputs; flow_queue_table None for no
        steering. Returns the table's n_flows."""
        d = self.dev
        src, out = d.dev_in.data_ptr(), d.dev_out.data_ptr()
        if flow_queue_table is None:
            d.launch(n, src, src + 8 * m, None, None, 0, out + 16, None, out, busy0_ns,
                     latency_ns)
            return 0
        if self.table[0] is not flow_queue_table:
            t = torch.from_numpy(np.ascontiguousarray(flow_queue_table, dtype=np.int64))
            self.table = flow_queue_table, t.to(d.device)
        table = self.table[1]
        d.launch(n, src, src + 8 * m, table.data_ptr(), src + 16 * m, table.shape[0],
                 out + 16, out + 16 + 8 * m, out, busy0_ns, latency_ns)
        return table.shape[0]

    def download(self, n: int, m: int, steer: bool) -> None:
        k = 2 + (m if steer else 0) + n
        self.dev.host_out[:k].copy_(self.dev.dev_out[:k], non_blocking=True)

    def finish(self, n: int, m: int, steer: bool, n_flows: int):
        host = self.dev.host_out.numpy()
        busy, bad = int(host[0]), int(host[1])
        if bad:
            raise bad_ids(bad, n_flows)
        queues = host[2 + m:2 + m + n].copy() if steer else None
        return host[2:2 + n].copy(), busy, queues


def make_pass(device) -> Callable:
    """A function with ``epoch_pass_np``'s signature (numpy in,
    ``(arrivals, busy_until, queue_idx)`` numpy out) that runs the pass on
    ``device``: ``"cuda"`` launches the kernel (``_CardPass``), ``"cpu"``
    runs the plain version through ``ops.epoch_pass``. Raises at once for
    ``"cuda"`` where no CUDA device is present. The flow-queue table goes to
    the device once for each table object it is given (the engine builds
    one a port), not once an epoch."""
    from . import ops

    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the epoch pass runs on cpu or cuda, not {device.type!r}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the epoch pass on 'cuda' needs a CUDA device and none is "
                               "present; pass device='cpu' (plain torch) or None (numpy)")
        return _CardPass(device)
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
