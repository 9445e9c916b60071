"""What a step costs, counted from what it dispatches (the counterpart of
``src/repro/parallel/hlo_counter.py``, which reads compiled HLO text).

``OpCounter`` is a ``TorchDispatchMode``: every aten op, collective and
kernel op that a step dispatches passes through it, on real tensors (CUDA
or CPU) or on fake ones (``FakeTensorMode``, the dry run), and the same step
gives the same counts either way, since nothing here reads a value. Eager
PyTorch runs every iteration of a Python loop (the layer stack, the loss's
sequence chunks), so each is counted as it runs: there are no while-loop
trip counts to recover, and ``OpCost`` has ``HloCost``'s fields without
``n_while`` and ``max_trip``.

* **dot FLOP**: ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and ``convolution``
  by the JAX package's rule, 2 · output elements · contraction; and each
  kernel op's FLOP from its function in ``kernels/costs.py`` (the functions
  that ``chip_smoke.py``'s bound rows use).
* **HBM bytes**: operand and result bytes of every op that launches a
  kernel (views and metadata ops launch none and are left out); a gather
  (``index``, ``index_select``, ``gather``, ``embedding``) counts its
  result read and written, a scatter or indexed write (``index_put``,
  ``index_add``, ``scatter``) its updates read and written, and ``copy_``
  its source and destination, as ``hlo_counter`` counts its slices. Unlike
  the JAX package's TPU proxy, elementwise ops are counted: in the eager
  port each is a kernel of its own (``elementwise_bytes`` holds their part).
  A kernel op counts its function's bytes (``kernels/costs.py``): decode's
  over every cache slot, since the counter reads no lengths.
* **collectives**: c10d ops and functional collectives, DTensor's
  redistributions included (the mode lets DTensor turn an op into its
  collectives first, as ``CommDebugMode`` does): count, operand bytes and
  ring wire bytes (``analysis.ring_wire_bytes``) per kind and per group
  size, and the wire bytes of groups inside one node apart.
* **kernel calls** by name (the launch counters' names).
* **peak live bytes**: the largest sum over the step of the storages that
  its ops made and that were still referenced (the memory record's
  temporaries); storages that existed before the step are the caller's.

DTensor works out an op's global output shape by running the op on fake
tensors of the global shapes (``ShardingPropagator``); under a
``FakeTensorMode`` already active (the dry run's) those ops pass through
this mode, and under none they do not. They are not the step's work, so the
counter pauses while DTensor propagates.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# importing the kernel modules registers the repro_torch ops
from repro_torch.kernels import (costs, decode_attention, flash_attention,  # noqa: F401
                                 flash_attention_bwd, rglru_scan, rglru_scan_bwd, ssd_scan,
                                 ssd_scan_bwd)
from .analysis import crosses_nodes, ring_wire_bytes


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _bytes(x: Any) -> int:
    return sum(_size(t) for t in _tensors(x))


# -- the kernel ops: launch counter's name and work, from the op's arguments ---------

def _flash_fwd(q, k, v, causal, window, q_offset, scale, with_lse):
    return costs.flash_forward(q.shape, k.shape, q.element_size(), causal=causal,
                               window=window, q_offset=q_offset, with_lse=with_lse)


def _flash_bwd(q, k, v, out, lse, dout, causal, window, q_offset, scale):
    return costs.flash_backward(q.shape, k.shape, q.element_size(), causal=causal,
                                window=window, q_offset=q_offset)


def _decode(q, k_cache, v_cache, cache_len, scale):
    return costs.decode(q.shape, k_cache.shape, q.element_size(),
                        k_cache.shape[0] * k_cache.shape[1])


def _decode_lse(q, k_cache, v_cache, cache_len, scale):
    return costs.decode(q.shape, k_cache.shape, q.element_size(),
                        k_cache.shape[0] * k_cache.shape[1], with_lse=True)


def _ssd_fwd(x, dt, A, Bmat, Cmat, h0, chunk):
    B, S, H, P = x.shape
    return costs.ssd_forward(B, S, H, P, Bmat.shape[-1], chunk, x.element_size(),
                             h0 is not None)


def _ssd_bwd(x, dt, A, Bmat, Cmat, h0, dy, dh_final, chunk, ws):
    B, S, H, P = x.shape
    return costs.ssd_backward(B, S, H, P, Bmat.shape[-1], chunk, x.element_size(),
                              h0 is not None, dh_final is not None)


def _rglru_fwd(x, a_log, h0):
    return costs.rglru_forward(*x.shape, x.element_size(), h0 is not None)


def _rglru_bwd(x, a_log, h0, dy, dh_last, ws):
    return costs.rglru_backward(*x.shape, x.element_size(), h0 is not None,
                                dh_last is not None)


KERNEL_OPS: Dict[str, Tuple[str, Callable[..., costs.Work]]] = {
    "flash_attention_fwd": ("flash_attention", _flash_fwd),
    "flash_attention_bwd": ("flash_attention_bwd", _flash_bwd),
    "decode_attention": ("decode_attention", _decode),
    "decode_attention_lse": ("decode_attention", _decode_lse),
    "ssd_scan_fwd": ("ssd_scan", _ssd_fwd),
    "ssd_scan_bwd": ("ssd_scan_bwd", _ssd_bwd),
    "rglru_scan_fwd": ("rglru_scan", _rglru_fwd),
    "rglru_scan_bwd": ("rglru_scan_bwd", _rglru_bwd),
}


def _shape_stub(shape, itemsize: int = 2):
    """A stand-in for a tensor of ``shape`` (FlopCounterMode passes shapes)."""
    class _T:
        def __init__(self):
            self.shape = tuple(shape)

        def element_size(self):
            return itemsize
    return _T()


def _register_flop_formulas() -> None:
    """Each kernel op's FLOP, from the same functions, for
    ``torch.utils.flop_counter.FlopCounterMode``."""
    from torch.utils.flop_counter import register_flop_formula

    for name, (_, work) in KERNEL_OPS.items():
        def formula(*args, out_shape=None, _work=work, **kwargs):
            stubs = [_shape_stub(a) if isinstance(a, torch.Size) else a for a in args]
            return int(_work(*stubs).flops)
        register_flop_formula(getattr(torch.ops.repro_torch, name))(formula)


_register_flop_formulas()


# -- the aten ops ------------------------------------------------------------------

_aten = torch.ops.aten
# ops that launch no kernel though their schemas are not views: allocations,
# metadata, and the reshapes that matmul's decomposition returns
_NO_KERNEL = {getattr(getattr(_aten, op), overload) for op, overload in (
    ("empty", "memory_format"), ("empty_strided", "default"), ("empty_like", "default"),
    ("new_empty", "default"), ("new_empty_strided", "default"), ("lift_fresh", "default"),
    ("detach", "default"), ("sym_size", "int"), ("sym_stride", "int"),
    ("sym_numel", "default"), ("sym_storage_offset", "default"), ("is_same_size", "default"),
    ("_unsafe_view", "default"), ("_has_compatible_shallow_copy_type", "default"))}
_GATHERS = {_aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
            _aten.embedding.default}
_SCATTERS = {  # op → index of the updates argument
    _aten.index_put_.default: 2, _aten.index_put.default: 2,
    _aten._index_put_impl_.default: 2, _aten.index_add_.default: 3,
    _aten.index_add.default: 3, _aten.scatter_.src: 3, _aten.scatter.src: 3,
    _aten.scatter_add_.default: 3, _aten.scatter_add.default: 3,
}


def _same_place(t: torch.Tensor, kwargs) -> bool:
    """A ``_to_copy`` of ``t`` that changes neither its dtype, device, layout
    nor memory format."""
    return (kwargs.get("dtype") in (None, t.dtype) and kwargs.get("device") in (None, t.device)
            and kwargs.get("layout") in (None, t.layout)
            and kwargs.get("memory_format") in (None, torch.preserve_format))


def _dot_flops(func, args, out) -> float:
    if func in (_aten.mm.default, _aten.bmm.default):
        return 2.0 * out.numel() * args[0].shape[-1]
    if func in (_aten.addmm.default, _aten.baddbmm.default):
        return 2.0 * out.numel() * args[1].shape[-1]
    if func is _aten.convolution.default:
        w = args[1]
        return 2.0 * out.numel() * (w.numel() // w.shape[0])
    return 0.0


# -- collectives ----------------------------------------------------------------------

_c10d = torch.ops.c10d
_fc = torch.ops._c10d_functional


def _c10d_collectives() -> Dict[Any, Tuple[str, Callable]]:
    """op → (kind, (args → (operand tensors, process group)))."""
    out = {}

    def add(name, overload, kind, fn):
        packet = getattr(_c10d, name, None)
        if packet is not None:
            out[getattr(packet, overload)] = (kind, fn)
    add("allreduce_", "default", "all-reduce", lambda a: (a[0], a[1]))
    add("allreduce_coalesced_", "default", "all-reduce", lambda a: (a[0], a[1]))
    add("allgather_", "default", "all-gather", lambda a: (a[1], a[2]))
    add("_allgather_base_", "default", "all-gather", lambda a: (a[1], a[2]))
    add("allgather_into_tensor_coalesced_", "default", "all-gather", lambda a: (a[1], a[2]))
    add("reduce_scatter_", "default", "reduce-scatter", lambda a: (a[1], a[2]))
    add("_reduce_scatter_base_", "default", "reduce-scatter", lambda a: (a[1], a[2]))
    add("reduce_scatter_tensor_coalesced_", "default", "reduce-scatter",
        lambda a: (a[1], a[2]))
    add("alltoall_", "default", "all-to-all", lambda a: (a[1], a[2]))
    add("alltoall_base_", "default", "all-to-all", lambda a: (a[1], a[2]))
    add("send", "default", "collective-permute", lambda a: (a[0], a[1]))
    return out


def _functional_collectives() -> Dict[Any, Tuple[str, int, int]]:
    """op → (kind, index of the operand, index of the group name)."""
    table = {"all_reduce": ("all-reduce", 0, 2), "all_reduce_": ("all-reduce", 0, 2),
             "all_reduce_coalesced": ("all-reduce", 0, 2),
             "all_gather_into_tensor": ("all-gather", 0, 2),
             "all_gather_into_tensor_coalesced": ("all-gather", 0, 2),
             "reduce_scatter_tensor": ("reduce-scatter", 0, 3),
             "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0, 3),
             "all_to_all_single": ("all-to-all", 0, 3)}
    return {getattr(_fc, n).default: v for n, v in table.items() if hasattr(_fc, n)}


_C10D = _c10d_collectives()
_FUNCTIONAL = _functional_collectives()
_SKIP_COMM = {_fc.wait_tensor.default}
for _name in ("barrier", "recv_", "recv_any_source_"):
    if hasattr(_c10d, _name):
        _SKIP_COMM.add(getattr(_c10d, _name).default)


def _group_of(func, args) -> Tuple[str, List[torch.Tensor], Any]:
    if func in _C10D:
        kind, pick = _C10D[func]
        operands, pg = pick(args)
        if isinstance(pg, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(pg)
        return kind, _tensors(operands), pg
    kind, i_op, i_group = _FUNCTIONAL[func]
    from torch.distributed.distributed_c10d import _resolve_process_group
    return kind, _tensors(args[i_op]), _resolve_process_group(args[i_group])


# -- the cost and the mode ------------------------------------------------------------

@dataclass
class OpCost:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_counts: Dict[str, float] = field(default_factory=dict)
    collective_op_bytes: Dict[str, float] = field(default_factory=dict)
    collective_wire_bytes: Dict[str, float] = field(default_factory=dict)
    # beyond HloCost
    elementwise_bytes: float = 0.0
    kernel_flops: float = 0.0  # the kernel ops' part of dot_flops
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    # kind → group size → {"count", "op_bytes", "wire_bytes"}
    collective_groups: Dict[str, Dict[int, Dict[str, float]]] = field(default_factory=dict)
    nvlink_wire_bytes: float = 0.0
    peak_live_bytes: int = 0
    # op name → [calls, HBM bytes, dot FLOP]: where two runs' counts differ
    by_op: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.collective_wire_bytes.values())

    def add_collective(self, kind: str, n: float, op_b: float, wire_b: float):
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) + n
        self.collective_op_bytes[kind] = self.collective_op_bytes.get(kind, 0) + op_b
        self.collective_wire_bytes[kind] = self.collective_wire_bytes.get(kind, 0) + wire_b

    def counts(self) -> Dict[str, Any]:
        """What a fake run must reproduce of a real one: dot FLOP, HBM and
        elementwise bytes, kernel calls, collectives."""
        return {"dot_flops": self.dot_flops, "kernel_flops": self.kernel_flops,
                "hbm_bytes": self.hbm_bytes,
                "elementwise_bytes": self.elementwise_bytes,
                "kernel_calls": dict(sorted(self.kernel_calls.items())),
                "collective_counts": dict(sorted(self.collective_counts.items())),
                "collective_op_bytes": dict(sorted(self.collective_op_bytes.items())),
                "collective_wire_bytes": dict(sorted(self.collective_wire_bytes.items()))}


class OpCounter(TorchDispatchMode):
    """Counts what runs under it into ``self.cost`` (see the module's note).

        with OpCounter() as c:
            step(...)
        c.cost.dot_flops
    """

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._propagating = threading.local()  # DTensor's shape propagation, per thread
        self._saved_propagate = None
        self._seen: Dict[int, Any] = {}   # storages seen: id → weakref (or None)
        self._live: Dict[int, int] = {}   # storages the step made, still alive: id → bytes
        self._live_bytes = 0

    # -- memory ---------------------------------------------------------------------
    def _note_inputs(self, ts: List[torch.Tensor]) -> None:
        for t in ts:
            s = t.untyped_storage()
            if id(s) not in self._seen:
                self._seen[id(s)] = weakref.ref(s, self._forget(id(s)))

    def _forget(self, key: int):
        def cb(_):
            self._seen.pop(key, None)
            self._live_bytes -= self._live.pop(key, 0)
        return cb

    def _note_outputs(self, ts: List[torch.Tensor]) -> None:
        for t in ts:
            s = t.untyped_storage()
            key = id(s)
            ref = self._seen.get(key)
            if ref is not None and ref() is s:
                continue
            self._seen[key] = weakref.ref(s, self._forget(key))
            n = s.nbytes()
            self._live[key] = n
            self._live_bytes += n
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self._live_bytes)

    @property
    def live_bytes(self) -> int:
        """Bytes of the storages the counted ops made that are still alive."""
        return self._live_bytes

    # -- DTensor's shape propagation ------------------------------------------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        counter, saved = self, ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, op_schema):
            counter._propagating.depth = getattr(counter._propagating, "depth", 0) + 1
            try:
                return saved(prop, op_schema)
            finally:
                counter._propagating.depth -= 1
        self._saved_propagate = saved
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._saved_propagate
        return super().__exit__(*exc)

    # -- dispatch -------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first, into local ops and collectives
        if getattr(self._propagating, "depth", 0):
            return func(*args, **kwargs)
        if func is _aten._to_copy.default and _same_place(args[0], kwargs):
            # Tensor.to on a real tensor returns the tensor itself and
            # dispatches nothing; on a fake one whose C++ device reads "meta"
            # (the dry run) it dispatches this copy, which is not counted
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        self._note_inputs(ins)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._count(func, args, ins, out, outs)
        self._note_outputs(outs)
        return out

    def _count(self, func, args, ins, out, outs) -> None:
        cost = self.cost
        before = cost.hbm_bytes, cost.dot_flops
        self._tally(func, args, ins, out, outs)
        if func.namespace == "prim":
            return
        row = cost.by_op.setdefault(str(func), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += cost.hbm_bytes - before[0]
        row[2] += cost.dot_flops - before[1]

    def _tally(self, func, args, ins, out, outs) -> None:
        cost = self.cost
        if func in _NO_KERNEL or func in _SKIP_COMM or func.namespace == "prim":
            return
        if func.namespace == "repro_torch":
            name, work = KERNEL_OPS[func._opname]
            w = work(*args)
            cost.kernel_calls[name] = cost.kernel_calls.get(name, 0) + 1
            cost.dot_flops += w.flops
            cost.kernel_flops += w.flops
            cost.hbm_bytes += w.bytes
            return
        if func in _C10D or func in _FUNCTIONAL:
            kind, operands, pg = _group_of(func, args)
            g = pg.size()
            op_b = sum(_size(t) for t in operands)
            wire = ring_wire_bytes(kind, op_b, g)
            cost.add_collective(kind, 1, op_b, wire)
            per = cost.collective_groups.setdefault(kind, {}).setdefault(
                g, {"count": 0, "op_bytes": 0, "wire_bytes": 0.0})
            per["count"] += 1
            per["op_bytes"] += op_b
            per["wire_bytes"] += wire
            if not crosses_nodes(dist.get_process_group_ranks(pg)):
                cost.nvlink_wire_bytes += wire
            cost.hbm_bytes += sum(_size(t) for t in ins) + sum(_size(t) for t in outs)
            return
        if func.namespace in ("c10d", "_c10d_functional"):
            raise NotImplementedError(f"OpCounter: no rule for the collective {func}")
        if func.is_view:
            return
        if func in _GATHERS:
            cost.hbm_bytes += 2 * _bytes(out)
            return
        if func in _SCATTERS:
            cost.hbm_bytes += 2 * _bytes(args[_SCATTERS[func]])
            return
        if func is _aten.copy_.default:
            cost.hbm_bytes += _size(args[0]) + _size(args[1])
            return
        io = sum(_size(t) for t in ins) + sum(_size(t) for t in outs)
        cost.hbm_bytes += io
        if torch.Tag.pointwise in func.tags:
            cost.elementwise_bytes += io
        cost.dot_flops += _dot_flops(func, args, out)


def fresh_storages(tree: Any, held: Any = None) -> int:
    """Bytes of the distinct storages under ``tree`` (DTensors by their local
    shard), leaving out those under ``held``: what a rank holds of it."""
    from torch.distributed.tensor import DTensor

    def storages(x):
        for t in _tensors(x):
            yield (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
    seen = {id(s) for s in storages(held)}
    n = 0
    for s in storages(tree):
        if id(s) not in seen:
            seen.add(id(s))
            n += s.nbytes()
    return n
