"""Logical-axis sharding on a ``torch.distributed`` DeviceMesh (port of
``src/repro/parallel/axes.py``).

Model code names the axes of its tensors logically ("batch", "heads",
"ffn", "vocab", "fsdp", "experts", "kv_seq", ...). The launcher installs an
:class:`AxisRules` that maps logical names to mesh axes (single-pod,
multi-pod, pure FSDP, or none) together with a DeviceMesh. With no rules or
no mesh every call here returns its input, so the same model code runs on
one device and on a mesh.

Where the JAX package hands the whole layout to GSPMD, the port is explicit:

* a spec is a :class:`PartitionSpec`, a tuple of ``None | str | tuple of
  str`` per tensor dim, and :func:`placements` turns it into DTensor
  placements on a mesh;
* params on a mesh are DTensors; activations stay plain tensors holding the
  rank's own batch rows (the batch is split over the mesh axes the rules
  give "batch", :func:`batch_axes`). The dense layers run no tensor
  parallelism: their work over any other axis is replicated;
* :func:`gather_weight` gathers a param where it is read, under every rule
  set (the JAX package gathers at use only under ``gather_weights_at_use``
  and leaves the rest to GSPMD). The gathered copy's gradient is taken as
  partial over the batch axes and replicated over the others, so the
  backward reduce-scatters over the batch axes and sums no identical copies.
  A param read without it raises (a DTensor mixed with a plain tensor).
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Mesh axes per tensor dim (``jax.sharding.PartitionSpec``): each entry
    None, a mesh axis, or a tuple of mesh axes, major first. As JAX does, a
    tuple of one axis is kept as that axis and an empty one as None."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        def canonical(part):
            if isinstance(part, tuple):
                part = tuple(a for a in part if a is not None)
                return part[0] if len(part) == 1 else (part or None)
            return part
        return super().__new__(cls, [canonical(p) for p in parts])

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x: Any) -> bool:
    """``is_leaf`` for trees of specs (``repro_torch.tree``)."""
    return isinstance(x, PartitionSpec)


@dataclass(frozen=True)
class AxisRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    rules: Dict[str, MeshAxes] = field(default_factory=dict)
    # the JAX layout's choice to gather weights at use (pure FSDP); the port
    # gathers every param at use under every rule set, so nothing reads it
    # but the comparison of rule sets with the JAX package's
    gather_weights_at_use: bool = False

    def resolve(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, *logical_axes: Optional[str]) -> PartitionSpec:
        return PartitionSpec(*[self.resolve(a) for a in logical_axes])


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> List[Any]:
        return placements(self.spec, self.mesh)


# -- the active rules ------------------------------------------------------------
class _State:
    """The rules and mesh ``axis_rules`` installs, for the whole process (the
    JAX package keeps them per thread): the autograd engine runs a CUDA
    backward, and the layers' recomputes under ``torch.utils.checkpoint``,
    on threads of its own, which must read the same rules."""

    def __init__(self) -> None:
        self.rules: Optional[AxisRules] = None
        self.mesh: Optional[Any] = None


_STATE = _State()


@contextmanager
def axis_rules(rules: AxisRules, mesh: Optional[Any] = None) -> Iterator[None]:
    prev_r, prev_m = _STATE.rules, _STATE.mesh
    _STATE.rules, _STATE.mesh = rules, mesh
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh = prev_r, prev_m


def current_rules() -> Optional[AxisRules]:
    return _STATE.rules


def current_mesh() -> Optional[Any]:
    return _STATE.mesh


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a stand-in whose ``shape`` is
    that dict already (as the JAX package's tests use)."""
    shape = mesh.shape
    return dict(shape) if isinstance(shape, dict) else dict(zip(mesh.mesh_dim_names, shape))


def _axes_tuple(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(a for a in axes if a is not None)


def placements(spec: PartitionSpec, mesh: Any) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: ``Shard(d)``
    on each mesh axis that tensor dim d is split over, ``Replicate()`` on
    the rest. Several mesh axes on one dim (``("data", "model")``) nest
    major first, as JAX nests them, which DTensor does in mesh order."""
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        idx = [names.index(a) for a in _axes_tuple(axes)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: mesh axes {axes} of dim {d} are not in "
                             f"mesh order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} used twice")
            out[i] = Shard(d)
    return out


def logical_spec(*logical_axes: Optional[str]) -> PartitionSpec:
    """Resolve logical axes to a spec under the active rules."""
    rules = current_rules()
    if rules is None:
        return PartitionSpec()
    return rules.spec(*logical_axes)


def batch_axes() -> Tuple[str, ...]:
    """The mesh axes the active rules split the batch rows over (the
    data-parallel axes), in mesh order; () without rules or mesh."""
    rules, mesh = _STATE.rules, _STATE.mesh
    if rules is None or mesh is None:
        return ()
    axes = _axes_tuple(rules.resolve("batch"))
    return tuple(a for a in mesh.mesh_dim_names if a in axes)


def batch_shards() -> int:
    """How many ways the batch rows are split (1 without rules or mesh)."""
    mesh = _STATE.mesh
    n = 1
    for a in batch_axes():
        n *= mesh_sizes(mesh)[a]
    return n


def batch_index() -> int:
    """This rank's block of the batch rows, major axis first."""
    mesh = _STATE.mesh
    i = 0
    for a in batch_axes():
        i = i * mesh_sizes(mesh)[a] + mesh.get_local_rank(a)
    return i


def sum_over(t: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the active mesh's ``axes``, with no
    gradient through it; ``t`` itself where ``axes`` is empty."""
    if not axes:
        return t
    out = t.detach().clone()
    for a in axes:
        dist.all_reduce(out, group=_STATE.mesh.get_group(a))
    return out


def shard(x: Any, *logical_axes: Optional[str]) -> Any:
    """``with_sharding_constraint`` by logical axes. A DTensor is laid out by
    the active rules; an activation, a plain tensor of the rank's own batch
    rows, passes as it is (the port runs no tensor parallelism), and so
    does everything without rules or mesh."""
    mesh = _STATE.mesh
    if mesh is None or _STATE.rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(_STATE.rules.spec(*logical_axes), mesh))


def gather_weight(w: Any) -> Any:
    """A param, whole and local, where it is read: a DTensor is gathered
    (replicated) and handed over as a plain tensor whose gradient is partial
    over the batch axes and replicated over the others. Anything else, and
    everything without rules or mesh, passes as it is."""
    mesh = _STATE.mesh
    if mesh is None or _STATE.rules is None or not isinstance(w, DTensor):
        return w
    rows = batch_axes()
    grad = [Partial() if a in rows else Replicate() for a in mesh.mesh_dim_names]
    return w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad)


def named_sharding(*logical_axes: Optional[str]) -> Optional[NamedSharding]:
    rules = current_rules()
    if rules is None or _STATE.mesh is None:
        return None
    return NamedSharding(_STATE.mesh, rules.spec(*logical_axes))


# -- standard rule sets -----------------------------------------------------------

def single_pod_rules() -> AxisRules:
    """(data=16, model=16) mesh."""
    return AxisRules(rules={
        "batch": ("data",),      # DP/FSDP batch dim
        "fsdp": ("data",),       # parameter storage sharding (ZeRO-3 style)
        "heads": "model",        # TP attention heads
        "kv_heads": None,        # GQA KV heads: replicated under TP
        "ffn": "model",          # TP MLP hidden
        "vocab": "model",        # TP vocab/logits
        "embed": None,           # d_model stays unsharded in activations
        "experts": "model",      # EP expert dim
        "seq": None,             # sequence dim of activations (train/prefill)
        "kv_seq": "model",       # decode KV-cache sequence dim (flash-decoding)
        "seq_shard": "model",    # context-parallel sequence dim (long ctx / EDP)
        "ssm_heads": "model",    # SSM / RG-LRU state heads
    })


def multi_pod_rules() -> AxisRules:
    """(pod=2, data=16, model=16) mesh — pod extends the DP axis; FSDP stays
    intra-pod so param all-gathers never cross the (slow) pod interconnect."""
    r = single_pod_rules().rules.copy()
    r["batch"] = ("pod", "data")
    return AxisRules(rules=r)


def pure_fsdp_rules() -> AxisRules:
    """Single-pod (data=16, model=16) with NO tensor parallelism: both mesh
    axes act as one 256-way DP/FSDP domain. Requires global_batch % 256 == 0."""
    return AxisRules(rules={
        "batch": ("data", "model"),
        "fsdp": ("data", "model"),
        "heads": None,
        "kv_heads": None,
        "ffn": None,
        "vocab": None,
        "embed": None,
        "experts": None,
        "seq": None,
        "kv_seq": None,
        "seq_shard": None,
        "ssm_heads": None,
    }, gather_weights_at_use=True)


def no_rules() -> AxisRules:
    return AxisRules(rules={})
