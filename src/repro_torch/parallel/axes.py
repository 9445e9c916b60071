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
  give "batch", :func:`batch_axes`);
* the dense layers of ``models/layers.py`` run tensor-parallel over
  ``model``, Megatron-style, where the rules put "heads", "ffn" or "vocab"
  on ``model`` (``single_pod_rules``, ``multi_pod_rules``) and the param's
  sanitised spec splits that dim (:func:`tp_split`): attention by heads
  (``wq`` and ``wo`` read as the rank's slice, :func:`local_weight`; ``wk``
  and ``wv`` whole and sliced to the kv heads the rank's q heads read), the
  MLP by ``ffn``, the embedding, the logits and the loss by ``vocab``. An
  activation is whole on every model rank between the layers: it enters a
  column-parallel product through :func:`copy_to_model` (Megatron's *f*)
  and leaves a row-parallel one through :func:`reduce_from_model` (*g*). A
  dim the mesh does not divide (phi4-mini's and llama3.2's 24 heads over
  16, llama4's 40) keeps the replicated work, and so does a model axis of
  size 1, with no collective and today's ops. The recurrent blocks split
  the same way: mamba2's SSD blocks by ``ssm_heads`` (``models/mamba2.py``:
  each rank its heads' z, x and dt columns of ``in_proj``, B and C whole,
  ``out_proj`` row-parallel; the gated RMSNorm's statistic over all of
  ``d_inner`` is :func:`stat_over_model`), the RG-LRU blocks by ``ffn``
  (``models/rglru.py``: each rank W/m columns of the recurrence, and where
  the 8 gate blocks straddle ranks, m > 8, the input and conv of its whole
  block). The MoE experts (``models/moe.py``) are expert-parallel.
  Decode is context-sharded where the rules put ``kv_seq`` on ``model`` and
  the model size m divides the cache's C slots (:func:`kv_seq_span`): each
  rank holds slots [r·C/m, (r+1)·C/m) of every kv head for its batch rows,
  attends all q heads over them (the new token's q, k and v heads from
  every rank, :func:`gather_heads`), and the ranks' partial outputs merge
  by their logsumexps (:func:`merge_over_model`);
  the prefill hands each rank its slots (:func:`slots_from_heads` where the
  kv heads split). Elsewhere each rank holds its rows' caches over every
  slot, of the kv heads its q heads read;
* :func:`gather_weight` gathers a param where it is read whole, under every
  rule set (the JAX package gathers at use only under
  ``gather_weights_at_use`` and leaves the rest to GSPMD). The gathered
  copy's gradient is taken as partial over the batch axes and replicated
  over the others, so the backward reduce-scatters over the batch axes and
  sums no identical copies; :func:`gather_partial` takes it as partial over
  ``model`` too, for a whole param that each model rank reads only in part.
  A param read without one of these raises (a DTensor mixed with a plain
  tensor).
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
    rows (whole over ``model`` between the dense layers), passes as it is,
    and so does everything without rules or mesh."""
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


def gather_partial(w: Any) -> Any:
    """``gather_weight``'s whole param, whose gradient is partial over
    ``model`` as well as over the batch axes: a replicated param that each
    model rank reads only in part under tensor parallelism (the kv heads of
    its q heads, its slice of a bias) or applies to its own share of the
    work (the qk-norm scales of its heads)."""
    mesh = _STATE.mesh
    if mesh is None or _STATE.rules is None or not isinstance(w, DTensor):
        return w
    rows = batch_axes()
    grad = [Partial() if a in rows or a == "model" else Replicate()
            for a in mesh.mesh_dim_names]
    return w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad)


# -- tensor parallelism over "model" ------------------------------------------------

def _on_model(logical: str) -> int:
    """The ``model`` axis size where the rules put ``logical`` on ``model``
    alone; 1 elsewhere (no rules or mesh, other axes)."""
    rules, mesh = _STATE.rules, _STATE.mesh
    if rules is None or mesh is None or _axes_tuple(rules.resolve(logical)) != ("model",):
        return 1
    return mesh_sizes(mesh).get("model", 1)


def tp_split(logical: str, n: int) -> Tuple[int, int]:
    """(m, r): the ``model`` axis size that splits a dim of size ``n`` named
    ``logical``, and this rank's block of it; (1, 0) where the dim is not
    split: no rules or mesh, rules that do not put ``logical`` on ``model``
    alone, a model axis of size 1, or ``n`` not a multiple of its size (the
    dim is stored whole, ``specs.sanitize_spec``)."""
    m = _on_model(logical)
    if m == 1 or n % m:
        return 1, 0
    return m, _STATE.mesh.get_local_rank("model")


def local_weight(w: Any) -> torch.Tensor:
    """This model rank's shard of a param whose spec splits a dim over
    ``model``, gathered over the other mesh axes (the ``fsdp`` ones), as a
    plain tensor. Its gradient is that shard's alone over ``model``
    (``Shard``) and partial over the batch axes."""
    mesh = _STATE.mesh
    names = list(mesh.mesh_dim_names)
    on_model = w.placements[names.index("model")]
    if not isinstance(on_model, Shard):
        raise ValueError(f"local_weight: a param of shape {tuple(w.shape)} placed "
                         f"{w.placements} is not split over 'model'")
    rows = batch_axes()
    target = [on_model if a == "model" else Replicate() for a in names]
    grad = [on_model if a == "model" else Partial() if a in rows else Replicate()
            for a in names]
    return w.redistribute(mesh, target).to_local(grad_placements=grad)


def _model_group():
    return _STATE.mesh.get_group("model")


class SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``group``: a value
    every rank of the group holds alike enters work that differs by rank
    (Megatron's *f* over ``model``, where each rank's column-parallel
    product gives a part of the gradient; the MoE layer's pool)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the sum over ``model`` of each rank's part, whose
    gradient passes as it is (every rank uses the sum alike)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Every model rank's block of the last dim, concatenated in rank order;
    the backward hands each rank the gradient of its own block (every rank
    uses the whole alike)."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.block, ctx.rank = x.shape[-1], rank
        m = dist.get_world_size(group)
        x0 = x.movedim(-1, 0).contiguous()
        out = x0.new_empty((m * x0.shape[0], *x0.shape[1:]))
        dist.all_gather_into_tensor(out, x0, group=group)
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.block
        return grad[..., lo:lo + ctx.block], None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """A whole activation entering column-parallel products (*f*)."""
    return SumGrad.apply(x, _model_group())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of a row-parallel product's parts (*g*)."""
    return _ReduceFromModel.apply(x, _model_group())


def stat_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of a statistic each rank takes over its own
    slice of a dim and then applies to that slice alone (the gated RMSNorm's
    sum of squares over ``d_inner``): an all-reduce forward and backward.
    Megatron's *g* alone passes the gradient as it is, right where every
    rank uses the sum alike; here each rank's use reaches other columns, so
    the sum's gradient is the sum of every rank's part, and each rank's own
    statistic takes all of it."""
    return copy_to_model(reduce_from_model(x))


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' blocks of the last dim, whole (the logits)."""
    return _GatherFromModel.apply(x, _model_group(), _STATE.mesh.get_local_rank("model"))


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model``, with no gradient through it."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_model_group())
    return out


# -- context-sharded decode over "model" (kv_seq) ------------------------------------

def splits_kv_seq() -> bool:
    """Whether the active rules and mesh split a decode cache's slots over
    ``model`` where its size divides them: a cache's whole length must then
    be known to tell a rank's share from a whole cache."""
    return _on_model("kv_seq") > 1


def kv_seq_span(n_slots: int) -> Optional[Tuple[int, int]]:
    """[lo, hi): the slots this rank holds of a decode cache of ``n_slots``
    slots, [r·C/m, (r+1)·C/m) of model rank r, where the rules put
    ``kv_seq`` on ``model`` and its size m > 1 divides C; None where the rank
    holds all of them (``tp_split``)."""
    m, r = tp_split("kv_seq", n_slots)
    if m == 1:
        return None
    n = n_slots // m
    return r * n, (r + 1) * n


def gather_heads(x: torch.Tensor) -> torch.Tensor:
    """Every model rank's heads of ``x`` (..., h, Dh): (..., m·h, Dh) in rank
    order (one all-gather over ``model``; no gradient through it)."""
    group = _model_group()
    m = dist.get_world_size(group)
    x0 = x.movedim(-2, 0).contiguous()
    out = x0.new_empty((m * x0.shape[0], *x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, -2).contiguous()


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Attention over the union of m disjoint slot shares, from each share's
    output ``outs`` (m, ..., Dh) and logsumexp ``lses`` (m, ...): share s
    weighs exp(lse_s - max lse), and the weighted sum and the weights' sum
    are taken in f32, in share order (the same sums on every call), their
    quotient the result, f32. A share with no valid slot (lse -inf, output
    0) adds nothing, and a row that has none in any share gives 0, as the
    decode kernel gives it."""
    outs, lses = outs.float(), lses.float()
    top = lses.amax(0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    num = torch.zeros_like(outs[0])
    den = torch.zeros_like(top)
    for s in range(outs.shape[0]):
        w = torch.exp(lses[s] - top)
        num = num + w[..., None] * outs[s]
        den = den + w
    # den >= 1 where a share has a valid slot (the largest weighs exp(0) = 1)
    return num / den.clamp_min(1.0)[..., None]


def merge_over_model(out: torch.Tensor, lse: torch.Tensor, split_heads: bool) -> torch.Tensor:
    """The decode attention of a cache whose slots are split over ``model``,
    from each rank's attention over its own slots: ``out`` (B, H, Dh) and
    its logsumexp ``lse`` (B, H) f32 over all H q heads, merged in rank
    order by :func:`merge_partials`, in ``out``'s dtype. Where the heads
    split (``split_heads``, H/m a rank), one all-to-all hands each rank
    every rank's partials of its own heads and the result is (B, H/m, Dh);
    else one all-gather hands every rank all of them, (B, H, Dh). Each
    partial travels in ``out``'s dtype with its f32 logsumexp's bits beside
    it (4 bytes as ``out``'s dtype), so a bf16 merge moves half the bytes of
    an f32 one and the logsumexp arrives exact."""
    group = _model_group()
    m = dist.get_world_size(group)
    B, H, Dh = out.shape
    packed = torch.cat([out, lse[..., None].view(out.dtype)], dim=-1)  # (B, H, Dh + w)
    w = packed.shape[-1] - Dh
    if split_heads:
        send = packed.view(B, m, H // m, Dh + w).movedim(1, 0).contiguous()
        parts = torch.empty_like(send)
        dist.all_to_all_single(parts, send, group=group)
    else:
        parts = packed.new_empty((m * B, H, Dh + w))
        dist.all_gather_into_tensor(parts, packed, group=group)
        parts = parts.view(m, B, H, Dh + w)
    lses = parts[..., Dh:].contiguous().view(torch.float32)[..., 0]
    return merge_partials(parts[..., :Dh], lses).to(out.dtype)


def slots_from_heads(kv: torch.Tensor, first_heads: List[int], n_heads: int) -> torch.Tensor:
    """This rank's slots of every kv head, from each model rank's kv heads
    over every slot: ``kv`` (..., C, n, Dh) holds the heads [first_heads[r],
    first_heads[r] + n) of this rank r, and the result (..., C/m, n_heads, Dh)
    this rank's slots [r·C/m, (r+1)·C/m) of heads 0 .. n_heads - 1 (one
    all-to-all over ``model``). Where several ranks hold a head they hold the
    same values, and the first of them is read."""
    group = _model_group()
    m = dist.get_world_size(group)
    C, n = kv.shape[-3], kv.shape[-2]
    send = kv.unflatten(-3, (m, C // m)).movedim(-4, 0).contiguous()  # (m, ..., C/m, n, Dh)
    parts = torch.empty_like(send)
    dist.all_to_all_single(parts, send, group=group)
    ranks, local = first_holders(first_heads, n, n_heads, kv.device)
    # parts[ranks[j], ..., local[j], :]: the advanced index puts the heads first
    picked = parts.movedim(-2, 1)[ranks, local]  # (n_heads, ..., C/m, Dh)
    return picked.movedim(0, -2)


def first_holders(first_heads: List[int], n: int, n_heads: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each of ``n_heads`` heads, the first model rank whose ``n`` heads
    from ``first_heads[rank]`` hold it, and its place among them."""
    src = [next(s for s in range(len(first_heads)) if first_heads[s] <= j < first_heads[s] + n)
           for j in range(n_heads)]
    return (torch.tensor(src, device=device),
            torch.tensor([j - first_heads[s] for j, s in enumerate(src)], device=device))


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
