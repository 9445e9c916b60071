"""Parameter, state, batch and cache specs (port of
``src/repro/parallel/specs.py``), and the placement of trees on a mesh.

Leaf-path pattern table → logical axes → (via AxisRules) mesh specs →
DTensor placements. FSDP ("data") shards a storage dim of every large
tensor; "model" shards heads, ffn, experts and vocab in storage. Every
param is gathered where it is read (``axes.gather_weight``), so a dim the
mesh cannot divide evenly is stored replicated (``sanitize_spec``), as the
JAX package does for its jit arguments.

The patterns match the port's ``/``-joined leaf paths
(``repro_torch.tree.leaf_paths``), which equal the JAX package's. The one
difference is an MoE layer's experts: off a mesh the port holds them whole,
``(n, E, D, F)`` and ``(n, E, F, D)``; on a mesh it holds them in the JAX
package's blocked layout for the mesh's model size, ``(n, TP, E/ep, D,
F/fp)`` (``expert_blocks``), which the JAX rows match unchanged. The whole
layout has rows of its own (leaf rank 4).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch import tree
from repro_torch.convert import experts_blocked
from repro_torch.models import layers, mamba2, rglru
from repro_torch.models.config import ModelConfig
from .axes import (AxisRules, NamedSharding, PartitionSpec, is_spec, kv_seq_span, mesh_sizes,
                   splits_kv_seq)

P = PartitionSpec

# (regex over the "/"-joined path, logical axes of the trailing dims, the
# leaf rank the row is for or None for any). Leading stack dims not covered
# by the axes are replicated (None).
_PARAM_RULES: List[Tuple[str, Optional[Tuple[Optional[str], ...]], Optional[int]]] = [
    # embeddings
    (r"embed/tok$", ("vocab", "fsdp"), None),
    (r"embed/unembed$", ("vocab", "fsdp"), None),
    # attention
    (r"attn/wq$", ("fsdp", "heads", None), None),
    (r"attn/wk$", ("fsdp", "kv_heads", None), None),
    (r"attn/wv$", ("fsdp", "kv_heads", None), None),
    (r"attn/wo$", ("heads", None, "fsdp"), None),
    (r"attn/(q_norm|k_norm)$", (None,), None),
    # dense mlp / shared expert
    (r"(mlp|shared)/w_gate$", ("fsdp", "ffn"), None),
    (r"(mlp|shared)/w_up$", ("fsdp", "ffn"), None),
    (r"(mlp|shared)/w_down$", ("ffn", "fsdp"), None),
    (r"(mlp|shared)/b_(up|down)$", (None,), None),
    # moe, the port's whole layout (n, E, D, F) / (n, E, F, D)
    (r"moe/w_(gate|up)$", ("experts", "fsdp", None), 4),
    (r"moe/w_down$", ("experts", None, "fsdp"), 4),
    # moe (blocked layout (TP, E_loc, D, F_loc))
    (r"moe/router$", (None, None), None),
    (r"moe/w_gate$", ("experts", None, "fsdp", None), None),
    (r"moe/w_up$", ("experts", None, "fsdp", None), None),
    (r"moe/w_down$", ("experts", None, None, "fsdp"), None),
    # rg-lru
    (r"rglru/w_x$", ("fsdp", "ffn"), None),
    (r"rglru/w_gate$", ("fsdp", "ffn"), None),
    (r"rglru/conv_[wb]$", None, None),  # tiny; replicate fully
    (r"rglru/w_[ai]$", (None, "fsdp", "ffn"), None),
    (r"rglru/(b_[ai]|lam)$", (None,), None),
    (r"rglru/w_out$", ("ffn", "fsdp"), None),
    # mamba2
    (r"blocks/in_proj$", ("fsdp", "ffn"), None),
    (r"blocks/conv_[wb]$", None, None),
    (r"blocks/(a_log|dt_bias|d_skip|out_norm)$", None, None),
    (r"blocks/out_proj$", ("ffn", "fsdp"), None),
    # norms
    (r"norm", None, None),
]


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def leaf_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical axes of the param leaf at ``path`` of rank ``ndim``."""
    for pat, axes, rank in _PARAM_RULES:
        if (rank is None or rank == ndim) and re.search(pat, path):
            if axes is None:
                return (None,) * ndim
            pad = ndim - len(axes)
            if pad < 0:
                raise ValueError(f"{path}: rank {ndim} < rule {axes}")
            return (None,) * pad + tuple(axes)
    if ndim <= 1:
        return (None,) * ndim
    raise ValueError(f"no partition rule for param leaf {path} (rank {ndim})")


def param_logical_axes(params: Any) -> Any:
    """Tree of logical-axis tuples matching params (trailing dims aligned)."""
    by_path = {k: leaf_axes(k, v.dim()) for k, v in tree.leaf_paths(params).items()}
    return tree.unflatten_like(params, by_path)


def _axis_size(mesh: Optional[Any], names) -> int:
    if mesh is None or names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_sizes(mesh)
    n = 1
    for a in names:
        if a is not None:
            n *= sizes[a]
    return n


def sanitize_spec(spec: PartitionSpec, shape, mesh: Optional[Any]) -> PartitionSpec:
    """Drop sharding on dims the mesh cannot divide evenly (24 heads over a
    16-way model axis, a batch of 1 over data): those dims are stored
    replicated."""
    out = []
    for d, names in enumerate(spec):
        if names is None:
            out.append(None)
            continue
        div = _axis_size(mesh, names)
        out.append(names if (d < len(shape) and shape[d] % div == 0) else None)
    return P(*out)


def _specs(axes_tree: Any, like: Any, rules: AxisRules, mesh: Optional[Any]) -> Any:
    specs = tree.tree_map(lambda a: rules.spec(*a), axes_tree, is_leaf=_is_axes)
    if mesh is None:
        return specs
    return tree.tree_map(lambda s, x: sanitize_spec(s, x.shape, mesh), specs, like,
                         is_leaf=is_spec)


def make_param_specs(params: Any, rules: AxisRules, mesh: Optional[Any] = None) -> Any:
    """Tree of specs for params (or same-shaped states)."""
    return _specs(param_logical_axes(params), params, rules, mesh)


def make_shardings(specs: Any, mesh: Any) -> Any:
    return tree.tree_map(lambda s: NamedSharding(mesh, s), specs, is_leaf=is_spec)


# -- batch / cache specs -------------------------------------------------------

def batch_logical_axes(batch_like: Any) -> Any:
    return tree.tree_map(lambda leaf: ("batch",) + (None,) * (leaf.dim() - 1), batch_like)


def make_batch_specs(batch_like: Any, rules: AxisRules, mesh: Optional[Any] = None) -> Any:
    return _specs(batch_logical_axes(batch_like), batch_like, rules, mesh)


def _cache_axes(path: str, nd: int) -> Tuple[Optional[str], ...]:
    """The logical axes of the whole cache's leaf at ``path`` (the JAX
    package's); a rank's state on a tp mesh is the share ``cache_share``
    gives."""
    if re.search(r"(^|/)(k|v)$", path):
        # (..., B, C, Hkv, Dh): batch at -4, cache seq at -3
        return (None,) * (nd - 4) + ("batch", "kv_seq", None, None)
    if path.endswith("ssm"):  # (L, B, H, P, N)
        return (None, "batch", "ssm_heads", None, None)
    if path.endswith("conv") and nd == 4:  # (L, B, K-1, conv_dim)
        return (None, "batch", None, "ffn")
    if path.endswith("h") and nd == 3:  # (units, B, W)
        return (None, "batch", "ffn")
    if path.endswith("conv") and nd == 3:  # tail rglru (B, K-1, W)
        return ("batch", None, "ffn")
    if path.endswith("h") and nd == 2:
        return ("batch", "ffn")
    return (None,) * nd


def make_cache_specs(cfg: ModelConfig, cache_like: Any, rules: AxisRules,
                     mesh: Optional[Any] = None) -> Any:
    """Decode-state specs: batch over the DP axes; long axes context-sharded.

    * attention k/v caches: sequence dim over `model` (flash-decoding layout)
    * mamba2 ssm state: head dim over `model`
    * rg-lru h/conv states: width dim over `model`

    These are the specs of the whole cache, as the JAX package lays it out,
    and ``cache_like`` is a whole cache (``lm.init_cache`` without a mesh).
    On a tp mesh the port's ``init_cache`` makes each rank's own state,
    which ``cache_share`` places in the whole: the split that the specs
    name (k and v by slots, ``kv_seq``, where the model size divides them;
    else the kv heads its q heads read; ``ssm`` by heads, ``h`` by width)
    but for two leaves: mamba2's ``conv`` holds
    the rank's heads' x columns and B and C whole (JAX splits conv_dim in
    contiguous blocks), and the RG-LRU's ``conv`` holds its whole gate
    block where blocks straddle ranks (m > 8).
    """
    by_path = {k: _cache_axes(k, v.dim()) for k, v in tree.leaf_paths(cache_like).items()}
    return _specs(tree.unflatten_like(cache_like, by_path), cache_like, rules, mesh)


def cache_share(cfg: ModelConfig, path: str, n_slots: Optional[int] = None
                ) -> Optional[Tuple[int, List[Tuple[int, int]]]]:
    """Where this rank's leaf ``path`` of the serve state lies in the whole
    cache under the active rules and mesh: (the dim, counted from the end,
    and the spans [lo, hi) of the whole dim it holds, in order), or None
    where it holds the whole dim. A KV cache of ``n_slots`` whole slots
    holds its slots of every kv head where they split over ``model``
    (``axes.kv_seq_span``), else the kv heads its q heads read
    (``layers.kv_heads_local``); mamba2's ``ssm`` its heads and its
    ``conv`` their x columns and B and C (``mamba2.conv_spans``); the
    RG-LRU's ``h`` its own columns and its ``conv`` the columns whose conv
    it computes (``rglru.width_share``)."""
    name = path.split("/")[-1]
    if name in ("k", "v"):
        if n_slots is None and splits_kv_seq():
            raise ValueError(f"cache_share({path!r}): the rules split kv_seq over 'model'; "
                             "the whole cache's n_slots tells a share from a whole cache")
        span = None if n_slots is None else kv_seq_span(n_slots)
        if span is not None:
            return -3, [span]
        local = layers.kv_heads_local(cfg)
        return None if local is None else (-2, [(local[0], local[0] + local[1])])
    if cfg.family == "ssm" and name in ("ssm", "conv"):
        m, r = mamba2.heads_split(cfg)
        if m == 1:
            return None
        if name == "conv":
            return -1, mamba2.conv_spans(cfg, m, r)
        hl = cfg.n_ssm_heads // m
        return -3, [(r * hl, (r + 1) * hl)]
    if name in ("h", "conv"):
        share = rglru.width_share(cfg)
        return None if share is None else (-1, [share.own if name == "h" else share.conv])
    return None


# -- trees on a mesh ------------------------------------------------------------

def expert_blocks(params: Any, mesh: Any) -> Any:
    """A param-shaped tree (params or an optimizer moment) with every MoE
    layer's whole experts blocked for the mesh's model size
    (``convert.experts_blocked``): the layout on a mesh."""
    return experts_blocked(params, mesh_sizes(mesh)["model"])


def _local(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's chunk of the whole tensor ``t`` under ``sharding``: a copy,
    so that the whole can be freed, or ``t`` itself where the chunk is all
    of it."""
    mesh = sharding.mesh
    chunk = t
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            chunk = chunk.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return t if chunk.numel() == t.numel() else chunk.clone(memory_format=torch.contiguous_format)


def place(whole: torch.Tensor, sharding: Optional[NamedSharding]) -> torch.Tensor:
    """A DTensor holding this rank's chunk of ``whole`` (the same on every
    rank) by ``sharding``; a plain tensor as it is where ``sharding`` is
    None. No collective: each rank keeps its own chunk. Where the chunk is
    all of ``whole`` (a replicated leaf, any leaf on a mesh of one rank) the
    DTensor holds ``whole`` itself, not a copy."""
    if sharding is None:
        return whole
    return DTensor.from_local(_local(whole, sharding), sharding.mesh, sharding.placements,
                              run_check=False, shape=whole.shape, stride=whole.stride())


def place_tree(whole: Any, shardings: Any) -> Any:
    return tree.tree_map(place, whole, shardings)


def whole(t: Any) -> Any:
    """The whole tensor of a DTensor (a collective over its mesh); anything
    else as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def batch_rules(rules: AxisRules, mesh: Optional[Any], n_rows: int) -> AxisRules:
    """The rules to run a batch of ``n_rows`` rows under on ``mesh``:
    ``rules`` as they are where the rows split over the mesh axes the rules
    give "batch"; else the same rules with the batch replicated, as the JAX
    package's ``sanitize_spec`` leaves such a batch's spec (a global batch of
    1 over 16 data ranks). Every rank then holds and runs the whole batch
    (``batch_rows``), ``axes.batch_axes()`` is empty, and the loss counts the
    batch once and its gradients are not summed over the ranks."""
    if mesh is None or n_rows % _axis_size(mesh, rules.resolve("batch")) == 0:
        return rules
    return AxisRules(rules={**rules.rules, "batch": None},
                     gather_weights_at_use=rules.gather_weights_at_use)


def batch_rows(batch: Dict[str, torch.Tensor], n: int, i: int) -> Dict[str, torch.Tensor]:
    """Block ``i`` of ``n`` of every leaf's rows: a rank's part of the global
    batch. A batch whose rows do not split into ``n`` blocks is replicated,
    as the JAX package replicates it: every rank gets the whole batch, which
    it must run under ``batch_rules`` (where the batch is not split, and
    ``n`` is 1)."""
    if any(v.shape[0] % n for v in batch.values()):
        return dict(batch)
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // n
        out[k] = v[i * b:(i + 1) * b]
    return out
