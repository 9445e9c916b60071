"""The port's sharding tables against the JAX package's, with no process
group: ``repro_torch.parallel.{axes,specs}`` and ``repro_torch.launch.mesh``.

For every arch's smoke param tree, batch and decode cache, the port's
logical axes and its specs under ``single_pod_rules``, ``multi_pod_rules``
and ``pure_fsdp_rules`` equal the JAX package's exactly, path for path, on
stand-in meshes that carry only axis sizes, (16, 16) and (2, 16, 16), as
tests/test_analysis.py:67-76 uses. The port's MoE experts are blocked for
the stand-in's model size (``specs.expert_blocks``), which gives the JAX
init's (tp_hint 16) shapes. Also the ports of test_analysis.py's
``test_partition_rules_cover_every_param`` and
``test_sanitize_spec_divisibility``, and the spec → DTensor placements map.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import synth_tokens as jax_synth_tokens
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.parallel import axes as jaxes
from repro.parallel import specs as jspecs
from repro_torch import tree
from repro_torch.data.pipeline import DataConfig, synth_tokens
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm, registry
from repro_torch.parallel import axes, specs

ARCHS = list(jregistry.ARCHS)
RULES = ["single_pod_rules", "multi_pod_rules", "pure_fsdp_rules"]


class StandIn:
    """A mesh that carries only axis sizes (tests/test_analysis.py:71)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(self.shape)


MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}
# multi-pod rules name the pod axis: only the 3-D mesh has it
CASES = [(r, m) for r in RULES for m in MESHES if r != "multi_pod_rules" or m == "2x16x16"]


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(lambda: jlm.init_params(jregistry.get_smoke_config(arch),
                                                  jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The port's smoke params with the experts blocked for a model axis of
    16, the JAX init's blocking."""
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return specs.expert_blocks(params, StandIn(MESHES["16x16"]))


def _jax_by_path(t, is_leaf):
    flat, _ = jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)
    return {jspecs._path_str(p): v for p, v in flat}


def _is_axes(x):
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def _assert_same(port_tree, jax_tree, port_leaf, jax_leaf):
    got = tree.leaf_paths(port_tree, is_leaf=port_leaf)
    want = _jax_by_path(jax_tree, jax_leaf)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_axes_equal_jax(arch):
    _assert_same(specs.param_logical_axes(_port_params(arch)),
                 jspecs.param_logical_axes(_jax_params(arch)), _is_axes,
                 lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("rules,mesh", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, rules, mesh):
    m = StandIn(MESHES[mesh])
    _assert_same(specs.make_param_specs(_port_params(arch), getattr(axes, rules)(), m),
                 jspecs.make_param_specs(_jax_params(arch), getattr(jaxes, rules)(), m),
                 axes.is_spec, lambda x: isinstance(x, JP))


def _batches(arch, global_batch):
    dcfg = dict(seq_len=288, global_batch=global_batch, seed=0)
    jb = jax_synth_tokens(jregistry.get_smoke_config(arch), JaxDataConfig(**dcfg), 0, 1, 0)
    tb = synth_tokens(registry.get_smoke_config(arch), DataConfig(**dcfg), 0, 1, 0)
    return {k: torch.from_numpy(v.copy()) for k, v in tb.items()}, jb


@pytest.mark.parametrize("global_batch", [512, 256, 2])
@pytest.mark.parametrize("rules,mesh", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_jax(arch, rules, mesh, global_batch):
    """Batches that split over every batch axis, over some, and over none."""
    m = StandIn(MESHES[mesh])
    tb, jb = _batches(arch, global_batch)
    _assert_same(specs.make_batch_specs(tb, getattr(axes, rules)(), m),
                 jspecs.make_batch_specs(jb, getattr(jaxes, rules)(), m),
                 axes.is_spec, lambda x: isinstance(x, JP))


@pytest.mark.parametrize("rules,mesh", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, rules, mesh):
    m = StandIn(MESHES[mesh])
    jcfg, tcfg = jregistry.get_smoke_config(arch), registry.get_smoke_config(arch)
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 32, 64))
    tcache = lm.init_cache(tcfg, 32, 64, "cpu")
    _assert_same(specs.make_cache_specs(tcfg, tcache, getattr(axes, rules)(), m),
                 jspecs.make_cache_specs(jcfg, jcache, getattr(jaxes, rules)(), m),
                 axes.is_spec, lambda x: isinstance(x, JP))


@pytest.mark.parametrize("rules", RULES + ["no_rules"])
def test_rule_sets_equal_jax(rules):
    mine, theirs = getattr(axes, rules)(), getattr(jaxes, rules)()
    assert mine.rules == theirs.rules
    assert mine.gather_weights_at_use == theirs.gather_weights_at_use
    for name in list(theirs.rules) + [None, "not-a-rule"]:
        assert mine.resolve(name) == theirs.resolve(name)
    assert tuple(mine.spec("batch", None, "heads")) == tuple(theirs.spec("batch", None, "heads"))


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_rules_cover_every_param(arch):
    """Every leaf of every arch's param tree matches a rule, in the whole
    expert layout and in the blocked one (test_analysis.py:46)."""
    cfg = registry.get_smoke_config(arch)
    whole = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for params in (whole, _port_params(arch)):
        got = tree.leaf_paths(specs.param_logical_axes(params), is_leaf=_is_axes)
        want = tree.leaf_paths(params)
        assert sorted(got) == sorted(want)
        assert all(len(got[k]) == want[k].dim() for k in want)
    if cfg.n_experts:  # the whole layout's rows: experts, then FSDP on D
        axes_of = tree.leaf_paths(specs.param_logical_axes(whole), is_leaf=_is_axes)
        key = next(k for k in axes_of if k.endswith("moe/w_gate"))
        assert axes_of[key] == (None, "experts", "fsdp", None)
        assert axes_of[key.replace("w_gate", "w_down")] == (None, "experts", None, "fsdp")


def test_sanitize_spec_divisibility():
    """test_analysis.py:57's cases."""
    P = axes.P
    one = StandIn((("data", 1), ("model", 1)))
    assert specs.sanitize_spec(P("data", None), (8, 4), one) == P("data", None)
    fm = StandIn((("data", 16), ("model", 16)))
    assert specs.sanitize_spec(P("model", "data"), (24, 32), fm) == P(None, "data")
    assert specs.sanitize_spec(P(("data", "model"), None), (256, 8), fm) == \
        P(("data", "model"), None)
    assert specs.sanitize_spec(P(("data", "model"), None), (128, 8), fm) == P(None, None)
    assert specs.sanitize_spec(P("data"), (1,), fm) == P(None)


def test_partition_spec_canonical_as_jax():
    P = axes.P
    for parts in [((), ("a",), ("a", "b"), None, (None,)), ("a", None)]:
        assert tuple(P(*parts)) == tuple(JP(*parts))


@pytest.mark.parametrize("spec,want", [
    ((None, None), [Replicate(), Replicate()]),
    (("data", "model"), [Shard(0), Shard(1)]),
    (("model", None, "data"), [Shard(2), Shard(0)]),
    ((None, ("data", "model")), [Shard(1), Shard(1)]),
])
def test_placements_of_a_spec(spec, want):
    """Each mesh axis a dim is split over becomes Shard(dim) on it, several
    on one dim in mesh order; the others Replicate."""
    assert axes.placements(axes.P(*spec), StandIn(MESHES["16x16"])) == want


@pytest.mark.parametrize("spec", [(("model", "data"),), ("data", "data")])
def test_placements_refuse_what_dtensor_cannot_nest(spec):
    with pytest.raises(ValueError):
        axes.placements(axes.P(*spec), StandIn(MESHES["16x16"]))


def test_without_rules_or_mesh_every_hook_returns_its_input():
    w = torch.ones(3)
    assert axes.gather_weight(w) is w and axes.shard(w, "batch") is w
    assert axes.logical_spec("batch", "heads") == axes.P()
    assert axes.batch_axes() == () and axes.batch_shards() == 1
    assert axes.named_sharding("batch") is None
    with axes.axis_rules(axes.single_pod_rules()):
        assert axes.gather_weight(w) is w and axes.shard(w, "batch") is w
        assert axes.logical_spec("batch", "heads") == axes.P("data", "model")
    assert axes.current_rules() is None and axes.current_mesh() is None


def test_mesh_builders_name_the_ranks_they_need():
    """No process group: each builder raises naming its world size."""
    for build, need in ((lambda: tmesh.make_production_mesh(device_type="cpu"), 256),
                        (lambda: tmesh.make_production_mesh(multi_pod=True,
                                                            device_type="cpu"), 512),
                        (lambda: tmesh.make_smoke_mesh(4, device_type="cpu"), 4)):
        with pytest.raises(ValueError, match=f"needs {need} ranks"):
            build()


@pytest.mark.parametrize("layout,names,want", [
    ("tp", ("data", "model"), "single_pod_rules"),
    ("fsdp", ("data", "model"), "pure_fsdp_rules"),
    ("fsdp", ("pod", "data", "model"), "multi_pod_rules"),
])
def test_rules_for_as_jax(layout, names, want):
    m = StandIn(tuple((n, 2) for n in names))
    assert tmesh.rules_for(m, layout) == getattr(axes, want)()


def test_batch_rows_split_a_global_batch():
    b = {"tokens": torch.arange(24).reshape(8, 3), "labels": torch.arange(8)}
    parts = [specs.batch_rows(b, 4, i) for i in range(4)]
    assert torch.equal(torch.cat([p["tokens"] for p in parts]), b["tokens"])
    # rows that do not split over 3 ranks are replicated, as the JAX package
    # replicates them: every rank gets the whole batch
    for i in range(3):
        whole = specs.batch_rows(b, 3, i)
        assert sorted(whole) == sorted(b)
        assert all(torch.equal(whole[k], b[k]) for k in b)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b"])
def test_expert_blocks_match_jax_shapes(arch):
    """Blocked for a model axis of 16, the port's expert leaves have the JAX
    init's shapes; unblocked, its own whole ones (convert.experts_whole)."""
    from repro_torch.convert import experts_whole
    jp = _jax_by_path(_jax_params(arch), None)
    blocked = tree.leaf_paths(_port_params(arch))
    for k, v in blocked.items():
        assert tuple(v.shape) == tuple(jp[k].shape), k
    cfg = registry.get_smoke_config(arch)
    whole = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    back = tree.leaf_paths(experts_whole(_port_params(arch)))
    for k, v in tree.leaf_paths(whole).items():
        assert torch.equal(back[k], v), k
    assert np.prod(blocked[next(k for k in blocked if k.endswith("moe/w_gate"))].shape) == \
        np.prod(tree.leaf_paths(whole)[next(k for k in blocked if k.endswith("moe/w_gate"))].shape)


def test_the_rules_are_seen_from_other_threads():
    """The autograd engine runs a CUDA backward and its checkpoint
    recomputes on threads of its own: they must read the rules the step
    installed."""
    import threading
    seen = []
    rules, mesh = axes.single_pod_rules(), StandIn(MESHES["16x16"])
    with axes.axis_rules(rules, mesh):
        t = threading.Thread(target=lambda: seen.append((axes.current_rules(),
                                                         axes.current_mesh())))
        t.start()
        t.join(10)
    assert not t.is_alive() and seen == [(rules, mesh)]


def test_hooks_on_a_one_rank_mesh(tmp_path):
    """In a world of this process alone: ``shard`` lays a DTensor out by the
    rules and passes a plain activation; ``gather_weight`` hands a DTensor
    param over whole and plain; ``place`` keeps the whole tensor on a mesh
    of one rank; a DTensor read without a gather raises."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'world'}", rank=0,
                            world_size=1)
    try:
        mesh = tmesh.make_smoke_mesh(1, device_type="cpu")
        rules = axes.single_pod_rules()
        w = torch.arange(12.0).reshape(4, 3)
        placed = specs.place(w, axes.NamedSharding(mesh, axes.P("data", "model")))
        assert isinstance(placed, DTensor) and placed.to_local().data_ptr() == w.data_ptr()
        with axes.axis_rules(rules, mesh):
            x = torch.ones(2, 4)
            assert axes.shard(x, "batch", None) is x
            laid = axes.shard(placed, None, "heads")
            assert list(laid.placements) == [Replicate(), Shard(1)]
            got = axes.gather_weight(placed)
            assert not isinstance(got, DTensor) and torch.equal(got, w)
            assert axes.batch_axes() == ("data",) and axes.batch_shards() == 1
            with pytest.raises(RuntimeError, match="mixed torch.Tensor and DTensor"):
                x @ placed
    finally:
        dist.destroy_process_group()
