"""The port's expert-parallel MoE path (``models/moe.py``, ``_moe_sharded``)
on 8 gloo ranks on the CPU, held against the JAX package.

One world of 8 ranks (``torch_mesh_worlds.moe_job``) runs every case; the
small tests below each assert one of its results. The cases:

* capacity factor 8.0 (nothing dropped), mixtral-8x7b's and
  llama4-maverick's smoke configs at d_model 32, d_ff 64, f32, on a (2, 4)
  mesh (ep 4, fp 1) and on a (1, 8) mesh (mixtral: ep 4, fp 2; llama4: ep 8),
  in both modes: the output against the JAX package's unsharded
  ``apply_moe`` (tests/test_moe_distributed.py:58's case, within its 1e-4);
* capacity factor 0.5 on (2, 4), both modes: assignments drop per pool,
  and the output, the aux loss and the kept assignments per pool equal the
  JAX package's own sharded ``apply_moe``, run in one subprocess with 8
  host devices as its test runs it (within 1e-5);
* gradients of x, the router, the experts and the shared expert against
  the unsharded gradient of the same function, within 1e-4 of each leaf's
  largest magnitude.

The aux loss of a sharded layer is, as in the JAX package, the mean over
the mesh of each routing pool's aux loss. Where the pool is the whole batch
(the weight-stationary mode gathers the tokens over ``data``; a data axis
of 1) that is the unsharded aux loss; in the gather mode on (2, 4) each of
the two data blocks is a pool, and the reference is the mean of the JAX
package's ``_route`` aux loss over the two blocks. The outputs do not
depend on it (nothing drops at 8.0), the gradients do, through the router:
the reference gradient is ``jax.grad`` of sum(y·dy) plus that aux loss.
"""
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.registry import get_smoke_config as jax_smoke_config
from repro_torch import tree
from repro_torch.convert import unblock_experts
from repro_torch.models import moe
from repro_torch.models.registry import get_smoke_config
from torch_mesh_worlds import MOE_TEST_RULES, moe_job, run_world

ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
OUT_TOL, SHARDED_TOL, GRAD_OF_MAX, AUX_REL = 1e-4, 1e-5, 1e-4, 1e-6
SHAPE = dict(param_dtype="float32", compute_dtype="float32", d_model=32, d_ff=64)
X_SHAPE = (4, 8, 32)
TP = 4  # the blocking of the JAX init: the (2, 4) mesh's model axis
CASES = [(a, m, g) for a in ARCHS for m in ((2, 4), (1, 8)) for g in (True, False)]
DROP_CASES = [(a, (2, 4), g) for a in ARCHS for g in (True, False)]

_JAX_SHARDED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch.mesh import make_auto_mesh
    from repro.models.moe import (apply_moe, init_moe_layer, _capacity, _route,
                                  _dispatch_indices)
    from repro.models.registry import get_smoke_config
    from repro.parallel.axes import AxisRules, axis_rules

    mesh = make_auto_mesh((2, 4), ("data", "model"))
    rules = AxisRules(rules={"batch": ("data",), "fsdp": ("data",),
                             "experts": "model", "ffn": "model"})
    out = {}
    for arch in ("mixtral-8x7b", "llama4-maverick-400b-a17b"):
        cfg = get_smoke_config(arch).replace(
            param_dtype="float32", compute_dtype="float32",
            capacity_factor=0.5, d_model=32, d_ff=64)
        p = init_moe_layer(cfg, jax.random.PRNGKey(0), tp_hint=4)
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32), jnp.float32)
        for gather in (True, False):
            os.environ["REPRO_MOE_FORCE_GATHER"] = "1" if gather else "0"
            with axis_rules(rules, mesh):
                xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
                y, aux = jax.jit(lambda p_, x_: apply_moe(cfg, p_, x_))(p, xs)
            # the kept assignments of each routing pool, by the body's own
            # routing and dispatch functions: a data block's rows (gather
            # mode) or the whole batch at twice the capacity (stationary)
            cap = _capacity(cfg, 2 * 8)
            pools = [x[:2], x[2:]] if gather else [x]
            kept = []
            for pool in pools:
                idx, _, _ = _route(cfg, p["router"], pool.reshape(-1, 32))
                pos, _ = _dispatch_indices(cfg, idx, 0, cfg.n_experts, cfg.n_experts,
                                           cap * (pool.shape[0] // 2))
                kept.append(int((pos >= 0).sum()))
            key = f"{arch}/{gather}"
            out[key + "/y"] = np.asarray(y)
            out[key + "/aux"] = np.asarray(aux)
            out[key + "/kept"] = np.asarray(kept)
    np.savez(sys.argv[1], **out)
    print("JAX SHARDED OK")
""")


def _jax_layer(cfg):
    p = jmoe.init_moe_layer(cfg, jax.random.PRNGKey(0), tp_hint=TP)
    x = jax.random.normal(jax.random.PRNGKey(1), X_SHAPE, jnp.float32)
    return p, x


def _whole(tree_np, cfg):
    """A numpy MoE layer (JAX layout, blocked for TP) as the port's whole
    torch tree."""
    stacked = {k: (v if isinstance(v, dict) else np.asarray(v)[None])
               for k, v in tree_np.items()}
    whole = unblock_experts(stacked, cfg)
    return {k: (tree.tree_map(lambda a: torch.from_numpy(np.array(a)), v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v[0]))) for k, v in whole.items()}


def _reference(cfg, p, x, dy, n_pools):
    """(y, aux, dx, dparams) of the unsharded layer with the aux loss of
    ``n_pools`` routing pools (the data blocks of x), by JAX."""
    def objective(p_, x_):
        y, _ = jmoe.apply_moe(cfg, p_, x_)
        blocks = jnp.split(x_, n_pools)
        aux = sum(jmoe._route(cfg, p_["router"], b.reshape(-1, b.shape[-1]))[2]
                  for b in blocks) / n_pools
        return jnp.sum(y * dy) + aux, (y, aux)
    (_, (y, aux)), (dp, dx) = jax.jit(jax.value_and_grad(objective, argnums=(0, 1),
                                                         has_aux=True))(p, x)
    return np.asarray(y), float(aux), np.asarray(dx), jax.tree_util.tree_map(np.asarray, dp)


def _n_pools(mesh, gather):
    return mesh[0] if gather else 1


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("moe_world")
    jax_out = workdir / "jax_sharded.npz"
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SHARDED, str(jax_out)], env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        cases, refs, by_pools = {}, {}, {}
        dy = np.array(jax.random.normal(jax.random.PRNGKey(2), X_SHAPE, jnp.float32))
        for arch in ARCHS:
            for cap in (8.0, 0.5):
                jcfg = jax_smoke_config(arch).replace(capacity_factor=cap, **SHAPE)
                tcfg = get_smoke_config(arch).replace(capacity_factor=cap, **SHAPE)
                jp, jx = _jax_layer(jcfg)
                params = _whole(jax.tree_util.tree_map(np.asarray, jp), tcfg)
                for mesh in ((2, 4), (1, 8)) if cap == 8.0 else ((2, 4),):
                    for gather in (True, False):
                        key = f"{arch}/{mesh}/{gather}/{cap}"
                        cases[key] = dict(cfg=tcfg, mesh=mesh, rules=MOE_TEST_RULES,
                                          params=params, x=torch.from_numpy(np.array(jx)),
                                          dy=torch.from_numpy(dy), gather=gather)
                        if cap == 8.0:
                            pools = _n_pools(mesh, gather)
                            if (arch, pools) not in by_pools:
                                y, aux, dx, dp = _reference(jcfg, jp, jx, dy, pools)
                                by_pools[arch, pools] = dict(y=y, aux=aux, dx=dx,
                                                             grads=_whole(dp, tcfg))
                            refs[key] = by_pools[arch, pools]
        torch.save({"cases": cases}, workdir / "inputs.pt")
        results = run_world(moe_job, 8, workdir)
    finally:
        stdout, stderr = jax_proc.communicate(timeout=600)
    assert "JAX SHARDED OK" in stdout, stdout + "\n" + stderr
    return results, refs, dict(np.load(jax_out))


def _key(arch, mesh, gather, cap):
    return f"{arch}/{mesh}/{gather}/{cap}"


@pytest.mark.parametrize("arch,mesh,gather", CASES)
def test_output_matches_jax_unsharded(world, arch, mesh, gather):
    results, refs, _ = world
    key = _key(arch, mesh, gather, 8.0)
    err = float(np.abs(results[key]["y"].numpy() - refs[key]["y"]).max())
    assert err < OUT_TOL, err


@pytest.mark.parametrize("arch,mesh,gather", CASES)
def test_aux_is_the_mean_of_the_pools_aux_as_jax(world, arch, mesh, gather):
    results, refs, _ = world
    key = _key(arch, mesh, gather, 8.0)
    got, want = float(results[key]["aux"]), refs[key]["aux"]
    assert want > 0 and abs(got - want) <= AUX_REL * want, (got, want)


@pytest.mark.parametrize("arch,mesh,gather", CASES)
def test_gradients_match_the_unsharded_gradient(world, arch, mesh, gather):
    """x, the router, every expert leaf and the shared expert: no factor of
    the model or data size, nothing missing from another rank's experts."""
    results, refs, _ = world
    key = _key(arch, mesh, gather, 8.0)
    got = {"x": results[key]["dx"], **tree.leaf_paths(results[key]["grads"])}
    want = {"x": torch.from_numpy(refs[key]["dx"]), **tree.leaf_paths(refs[key]["grads"])}
    assert sorted(got) == sorted(want)
    for k in want:
        bound = GRAD_OF_MAX * float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert bound > 0 and err <= bound, (k, err, bound)


@pytest.mark.parametrize("arch,mesh,gather", DROP_CASES)
def test_drops_match_jax_sharded(world, arch, mesh, gather):
    """At capacity factor 0.5 each pool drops assignments: the output, aux
    loss and each pool's kept assignments equal the JAX package's sharded
    layer's."""
    results, _, jax_sharded = world
    r = results[_key(arch, mesh, gather, 0.5)]
    jkey = f"{arch}/{gather}"
    err = float(np.abs(r["y"].numpy() - jax_sharded[jkey + "/y"]).max())
    assert err < SHARDED_TOL, err
    assert abs(float(r["aux"]) - float(jax_sharded[jkey + "/aux"])) <= \
        AUX_REL * float(jax_sharded[jkey + "/aux"])
    kept = jax_sharded[jkey + "/kept"]
    k = get_smoke_config(arch).experts_per_token
    total = X_SHAPE[0] * X_SHAPE[1] * k // len(kept)
    if arch == "mixtral-8x7b":  # llama4's 8 experts keep their floor of 4 slots
        assert all(n < total for n in kept)  # something dropped in every pool
    # each rank reports its pool's kept count: data block d's ranks come first
    per_rank = r["kept"].tolist()
    pools = [per_rank[:4], per_rank[4:]] if gather else [per_rank]
    for pool, want in zip(pools, kept):
        assert set(pool) == {int(want)}, (per_rank, kept)


def test_no_environment_switch_picks_the_mode():
    """The JAX package reads REPRO_MOE_FORCE_GATHER; the port takes an
    argument."""
    src = inspect.getsource(moe)
    assert "environ" not in src and "getenv" not in src
    assert "force_gather" in inspect.signature(moe.apply_moe).parameters


def test_results_cover_every_case(world):
    results, _, _ = world
    assert sorted(results) == sorted([_key(*c, 8.0) for c in CASES]
                                     + [_key(*c, 0.5) for c in DROP_CASES])
