"""The port's dry run (``launch/dryrun.py``, ``launch/inputs.py``,
``parallel/analysis.py``, ``parallel/op_counter.py``, the registry's cell
metadata) against the JAX package on the CPU.

* the registry's ``SHAPES``, ``STEP_KIND``, ``all_cells()`` in order, and for
  all 40 cells ``cell_status``, ``is_subquadratic``, ``has_decode``,
  ``param_count``, ``active_param_count`` and ``model_flops_for_step``,
  equal to the JAX package's;
* ``input_specs``: every leaf's shape and dtype equal to the JAX package's
  ``ShapeDtypeStruct``s, the decode caches included;
* the ported cases of tests/test_analysis.py (a plain matmul; a Python loop
  of N matmuls counted N times, the counterpart of the scan test; the model
  FLOP formula), and the ring factors on a fake world of 16 ranks with
  groups of 4 and 16;
* each of the seven kernel ops' fake implementation against its plain
  version's outputs (shapes and dtypes), and the kernels' FLOP and byte
  functions at the shapes of PERF.md §6's table giving its bounds;
* ``run_cell`` at every arch's smoke config on fake (2, 4) worlds under
  both layouts and on fake (2, 2, 2) worlds, for every shape: ``ok`` (with
  ``FlopCounterMode``'s total equal to the counter's dot FLOP) or the JAX
  package's skip reason; the counter's counts on a real CPU step equal to
  those on the same step on fake tensors (the plain path); the counter's
  dense dot FLOP of a qwen3-1.7b smoke prefill against ``hlo_counter`` on
  the JAX package's compiled prefill;
* importing ``repro_torch.launch.dryrun`` starts no process group and sets
  no environment variable.

Every fake world runs in a subprocess of its own, so that no default
process group outlives it. ``repro.launch.dryrun`` is never imported here:
it sets ``XLA_FLAGS`` at import.
"""
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import inputs as jinputs
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.parallel import hlo_analysis as jhlo
from repro.parallel import hlo_counter
from repro.runtime import steps as jsteps
from repro_torch import tree
from repro_torch.kernels import (decode_attention, flash_attention, flash_attention_bwd,
                                 ref, rglru_scan, rglru_scan_bwd, ssd_scan, ssd_scan_bwd)
from repro_torch.kernels import costs
from repro_torch.launch import inputs
from repro_torch.models import registry
from repro_torch.parallel import analysis
from repro_torch.parallel.op_counter import OpCounter

ROOT = Path(__file__).resolve().parents[1]
CELLS = jreg.all_cells()
N_WORKERS = 4  # subprocesses sharing the smoke cells


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _run(script: str, *args: str, timeout: float = 300) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script), *args],
                         capture_output=True, text=True, env=_env(), timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


# -- the registry -----------------------------------------------------------------------

def test_shapes_step_kinds_and_cell_order_equal_jax():
    assert registry.SHAPES == jreg.SHAPES
    assert registry.STEP_KIND == jreg.STEP_KIND
    assert registry.all_cells() == jreg.all_cells()
    assert len(CELLS) == 40 and sorted(registry.ARCHS) == sorted(jreg.ARCHS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_metadata_and_model_flops_equal_jax(arch, shape):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    assert registry.cell_status(cfg, shape) == jreg.cell_status(jcfg, shape)
    assert cfg.is_subquadratic == jcfg.is_subquadratic
    assert cfg.has_decode == jcfg.has_decode
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    dims, kind = jreg.SHAPES[shape], jreg.STEP_KIND[shape]
    assert analysis.model_flops_for_step(cfg, kind, dims["seq_len"], dims["global_batch"]) \
        == jhlo.model_flops_for_step(jcfg, kind, dims["seq_len"], dims["global_batch"])


# -- the input specs --------------------------------------------------------------------

def _dtype_name(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_jax(arch, shape):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    got = tree.leaf_paths(inputs.input_specs(cfg, shape, device="cuda"))
    want = tree.leaf_paths(jinputs.input_specs(jcfg, shape))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype_name(got[k].dtype) == np.dtype(w.dtype).name, k
        assert got[k].device.type == "cuda"


# -- the counter, as tests/test_analysis.py --------------------------------------------------

def test_counter_plain_matmul():
    M, K, N = 32, 48, 64
    with OpCounter() as c:
        torch.randn(M, K) @ torch.randn(K, N)
    assert c.cost.dot_flops == 2.0 * M * K * N


def test_counter_counts_every_iteration_of_a_loop():
    """The counterpart of the scan test: eager PyTorch runs each iteration."""
    N, M = 12, 64
    x, w = torch.randn(M, M), torch.randn(M, M)
    with OpCounter() as c:
        for _ in range(N):
            x = x @ w
    assert c.cost.dot_flops == 2.0 * M * M * M * N


def test_model_flops_formula():
    cfg = registry.get_config("qwen3-1.7b")
    n = cfg.param_count()
    f_train = analysis.model_flops_for_step(cfg, "train", 4096, 256)
    assert abs(f_train - 6 * n * 4096 * 256) / f_train < 1e-9
    f_dec = analysis.model_flops_for_step(cfg, "decode", 32768, 128)
    assert abs(f_dec - 2 * n * 128) / f_dec < 1e-9
    moe = registry.get_config("mixtral-8x7b")
    assert moe.active_param_count() < 0.45 * moe.param_count()


_RING = """
    import json, sys, torch, torch.distributed as dist
    from repro_torch.launch.dryrun import fake_mode, fake_world
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.parallel.op_counter import OpCounter
    with fake_world(16):
        mesh = make_auto_mesh((4, 4), ("data", "model"), "cuda")
        out = {}
        for axis in ("model", "data", None):  # groups of 4 in a node, of 4 across, of 16
            g = mesh.get_group(axis) if axis else dist.group.WORLD
            n = dist.get_world_size(g)
            with fake_mode(), OpCounter() as c:
                x = torch.empty(1024, device="cuda")
                dist.all_reduce(x, group=g)
                dist.all_gather_into_tensor(x.new_empty(1024 * n), x, group=g)
                dist.reduce_scatter_tensor(x.new_empty(1024 // n), x, group=g)
                dist.all_to_all_single(torch.empty_like(x), x, group=g)
            out[str(axis)] = {"groups": {k: {str(s): v for s, v in by.items()}
                                         for k, by in c.cost.collective_groups.items()},
                              "nvlink": c.cost.nvlink_wire_bytes,
                              "wire": c.cost.collective_wire_bytes}
    print(json.dumps(out))
"""


def test_ring_factors_on_a_fake_world_of_16():
    got = json.loads(_run(_RING).strip().splitlines()[-1])
    nbytes = 4096  # 1024 f32, the operand of each
    for axis, g, inside in (("model", 4, True), ("data", 4, False), ("None", 16, False)):
        groups = got[axis]["groups"]
        want = {"all-reduce": 2 * (g - 1) / g, "all-gather": (g - 1) / g,
                "reduce-scatter": (g - 1) / g, "all-to-all": (g - 1) / g}
        for kind, factor in want.items():
            assert groups[kind] == {str(g): {"count": 1, "op_bytes": nbytes,
                                             "wire_bytes": factor * nbytes}}, (axis, kind)
        total = sum(got[axis]["wire"].values())
        assert got[axis]["nvlink"] == (total if inside else 0.0), axis
    assert analysis.ring_wire_bytes("collective-permute", 100, 4) == 100.0
    assert analysis.ring_wire_bytes("all-reduce", 100, 1) == 0.0


# -- the kernel ops ----------------------------------------------------------------------

def _fake(op, *args):
    from repro_torch.launch.dryrun import fake_mode
    with fake_mode():
        fakes = [torch.empty(a.shape, dtype=a.dtype, device="cuda")
                 if isinstance(a, torch.Tensor) else a for a in args]
        return op(*fakes)


def _like(fake_outs, plain_outs):
    assert len(fake_outs) == len(plain_outs)
    for f, p in zip(fake_outs, plain_outs):
        assert tuple(f.shape) == tuple(p.shape) and f.dtype == p.dtype
        assert f.device.type == "cuda"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_ops_give_the_plain_versions_shapes_and_dtypes(dtype):
    g = torch.Generator().manual_seed(0)
    B, S, H, Hkv, Dh = 2, 40, 4, 2, 32
    q, k, v = (torch.randn(s, generator=g).to(dtype) for s in
               ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    out = ref.mha(q, k, v, causal=True)
    lse = torch.zeros((B, H, S), dtype=torch.float32)  # the logsumexp the backward takes
    _like(_fake(flash_attention.forward_op, q, k, v, True, 0, 0, 0.1, False), [out])
    _like(_fake(flash_attention.forward_op, q, k, v, True, 0, 0, 0.1, True), [out, lse])
    _like(_fake(flash_attention_bwd.backward_op, q, k, v, out, lse, out, True, 0, 0, 0.1),
          ref.mha_bwd(q, k, v, out, lse, out, causal=True, window=0, q_offset=0,
                      softmax_scale=0.1))
    qd, cl = q[:, 0].contiguous(), torch.full((B,), S, dtype=torch.int32)
    _like([_fake(decode_attention.decode_op, qd, k, v, cl, 0.1)],
          [ref.decode_attention(qd, k, v, cl, softmax_scale=0.1)])
    P, N, chunk = 8, 16, 16
    x = torch.randn((B, S, H, P), generator=g).to(dtype)
    dt, A = torch.rand((B, S, H), generator=g), -torch.rand(H, generator=g)
    Bm, Cm = (torch.randn((B, S, N), generator=g).to(dtype) for _ in range(2))
    for h0 in (None, torch.zeros((B, H, P, N))):
        y, hf = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        ws = torch.zeros(ssd_scan.plan(B, S, H, P, N, chunk).workspace_floats)
        _like(_fake(ssd_scan.forward_op, x, dt, A, Bm, Cm, h0, chunk), [y, hf, ws])
        grads = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, y, None, chunk=chunk)
        _like(_fake(ssd_scan_bwd.backward_op, x, dt, A, Bm, Cm, h0, y, None, chunk, ws),
              [t for t in grads if t is not None])
    W = 24
    xr, a_log = torch.randn((B, S, W), generator=g).to(dtype), -torch.rand((B, S, W),
                                                                          generator=g)
    for h0 in (None, torch.zeros((B, W))):
        y, hl = ref.rglru_scan(xr, a_log, h0=h0)
        ws = torch.zeros(rglru_scan.plan(B, S, W).workspace_floats)
        _like(_fake(rglru_scan.forward_op, xr, a_log, h0), [y, hl, ws])
        grads = ref.rglru_scan_bwd(xr, a_log, h0, y, None)
        _like(_fake(rglru_scan_bwd.backward_op, xr, a_log, h0, y, None, ws),
              [t for t in grads if t is not None])


def _bound_ms(w: costs.Work) -> float:
    """chip_smoke.py's ``bound``: bytes over 3.35 TB/s or FLOP over 989
    TFLOP/s bf16 (67 f32 for the RG-LRU scans), the larger."""
    rate = 67e12 if w.f32 else analysis.PEAK_FLOPS_BF16
    return max(w.bytes / analysis.HBM_BW, w.flops / rate) * 1e3


def test_kernel_functions_give_the_tables_bounds():
    """PERF.md §6: flash with the logsumexp and its backward at qwen3-1.7b's
    train shape (B 4, S 2048, H 16 on 8, Dh 128), the SSD forward at
    mamba2-1.3b's prefill (B 4, S 2048, H 64, P 64, N 128, chunk 256)."""
    q, k = (4, 2048, 16, 128), (4, 2048, 8, 128)
    fwd = costs.flash_forward(q, k, 2, causal=True, window=0, with_lse=True)
    bwd = costs.flash_backward(q, k, 2, causal=True, window=0)
    ssd = costs.ssd_forward(4, 2048, 64, 64, 128, 256, 2)
    assert round(_bound_ms(fwd), 7) == 0.0695177
    assert round(_bound_ms(bwd), 7) == 0.1737943
    assert round(_bound_ms(ssd), 7) == 0.0444472
    assert costs.visible_pairs(2048, 2048, True, 0) == 2048 * 2049 // 2
    assert costs.visible_pairs(6, 6, True, 2) == 11
    assert costs.visible_pairs(3, 5, True, 0, q_offset=2) == 3 + 4 + 5
    assert costs.visible_pairs(4, 4, False, 0) == 16


# -- run_cell on fake worlds ---------------------------------------------------------------

_CELLS = """
    import json, sys
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import all_cells
    jobs = [(a, s, m, lay) for a, s in all_cells()
            for m, lay in (((2, 4), "tp"), ((2, 4), "fsdp"), ((2, 2, 2), None))]
    part, parts = int(sys.argv[1]), int(sys.argv[2])
    out = []
    for arch, shape, mesh, layout in jobs[part::parts]:
        rec = dryrun.run_cell(arch, shape, len(mesh) == 3, smoke=True, mesh_shape=mesh,
                              layout=layout)
        out.append({k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "reason",
                                            "layout", "flop_counter", "roofline",
                                            "kernel_calls", "memory", "n_devices",
                                            "collective_counts")})
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def smoke_records():
    with ThreadPoolExecutor(N_WORKERS) as pool:
        parts = pool.map(lambda i: _run(_CELLS, str(i), str(N_WORKERS), timeout=600),
                         range(N_WORKERS))
        return [r for p in parts for r in json.loads(p.strip().splitlines()[-1])]


def test_every_smoke_cell_runs_or_skips_as_jax(smoke_records):
    assert len(smoke_records) == 3 * len(CELLS)
    for r in smoke_records:
        ok, reason = jreg.cell_status(jreg.get_smoke_config(r["arch"]), r["shape"])
        assert ok == jreg.cell_status(jreg.get_config(r["arch"]), r["shape"])[0]
        if not ok:
            assert r["status"] == "skipped" and r["reason"] == reason, r
            continue
        assert r["status"] == "ok", r
        assert r["n_devices"] == 8 and r["mesh"] in ("2x4", "2x2x2")
        roof = r["roofline"]
        assert r["flop_counter"] == roof["flops_per_device"] > 0
        assert roof["hbm_bytes_per_device"] > 0 and roof["model_flops_total"] > 0
        assert r["memory"]["argument_size_in_bytes"] > 0
        calls = r["kernel_calls"]
        cfg = registry.get_smoke_config(r["arch"])
        if registry.STEP_KIND[r["shape"]] == "decode":
            assert set(calls) <= {"decode_attention"}
        elif cfg.family == "ssm":
            assert set(calls) >= {"ssd_scan"}
        else:
            assert set(calls) >= {"flash_attention"}
        if cfg.n_experts:  # the sharded MoE path's collectives
            assert r["collective_counts"].get("all-reduce", 0) > 0


def _counts(cfg, kind, params=None):
    from repro_torch.launch.dryrun import count_step
    return count_step(cfg, kind, 24, 2, device="cpu", params=params)["cost"].counts()


@pytest.mark.parametrize("arch,kind", [("qwen3-1.7b", "train"), ("qwen3-1.7b", "prefill"),
                                       ("qwen3-1.7b", "decode"), ("mamba2-1.3b", "train"),
                                       ("recurrentgemma-9b", "decode"),
                                       ("mixtral-8x7b", "train")])
def test_fake_counts_equal_real_counts_on_the_plain_path(arch, kind):
    from repro_torch.models import lm
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fake, real = _counts(cfg, kind), _counts(cfg, kind, params)
    assert fake == real, (kind, fake, real)
    assert fake["dot_flops"] > 0 and fake["kernel_calls"] == {}


def test_dense_dot_flops_of_a_prefill_equal_jax_hlo_counter():
    """qwen3-1.7b's smoke config, a prefill of B 2 x S 512. The port counts
    attention as the flash kernel's 4·Dh FLOP per visible (query, key) pair
    and head; the JAX package's CPU path runs the paired causal schedule
    (``ops._paired_causal_attention``): for each of the n(n+1)/2 pairs of
    query and key blocks of qc = min(256, S) rows (n = S / qc), both of
    whose products it computes whole, 4·qc²·Dh FLOP per row of the batch and
    head, diagonal blocks' masked half included. The rest (projections, MLP,
    the last position's logits) is the same products on both sides, so the
    dense FLOP must agree exactly: each product is one dot, counted once,
    on each side."""
    from repro_torch.launch.dryrun import count_step
    arch, B, S = "qwen3-1.7b", 2, 512
    cfg, jcfg = registry.get_smoke_config(arch), jreg.get_smoke_config(arch)
    cost = count_step(cfg, "prefill", S, B)["cost"]
    port_dense = cost.dot_flops - cost.kernel_flops
    assert cost.kernel_flops == cfg.n_layers * 4 * cfg.head_dim * cfg.n_heads * B * (
        S * (S + 1) // 2)

    params = jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    compiled = jax.jit(jsteps.make_prefill_step(jcfg, S)).lower(params, batch).compile()
    jax_total = hlo_counter.analyze(compiled.as_text()).dot_flops
    qc = min(256, S)
    n = S // qc
    jax_attention = jcfg.n_layers * B * jcfg.n_heads * 4 * qc * qc * jcfg.head_dim \
        * n * (n + 1) // 2
    assert port_dense == jax_total - jax_attention, (port_dense, jax_total, jax_attention)


_IMPORT = """
    import os, json
    before = dict(os.environ)
    import torch.distributed as dist
    import repro_torch.launch.dryrun
    print(json.dumps({"initialized": dist.is_initialized(),
                      "same": dict(os.environ) == before}))
"""


def test_importing_the_dry_run_starts_no_world_and_sets_no_variable():
    got = json.loads(_run(_IMPORT).strip().splitlines()[-1])
    assert got == {"initialized": False, "same": True}
