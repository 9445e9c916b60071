"""Context-sharded decode (``kv_seq``) of the port on the CPU, held against
the JAX package and the port's unsharded run.

Under ``single_pod_rules`` and ``multi_pod_rules``, where the model axis m
divides a KV cache's C slots, each rank holds slots [r·C/m, (r+1)·C/m) of
every kv head for its batch rows (``axes.kv_seq_span``,
``layers.kv_cache_shape``), attends every q head over them with
``ops.decode_attention(..., return_lse=True)``, and the ranks' partial
outputs merge over ``model`` by their logsumexps in rank order
(``axes.merge_over_model``, whose arithmetic is ``axes.merge_partials``).

* The plain decode with the logsumexp (``ref.decode_attention``): its output
  within 1e-6 of ``decode_attention_pallas`` in interpret mode and of the
  JAX package's ``ref.decode_attention`` (the bound of
  tests/test_torch_decode_split.py) and bitwise the output without the
  logsumexp; the logsumexp within 1e-6 relative of a float64 numpy
  logsumexp of the masked scaled scores, -inf on rows of length 0; the
  kernel's op with the logsumexp (``repro_torch::decode_attention_lse``)
  gives the plain version's shapes and dtypes on fake CUDA tensors.
* The merge of m = 2, 4 and 8 slot shares, each attended with its own
  valid count clamp(len - r·C/m, 0, C/m) (rows of length 0, shares with no
  valid slot), within 1e-6 of the whole call.
* One gloo world of 8 ranks (``torch_serve_worlds.serve_job``) on a (2, 4)
  mesh under ``single_pod_rules``, f32 smoke configs, teacher-forced
  tokens: qwen3-1.7b (its heads split: the new token's q, k and v heads
  gathered, the partials by an all-to-all), phi4-mini-3.8b (6 heads do not
  split over 4: an all-gather of the partials), mixtral-8x7b past its
  32-slot window (the ring wraps, valid slots straddle ranks),
  recurrentgemma-9b past its local window of 16, qwen3-1.7b with a cache of
  32 slots whose ranks 1-3 hold no valid slot for the first steps, and
  qwen3-1.7b with 18 slots, which 4 does not divide (today's layout: every
  slot, the rank's kv head). Each against the JAX package's unsharded
  ``prefill`` and ``decode_step`` on the same params (``params_from_jax``)
  and against the port's unsharded run: the greedy tokens (each step's
  argmax) equal, the logits within 1e-4 of their largest, the final caches,
  gathered, within 1e-4 of the unsharded cache's largest (the bounds of
  tests/test_torch_sharded_serve.py), and each rank's cache of its shape.
* The dry run: decode_32k records on fake (16, 16) and (2, 16, 16) worlds
  carry the ``kv_seq`` cache layout, and a rank's KV cache is its rows at
  1/16 of the slots, of every kv head.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import lm as jlm
from repro.models.registry import get_smoke_config as jax_smoke_config
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref
from repro_torch.models import lm, transformer
from repro_torch.models.registry import get_smoke_config
from repro_torch.parallel.axes import merge_partials, single_pod_rules
from torch_mesh_worlds import World
from torch_serve_worlds import serve, serve_job

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6  # the plain decode against the Pallas kernel and the merge against the whole
OF_MAX = 1e-4  # serving on the mesh: of each tensor's largest magnitude
F32 = dict(param_dtype="float32", compute_dtype="float32")

DECODE_CASES = [
    # B, C, H, Hkv, Dh, cache_len
    (5, 256, 4, 2, 64, (0, 1, 63, 65, 256)),     # len 0; a key either side of a tile edge
    (4, 320, 12, 1, 64, (320, 0, 7, 200)),       # group 12
    (3, 128, 16, 1, 256, (128, 33, 0)),          # group 16, Dh 256
    (4, 64, 6, 3, 16, (64, 9, 40, 1)),           # group 2, short cache
]
MERGE_SHARES = (2, 4, 8)


@pytest.fixture(scope="module")
def decode_inputs():
    out = {}
    for case in DECODE_CASES:
        B, C, H, Hkv, Dh, lens = case
        rng = np.random.default_rng(41)
        q = rng.standard_normal((B, H, Dh), dtype=np.float32)
        kc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
        vc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
        out[case] = (q, kc, vc, np.asarray(lens, np.int32))
    return out


def _lse64(q, kc, lens, scale):
    """float64 logsumexp of the masked scaled scores, (B, H); -inf on empty rows."""
    B, H, Dh = q.shape
    C, Hkv = kc.shape[1], kc.shape[2]
    qg = q.astype(np.float64).reshape(B, Hkv, H // Hkv, Dh)
    s = np.einsum("bhgd,bshd->bhgs", qg, kc.astype(np.float64)) * scale
    valid = np.arange(C)[None] < lens[:, None]
    s = np.where(valid[:, None, None], s, -np.inf)
    top = s.max(-1, keepdims=True)
    safe = np.where(np.isfinite(top), top, 0.0)
    with np.errstate(divide="ignore"):
        lse = np.log(np.exp(s - safe).sum(-1)) + safe[..., 0]
    return lse.reshape(B, H)


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_plain_decode_with_logsumexp_matches_pallas_jax_and_float64(decode_inputs, case):
    q, kc, vc, lens = decode_inputs[case]
    scale = q.shape[-1] ** -0.5
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, kc, vc, lens))
    out, lse = ref.decode_attention(tq, tk, tv, tl, softmax_scale=scale, return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == q.shape[:2]
    assert torch.equal(out, ref.decode_attention(tq, tk, tv, tl, softmax_scale=scale))
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, kc, vc, lens))
    pallas = np.asarray(decode_attention_pallas(jq, jk, jv, jl, blk_k=128, interpret=True))
    plain = np.asarray(jref.decode_attention(jq, jk, jv, jl))
    np.testing.assert_allclose(out.numpy(), pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out.numpy(), plain, atol=TOL, rtol=TOL)
    want = _lse64(q, kc, lens, scale)
    empty = lens == 0
    assert np.isneginf(lse.numpy()[empty]).all() and np.isfinite(lse.numpy()[~empty]).all()
    np.testing.assert_allclose(lse.numpy()[~empty], want[~empty], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_logsumexp_op_gives_the_plain_versions_shapes_and_dtypes(dtype):
    """``repro_torch::decode_attention_lse`` on fake CUDA tensors (the dry
    run's mode): the output in q's dtype and the logsumexp (B, H) f32, as
    the plain version returns them."""
    from repro_torch.kernels import decode_attention
    from repro_torch.launch.dryrun import fake_mode
    B, C, H, Hkv, Dh = 2, 40, 4, 2, 32
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, H, Dh), generator=g).to(dtype)
    kc = torch.randn((B, C, Hkv, Dh), generator=g).to(dtype)
    cl = torch.full((B,), C, dtype=torch.int32)
    want = ref.decode_attention(q, kc, kc, cl, softmax_scale=0.1, return_lse=True)
    with fake_mode():
        got = decode_attention.decode_lse_op(
            *(torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in (q, kc, kc, cl)), 0.1)
    assert len(got) == len(want) == 2
    for f, p in zip(got, want):
        assert tuple(f.shape) == tuple(p.shape) and f.dtype == p.dtype
        assert f.device.type == "cuda"


@pytest.mark.parametrize("m", MERGE_SHARES)
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_merge_of_slot_shares_matches_the_whole_call(decode_inputs, case, m):
    q, kc, vc, lens = (torch.from_numpy(a) for a in decode_inputs[case])
    C = kc.shape[1]
    n = C // m
    outs, lses = [], []
    for r in range(m):
        local = torch.clamp(lens - r * n, 0, n).to(torch.int32)
        o, s = ref.decode_attention(q, kc[:, r * n:(r + 1) * n].contiguous(),
                                    vc[:, r * n:(r + 1) * n].contiguous(), local,
                                    return_lse=True)
        outs.append(o)
        lses.append(s)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    whole = ref.decode_attention(q, kc, vc, lens)
    torch.testing.assert_close(got, whole, atol=TOL, rtol=TOL)
    # a share with no valid slot of some row is part of every case
    assert any(bool((torch.clamp(lens - r * n, 0, n) == 0).any()) for r in range(m))
    empty = lens == 0
    assert torch.count_nonzero(got[empty]) == 0 and torch.isfinite(got).all()


# -- serving on a (2, 4) mesh -----------------------------------------------------------------

GEN = 4
# name -> (arch, prompt length, max_len): C is max_len, or the window where shorter
SERVE_CASES = {
    "qwen3 heads split": ("qwen3-1.7b", 12, 16),
    "phi4 heads whole": ("phi4-mini-3.8b", 12, 16),
    "mixtral ring wraps": ("mixtral-8x7b", 40, 44),           # 32 slots, 8 a rank
    "recurrentgemma local window": ("recurrentgemma-9b", 24, 28),  # 16 slots, 4 a rank
    "qwen3 ranks without valid slots": ("qwen3-1.7b", 5, 32),  # ranks 1-3 empty at first
    "qwen3 slots do not split": ("qwen3-1.7b", 12, 18),       # 4 does not divide 18
}


def _f32(arch, jax_side=False):
    cfg = (jax_smoke_config if jax_side else get_smoke_config)(arch).replace(**F32)
    return cfg.replace(capacity_factor=8.0) if cfg.n_experts else cfg


def _jax_run(arch, jp, prompt, tokens, max_len):
    """The JAX package's unsharded prefill and teacher-forced decode steps:
    each step's logits."""
    jcfg = _f32(arch, jax_side=True)
    logits, cache = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)}, max_len)
    out = [np.asarray(logits, np.float32)]
    B, S = prompt.shape
    for t in range(tokens.shape[1]):
        logits, cache = jlm.decode_step(jcfg, jp, cache, jnp.asarray(tokens[:, t]),
                                        jnp.full((B,), S + t, jnp.int32))
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cases, refs = {}, {}
    for i, (name, (arch, S, max_len)) in enumerate(SERVE_CASES.items()):
        cfg = _f32(arch)
        jp = jlm.init_params(_f32(arch, jax_side=True), jax.random.PRNGKey(i))
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
        rng = np.random.default_rng(100 + i)
        prompt = rng.integers(0, cfg.vocab_size, size=(4, S)).astype(np.int32)
        tokens = rng.integers(0, cfg.vocab_size, size=(4, GEN)).astype(np.int32)
        cases[name] = dict(cfg=cfg, params=params, prompt={"tokens": torch.from_numpy(prompt)},
                           tokens=torch.from_numpy(tokens), mesh=(2, 4),
                           rules=single_pod_rules(), max_len=max_len)
        refs[name] = (arch, prompt, tokens, jp)
    d = tmp_path_factory.mktemp("kv_seq_world")
    torch.save({"cases": cases}, d / "inputs.pt")
    world = World(serve_job, 8, d)  # runs while the references are computed
    want = {}
    for name, (arch, prompt, tokens, jp) in refs.items():
        c = cases[name]
        logits, _, cache = serve(c["cfg"], c["params"], c["prompt"], c["max_len"], c["tokens"])
        want[name] = {"logits": logits, "cache": tree.leaf_paths(cache),
                      "jax": _jax_run(arch, jp, prompt, tokens, c["max_len"])}
    return world.result(), want


def _close(got, want, what):
    bound = OF_MAX * max(float(want.abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= bound, (what, err, bound)


def _local_kv(name):
    """(slots, kv heads) of a rank's KV cache on (2, 4)."""
    arch, _, max_len = SERVE_CASES[name]
    cfg = get_smoke_config(arch)
    C = transformer.cache_size_for(cfg, max_len)
    if C % 4 == 0:
        return C // 4, cfg.n_kv_heads
    return C, max(1, cfg.n_kv_heads // 4)  # the kv head of the rank's q heads


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_context_sharded_serving_matches_jax_and_the_unsharded_run(served, name):
    results, refs = served
    got, want = results[name], refs[name]
    assert got["shards"] == 2 and not got["replicated"]
    slots, heads = _local_kv(name)
    kv = [s for k, s in got["local_shapes"].items() if k.split("/")[-1] in ("k", "v")]
    assert kv and all(s[-3:-1] == (slots, heads) for s in kv), (kv, slots, heads)
    assert len(got["logits"]) == len(want["logits"]) == len(want["jax"]) == GEN + 1
    for i, (g, w, j) in enumerate(zip(got["logits"], want["logits"], want["jax"])):
        j = torch.tensor(j)
        assert g.shape == w.shape == j.shape
        _close(g, w, f"logits of step {i} against the unsharded run")
        _close(g, j, f"logits of step {i} against JAX")
        greedy = torch.argmax(g, -1)
        assert torch.equal(greedy, torch.argmax(w, -1)), i
        assert torch.equal(greedy, torch.argmax(j, -1)), i
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, w in want["cache"].items():
        assert got["cache"][k].shape == w.shape, k
        _close(got["cache"][k], w, k)


def test_the_cases_hold_what_they_are_named_for():
    """The mixtral ring has wrapped and its valid slots straddle ranks; the
    32-slot qwen3 case leaves ranks 1-3 without a valid slot until its last
    step; 4 does not divide the 18-slot case."""
    arch, S, max_len = SERVE_CASES["mixtral ring wraps"]
    C = transformer.cache_size_for(get_smoke_config(arch), max_len)
    assert C == 32 and S > C  # the prompt's last 32 positions wrap the ring
    assert {(p % C) // (C // 4) for p in range(S, S + GEN)} == {1}  # decode writes on rank 1
    _, S, max_len = SERVE_CASES["qwen3 ranks without valid slots"]
    n = max_len // 4
    assert S <= n and S + GEN - 1 == n  # the last step writes rank 1's first slot
    assert SERVE_CASES["qwen3 slots do not split"][2] % 4


# -- the dry run at (16, 16) and (2, 16, 16) ----------------------------------------------------

_DRY = """
    import json
    from repro_torch import tree
    from repro_torch.launch import dryrun
    from repro_torch.launch.inputs import step_specs
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    from repro_torch.models.registry import SHAPES, get_smoke_config
    from repro_torch.parallel import axes
    out = []
    for arch, multi in (("qwen3-1.7b", False), ("phi4-mini-3.8b", True)):
        rec = dryrun.run_cell(arch, "decode_32k", multi, smoke=True)
        cfg = get_smoke_config(arch)
        dims = SHAPES["decode_32k"]
        n = 512 if multi else 256
        with dryrun.fake_world(n):
            mesh = make_production_mesh(multi_pod=multi, device_type="cuda")
            rules = rules_for(mesh, "tp")
            with axes.axis_rules(rules, mesh), dryrun.fake_mode() as mode:
                rows = dims["global_batch"] // axes.batch_shards()
                cache = step_specs(cfg, "decode", dims["seq_len"], rows, device="cuda",
                                   mode=mode)[0]
                shapes = {k: list(v.shape) for k, v in tree.leaf_paths(cache).items()}
        out.append({"arch": arch, "multi": multi, "status": rec["status"],
                    "cache_layout": rec["cache_layout"], "rows": rows, "shapes": shapes,
                    "args": rec["memory"]["argument_size_in_bytes"]})
    print(json.dumps(out))
"""


def test_dry_run_decode_records_take_the_kv_seq_layout():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_DRY)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    for rec in json.loads(out.stdout.strip().splitlines()[-1]):
        cfg = get_smoke_config(rec["arch"])
        assert rec["status"] == "ok" and rec["cache_layout"].startswith("kv_seq"), rec
        C = 32768
        whole = [rec["rows"], C, cfg.n_kv_heads, cfg.head_dim]
        kv = {k: s for k, s in rec["shapes"].items() if k in ("k", "v")}
        assert sorted(kv) == ["k", "v"]
        for s in kv.values():  # (units, unit, rows, C/16, every kv head, Dh)
            assert s[-4:] == [rec["rows"], C // 16, cfg.n_kv_heads, cfg.head_dim], s
            assert np.prod(s[-4:]) * 16 == np.prod(whole)
        assert rec["args"] > 0
