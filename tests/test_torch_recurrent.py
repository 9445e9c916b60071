"""The port's ssm and hybrid serve paths on the CPU against the JAX package.

* The plain scans of ``repro_torch.kernels.ref`` (what a CPU tensor takes in
  ``ops``) against the Pallas kernels in interpret mode, the JAX package's
  chunked path and its sequential oracles, including an initial state ``h0``
  and an S that is not a multiple of the chunk.
* mamba2-1.3b's and recurrentgemma-9b's smoke configs, with the JAX package's
  params copied over by ``params_from_jax``, through ``lm.prefill`` and
  ``lm.decode_step`` of both packages; the hybrid's prompt is longer than
  its window of 16, so its ring caches rotate.

Bounds. Scans in f32: 5e-4 against the sequential oracles (the JAX package's
own bound in tests/test_kernels.py), 1e-5 between the two chunked forms (the
same arithmetic in another order); the RG-LRU at 1e-4 f32 / 3e-2 bf16 as in
tests/test_kernels.py. Logits at 1e-4 (f32) and 3e-2 (bf16), the bounds of
tests/test_torch_serve.py and for the same reasons.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import lm as jlm
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as trglru
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import serve
from repro_torch.models import lm

F32_TOL, BF16_TOL = 1e-4, 3e-2
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = {"mamba2-1.3b": "mamba2_1p3b", "recurrentgemma-9b": "recurrentgemma_9b"}


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _ssd_np(seed, B, S, H, P, N, with_h0=False):
    rng = np.random.default_rng(seed)
    out = dict(x=rng.standard_normal((B, S, H, P), dtype=np.float32),
               dt=(np.abs(rng.standard_normal((B, S, H))) * 0.3 + 0.01).astype(np.float32),
               A=(-np.abs(rng.standard_normal(H)) - 0.1).astype(np.float32),
               Bm=rng.standard_normal((B, S, N), dtype=np.float32),
               Cm=rng.standard_normal((B, S, N), dtype=np.float32))
    out["h0"] = rng.standard_normal((B, H, P, N), dtype=np.float32) if with_h0 else None
    return out


def _as(arrs, fn):
    return {k: (None if v is None else fn(k, v)) for k, v in arrs.items()}


def _torch_ssd(a, dtype=torch.float32):
    return _as(a, lambda k, v: torch.from_numpy(v).to(dtype if k in ("x", "Bm", "Cm")
                                                      else torch.float32))


def _jax_ssd(a, dtype=jnp.float32):
    return _as(a, lambda k, v: jnp.asarray(v, dtype if k in ("x", "Bm", "Cm")
                                           else jnp.float32))


# =============================================================================
# SSD scan
# =============================================================================

@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 128, 4, 16, 32, 32),
                                             (1, 256, 2, 8, 16, 64)])
def test_ssd_plain_vs_pallas(B, S, H, P, N, chunk):
    a = _ssd_np(0, B, S, H, P, N)
    j, t = _jax_ssd(a), _torch_ssd(a)
    want_y, want_h = ssd_scan_pallas(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"],
                                     chunk=chunk, interpret=True)
    y, h = ops.ssd_scan(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, want_y, 5e-4)
    _close(h, want_h, 5e-4)


@pytest.mark.parametrize("S,chunk,with_h0", [(96, 32, False), (100, 32, True),
                                             (37, 8, True), (20, 64, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_vs_jax_chunked(S, chunk, with_h0, dtype):
    """Ragged S (padded with dt = 0 rows), h0 and the final state, against
    the JAX package's chunked path; bf16 rounds the dot inputs in both."""
    a = _ssd_np(1, 2, S, 3, 8, 16, with_h0)
    j = _jax_ssd(a, getattr(jnp, dtype))
    t = _torch_ssd(a, getattr(torch, dtype))
    want_y, want_h = jops.ssd_scan(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"], chunk=chunk,
                                   h0=j["h0"], impl="chunked")
    y, h = ops.ssd_scan(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], chunk=chunk, h0=t["h0"])
    assert y.dtype == getattr(torch, dtype) and y.shape == (2, S, 3, 8)
    assert h.dtype == torch.float32 and h.shape == (2, 3, 8, 16)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    _close(y, want_y, tol)
    _close(h, want_h, tol)


def test_ssd_sequential_matches_jax_oracle_and_chunked_with_h0():
    a = _ssd_np(2, 2, 50, 3, 8, 16)
    j, t = _jax_ssd(a), _torch_ssd(a)
    y, _ = ref.ssd_sequential(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"])
    _close(y, jref.ssd(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"]), 1e-5)
    # a carried state: the second half from the first half's final state
    # equals the whole sequence, in the oracle and in the chunked form
    _, h1 = ref.ssd_sequential(*(t[k][:, :20] for k in ("x", "dt")), t["A"],
                               *(t[k][:, :20] for k in ("Bm", "Cm")))
    y2, h2 = ref.ssd_sequential(*(t[k][:, 20:] for k in ("x", "dt")), t["A"],
                                *(t[k][:, 20:] for k in ("Bm", "Cm")), h0=h1)
    _close(y2, y[:, 20:].numpy(), 1e-5)
    yc, hc = ops.ssd_scan(*(t[k][:, 20:] for k in ("x", "dt")), t["A"],
                          *(t[k][:, 20:] for k in ("Bm", "Cm")), chunk=8, h0=h1)
    _close(yc, y2.numpy(), 5e-4)
    _close(hc, h2.numpy(), 5e-4)


def test_ssd_decode_step_matches_jax():
    a = _ssd_np(3, 2, 1, 3, 8, 16, with_h0=True)
    j, t = _jax_ssd(a), _torch_ssd(a)
    want_y, want_h = jops.ssd_decode_step(j["x"][:, 0], j["dt"][:, 0], j["A"],
                                          j["Bm"][:, 0], j["Cm"][:, 0], j["h0"])
    y, h = ops.ssd_decode_step(t["x"][:, 0], t["dt"][:, 0], t["A"], t["Bm"][:, 0],
                               t["Cm"][:, 0], t["h0"])
    _close(y, want_y, 1e-5)
    _close(h, want_h, 1e-5)


# =============================================================================
# RG-LRU scan
# =============================================================================

def _rglru_np(seed, B, S, W):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, W), dtype=np.float32),
            (-np.abs(rng.standard_normal((B, S, W))) * 0.5).astype(np.float32),
            rng.standard_normal((B, W), dtype=np.float32))


@pytest.mark.parametrize("B,S,W,blk_s,blk_w", [(2, 256, 512, 64, 128),
                                               (1, 128, 256, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_plain_vs_pallas(B, S, W, blk_s, blk_w, dtype):
    x, al, _ = _rglru_np(4, B, S, W)
    want_y, want_h = rglru_scan_pallas(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(al),
                                       blk_s=blk_s, blk_w=blk_w, interpret=True)
    y, h = ops.rglru_scan(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(al))
    assert y.dtype == h.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(y, want_y, tol)
    _close(h, want_h, tol)


@pytest.mark.parametrize("S,W,split", [(64, 32, 32), (37, 33, 5)])
def test_rglru_plain_h0_handoff_vs_jax_chunked(S, W, split):
    """Carried state: scan(x[:k]) then scan(x[k:], h0) against one scan, and
    each half against the JAX package's chunked path with the same h0."""
    x, al, h0 = _rglru_np(5, 2, S, W)
    tx, tal = torch.from_numpy(x), torch.from_numpy(al)
    full, _ = ops.rglru_scan(tx, tal)
    y1, h1 = ops.rglru_scan(tx[:, :split], tal[:, :split])
    y2, h2 = ops.rglru_scan(tx[:, split:], tal[:, split:], h0=h1)
    _close(y2, full[:, split:].numpy(), 1e-5)
    want, want_h = jops.rglru_scan(jnp.asarray(x), jnp.asarray(al), h0=jnp.asarray(h0),
                                   impl="chunked")
    got, got_h = ops.rglru_scan(tx, tal, h0=torch.from_numpy(h0))
    _close(got, want, 1e-5)
    _close(got_h, want_h, 1e-5)


def test_rglru_plain_matches_jax_oracle():
    x, al, _ = _rglru_np(6, 2, 40, 24)
    y, h = ops.rglru_scan(torch.from_numpy(x), torch.from_numpy(al))
    want = jref.rglru(jnp.asarray(x), jnp.asarray(al))
    _close(y, want, 1e-6)
    _close(h, np.asarray(want)[:, -1], 1e-6)


def test_rglru_decode_step_matches_jax():
    x, al, h0 = _rglru_np(7, 3, 1, 16)
    want = jops.rglru_decode_step(jnp.asarray(x[:, 0]), jnp.asarray(al[:, 0]),
                                  jnp.asarray(h0))
    got = ops.rglru_decode_step(torch.from_numpy(x[:, 0]), torch.from_numpy(al[:, 0]),
                                torch.from_numpy(h0))
    _close(got, want, 1e-6)


# =============================================================================
# Decode attention at group 16 (recurrentgemma-9b's MQA)
# =============================================================================

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_group16_vs_pallas(dtype):
    B, C, H, Hkv, Dh = 3, 256, 16, 1, 256
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, H, Dh), dtype=np.float32)
    kc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
    vc = rng.standard_normal((B, C, Hkv, Dh), dtype=np.float32)
    cl = np.asarray([256, 100, 1], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = decode_attention_pallas(jnp.asarray(q, jd), jnp.asarray(kc, jd),
                                   jnp.asarray(vc, jd), jnp.asarray(cl), blk_k=128,
                                   interpret=True)
    got = ops.decode_attention(torch.from_numpy(q).to(td), torch.from_numpy(kc).to(td),
                               torch.from_numpy(vc).to(td), torch.from_numpy(cl))
    _close(got, want, 2e-5 if dtype == "float32" else 2e-2)


# =============================================================================
# Dispatch
# =============================================================================

def test_cpu_tensors_take_the_plain_scans():
    a = _torch_ssd(_ssd_np(9, 1, 16, 2, 8, 16))
    x, al, _ = (torch.from_numpy(v) for v in _rglru_np(9, 1, 16, 8))
    launches, calls = (tssd.launches, trglru.launches), ref.calls
    ops.ssd_scan(a["x"], a["dt"], a["A"], a["Bm"], a["Cm"], chunk=8)
    ops.rglru_scan(x, al)
    assert ref.calls == calls + 2
    assert (tssd.launches, trglru.launches) == launches


def test_scan_wrappers_refuse_cpu_tensors():
    a = _torch_ssd(_ssd_np(10, 1, 16, 2, 8, 16))
    x, al, _ = (torch.from_numpy(v) for v in _rglru_np(10, 1, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_cuda(a["x"], a["dt"], a["A"], a["Bm"], a["Cm"], chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        trglru.rglru_scan_cuda(x, al)


def test_scan_ops_raise_on_meta_and_mixed_devices():
    x = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.rglru_scan(x, x)
    with pytest.raises(ValueError, match="mixed"):
        ops.rglru_scan(torch.zeros(1, 4, 8), x)
    xs = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        ops.ssd_scan(xs, torch.zeros(1, 4, 2), torch.zeros(2), torch.zeros(1, 4, 16),
                     torch.zeros(1, 4, 16), chunk=4)


# =============================================================================
# Configs and params
# =============================================================================

def _modules(arch):
    name = ARCHS[arch]
    return (importlib.import_module(f"repro.configs.{name}"),
            importlib.import_module(f"repro_torch.configs.{name}"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_and_param_counts_match_jax(arch):
    from repro_torch.models.registry import get_config, get_smoke_config
    jmod, tmod = _modules(arch)
    for jc, tc in ((jmod.CONFIG, get_config(arch)), (jmod.SMOKE_CONFIG, get_smoke_config(arch))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert (tc.d_inner, tc.n_ssm_heads) == (jc.d_inner, jc.n_ssm_heads)
    assert tmod.CONFIG is get_config(arch)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_layout_and_count_match_jax(arch):
    """The port's own init: the JAX package's keys, shapes and leaf dtypes
    (the decay leaves in f32 in a bf16 model), and param_count leaves."""
    jmod, tmod = _modules(arch)
    jp = jax.tree_util.tree_map(np.asarray, jlm.init_params(jmod.SMOKE_CONFIG,
                                                           jax.random.PRNGKey(0)))
    tp = lm.init_params(tmod.SMOKE_CONFIG, torch.Generator().manual_seed(0), "cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, path
    n = sum(t.numel() for _, t in tleaves)
    assert n == sum(j.size for _, j in jleaves)


@pytest.mark.parametrize("arch,keys", [("mamba2-1.3b", ("a_log", "dt_bias", "d_skip")),
                                       ("recurrentgemma-9b", ("lam",))])
def test_params_from_jax_keeps_f32_leaves(arch, keys):
    """With param_dtype bfloat16 the decay leaves stay f32 and bit-equal; the
    old cast of every leaf to bf16 changed them."""
    jmod, tmod = _modules(arch)
    jp = jax.tree_util.tree_map(np.asarray, jlm.init_params(jmod.SMOKE_CONFIG,
                                                           jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, tmod.SMOKE_CONFIG)
    assert tmod.SMOKE_CONFIG.param_dtype == "bfloat16"
    if arch == "mamba2-1.3b":
        pairs = [(jp["backbone"]["blocks"][k], tp["backbone"]["blocks"][k]) for k in keys]
        bf16 = tp["backbone"]["blocks"]["in_proj"]
    else:
        pairs = [(jp["backbone"]["units"][0]["rglru"][k], tp["backbone"]["units"][0]["rglru"][k])
                 for k in keys]
        pairs.append((jp["backbone"]["tail"][0]["rglru"]["lam"],
                      tp["backbone"]["tail"][0]["rglru"]["lam"]))
        bf16 = tp["backbone"]["units"][0]["rglru"]["w_x"]
    assert bf16.dtype == torch.bfloat16
    for j, t in pairs:
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), j)
    # a_log (log 1..16) and lam are not bf16-exact (d_skip, all ones, is)
    j, t = pairs[0]
    assert not np.array_equal(t.to(torch.bfloat16).float().numpy(), j)


def test_params_from_jax_refuses_a_foreign_dtype():
    jmod, tmod = _modules("mamba2-1.3b")
    jp = jax.tree_util.tree_map(np.asarray, jlm.init_params(jmod.SMOKE_CONFIG,
                                                           jax.random.PRNGKey(0)))
    jp["final_norm"]["scale"] = jp["final_norm"]["scale"].astype(np.float16)
    with pytest.raises(TypeError, match="float16"):
        params_from_jax(jp, tmod.SMOKE_CONFIG)


def test_unported_family_raises_naming_roadmap():
    """Every family of the JAX package is ported since the encoder and the
    VLM came in; a family it does not have raises, naming ROADMAP.md."""
    _, tmod = _modules("mamba2-1.3b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm.init_cache(tmod.SMOKE_CONFIG.replace(family="diffusion"), 1, 8, "cpu")


# =============================================================================
# Serve path against the JAX package
# =============================================================================

def _run_both(arch, *, B, S, steps, seed=0, **kw):
    jmod, tmod = _modules(arch)
    jcfg, tcfg = jmod.SMOKE_CONFIG.replace(**kw), tmod.SMOKE_CONFIG.replace(**kw)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    prompt = np.random.default_rng(seed).integers(0, jcfg.vocab_size, size=(B, S))
    max_len = S + steps
    jl, jcache = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt, jnp.int32)}, max_len)
    tl, tcache = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(prompt)}, max_len)
    out = {"jax": [np.asarray(jl, np.float32)], "torch": [tl.float().numpy()]}
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    toks = {"jax": [np.asarray(jtok)], "torch": [ttok.numpy()]}
    for i in range(steps):
        jl, jcache = jlm.decode_step(jcfg, jp, jcache, jtok, jnp.full((B,), S + i, jnp.int32))
        tl, tcache = lm.decode_step(tcfg, tp, tcache, ttok,
                                    torch.full((B,), S + i, dtype=torch.int32))
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        out["jax"].append(np.asarray(jl, np.float32))
        out["torch"].append(tl.float().numpy())
        toks["jax"].append(np.asarray(jtok))
        toks["torch"].append(ttok.numpy())
    return out, toks


# prompts: mamba2 spans 2.5 chunks of 8; the hybrid's 24 tokens exceed its
# window of 16, so prefill keeps the last 16 keys ring-rotated and decode
# overwrites the oldest slot
PROMPT = {"mamba2-1.3b": 20, "recurrentgemma-9b": 24}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(arch, dtype):
    out, _ = _run_both(arch, B=2, S=PROMPT[arch], steps=3,
                       **(F32 if dtype == "float32" else {}))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for jl, tl in zip(out["jax"], out["torch"]):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, atol=tol, rtol=0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_greedy_tokens_match_jax_f32(arch):
    _, toks = _run_both(arch, B=3, S=PROMPT[arch] - 4, steps=8, seed=1, **F32)
    np.testing.assert_array_equal(np.stack(toks["torch"], 1), np.stack(toks["jax"], 1))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_hidden_matches_jax(arch):
    """The full-sequence stack (no cache), as training will run it."""
    jmod, tmod = _modules(arch)
    jcfg, tcfg = jmod.SMOKE_CONFIG.replace(**F32), tmod.SMOKE_CONFIG.replace(**F32)
    family = {"mamba2-1.3b": "mamba2", "recurrentgemma-9b": "rglru"}[arch]
    jback = importlib.import_module(f"repro.models.{family}")
    tback = importlib.import_module(f"repro_torch.models.{family}")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want, _ = jback.forward_hidden(jcfg, jp["backbone"], jnp.asarray(x), jnp.asarray(pos),
                                   remat=False)
    got, aux = tback.forward_hidden(tcfg, tp["backbone"], torch.from_numpy(x),
                                    torch.from_numpy(pos))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_main_runs_on_cpu_when_asked(arch):
    result = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
                         "--batch", "2", "--prompt-len", "20", "--gen-len", "3"])
    assert result["finite"]
    assert result["total_tokens"] == 2 * 2 * 3
    assert tuple(result["tokens"].shape) == (4, 4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_main_refuses_to_run_without_gpu(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke", "--requests", "2", "--batch", "2",
                    "--prompt-len", "8", "--gen-len", "2"])
