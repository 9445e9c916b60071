"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:

1. device: name, capability, torch and CUDA versions, nvidia-smi's name and
   power limit;
2. build: the four CUDA sources under src/repro_torch/kernels/csrc, one nvcc
   per source, started together;
3. checks: each kernel against its plain PyTorch version on the card, on the
   same inputs, in f32 (TF32 off) and bf16: flash and decode attention at
   2e-5 / 2e-2, the RG-LRU scan at 1e-4 / 3e-2, the SSD scan against the
   sequential oracle at 5e-4 (bf16: 2e-2 on y, the oracle rounding only its
   output) and against the port's chunked plain version within a relative
   RMS of 1e-2 in bf16 (5e-4 in f32); the cases include each serve shape,
   ragged S and W, a non-zero h0, group 16 at head_dim 256 and a window
   that cuts keys;
4. per arch — qwen3-1.7b, mamba2-1.3b, recurrentgemma-9b, each at full width
   with random weights from seed 0 — serve: 8 requests in batches of 4, 32
   generated tokens, greedy, through repro_torch.launch.serve, with every
   launch counter set to 0 just before and read just after: the counts must
   be exactly those of EXPECTED and the plain-version counter 0;
   serve_vs_plain: prefill and teacher-forced decode logits with the kernels
   against the same model on the plain versions, on the card, in bf16 and
   f32 (recurrentgemma-9b's f32 copy keeps one pattern unit and the tail);
   trace: device busy and idle share of one prefill and of decode steps;
5. times: each kernel at its serve shapes (CUDA events), its plain version,
   a PyTorch call computing the same function where there is one (checked
   against the kernel), and the bound.

The last three lines are the card's name and power limit, the kernel table
and {"ok": true, "device": ...}. Any failed check exits non-zero before them.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
F32_TOL, BF16_TOL = 2e-5, 2e-2
RGLRU_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SSD_ORACLE_TOL = 5e-4
# SSD kernel vs the port's chunked plain version in bf16: the plain version
# rounds its dot inputs to bf16 as the JAX package does, the kernel does all
# products in f32. These checks measure a relative RMS of up to 3.3e-3 on y
# and 1.9e-3 on the final state on an H100 (S 37-2048, N 16-128); 1e-2 bounds
# that rounding, a wrong decay or mask moves y by order 100%.
SSD_PLAIN_BF16_REL_RMS = 1e-2
SOURCES = ["flash_attention", "decode_attention", "ssd_scan", "rglru_scan"]
SERVE = dict(requests=8, batch=4, gen_len=32, seed=0)
PROMPT = {"qwen3-1.7b": 512, "mamba2-1.3b": 2048, "recurrentgemma-9b": 3072}
EXPECTED = {  # exact launches of one serve run; every other counter must read 0
    "qwen3-1.7b": {"flash_attention": 56, "decode_attention": 1792},
    "mamba2-1.3b": {"ssd_scan": 96},
    "recurrentgemma-9b": {"rglru_scan": 52, "flash_attention": 24, "decode_attention": 768},
}
# plain vs kernel serving in bf16: relative RMS of the logit difference. Both
# sides compute in f32 and round to bf16, but at other points, so bf16
# rounding flips feed every layer of random weights; the bound is about twice
# that noise as measured on the card (0.029 qwen3 over 28 layers; 0.040
# mamba2 over 48, whose plain SSD also rounds its dot inputs to bf16 where
# the kernel does not; 0.037 recurrentgemma over 38), while a wrong mask,
# head, slot or decay moves the logits by order 100%. f32 is the tight check
# (summation order only).
SERVE_BF16_REL_RMS = {"qwen3-1.7b": 0.05, "mamba2-1.3b": 0.08, "recurrentgemma-9b": 0.08}
SERVE_F32_ABS = 1e-3


def emit(key, value):
    print(json.dumps({key: value}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dev, dtype)


def max_err(got, want, tol):
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def rel_rms(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def kernel_modules():
    from repro_torch.kernels import decode_attention, flash_attention, rglru_scan, ssd_scan
    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "ssd_scan": ssd_scan, "rglru_scan": rglru_scan}


# --------------------------------------------------------------------------
# kernel against plain version
# --------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset
    (1, 128, 128, 2, 2, 64, True, 0, 0),
    (2, 256, 256, 4, 2, 16, True, 0, 0),
    (1, 256, 256, 4, 1, 64, False, 0, 0),
    (1, 384, 384, 2, 1, 16, True, 128, 0),
    (1, 100, 100, 4, 2, 64, True, 0, 0),
    (1, 200, 200, 2, 1, 16, False, 0, 0),
    (2, 64, 192, 4, 2, 128, True, 0, 128),
    (1, 96, 160, 8, 2, 128, True, 64, 64),
    (2, 128, 128, 8, 2, 128, True, 0, 0),
    (1, 64, 64, 2, 1, 32, True, 0, -16),      # rows with no visible key
    (1, 128, 128, 2, 1, 256, True, 0, 0),     # Dh 256
    (4, 512, 512, 16, 8, 128, True, 0, 0),    # qwen3-1.7b prefill, full width
    (4, 3072, 3072, 16, 1, 256, True, 2048, 0),  # recurrentgemma-9b prefill: window cuts keys
]
FLASH_SERVE = {"qwen3-1.7b": FLASH_CASES[-2], "recurrentgemma-9b": FLASH_CASES[-1]}
DECODE_CASES = [
    # B, C, H, Hkv, Dh, cache_len
    (4, 300, 4, 2, 64, (0, 1, 300, 157)),
    (3, 128, 6, 3, 16, (128, 0, 77)),
    (2, 200, 8, 1, 256, (200, 17)),
    (2, 200, 8, 2, 128, (1, 200)),
    (2, 300, 12, 1, 64, (300, 5)),            # group 12: a full and a partial slice
    (4, 544, 16, 8, 128, (1, 200, 544, 377)),  # qwen3-1.7b decode, full width
    (4, 2048, 16, 1, 256, (2048, 2048, 1000, 0)),  # recurrentgemma-9b: group 16, full ring
]
DECODE_SERVE = {"qwen3-1.7b": DECODE_CASES[-2], "recurrentgemma-9b": DECODE_CASES[-1]}
SSD_CASES = [
    # B, S, H, P, N, chunk, h0
    (4, 2048, 64, 64, 128, 256, False),       # mamba2-1.3b prefill, full width
    (2, 300, 8, 64, 128, 256, True),          # ragged S (one full and one partial chunk), h0
    (2, 37, 3, 8, 16, 8, True),               # smoke-sized heads, ragged S, h0
    (1, 100, 4, 16, 32, 32, False),
    (2, 48, 2, 64, 128, 64, False),           # S shorter than a 256 chunk would be
]
RGLRU_CASES = [
    # B, S, W, h0
    (4, 3072, 4096, False),                   # recurrentgemma-9b prefill, full width
    (3, 1001, 1000, True),                    # ragged S and W, h0
    (2, 7, 33, True),
    (1, 256, 512, False),
]


def flash_inputs(case, dtype, dev, seed=0):
    B, Sq, Skv, H, Hkv, Dh = case[:6]
    gen = torch.Generator().manual_seed(seed)
    return (randn(gen, (B, Sq, H, Dh), dtype, dev), randn(gen, (B, Skv, Hkv, Dh), dtype, dev),
            randn(gen, (B, Skv, Hkv, Dh), dtype, dev))


def decode_inputs(case, dtype, dev, seed=0):
    B, C, H, Hkv, Dh, lens = case
    gen = torch.Generator().manual_seed(seed)
    return (randn(gen, (B, H, Dh), dtype, dev), randn(gen, (B, C, Hkv, Dh), dtype, dev),
            randn(gen, (B, C, Hkv, Dh), dtype, dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def ssd_inputs(case, dtype, dev, seed=0):
    """Inputs in the ranges mamba2 gives the scan: dt = softplus(N(0,1) - 3),
    A = -(1..16), unit-normal x, B, C and h0."""
    B, S, H, P, N, _, with_h0 = case
    gen = torch.Generator().manual_seed(seed)
    x = randn(gen, (B, S, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(randn(gen, (B, S, H), torch.float32, dev) - 3.0)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, Cm = randn(gen, (B, S, N), dtype, dev), randn(gen, (B, S, N), dtype, dev)
    h0 = randn(gen, (B, H, P, N), torch.float32, dev) if with_h0 else None
    return x, dt, A, Bm, Cm, h0


def rglru_inputs(case, dtype, dev, seed=0):
    B, S, W, with_h0 = case
    gen = torch.Generator().manual_seed(seed)
    x = randn(gen, (B, S, W), dtype, dev)
    a_log = -randn(gen, (B, S, W), torch.float32, dev).abs() * 0.5
    h0 = randn(gen, (B, W), torch.float32, dev) if with_h0 else None
    return x, a_log, h0


def _check(kernel, case, dtype, out, ok, msg):
    emit("check", {"kernel": kernel, "case": case, "dtype": str(dtype), **out, "ok": ok})
    if not ok:
        fail(f"{kernel} {case} {dtype}: {msg or out}")


def run_checks(dev):
    """Every kernel against its plain version; returns the bf16 max abs error
    at each serve shape, keyed by (kernel, arch)."""
    from repro_torch.kernels import ops, ref
    worst = {}
    dtypes = (torch.float32, torch.bfloat16)
    for case in FLASH_CASES:
        for dtype, tol in zip(dtypes, (F32_TOL, BF16_TOL)):
            causal, window, q_offset = case[6:]
            q, k, v = flash_inputs(case, dtype, dev)
            got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
            want = ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, tol)
            _check("flash_attention", case, dtype, {"max_abs_err": err, "tol": tol}, ok, "")
            for arch, c in FLASH_SERVE.items():
                if case == c and dtype == torch.bfloat16:
                    worst[("flash_attention", arch)] = err
            del q, k, v, got, want
    for case in DECODE_CASES:
        for dtype, tol in zip(dtypes, (F32_TOL, BF16_TOL)):
            q, kc, vc, cl = decode_inputs(case, dtype, dev)
            got = ops.decode_attention(q, kc, vc, cl)
            want = ref.decode_attention(q, kc, vc, cl)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, tol)
            empty = [i for i, n in enumerate(case[5]) if n == 0]
            ok = ok and int(torch.count_nonzero(got[empty])) == 0
            _check("decode_attention", case, dtype, {"max_abs_err": err, "tol": tol}, ok, "")
            for arch, c in DECODE_SERVE.items():
                if case == c and dtype == torch.bfloat16:
                    worst[("decode_attention", arch)] = err
    for case in SSD_CASES:
        for dtype in dtypes:
            x, dt, A, Bm, Cm, h0 = ssd_inputs(case, dtype, dev)
            y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=case[5], h0=h0)
            yo, ho = ref.ssd_sequential(x, dt, A, Bm, Cm, h0=h0)
            yp, hp = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=case[5], h0=h0)
            torch.cuda.synchronize()
            y_tol = SSD_ORACLE_TOL if dtype == torch.float32 else BF16_TOL
            ey, oky = max_err(y, yo, y_tol)
            eh, okh = max_err(hf, ho, SSD_ORACLE_TOL)
            ep, okp = max_err(y, yp, SSD_ORACLE_TOL)
            rp = {"y": rel_rms(y, yp), "h_final": rel_rms(hf, hp)}
            if dtype == torch.bfloat16:
                okp = max(rp.values()) <= SSD_PLAIN_BF16_REL_RMS
            out = {"vs_oracle": {"y_max_abs": ey, "y_tol": y_tol, "h_max_abs": eh,
                                 "h_tol": SSD_ORACLE_TOL},
                   "vs_plain": {"y_max_abs": ep, "rel_rms": rp,
                                "bound": ({"max_abs_rel": SSD_ORACLE_TOL}
                                          if dtype == torch.float32
                                          else {"rel_rms": SSD_PLAIN_BF16_REL_RMS})},
                   "finite": bool(torch.isfinite(y).all() and torch.isfinite(hf).all())}
            _check("ssd_scan", case, dtype, out, oky and okh and okp and out["finite"], "")
            if case == SSD_CASES[0] and dtype == torch.bfloat16:
                worst[("ssd_scan", "mamba2-1.3b")] = ep
            del x, Bm, Cm, y, yo, yp
    for case in RGLRU_CASES:
        for dtype in dtypes:
            tol = RGLRU_TOL[dtype]
            x, a_log, h0 = rglru_inputs(case, dtype, dev)
            y, hl = ops.rglru_scan(x, a_log, h0=h0)
            yp, hp = ref.rglru_scan(x, a_log, h0=h0)
            torch.cuda.synchronize()
            ey, oky = max_err(y, yp, tol)
            eh, okh = max_err(hl, hp, tol)
            ok = oky and okh and y.dtype == dtype and hl.dtype == dtype
            _check("rglru_scan", case, dtype,
                   {"y_max_abs": ey, "h_last_max_abs": eh, "tol": tol}, ok, "")
            if case == RGLRU_CASES[0] and dtype == torch.bfloat16:
                worst[("rglru_scan", "recurrentgemma-9b")] = max(ey, eh)
    return worst


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def run_serve(cfg, params, dev, card):
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    mods = kernel_modules()
    kw = dict(batch=SERVE["batch"], prompt_len=PROMPT[cfg.arch_id], gen_len=SERVE["gen_len"],
              seed=SERVE["seed"])
    # warm-up: cuBLAS handles, allocator pools and the kernels' first launches
    serve.serve(cfg, params, device=dev, requests=SERVE["batch"], **{**kw, "gen_len": 2})
    for m in mods.values():
        m.launches = 0
    ref.calls = 0
    res = serve.serve(cfg, params, device=dev, requests=SERVE["requests"], **kw)
    launches = {name: m.launches for name, m in mods.items()}
    plain_calls = ref.calls
    expected = {name: EXPECTED[cfg.arch_id].get(name, 0) for name in mods}
    n_batches = -(-SERVE["requests"] // SERVE["batch"])
    ms = 1e-6
    out = {
        "card": card, "arch": cfg.arch_id, "params": cfg.param_count(),
        "requests": SERVE["requests"], **kw,
        "ttft_ms_median": res["ttft"].median_ns * ms, "ttft_ms_p99": res["ttft"].p99_ns * ms,
        "tpot_ms_median": res["tpot"].median_ns * ms, "tpot_ms_p99": res["tpot"].p99_ns * ms,
        "tok_per_s": res["tok_per_s"], "wall_s": res["wall_s"],
        "total_tokens": res["total_tokens"], "launches": launches,
        "expected_launches": expected, "plain_calls": plain_calls, "finite": res["finite"],
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    emit("serve", out)
    if launches != expected:
        fail(f"{cfg.arch_id}: launch counts {launches} != expected {expected}")
    if plain_calls != 0:
        fail(f"{cfg.arch_id}: serving called the plain versions {plain_calls} times")
    if not res["finite"]:
        fail(f"{cfg.arch_id}: serving produced non-finite logits")
    if res["tokens"].shape != (n_batches * SERVE["batch"], SERVE["gen_len"] + 1):
        fail(f"{cfg.arch_id}: generated tokens have shape {tuple(res['tokens'].shape)}")
    return out


class plain_kernels:
    """Within the block, the model's kernel calls go to the plain versions."""
    NAMES = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan")

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.ops, self.saved = ops, {n: getattr(ops, n) for n in self.NAMES}

        def flash(q, k, v, *, causal=True, window=0, q_offset=0, softmax_scale=None):
            return ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset,
                           softmax_scale=softmax_scale)

        def decode(q, kc, vc, cl, *, softmax_scale=None):
            return ref.decode_attention(q, kc, vc, cl, softmax_scale=softmax_scale)

        def ssd(x, dt, A, Bm, Cm, *, chunk=128, h0=None):
            return ref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)

        def rglru(x, a_log, *, h0=None):
            return ref.rglru_scan(x, a_log, h0=h0)

        for name, fn in zip(self.NAMES, (flash, decode, ssd, rglru)):
            setattr(ops, name, fn)

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


def logits_run(cfg, params, prompt, steps, forced=None):
    """Prefill + ``steps`` decode steps. Decode inputs are ``forced`` tokens
    when given (teacher forcing), else this run's own argmax."""
    from repro_torch.models import lm
    B, S = prompt.shape
    logits, cache = lm.prefill(cfg, params, {"tokens": prompt}, S + steps)
    outs, toks = [logits.float()], []
    for i in range(steps):
        tok = forced[i] if forced is not None else logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        pos = torch.full((B,), S + i, dtype=torch.int32, device=prompt.device)
        logits, cache = lm.decode_step(cfg, params, cache, tok, pos)
        outs.append(logits.float())
    return torch.stack(outs), toks


def _cast_tree(node, dtype):
    """Every leaf in ``dtype`` (the f32 decay leaves are f32 already)."""
    if isinstance(node, dict):
        return {k: _cast_tree(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [_cast_tree(v, dtype) for v in node]
    return node.to(dtype)


def f32_copy(cfg, params):
    """An f32 copy of the served model. recurrentgemma-9b (35 GB in f32) keeps
    its first pattern unit and the tail: full width, 5 of 38 layers."""
    c = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p = params
    if cfg.family == "hybrid":
        c = c.replace(n_layers=len(cfg.block_pattern) + len(params["backbone"]["tail"]))
        unit0 = [{k: _slice0(v) for k, v in u.items()} for u in params["backbone"]["units"]]
        p = {**params, "backbone": {"units": unit0, "tail": params["backbone"]["tail"]}}
    return c, _cast_tree(p, torch.float32)


def _slice0(node):
    return {k: _slice0(v) for k, v in node.items()} if isinstance(node, dict) else node[:1]


def run_serve_vs_plain(cfg, params, dev, steps=4):
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE["batch"], PROMPT[cfg.arch_id]),
                           generator=gen).to(dev)
    out = {"arch": cfg.arch_id}
    for name in ("bfloat16", "float32"):
        c, p = (cfg, params) if name == "bfloat16" else f32_copy(cfg, params)
        kern, toks = logits_run(c, p, prompt, steps)
        with plain_kernels():
            plain, _ = logits_run(c, p, prompt, steps, forced=toks)
        del p
        diff = kern - plain
        rr = float(diff.norm() / plain.norm())
        max_abs = float(diff.abs().max())
        agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        bf16_bound = SERVE_BF16_REL_RMS[cfg.arch_id]
        ok = bool(torch.isfinite(kern).all()) and (
            rr <= bf16_bound if name == "bfloat16" else max_abs <= SERVE_F32_ABS)
        out[name] = {"n_layers": c.n_layers,
                     "prefill_max_abs": float(diff[0].abs().max()),
                     "decode_max_abs": float(diff[1:].abs().max()),
                     "max_abs": max_abs, "rel_rms": rr, "argmax_agree": agree,
                     "max_abs_logit": float(plain.abs().max()), "decode_steps": steps,
                     "bound": ({"rel_rms": bf16_bound} if name == "bfloat16"
                               else {"max_abs": SERVE_F32_ABS}), "ok": ok}
        del kern, plain, diff
        torch.cuda.empty_cache()
        if not ok:
            emit("serve_vs_plain", out)
            fail(f"{cfg.arch_id}: serving with kernels disagrees with the plain versions "
                 f"in {name}: {out[name]}")
    emit("serve_vs_plain", out)


# --------------------------------------------------------------------------
# trace: device busy / idle share
# --------------------------------------------------------------------------

def _busy_us(events):
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + ((cur_e - cur_s) if cur_e is not None else 0.0)


def run_trace(cfg, params, dev, steps=8):
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from repro_torch.models import lm
    B, S = SERVE["batch"], PROMPT[cfg.arch_id]
    prompt = torch.randint(0, cfg.vocab_size, (B, S), device=dev)
    out = {"arch": cfg.arch_id}
    for phase in ("prefill", "decode"):
        torch.cuda.synchronize()
        if phase == "decode":
            logits, cache = lm.prefill(cfg, params, {"tokens": prompt}, S + steps)
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                lm.prefill(cfg, params, {"tokens": prompt}, S + SERVE["gen_len"])
            else:
                for i in range(steps):
                    pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
                    logits, cache = lm.decode_step(cfg, params, cache, tok, pos)
                    tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        n = 1 if phase == "prefill" else steps
        busy = _busy_us(kernels) if kernels else None
        out[phase] = {
            "steps": n, "host_ms_per_step": wall_us / n / 1e3,
            "device_busy_ms_per_step": None if busy is None else busy / n / 1e3,
            "device_idle_share": None if busy is None else 1.0 - busy / wall_us,
            "top_kernels_ms_per_step": sorted(
                ([k[:90], v / n / 1e3] for k, v in by_name.items()), key=lambda kv: -kv[1])[:8],
        }
    emit("trace", out)


# --------------------------------------------------------------------------
# kernel times and bounds
# --------------------------------------------------------------------------

def bound(nbytes, flops, flop_rate=BF16_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _row(name, arch, launches, errs, card, **kw):
    src = {"flash_attention": ("flash_attention.cu", "flash_attention.py:92"),
           "decode_attention": ("decode_attention.cu", "decode_attention.py:62"),
           "ssd_scan": ("ssd_scan.cu", "ssd_scan.py:66"),
           "rglru_scan": ("rglru_scan.cu", "rglru_scan.py:46")}[name]
    return {"name": f"{name} ({arch})", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src[0]}",
            "replaces": f"src/repro/kernels/{src[1]}",
            "launches": launches[arch][name], "max_abs_err": errs[(name, arch)],
            **kw, "card": card}


def time_flash(arch, launches, errs, card, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    case = FLASH_SERVE[arch]
    B, S, _, H, Hkv, Dh, causal, window, _ = case
    scale = Dh ** -0.5
    q, k, v = flash_inputs(case, torch.bfloat16, dev, seed=3)
    # visible (q, k) pairs per (b, h) under the causal and window masks
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), 4 * Dh * pairs * B * H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:  # SDPA takes the window only as a mask, built outside the timing
        mask = ref.attention_mask(S, S, causal=causal, window=window, device=dev)
    kern = lambda: kflash.flash_attention_cuda(  # noqa: E731
        q, k, v, causal=causal, window=window, q_offset=0, softmax_scale=scale)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, scale=scale,
        enable_gqa=True).transpose(1, 2)
    heads_major = [t.contiguous() for t in (qt, kt, vt)]
    return _row("flash_attention", arch, launches, errs, card,
                ms=time_ms(kern, iters=20 if window else 50),
                plain_ms=time_ms(lambda: ref.mha(q, k, v, causal=causal, window=window,
                                                 softmax_scale=scale), iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, iters=20),
                library="scaled_dot_product_attention" + (" with a window mask" if window else ""),
                library_vs_kernel_max_abs=max_err(lib(), kern(), BF16_TOL),
                library_head_major_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    *heads_major, attn_mask=mask, is_causal=mask is None, scale=scale,
                    enable_gqa=True), iters=20),
                shape={"B": B, "Sq": S, "Skv": S, "H": H, "Hkv": Hkv, "Dh": Dh,
                       "causal": causal, "window": window, "dtype": "bfloat16"})


def time_decode(arch, launches, errs, card, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref
    B, C, H, Hkv, Dh, _ = DECODE_SERVE[arch]
    gen_len = SERVE["gen_len"]
    # qwen3: the middle decode step over a cache of prompt + gen slots;
    # recurrentgemma: the ring is full at every decode step
    n = PROMPT[arch] + gen_len // 2 + 1 if C > PROMPT[arch] else C
    lens = (n,) * B
    scale = Dh ** -0.5
    q1, kc, vc, cl = decode_inputs((B, C, H, Hkv, Dh, lens), torch.bfloat16, dev, seed=4)
    valid = sum(lens)
    b_ms, b_by = bound(2 * (2 * q1.numel() + 2 * valid * Hkv * Dh) + 4 * B, 4 * Dh * H * valid)
    # every row has the same length n, so SDPA on the first n slots, unmasked,
    # computes the same function
    q1t, kct, vct = q1[:, :, None], kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
    kern = lambda: kdec.decode_attention_cuda(q1, kc, vc, cl, softmax_scale=scale)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q1t, kct, vct, scale=scale, enable_gqa=True)[:, :, 0]
    heads_major = [t.contiguous() for t in (q1t, kct, vct)]
    return _row("decode_attention", arch, launches, errs, card,
                ms=time_ms(kern, iters=200),
                plain_ms=time_ms(lambda: ref.decode_attention(q1, kc, vc, cl,
                                                              softmax_scale=scale)),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, iters=200),
                library="scaled_dot_product_attention",
                library_vs_kernel_max_abs=max_err(lib(), kern(), BF16_TOL),
                library_head_major_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    *heads_major, scale=scale, enable_gqa=True), iters=200),
                shape={"B": B, "C": C, "H": H, "Hkv": Hkv, "Dh": Dh, "cache_len": list(lens),
                       "dtype": "bfloat16"})


def time_ssd(launches, errs, card, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    case = SSD_CASES[0]
    B, S, H, P, N, Q, _ = case
    x, dt, A, Bm, Cm, _ = ssd_inputs(case, torch.bfloat16, dev, seed=5)
    nbytes = (2 * x.numel() * 2 + dt.numel() * 4 + A.numel() * 4 + 2 * Bm.numel() * 2
              + B * H * P * N * 4)
    # the chunked form's products, lower triangles only: C.B^T per (b, chunk),
    # the intra-chunk, carried and state products per (b, chunk, head)
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    flops = B * nc * (2 * tri * N + H * (2 * tri * P + 2 * 2 * Q * P * N))
    b_ms, b_by = bound(nbytes, flops)
    return _row("ssd_scan", "mamba2-1.3b", launches, errs, card,
                ms=time_ms(lambda: kssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q), iters=10),
                plain_ms=time_ms(lambda: ref.ssd_scan(x, dt, A, Bm, Cm, chunk=Q),
                                 iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library="none: no single PyTorch call computes an SSD scan",
                shape={"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": Q,
                       "dtype": "bfloat16", "flops": flops, "bytes": nbytes})


def time_rglru(launches, errs, card, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as krglru
    case = RGLRU_CASES[0]
    B, S, W, _ = case
    x, a_log, _ = rglru_inputs(case, torch.bfloat16, dev, seed=6)
    nbytes = x.numel() * (2 + 4 + 2) + B * W * 2
    # per element: exp, a*a, 1 - a^2, max, sqrt, the product with x, one FMA
    flops = 7 * x.numel()
    b_ms, b_by = bound(nbytes, flops, F32_FLOP_PER_S)
    return _row("rglru_scan", "recurrentgemma-9b", launches, errs, card,
                ms=time_ms(lambda: krglru.rglru_scan_cuda(x, a_log), iters=20),
                plain_ms=time_ms(lambda: ref.rglru_scan(x, a_log), iters=2, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library="none: no single PyTorch call computes an RG-LRU scan",
                shape={"B": B, "S": S, "W": W, "x": "bfloat16", "a_log": "float32",
                       "bytes": nbytes})


def run_times(launches, errs, card, dev):
    rows = [time_flash("qwen3-1.7b", launches, errs, card, dev),
            time_decode("qwen3-1.7b", launches, errs, card, dev),
            time_ssd(launches, errs, card, dev),
            time_rglru(launches, errs, card, dev),
            time_flash("recurrentgemma-9b", launches, errs, card, dev),
            time_decode("recurrentgemma-9b", launches, errs, card, dev)]
    for r in rows:
        emit("time", r)
        # a yardstick must compute the kernel's function on the same inputs
        if r["library_ms"] is not None and not r["library_vs_kernel_max_abs"][1]:
            fail(f"{r['name']}: the library call disagrees with the kernel")
    return rows


def run_arch(arch, dev, card):
    """Serve, serve_vs_plain and trace for one arch at full width; returns
    the serve run's launch counts."""
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    params = serve.init_params(cfg, SERVE["seed"], dev)
    served = run_serve(cfg, params, dev, card)
    run_serve_vs_plain(cfg, params, dev)
    run_trace(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    return served["launches"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 checks are exact f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from repro_torch.kernels import _build

    card = card_line()
    emit("device", {"name": torch.cuda.get_device_name(0),
                    "capability": list(torch.cuda.get_device_capability(0)),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "nvidia_smi": card, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    per_source = _build.build_all(SOURCES)
    emit("build", {"seconds": time.perf_counter() - t0, "per_source_s": per_source})

    errs = run_checks(dev)
    launches = {arch: run_arch(arch, dev, card) for arch in PROMPT}
    rows = run_times(launches, errs, card, dev)

    emit("total_s", time.perf_counter() - t_start)
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
