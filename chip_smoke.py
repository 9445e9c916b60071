"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:

1. device: name, capability, torch and CUDA versions, nvidia-smi's name and
   power limit;
2. build: both CUDA sources under src/repro_torch/kernels/csrc, one nvcc per
   source, started together;
3. checks: each kernel against its plain PyTorch version on the card, on the
   same inputs (f32 at 2e-5 with TF32 off, bf16 at 2e-2);
4. serve: qwen3-1.7b at full width with random weights from a seed, 8
   requests in batches of 4, prompt 512, 32 generated tokens, through
   repro_torch.launch.serve; the launch counters must read exactly 56 flash
   and 1792 decode launches and the plain-version counter 0;
5. serve_vs_plain: prefill and teacher-forced decode logits with the kernels
   against the same model on the plain versions, on the card, in f32 and bf16;
6. trace: device busy and idle share of one prefill and of decode steps;
7. times: each kernel at the serve shapes (CUDA events), its plain version,
   scaled_dot_product_attention as the library yardstick on the same inputs
   (checked against the kernel) and, labelled apart, on contiguous
   (B, heads, S, Dh) copies made outside the timing, and the bound.

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
F32_TOL, BF16_TOL = 2e-5, 2e-2
SERVE = dict(arch="qwen3-1.7b", requests=8, batch=4, prompt_len=512, gen_len=32, seed=0)
# plain vs kernel serving in bf16: relative RMS of the logit difference. Both
# attend in f32 and round to bf16, but in another order, so bf16 rounding
# flips feed 28 layers of random weights; 5% bounds that noise while a wrong
# mask, head or slot moves the logits by order 100% (f32 below is the tight check).
SERVE_BF16_REL_RMS = 0.05
SERVE_F32_ABS = 1e-3          # f32 end to end: summation order only


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
]
DECODE_CASES = [
    # B, C, H, Hkv, Dh, cache_len
    (4, 300, 4, 2, 64, (0, 1, 300, 157)),
    (3, 128, 6, 3, 16, (128, 0, 77)),
    (2, 200, 8, 1, 256, (200, 17)),
    (2, 200, 8, 2, 128, (1, 200)),
    (4, 544, 16, 8, 128, (1, 200, 544, 377)),  # qwen3-1.7b decode, full width
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


def run_checks(dev):
    from repro_torch.kernels import ops, ref
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    for case in FLASH_CASES:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            causal, window, q_offset = case[6:]
            q, k, v = flash_inputs(case, dtype, dev)
            got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
            want = ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, tol)
            emit("check", {"kernel": "flash_attention", "case": case, "dtype": str(dtype),
                           "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                fail(f"flash_attention {case} {dtype}: max abs err {err}")
            if case == FLASH_CASES[-1] and dtype == torch.bfloat16:
                worst["flash_attention"] = err
    for case in DECODE_CASES:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, kc, vc, cl = decode_inputs(case, dtype, dev)
            got = ops.decode_attention(q, kc, vc, cl)
            want = ref.decode_attention(q, kc, vc, cl)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, tol)
            empty = [i for i, n in enumerate(case[5]) if n == 0]
            ok = ok and int(torch.count_nonzero(got[empty])) == 0
            emit("check", {"kernel": "decode_attention", "case": case, "dtype": str(dtype),
                           "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                fail(f"decode_attention {case} {dtype}: max abs err {err}")
            if case == DECODE_CASES[-1] and dtype == torch.bfloat16:
                worst["decode_attention"] = err
    return worst


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def run_serve(cfg, params, dev, card):
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    kw = {k: SERVE[k] for k in ("batch", "prompt_len", "gen_len", "seed")}
    # warm-up: cuBLAS handles, allocator pools and the kernels' first launches
    serve.serve(cfg, params, device=dev, requests=SERVE["batch"],
                **{**kw, "gen_len": 2})
    kflash.launches = kdec.launches = ref.calls = 0
    res = serve.serve(cfg, params, device=dev, requests=SERVE["requests"], **kw)
    launches = {"flash_attention": kflash.launches, "decode_attention": kdec.launches}
    plain_calls = ref.calls
    n_batches = -(-SERVE["requests"] // SERVE["batch"])
    expected = {"flash_attention": cfg.n_layers * n_batches,
                "decode_attention": cfg.n_layers * n_batches * SERVE["gen_len"]}
    ms = 1e-6
    out = {
        "card": card, "arch": cfg.arch_id, "params": cfg.param_count(), **SERVE,
        "ttft_ms_median": res["ttft"].median_ns * ms, "ttft_ms_p99": res["ttft"].p99_ns * ms,
        "tpot_ms_median": res["tpot"].median_ns * ms, "tpot_ms_p99": res["tpot"].p99_ns * ms,
        "tok_per_s": res["tok_per_s"], "wall_s": res["wall_s"],
        "total_tokens": res["total_tokens"], "launches": launches,
        "expected_launches": expected, "plain_calls": plain_calls, "finite": res["finite"],
    }
    emit("serve", out)
    if launches != expected:
        fail(f"launch counts {launches} != expected {expected}")
    if plain_calls != 0:
        fail(f"serving called the plain attention {plain_calls} times")
    if not res["finite"]:
        fail("serving produced non-finite logits")
    if res["tokens"].shape != (n_batches * SERVE["batch"], SERVE["gen_len"] + 1):
        fail(f"generated tokens have shape {tuple(res['tokens'].shape)}")
    return out


class plain_attention:
    """Within the block, the model's attention calls go to the plain versions."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.ops, self.saved = ops, (ops.flash_attention, ops.decode_attention)

        def flash(q, k, v, *, causal=True, window=0, q_offset=0, softmax_scale=None):
            return ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset,
                           softmax_scale=softmax_scale)

        def decode(q, kc, vc, cl, *, softmax_scale=None):
            return ref.decode_attention(q, kc, vc, cl, softmax_scale=softmax_scale)

        ops.flash_attention, ops.decode_attention = flash, decode

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.decode_attention = self.saved


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


def run_serve_vs_plain(cfg, params, dev, steps=4):
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"]),
                           generator=gen).to(dev)
    out = {}
    for name in ("bfloat16", "float32"):
        c, p = cfg, params
        if name == "float32":  # f32 copy of the same weights: order of sums only
            c = cfg.replace(param_dtype="float32", compute_dtype="float32")
            p = _cast_tree(params, torch.float32)
        kern, toks = logits_run(c, p, prompt, steps)
        with plain_attention():
            plain, _ = logits_run(c, p, prompt, steps, forced=toks)
        del p
        diff = kern - plain
        rel_rms = float(diff.norm() / plain.norm())
        max_abs = float(diff.abs().max())
        agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        ok = bool(torch.isfinite(kern).all()) and (
            rel_rms <= SERVE_BF16_REL_RMS if name == "bfloat16" else max_abs <= SERVE_F32_ABS)
        out[name] = {"prefill_max_abs": float(diff[0].abs().max()),
                     "decode_max_abs": float(diff[1:].abs().max()),
                     "max_abs": max_abs, "rel_rms": rel_rms, "argmax_agree": agree,
                     "max_abs_logit": float(plain.abs().max()), "decode_steps": steps,
                     "bound": ({"rel_rms": SERVE_BF16_REL_RMS} if name == "bfloat16"
                               else {"max_abs": SERVE_F32_ABS}), "ok": ok}
        if not ok:
            emit("serve_vs_plain", out)
            fail(f"serving with kernels disagrees with plain attention in {name}: {out[name]}")
        torch.cuda.empty_cache()
    emit("serve_vs_plain", out)


def _cast_tree(node, dtype):
    if isinstance(node, dict):
        return {k: _cast_tree(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [_cast_tree(v, dtype) for v in node]
    return node.to(dtype)


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
    B, S = SERVE["batch"], SERVE["prompt_len"]
    prompt = torch.randint(0, cfg.vocab_size, (B, S), device=dev)
    out = {}
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

def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def run_times(cfg, dev, launches, errs, card):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    B, S, gen_len = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    H, Hkv, Dh, dt = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, torch.bfloat16
    scale = Dh ** -0.5
    el = 2
    rows = []

    # flash: the prefill call, causal over the 512-token prompt
    q, k, v = flash_inputs((B, S, S, H, Hkv, Dh), dt, dev, seed=3)
    pairs = S * (S + 1) // 2  # visible (q, k) pairs per (b, h) under the causal mask
    b_ms, b_by = bound(el * (2 * q.numel() + k.numel() + v.numel()), 4 * Dh * pairs * B * H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    heads_major = [t.contiguous() for t in (qt, kt, vt)]
    kern = lambda: kflash.flash_attention_cuda(  # noqa: E731
        q, k, v, causal=True, window=0, q_offset=0, softmax_scale=scale)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True).transpose(1, 2)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": launches["flash_attention"], "max_abs_err": errs["flash_attention"],
        "ms": time_ms(kern),
        "plain_ms": time_ms(lambda: ref.mha(q, k, v, causal=True, softmax_scale=scale), iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lib),
        "library_vs_kernel_max_abs": max_err(lib(), kern(), BF16_TOL),
        "library_head_major_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *heads_major, is_causal=True, scale=scale, enable_gqa=True)),
        "shape": {"B": B, "Sq": S, "Skv": S, "H": H, "Hkv": Hkv, "Dh": Dh, "causal": True,
                  "dtype": "bfloat16"},
        "card": card,
    })

    # decode: the middle decode step of a batch, cache of prompt + gen slots
    C = S + gen_len
    n = S + gen_len // 2 + 1
    lens = (n,) * B
    q1, kc, vc, cl = decode_inputs((B, C, H, Hkv, Dh, lens), dt, dev, seed=4)
    valid = sum(lens)
    b_ms, b_by = bound(el * (2 * q1.numel() + 2 * valid * Hkv * Dh) + 4 * B, 4 * Dh * H * valid)
    # every row has the same length n, so SDPA on the first n slots, unmasked,
    # computes the same function
    q1t, kct, vct = q1[:, :, None], kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
    kern = lambda: kdec.decode_attention_cuda(q1, kc, vc, cl, softmax_scale=scale)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q1t, kct, vct, scale=scale, enable_gqa=True)[:, :, 0]
    heads_major = [t.contiguous() for t in (q1t, kct, vct)]
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:62",
        "launches": launches["decode_attention"], "max_abs_err": errs["decode_attention"],
        "ms": time_ms(kern, iters=200),
        "plain_ms": time_ms(lambda: ref.decode_attention(q1, kc, vc, cl, softmax_scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lib, iters=200),
        "library_vs_kernel_max_abs": max_err(lib(), kern(), BF16_TOL),
        "library_head_major_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *heads_major, scale=scale, enable_gqa=True), iters=200),
        "shape": {"B": B, "C": C, "H": H, "Hkv": Hkv, "Dh": Dh, "cache_len": list(lens),
                  "dtype": "bfloat16"},
        "card": card,
    })
    for r in rows:
        emit("time", r)
        # the yardstick must compute the kernel's function on the same inputs
        if not r["library_vs_kernel_max_abs"][1]:
            fail(f"{r['name']}: the library call disagrees with the kernel")
    return rows


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
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_config

    card = card_line()
    emit("device", {"name": torch.cuda.get_device_name(0),
                    "capability": list(torch.cuda.get_device_capability(0)),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "nvidia_smi": card, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    per_source = _build.build_all(["flash_attention", "decode_attention"])
    emit("build", {"seconds": time.perf_counter() - t0, "per_source_s": per_source})

    errs = run_checks(dev)

    cfg = get_config(SERVE["arch"])
    params = serve.init_params(cfg, SERVE["seed"], dev)
    served = run_serve(cfg, params, dev, card)
    run_serve_vs_plain(cfg, params, dev)
    run_trace(cfg, params, dev)
    rows = run_times(cfg, dev, served["launches"], errs, card)

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
