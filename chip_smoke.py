"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:

1. device: name, capability, torch and CUDA versions, nvidia-smi's name and
   power limit;
2. build: the eight CUDA sources under src/repro_torch/kernels/csrc, one nvcc
   per source, started together;
3. checks: each kernel against its plain PyTorch version on the card, on the
   same inputs, in f32 (TF32 off) and bf16: flash and decode attention at
   2e-5 / 2e-2 (bf16 also within a relative RMS of 1e-2), the RG-LRU scan at 1e-4 / 3e-2, the SSD scan against the
   sequential oracle at 5e-4 (bf16: 2e-2 on y, the oracle rounding only its
   output) and against the port's chunked plain version within a relative
   RMS of 1e-2 in bf16 (5e-4 in f32); the cases include each serve shape,
   ragged S and W, a non-zero h0 (carried by the SSD scan across 8 chunks
   too), an SSD chunk of 1, group 16 at head_dim 256, a window that
   cuts keys (mixtral-8x7b's: 4096 at head_dim 128 over S 4608), GQA
   groups 3, 4 and 5 at head_dim 128 (the plain attention in blocks of
   query rows where its scores would not fit), and flash at head_dim 80
   and 96 (run on the head_dim 128
   body with zero columns) with ragged Sq and Skv under q_offset; decode
   at groups 1 to 16, rows of len 0 (exactly 0), 1, a key either side of a
   64-key tile edge and C, C not a multiple of the tile, and head_dim 24
   (the mma body) and 20 (the FMA body, in bf16 too);
   gather: the burst gather exactly equal to its plain version on the
   shapes of tests/test_kernels.py, the edge cases (slots past the arena and
   negative, lengths negative and past the width, a width past the slot
   size, no packets, widths 1, 15 and 17 whose 16-byte chunks straddle rows,
   a partial last chunk at 1518, arenas that are views off a 16-byte
   boundary), the whole ring of 4096 slots and the benchmark shape (arena
   4096 x 1518, 256 packets); then 16 bursts at the benchmark shape through
   ops.burst_gather with the counters set to 0 just before (16 launches, 0
   plain calls);
   epoch_pass: the simulator's epoch pass exactly equal to its plain version
   on the card and to the numpy pass, with a queue table and without, at
   n = 1 to 2^24 frames (tile edges, the bench epoch of 63 342) and on the
   edge cases (no frames, one, a burst of equal times, a wire busy past
   every frame, the ideal wire, negative flow ids), and a flow id out of
   range raising IndexError;
   simulate_vs_event and simulate: the port's simulator
   (repro_torch.core.fastpath.run_epoch_sim) at benchmarks/fastpath_bench.py's
   shape (one 100 GbE port, 8 RSS queues on 8 lcores, 1518-byte frames at
   100 Gbit/s, 0.1 s simulated) and its two-port version (16 lcores, 200
   Gbit/s, 0.05 s): the event loop at 0.004 s equal to both engines there,
   then each shape through the numpy pass and through the kernel
   (device="cuda"), three times each in turns, with the counters set to 0
   just before each kernel run: RunReports, per-queue stats and clocks
   bit-equal, on the fast path, the kernel's launches equal to the run's
   epochs and 0 plain calls; the wall time of each run, simulated packets
   per wall second and the pass's share of the run (host clock);
   experiment and experiment_summary: the paper's figures through the
   port's experiment layer (repro_torch.exp.run_experiment, configs built
   as benchmarks/common.py, fig3b_sensitivity.py and fig4_dca_burst.py
   build them): Fig. 3a's bandwidth search (trials of 0.004 s from 0.1
   Gbit/s, 4 bisection steps) for the bypass and kernel stacks at 1 and 4
   ports and the bypass stack at 4 lcores x 4 queues, Fig. 3b's six
   cumulative steps for both stacks, and Fig. 4's three DCA bursts (1, 32,
   1024); each once with engine="epoch" (the numpy pass) and once with
   engine="epoch-torch" on "cuda" (the kernel), the counters set to 0 just
   before the kernel run: the RunReports (extras and msb_gbps included)
   bit-equal, the kernel's launches equal to the numpy run's pass calls
   (above 0 in the searches that take the fast path), 0 plain calls; each
   search's msb_gbps, the bypass/kernel ratio at 1 and 4 ports, Fig. 3b's
   deltas from its base step, Fig. 4's p50/p99 and writebacks, and the wall
   seconds of each engine;
   flash_forward_digest: a sha256 over the forward's outputs and
   logsumexp at those cases and the train shape, f32 and bf16 (two trees
   with equal digests on one card compute bitwise-equal forwards);
   flash_bwd: dq, dk, dv of the flash kernels' autograd.Function against
   autograd through the plain ref.mha (f32: max abs <= 1e-4 (1 + max |ref|);
   bf16: relative RMS <= 2e-2), and of the backward kernel alone against
   ref.mha_bwd on the same out and lse (f32 the same bound; bf16 each
   gradient within a relative RMS of 1e-2), two calls bitwise equal, on
   causal, window, GQA group 2 and 16, q_offset > 0, rows with no visible
   key, Dh 80 and 96 (on the Dh 128 body), ragged Sq and Skv, and
   qwen3-1.7b's train shape; the forward's logsumexp against
   torch.logsumexp, and the rows of exp(s - lse) over the f32 scores the
   backward recomputes summing to 1 (the train shape's worst bf16 error on
   a line of its own);
   ssd_bwd: dx, ddt, dA, dB, dC and dh0 of the SSD scan's autograd.Function
   against autograd through the plain ref.ssd_scan (f32: max abs <= 1e-4
   (1 + max |ref|); bf16: relative RMS <= 2e-2), and of the backward kernels
   alone against ref.ssd_scan_bwd on the same inputs and the forward's saved
   workspace (f32 the same bound; bf16 within a relative RMS of 1e-2), two
   calls bitwise equal, on ragged S, a chunk of 1, h0 given and not, a
   cotangent on the final state and none, N 16 to 128, mamba2-1.3b's train
   shape, and adversarial magnitudes (A 4x as negative, dy scaled by 1e3 and
   by 1e-3; the kernels split the f32 operands of their tensor-core products
   into bf16 parts);
4. per arch — qwen3-1.7b, mamba2-1.3b, recurrentgemma-9b, granite-8b,
   phi4-mini-3.8b, llama3.2-3b, mixtral-8x7b (16 of 32 layers) and
   llama4-maverick-400b-a17b (2 of 48 layers: one dense and one MoE layer),
   each at full width with random weights from seed 0, its params freed
   before the next — serve: 8 requests in batches of 4, 32 generated tokens,
   greedy, through repro_torch.launch.serve, with every launch counter set
   to 0 just before and read just after: the counts must be exactly those of
   EXPECTED and the plain-version counter 0; the peak device memory since
   the params were made;
   trace: device busy and idle share of one prefill and of decode steps,
   and the decode kernels' and the SSD scan's share of them;
   serve_vs_plain: prefill and teacher-forced decode logits with the kernels
   against the same model on the plain versions (attention in blocks of
   query rows where its scores would not fit; in MoE layers the plain run
   takes the kernels' run's expert choices, as decode takes its tokens, and
   counts the tokens whose own choice differs), on the card, in bf16 and then,
   the served params freed, in f32 (recurrentgemma-9b's f32 copy keeps one
   pattern unit and the tail, mixtral-8x7b's 4 layers; llama4-maverick's
   does not fit, and its f32 check is the kernels' at its shapes);
5. train: TrainerRuntime on qwen3-1.7b at full width, bf16, random weights
   from seed 0, 8 steps of 4 x 2048 tokens, once fed by the bypass
   dataplane and once by the kernel-stack feed, on the same batches, each
   with the counters set to 0 just before (exactly 448 flash forwards and
   224 flash backwards, nothing else, 0 plain calls); the two runs' losses
   must be bitwise equal; checkpointing is off at this size; a profile of
   one more step (trace_train: the flash forward and backward kernels'
   device time, which must not read 0, the backward's also per kernel);
   the same for mamba2-1.3b, bypass feed only (exactly 768 ssd_scan and 384
   ssd_scan_bwd launches), profiled for the SSD forward's and backward's
   device time and idle share; trace_train scales each counted kernel's mean
   event time by its launches in the step (the wrapper counters), as
   device_ms does, since the profiler drops events;
   train_vs_plain, for each of the two archs: one step's loss and every
   gradient with the kernels against the plain versions, f32, full width,
   4 layers;
   restart: 6 steps against 4 steps and a resume to 6 in a fresh runtime
   (smoke config, f32, checkpoints under build/), steps 5 and 6 within 1e-4;
6. times: each kernel at the shapes of its main path (serve, train, the
   gather's benchmark; CUDA events; the gather, decode, the SSD scan and
   its backward also their device time from the profiler, decode, the SSD
   scan and its backward per kernel, decode with the L2 flushed before each
   call too, SDPA's the same way; the SSD scan and its backward also their
   FMA floor, their FLOP over the 67 TFLOP/s of f32 FMAs, and the backward
   its design's floor, its bf16 mma FLOP (split terms counted) over the
   989 TFLOP/s of the tensor cores plus the rest over the FMA rate), its plain
   version, a PyTorch call
   computing the same function where there is one (checked against the
   kernel), and the bound;
   before them, one line with the flash forward's achieved TFLOP/s at its
   three shapes beside the bound's, one with the backward's at the train
   shape, and one (decode_rate) with decode's achieved GB/s over the valid
   K and V bytes beside the HBM's 3.35 TB/s; gather_host: the host us per
   call of each stage of the gather's wrapper at the benchmark shape
   (time.perf_counter over 1000 calls), and the floors torch.empty and
   torch.empty + fill_(0) timed as the wrapper is (launch_floor_ms, also in
   the gather's row); gather_sweep: the
   gather at bursts of 32 to 1024 packets and the whole ring of 4096, each
   checked exactly, by wrapper time, device time warm and with the L2
   flushed, beside the byte bound and the achieved GB/s; the epoch pass at
   the bench shape's first epoch also by the device time of its three
   kernels, beside a launch-and-read-back floor (torch.empty + fill_ +
   tolist), the pass as the engine calls it (numpy in and out, the copies
   included) and the numpy pass, on the host clock.

The last three lines are the card's name and power limit, the kernel table
and {"ok": true, "device": ...}. Any failed check exits non-zero before them.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20       # H100 SXM L2
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
FLASH_BWD_F32_TOL, FLASH_BWD_BF16_REL_RMS = 1e-4, 2e-2
# bf16 backward kernel vs ref.mha_bwd on the same out and lse: the kernel
# rounds P and dS to bf16 as operands of its products, the plain version
# rounds only its outputs; a wrong product, mask or scale moves a gradient
# by order 100%.
FLASH_BWD_VS_PLAIN_BF16_REL_RMS = 1e-2
# bf16 flash forward vs ref.mha (f32 softmax of the bf16 inputs, the output
# rounded once): besides the elementwise 2e-2, which is large beside outputs
# of order sqrt(e / n_keys), the whole output within a relative RMS of 1e-2.
# The kernel rounds P and the output to bf16: these checks measure 1.8e-3
# to 2.4e-3 on an H100 (Dh 16-256, S 64-3072); a wrong P.V product or mask
# moves it by order 100%.
FLASH_FWD_BF16_REL_RMS = 1e-2
# bf16 decode vs ref.decode_attention: the same two bounds; the kernels
# round P to bf16 as the A operand of P.V, as the flash forward does, and a
# wrong mask, split or combine moves the output by order 100%.
DECODE_BF16_REL_RMS = 1e-2
SOURCES = ["flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
           "flash_attention_bwd", "burst_gather", "ssd_scan_bwd", "epoch_pass"]
DECODE_KERNELS = "decode_attn_"  # the name part of decode's partial pass and combine
SSD_KERNELS = "ssd_scan_"  # the name part of the SSD scan's four kernels
SSD_PHASES = ("state", "scores", "pass", "out")  # their names after it, in launch order
SSD_BWD_KERNELS = "ssd_bwd_"  # the name part of the SSD backward's eight kernels
# their names after it, in launch order; no name is a prefix of another
SSD_BWD_PHASES = ("dstate", "pass", "scores", "dbc_part", "dbc_sum", "dx", "dt", "da")
SSD_BWD_F32_TOL, SSD_BWD_BF16_REL_RMS = 1e-4, 2e-2
# bf16 SSD backward kernels vs ref.ssd_scan_bwd on the same inputs: both do
# all math in f32 and round only their outputs, so the gap is summation order
# and that rounding; through autograd the plain forward also rounds its dot
# inputs to bf16 where the kernels do not (SSD_PLAIN_BF16_REL_RMS bounds that
# gap on the forward at 1e-2), hence 2e-2 there. A wrong decay, mask, head sum
# or chunk edge moves a gradient by order 100%.
SSD_BWD_VS_PLAIN_BF16_REL_RMS = 1e-2
RGLRU_KERNELS = "rglru_scan_"  # the name part of the RG-LRU scan's three kernels
RGLRU_PHASES = ("chunk", "pass", "out")  # their names after it, in launch order
SERVE = dict(requests=8, batch=4, gen_len=32, seed=0)
# mixtral-8x7b's prompt passes its 4096-token window, so prefill rotates the
# ring cache and every decode step overwrites its oldest slot
PROMPT = {"qwen3-1.7b": 512, "mamba2-1.3b": 2048, "recurrentgemma-9b": 3072,
          "granite-8b": 512, "phi4-mini-3.8b": 512, "llama3.2-3b": 512,
          "mixtral-8x7b": 4608, "llama4-maverick-400b-a17b": 512}
# depth cuts of the archs whose weights do not fit the card (width is never
# cut): mixtral-8x7b's 32 layers are 93.4 GB in bf16, 16 are about 47 GB;
# llama4-maverick keeps one (dense, MoE) unit, about 37 GB (the 128 experts of
# one MoE layer are 32 GB)
DEPTH = {"mixtral-8x7b": 16, "llama4-maverick-400b-a17b": 2}
EXPECTED = {  # exact launches of one serve run; every other counter must read 0
    "qwen3-1.7b": {"flash_attention": 56, "decode_attention": 1792},
    "mamba2-1.3b": {"ssd_scan": 96},
    "recurrentgemma-9b": {"rglru_scan": 52, "flash_attention": 24, "decode_attention": 768},
    "granite-8b": {"flash_attention": 72, "decode_attention": 2304},
    "phi4-mini-3.8b": {"flash_attention": 64, "decode_attention": 2048},
    "llama3.2-3b": {"flash_attention": 56, "decode_attention": 1792},
    "mixtral-8x7b": {"flash_attention": 32, "decode_attention": 1024},
    "llama4-maverick-400b-a17b": {"flash_attention": 4, "decode_attention": 128},
}
# plain vs kernel serving in bf16: relative RMS of the logit difference. Both
# sides compute in f32 and round to bf16, but at other points, so bf16
# rounding flips feed every layer of random weights; the bound is about twice
# that noise as measured on the card (0.029 qwen3 over 28 layers; 0.040
# mamba2 over 48, whose plain SSD also rounds its dot inputs to bf16 where
# the kernel does not; 0.037 recurrentgemma over 38; 0.053 granite over 36,
# 0.044 phi4-mini over 32, 0.042 llama3.2 over 28; 0.051 mixtral over 16 and
# 0.011 llama4-maverick over 2, each with the plain run's expert choices
# forced to the kernels' run: left free, 5.6% of mixtral's routed tokens
# flip their top 2 and its relative RMS is 0.33), while a wrong mask, head,
# slot or decay moves the logits by order 100%. f32 is the tight check
# (summation order only).
SERVE_BF16_REL_RMS = {"qwen3-1.7b": 0.05, "mamba2-1.3b": 0.08, "recurrentgemma-9b": 0.08,
                      "granite-8b": 0.1, "phi4-mini-3.8b": 0.09, "llama3.2-3b": 0.08,
                      "mixtral-8x7b": 0.1, "llama4-maverick-400b-a17b": 0.02}
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


def _cuda_events(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, name_part, iters=50, flush=None):
    """Device time per call of the kernels whose names contain ``name_part``,
    from torch.profiler: what time_ms reads when the host cannot keep the
    card busy (a short kernel behind a Python wrapper). With ``flush``, each
    call first runs it (a write over more than the 50 MB L2, so that the
    call finds its inputs in device memory, as a decode step does); the
    flush's own kernels are not counted.

    A trace can hold fewer kernel events than were launched (on an H100, a
    trace of one call has held none, one of 50 calls 47 of 50), so the time
    is, for each kernel name, its mean event time times its launches per
    call, ceil(events / iters): the sum over events over ``iters`` when none
    is lost. A trace without one matching event is taken again, and a third
    fails. The flush's kernels are named from a trace of ``iters`` flushes:
    a trace of one can hold none, which counted the flush in."""

    def repeat(f):
        def run():
            for _ in range(iters):
                f()
        return run

    def call():
        if flush is not None:
            flush()
        fn()
    fn()
    # the flush's kernel names, from as many calls as are measured
    skip = {e.name for e in _cuda_events(repeat(flush))} if flush is not None else set()
    for _ in range(3):
        times = {}
        for e in _cuda_events(repeat(call)):
            if name_part in e.name and e.name not in skip:
                times.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if times:
            return sum(math.ceil(len(v) / iters) * sum(v) / len(v)
                       for v in times.values()) / 1e3
    fail(f"device_ms({name_part!r}): 3 traces of {iters} calls without a matching kernel event")


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
    from repro_torch.kernels import (burst_gather, decode_attention, epoch_pass,
                                     flash_attention, flash_attention_bwd, rglru_scan,
                                     ssd_scan, ssd_scan_bwd)
    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "ssd_scan": ssd_scan, "rglru_scan": rglru_scan,
            "flash_attention_bwd": flash_attention_bwd, "burst_gather": burst_gather,
            "ssd_scan_bwd": ssd_scan_bwd, "epoch_pass": epoch_pass}


def zero_counters():
    from repro_torch.kernels import ref
    for m in kernel_modules().values():
        m.launches = 0
    ref.calls = 0


def read_counters():
    from repro_torch.kernels import ref
    return {name: m.launches for name, m in kernel_modules().items()}, ref.calls


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
    (2, 130, 130, 4, 2, 80, True, 0, 0),      # Dh 80: the Dh 128 body, zero columns
    (1, 100, 161, 4, 2, 96, True, 0, 61),     # Dh 96, ragged Sq and Skv under q_offset
    (4, 512, 512, 16, 8, 128, True, 0, 0),    # qwen3-1.7b prefill, full width
    (4, 3072, 3072, 16, 1, 256, True, 2048, 0),  # recurrentgemma-9b prefill: window cuts keys
    (4, 512, 512, 32, 8, 128, True, 0, 0),    # granite-8b prefill: group 4
    (4, 512, 512, 24, 8, 128, True, 0, 0),    # phi4-mini-3.8b, llama3.2-3b prefill: group 3
    (4, 512, 512, 40, 8, 128, True, 0, 0),    # llama4-maverick prefill: group 5
    (4, 4608, 4608, 32, 8, 128, True, 4096, 0),  # mixtral-8x7b prefill: window 4096 < S
]
DIGEST_CASES = 15  # forward_digest's cases: those it covered when first recorded
FLASH_SERVE = {"qwen3-1.7b": FLASH_CASES[13], "recurrentgemma-9b": FLASH_CASES[14],
               "granite-8b": FLASH_CASES[15], "phi4-mini-3.8b": FLASH_CASES[16],
               "llama3.2-3b": FLASH_CASES[16], "llama4-maverick-400b-a17b": FLASH_CASES[17],
               "mixtral-8x7b": FLASH_CASES[18]}
DECODE_CASES = [
    # B, C, H, Hkv, Dh, cache_len
    (4, 300, 4, 2, 64, (0, 1, 300, 157)),
    (3, 128, 6, 3, 16, (128, 0, 77)),
    (2, 200, 8, 1, 256, (200, 17)),
    (2, 200, 8, 2, 128, (1, 200)),
    (2, 300, 12, 1, 64, (300, 5)),            # group 12: 12 of the mma tile's 16 rows
    (5, 300, 2, 2, 64, (0, 1, 63, 65, 300)),  # group 1; a key either side of a tile edge
    (2, 1000, 16, 2, 128, (1000, 999)),       # group 8 over 16 splits
    (3, 256, 6, 1, 24, (256, 63, 0)),         # Dh 24: the mma body, half a k-step zero
    (2, 200, 16, 1, 20, (200, 65)),           # Dh 20: the FMA body in bf16 too
    (4, 544, 16, 8, 128, (1, 200, 544, 377)),  # qwen3-1.7b decode, full width
    (4, 2048, 16, 1, 256, (2048, 2048, 1000, 0)),  # recurrentgemma-9b: group 16, full ring
    (4, 544, 32, 8, 128, (1, 200, 544, 377)),  # granite-8b: group 4
    (4, 544, 24, 8, 128, (1, 200, 544, 377)),  # phi4-mini-3.8b, llama3.2-3b: group 3
    (4, 544, 40, 8, 128, (1, 200, 544, 377)),  # llama4-maverick: group 5
    (4, 4096, 32, 8, 128, (4096, 4096, 4096, 4096)),  # mixtral-8x7b: group 4, full ring
]
DECODE_SERVE = {"qwen3-1.7b": DECODE_CASES[9], "recurrentgemma-9b": DECODE_CASES[10],
                "granite-8b": DECODE_CASES[11], "phi4-mini-3.8b": DECODE_CASES[12],
                "llama3.2-3b": DECODE_CASES[12], "llama4-maverick-400b-a17b": DECODE_CASES[13],
                "mixtral-8x7b": DECODE_CASES[14]}
SSD_CASES = [
    # B, S, H, P, N, chunk, h0
    (4, 2048, 64, 64, 128, 256, False),       # mamba2-1.3b prefill, full width
    (2, 300, 8, 64, 128, 256, True),          # ragged S (one full and one partial chunk), h0
    (2, 37, 3, 8, 16, 8, True),               # smoke-sized heads, ragged S, h0
    (1, 100, 4, 16, 32, 32, False),
    (2, 48, 2, 64, 128, 64, False),           # S shorter than a 256 chunk would be
    (1, 1024, 4, 64, 128, 128, True),         # the state pass carries h0 across 8 chunks
    (2, 40, 3, 16, 32, 1, True),              # chunk 1: every step its own chunk
]
RGLRU_CASES = [
    # B, S, W, h0
    (4, 3072, 4096, False),                   # recurrentgemma-9b prefill, full width
    (3, 1001, 1000, True),                    # ragged S and W, h0
    (2, 7, 33, True),                         # one chunk
    (1, 256, 512, False),
    (2, 1, 33, True),                         # S 1
    (2, 65, 33, True),                        # chunks of 64: the last of one step
    (2, 197, 33, True),                       # 3 chunks of 64 and one of 5
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


PLAIN_SCORES = 1 << 29  # f32 scores per plain attention call: 2 GiB


def plain_mha(q, k, v, **kw):
    """ref.mha, in blocks of query rows (each under its own q_offset) so that
    no call holds more than PLAIN_SCORES f32 scores: the same function, in
    memory beside mixtral-8x7b's weights (its whole prefill's scores are
    10.9 GB, and the softmax copies them)."""
    from repro_torch.kernels import ref
    B, Sq, H, _ = q.shape
    rows = max(1, PLAIN_SCORES // (B * H * k.shape[1]))
    if rows >= Sq:
        return ref.mha(q, k, v, **kw)
    q_offset = kw.pop("q_offset", 0)
    return torch.cat([ref.mha(q[:, i:i + rows], k, v, q_offset=q_offset + i, **kw)
                      for i in range(0, Sq, rows)], dim=1)


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
            want = plain_mha(q, k, v, causal=causal, window=window, q_offset=q_offset)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, tol)
            out = {"max_abs_err": err, "tol": tol}
            if dtype == torch.bfloat16:  # the elementwise bound is loose at small outputs
                out["rel_rms"] = rel_rms(got, want)
                out["bound_rel_rms"] = FLASH_FWD_BF16_REL_RMS
                ok = ok and out["rel_rms"] <= FLASH_FWD_BF16_REL_RMS
            _check("flash_attention", case, dtype, out, ok, "")
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
            out = {"max_abs_err": err, "tol": tol,
                   "empty_rows_zero": int(torch.count_nonzero(got[empty])) == 0}
            if dtype == torch.bfloat16:
                out["rel_rms"] = rel_rms(got, want)
                out["bound_rel_rms"] = DECODE_BF16_REL_RMS
                ok = ok and out["rel_rms"] <= DECODE_BF16_REL_RMS
            _check("decode_attention", case, dtype, out, ok and out["empty_rows_zero"], "")
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


def forward_digest(dev):
    """sha256 over the bytes of the flash forward's output and logsumexp, f32
    and bf16, at the first DIGEST_CASES of FLASH_CASES and the train shape:
    two trees whose digests agree on one card compute bitwise-equal
    forwards."""
    import hashlib
    from repro_torch.kernels import flash_attention as kflash
    h = hashlib.sha256()
    cases = FLASH_CASES[:DIGEST_CASES] + [FLASH_TRAIN]
    for case in cases:
        causal, window, q_offset = case[6:]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(case, dtype, dev)
            for t in kflash._forward(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                     softmax_scale=case[5] ** -0.5, with_lse=True):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            del q, k, v
    return {"cases": len(cases), "dtypes": ["float32", "bfloat16"], "sha256": h.hexdigest()}


# --------------------------------------------------------------------------
# burst gather
# --------------------------------------------------------------------------

GATHER_CASES = {
    # name: (n_slots, slot_size, slots or a count of random distinct slots,
    #        lengths or None for random ones, out_width[, rows of the buffer
    #        before the arena, a contiguous view that starts there])
    "16x256_w256": (64, 256, 16, None, 256),          # tests/test_kernels.py:132
    "8x128_w300": (64, 128, 8, None, 300),
    "32x64_w32": (64, 64, 32, None, 32),
    "slots_past_the_arena": (4, 16, [5, -1, 3, 1 << 30], [16, 16, 16, 16], 16),
    "negative_slots": (4, 16, [-1, -4, -5, -10, -(1 << 31)], [16, 8, 16, 16, 16], 16),
    "negative_and_zero_lengths": (4, 16, [0, 1, 2], [-3, 0, -(1 << 31)], 16),
    "lengths_past_the_width": (4, 16, [0, 1, 2], [17, 100, (1 << 31) - 1], 12),
    "width_past_the_slot_size": (8, 16, [7, 0, 3], [16, 20, 9], 40),
    "no_packets": (4, 16, [], [], 16),
    # chunks of 16 output bytes that straddle rows and partial last chunks
    "w1": (64, 8, 37, None, 1),                       # 16 rows a chunk, tail of 5
    "w15": (64, 9, 33, None, 15),                     # a width past the slot size
    "w17": (64, 40, 33, None, 17),                    # tail of 1
    "w1518_tail": (4096, 1518, 255, None, 1518),      # 255 * 1518 % 16 = 2
    "view_unaligned": (300, 1518, 64, None, 1518, 1),  # arena = buffer[1:], 14 mod 16
    "view_odd": (300, 33, 64, None, 40, 3),           # arena = buffer[3:], 3 mod 4
    "whole_ring": (4096, 1518, 4096, None, 1518),     # every slot in one call
    "bench": (4096, 1518, 256, None, 1518),           # benchmarks/kernels_bench.py:77
}
GATHER_BURSTS = 16  # bursts at the benchmark shape on the counted main-path run


def gather_inputs(case, dev, seed=0):
    """arena, slots, lengths (int32), out_width; random lengths are 64-1517 at
    the Ethernet frame size (as kernels_bench.py draws them), else 1 up to the
    slot size."""
    n_slots, slot_size, slots, lengths, width = case[:5]
    skip = case[5] if len(case) > 5 else 0
    gen = torch.Generator().manual_seed(seed)
    arena = torch.randint(0, 256, (skip + n_slots, slot_size), generator=gen,
                          dtype=torch.uint8).to(dev)[skip:]
    if isinstance(slots, int):
        slots = torch.randperm(n_slots, generator=gen)[:slots]
        lengths = torch.randint(64 if slot_size == 1518 else 1, slot_size, (len(slots),),
                                generator=gen)
    as_i32 = dict(dtype=torch.int32, device=dev)
    return arena, torch.as_tensor(slots, **as_i32), torch.as_tensor(lengths, **as_i32), width


def byte_err(got, want):
    """Largest absolute difference of two uint8 tensors of one shape."""
    return int((got.int() - want.int()).abs().max()) if got.numel() else 0


def run_gather(dev):
    """The gather kernel equal to its plain version on every case, then the
    counted main-path run. Returns that run's launch count and the largest
    absolute byte difference at the bench case and on the counted bursts."""
    from repro_torch.kernels import ops, ref
    worst = 0
    for name, case in GATHER_CASES.items():
        args = gather_inputs(case, dev)
        got, want = ops.burst_gather(*args), ref.burst_gather(*args)
        torch.cuda.synchronize()
        same_shape = got.shape == want.shape and got.dtype == torch.uint8
        err = byte_err(got, want) if same_shape else None
        _check("burst_gather", name, torch.uint8,
               {"shape": list(got.shape), "max_abs_err": err}, err == 0, "")
        if name == "bench":
            worst = err
    bursts = [gather_inputs(GATHER_CASES["bench"], dev, seed=10 + i)
              for i in range(GATHER_BURSTS)]
    torch.cuda.synchronize()
    zero_counters()
    outs = [ops.burst_gather(*b) for b in bursts]
    torch.cuda.synchronize()
    launches, plain_calls = read_counters()
    expected = {name: GATHER_BURSTS if name == "burst_gather" else 0 for name in launches}
    err = max(byte_err(o, ref.burst_gather(*b)) for o, b in zip(outs, bursts))
    worst = max(worst, err)
    emit("gather", {"bursts": GATHER_BURSTS, "shape": GATHER_CASES["bench"][:2],
                    "packets": GATHER_CASES["bench"][2], "launches": launches,
                    "expected_launches": expected, "plain_calls": plain_calls,
                    "max_abs_err": err})
    if launches != expected or plain_calls or err:
        fail(f"burst_gather main path: launches {launches}, plain calls {plain_calls}, "
             f"max abs byte error {err}")
    return launches, worst


# --------------------------------------------------------------------------
# the simulator: the epoch pass against its plain version, then the engine
# --------------------------------------------------------------------------

# frames of the exact checks: tile edges (2048 a tile), the engine's epoch at
# the bench shape, and 2^24 in one call (an epoch of a long run)
EPOCH_N = (1, 1023, 1024, 1025, 2047, 2048, 2049, 63342, 1 << 24)
EPOCH_FLOWS, EPOCH_QUEUES = 256, 8
# the edge cases of tests/test_torch_epoch_pass.py: handed, ser, busy0, latency
EPOCH_EDGES = {
    "empty": ([], [], 5, 7),
    "single": ([100], [10], 0, 3),
    "equal-time-burst": ([1000] * 40, [121] * 40, 0, 1000),
    "busy0-past-all": (list(range(0, 500, 10)), [4] * 50, 10_000, 1000),
    "ideal-wire": ([0, 0, 5, 5, 9], [0] * 5, 0, 0),
    "queueing": ([0, 5, 5, 40], [10] * 4, 3, 7),
}
# benchmarks/fastpath_bench.py's shape (one 100 GbE port, 8 RSS queues on 8
# lcores, ring 1024, writeback threshold 32, burst 64, a pool of 16384
# slots, 1518-byte frames) and its two-port version: name -> (ports,
# Gbit/s offered over all ports, simulated s)
SIM_SHAPES = {"1x100GbE": (1, 100.0, 0.1), "2x100GbE": (2, 200.0, 0.05)}
SIM_EVENT_S = 0.004  # the event loop's run of the first shape, against both engines
SIM_REPEATS = 3      # timed runs of each engine a shape, in turns
SIM_LABEL = "simulate 1x100GbE"


def epoch_inputs(n, dev, seed=0):
    """handed (bursts of equal times among gaps of up to 250 ns), ser (5-249
    ns), a queue table of 256 flows over 8 queues and flow ids, int64, and
    busy0 (the wire busy until the middle frame's time)."""
    gen = torch.Generator().manual_seed(seed)
    gaps = torch.randint(0, 250, (n,), generator=gen) * torch.randint(0, 2, (n,), generator=gen)
    handed = torch.cumsum(gaps, 0)
    ser = torch.randint(5, 250, (n,), generator=gen)
    table = torch.randint(0, EPOCH_QUEUES, (EPOCH_FLOWS,), generator=gen)
    fids = torch.randint(0, EPOCH_FLOWS, (n,), generator=gen)
    busy0 = int(handed[n // 2]) if n else 0
    return [t.to(dev) for t in (handed, ser, table, fids)], busy0


def epoch_equal(got, want):
    """Two passes' outputs (tensors anywhere, or numpy) bit-equal."""
    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(x)

    (a, busy, q), (wa, wbusy, wq) = got, want
    same_q = (q is None and wq is None) or (
        q is not None and wq is not None and torch.equal(host(q), host(wq)))
    return bool(torch.equal(host(a), host(wa)) and busy == wbusy and same_q)


def run_epoch_checks(dev):
    """The epoch pass kernel exactly equal to its plain version on the card
    and to the numpy pass (the engine's reference), with a table and
    without, on EPOCH_N and the edge cases; a flow id out of range raises
    IndexError. Returns the largest absolute arrival difference at the
    bench epoch (0 when equal)."""
    from repro_torch.kernels import epoch_pass as kep
    from repro_torch.kernels import ops, ref
    worst = None
    for n in EPOCH_N:
        (h, s, table, fids), busy0 = epoch_inputs(n, dev, seed=n)
        for steer in (True, False):
            t, f = (table, fids) if steer else (None, None)
            got = ops.epoch_pass(h, s, busy0, 1000, t, f)
            want = ref.epoch_pass(h, s, busy0, 1000, t, f)
            torch.cuda.synchronize()
            ok = epoch_equal(got, want)
            err = int((got[0] - want[0]).abs().max())
            if n <= 63342:
                host = kep.epoch_pass_np(h.cpu().numpy(), s.cpu().numpy(), busy0, 1000,
                                         None if t is None else t.cpu().numpy(),
                                         None if f is None else f.cpu().numpy())
                ok = ok and epoch_equal(got, host)
            _check("epoch_pass", {"n": n, "steer": steer}, torch.int64,
                   {"max_abs_err": err, "busy_until": got[1]}, ok, "")
            if n == 63342 and steer:
                worst = err
    tab = torch.arange(EPOCH_FLOWS, device=dev) % EPOCH_QUEUES
    for name, (h, s, busy0, lat) in EPOCH_EDGES.items():
        h, s = (torch.tensor(x, dtype=torch.int64, device=dev) for x in (h, s))
        ids = (torch.arange(h.numel(), device=dev) * 37) % EPOCH_FLOWS - 3  # -3: from the end
        ok = True
        for t, f in ((tab, ids), (None, None), (tab, None)):
            got = ops.epoch_pass(h, s, busy0, lat, t, f)
            host = kep.epoch_pass_np(h.cpu().numpy(), s.cpu().numpy(), busy0, lat,
                                     None if t is None else t.cpu().numpy(),
                                     None if f is None else f.cpu().numpy())
            ok = ok and epoch_equal(got, ref.epoch_pass(h, s, busy0, lat, t, f)) \
                and epoch_equal(got, host)
        _check("epoch_pass", name, torch.int64, {"busy_until": got[1]}, ok, "")
    h, s = torch.arange(8, device=dev), torch.ones(8, dtype=torch.int64, device=dev)
    for bad in (EPOCH_FLOWS, -EPOCH_FLOWS - 1):
        ids = torch.zeros(8, dtype=torch.int64, device=dev)
        ids[5] = bad
        try:
            ops.epoch_pass(h, s, 0, 0, tab, ids)
            raised = False
        except IndexError:
            raised = True
        _check("epoch_pass", f"flow id {bad} of {EPOCH_FLOWS}", torch.int64,
               {"raised_index_error": raised}, raised, "")
    return worst


def sim_build(nports):
    """The bench shape on the port's classes, one pool for all ports."""
    from repro_torch.core import packet, pmd, simclock
    pool = packet.PacketPool(16384, 1518)
    ports = [pmd.Port.make(pool, ring_size=1024, writeback_threshold=32, n_queues=8,
                           link_gbps=100.0, link_latency_ns=1000) for _ in range(nports)]
    server = pmd.BypassL2FwdServer(ports, burst_size=64, n_lcores=8 * nports)
    clock = simclock.SimClock()
    server.attach_clock(clock)
    return server, ports, clock


@contextlib.contextmanager
def timed_pass():
    """Within the block, the engine's epoch pass (numpy or torch) is timed
    on the host clock and its calls counted; yields a list of the seconds
    summed and the calls."""
    from repro_torch.core import fastpath
    spent = [0.0, 0]
    make, numpy_pass = fastpath.make_pass, fastpath.epoch_pass_np

    def timed(fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out
        return call

    fastpath.make_pass = lambda device: timed(make(device))
    fastpath.epoch_pass_np = timed(numpy_pass)
    try:
        yield spent
    finally:
        fastpath.make_pass, fastpath.epoch_pass_np = make, numpy_pass


def sim_run(nports, rate, duration_s, device, engine="epoch"):
    """One open-loop run of the shape through the event loop or the epoch
    engine (device None: the numpy pass; "cuda": the kernel). Returns what
    must be bit-equal across engines (the RunReport, the per-queue stats of
    tests/test_fastpath.py's queue_stats_key, the final clock), the run's
    info, its wall seconds and the pass's seconds."""
    from repro_torch.core import fastpath, loadgen
    server, ports, clock = sim_build(nports)
    lg = loadgen.LoadGen(ports)
    pattern = loadgen.TrafficPattern(rate_gbps=rate, packet_size=1518)
    info = fastpath.EpochRunInfo()
    with timed_pass() as spent:
        t0 = time.perf_counter()
        if engine == "event":
            rep = lg.run_sim(server, pattern, duration_s=duration_s, clock=clock)
        else:
            rep = fastpath.run_epoch_sim(lg, server, pattern, duration_s=duration_s,
                                         clock=clock, device=device, info=info)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    queues = {str(k): (v.rx_packets, v.tx_packets, v.rx_bytes, v.burst_count,
                       v.burst_packets, list(v.burst_buckets))
              for k, v in server.per_queue_stats().items()}
    return (rep.to_dict(), queues, clock.now_ns), info, wall, spent[0]


def run_simulate(dev, card):
    """The port's simulator on the card. First the event loop on the first
    shape at SIM_EVENT_S against both engines at that length; then each
    shape through the numpy pass and the kernel, SIM_REPEATS times each in
    turns, every count set to 0 just before each kernel run and read just
    after (launches == info.n_epochs, no plain call, no other kernel), all
    observations bit-equal and on the fast path. Returns the counted
    launches of the kernel runs, by label."""
    nports, rate, _ = SIM_SHAPES["1x100GbE"]
    event = sim_run(nports, rate, SIM_EVENT_S, None, engine="event")
    short = {str(d): sim_run(nports, rate, SIM_EVENT_S, d) for d in (None, "cuda")}
    same = {d: r[0] == event[0] for d, r in short.items()}
    emit("simulate_vs_event", {"shape": "1x100GbE", "duration_s": SIM_EVENT_S,
                               "packets": event[0][0]["sent"], "equal": same,
                               "fastpath": {d: r[1].fastpath for d, r in short.items()},
                               "event_wall_s": event[2], "card": card})
    if not all(same.values()) or not all(r[1].fastpath for r in short.values()):
        fail(f"simulate: the event loop and the epoch engines disagree at {SIM_EVENT_S} s")
    launches = {}
    for name, (nports, rate, dur) in SIM_SHAPES.items():
        runs = {"None": [], "cuda": []}
        for k in range(SIM_REPEATS):
            for device in ((None, "cuda") if k % 2 == 0 else ("cuda", None)):
                zero_counters()
                obs, info, wall, pass_s = sim_run(nports, rate, dur, device)
                counts, plain = read_counters()
                runs[str(device)].append((obs, info, wall, pass_s, counts, plain))
        want = runs["None"][0][0]
        out = {"shape": name, "ports": nports, "offered_gbps": rate, "duration_s": dur,
               "packets": want[0]["sent"], "card": card}
        ok = True
        for device, rs in runs.items():
            walls = sorted(r[2] for r in rs)
            info = rs[0][1]
            expect = {k: (info.n_epochs if device == "cuda" and k == "epoch_pass" else 0)
                      for k in rs[0][4]}
            eng = {"engine": info.engine, "pass_device": info.pass_device,
                   "fastpath": info.fastpath, "n_epochs": info.n_epochs,
                   "wall_s": [r[2] for r in rs], "wall_s_median": walls[len(walls) // 2],
                   "sim_pkts_per_s": want[0]["sent"] / walls[len(walls) // 2],
                   "pass_s": [r[3] for r in rs],
                   "pass_share": [r[3] / r[2] for r in rs],
                   "launches": rs[0][4], "expected_launches": expect,
                   "plain_calls": [r[5] for r in rs],
                   "equal_to_numpy": all(r[0] == want for r in rs)}
            ok = ok and eng["fastpath"] and eng["equal_to_numpy"] and all(
                r[4] == expect and r[5] == 0 and r[1].fastpath for r in rs)
            out[device] = eng
        emit("simulate", out)
        if not ok:
            fail(f"simulate {name}: engines disagree, left the fast path or miscounted "
                 f"(launches must equal n_epochs, plain calls 0): {out}")
        launches[f"simulate {name}"] = runs["cuda"][0][4]
    return launches


# --------------------------------------------------------------------------
# the experiment layer: the paper's figures through repro_torch.exp
# --------------------------------------------------------------------------

# benchmarks/common.py's msb search: trial length, first rate, bisection steps
EXP_MSB = dict(trial_s=0.004, start_gbps=0.1, refine_iters=4)
# Fig. 3a's port axis, and one point of its cores x queues axis
FIG3A = {"1port": dict(nports=1), "4port": dict(nports=4),
         "4core_4q": dict(n_queues=4, n_lcores=4)}
# Fig. 3b's cumulative steps (benchmarks/fig3b_sensitivity.py): name ->
# (CostConfig changes from 2 GHz, ring, burst, sockbuf budget)
FIG3B = {"base_2ghz": ({}, 1024, 64, 16),
         "3ghz_cpu": ({"cpu_ghz": 3.0}, 1024, 64, 16),
         "low_lat_pcie": ({"cpu_ghz": 3.0, "interrupt_cycles": 4000}, 1024, 64, 16),
         "2x_sockbuf": ({"cpu_ghz": 3.0, "interrupt_cycles": 4000}, 1024, 64, 32),
         "2x_ring": ({"cpu_ghz": 3.0, "interrupt_cycles": 4000}, 2048, 64, 32),
         "2x_burst": ({"cpu_ghz": 3.0, "interrupt_cycles": 4000}, 2048, 128, 32)}
FIG4_BURSTS = (1, 32, 1024)  # benchmarks/fig4_dca_burst.py, 0.004 s of 10 Gbit/s
EXP_LABEL = "experiment"


def experiment_on_fast_path(label):
    """The searches whose trials take the epoch fast path, so that the pass
    runs: the bypass stack's, but for Fig. 3b's 2x_burst step, whose burst
    of 128 exceeds the load generator's TX burst of 64. The kernel stack and
    Fig. 4's DCA timers run the event loop under every engine."""
    return label.startswith(("fig3a bypass", "fig3b bypass")) and not label.endswith("2x_burst")


def experiment_config(stack, nports=1, ring=1024, burst=64, cost=None, sockbuf_budget=16,
                      n_queues=1, n_lcores=None, traffic=None, name="bench"):
    """benchmarks/common.py's experiment_config on the port's classes."""
    from repro_torch.exp import (ExperimentConfig, PoolConfig, PortConfig, StackConfig,
                                 TrafficConfig)
    return ExperimentConfig(
        name=name, pool=PoolConfig(n_slots=16384, slot_size=1518),
        ports=tuple(PortConfig(n_queues=n_queues, ring_size=ring, writeback_threshold=32)
                    for _ in range(nports)),
        stack=StackConfig(kind=stack, burst_size=burst, n_lcores=n_lcores,
                          sockbuf_budget=sockbuf_budget, cost=cost),
        traffic=traffic if traffic is not None else TrafficConfig())


def experiment_configs():
    """label -> the port's ExperimentConfig, for Fig. 3a, 3b and 4."""
    from repro_torch.exp import (CostConfig, DcaConfig, ExperimentConfig, PortConfig,
                                 StackConfig, TrafficConfig)
    msb = TrafficConfig(mode="msb", **EXP_MSB)
    out = {}
    for point, kw in FIG3A.items():
        for stack in ("bypass", "kernel") if point != "4core_4q" else ("bypass",):
            out[f"fig3a {stack} {point}"] = experiment_config(stack, traffic=msb, **kw)
    for step, (cost, ring, burst, sockbuf) in FIG3B.items():
        out[f"fig3b bypass {step}"] = experiment_config("bypass", ring=ring, burst=burst,
                                                        traffic=msb)
        out[f"fig3b kernel {step}"] = experiment_config(
            "kernel", ring=ring, burst=burst, cost=CostConfig(**{"cpu_ghz": 2.0, **cost}),
            sockbuf_budget=sockbuf, traffic=msb)
    for burst in FIG4_BURSTS:
        out[f"fig4 burst {burst}"] = ExperimentConfig(
            name=f"fig4-burst-{burst}", ports=(PortConfig(n_queues=1, ring_size=2048),),
            stack=StackConfig(kind="bypass", n_lcores=1),
            traffic=TrafficConfig(mode="open_loop", rate_gbps=10.0, packet_size=1518,
                                  duration_s=0.004, seed=3),
            dca=DcaConfig(burst_size=burst, writeback_threshold=32,
                          writeback_timeout_ns=200_000))
    return out


def experiment_run(cfg, engine):
    """run_experiment under ``engine`` ("epoch": the numpy pass;
    "epoch-torch": the kernel on "cuda"): the report as a dict, the wall
    seconds, and the pass's seconds and calls."""
    from repro_torch.exp import run_experiment
    cfg = cfg.with_traffic(engine=engine)
    with timed_pass() as spent:
        t0 = time.perf_counter()
        rep = run_experiment(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return rep.to_dict(), wall, spent[0], spent[1]


def run_experiments(card):
    """Each figure config through run_experiment once with the numpy pass
    and once with the kernel, every count set to 0 just before the kernel
    run and read just after: the reports (extras and msb_gbps included)
    bit-equal, the kernel's launches equal to the numpy run's pass calls
    (above 0 exactly where experiment_on_fast_path says), no plain call, no
    other kernel. Returns the kernel runs' launches summed, by kernel."""
    total = {}
    reports, walls = {}, {"epoch": 0.0, "epoch-torch": 0.0}
    bad = []
    for label, cfg in experiment_configs().items():
        want, np_wall, np_pass_s, np_calls = experiment_run(cfg, "epoch")
        zero_counters()
        got, cu_wall, cu_pass_s, cu_calls = experiment_run(cfg, "epoch-torch")
        counts, plain = read_counters()
        expect = {k: (np_calls if k == "epoch_pass" else 0) for k in counts}
        ok = (got == want and counts == expect and plain == 0 and cu_calls == np_calls
              and (np_calls > 0) == experiment_on_fast_path(label))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        walls["epoch"] += np_wall
        walls["epoch-torch"] += cu_wall
        reports[label] = want
        emit("experiment", {"name": label, "msb_gbps": want["extras"].get("msb_gbps"),
                            "received": want["received"], "dropped": want["dropped"],
                            "equal": got == want, "numpy_pass_calls": np_calls,
                            "launches": counts, "plain_calls": plain,
                            "wall_s": {"epoch": np_wall, "epoch-torch": cu_wall},
                            "pass_s": {"epoch": np_pass_s, "epoch-torch": cu_pass_s},
                            "ok": ok, "card": card})
        if not ok:
            bad.append(label)
    msb = {k: r["extras"]["msb_gbps"] for k, r in reports.items() if "msb_gbps" in r["extras"]}
    summary = {
        "fig3a_msb_gbps": {k[6:]: v for k, v in msb.items() if k.startswith("fig3a")},
        "fig3a_bypass_over_kernel": {
            p: msb[f"fig3a bypass {p}"] / msb[f"fig3a kernel {p}"] for p in ("1port", "4port")},
        "fig3b_msb_gbps": {k[6:]: v for k, v in msb.items() if k.startswith("fig3b")},
        "fig3b_delta_vs_base_pct": {
            f"{stack} {step}": 100.0 * (msb[f"fig3b {stack} {step}"]
                                        / msb[f"fig3b {stack} base_2ghz"] - 1)
            for stack in ("bypass", "kernel") for step in FIG3B},
        "fig4": {b: {"p50_us": reports[f"fig4 burst {b}"]["latency"]["median_ns"] / 1e3,
                     "p99_us": reports[f"fig4 burst {b}"]["latency"]["p99_ns"] / 1e3,
                     "writebacks": reports[f"fig4 burst {b}"]["extras"]["p0q0_writebacks"],
                     "received": reports[f"fig4 burst {b}"]["received"],
                     "sent": reports[f"fig4 burst {b}"]["sent"]} for b in FIG4_BURSTS},
        "wall_s": walls, "torch_over_numpy_wall": walls["epoch-torch"] / walls["epoch"],
        "launches": total, "card": card}
    emit("experiment_summary", summary)
    if bad:
        fail(f"experiment: the numpy and card runs disagree or miscounted on {bad}")
    return {EXP_LABEL: total}


def bench_epoch(dev):
    """The first epoch slice of the bench shape's 0.1 s run as the engine
    plans it (about 63 000 frames over 8 queues): numpy inputs, and the same
    on the card, with the port's queue table."""
    import numpy as np
    from repro_torch.core import fastpath, loadgen
    from repro_torch.kernels import epoch_pass as kep
    _, ports, _ = sim_build(1)
    pattern = loadgen.TrafficPattern(rate_gbps=100.0, packet_size=1518)
    times, sizes = pattern.emission_schedule(int(SIM_SHAPES["1x100GbE"][2] * 1e9),
                                             np.random.default_rng(pattern.seed))
    lo, hi = next(fastpath.iter_epoch_slices(times, fastpath.default_epoch_ns(ports, times)))
    table = fastpath._flow_queue_table(ports[0], 256, None, None)
    host = (times[lo:hi], kep.serialization_ns_vec(sizes[lo:hi], 100.0), 0, 1000, table,
            np.arange(lo, hi, dtype=np.int64) % 256)
    on_dev = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
              (host[0], host[1], table, host[5])]
    return host, on_dev


# --------------------------------------------------------------------------
# flash backward against autograd through the plain version
# --------------------------------------------------------------------------

FLASH_BWD_CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset
    (1, 128, 128, 2, 2, 64, True, 0, 0),      # causal, MHA
    (1, 200, 200, 4, 2, 64, True, 64, 0),     # window, GQA group 2, ragged tiles
    (1, 384, 384, 2, 1, 16, True, 128, 0),    # a window over several tiles
    (2, 96, 160, 16, 1, 32, True, 0, 64),     # GQA group 16, q_offset > 0
    (1, 64, 64, 2, 1, 32, True, 0, -16),      # rows with no visible key
    (1, 100, 100, 4, 2, 128, False, 0, 0),    # not causal, Dh 128
    (2, 130, 130, 4, 2, 80, True, 0, 0),      # Dh 80: the Dh 128 body, zero columns
    (1, 100, 161, 4, 2, 96, True, 0, 61),     # Dh 96, ragged Sq and Skv under q_offset
    (4, 2048, 2048, 16, 8, 128, True, 0, 0),  # qwen3-1.7b train, full width
]
FLASH_TRAIN = FLASH_BWD_CASES[-1]


def flash_grads(fn, q, k, v, dout):
    """(output, (dq, dk, dv)) of ``fn`` by autograd, on fresh leaves."""
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(qs, ks, vs)
    return out.detach(), torch.autograd.grad(out, (qs, ks, vs), dout)


def plain_scores(q, k, *, causal, window, q_offset, scale):
    """(B,H,Sq,Skv) scaled f32 scores, -inf where masked."""
    from repro_torch.kernels import ref
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, H // Hkv, Dh).float(),
                     k.float()) * scale
    mask = ref.attention_mask(Sq, k.shape[1], causal=causal, window=window,
                              q_offset=q_offset, device=q.device)
    return s.masked_fill(~mask, float("-inf")).reshape(B, H, Sq, k.shape[1])


def run_flash_bwd_checks(dev):
    """Returns the bf16 max abs errors at the train shape: of the forward
    output and of the gradients (largest of dq, dk, dv)."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import ops, ref
    worst = {}
    for case in FLASH_BWD_CASES:
        causal, window, q_offset = case[6:]
        mask = dict(causal=causal, window=window, q_offset=q_offset)
        scale = case[5] ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(case, dtype, dev, seed=7)
            dout = randn(torch.Generator().manual_seed(8), q.shape, dtype, dev)
            out, g = flash_grads(lambda a, b, c: ops.flash_attention(a, b, c, **mask),
                                 q, k, v, dout)
            out_p, gp = flash_grads(lambda a, b, c: ref.mha(a, b, c, **mask), q, k, v, dout)
            _, lse = kflash._forward(q, k, v, softmax_scale=scale, with_lse=True, **mask)
            s = plain_scores(q, k, scale=scale, **mask)
            lse_p = torch.logsumexp(s, -1)  # -inf on rows with no visible key
            # what the backward recomputes: the softmax of f32 scores against
            # the forward's lse, whose rows must sum to 1
            row_sums = torch.exp(s - lse[..., None]).sum(-1)
            del s
            torch.cuda.synchronize()
            res, ok = {}, True
            for name, a, b in zip(("dq", "dk", "dv"), g, gp):
                err = float((a.float() - b.float()).abs().max())
                if dtype == torch.float32:
                    bound = FLASH_BWD_F32_TOL * (1 + float(b.float().abs().max()))
                    ok_i = err <= bound
                    res[name] = {"max_abs": err, "bound_max_abs": bound}
                else:
                    rr = rel_rms(a, b)
                    ok_i = rr <= FLASH_BWD_BF16_REL_RMS
                    res[name] = {"rel_rms": rr, "bound_rel_rms": FLASH_BWD_BF16_REL_RMS,
                                 "max_abs": err}
                ok = ok and ok_i and bool(torch.isfinite(a).all())
            # the kernel alone, twice, against ref.mha_bwd on the same out and lse
            gk = kbwd.flash_attention_bwd_cuda(q, k, v, out, lse, dout, softmax_scale=scale,
                                               **mask)
            gk2 = kbwd.flash_attention_bwd_cuda(q, k, v, out, lse, dout, softmax_scale=scale,
                                                **mask)
            gm = ref.mha_bwd(q, k, v, out, lse, dout, softmax_scale=scale, **mask)
            torch.cuda.synchronize()
            res["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(gk, gk2))
            ok = ok and res["bitwise_repeatable"]
            vs = {}
            for name, a, b in zip(("dq", "dk", "dv"), gk, gm):
                if dtype == torch.float32:
                    bound = FLASH_BWD_F32_TOL * (1 + float(b.float().abs().max()))
                    vs[name] = {"max_abs": float((a - b).abs().max()), "bound_max_abs": bound}
                    ok = ok and vs[name]["max_abs"] <= bound
                else:
                    vs[name] = {"rel_rms": rel_rms(a, b),
                                "bound_rel_rms": FLASH_BWD_VS_PLAIN_BF16_REL_RMS}
                    ok = ok and vs[name]["rel_rms"] <= FLASH_BWD_VS_PLAIN_BF16_REL_RMS
            res["vs_mha_bwd"] = vs
            del gk, gk2, gm
            e_out, ok_out = max_err(out, out_p, F32_TOL if dtype == torch.float32 else BF16_TOL)
            empty = torch.isinf(lse_p)  # (B, H, Sq): rows with no visible key
            vis = ~empty
            e_lse = float((lse[vis] - lse_p[vis]).abs().max()) if vis.any() else 0.0
            e_sum = float((row_sums[vis] - 1).abs().max()) if vis.any() else 0.0
            lse_bound = 1e-4 * (1 + float(lse_p[vis].abs().max())) if vis.any() else 0.0
            ok_lse = (e_lse <= lse_bound and e_sum <= lse_bound
                      and bool((lse[empty] == float("inf")).all()))
            dq_rows = g[0].transpose(1, 2)[empty]  # dq of the empty rows must be 0
            ok_empty = int(torch.count_nonzero(dq_rows)) == 0
            res.update({"out_max_abs": e_out, "lse_max_abs": e_lse,
                        "softmax_row_sum_max_abs_err": e_sum, "bound_lse": lse_bound,
                        "empty_rows": int(empty.sum()), "empty_rows_dq_zero": ok_empty})
            _check("flash_attention_bwd", case, dtype, res,
                   ok and ok_out and ok_lse and ok_empty, "")
            if case == FLASH_TRAIN and dtype == torch.bfloat16:
                worst["flash_attention"] = e_out
                worst["flash_attention_bwd"] = max(r["max_abs"] for r in
                                                   (res["dq"], res["dk"], res["dv"]))
                emit("flash_train_softmax_row_sums", {
                    "shape": case, "dtype": "bfloat16", "max_abs_err": e_sum,
                    "what": "max |sum_k exp(s - lse) - 1| over rows with a visible key, "
                            "s the f32 scores the backward recomputes, lse the forward's"})
            del q, k, v, dout, out, g, out_p, gp, lse, lse_p, row_sums
            torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------------------
# SSD backward against autograd through the plain version
# --------------------------------------------------------------------------

SSD_BWD_CASES = [
    # B, S, H, P, N, chunk, h0, a cotangent on the final state
    (2, 300, 8, 64, 128, 256, True, True),    # ragged S (one full and one partial chunk), h0
    (2, 37, 3, 8, 16, 8, True, False),        # N 16, ragged S over 5 chunks
    (2, 40, 3, 16, 32, 1, True, True),        # chunk 1: every step its own chunk
    (1, 1024, 4, 64, 128, 128, False, True),  # 8 chunks of two tiles, no h0
    (2, 333, 4, 32, 64, 64, True, True),      # N 64, ragged S over 6 chunks
    (4, 2048, 64, 64, 128, 256, False, False),  # mamba2-1.3b train, full width
]
SSD_TRAIN = SSD_BWD_CASES[-1]
# adversarial magnitudes: A 4x as negative, -4 to -64 (exp(cum) spans
# hundreds of decades within a chunk and most of L underflows to 0), with dy
# scaled by 1e3 and by 1e-3; (case, A's factor, dy's factor), checked at the
# same bounds. Far more negative A leaves f32 itself short of the f32 bound on
# ddt = x dxdt + A d(dA), the plain version's as much as the kernels'.
SSD_BWD_ADVERSARIAL = [(SSD_BWD_CASES[0], 4.0, 1e3), (SSD_BWD_CASES[0], 4.0, 1e-3)]


def ssd_grads(fn, x, dt, A, Bm, Cm, h0, dy, dh):
    """The gradients (dx, ddt, dA, dB, dC[, dh0]) of <y, dy> + <h_final, dh>
    through ``fn`` by autograd, on fresh leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    h0l = h0.detach().clone().requires_grad_(True) if h0 is not None else None
    y, hf = fn(*leaves, h0l)
    loss = (y.float() * dy.float()).sum() + ((hf * dh).sum() if dh is not None else 0)
    return torch.autograd.grad(loss, leaves + ([h0l] if h0l is not None else []))


def _grad_errs(got, want, dtype, rel_rms_bound):
    """Per gradient: f32 max abs against 1e-4 (1 + max |want|); bf16 the
    relative RMS against ``rel_rms_bound``. Returns (results, all ok)."""
    res, ok = {}, True
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        if b is None:
            continue
        err = float((a.float() - b.float()).abs().max())
        if dtype == torch.float32:
            bound = SSD_BWD_F32_TOL * (1 + float(b.float().abs().max()))
            res[name] = {"max_abs": err, "bound_max_abs": bound}
            ok = ok and err <= bound
        else:
            rr = rel_rms(a, b)
            res[name] = {"rel_rms": rr, "bound_rel_rms": rel_rms_bound, "max_abs": err}
            ok = ok and rr <= rel_rms_bound
        ok = ok and bool(torch.isfinite(a).all()) and a.dtype == b.dtype
    return res, ok


def run_ssd_bwd_checks(dev):
    """Returns the bf16 max abs error of the backward kernels against
    ref.ssd_scan_bwd at the train shape (largest over the gradients)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.kernels import ssd_scan_bwd as kbwd
    worst = None
    for case, a_scale, dy_scale in [(c, 1.0, 1.0) for c in SSD_BWD_CASES] + SSD_BWD_ADVERSARIAL:
        B, S, H, P, N, chunk, with_h0, with_dh = case
        dtypes = (torch.bfloat16,) if case == SSD_TRAIN else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
            x, dt, A, Bm, Cm, h0 = ssd_inputs(case[:7], dtype, dev, seed=7)
            A = A * a_scale
            gen = torch.Generator().manual_seed(8)
            dy = (randn(gen, x.shape, torch.float32, dev) * dy_scale).to(dtype)
            dh = randn(gen, (B, H, P, N), torch.float32, dev) if with_dh else None
            g = ssd_grads(lambda *a: ops.ssd_scan(*a[:5], chunk=chunk, h0=a[5]),
                          x, dt, A, Bm, Cm, h0, dy, dh)
            gp = ssd_grads(lambda *a: ref.ssd_scan(*a[:5], chunk=chunk, h0=a[5]),
                           x, dt, A, Bm, Cm, h0, dy, dh)
            torch.cuda.synchronize()
            res, ok = _grad_errs(g, gp, dtype, SSD_BWD_BF16_REL_RMS)
            del g, gp
            # the kernels alone, twice, against ref.ssd_scan_bwd on the same inputs
            _, _, ws = kssd._forward(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
            gk = kbwd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk,
                                        fwd_workspace=ws)
            gk2 = kbwd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk,
                                         fwd_workspace=ws)
            gm = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk)
            torch.cuda.synchronize()
            res["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(gk, gk2)
                                            if a is not None)
            res["dh0_iff_h0"] = (gk[5] is None) == (h0 is None)
            res["vs_ssd_scan_bwd"], ok_k = _grad_errs(gk, gm, dtype,
                                                      SSD_BWD_VS_PLAIN_BF16_REL_RMS)
            ok = ok and ok_k and res["bitwise_repeatable"] and res["dh0_iff_h0"]
            if (a_scale, dy_scale) != (1.0, 1.0):
                res["A_factor"], res["dy_factor"] = a_scale, dy_scale
            _check("ssd_scan_bwd", case, dtype, res, ok, "")
            if case == SSD_TRAIN:
                worst = max(v["max_abs"] for v in res["vs_ssd_scan_bwd"].values())
            del x, dy, Bm, Cm, gk, gk2, gm, ws
            torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def run_serve(cfg, params, dev, card):
    from repro_torch.launch import serve
    kw = dict(batch=SERVE["batch"], prompt_len=PROMPT[cfg.arch_id], gen_len=SERVE["gen_len"],
              seed=SERVE["seed"])
    # warm-up: cuBLAS handles, allocator pools and the kernels' first launches
    serve.serve(cfg, params, device=dev, requests=SERVE["batch"], **{**kw, "gen_len": 2})
    zero_counters()
    res = serve.serve(cfg, params, device=dev, requests=SERVE["requests"], **kw)
    launches, plain_calls = read_counters()
    expected = {name: EXPECTED[cfg.arch_id].get(name, 0) for name in launches}
    n_batches = -(-SERVE["requests"] // SERVE["batch"])
    ms = 1e-6
    out = {
        "card": card, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
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
            return plain_mha(q, k, v, causal=causal, window=window, q_offset=q_offset,
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


# the layers of the transformer archs' f32 copies that are cut to fit the
# card alone, at full width: mixtral-8x7b keeps 4 of its 16 served layers
# (23.6 GB); llama4-maverick's one unit is 66 GB in f32 and does not fit
# beside its activations, so its f32 check is the kernels' at its attention
# shapes (run_checks)
F32_LAYERS = {"mixtral-8x7b": 4, "llama4-maverick-400b-a17b": 0}


def f32_copy(cfg, params):
    """(config, params) of an f32 copy of the served model, or (None, None)
    where none fits. recurrentgemma-9b (35 GB in f32) keeps its first pattern
    unit and the tail (5 of 38 layers), the transformer archs the layers
    F32_LAYERS says, the others all."""
    n = F32_LAYERS.get(cfg.arch_id)
    if n == 0:
        return None, None
    c = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p = params
    if cfg.family == "hybrid":
        c = c.replace(n_layers=len(cfg.block_pattern) + len(params["backbone"]["tail"]))
        unit0 = [_slice(u, 1) for u in params["backbone"]["units"]]
        p = {**params, "backbone": {"units": unit0, "tail": params["backbone"]["tail"]}}
    elif n is not None:  # a transformer: whole units of its stacked layers
        c = c.replace(n_layers=n)
        units = [_slice(u, n // len(params["backbone"]["units"]))
                 for u in params["backbone"]["units"]]
        p = {**params, "backbone": {"units": units}}
    return c, _cast_tree(p, torch.float32)


def _slice(node, n):
    return {k: _slice(v, n) for k, v in node.items()} if isinstance(node, dict) else node[:n]


class forced_experts:
    """Teacher forcing of the MoE layers' expert choices, as logits_run's
    ``forced`` tokens are of the decode inputs. In ``mode(replay=False)``
    moe.route keeps each call's chosen experts; in ``mode(replay=True)`` each
    call, in the same order, takes the recorded ones in place of its own top
    k (its combine weights the softmax of its own logits at them) and counts
    the tokens whose own top k differs. bf16 rounding flips a near tie of two
    experts' logits and sends that token through another expert, which moves
    its logits by order 100% and says nothing of the kernels."""

    def __init__(self):
        self.choices, self.flipped, self.tokens = [], 0, 0

    @contextlib.contextmanager
    def mode(self, replay):
        from repro_torch.models import moe
        route, recorded = moe.route, iter(self.choices)

        def forced(cfg, router, x2d):
            idx, weights, aux = route(cfg, router, x2d)
            if not replay:
                self.choices.append(idx)
                return idx, weights, aux
            want = next(recorded)
            self.flipped += int((idx != want).any(dim=-1).sum())
            self.tokens += idx.shape[0]
            logits = x2d.float() @ router.float()
            return want, torch.softmax(logits.gather(1, want), dim=-1), aux
        moe.route = forced
        try:
            yield
        finally:
            moe.route = route


def serve_vs_plain(cfg, params, prompt, steps=4):
    """Prefill and ``steps`` decode steps with the kernels against the same
    model on the plain versions (teacher-forced by the kernels' tokens and,
    in MoE layers, expert choices), in the config's dtype: bf16 within
    SERVE_BF16_REL_RMS, f32 within SERVE_F32_ABS."""
    experts = forced_experts()
    with experts.mode(replay=False):
        kern, toks = logits_run(cfg, params, prompt, steps)
    with plain_kernels(), experts.mode(replay=True):
        plain, _ = logits_run(cfg, params, prompt, steps, forced=toks)
    diff = kern - plain
    rr = float(diff.norm() / plain.norm())
    max_abs = float(diff.abs().max())
    bf16 = cfg.param_dtype == "bfloat16"
    bound = {"rel_rms": SERVE_BF16_REL_RMS[cfg.arch_id]} if bf16 else {"max_abs": SERVE_F32_ABS}
    ok = bool(torch.isfinite(kern).all()) and (
        rr <= bound["rel_rms"] if bf16 else max_abs <= SERVE_F32_ABS)
    out = {"n_layers": cfg.n_layers, "prefill_max_abs": float(diff[0].abs().max()),
           "decode_max_abs": float(diff[1:].abs().max()), "max_abs": max_abs, "rel_rms": rr,
           # per step: a routing flip moves whole tokens' logits
           "rel_rms_per_step": [float(d.norm() / p.norm()) for d, p in zip(diff, plain)],
           "argmax_agree": float((kern.argmax(-1) == plain.argmax(-1)).float().mean()),
           "max_abs_logit": float(plain.abs().max()), "decode_steps": steps,
           # routed tokens (over all MoE layers and calls) whose own top k
           # differs from the kernels' run, which the plain run was forced to
           "expert_flips": {"tokens": experts.tokens, "flipped": experts.flipped},
           "bound": bound, "ok": ok}
    del kern, plain, diff
    torch.cuda.empty_cache()
    return out


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
            "decode_attention_ms_per_step": sum(
                v for k, v in by_name.items() if DECODE_KERNELS in k) / n / 1e3,
            "ssd_scan_ms_per_step": sum(
                v for k, v in by_name.items() if SSD_KERNELS in k) / n / 1e3,
            "rglru_scan_ms_per_step": sum(
                v for k, v in by_name.items() if RGLRU_KERNELS in k) / n / 1e3,
            "top_kernels_ms_per_step": sorted(
                ([k[:90], v / n / 1e3] for k, v in by_name.items()), key=lambda kv: -kv[1])[:8],
        }
    emit("trace", out)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

TRAIN = dict(arch="qwen3-1.7b", seq_len=2048, global_batch=4, steps=8, seed=0)
TRAIN_LABEL = "qwen3-1.7b train"
SSM_TRAIN_LABEL = "mamba2-1.3b train"
TRAIN_FEEDS = {"qwen3-1.7b": ("bypass", "kernel"), "mamba2-1.3b": ("bypass",)}
TRAIN_LOSS_REL, TRAIN_GRAD_OF_MAX, RESTART_TOL = 1e-5, 1e-4, 1e-4
# the kernels of each family's train step: (name part of their kernels,
# counter of their wrapper); each kernel name launches once a wrapper call
TRAIN_KERNELS = {
    "dense": {"flash_fwd": ("flash_fwd_", "flash_attention"),
              "flash_bwd": ("flash_bwd_", "flash_attention_bwd")},
    "ssm": {"ssd_fwd": (SSD_KERNELS, "ssd_scan"), "ssd_bwd": (SSD_BWD_KERNELS, "ssd_scan_bwd")},
}
# leaves whose gradient only the family's backward kernel gives
KERNEL_GRAD_LEAVES = {"dense": ("wq", "wk", "wv"), "ssm": ("a_log", "dt_bias")}


def train_expected(cfg, steps):
    """Launches of ``steps`` train steps: per layer, the forward and its
    recompute under torch.utils.checkpoint, then one backward, of the
    family's kernel (flash attention, or the SSD scan)."""
    fwd, bwd = [counter for _, counter in TRAIN_KERNELS[cfg.family].values()]
    return {fwd: 2 * cfg.n_layers * steps, bwd: cfg.n_layers * steps}


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(xs, q))


def _kernel_profile(prof, wall_us):
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = _busy_us(kernels) if kernels else None
    return by_name, busy, {
        "host_ms": wall_us / 1e3,
        "device_busy_ms": None if busy is None else busy / 1e3,
        "device_idle_share": None if busy is None else 1.0 - busy / wall_us,
        "top_kernels_ms": sorted(([k[:90], v / 1e3] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10]}


def trace_train(cfg, rt, state, dev):
    """Profile one more train step (a fresh batch of the same stream).

    The profiler drops kernel events (device_ms), so the family's kernels
    (TRAIN_KERNELS: each of their names launches once a wrapper call) are
    counted as device_ms counts them: each name's mean event time times its
    launches in the step, read from the wrapper counters; the events lost
    there are added to the busy time, whose idle share is then corrected for
    them (the step runs on one stream, so they overlap nothing). Other
    kernels' lost events stay uncounted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import synth_tokens
    from repro_torch.runtime.steps import make_train_step
    step_fn = make_train_step(cfg, rt.opt_cfg)
    host = synth_tokens(cfg, rt.dcfg, 0, 1, TRAIN["steps"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    torch.cuda.synchronize()
    zero_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state.params, state.opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches, _ = read_counters()
    by_name, busy, out = _kernel_profile(prof, wall_us)
    events = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            events.setdefault(e.name, []).append(e.time_range.elapsed_us())
    lost_us, counted = 0.0, {}
    for fam, (part, counter) in TRAIN_KERNELS[cfg.family].items():
        n = launches[counter]
        names = [k for k in events if part in k and (fam != "ssd_fwd" or SSD_BWD_KERNELS not in k)]
        mean = {k: sum(events[k]) / len(events[k]) for k in names}
        by = {k[:60]: mean[k] * max(n, len(events[k])) / 1e3 for k in names}
        lost_us += sum(max(0, n - len(events[k])) * mean[k] for k in names)
        counted[fam] = {"ms": sum(by.values()), "ms_by_kernel": by, "launches": n,
                        "events": {k[:60]: len(events[k]) for k in names}}
    busy_c = None if busy is None else busy + lost_us
    total = sum(c["ms"] for c in counted.values())
    out.update({"arch": cfg.arch_id, "counted": counted,
                "device_busy_ms_corrected": None if busy_c is None else busy_c / 1e3,
                "device_idle_share_corrected": None if busy_c is None else 1.0 - busy_c / wall_us,
                "counted_share_of_busy": None if not busy_c else total * 1e3 / busy_c})
    emit("trace_train", out)
    if any(c["ms"] <= 0 for c in counted.values()):
        fail(f"trace_train: a kernel family of {cfg.arch_id} reads no device time: "
             f"{ {f: c['ms'] for f, c in counted.items()} }")


def run_train(dev, card, arch):
    """``arch`` at full width, bf16, 8 steps with each of its feeds
    (TRAIN_FEEDS) on the same batches. Returns the bypass run's launch
    counts."""
    import contextlib
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_config
    from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime
    cfg = get_config(arch)
    dcfg = DataConfig(seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"],
                      seed=TRAIN["seed"])
    emit("train_checkpointing", f"{arch}: off at full width: params, gradients, f32 master "
         f"copy and AdamW moments are {16 * cfg.param_count() / 1e9:.1f} GB to hash and "
         "write; the restart phase drives checkpoints at the smoke config")
    expected = train_expected(cfg, TRAIN["steps"])
    runs = {}
    for feed in TRAIN_FEEDS[arch]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        rt = TrainerRuntime(cfg, dcfg, TrainerConfig(steps=TRAIN["steps"], feed=feed,
                                                     log_every=1, seed=TRAIN["seed"]),
                            device=dev)
        zero_counters()
        with contextlib.redirect_stdout(sys.stderr):  # the trainer's log lines
            state = rt.run()
        launches, plain_calls = read_counters()
        want = {name: expected.get(name, 0) for name in launches}
        losses = [m["loss"] for m in rt.metrics_log]
        st = rt.feed.stats
        tokens = TRAIN["steps"] * TRAIN["global_batch"] * TRAIN["seq_len"]
        out = {
            "card": card, "arch": cfg.arch_id, "feed": feed, "params": cfg.param_count(),
            "dtype": cfg.param_dtype, **{k: TRAIN[k] for k in ("seq_len", "global_batch", "steps")},
            "losses": losses, "grad_norms": [m["grad_norm"] for m in rt.metrics_log],
            "step_ms": [t * 1e3 for t in rt.step_times_s],
            "step_ms_median": _pct(rt.step_times_s, 50) * 1e3,
            "step_ms_p99": _pct(rt.step_times_s, 99) * 1e3,
            "tok_per_s": tokens / sum(rt.step_times_s),
            "feed_wait_ms_per_batch": 1e3 * sum(rt.feed_times_s) / len(rt.feed_times_s),
            "feed_wait_ms_max": 1e3 * max(rt.feed_times_s),
            "feed_stats": {"batches": st.batches, "bytes": st.bytes,
                           "put_ms_per_batch": st.put_ns / 1e6 / max(st.batches, 1),
                           "poll_wait_ms_per_batch": st.wait_ns / 1e6 / max(st.batches, 1),
                           "host_alloc_ms_per_batch": st.host_alloc_ns / 1e6 / max(st.batches, 1),
                           "empty_polls": st.empty_polls, "avg_occupancy": st.avg_occupancy},
            "launches": launches, "expected_launches": want, "plain_calls": plain_calls,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        }
        emit("train", out)
        if launches != want:
            fail(f"train ({feed} feed): launch counts {launches} != expected {want}")
        if plain_calls:
            fail(f"train ({feed} feed): called the plain versions {plain_calls} times")
        if len(losses) != TRAIN["steps"] or not all(math.isfinite(x) for x in losses):
            fail(f"train ({feed} feed): losses {losses}")
        runs[feed] = out
        if feed == "bypass":
            trace_train(cfg, rt, state, dev)
        del state, rt
    if len(runs) > 1:
        same = runs["bypass"]["losses"] == runs["kernel"]["losses"]
        emit("train_feeds", {"arch": arch, "losses_bitwise_equal": same,
                             "feed_wait_ms_per_batch": {f: runs[f]["feed_wait_ms_per_batch"]
                                                        for f in runs},
                             "step_ms_median": {f: runs[f]["step_ms_median"] for f in runs}})
        if not same:
            fail(f"the two feeds gave different losses: {runs['bypass']['losses']} vs "
                 f"{runs['kernel']['losses']}")
    torch.cuda.empty_cache()
    return runs["bypass"]["launches"]


def run_train_vs_plain(dev, arch):
    """One step's loss and every gradient, kernels against plain versions:
    f32, full width, 4 layers."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synth_tokens
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_config
    from repro_torch.runtime.steps import loss_and_grads
    cfg = get_config(arch).replace(n_layers=4, param_dtype="float32", compute_dtype="float32")
    params = serve.init_params(cfg, 0, dev)
    host = synth_tokens(cfg, DataConfig(seq_len=TRAIN["seq_len"],
                                        global_batch=TRAIN["global_batch"], seed=1), 0, 1, 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    zero_counters()
    loss_k, _, gk = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    launches, plain_calls = read_counters()
    want = {name: train_expected(cfg, 1).get(name, 0) for name in launches}
    with plain_kernels():
        loss_p, _, gp = loss_and_grads(cfg, params, batch)
    gk, gp = tree.leaf_paths(gk), tree.leaf_paths(gp)
    worst, ok = {}, True
    for key in gp:
        ref_max = float(gp[key].abs().max())
        err = float((gk[key] - gp[key]).abs().max())
        worst[key] = err / max(ref_max, 1e-30)
        ok = ok and err <= TRAIN_GRAD_OF_MAX * ref_max and bool(torch.isfinite(gk[key]).all())
    lk, lp = float(loss_k), float(loss_p)
    loss_ok = abs(lk - lp) <= TRAIN_LOSS_REL * abs(lp)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    leaves = KERNEL_GRAD_LEAVES[cfg.family]
    out = {"arch": arch, "n_layers": cfg.n_layers, "dtype": "float32", "loss_kernels": lk,
           "loss_plain": lp, "loss_rel_diff": abs(lk - lp) / abs(lp),
           "bound_loss_rel": TRAIN_LOSS_REL, "grad_leaves": len(gp),
           "worst_grad_err_of_max": top, "bound_grad_err_of_max": TRAIN_GRAD_OF_MAX,
           "kernel_grad_leaves": leaves,
           "kernel_grads_nonzero": all(bool(gk[k].abs().max() > 0) for k in gk
                                       if k.split("/")[-1] in leaves),
           "launches": launches, "expected_launches": want, "plain_calls": plain_calls}
    emit("train_vs_plain", out)
    if not (ok and loss_ok and out["kernel_grads_nonzero"]) or launches != want \
            or plain_calls:
        fail(f"train_vs_plain: {out}")
    del params, gk, gp
    torch.cuda.empty_cache()


def run_restart(dev):
    """test_trainer_checkpoint_restart_determinism on the card (smoke config, f32)."""
    import contextlib
    import shutil
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_smoke_config
    from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime
    cfg = get_smoke_config(TRAIN["arch"]).replace(param_dtype="float32",
                                                  compute_dtype="float32")
    dcfg = DataConfig(seq_len=32, global_batch=2, seed=5)
    base = ROOT / "build" / "chip_smoke_restart"
    shutil.rmtree(base, ignore_errors=True)

    def losses_of(run_steps, ckpt_dir):
        rt = TrainerRuntime(cfg, dcfg, TrainerConfig(steps=run_steps, ckpt_every=2,
                                                     ckpt_dir=str(ckpt_dir), feed="bypass",
                                                     log_every=1), device=dev)
        with contextlib.redirect_stdout(sys.stderr):
            rt.run()
        return {m["step"]: m["loss"] for m in rt.metrics_log}

    try:
        full = losses_of(6, base / "a")
        first = losses_of(4, base / "b")
        resumed = losses_of(6, base / "b")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    diffs = {s: abs(full[s] - resumed.get(s, float("nan"))) for s in (5, 6)}
    ok = sorted(resumed) == [5, 6] and sorted(first) == [1, 2, 3, 4] and all(
        d < RESTART_TOL for d in diffs.values())
    emit("restart", {"full": full, "first": first, "resumed": resumed, "abs_diff": diffs,
                     "tol": RESTART_TOL, "ok": ok})
    if not ok:
        fail(f"restart not deterministic: {diffs}")


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
           "rglru_scan": ("rglru_scan.cu", "rglru_scan.py:46"),
           # the gradient of the Pallas forward, which JAX takes through its chunked path
           "flash_attention_bwd": ("flash_attention_bwd.cu", "flash_attention.py:92"),
           "burst_gather": ("burst_gather.cu", "burst_gather.py:34"),
           # the gradient of the Pallas forward, which JAX takes through its chunked path
           "ssd_scan_bwd": ("ssd_scan_bwd.cu", "ssd_scan.py:66"),
           # jitted XLA (the scan and gather of get_epoch_pass_jax), not Pallas
           "epoch_pass": ("epoch_pass.cu", "epoch_fastpath.py:108")}[name]
    return {"name": f"{name} ({arch})", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src[0]}",
            "replaces": f"src/repro/kernels/{src[1]}",
            "launches": launches[arch][name], "max_abs_err": errs[(name, arch)],
            **kw, "card": card}


def time_flash(arch, launches, errs, card, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    with_lse = arch == TRAIN_LABEL  # the train path's forward also writes the logsumexp
    case = FLASH_TRAIN if with_lse else FLASH_SERVE[arch]
    B, S, _, H, Hkv, Dh, causal, window, _ = case
    scale = Dh ** -0.5
    q, k, v = flash_inputs(case, torch.bfloat16, dev, seed=3)
    # visible (q, k) pairs per (b, h) under the causal and window masks
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    flops = 4 * Dh * pairs * B * H
    b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel())
                       + (4 * B * H * S if with_lse else 0), flops)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:  # SDPA takes the window only as a mask, built outside the timing
        mask = ref.attention_mask(S, S, causal=causal, window=window, device=dev)
    kern = lambda: kflash._forward(  # noqa: E731
        q, k, v, causal=causal, window=window, q_offset=0, softmax_scale=scale,
        with_lse=with_lse)[0]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, scale=scale,
        enable_gqa=True).transpose(1, 2)
    heads_major = [t.contiguous() for t in (qt, kt, vt)]
    ms = time_ms(kern, iters=20 if window else 50)
    return _row("flash_attention", arch, launches, errs, card,
                ms=ms, flops=flops, tflop_per_s=flops / ms / 1e9,
                plain_ms=time_ms(lambda: plain_mha(q, k, v, causal=causal, window=window,
                                                   softmax_scale=scale), iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, iters=20),
                library="scaled_dot_product_attention" + (" with a window mask" if window else ""),
                library_vs_kernel_max_abs=max_err(lib(), kern(), BF16_TOL),
                library_head_major_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    *heads_major, attn_mask=mask, is_causal=mask is None, scale=scale,
                    enable_gqa=True), iters=20),
                shape={"B": B, "Sq": S, "Skv": S, "H": H, "Hkv": Hkv, "Dh": Dh,
                       "causal": causal, "window": window, "dtype": "bfloat16",
                       "lse": with_lse})


def time_flash_bwd(launches, errs, card, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import ref
    B, S, _, H, Hkv, Dh = FLASH_TRAIN[:6]
    scale = Dh ** -0.5
    mask = dict(causal=True, window=0, q_offset=0)
    q, k, v = flash_inputs(FLASH_TRAIN, torch.bfloat16, dev, seed=3)
    dout = randn(torch.Generator().manual_seed(9), q.shape, torch.bfloat16, dev)
    out, lse = kflash._forward(q, k, v, softmax_scale=scale, with_lse=True, **mask)
    pairs = S * (S + 1) // 2
    # read q, o, dO and k, v once, write dq, dk, dv; 5 products of 2*Dh FLOP per
    # visible pair and head: the scores again, dP, dV, dK and dQ
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, 10 * Dh * pairs * B * H)
    kern = lambda: kbwd.flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, out, lse, dout, softmax_scale=scale, **mask)
    # plain: autograd's backward through ref.mha, its graph built outside the timing
    qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
    out_p = ref.mha(qp, kp, vp, softmax_scale=scale, **mask)
    plain_ms = time_ms(lambda: torch.autograd.grad(out_p, (qp, kp, vp), dout,
                                                   retain_graph=True), iters=3, warmup=1)
    del out_p, qp, kp, vp
    torch.cuda.empty_cache()
    # library: SDPA's forward + backward minus its forward (the port never calls it)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dout_t = dout.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
    sdpa_fb = lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dout_t)  # noqa: E731
    lib_ms = time_ms(sdpa_fb, iters=20) - time_ms(sdpa, iters=20)
    got = kern()
    rr = max(rel_rms(a, b.transpose(1, 2)) for a, b in zip(got, sdpa_fb()))
    flops = 10 * Dh * pairs * B * H
    ms = time_ms(kern, iters=10)
    return _row("flash_attention_bwd", TRAIN_LABEL, launches, errs, card,
                ms=ms, flops=flops, tflop_per_s=flops / ms / 1e9, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms,
                library="scaled_dot_product_attention forward+backward minus its forward",
                library_vs_kernel_rel_rms=(rr, rr <= FLASH_BWD_BF16_REL_RMS),
                shape={"B": B, "Sq": S, "Skv": S, "H": H, "Hkv": Hkv, "Dh": Dh,
                       "causal": True, "dtype": "bfloat16", "bytes": nbytes})


GATHER_SWEEP = (32, 64, 128, 256, 512, 1024, 4096)  # the paper's DPDK bursts, the ring
HOST_CALLS, HOST_SYNC_EVERY = 1000, 100


def gather_bytes(arena, lens, width):
    """What a gather must move: each packet's valid bytes read, each output
    row written, its slot and length read."""
    n = lens.numel()
    return int(lens.clamp(0, min(arena.shape[1], width)).sum()) + n * width + 8 * n


def l2_flusher(dev):
    """A write over twice the L2, so that the next call finds its inputs in
    device memory."""
    buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    return lambda: buf.fill_(1)


def host_us(fn, calls=HOST_CALLS, every=HOST_SYNC_EVERY):
    """Host microseconds per call of ``fn`` (time.perf_counter), synchronising
    every ``every`` calls, outside the timing, so that the queue stays short."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // every):
        t0 = time.perf_counter()
        for _ in range(every):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def gather_host(dev, card):
    """Host us per call of each stage of burst_gather_cuda at the benchmark
    shape, in the wrapper's order, and two floors timed as the wrapper is
    (CUDA events over back-to-back calls): torch.empty alone, and
    torch.empty + fill_(0), one PyTorch op that allocates and launches
    (launch_floor_ms)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import burst_gather as kgather
    arena, slots, lens, width = gather_inputs(GATHER_CASES["bench"], dev, seed=11)
    n, n_slots, slot_size = kgather.check_args(arena, slots, lens, width)
    lib, fn, raw_stream = kgather._fn()
    index = arena.get_device()
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    p = kgather.plan(n, width)
    args = (arena.data_ptr(), slots.data_ptr(), lens.data_ptr(), out.data_ptr(),
            n, n_slots, slot_size, width, p.chunks, p.tail, p.grid, p.threads)
    stream = raw_stream(index)
    shape = (n, width)

    def call():
        _build.check(lib, "burst_gather", fn(*args, stream))

    stages = {
        "checks": lambda: kgather.check_args(arena, slots, lens, width),
        "torch.empty": lambda: torch.empty(shape, dtype=torch.uint8, device=arena.device),
        "_fn()": lambda: kgather._launcher or kgather._fn(),
        "device guard": lambda: arena.get_device() == torch.cuda.current_device(),
        "stream lookup": lambda: raw_stream(index),
        "plan and pointers": lambda: (kgather.plan(n, width), arena.data_ptr(),
                                      slots.data_ptr(), lens.data_ptr(), out.data_ptr()),
        "ctypes call + _build.check": call,
    }
    stage_us = {k: host_us(f) for k, f in stages.items()}
    kern = lambda: kgather.burst_gather_cuda(arena, slots, lens, width)  # noqa: E731
    line = {"shape": {"packets": n, "out_width": width}, "calls": HOST_CALLS,
            "sync_every": HOST_SYNC_EVERY, "stages_us": stage_us,
            "sum_of_stages_us": sum(stage_us.values()), "wrapper_us": host_us(kern),
            "empty_ms": time_ms(lambda: torch.empty(shape, dtype=torch.uint8, device=dev),
                                iters=200),
            "launch_floor_ms": time_ms(lambda: torch.empty(shape, dtype=torch.uint8,
                                                           device=dev).fill_(0), iters=200),
            "card": card}
    emit("gather_host", line)
    return line


def gather_sweep(dev, card):
    """The gather at the paper's DPDK bursts (its section 5.2 sweeps 32 to
    1024) and the whole ring of 4096 slots in one call: the arena of the
    benchmark, random distinct slots, lengths 64-1517, out_width 1518. Each
    burst's output is first checked equal to the plain version."""
    from repro_torch.kernels import burst_gather as kgather
    from repro_torch.kernels import ref
    flush = l2_flusher(dev)
    rows = []
    for n in GATHER_SWEEP:
        arena, slots, lens, width = gather_inputs((4096, 1518, n, None, 1518), dev,
                                                  seed=20 + n)
        kern = lambda: kgather.burst_gather_cuda(arena, slots, lens, width)  # noqa: E731
        err = byte_err(kern(), ref.burst_gather(arena, slots, lens, width))
        if err:
            fail(f"burst_gather at n {n}: max abs byte error {err}")
        nbytes = gather_bytes(arena, lens, width)
        b_ms = bound(nbytes, 0)[0]
        dev_ms = device_ms(kern, "burst_gather")
        cold_ms = device_ms(kern, "burst_gather", flush=flush)
        rows.append({"n": n, "bytes": nbytes, "ms": time_ms(kern, iters=200),
                     "device_ms": dev_ms, "device_ms_cold_l2": cold_ms, "bound_ms": b_ms,
                     "device_gb_per_s": nbytes / dev_ms / 1e6,
                     "device_gb_per_s_cold_l2": nbytes / cold_ms / 1e6,
                     "cold_over_bound": cold_ms / b_ms})
    emit("gather_sweep", {"rows": rows, "hbm_gb_per_s": HBM_BYTES_PER_S / 1e9,
                          "card": card})
    return rows


def time_gather(launches, errs, card, dev, launch_floor_ms):
    from repro_torch.kernels import burst_gather as kgather
    from repro_torch.kernels import ref
    arena, slots, lens, width = gather_inputs(GATHER_CASES["bench"], dev, seed=11)
    n = slots.numel()
    nbytes = gather_bytes(arena, lens, width)
    b_ms, b_by = bound(nbytes, 0)
    kern = lambda: kgather.burst_gather_cuda(arena, slots, lens, width)  # noqa: E731
    return _row("burst_gather", "bench", launches, errs, card,
                ms=time_ms(kern, iters=200), device_ms=device_ms(kern, "burst_gather"),
                device_ms_cold_l2=device_ms(kern, "burst_gather", flush=l2_flusher(dev)),
                launch_floor_ms=launch_floor_ms,
                plain_ms=time_ms(lambda: ref.burst_gather(arena, slots, lens, width),
                                 iters=50),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library="none (no single call)",
                shape={"n_slots": arena.shape[0], "slot_size": arena.shape[1], "packets": n,
                       "out_width": width, "bytes": nbytes,
                       "plan": kgather.plan(n, width)._asdict()})


def time_epoch_pass(launches, errs, card, dev):
    """The epoch pass at the bench shape's first epoch: the wrapper (its
    call reads busy_until back, a synchronisation) by CUDA events, the
    device time of its kernels, the plain version (cumsum, cummax and a
    gather on the card), and the pass as the engine calls it (numpy in and
    out, the copies included) beside the numpy pass, on the host clock."""
    from repro_torch.kernels import epoch_pass as kep
    from repro_torch.kernels import ref
    host, (h, s, table, fids) = bench_epoch(dev)
    n, busy0, lat = h.numel(), host[2], host[3]
    kern = lambda: kep.epoch_pass_cuda(h, s, busy0, lat, table, fids)  # noqa: E731
    plain = lambda: ref.epoch_pass(h, s, busy0, lat, table, fids)  # noqa: E731
    if not (epoch_equal(kern(), plain()) and epoch_equal(kern(), kep.epoch_pass_np(*host))):
        fail("epoch_pass at the bench epoch: the kernel, its plain version and the numpy "
             "pass disagree")
    nbytes = 8 * (5 * n + table.numel())  # handed, ser, fids in; arrivals, queues out
    b_ms, b_by = bound(nbytes, 0)
    engine_pass = kep.make_pass(dev.type)

    def host_ms(fn, calls=200):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls * 1e3

    return _row("epoch_pass", SIM_LABEL, launches, errs, card,
                ms=time_ms(kern, iters=200), device_ms=device_ms(kern, "epoch_pass_"),
                device_ms_per_kernel={k: device_ms(kern, "epoch_pass_" + k)
                                      for k in ("reduce", "carry", "apply")},
                launch_floor_ms=time_ms(lambda: torch.empty(
                    2, dtype=torch.int64, device=dev).fill_(0).tolist(), iters=200),
                plain_ms=time_ms(plain, iters=200),
                engine_pass_ms=host_ms(lambda: engine_pass(*host)),
                numpy_pass_ms=host_ms(lambda: kep.epoch_pass_np(*host)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library="none: no single PyTorch call computes a max-plus scan",
                shape={"n": n, "n_flows": table.numel(), "queues": EPOCH_QUEUES,
                       "bytes": nbytes, "plan": kep.plan(n)._asdict()})


def time_decode(arch, launches, errs, card, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref
    B, C, H, Hkv, Dh, _ = DECODE_SERVE[arch]
    # qwen3: the middle decode step over a cache of prompt + gen slots;
    # recurrentgemma: the ring is full at every decode step
    n = PROMPT[arch] + SERVE["gen_len"] // 2 + 1 if C > PROMPT[arch] else C
    q1, kc, vc, cl = decode_inputs((B, C, H, Hkv, Dh, (n,) * B), torch.bfloat16, dev, seed=4)
    scale = Dh ** -0.5
    valid = n * B
    kv_bytes = 2 * 2 * valid * Hkv * Dh
    b_ms, b_by = bound(2 * 2 * q1.numel() + kv_bytes + 4 * B, 4 * Dh * H * valid)
    plan = kdec.plan_splits(B, C, Hkv, H // Hkv, Dh, q1.dtype, kdec._sm_count(dev.index))
    # every row has the same length n, so SDPA on the first n slots, unmasked,
    # computes the same function
    q1t, kct, vct = q1[:, :, None], kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
    kern = lambda: kdec.decode_attention_cuda(q1, kc, vc, cl, softmax_scale=scale)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q1t, kct, vct, scale=scale, enable_gqa=True)[:, :, 0]
    heads_major = [t.contiguous() for t in (q1t, kct, vct)]
    flush = l2_flusher(dev)
    return _row("decode_attention", arch, launches, errs, card,
                ms=time_ms(kern, iters=200), device_ms=device_ms(kern, DECODE_KERNELS),
                device_ms_partial=device_ms(kern, DECODE_KERNELS + "partial"),
                device_ms_combine=device_ms(kern, DECODE_KERNELS + "combine"),
                device_ms_cold_l2=device_ms(kern, DECODE_KERNELS, flush=flush),
                library_device_ms_cold_l2=device_ms(lib, "", flush=flush),
                plain_ms=time_ms(lambda: ref.decode_attention(q1, kc, vc, cl,
                                                              softmax_scale=scale)),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, iters=200),
                library="scaled_dot_product_attention",
                library_device_ms=device_ms(lib, ""),  # every kernel of the call
                library_vs_kernel_max_abs=max_err(lib(), kern(), BF16_TOL),
                library_head_major_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    *heads_major, scale=scale, enable_gqa=True), iters=200),
                kv_bytes=kv_bytes,
                plan={**plan._asdict(), "blocks": plan.n_splits * Hkv * B},
                shape={"B": B, "C": C, "H": H, "Hkv": Hkv, "Dh": Dh, "cache_len": [n] * B,
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
    kern = lambda: kssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q)  # noqa: E731
    return _row("ssd_scan", "mamba2-1.3b", launches, errs, card,
                ms=time_ms(kern, iters=10), device_ms=device_ms(kern, SSD_KERNELS, iters=10),
                device_ms_per_kernel={ph: device_ms(kern, SSD_KERNELS + ph, iters=10)
                                      for ph in SSD_PHASES},
                plain_ms=time_ms(lambda: ref.ssd_scan(x, dt, A, Bm, Cm, chunk=Q),
                                 iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by,
                # the same products on the CUDA cores, where this design runs them
                fma_floor_ms=flops / F32_FLOP_PER_S * 1e3, library_ms=None,
                library="none: no single PyTorch call computes an SSD scan",
                shape={"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": Q,
                       "dtype": "bfloat16", "flops": flops, "bytes": nbytes})


def ssd_bwd_flops(B, S, H, P, N, Q):
    """The chunked form's products in the SSD gradient, lower triangles
    only: per (row, chunk, head) four P x N-by-chunk products (the chunk's
    state gradient, g B, dY^T h_c, XDT^T g) and two over the triangle (G and
    (L o S)^T dY); per (row, chunk) M B and M^T C."""
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    return B * nc * (4 * tri * N + H * (8 * Q * P * N + 4 * tri * P))


def ssd_bwd_mma_flops(B, S, H, P, N, Q):
    """The products of ssd_bwd_flops that the bf16 backward kernels run on
    the tensor cores, lower triangles only: G (two raw bf16 operands),
    (L o S)^T dY, g B, dY^T h_c and X^T g (an f32 operand split into hi + lo,
    so two bf16 products each). Returns (their bf16 FLOP, split terms
    counted; their FLOP counted once). The chunk's state gradient and M B,
    M^T C stay on f32 FMAs."""
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    per_head = 2 * tri * P, 2 * tri * P + 3 * 2 * Q * P * N  # raw x raw; split
    return (B * nc * H * (per_head[0] + 2 * per_head[1]),
            B * nc * H * (per_head[0] + per_head[1]))


def time_ssd_bwd(launches, errs, card, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.kernels import ssd_scan_bwd as kbwd
    B, S, H, P, N, Q, _, _ = SSD_TRAIN
    x, dt, A, Bm, Cm, _ = ssd_inputs(SSD_TRAIN[:7], torch.bfloat16, dev, seed=5)
    dy = randn(torch.Generator().manual_seed(6), x.shape, torch.bfloat16, dev)
    # read x, dy, dt, A, B, C once, write dx, ddt, dA, dB, dC
    nbytes = (3 * x.numel() * 2 + 2 * dt.numel() * 4 + 2 * A.numel() * 4
              + 4 * Bm.numel() * 2)
    flops = ssd_bwd_flops(B, S, H, P, N, Q)
    mma_flops, mma_flops_once = ssd_bwd_mma_flops(B, S, H, P, N, Q)
    b_ms, b_by = bound(nbytes, flops)
    _, _, ws = kssd._forward(x, dt, A, Bm, Cm, chunk=Q, h0=None)
    kern = lambda: kbwd.ssd_scan_bwd_cuda(  # noqa: E731
        x, dt, A, Bm, Cm, None, dy, None, chunk=Q, fwd_workspace=ws)
    # plain: autograd's backward through ref.ssd_scan, its graph built outside the timing
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y_p, _ = ref.ssd_scan(*leaves, chunk=Q)
    plain_ms = time_ms(lambda: torch.autograd.grad(y_p, leaves, dy, retain_graph=True),
                       iters=3, warmup=1)
    del y_p, leaves
    torch.cuda.empty_cache()
    ms = time_ms(kern, iters=10)
    return _row("ssd_scan_bwd", SSM_TRAIN_LABEL, launches, errs, card,
                ms=ms, device_ms=device_ms(kern, SSD_BWD_KERNELS, iters=10),
                device_ms_per_kernel={ph: device_ms(kern, SSD_BWD_KERNELS + ph, iters=10)
                                      for ph in SSD_BWD_PHASES},
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                # the same products all on the f32 CUDA cores
                fma_floor_ms=flops / F32_FLOP_PER_S * 1e3,
                # this design's: its bf16 mma FLOP, split terms counted, on the
                # tensor cores, and the rest of the products on f32 FMAs
                mma_flops=mma_flops, mma_floor_ms=mma_flops / BF16_FLOP_PER_S * 1e3,
                design_floor_ms=(mma_flops / BF16_FLOP_PER_S
                                 + (flops - mma_flops_once) / F32_FLOP_PER_S) * 1e3,
                library_ms=None,
                library="none: no single PyTorch call computes an SSD gradient",
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
    p = krglru.plan(B, S, W)
    # what this design moves: x and a_log read by the chunk kernel (all chunks
    # but the last) and again by the out kernel, y and h_last written, and the
    # f32 workspace (P and E written, read by the pass, E rewritten, then read
    # by the out kernel), were none of it held in the L2
    slots = B * (p.n_chunks - 1) * W
    design_bytes = (slots * p.chunk * 6 + x.numel() * (6 + 2) + B * W * 2
                    + slots * (8 + 8 + 4 + 4))
    kern = lambda: krglru.rglru_scan_cuda(x, a_log)  # noqa: E731
    return _row("rglru_scan", "recurrentgemma-9b", launches, errs, card,
                ms=time_ms(kern, iters=20), device_ms=device_ms(kern, RGLRU_KERNELS, iters=20),
                device_ms_per_kernel={ph: device_ms(kern, RGLRU_KERNELS + ph, iters=20)
                                      for ph in RGLRU_PHASES},
                plain_ms=time_ms(lambda: ref.rglru_scan(x, a_log), iters=2, warmup=1),
                bound_ms=b_ms, bound_by=b_by,
                design_floor_ms=design_bytes / HBM_BYTES_PER_S * 1e3, library_ms=None,
                library="none: no single PyTorch call computes an RG-LRU scan",
                shape={"B": B, "S": S, "W": W, "x": "bfloat16", "a_log": "float32",
                       "bytes": nbytes, "design_bytes": design_bytes,
                       "plan": p._asdict()})


def run_times(launches, errs, card, dev):
    rows = [time_flash("qwen3-1.7b", launches, errs, card, dev),
            time_decode("qwen3-1.7b", launches, errs, card, dev),
            time_ssd(launches, errs, card, dev),
            time_rglru(launches, errs, card, dev),
            time_flash("recurrentgemma-9b", launches, errs, card, dev),
            time_decode("recurrentgemma-9b", launches, errs, card, dev),
            time_flash("mixtral-8x7b", launches, errs, card, dev),
            time_decode("phi4-mini-3.8b", launches, errs, card, dev),
            time_decode("llama4-maverick-400b-a17b", launches, errs, card, dev),
            time_flash(TRAIN_LABEL, launches, errs, card, dev),
            time_flash_bwd(launches, errs, card, dev),
            time_ssd_bwd(launches, errs, card, dev),
            time_gather(launches, errs, card, dev, gather_host(dev, card)["launch_floor_ms"]),
            time_epoch_pass(launches, errs, card, dev)]
    gather_sweep(dev, card)
    emit("flash_forward_rate", [
        {"name": r["name"], "ms": r["ms"], "tflop_per_s": r["tflop_per_s"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "bound_tflop_per_s": r["flops"] / r["bound_ms"] / 1e9, "card": r["card"]}
        for r in rows if r["name"].startswith("flash_attention (")])
    emit("flash_backward_rate", [
        {"name": r["name"], "ms": r["ms"], "tflop_per_s": r["tflop_per_s"],
         "flops": r["flops"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "bound_tflop_per_s": r["flops"] / r["bound_ms"] / 1e9,
         "what": "10 Dh FLOP per visible (query, key) pair and head: the 5 products "
                 "a fused backward needs; the kernels do 7", "card": r["card"]}
        for r in rows if r["name"].startswith("flash_attention_bwd")])
    emit("decode_rate", [
        {"name": r["name"], "kv_bytes": r["kv_bytes"], "device_ms": r["device_ms"],
         "ms": r["ms"], "device_gb_per_s": r["kv_bytes"] / r["device_ms"] / 1e6,
         "wrapper_gb_per_s": r["kv_bytes"] / r["ms"] / 1e6,
         "hbm_gb_per_s": HBM_BYTES_PER_S / 1e9, "card": r["card"]}
        for r in rows if r["name"].startswith("decode_attention (")])
    for r in rows:
        # the kernel's launches on every main path of this run
        kernel = r["name"].split(" (")[0]
        r["launches_all_paths"] = {path: n[kernel] for path, n in launches.items()
                                   if n.get(kernel)}
        emit("time", r)
        # a yardstick must compute the kernel's function on the same inputs
        agree = r.get("library_vs_kernel_max_abs", r.get("library_vs_kernel_rel_rms"))
        if r["library_ms"] is not None and not agree[1]:
            fail(f"{r['name']}: the library call disagrees with the kernel")
    return rows


def run_arch(arch, dev, card):
    """Serve, trace and serve_vs_plain for one arch at full width (depth cut
    where DEPTH says); returns the serve run's launch counts. The served
    params are freed before the f32 copy is run, and before the next arch."""
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    if arch in DEPTH:
        cfg = cfg.replace(n_layers=DEPTH[arch])
    torch.cuda.reset_peak_memory_stats(dev)
    params = serve.init_params(cfg, SERVE["seed"], dev)
    served = run_serve(cfg, params, dev, card)
    run_trace(cfg, params, dev)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE["batch"], PROMPT[arch]),
                           generator=gen).to(dev)
    out = {"arch": arch, "bfloat16": serve_vs_plain(cfg, params, prompt)}
    c32, p32 = f32_copy(cfg, params)
    del params
    torch.cuda.empty_cache()
    if out["bfloat16"]["ok"]:
        out["float32"] = (serve_vs_plain(c32, p32, prompt) if c32 is not None else
                          {"ok": True, "not_run": "no f32 copy fits the card; its kernels "
                           "are checked in f32 at this arch's shapes (check)"})
    del p32
    torch.cuda.empty_cache()
    emit("serve_vs_plain", out)
    for name in ("bfloat16", "float32"):
        if name in out and not out[name]["ok"]:
            fail(f"{arch}: serving with kernels disagrees with the plain versions in {name}: "
                 f"{out[name]}")
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
    emit("flash_forward_digest", forward_digest(dev))
    launches = {}
    launches["bench"], errs[("burst_gather", "bench")] = run_gather(dev)
    errs[("epoch_pass", SIM_LABEL)] = run_epoch_checks(dev)
    launches.update(run_simulate(dev, card))
    launches.update(run_experiments(card))
    errs.update({(name, TRAIN_LABEL): e for name, e in run_flash_bwd_checks(dev).items()})
    errs[("ssd_scan_bwd", SSM_TRAIN_LABEL)] = run_ssd_bwd_checks(dev)
    launches.update({arch: run_arch(arch, dev, card) for arch in PROMPT})
    for arch in TRAIN_FEEDS:
        launches[f"{arch} train"] = run_train(dev, card, arch)
        run_train_vs_plain(dev, arch)
    run_restart(dev)
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
