"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:

1. device: name, capability, torch and CUDA versions, nvidia-smi's name and
   power limit;
2. build: the nine CUDA sources under src/repro_torch/kernels/csrc, one nvcc
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
   groups 3, 4, 5 and 6 at head_dim 128 (the plain attention in blocks of
   query rows where its scores would not fit), and flash at head_dim 80
   and 96 (run on the head_dim 128
   body with zero columns) with ragged Sq and Skv under q_offset, at head_dim
   80 bidirectional (hubert-xlarge's encode shape and a ragged one); decode
   at groups 1 to 16, rows of len 0 (exactly 0), 1, a key either side of a
   64-key tile edge and C, C not a multiple of the tile, and head_dim 24
   (the mma body) and 20 (the FMA body, in bf16 too), and a rank's 2048
   slots of qwen3-1.7b's decode_32k cache at model 16 (every head); at each
   case decode's logsumexp too, against the plain float64 one (within 1e-4
   (1 + |lse|), -inf on rows of len 0), the output bitwise the same whether
   it is asked for or not;
   kv_seq_merge: context-sharded decode's arithmetic at qwen3-1.7b's,
   phi4-mini-3.8b's and recurrentgemma-9b's decode shapes: the cache cut
   into 2, 4 and 16 slot shares, the kernel on each share with its own
   valid count, the partials merged by their logsumexps
   (axes.merge_partials), against the kernel's whole call at decode's
   bounds, rows of len 0 exactly 0;
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
   n = 1 to 2^24 frames (the 512-frame tile's edges, the bench epoch of
   63 343), on consecutive calls of n 2^16, 1, 63 343 and 2049 (through
   ops.epoch_pass and through the engine's make_pass("cuda"), whose arrays
   stay as returned after the next call), on inputs 8 bytes off a 16-byte
   boundary and on the edge cases (no frames, one, a burst of equal times,
   a wire busy past every frame, the ideal wire, negative flow ids), and a
   flow id out of range raising IndexError;
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
   seconds of each engine, and a histogram of the kernel's n by tiles;
   serving_sim and serving_sim_counts: benchmarks/fig_serving.py's five
   serving topologies (QPS 2 000, 8 000 and 24 000 at 2 000 ns per prefill
   token with one client, the KV incast onto one decode replica, decode1
   failing at a quarter of the 2 ms trial) through the port's
   run_topology_experiment on the card's host: sent and received requests,
   TTFT p50/p99, TPOT p50, the switch drops and stranded requests, wall
   seconds and simulated requests per wall second, and the sha256 of each
   report, which must equal its pin (SERVING_DIGESTS, the JAX package's
   reports); every kernel counter and the plain counter stay 0 across the
   phase, since serving never reaches the epoch pass;
   flash_forward_digest: a sha256 over the forward's outputs and
   logsumexp at those cases and the train shape, f32 and bf16 (two trees
   with equal digests on one card compute bitwise-equal forwards);
   flash_bwd: dq, dk, dv of the flash kernels' autograd.Function against
   autograd through the plain ref.mha (f32: max abs <= 1e-4 (1 + max |ref|);
   bf16: relative RMS <= 2e-2), and of the backward kernel alone against
   ref.mha_bwd on the same out and lse (f32 the same bound; bf16 each
   gradient within a relative RMS of 1e-2), two calls bitwise equal, on
   causal, window, GQA group 2 and 16, q_offset > 0, rows with no visible
   key, mixtral-8x7b's train shape (group 4 at Dh 128, S 4608 under a
   4096-key window), Dh 80 and 96 (on the Dh 128 body; Dh 80 also bidirectional, ragged
   and at hubert-xlarge's train shape), GQA group 6, Dh 160 and 192 (on the Dh 256
   body), Dh 256 with ragged Sq and Skv under q_offset and with rows that see
   no key, Dh 256 with enough kv tiles for one head subset a tile, Dh 160
   with group 3 in subsets of 1 and 2 heads, ragged Sq and Skv,
   recurrentgemma-9b's train shape (group 16 at
   Dh 256, S 3072 under a 2048-key window) and qwen3-1.7b's train shape;
   the forward's logsumexp against
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
   rglru_bwd: dx, da_log and dh0 of the RG-LRU scan's autograd.Function
   against autograd through the plain ref.rglru_scan (f32: max abs <= 1e-4
   (1 + max |ref|); bf16: relative RMS <= 2e-2), and of the backward kernel
   alone against ref.rglru_scan_bwd on the same inputs and the forward's
   saved workspace (f32 the same bound; bf16 within a relative RMS of 1e-2),
   two calls bitwise equal, on recurrentgemma-9b's train shape, S not a
   multiple of the 64-step chunk and S inside one chunk, W not a multiple of
   the 32-channel tile, h0 given and not, a cotangent on the final state
   and none, rows of a_log = 0 (the clamp) and a_log very negative;
   rglru_bwd_digest: a sha256 over the backward kernel's dx, da_log and dh0
   at those cases, f32 and bf16, and each case's own (two trees with equal
   digests on one card compute bitwise-equal gradients; rglru_bwd_bits
   prints it, the kernel's time and recurrentgemma-9b's train losses for a
   tree named on PYTHONPATH, such as a git archive of the parent);
4. per arch — qwen3-1.7b, mamba2-1.3b, recurrentgemma-9b, granite-8b,
   phi4-mini-3.8b, llama3.2-3b, mixtral-8x7b (16 of 32 layers),
   llama4-maverick-400b-a17b (2 of 48 layers: one dense and one MoE layer)
   and internvl2-26b (48 layers; each batch's 256 image patches before its
   512-token prompt, so prefill runs 768 positions and decode from 768),
   each at full width with random weights from seed 0, its params freed
   before the next — serve: 8 requests in batches of 4, 32 generated tokens,
   greedy, through repro_torch.launch.serve, with every launch counter set
   to 0 just before and read just after: the counts must be exactly those of
   EXPECTED and the plain-version counter 0; the peak device memory since
   the params were made;
   trace: device busy and idle share of one prefill and of decode steps,
   and the decode kernels' and the SSD scan's share of them; the profiler
   drops kernel events, so each counted kernel's mean event time is scaled
   by its launches (the wrapper counters), as trace_train and device_ms
   scale them, and the busy time and idle share are given corrected for
   the lost events too;
   serve_vs_plain: prefill and teacher-forced decode logits with the kernels
   against the same model on the plain versions (attention in blocks of
   query rows where its scores would not fit; in MoE layers the plain run
   takes the kernels' run's expert choices, as decode takes its tokens, and
   counts the tokens whose own choice differs), on the card, in bf16 and then,
   the served params freed, in f32 (recurrentgemma-9b's f32 copy keeps one
   pattern unit and the tail, mixtral-8x7b's 4 layers; llama4-maverick's
   does not fit, and its f32 check is the kernels' at its shapes;
   internvl2-26b's keeps 8 layers);
   encode and encode_vs_plain: hubert-xlarge (the encoder: no decode step)
   at full width, 48 layers, lm.prefill of 4 x 2048 f32 frames with the
   counters set to 0 just before (exactly 48 flash calls, 0 plain), its
   median over 5 calls, and its logits at the last frame and every layer's
   cached keys against the plain versions, bf16 and f32 (all 48 layers,
   3.8 GB), bounds as serve_vs_plain's;
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
   device time and idle share; and for recurrentgemma-9b, bypass feed only,
   cut to 6 of its 38 layers (two (rglru, rglru, attn) units, 35.9 GB of
   training state), 8 steps of 4 x 3072 tokens so that its 2048-key window
   cuts keys (exactly 32 flash forwards, 16 flash backwards, 64 rglru_scan
   and 32 rglru_scan_bwd launches), its peak memory, profiled for the four
   kernels' device time; and hubert-xlarge whole (48 layers, 15.1 GB of
   training state), 8 steps of 4 x 2048 f32 frames (41.9 MB a batch) once
   per feed, exactly 768 flash forwards and 384 backwards each, losses
   bitwise equal, feed wait, put ms and bytes per batch; and mixtral-8x7b
   (the moe family) at full width, cut to 2 of its 32 layers (3.165 B
   params, 50.6 GB of training state), bypass feed only, 8 steps of 2 x 4608
   tokens so that its 4096-key window cuts keys (exactly 32 flash forwards
   and 16 backwards), with per step the host time to issue it and its
   device time between two CUDA events; its routing over the 8 steps
   (train_routing: per layer the share of assignments dropped at capacity,
   the aux loss of each forward, and the tokens whose recompute under
   torch.utils.checkpoint routed otherwise than its forward, which must be
   0), one more step's peak memory and time per phase (train_phases:
   forward, loss, backward, optimizer, the card synchronised and the peak
   reset at each bound) and the loss and every gradient of one step taken
   twice, which must be bitwise equal (train_repeat); trace_train
   scales each counted kernel's mean
   event time by its launches in the step (the wrapper counters), as
   device_ms does, since the profiler drops events, and gives the largest
   elementwise, fill, add and indexing kernels, and for mixtral-8x7b the
   expert products' (aten::bmm's kernels') share of the busy time;
   train_vs_plain, for each of the five trained archs and internvl2-26b
   (whose 318 GB of training state does not fit; its batch is the
   pipeline's 256 patches and 1792 text tokens, the patch labels -100): one
   step's loss and every gradient with the kernels against the plain
   versions, f32, full width, 4 layers (recurrentgemma-9b: one unit and the
   tail's RG-LRU layer, at S 3072; mixtral-8x7b: one layer, 21 GB of
   params and both gradient trees, its plain run taking the kernels' run's
   expert choices, recomputes included, the tokens whose own choice differs
   counted), with non-zero gradients on the leaves that only the backward
   kernels reach;
   sharding (after mixtral-8x7b's train cell): the port's mesh layer on a
   process group of this process alone (NCCL on a free local port), a (1, 1)
   ("data", "model") mesh from launch.mesh.make_smoke_mesh and
   single_pod_rules, so that every param is a DTensor gathered where it is
   read and the MoE layers take the sharded path; one mixtral-8x7b MoE layer
   at full width on 2 x 4608 bf16 tokens in the gather and the
   weight-stationary mode against moe_local (outputs, aux loss and one
   backward's gradients bitwise equal), then the train cell again on the
   mesh with the counters set to 0 just before (8 losses and grad norms
   bitwise equal to the unsharded run's, 32 flash forwards and 16
   backwards, 0 plain calls), its step, device and issue times and peak
   beside the unsharded run's and one traced step; the group is destroyed
   at the end of the phase;
   recurrent_sharding (after the train cells): one train step each of
   mamba2-1.3b (48 layers) and recurrentgemma-9b (6 layers) at their train
   shapes, without a mesh and on a (1, 1) NCCL mesh under single_pod_rules,
   the counters set to 0 just before each: loss and every gradient bitwise
   equal, the same launches, 0 plain calls (a model axis of 1 splits no
   recurrent block);
   restart: 6 steps against 4 steps and a resume to 6 in a fresh runtime
   (smoke config, f32, checkpoints under build/), steps 5 and 6 within 1e-4;
   dryrun (run_dryrun): both digests through the kernels' torch.library ops
   equal to the bare launchers' and their pins (ops_bits); the host us of a
   qwen3-1.7b decode call through the wrapper, the op and the bare launcher
   (decode_host); qwen3-1.7b and mixtral-8x7b (16 of 32 layers) prefilled
   and decoded 32 greedy steps on a (1, 1) NCCL mesh, logits and tokens
   bitwise the unsharded run's, launches, TTFT and TPOT of both
   (mesh_serve); five real steps (CALIBRATION) counted by the dry run's op
   counter, their counts equal to the same steps on fake tensors
   (fake_calibration, a process of its own), each roofline bound under its
   CUDA-event time, the predicted peak beside the measured one
   (calibration); and the production cells of DRYRUN_CELLS through
   python -m repro_torch.launch.dryrun (dryrun_cell, dryrun_summary), among
   them phi4-mini-3.8b's decode_32k at (16, 16), whose 24 heads do not split
   over 16 while its cache's slots do (kv_seq);
6. times: each kernel at the shapes of its main path (serve, train, the
   gather's benchmark; the flash backward and the RG-LRU backward also at
   recurrentgemma-9b's train shape, the flash backward's yardstick there
   SDPA under the window mask; the flash forward and backward at
   hubert-xlarge's and mixtral-8x7b's train shapes and the forward and decode at internvl2-26b's
   serve shapes, with the body's head dim beside Dh: Dh 80 runs the Dh 128
   body, 1.6x the arithmetic the bound counts; every SDPA yardstick with the
   backend that ran it; CUDA events; the flash forward, the gather, decode, the SSD
   scan and its backward, the flash backward and the RG-LRU backward also
   their device time from the profiler, decode, the SSD scan and its
   backward, the flash backward (row dots, dK/dV, the head subsets' sum
   where it runs, dQ) and the RG-LRU backward per kernel, the flash
   backward's SDPA yardstick also the SDPA backend that ran it (named from
   its kernels in a trace), decode with the L2 flushed before each
   call too, SDPA's the same way; the SSD scan and its backward also their
   FMA floor, their FLOP over the 67 TFLOP/s of f32 FMAs, and the backward
   its design's floor, its bf16 mma FLOP (split terms counted) over the
   989 TFLOP/s of the tensor cores plus the rest over the FMA rate), its plain
   version, a PyTorch call
   computing the same function where there is one (checked against the
   kernel), and the bound;
   before them, one line with the flash forward's achieved TFLOP/s at its
   three shapes beside the bound's, one with the backward's at the two train
   shapes, and one (decode_rate) with decode's achieved GB/s over the valid
   K and V bytes beside the HBM's 3.35 TB/s; gather_host: the host us per
   call of each stage of the gather's wrapper at the benchmark shape
   (time.perf_counter over 1000 calls), and the floors torch.empty and
   torch.empty + fill_(0) timed as the wrapper is (launch_floor_ms, also in
   the gather's row); gather_sweep: the
   gather at bursts of 32 to 1024 packets and the whole ring of 4096, each
   checked exactly, by wrapper time, device time warm and with the L2
   flushed, beside the byte bound and the achieved GB/s; the epoch pass at
   the bench shape's first epoch also by the device time of its one
   kernel, beside a launch-and-read-back floor (torch.empty + fill_ +
   tolist), the pass as the engine calls it (numpy in and out, the copies
   included; engine_pass_ms) with its host-clock split into staging,
   upload, kernel with read-back and download (each step synchronised
   alone), and the numpy pass, on the host clock;
   then the kernels at one rank's share under tensor parallelism, checked
   (after the RG-LRU backward's digest: run_tp_scan_checks for the scans)
   and timed as above (tp_time, tp_times; not in the kernels line): the
   flash forward, backward and decode at one rank's heads (TP_PREFILL,
   TP_TRAIN, TP_DECODE), decode at one rank's slots of every head with the
   logsumexp (KV_SEQ_DECODE: qwen3-1.7b's decode_32k rows, 2048 of 32 768
   slots) and the SSD and RG-LRU scans and their backward at one rank's
   share at model 16 (TP_SSD, TP_SSD_TRAIN, TP_RGLRU, TP_RGLRU_TRAIN).

More entry points (see their docstrings): epoch_pass_bits() and
rglru_bwd_bits(), for the tree whose src is first on PYTHONPATH;
epoch_tile_sweep(), the epoch pass built at other tile shapes;
moe_train_bits(), mixtral-8x7b's train cell alone; tp_bits(), the kernels
at one rank's share alone; recurrent_sharding_bits(), the
recurrent_sharding phase alone; and kv_seq_bits(), decode's logsumexp and
kv_seq_merge alone.

The last three lines are the card's name and power limit, the kernel table
and {"ok": true, "device": ...}. Any failed check exits non-zero before them.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# after PYTHONPATH, so that a tree named there (a git archive of the parent)
# is the one imported: see rglru_bwd_bits
sys.path.append(str(ROOT / "src"))

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
LSE_TOL = 1e-4  # decode's logsumexp: of 1 + |lse|, against the plain float64 one
SOURCES = ["flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
           "flash_attention_bwd", "burst_gather", "ssd_scan_bwd", "epoch_pass",
           "rglru_scan_bwd"]
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
RGLRU_BWD_KERNELS = "rglru_bwd_"  # the name part of the RG-LRU backward's kernel
RGLRU_BWD_PHASES = ("onepass",)  # its name after it
# the RG-LRU backward against autograd through the plain scan (f32 max abs
# within 1e-4 (1 + max |ref|), bf16 relative RMS 2e-2: the plain forward
# rounds only y and h_last, the kernels dx too) and, alone on the forward's
# workspace, against ref.rglru_scan_bwd (bf16 1e-2: both compute in f32 and
# round dx; the kernel reassociates only the carry into each chunk). A wrong
# decay, carry or chunk edge moves a gradient by order 100%.
RGLRU_BWD_F32_TOL, RGLRU_BWD_BF16_REL_RMS, RGLRU_BWD_VS_PLAIN_BF16_REL_RMS = 1e-4, 2e-2, 1e-2
SERVE = dict(requests=8, batch=4, gen_len=32, seed=0)
# mixtral-8x7b's prompt passes its 4096-token window, so prefill rotates the
# ring cache and every decode step overwrites its oldest slot
# internvl2-26b's prompt is 512 text tokens after its config's 256 image
# patches: prefill runs a fused sequence of 768 (prompt_batch)
PROMPT = {"qwen3-1.7b": 512, "mamba2-1.3b": 2048, "recurrentgemma-9b": 3072,
          "granite-8b": 512, "phi4-mini-3.8b": 512, "llama3.2-3b": 512,
          "mixtral-8x7b": 4608, "llama4-maverick-400b-a17b": 512, "internvl2-26b": 512}
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
    "internvl2-26b": {"flash_attention": 96, "decode_attention": 3072},
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
# flip their top 2 and its relative RMS is 0.33; 0.080 internvl2-26b over 48
# layers; hubert-xlarge's encode 0.016 on its logits and 0.013 on its cached
# keys, over 48 bidirectional layers), while a wrong mask, head, slot or
# decay moves the logits by order 100%. f32 is the tight check (summation
# order only).
SERVE_BF16_REL_RMS = {"qwen3-1.7b": 0.05, "mamba2-1.3b": 0.08, "recurrentgemma-9b": 0.08,
                      "granite-8b": 0.1, "phi4-mini-3.8b": 0.09, "llama3.2-3b": 0.08,
                      "mixtral-8x7b": 0.1, "llama4-maverick-400b-a17b": 0.02,
                      "internvl2-26b": 0.16, "hubert-xlarge": 0.035}
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


def fresh_peak(dev):
    """Free what the phases before left, then reset the peak to what is
    still allocated. A train step leaves its layers' params and inputs in
    reference cycles (torch.utils.checkpoint's recompute closures) that only
    the garbage collector frees: up to 7 GB after an f32 train_vs_plain,
    which the next phase's first peak counted."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


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
                                     rglru_scan_bwd, ssd_scan, ssd_scan_bwd)
    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "ssd_scan": ssd_scan, "rglru_scan": rglru_scan,
            "flash_attention_bwd": flash_attention_bwd, "burst_gather": burst_gather,
            "ssd_scan_bwd": ssd_scan_bwd, "epoch_pass": epoch_pass,
            "rglru_scan_bwd": rglru_scan_bwd}


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
    (2, 300, 300, 4, 4, 80, False, 0, 0),     # bidirectional MHA at Dh 80, ragged S
    (2, 300, 300, 12, 2, 128, True, 0, 0),    # GQA group 6, ragged S
    (4, 768, 768, 48, 8, 128, True, 0, 0),    # internvl2-26b prefill: 256 patches + 512 text
    (4, 2048, 2048, 16, 16, 80, False, 0, 0),  # hubert-xlarge encode: 2048 frames, Dh 80
    # one rank's heads under tensor parallelism over a model axis of 16
    (4, 512, 512, 2, 1, 128, True, 0, 0),     # granite-8b prefill: 2 q heads on 1 kv head
    (4, 768, 768, 3, 1, 128, True, 0, 0),     # internvl2-26b prefill: 3 on 1
    (4, 2048, 2048, 1, 1, 128, True, 0, 0),   # qwen3-1.7b train: 1 on 1
    (2, 4608, 4608, 2, 1, 128, True, 4096, 0),  # mixtral-8x7b train: 2 on 1, window 4096
]
DIGEST_CASES = 15  # forward_digest's cases: those it covered when first recorded
FLASH_SERVE = {"qwen3-1.7b": FLASH_CASES[13], "recurrentgemma-9b": FLASH_CASES[14],
               "granite-8b": FLASH_CASES[15], "phi4-mini-3.8b": FLASH_CASES[16],
               "llama3.2-3b": FLASH_CASES[16], "llama4-maverick-400b-a17b": FLASH_CASES[17],
               "mixtral-8x7b": FLASH_CASES[18], "internvl2-26b": FLASH_CASES[21]}
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
    (4, 800, 48, 8, 128, (1, 300, 800, 785)),  # internvl2-26b: group 6, 768 + 32 slots
    # one rank's heads under tensor parallelism
    (4, 544, 2, 1, 128, (1, 200, 544, 377)),  # granite-8b at model 16: 2 q heads on 1 kv head
    (4, 800, 3, 1, 128, (1, 300, 800, 785)),  # internvl2-26b at model 16: 3 on 1
    (4, 544, 4, 2, 128, (1, 200, 544, 377)),  # qwen3-1.7b at model 4: 4 on 2
    # a rank's slots under context-sharded decode (kv_seq): qwen3-1.7b's
    # decode_32k rows at model 16, 2048 of 32 768 slots, every head
    (8, 2048, 16, 8, 128, (2048, 2048, 2048, 2048, 1000, 64, 1, 0)),
]
# one rank's heads under tensor parallelism (model 16, and 4 for qwen3-1.7b)
TP_PREFILL = {"granite-8b, model 16": FLASH_CASES[23], "internvl2-26b, model 16": FLASH_CASES[24]}
TP_DECODE = {"granite-8b, model 16": DECODE_CASES[16], "internvl2-26b, model 16": DECODE_CASES[17],
             "qwen3-1.7b, model 4": DECODE_CASES[18]}
# one rank's share of the slots under context-sharded decode (kv_seq)
KV_SEQ_DECODE = {"qwen3-1.7b, kv_seq 16 of decode_32k": DECODE_CASES[19]}
DECODE_SERVE = {"qwen3-1.7b": DECODE_CASES[9], "recurrentgemma-9b": DECODE_CASES[10],
                "granite-8b": DECODE_CASES[11], "phi4-mini-3.8b": DECODE_CASES[12],
                "llama3.2-3b": DECODE_CASES[12], "llama4-maverick-400b-a17b": DECODE_CASES[13],
                "mixtral-8x7b": DECODE_CASES[14], "internvl2-26b": DECODE_CASES[15]}
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
# one rank's share of the recurrent blocks under tensor parallelism at model
# 16 (lists of their own: SSD_TRAIN, RGLRU_TRAIN and rglru_bwd_digest index
# and pin the lists above): mamba2-1.3b's 4 of 64 SSD heads, and
# recurrentgemma-9b's 256 of 4096 RG-LRU columns, at their train and
# prefill shapes
TP_SSD = {"mamba2-1.3b prefill, model 16": (4, 2048, 4, 64, 128, 256, False)}
TP_RGLRU = {"recurrentgemma-9b prefill, model 16": (4, 3072, 256, False)}


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
            for arch, c in {**FLASH_SERVE, **TP_PREFILL}.items():
                if case == c and dtype == torch.bfloat16:
                    worst[("flash_attention", arch)] = err
            del q, k, v, got, want
    for case in DECODE_CASES:
        for dtype, tol in zip(dtypes, (F32_TOL, BF16_TOL)):
            q, kc, vc, cl = decode_inputs(case, dtype, dev)
            got = ops.decode_attention(q, kc, vc, cl)
            want, want_lse = ref.decode_attention(q, kc, vc, cl, return_lse=True)
            # the logsumexp beside the output, whose bits must not move
            got2, lse = ops.decode_attention(q, kc, vc, cl, return_lse=True)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, tol)
            empty = [i for i, n in enumerate(case[5]) if n == 0]
            lse_err, lse_ok = lse_check(lse, want_lse, empty)
            out = {"max_abs_err": err, "tol": tol,
                   "empty_rows_zero": int(torch.count_nonzero(got[empty])) == 0,
                   "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
                   "output_bitwise_with_lse": torch.equal(got, got2)}
            if dtype == torch.bfloat16:
                out["rel_rms"] = rel_rms(got, want)
                out["bound_rel_rms"] = DECODE_BF16_REL_RMS
                ok = ok and out["rel_rms"] <= DECODE_BF16_REL_RMS
            ok = ok and out["empty_rows_zero"] and lse_ok and out["output_bitwise_with_lse"]
            _check("decode_attention", case, dtype, out, ok, "")
            for arch, c in {**DECODE_SERVE, **TP_DECODE, **KV_SEQ_DECODE}.items():
                if case == c and dtype == torch.bfloat16:
                    worst[("decode_attention", arch)] = err
    for case in SSD_CASES:
        for dtype in dtypes:
            ep = check_ssd(case, dtype, dev)
            if case == SSD_CASES[0] and dtype == torch.bfloat16:
                worst[("ssd_scan", "mamba2-1.3b")] = ep
    for case in RGLRU_CASES:
        for dtype in dtypes:
            err = check_rglru(case, dtype, dev)
            if case == RGLRU_CASES[0] and dtype == torch.bfloat16:
                worst[("rglru_scan", "recurrentgemma-9b")] = err
    return worst


def lse_check(got, want, empty):
    """The kernel's logsumexp (B, H) against the plain version's (float64,
    as f32): -inf exactly on the rows of length 0, elsewhere within LSE_TOL
    (1 + |want|); returns (max abs error off the empty rows, ok)."""
    full = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    full[empty] = False
    ok = bool(torch.isneginf(got[~full]).all()) and bool(torch.isfinite(got[full]).all())
    diff = (got[full] - want[full]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    return err, ok and bool((diff <= LSE_TOL * (1 + want[full].abs())).all())


# kv_seq_merge: each arch's decode shape (DECODE_SERVE) cut into m slot
# shares, the kernel on each share with its own valid count, the partials
# merged by their logsumexps (axes.merge_partials), held to the whole call
KV_SEQ_MERGE = ("qwen3-1.7b", "phi4-mini-3.8b", "recurrentgemma-9b")
KV_SEQ_SHARES = (2, 4, 16)


def run_kv_seq_merge(dev):
    """Context-sharded decode's arithmetic on the card: for each arch of
    KV_SEQ_MERGE and m of KV_SEQ_SHARES, f32 and bf16, the merge of the m
    shares' kernel calls against the kernel's whole call (f32 max abs
    within F32_TOL; bf16 within BF16_TOL and a relative RMS of
    DECODE_BF16_REL_RMS; rows of length 0 exactly 0) and, for the record,
    against the plain whole call."""
    from repro_torch.kernels import ops, ref
    from repro_torch.parallel.axes import merge_partials
    for arch in KV_SEQ_MERGE:
        case = DECODE_SERVE[arch]
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, kc, vc, cl = decode_inputs(case, dtype, dev)
            whole = ops.decode_attention(q, kc, vc, cl)
            plain = ref.decode_attention(q, kc, vc, cl)
            empty = [i for i, n in enumerate(case[5]) if n == 0]
            for m in KV_SEQ_SHARES:
                n = kc.shape[1] // m
                parts = [ops.decode_attention(q, kc[:, r * n:(r + 1) * n].contiguous(),
                                              vc[:, r * n:(r + 1) * n].contiguous(),
                                              torch.clamp(cl - r * n, 0, n).to(torch.int32),
                                              return_lse=True) for r in range(m)]
                got = merge_partials(torch.stack([o for o, _ in parts]),
                                     torch.stack([s for _, s in parts])).to(dtype)
                torch.cuda.synchronize()
                err, ok = max_err(got, whole, tol)
                out = {"arch": arch, "shares": m, "dtype": str(dtype), "case": case,
                       "max_abs_err": err, "tol": tol,
                       "plain_max_abs_err": max_err(got, plain, tol)[0],
                       "empty_rows_zero": int(torch.count_nonzero(got[empty])) == 0}
                if dtype == torch.bfloat16:
                    out["rel_rms"] = rel_rms(got, whole)
                    out["bound_rel_rms"] = DECODE_BF16_REL_RMS
                    ok = ok and out["rel_rms"] <= DECODE_BF16_REL_RMS
                out["ok"] = ok and out["empty_rows_zero"]
                emit("kv_seq_merge", out)
                if not out["ok"]:
                    fail(f"kv_seq_merge {arch} m {m} {dtype}: {out}")


def check_ssd(case, dtype, dev):
    """The SSD scan at ``case`` against the sequential oracle and the plain
    chunked version; returns the max abs error against the plain version."""
    from repro_torch.kernels import ops, ref
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
    return ep


def check_rglru(case, dtype, dev):
    """The RG-LRU scan at ``case`` against the plain version; returns the
    larger max abs error of y and h_last."""
    from repro_torch.kernels import ops, ref
    tol = RGLRU_TOL[dtype]
    x, a_log, h0 = rglru_inputs(case, dtype, dev)
    y, hl = ops.rglru_scan(x, a_log, h0=h0)
    yp, hp = ref.rglru_scan(x, a_log, h0=h0)
    torch.cuda.synchronize()
    ey, oky = max_err(y, yp, tol)
    eh, okh = max_err(hl, hp, tol)
    ok = oky and okh and y.dtype == dtype and hl.dtype == dtype
    _check("rglru_scan", case, dtype, {"y_max_abs": ey, "h_last_max_abs": eh, "tol": tol},
           ok, "")
    return max(ey, eh)


def forward_digest(dev, through_op=False):
    """sha256 over the bytes of the flash forward's output and logsumexp, f32
    and bf16, at the first DIGEST_CASES of FLASH_CASES and the train shape:
    two trees whose digests agree on one card compute bitwise-equal
    forwards. The launcher is called bare, or through its ``torch.library``
    op (``through_op``)."""
    from repro_torch.kernels import flash_attention as kflash
    h = hashlib.sha256()
    cases = FLASH_CASES[:DIGEST_CASES] + [FLASH_TRAIN]
    for case in cases:
        causal, window, q_offset = case[6:]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(case, dtype, dev)
            scale = case[5] ** -0.5
            outs = (kflash.forward_op(q, k, v, causal, window, q_offset, scale, True)
                    if through_op else
                    kflash._forward(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                    softmax_scale=scale, with_lse=True))
            for t in outs:
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

# frames of the exact checks: tile edges (epoch_pass.TILE, 512 a tile), the
# engine's first epoch at the bench shape, and 2^24 in one call (an epoch of
# a long run)
EPOCH_TILE = 512
EPOCH_BENCH_N = 63343
EPOCH_N = (1, 3, 4, 5, EPOCH_TILE - 1, EPOCH_TILE, EPOCH_TILE + 1, 2 * EPOCH_TILE + 1, 2047,
           2048, 2049, EPOCH_BENCH_N, 1 << 24)
# consecutive calls on the device's one workspace, n growing and shrinking
EPOCH_SEQUENCE = (1 << 16, 1, EPOCH_BENCH_N, 2049)
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


def epoch_numpy(h, s, busy0, lat, t, f):
    """The numpy pass on the card's tensors."""
    from repro_torch.kernels import epoch_pass as kep
    host = [None if x is None else x.cpu().numpy() for x in (h, s, t, f)]
    return kep.epoch_pass_np(host[0], host[1], busy0, lat, host[2], host[3])


def run_epoch_checks(dev):
    """The epoch pass kernel exactly equal to its plain version on the card
    and to the numpy pass (the engine's reference), with a table and
    without, on EPOCH_N, EPOCH_SEQUENCE (also through make_pass), inputs
    off a 16-byte boundary and the edge cases; a flow id out of range
    raises IndexError. Returns the largest absolute arrival difference at
    the bench epoch (0 when equal)."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels import epoch_pass as kep
    from repro_torch.kernels import ops, ref
    if not _build.load("epoch_pass").epoch_pass_tile() == kep.TILE == EPOCH_TILE:
        fail(f"epoch_pass: the library's tile, the plan's {kep.TILE} and {EPOCH_TILE} differ")
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
            if n <= EPOCH_BENCH_N:
                ok = ok and epoch_equal(got, epoch_numpy(h, s, busy0, 1000, t, f))
            _check("epoch_pass", {"n": n, "steer": steer}, torch.int64,
                   {"max_abs_err": err, "busy_until": got[1]}, ok, "")
            if n == EPOCH_BENCH_N and steer:
                worst = err
    engine, kept = kep.make_pass("cuda"), []
    for k, n in enumerate(EPOCH_SEQUENCE):
        (h, s, table, fids), busy0 = epoch_inputs(n, dev, seed=100 + k)
        want = epoch_numpy(h, s, busy0, 1000, table, fids)
        host = [x.cpu().numpy() for x in (h, s, table, fids)]
        got = engine(host[0], host[1], busy0, 1000, host[2], host[3])
        ok = epoch_equal(ops.epoch_pass(h, s, busy0, 1000, table, fids), want) and \
            epoch_equal(got, want)
        kept.append((got, [got[0].copy(), got[2].copy()]))
        _check("epoch_pass", {"sequence": k, "n": n}, torch.int64, {"busy_until": want[1]},
               ok, "")
    fresh = all(np.array_equal(g[0], c[0]) and np.array_equal(g[2], c[1]) for g, c in kept)
    _check("epoch_pass", "make_pass arrays unchanged by later calls", torch.int64, {}, fresh,
           "")
    (h, s, table, fids), busy0 = epoch_inputs(5001, dev, seed=9)
    h, s, fids = h[1:], s[1:], fids[1:]  # 8 bytes past a 16-byte boundary
    got = ops.epoch_pass(h, s, busy0, 7, table, fids)
    _check("epoch_pass", "inputs off a 16-byte boundary", torch.int64, {"offset": h.data_ptr() % 16},
           h.data_ptr() % 16 == 8 and epoch_equal(got, epoch_numpy(h, s, busy0, 7, table, fids)),
           "")
    tab = torch.arange(EPOCH_FLOWS, device=dev) % EPOCH_QUEUES
    for name, (h, s, busy0, lat) in EPOCH_EDGES.items():
        h, s = (torch.tensor(x, dtype=torch.int64, device=dev) for x in (h, s))
        ids = (torch.arange(h.numel(), device=dev) * 37) % EPOCH_FLOWS - 3  # -3: from the end
        ok = True
        for t, f in ((tab, ids), (None, None), (tab, None)):
            got = ops.epoch_pass(h, s, busy0, lat, t, f)
            ok = ok and epoch_equal(got, ref.epoch_pass(h, s, busy0, lat, t, f)) \
                and epoch_equal(got, epoch_numpy(h, s, busy0, lat, t, f))
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
    summed, the calls and each call's n."""
    from repro_torch.core import fastpath
    spent = [0.0, 0, []]
    make, numpy_pass = fastpath.make_pass, fastpath.epoch_pass_np

    def timed(fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            spent[2].append(len(args[0]))
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
    return rep.to_dict(), wall, spent[0], spent[1], spent[2]


def tiles_histogram(ns):
    """Calls of the pass by the kernel's tiles (EPOCH_TILE frames each)."""
    bins = {"1": (1, 1), "2-8": (2, 8), "9-32": (9, 32), "33-132": (33, 132),
            "133+": (133, 1 << 62)}
    tiles = [-(-n // EPOCH_TILE) for n in ns]
    return {"calls_by_tiles": {k: sum(lo <= t <= hi for t in tiles)
                               for k, (lo, hi) in bins.items()},
            "n_min": min(ns, default=0), "n_median": sorted(ns)[len(ns) // 2] if ns else 0,
            "n_max": max(ns, default=0), "calls": len(ns)}


def run_experiments(card):
    """Each figure config through run_experiment once with the numpy pass
    and once with the kernel, every count set to 0 just before the kernel
    run and read just after: the reports (extras and msb_gbps included)
    bit-equal, the kernel's launches equal to the numpy run's pass calls
    (above 0 exactly where experiment_on_fast_path says), no plain call, no
    other kernel. Returns the kernel runs' launches summed, by kernel."""
    total = {}
    reports, walls = {}, {"epoch": 0.0, "epoch-torch": 0.0}
    bad, ns = [], []
    for label, cfg in experiment_configs().items():
        want, np_wall, np_pass_s, np_calls, _ = experiment_run(cfg, "epoch")
        zero_counters()
        got, cu_wall, cu_pass_s, cu_calls, cu_ns = experiment_run(cfg, "epoch-torch")
        ns += cu_ns
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
        "launches": total, "pass_n": tiles_histogram(ns), "card": card}
    emit("experiment_summary", summary)
    if bad:
        fail(f"experiment: the numpy and card runs disagree or miscounted on {bad}")
    return {EXP_LABEL: total}


# --------------------------------------------------------------------------
# serving_sim: the serving layer's topologies on the card's host
# --------------------------------------------------------------------------

SERVING_TRIAL_S = 0.002  # benchmarks/fig_serving.py's trial
SERVING_QPS = (2_000.0, 8_000.0, 24_000.0)  # its sweep across the prefill knee
# sha256 of json.dumps(report.to_dict(), sort_keys=True) for each config of
# serving_configs(): the JAX package's run_topology_experiment gives the same
# reports on the CPU (tests/test_torch_serving.py holds these pins to them)
SERVING_DIGESTS = {
    "qps2000": "239ee3d1d96ed4394ca04694f787b0f7944350e3ca8010913f205af3484cee11",
    "qps8000": "d233cb7b1dff9d49c0eb420e0a500a44e1ba5fcf25c1dfcfd75941e1c30581e4",
    "qps24000": "3d50c940beb4d3bc4914a4bcacbd774bba606d2765a6c8b2ce6d9b91d165c5b2",
    "kv_incast": "59f7ae8f1696277e903cdc4a192b3a1a290149c9974f2ea016f16b58bbab022c",
    "failover": "3e6ce054247a2e60d384cef90dfa4aa1f7679b70fcd614a2d7b190371c337031",
}


def serving_configs():
    """label -> the port's TopologyConfig: benchmarks/fig_serving.py's five
    configurations on the port's classes (the QPS sweep at 2 000 ns per
    prefill token and one client, the KV incast onto one pinned decode
    replica through 16-frame egress buffers at 10 Gbit/s, decode1 failing at
    a quarter of the trial)."""
    from repro_torch.exp import (LinkConfig, NodeConfig, PoolConfig, PortConfig,
                                 StackConfig, SwitchConfig, TopologyConfig, TrafficConfig)
    from repro_torch.serving import RequestMixConfig, ServingConfig

    def serving(**kw):
        base = dict(
            mix=RequestMixConfig(prompt_mean_tokens=64, prompt_dist="fixed",
                                 output_mean_tokens=4, output_dist="fixed"),
            qps=20_000.0, prefill_ns_per_token=200, prefill_overhead_ns=5_000,
            decode_ns_per_token=300, decode_overhead_ns=2_000,
            kv_bytes_per_token=256, kv_segment_bytes=1024,
            max_batch_tokens=2048, max_batch_requests=8)
        base.update(kw)
        return ServingConfig(**base)

    def node(name, kind):
        return NodeConfig(name=name, pool=PoolConfig(n_slots=4096, slot_size=2048),
                          port=PortConfig(n_queues=2, ring_size=512, writeback_threshold=1),
                          stack=StackConfig(kind=kind, burst_size=32))

    def topology(s, n_clients, egress_capacity=256, link_gbps=100.0):
        return TopologyConfig(
            name=f"serving-{s.qps:g}qps",
            nodes=(node("lb", "balancer"), node("prefill0", "prefill"),
                   node("prefill1", "prefill"), node("decode0", "decode"),
                   node("decode1", "decode")),
            n_clients=n_clients, client_pool=PoolConfig(n_slots=4096, slot_size=2048),
            switch=SwitchConfig(egress_capacity=egress_capacity,
                                link=LinkConfig(gbps=link_gbps, latency_ns=1000)),
            traffic=TrafficConfig(duration_s=SERVING_TRIAL_S, seed=7, mode="open_loop",
                                  sim_time=True),
            serving=s)

    out = {f"qps{qps:g}": topology(serving(qps=qps, prefill_ns_per_token=2_000), 1)
           for qps in SERVING_QPS}
    out["kv_incast"] = topology(serving(kv_bytes_per_token=4096, decode=("decode0",)), 2,
                                egress_capacity=16, link_gbps=10.0)
    out["failover"] = topology(serving(fail_node="decode1", fail_at_s=SERVING_TRIAL_S / 4), 2)
    return out


def report_digest(rep):
    return hashlib.sha256(json.dumps(rep.to_dict(), sort_keys=True).encode()).hexdigest()


def run_serving_sim(card):
    """Each of serving_configs() through the port's run_topology_experiment
    on the host, the counters set to 0 before the first run and read after
    the last: each report's digest equal to its pin, and no kernel launch or
    plain call in the phase, since serving never reaches the epoch pass. One
    line a config: requests sent and received, TTFT p50 and p99, TPOT p50,
    the switch drops and the requests lost at the failed replica that
    benchmarks/fig_serving.py reports, the wall seconds and simulated
    requests per wall second."""
    from repro_torch.exp import run_topology_experiment
    bad = []
    zero_counters()
    for label, cfg in serving_configs().items():
        t0 = time.perf_counter()
        rep = run_topology_experiment(cfg)
        wall = time.perf_counter() - t0
        x = rep.extras
        digest = report_digest(rep)
        ok = digest == SERVING_DIGESTS[label]
        emit("serving_sim", {
            "name": label, "sent": rep.sent, "received": rep.received,
            "ttft_p50_ns": x["ttft_p50_ns"], "ttft_p99_ns": x["ttft_p99_ns"],
            "tpot_p50_ns": x["tpot_p50_ns"], "sw_p3_egress_drops": x["sw_p3_egress_drops"],
            "n3_imissed": x["n3_imissed"],
            "n3_decode_reasm_pending": x["n3_decode_reasm_pending"],
            "lost_at_failed": x["n4_decode_failed_drops"] + x["n4_decode_stranded_requests"],
            "n3_decode_requests_done": x["n3_decode_requests_done"],
            "wall_s": wall, "requests_per_wall_s": rep.sent / wall,
            "digest": digest, "pinned": ok, "card": card})
        if not ok:
            bad.append(label)
    counts, plain = read_counters()
    emit("serving_sim_counts", {"launches": counts, "plain_calls": plain})
    if bad:
        fail(f"serving_sim: reports differ from the pinned digests on {bad}")
    if any(counts.values()) or plain:
        fail(f"serving_sim: the serving topologies reached a kernel or a plain version "
             f"({counts}, {plain} plain calls)")


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
    (1, 200, 200, 4, 1, 160, True, 0, 0),     # Dh 160 on the Dh 256 body, zero columns
    (1, 130, 130, 2, 1, 192, False, 0, 0),    # Dh 192, not causal
    (2, 100, 161, 16, 1, 256, True, 64, 61),  # Dh 256, ragged Sq and Skv under q_offset
    (1, 64, 64, 4, 1, 256, True, 0, -16),     # Dh 256, rows with no visible key
    (4, 1100, 1100, 16, 4, 256, True, 0, 0),  # Dh 256, 288 kv tiles: one head subset
    (2, 2112, 2112, 6, 2, 160, True, 512, 0),  # Dh 160, group 3 in subsets of 1 and 2
    (2, 300, 300, 4, 4, 80, False, 0, 0),     # bidirectional MHA at Dh 80, ragged S
    (2, 300, 300, 12, 2, 128, True, 0, 0),    # GQA group 6, ragged S
    # one rank's heads under tensor parallelism over a model axis of 16
    (4, 2048, 2048, 1, 1, 128, True, 0, 0),   # qwen3-1.7b train: 1 q head on 1 kv head
    (2, 4608, 4608, 2, 1, 128, True, 4096, 0),  # mixtral-8x7b train: 2 on 1, window 4096
    # mixtral-8x7b train, full width: group 4 at Dh 128, a window that cuts keys
    (2, 4608, 4608, 32, 8, 128, True, 4096, 0),
    (4, 2048, 2048, 16, 16, 80, False, 0, 0),  # hubert-xlarge train: bidirectional, Dh 80
    # recurrentgemma-9b train, full width: group 16 at Dh 256, a window that cuts keys
    (4, 3072, 3072, 16, 1, 256, True, 2048, 0),
    (4, 2048, 2048, 16, 8, 128, True, 0, 0),  # qwen3-1.7b train, full width
]
FLASH_TRAIN = FLASH_BWD_CASES[-1]
FLASH_TRAIN_RG = FLASH_BWD_CASES[-2]
FLASH_TRAIN_HUBERT = FLASH_BWD_CASES[-3]
FLASH_TRAIN_MIXTRAL = FLASH_BWD_CASES[-4]
TP_TRAIN = {"qwen3-1.7b train, model 16": FLASH_BWD_CASES[-6],
            "mixtral-8x7b train, model 16": FLASH_BWD_CASES[-5]}


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
    """Returns the bf16 max abs errors at the train shapes, keyed by (kernel,
    train label): of the forward output and of the gradients (largest of dq,
    dk, dv)."""
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
            label = {c: lab for lab, c in {**flash_train_cases(), **TP_TRAIN}.items()}.get(case)
            if label is not None and dtype == torch.bfloat16:
                worst[("flash_attention", label)] = e_out
                worst[("flash_attention_bwd", label)] = max(r["max_abs"] for r in
                                                            (res["dq"], res["dk"], res["dv"]))
            if case == FLASH_TRAIN and dtype == torch.bfloat16:
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
    worst = None
    for case, a_scale, dy_scale in [(c, 1.0, 1.0) for c in SSD_BWD_CASES] + SSD_BWD_ADVERSARIAL:
        dtypes = (torch.bfloat16,) if case == SSD_TRAIN else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
            err = check_ssd_bwd(case, dtype, dev, a_scale, dy_scale)
            if case == SSD_TRAIN:
                worst = err
    return worst


def check_ssd_bwd(case, dtype, dev, a_scale=1.0, dy_scale=1.0):
    """The SSD backward at ``case`` through autograd against the plain
    version's, and the kernels alone, twice, against ref.ssd_scan_bwd;
    returns the largest max abs error of the latter over the gradients."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.kernels import ssd_scan_bwd as kbwd
    B, S, H, P, N, chunk, with_h0, with_dh = case
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
    gk = kbwd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk, fwd_workspace=ws)
    gk2 = kbwd.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk, fwd_workspace=ws)
    gm = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    res["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(gk, gk2)
                                    if a is not None)
    res["dh0_iff_h0"] = (gk[5] is None) == (h0 is None)
    res["vs_ssd_scan_bwd"], ok_k = _grad_errs(gk, gm, dtype, SSD_BWD_VS_PLAIN_BF16_REL_RMS)
    ok = ok and ok_k and res["bitwise_repeatable"] and res["dh0_iff_h0"]
    if (a_scale, dy_scale) != (1.0, 1.0):
        res["A_factor"], res["dy_factor"] = a_scale, dy_scale
    _check("ssd_scan_bwd", case, dtype, res, ok, "")
    del x, dy, Bm, Cm, gk, gk2, gm, ws
    torch.cuda.empty_cache()
    return max(v["max_abs"] for v in res["vs_ssd_scan_bwd"].values())


# --------------------------------------------------------------------------
# RG-LRU backward against autograd through the plain version
# --------------------------------------------------------------------------

RGLRU_BWD_CASES = [
    # B, S, W, h0, a cotangent on the final state, a_log ("" drawn, "unit": 0 on
    # every third step, the clamp; "negative": -30 on every seventh, a = 0)
    (4, 3072, 4096, False, False, ""),       # recurrentgemma-9b train, full width
    (3, 1001, 1000, True, True, ""),         # S not a multiple of the chunk, ragged W
    (2, 50, 33, True, True, ""),             # S inside one chunk: the out kernel alone
    (2, 197, 129, False, True, ""),          # W one past a block of 128, no h0
    (2, 300, 256, True, False, ""),          # h0 and no final-state cotangent
    (2, 300, 256, True, True, "unit"),       # rows of a_log = 0
    (2, 300, 256, False, True, "negative"),  # a_log very negative
]
RGLRU_TRAIN = RGLRU_BWD_CASES[0]
# the backward at one rank's share under tensor parallelism (model 16)
TP_SSD_TRAIN = {"mamba2-1.3b train, model 16": (4, 2048, 4, 64, 128, 256, False, False)}
TP_RGLRU_TRAIN = {"recurrentgemma-9b train, model 16": (4, 3072, 256, False, False, "")}


def rglru_bwd_inputs(case, dtype, dev, seed=0):
    B, S, W, with_h0, with_dh, kind = case
    x, a_log, h0 = rglru_inputs((B, S, W, with_h0), dtype, dev, seed=seed)
    if kind == "unit":
        a_log[:, ::3] = 0.0
    elif kind == "negative":
        a_log[:, ::7] = -30.0
    gen = torch.Generator().manual_seed(seed + 1)
    dy = randn(gen, (B, S, W), dtype, dev)
    dh = randn(gen, (B, W), dtype, dev) if with_dh else None
    return x, a_log, h0, dy, dh


def rglru_grads(fn, x, a_log, h0, dy, dh):
    """The gradients (dx, da_log[, dh0]) of <y, dy> + <h_last, dh> through
    ``fn`` by autograd, on fresh leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, a_log)]
    h0l = h0.detach().clone().requires_grad_(True) if h0 is not None else None
    y, hl = fn(*leaves, h0=h0l)
    loss = (y.float() * dy.float()).sum() + ((hl.float() * dh.float()).sum()
                                             if dh is not None else 0)
    return torch.autograd.grad(loss, leaves + ([h0l] if h0l is not None else []))


def _rglru_grad_errs(got, want, dtype, rel_rms_bound):
    res, ok = {}, True
    for name, a, b in zip(("dx", "da_log", "dh0"), got, want):
        if b is None:
            ok = ok and a is None
            continue
        err = float((a.float() - b.float()).abs().max())
        if dtype == torch.float32:
            bound = RGLRU_BWD_F32_TOL * (1 + float(b.float().abs().max()))
            res[name] = {"max_abs": err, "bound_max_abs": bound}
            ok = ok and err <= bound
        else:
            rr = rel_rms(a, b)
            res[name] = {"rel_rms": rr, "bound_rel_rms": rel_rms_bound, "max_abs": err}
            ok = ok and rr <= rel_rms_bound
        ok = ok and bool(torch.isfinite(a).all()) and a.dtype == b.dtype
    return res, ok


def run_rglru_bwd_checks(dev):
    """Returns the bf16 max abs error of the backward kernel against
    ref.rglru_scan_bwd at the train shape (largest over the gradients)."""
    worst = None
    for case in RGLRU_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            err = check_rglru_bwd(case, dtype, dev)
            if case == RGLRU_TRAIN and dtype == torch.bfloat16:
                worst = err
    return worst


def check_rglru_bwd(case, dtype, dev):
    """The RG-LRU backward at ``case`` through autograd against the plain
    version's, and the kernel alone, twice, against ref.rglru_scan_bwd;
    returns the largest max abs error of the latter over the gradients."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as krglru
    from repro_torch.kernels import rglru_scan_bwd as kbwd
    x, a_log, h0, dy, dh = rglru_bwd_inputs(case, dtype, dev, seed=7)
    g = rglru_grads(ops.rglru_scan, x, a_log, h0, dy, dh)
    gp = rglru_grads(ref.rglru_scan, x, a_log, h0, dy, dh)
    torch.cuda.synchronize()
    res, ok = _rglru_grad_errs(g, gp, dtype, RGLRU_BWD_BF16_REL_RMS)
    del g, gp
    # the kernel alone, twice, against ref.rglru_scan_bwd on the forward's workspace
    _, _, ws = krglru._forward(x, a_log, h0)
    gk = kbwd.rglru_scan_bwd_cuda(x, a_log, h0, dy, dh, fwd_workspace=ws)
    gk2 = kbwd.rglru_scan_bwd_cuda(x, a_log, h0, dy, dh, fwd_workspace=ws)
    gm = ref.rglru_scan_bwd(x, a_log, h0, dy, dh)
    torch.cuda.synchronize()
    res["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(gk, gk2)
                                    if a is not None)
    res["dh0_iff_h0"] = (gk[2] is None) == (h0 is None)
    res["vs_rglru_scan_bwd"], ok_k = _rglru_grad_errs(gk, gm, dtype,
                                                      RGLRU_BWD_VS_PLAIN_BF16_REL_RMS)
    ok = ok and ok_k and res["bitwise_repeatable"] and res["dh0_iff_h0"]
    _check("rglru_scan_bwd", case, dtype, res, ok, "")
    del x, a_log, dy, gk, gk2, gm, ws
    torch.cuda.empty_cache()
    return max(v["max_abs"] for v in res["vs_rglru_scan_bwd"].values())


def rglru_bwd_digest(dev, through_op=False):
    """sha256 over the bytes of the RG-LRU backward kernel's dx, da_log and
    dh0 (where h0 is given), f32 and bf16, at every RGLRU_BWD_CASES case (the
    train shape first), each on the forward's workspace of its inputs: two
    trees whose digests agree on one card compute bitwise-equal gradients.
    Each case's own digest too (its first 16 hex digits), to name a case
    where two trees differ. The launcher is called bare, or through its
    ``torch.library`` op (``through_op``)."""
    from repro_torch.kernels import rglru_scan as krglru
    from repro_torch.kernels import rglru_scan_bwd as kbwd
    h, per_case = hashlib.sha256(), []
    for case in RGLRU_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, a_log, h0, dy, dh = rglru_bwd_inputs(case, dtype, dev, seed=7)
            _, _, ws = krglru._forward(x, a_log, h0)
            hc = hashlib.sha256()
            grads = (kbwd.backward_op(x, a_log, h0, dy, dh, ws) if through_op else
                     kbwd.rglru_scan_bwd_cuda(x, a_log, h0, dy, dh, fwd_workspace=ws))
            for t in grads:
                if t is not None:
                    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                    h.update(raw)
                    hc.update(raw)
            per_case.append(hc.hexdigest()[:16])
            del x, a_log, h0, dy, dh, ws
            torch.cuda.empty_cache()
    return {"cases": len(RGLRU_BWD_CASES), "dtypes": ["float32", "bfloat16"],
            "sha256": h.hexdigest(), "per_case": per_case}


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

        def decode(q, kc, vc, cl, *, softmax_scale=None, return_lse=False):
            return ref.decode_attention(q, kc, vc, cl, softmax_scale=softmax_scale,
                                        return_lse=return_lse)

        def ssd(x, dt, A, Bm, Cm, *, chunk=128, h0=None):
            return ref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)

        def rglru(x, a_log, *, h0=None):
            return ref.rglru_scan(x, a_log, h0=h0)

        for name, fn in zip(self.NAMES, (flash, decode, ssd, rglru)):
            setattr(ops, name, fn)

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


def n_patches(cfg):
    """The image patches before a prompt's text (the vlm's frontend), else 0."""
    return cfg.n_patches if cfg.frontend == "vision_patches" else 0


def prompt_batch(cfg, tokens, gen=None):
    """The prefill batch of prompt ``tokens`` (B, S): for the vlm also its
    config's n_patches patches before the text, 0.02 N(0, 1) in the compute
    dtype as launch/serve.py draws them (here from ``gen``), on the tokens'
    device."""
    batch = {"tokens": tokens}
    if n_patches(cfg):
        patches = torch.randn((tokens.shape[0], cfg.n_patches, cfg.d_model), generator=gen)
        batch["patches"] = (patches * 0.02).to(tokens.device, getattr(torch, cfg.compute_dtype))
    return batch


def logits_run(cfg, params, prompt, steps, forced=None):
    """Prefill of the batch ``prompt`` (prompt_batch) + ``steps`` decode
    steps. Decode inputs are ``forced`` tokens when given (teacher forcing),
    else this run's own argmax."""
    from repro_torch.models import lm
    B, S = prompt["tokens"].shape
    S += n_patches(cfg)  # the fused sequence: patches, then text
    logits, cache = lm.prefill(cfg, params, prompt, S + steps)
    outs, toks = [logits.float()], []
    for i in range(steps):
        tok = forced[i] if forced is not None else logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        pos = torch.full((B,), S + i, dtype=torch.int32, device=prompt["tokens"].device)
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
# shapes (run_checks); internvl2-26b's 48 layers are 75 GB in f32, 8 layers
# and the f32 embeddings about 17 GB, made while its 39.7 GB of bf16 params
# are still on the card
F32_LAYERS = {"mixtral-8x7b": 4, "llama4-maverick-400b-a17b": 0, "internvl2-26b": 8}


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


# the kernels of a serve run: (name part of their kernels, counter of their
# wrapper); each kernel name launches once a wrapper call
SERVE_KERNELS = {"flash_attention": ("flash_fwd_", "flash_attention"),
                 "decode_attention": (DECODE_KERNELS, "decode_attention"),
                 "ssd_scan": (SSD_KERNELS, "ssd_scan"),
                 "rglru_scan": (RGLRU_KERNELS, "rglru_scan")}


def counted_events(events, launches, families, exclude=None):
    """The profiler drops kernel events (device_ms), so each family's kernels
    (``families``: name -> (name part, counter), each kernel name launched
    once a wrapper call; ``exclude``: family -> a name part its kernels do
    not have) are counted as device_ms counts them: each name's mean event
    time times its launches, read from the wrapper counters (``launches``),
    or its events where more. ``events``: kernel name -> event µs. Returns
    ({family: ms, ms by kernel, launches, events}, the µs of the events
    lost)."""
    exclude = exclude or {}
    lost_us, counted = 0.0, {}
    for fam, (part, counter) in families.items():
        n = launches[counter]
        names = [k for k in events if part in k and not (fam in exclude and exclude[fam] in k)]
        mean = {k: sum(events[k]) / len(events[k]) for k in names}
        by = {k[:60]: mean[k] * max(n, len(events[k])) / 1e3 for k in names}
        lost_us += sum(max(0, n - len(events[k])) * mean[k] for k in names)
        counted[fam] = {"ms": sum(by.values()), "ms_by_kernel": by, "launches": n,
                        "events": {k[:60]: len(events[k]) for k in names}}
    return counted, lost_us


def run_trace(cfg, params, dev, steps=8):
    """Device busy time and idle share of one prefill and of ``steps``
    decode steps. The kernels of SERVE_KERNELS are counted by their launches
    (``counted_events``); the events the profiler lost are added to the
    busy time, whose idle share is given corrected for them too (a serve
    step runs on one stream, so they overlap nothing)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from repro_torch.models import lm
    B = SERVE["batch"]
    prompt = prompt_batch(cfg, torch.randint(0, cfg.vocab_size, (B, PROMPT[cfg.arch_id]),
                                             device=dev))
    S = PROMPT[cfg.arch_id] + n_patches(cfg)  # the fused sequence
    out = {"arch": cfg.arch_id, "prefill_len": S}
    for phase in ("prefill", "decode"):
        torch.cuda.synchronize()
        if phase == "decode":
            logits, cache = lm.prefill(cfg, params, prompt, S + steps)
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
        zero_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                lm.prefill(cfg, params, prompt, S + SERVE["gen_len"])
            else:
                for i in range(steps):
                    pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
                    logits, cache = lm.decode_step(cfg, params, cache, tok, pos, S + steps)
                    tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launches, _ = read_counters()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name, events = {}, {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            events.setdefault(e.name, []).append(e.time_range.elapsed_us())
        counted, lost_us = counted_events(events, launches, SERVE_KERNELS)
        n = 1 if phase == "prefill" else steps
        busy = _busy_us(kernels) if kernels else None
        busy_c = None if busy is None else busy + lost_us
        out[phase] = {
            "steps": n, "host_ms_per_step": wall_us / n / 1e3,
            "device_busy_ms_per_step": None if busy is None else busy / n / 1e3,
            "device_idle_share": None if busy is None else 1.0 - busy / wall_us,
            "device_busy_ms_per_step_corrected": None if busy_c is None else busy_c / n / 1e3,
            "device_idle_share_corrected": None if busy_c is None else 1.0 - busy_c / wall_us,
            **{f"{fam}_ms_per_step": c["ms"] / n for fam, c in counted.items()},
            "counted": counted,
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
RG_TRAIN_LABEL = "recurrentgemma-9b train"
HUBERT_TRAIN_LABEL = "hubert-xlarge train"
MIXTRAL_TRAIN_LABEL = "mixtral-8x7b train"
# hubert-xlarge trains whole (48 layers, 15.1 GB of training state), on both
# feeds: its 4 x 2048 f32 frames are 41.9 MB a batch, the first feed that
# carries real bytes
TRAIN_FEEDS = {"qwen3-1.7b": ("bypass", "kernel"), "mamba2-1.3b": ("bypass",),
               "recurrentgemma-9b": ("bypass",), "hubert-xlarge": ("bypass", "kernel"),
               "mixtral-8x7b": ("bypass",)}
# archs checked by train_vs_plain only: internvl2-26b's training state is
# 318 GB, but 4 layers in f32 (about 6 GB of layers and 4.5 GB of embeddings)
# hold the patch labels and the group-6 flash backward to the plain versions
TRAIN_VS_PLAIN_ONLY = ("internvl2-26b",)


def flash_train_cases():
    """The flash shape of each train run, by its label."""
    return {TRAIN_LABEL: FLASH_TRAIN, RG_TRAIN_LABEL: FLASH_TRAIN_RG,
            HUBERT_TRAIN_LABEL: FLASH_TRAIN_HUBERT, MIXTRAL_TRAIN_LABEL: FLASH_TRAIN_MIXTRAL}
# per arch where it differs from TRAIN: recurrentgemma-9b at S 3072, past its
# 2048-key window, so that the window cuts keys, as in its serve prefill; its
# training state is 138 GB at 38 layers (16 B a param), so it keeps two
# whole (rglru, rglru, attn) units, 6 layers: 35.9 GB of state. mixtral-8x7b
# at S 4608, past its 4096-key window, as its serve prefill; a layer is 1.451 B
# params (1.409 B in its 8 experts) and the untied embeddings 0.262 B, so 2
# of its 32 layers are 3.165 B params, 50.6 GB of training state
TRAIN_SHAPE = {"recurrentgemma-9b": dict(seq_len=3072, global_batch=4, n_layers=6),
               "mixtral-8x7b": dict(seq_len=4608, global_batch=2, n_layers=2)}
# train_vs_plain's depth where it is not 4: one mixtral-8x7b layer in f32 is
# 5.8 GB, and the embeddings 1.0 GB; params and the two gradient trees 21 GB
TRAIN_VS_PLAIN_LAYERS = {"mixtral-8x7b": 1}
# a train step's peak device memory above which mixtral-8x7b would be cut to
# one layer (the card holds 80 GB; the allocator needs room around the peak)
TRAIN_PEAK_GB = 76.0
TRAIN_LOSS_REL, TRAIN_GRAD_OF_MAX, RESTART_TOL = 1e-5, 1e-4, 1e-4
# the kernels of each family's train step: (name part of their kernels,
# counter of their wrapper, the kind of layer that calls it, whether it is a
# backward); each kernel name launches once a wrapper call
TRAIN_KERNELS = {
    "dense": {"flash_fwd": ("flash_fwd_", "flash_attention", "attn", False),
              "flash_bwd": ("flash_bwd_", "flash_attention_bwd", "attn", True)},
    "ssm": {"ssd_fwd": (SSD_KERNELS, "ssd_scan", "ssd", False),
            "ssd_bwd": (SSD_BWD_KERNELS, "ssd_scan_bwd", "ssd", True)},
    "hybrid": {"flash_fwd": ("flash_fwd_", "flash_attention", "attn", False),
               "flash_bwd": ("flash_bwd_", "flash_attention_bwd", "attn", True),
               "rglru_fwd": (RGLRU_KERNELS, "rglru_scan", "rglru", False),
               "rglru_bwd": (RGLRU_BWD_KERNELS, "rglru_scan_bwd", "rglru", True)},
}
TRAIN_KERNELS["encoder"] = TRAIN_KERNELS["vlm"] = TRAIN_KERNELS["moe"] = TRAIN_KERNELS["dense"]
# leaves whose gradient only the family's backward kernels give
KERNEL_GRAD_LEAVES = {"dense": ("wq", "wk", "wv"), "ssm": ("a_log", "dt_bias"),
                      "hybrid": ("lam", "wq", "wk", "wv"), "encoder": ("wq", "wk", "wv"),
                      "vlm": ("wq", "wk", "wv"), "moe": ("wq", "wk", "wv")}


def train_config(arch, **kw):
    """``arch``'s full-width config, cut in depth where TRAIN_SHAPE says."""
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    if "n_layers" in TRAIN_SHAPE.get(arch, {}):
        cfg = cfg.replace(n_layers=TRAIN_SHAPE[arch]["n_layers"])
    return cfg.replace(**kw)


def train_shape(arch):
    """(seq_len, global_batch) of ``arch``'s train runs."""
    shape = {**TRAIN, **TRAIN_SHAPE.get(arch, {})}
    return shape["seq_len"], shape["global_batch"]


def layer_kinds(cfg):
    """The kind of each layer, in order: what calls which kernel."""
    if cfg.family == "hybrid":
        return [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    kind = {"dense": "attn", "encoder": "attn", "vlm": "attn", "moe": "attn",
            "ssm": "ssd"}[cfg.family]
    return [kind] * cfg.n_layers


def train_expected(cfg, steps):
    """Launches of ``steps`` train steps: per layer, the forward and its
    recompute under torch.utils.checkpoint, then one backward, of the
    kernels its kind calls (flash attention, the SSD scan, the RG-LRU scan)."""
    kinds = layer_kinds(cfg)
    return {counter: (1 if bwd else 2) * kinds.count(kind) * steps
            for _, counter, kind, bwd in TRAIN_KERNELS[cfg.family].values()}


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
    counted, lost_us = counted_events(
        events, launches, {fam: (part, counter) for fam, (part, counter, _, _)
                           in TRAIN_KERNELS[cfg.family].items()}, {"ssd_fwd": SSD_BWD_KERNELS})
    busy_c = None if busy is None else busy + lost_us
    total = sum(c["ms"] for c in counted.values())
    out.update({"arch": cfg.arch_id, "counted": counted,
                "device_busy_ms_corrected": None if busy_c is None else busy_c / 1e3,
                "device_idle_share_corrected": None if busy_c is None else 1.0 - busy_c / wall_us,
                "counted_share_of_busy": None if not busy_c else total * 1e3 / busy_c,
                "kernels_by_kind_ms": kernels_by_kind(by_name)})
    if cfg.family == "moe":
        # the expert products are the step's only bmm calls (the projections
        # and the LM head are mm): their kernels, as the profiler links them
        # to aten::bmm, over the step's busy time (events the profiler kept)
        bmm_us = sum(k.duration for e in prof.events() if e.name == "aten::bmm"
                     for k in getattr(e, "kernels", ()))
        out.update({"expert_bmm_ms": bmm_us / 1e3,
                    "expert_bmm_calls": sum(1 for e in prof.events() if e.name == "aten::bmm"),
                    "expert_bmm_share_of_busy": None if not busy_c else bmm_us / busy_c})
    emit("trace_train", out)
    if any(c["ms"] <= 0 for c in counted.values()):
        fail(f"trace_train: a kernel family of {cfg.arch_id} reads no device time: "
             f"{ {f: c['ms'] for f, c in counted.items()} }")
    return out


KERNEL_KINDS = {  # by name part of the kernel's name, lower case
    "elementwise": ("elementwise",), "fill": ("fillfunctor",), "add": ("functor_add", "add_"),
    # an atomic scatter-add would show here (index_put with accumulate, scatter_add)
    "indexing": ("index", "scatter", "gather")}


def kernels_by_kind(by_name, top=5):
    """The ``top`` kernels of each kind of KERNEL_KINDS by device ms, with
    each kind's total (a kernel can be of two kinds)."""
    out = {}
    for kind, parts in KERNEL_KINDS.items():
        hits = {k: v for k, v in by_name.items() if any(p in k.lower() for p in parts)}
        out[kind] = {"ms": sum(hits.values()) / 1e3, "kernels": len(hits),
                     "top": [[k[:160], v / 1e3] for k, v in
                             sorted(hits.items(), key=lambda kv: -kv[1])[:top]]}
    return out


class route_log:
    """Every MoE layer's routing over train steps, read from moe.route and
    moe.dispatch_indices, wrapped within the block (their outputs pass as
    they are). Under torch.utils.checkpoint a layer routes twice a step, in
    its forward and in its recompute, from the same router view: calls are
    keyed by its data pointer, and alternate forward, recompute. Of each
    forward the share of assignments dropped at capacity and the aux loss
    are kept; each recompute's expert choices are held to its forward's,
    counting the tokens whose top k differs. The counts stay on the card
    until read."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.saved = moe, (moe.route, moe.dispatch_indices)
        self.layers, self.forward = {}, None
        route, dispatch = self.saved

        def logged_route(cfg, router, x2d):
            idx, weights, aux = route(cfg, router, x2d)
            rec = self.layers.setdefault(router.data_ptr(), {
                "calls": 0, "aux": [], "dropped": [], "assignments": 0, "flips": [],
                "tokens": 0})
            if rec["calls"] % 2 == 0:
                rec["idx"], self.forward = idx, rec
                rec["aux"].append(aux.detach())
            else:
                rec["flips"].append((idx != rec.pop("idx")).any(dim=-1).sum())
                rec["tokens"] += idx.shape[0]
                self.forward = None
            rec["calls"] += 1
            return idx, weights, aux

        def logged_dispatch(idx, n_experts, cap):
            pos = dispatch(idx, n_experts, cap)
            if self.forward is not None:
                self.forward["dropped"].append((pos < 0).sum())
                self.forward["assignments"] += pos.numel()
            return pos
        moe.route, moe.dispatch_indices = logged_route, logged_dispatch
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch_indices = self.saved

    def read(self):
        """Per MoE layer in depth order: forwards, recomputes, the dropped
        share, the aux loss of each forward and the recompute's flips."""
        out = []
        for i, rec in enumerate(self.layers.values()):
            dropped = int(sum(int(d) for d in rec["dropped"]))
            out.append({"layer": i, "forwards": len(rec["aux"]),
                        "recomputes": len(rec["flips"]),
                        "dropped": dropped, "assignments": rec["assignments"],
                        "dropped_share": dropped / max(rec["assignments"], 1),
                        "aux": [float(a) for a in rec["aux"]],
                        "recompute_tokens": rec["tokens"],
                        "recompute_flips": int(sum(int(f) for f in rec["flips"]))})
        return out


# --------------------------------------------------------------------------
# sharding: the port's mesh path on a one-rank NCCL group
# --------------------------------------------------------------------------

SHARDING_ARCH = "mixtral-8x7b"


def free_port():
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def one_rank_world(dev):
    """A process group of this process alone (NCCL on a free local port),
    destroyed on the way out."""
    import torch.distributed as dist
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def _whole_grads(grads):
    """Gradients of DTensor params as whole tensors in the port's whole
    expert layout."""
    from repro_torch import tree
    from repro_torch.convert import experts_whole
    from repro_torch.parallel.specs import whole
    return tree.leaf_paths(experts_whole(tree.tree_map(whole, grads)))


def sharding_layer(dev, mesh, rules):
    """One mixtral-8x7b MoE layer at full width (d 4096, d_ff 14 336, 8
    experts, top 2, capacity factor 1.25), bf16, on the train cell's 2 x
    4608 tokens: ``moe_local`` against ``apply_moe`` on the (1, 1) mesh in
    each mode; outputs, aux loss and the gradients of x, the router and the
    experts of one backward, bitwise."""
    from repro_torch import tree
    from repro_torch.models import moe
    from repro_torch.models.layers import layer_of
    from repro_torch.models.registry import get_config
    from repro_torch.parallel import axes
    from repro_torch.parallel.specs import expert_blocks, make_param_specs, make_shardings, place_tree
    from repro_torch.runtime.steps import _laid_out_as
    cfg = get_config(SHARDING_ARCH)
    seq_len, batch = train_shape(SHARDING_ARCH)
    gen = torch.Generator(device=dev).manual_seed(TRAIN["seed"])
    p = moe.init_moe_layer(cfg, gen, dev)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)

    def run(params, leaves, **kw):
        xr = x.clone().requires_grad_(True)
        for t in leaves.values():
            t.requires_grad_(True)
        # the layer's leaves are taken after they require grad
        layer = layer_of(params["moe"], 0) if "moe" in params else params
        y, aux = moe.apply_moe(cfg, layer, xr, **kw)
        grads = torch.autograd.grad((y, aux), [xr, *leaves.values()],
                                    (dy, torch.ones_like(aux)))
        for t in leaves.values():
            t.requires_grad_(False)
        return y.detach(), aux.detach(), grads[0], dict(zip(leaves, grads[1:]))

    y0, aux0, dx0, g0 = run(p, tree.leaf_paths(p))
    stacked = {"moe": tree.tree_map(lambda t: t[None], p)}  # the model's paths and ranks
    out = {"d_model": cfg.d_model, "d_ff": cfg.d_ff, "experts": cfg.n_experts,
           "top_k": cfg.experts_per_token, "capacity_factor": cfg.capacity_factor,
           "tokens": batch * seq_len, "modes": {}}
    with axes.axis_rules(rules, mesh):
        blocked = expert_blocks(stacked, mesh)
        placed = place_tree(blocked, make_shardings(make_param_specs(blocked, rules, mesh), mesh))
        leaves = tree.leaf_paths(placed)
        for mode, force in (("gather", True), ("stationary", False)):
            y, aux, dx, g = run(placed, leaves, force_gather=force)
            g = _whole_grads(tree.unflatten_like(
                placed, {k: _laid_out_as(v, leaves[k]) for k, v in g.items()}))
            out["modes"][mode] = {
                "output_bitwise_equal": bool(torch.equal(y, y0)),
                "aux_bitwise_equal": bool(torch.equal(aux, aux0)),
                "dx_bitwise_equal": bool(torch.equal(dx, dx0)),
                "grad_leaves_unequal": [k for k in g0 if not torch.equal(g["moe/" + k][0], g0[k])],
                "aux": float(aux)}
            del y, dx, g
    del p, stacked, blocked, placed, leaves, g0, dx0
    torch.cuda.empty_cache()
    return out


def sharding_train(dev, mesh, rules):
    """mixtral-8x7b's train cell (TRAIN_SHAPE: full width, 2 of 32 layers, 2
    x 4608 tokens, 8 steps, bypass feed) on the (1, 1) mesh, the counters
    set to 0 just before: its train line's numbers, and one more step
    traced (trace_train, under the rules)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.parallel import axes
    from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime
    cfg = train_config(SHARDING_ARCH)
    seq_len, global_batch = train_shape(SHARDING_ARCH)
    dcfg = DataConfig(seq_len=seq_len, global_batch=global_batch, seed=TRAIN["seed"])
    fresh_peak(dev)
    rt = TrainerRuntime(cfg, dcfg, TrainerConfig(steps=TRAIN["steps"], feed="bypass",
                                                 log_every=1, seed=TRAIN["seed"]),
                        device=dev, mesh=mesh, rules=rules)
    zero_counters()
    with contextlib.redirect_stdout(sys.stderr):  # the trainer's log lines
        state = rt.run()
    launches, plain_calls = read_counters()
    out = {"losses": [m["loss"] for m in rt.metrics_log],
           "grad_norms": [m["grad_norm"] for m in rt.metrics_log],
           "step_ms_median": _pct(rt.step_times_s, 50) * 1e3,
           "step_ms_p99": _pct(rt.step_times_s, 99) * 1e3,
           "device_ms_median": _pct(rt.device_times_s, 50) * 1e3,
           "issue_ms": [t * 1e3 for t in rt.issue_times_s],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches, "expected_launches":
               {n: train_expected(cfg, TRAIN["steps"]).get(n, 0) for n in launches},
           "plain_calls": plain_calls}
    with axes.axis_rules(rules, mesh):
        trace = trace_train(cfg, rt, state, dev)
    out["trace"] = {k: trace[k] for k in ("host_ms", "device_busy_ms_corrected",
                                          "device_idle_share_corrected", "top_kernels_ms")}
    del state, rt
    torch.cuda.empty_cache()
    return out


def run_sharding(dev, card, unsharded):
    """The port's sharding layer on the card: a one-rank NCCL group, the
    (1, 1) mesh of ``make_smoke_mesh`` and ``single_pod_rules``, under which
    the rules do nothing to the numbers, as the JAX package's do on one
    device. One full-width MoE layer in both modes against ``moe_local``
    (``sharding_layer``), then mixtral-8x7b's train cell on the mesh against
    its unsharded run (``unsharded``, run_train's line): losses and grad
    norms bitwise, the same flash launches, 0 plain calls; its times and
    peak beside the unsharded run's. One ``sharding`` line; a check that
    fails exits non-zero."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.axes import single_pod_rules
    with one_rank_world(dev) as dist:
        mesh = make_smoke_mesh(1, device_type="cuda")
        rules = single_pod_rules()
        layer = sharding_layer(dev, mesh, rules)
        train = sharding_train(dev, mesh, rules)
        backend, world = dist.get_backend(), dist.get_world_size()
    keys = ("step_ms_median", "step_ms_p99", "device_ms_median", "peak_mem_gb")
    out = {"card": card, "backend": backend, "world_size": world,
           "mesh_shape": list(mesh.shape), "mesh_axes": list(mesh.mesh_dim_names),
           "rules": "single_pod_rules", "moe_layer": layer,
           "train": {"arch": SHARDING_ARCH, **train,
                     "losses_bitwise_equal": train["losses"] == unsharded["losses"],
                     "grad_norms_bitwise_equal": train["grad_norms"] == unsharded["grad_norms"]},
           "unsharded": {**{k: unsharded[k] for k in keys},
                         "issue_ms": unsharded["issue_ms"]}}
    emit("sharding", out)
    bad = [m for m, r in layer["modes"].items()
           if not (r["output_bitwise_equal"] and r["aux_bitwise_equal"]
                   and r["dx_bitwise_equal"]) or r["grad_leaves_unequal"]]
    if bad:
        fail(f"sharding: the MoE layer on the mesh differs from moe_local in {bad}")
    t = out["train"]
    if not (t["losses_bitwise_equal"] and t["grad_norms_bitwise_equal"]):
        fail(f"sharding: mesh train losses {t['losses']} / grad norms {t['grad_norms']} "
             f"!= unsharded {unsharded['losses']} / {unsharded['grad_norms']}")
    if t["launches"] != t["expected_launches"] or t["plain_calls"]:
        fail(f"sharding: launches {t['launches']} (expected {t['expected_launches']}), "
             f"{t['plain_calls']} plain calls")


RECURRENT_SHARDING = ("mamba2-1.3b", "recurrentgemma-9b")


def recurrent_sharding_step(dev, arch):
    """One train step's loss and gradients of ``arch`` (``train_config``:
    mamba2-1.3b whole, recurrentgemma-9b's 6 layers; its train shape, bf16)
    without a mesh and on the (1, 1) NCCL mesh under ``single_pod_rules``,
    the counters set to 0 just before each: bitwise equal, the same
    launches, 0 plain calls. A model axis of 1 splits no recurrent block
    (``mamba2.heads_split``, ``rglru.width_share``), so the mesh's step runs
    today's ops."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synth_tokens
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import mamba2, rglru
    from repro_torch.parallel import axes
    from repro_torch.parallel.axes import single_pod_rules
    from repro_torch.parallel.specs import make_param_specs, make_shardings, place_tree
    from repro_torch.runtime.steps import _laid_out_as, loss_and_grads
    cfg = train_config(arch)
    params = serve.init_params(cfg, TRAIN["seed"], dev)
    seq_len, global_batch = train_shape(arch)
    host = synth_tokens(cfg, DataConfig(seq_len=seq_len, global_batch=global_batch,
                                        seed=TRAIN["seed"]), 0, 1, 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    zero_counters()
    loss0, _, g0 = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    launches0, plain0 = read_counters()
    g0 = tree.leaf_paths(g0)
    with one_rank_world(dev) as dist:
        mesh = make_smoke_mesh(1, device_type="cuda")
        rules = single_pod_rules()
        with axes.axis_rules(rules, mesh):
            split = {"heads": list(mamba2.heads_split(cfg)),
                     "width": rglru.width_share(cfg) is not None}
            placed = place_tree(params, make_shardings(make_param_specs(params, rules, mesh),
                                                       mesh))
            zero_counters()
            loss1, _, g1 = loss_and_grads(cfg, placed, batch)
            torch.cuda.synchronize()
            launches1, plain1 = read_counters()
            leaves = tree.leaf_paths(placed)
            g1 = _whole_grads(tree.unflatten_like(
                placed, {k: _laid_out_as(v, leaves[k])
                         for k, v in tree.leaf_paths(g1).items()}))
        backend = dist.get_backend()
    out = {"arch": arch, "n_layers": cfg.n_layers, "seq_len": seq_len,
           "global_batch": global_batch, "backend": backend, "mesh_shape": [1, 1],
           "rules": "single_pod_rules", "split_on_mesh": split,
           "loss": float(loss0), "loss_bitwise_equal": bool(torch.equal(loss0, loss1)),
           "grad_leaves": len(g0),
           "grad_leaves_unequal": [k for k in g0 if not torch.equal(g0[k], g1[k])],
           "launches": launches1, "launches_unsharded": launches0,
           "plain_calls": plain0 + plain1}
    del params, placed, g0, g1, leaves
    torch.cuda.empty_cache()
    return out


def run_recurrent_sharding(dev, card):
    """The ``recurrent_sharding`` phase: recurrent_sharding_step for
    mamba2-1.3b and recurrentgemma-9b; a check that fails exits non-zero."""
    for arch in RECURRENT_SHARDING:
        out = {"card": card, **recurrent_sharding_step(dev, arch)}
        emit("recurrent_sharding", out)
        if not out["loss_bitwise_equal"] or out["grad_leaves_unequal"]:
            fail(f"recurrent_sharding: {arch} on the (1, 1) mesh differs from its unsharded "
                 f"step: {out}")
        whole = {"heads": [1, 0], "width": False}
        if out["launches"] != out["launches_unsharded"] or not any(out["launches"].values()) \
                or out["plain_calls"] or out["split_on_mesh"] != whole:
            fail(f"recurrent_sharding: {arch}: {out}")


def recurrent_sharding_bits():
    """The recurrent_sharding phase alone, in the tree whose repro_torch this
    process imports. Run as

        python3 -c 'import chip_smoke; chip_smoke.recurrent_sharding_bits()'"""
    import repro_torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit("tree", str(Path(repro_torch.__file__).resolve().parents[2]))
    _build.build_all(["flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd",
                      "rglru_scan", "rglru_scan_bwd"])
    run_recurrent_sharding(dev, card)


def sharding_bits():
    """mixtral-8x7b's train cell (run_train) and then the sharding phase
    alone, in the tree whose repro_torch this process imports. Run as

        python3 -c 'import chip_smoke; chip_smoke.sharding_bits()'"""
    import repro_torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit("tree", str(Path(repro_torch.__file__).resolve().parents[2]))
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    run_sharding(dev, card, run_train(dev, card, SHARDING_ARCH))


def train_phases(cfg, rt, state, dev):
    """One more train step (a fresh batch of the same stream), the card
    synchronised at the bounds of its four phases: forward (the embedding
    and every layer), loss (the final norm and the chunked cross-entropy),
    backward (torch.autograd.grad, the recomputes included) and optimizer
    (AdamW). At each bound the phase's peak device memory is read and the
    peak reset, after the synchronisation: reset_peak_memory_stats sets it
    to what is allocated then, so no earlier phase counts in a later one."""
    from repro_torch.data.pipeline import synth_tokens
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step
    host = synth_tokens(cfg, rt.dcfg, 0, 1, TRAIN["steps"] + 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    backbone = lm.backbone(cfg)
    saved = lm.train_loss, backbone.forward_hidden, adamw.apply_updates
    marks = []

    def mark(name):
        torch.cuda.synchronize(dev)
        marks.append((name, time.perf_counter(), torch.cuda.max_memory_allocated(dev),
                      torch.cuda.memory_allocated(dev)))
        torch.cuda.reset_peak_memory_stats(dev)

    def train_loss(*a, **kw):
        mark("start")
        out = saved[0](*a, **kw)
        mark("loss")
        return out

    def forward_hidden(*a, **kw):
        out = saved[1](*a, **kw)
        mark("forward")
        return out

    def apply_updates(*a, **kw):
        mark("backward")
        out = saved[2](*a, **kw)
        mark("optimizer")
        return out
    lm.train_loss, backbone.forward_hidden, adamw.apply_updates = (
        train_loss, forward_hidden, apply_updates)
    try:
        make_train_step(cfg, rt.opt_cfg)(state.params, state.opt_state, batch)
    finally:
        lm.train_loss, backbone.forward_hidden, adamw.apply_updates = saved
    names = [m[0] for m in marks]
    if names != ["start", "forward", "loss", "backward", "optimizer"]:
        fail(f"train_phases: phase bounds {names}")
    phases = {name: {"ms": (t1 - t0) * 1e3, "peak_gb": peak / 1e9,
                     "allocated_after_gb": alloc / 1e9}
              for (_, t0, _, _), (name, t1, peak, alloc) in zip(marks, marks[1:])}
    out = {"arch": cfg.arch_id, "allocated_at_start_gb": marks[0][3] / 1e9,
           "phases": phases, "peak_gb": max(p["peak_gb"] for p in phases.values()),
           "bound_peak_gb": TRAIN_PEAK_GB}
    emit("train_phases", out)
    return out


def train_repeat(cfg, rt, state, dev):
    """One train step's loss and gradients twice from the same params and
    batch: both bitwise equal, as every kernel's repeat is."""
    from repro_torch import tree
    from repro_torch.data.pipeline import synth_tokens
    from repro_torch.runtime.steps import loss_and_grads
    host = synth_tokens(cfg, rt.dcfg, 0, 1, 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    la, _, ga = loss_and_grads(cfg, state.params, batch)
    ga = tree.leaf_paths(ga)
    lb, _, gb = loss_and_grads(cfg, state.params, batch)
    gb = tree.leaf_paths(gb)
    unequal = [k for k in ga if not torch.equal(ga[k], gb[k])]
    out = {"arch": cfg.arch_id, "losses": [float(la), float(lb)],
           "loss_bitwise_equal": bool(torch.equal(la, lb)), "grad_leaves": len(ga),
           "grad_leaves_unequal": unequal}
    emit("train_repeat", out)
    del ga, gb
    torch.cuda.empty_cache()
    if not out["loss_bitwise_equal"] or unequal:
        fail(f"train_repeat: two runs of one step differ: {out}")


def run_train(dev, card, arch):
    """``arch`` at full width (depth cut where TRAIN_SHAPE says), bf16, 8
    steps with each of its feeds (TRAIN_FEEDS) on the same batches. Returns
    the bypass run's ``train`` line (its launch counts under "launches")."""
    import contextlib
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.trainer import TrainerConfig, TrainerRuntime
    cfg = train_config(arch)
    seq_len, global_batch = train_shape(arch)
    dcfg = DataConfig(seq_len=seq_len, global_batch=global_batch, seed=TRAIN["seed"])
    emit("train_checkpointing", f"{arch}: off at full width: params, gradients, f32 master "
         f"copy and AdamW moments are {16 * cfg.param_count() / 1e9:.1f} GB to hash and "
         "write; the restart phase drives checkpoints at the smoke config")
    expected = train_expected(cfg, TRAIN["steps"])
    runs = {}
    for feed in TRAIN_FEEDS[arch]:
        fresh_peak(dev)
        rt = TrainerRuntime(cfg, dcfg, TrainerConfig(steps=TRAIN["steps"], feed=feed,
                                                     log_every=1, seed=TRAIN["seed"]),
                            device=dev)
        routes = route_log() if cfg.family == "moe" else contextlib.nullcontext()
        zero_counters()
        with contextlib.redirect_stdout(sys.stderr), routes:  # the trainer's log lines
            state = rt.run()
        launches, plain_calls = read_counters()
        want = {name: expected.get(name, 0) for name in launches}
        losses = [m["loss"] for m in rt.metrics_log]
        st = rt.feed.stats
        tokens = TRAIN["steps"] * global_batch * seq_len
        out = {
            "card": card, "arch": cfg.arch_id, "feed": feed, "params": cfg.param_count(),
            "n_layers": cfg.n_layers, "training_state_gb": 16 * cfg.param_count() / 1e9,
            "dtype": cfg.param_dtype, "seq_len": seq_len, "global_batch": global_batch,
            "steps": TRAIN["steps"],
            "losses": losses, "grad_norms": [m["grad_norm"] for m in rt.metrics_log],
            "step_ms": [t * 1e3 for t in rt.step_times_s],
            # per step: the host's time to issue it, the card's between two events
            "issue_ms": [t * 1e3 for t in rt.issue_times_s],
            "device_ms": [t * 1e3 for t in rt.device_times_s],
            "device_ms_median": _pct(rt.device_times_s, 50) * 1e3,
            "step_ms_median": _pct(rt.step_times_s, 50) * 1e3,
            "step_ms_p99": _pct(rt.step_times_s, 99) * 1e3,
            "tok_per_s": tokens / sum(rt.step_times_s),
            "feed_wait_ms_per_batch": 1e3 * sum(rt.feed_times_s) / len(rt.feed_times_s),
            "feed_wait_ms_max": 1e3 * max(rt.feed_times_s),
            "feed_stats": {"batches": st.batches, "bytes": st.bytes,
                           "bytes_per_batch": st.bytes / max(st.batches, 1),
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
        if cfg.family == "moe":
            routing = routes.read()
            emit("train_routing", {"arch": arch, "capacity_factor": cfg.capacity_factor,
                                   "layers": routing})
            if any(r["recompute_flips"] or r["recomputes"] != r["forwards"]
                   or r["forwards"] != TRAIN["steps"] for r in routing):
                fail(f"train ({feed} feed): a recompute routed otherwise than its forward: "
                     f"{routing}")
        if feed == "bypass":
            trace_train(cfg, rt, state, dev)
            if cfg.family == "moe":
                train_phases(cfg, rt, state, dev)
                train_repeat(cfg, rt, state, dev)
        del state, rt
    if len(runs) > 1:
        same = runs["bypass"]["losses"] == runs["kernel"]["losses"]
        emit("train_feeds", {"arch": arch, "losses_bitwise_equal": same,
                             "feed_wait_ms_per_batch": {f: runs[f]["feed_wait_ms_per_batch"]
                                                        for f in runs},
                             "put_ms_per_batch": {f: runs[f]["feed_stats"]["put_ms_per_batch"]
                                                  for f in runs},
                             "bytes_per_batch": {f: runs[f]["feed_stats"]["bytes_per_batch"]
                                                 for f in runs},
                             "step_ms_median": {f: runs[f]["step_ms_median"] for f in runs}})
        if not same:
            fail(f"the two feeds gave different losses: {runs['bypass']['losses']} vs "
                 f"{runs['kernel']['losses']}")
    torch.cuda.empty_cache()
    return runs["bypass"]


def run_train_vs_plain(dev, arch):
    """One step's loss and every gradient, kernels against plain versions:
    f32, full width, 4 layers (for recurrentgemma-9b one pattern unit and
    the tail's first RG-LRU layer), at the arch's train shape."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synth_tokens
    from repro_torch.launch import serve
    from repro_torch.runtime.steps import loss_and_grads
    cfg = train_config(arch, n_layers=TRAIN_VS_PLAIN_LAYERS.get(arch, 4),
                       param_dtype="float32", compute_dtype="float32")
    params = serve.init_params(cfg, 0, dev)
    seq_len, global_batch = train_shape(arch)
    host = synth_tokens(cfg, DataConfig(seq_len=seq_len, global_batch=global_batch, seed=1),
                        0, 1, 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    # in MoE layers the plain run takes the kernels' run's expert choices, in
    # the same order (each layer's forward, then its recompute), as
    # serve_vs_plain does
    experts = forced_experts()
    zero_counters()
    with experts.mode(replay=False):
        loss_k, _, gk = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    launches, plain_calls = read_counters()
    want = {name: train_expected(cfg, 1).get(name, 0) for name in launches}
    with plain_kernels(), experts.mode(replay=True):
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
    out = {"arch": arch, "n_layers": cfg.n_layers, "seq_len": seq_len,
           "global_batch": global_batch, "dtype": "float32", "loss_kernels": lk,
           "loss_plain": lp, "loss_rel_diff": abs(lk - lp) / abs(lp),
           "bound_loss_rel": TRAIN_LOSS_REL, "grad_leaves": len(gp),
           "worst_grad_err_of_max": top, "bound_grad_err_of_max": TRAIN_GRAD_OF_MAX,
           "kernel_grad_leaves": leaves,
           "kernel_grads_nonzero": all(bool(gk[k].abs().max() > 0) for k in gk
                                       if k.split("/")[-1] in leaves),
           "launches": launches, "expected_launches": want, "plain_calls": plain_calls}
    if cfg.family == "moe":
        out["expert_flips"] = {"tokens": experts.tokens, "flipped": experts.flipped}
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


def work_bound(w):
    """``bound`` of a kernel call's ``kernels.costs.Work``: the function the
    dry run's op counter reads too."""
    return bound(w.bytes, w.flops, F32_FLOP_PER_S if w.f32 else BF16_FLOP_PER_S)


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
           # the gradient of the Pallas forward, which JAX takes through its associative scan
           "rglru_scan_bwd": ("rglru_scan_bwd.cu", "rglru_scan.py:46"),
           # jitted XLA (the scan and gather of get_epoch_pass_jax), not Pallas
           "epoch_pass": ("epoch_pass.cu", "epoch_fastpath.py:108")}[name]
    return {"name": f"{name} ({arch})", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src[0]}",
            "replaces": f"src/repro/kernels/{src[1]}",
            "launches": launches[arch][name], "max_abs_err": errs[(name, arch)],
            **kw, "card": card}


def padded_head_dim(Dh):
    """The head dim of the bf16 flash body that runs Dh, with zero columns
    past Dh (the dispatch of both flash sources): Dh 80 and 96 run the Dh 128
    body, 160 and 192 the Dh 256 body. Its products do padded / Dh times the
    arithmetic that the bound counts."""
    return next(d for d in (32, 64, 128, 256) if Dh <= d)


def time_flash(arch, launches, errs, card, dev):
    from repro_torch.kernels import costs
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    train_cases = {**flash_train_cases(), **TP_TRAIN}
    with_lse = arch in train_cases  # the train path's forward also writes the logsumexp
    case = train_cases[arch] if with_lse else {**FLASH_SERVE, **TP_PREFILL}[arch]
    B, S, _, H, Hkv, Dh, causal, window, _ = case
    scale = Dh ** -0.5
    q, k, v = flash_inputs(case, torch.bfloat16, dev, seed=3)
    work = costs.flash_forward(q.shape, k.shape, 2, causal=causal, window=window,
                               with_lse=with_lse)
    flops = work.flops
    b_ms, b_by = work_bound(work)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:  # SDPA takes the window only as a mask, built outside the timing
        mask = ref.attention_mask(S, S, causal=causal, window=window, device=dev)
    kern = lambda: kflash._forward(  # noqa: E731
        q, k, v, causal=causal, window=window, q_offset=0, softmax_scale=scale,
        with_lse=with_lse)[0]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale,
        enable_gqa=True).transpose(1, 2)
    heads_major = [t.contiguous() for t in (qt, kt, vt)]
    ms = time_ms(kern, iters=20 if window else 50)
    pad = padded_head_dim(Dh)
    return _row("flash_attention", arch, launches, errs, card,
                ms=ms, flops=flops, tflop_per_s=flops / ms / 1e9,
                device_ms=device_ms(kern, "flash_fwd_"),
                plain_ms=time_ms(lambda: plain_mha(q, k, v, causal=causal, window=window,
                                                   softmax_scale=scale), iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, iters=20),
                library="scaled_dot_product_attention" + (" with a window mask" if window else ""),
                library_backend=sdpa_backend(lib),
                library_vs_kernel_max_abs=max_err(lib(), kern(), BF16_TOL),
                library_head_major_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    *heads_major, attn_mask=mask, is_causal=causal and mask is None,
                    scale=scale, enable_gqa=True), iters=20),
                body_head_dim=pad, body_flops_over_bound_flops=pad / Dh,
                shape={"B": B, "Sq": S, "Skv": S, "H": H, "Hkv": Hkv, "Dh": Dh,
                       "causal": causal, "window": window, "dtype": "bfloat16",
                       "lse": with_lse})


def time_flash_bwd(case, label, launches, errs, card, dev):
    from repro_torch.kernels import costs
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import ref
    B, S, _, H, Hkv, Dh, causal, window, _ = case
    scale = Dh ** -0.5
    mask = dict(causal=causal, window=window, q_offset=0)
    q, k, v = flash_inputs(case, torch.bfloat16, dev, seed=3)
    dout = randn(torch.Generator().manual_seed(9), q.shape, torch.bfloat16, dev)
    out, lse = kflash._forward(q, k, v, softmax_scale=scale, with_lse=True, **mask)
    # read q, o, dO and k, v once, write dq, dk, dv; 5 products of 2*Dh FLOP per
    # visible pair and head: the scores again, dP, dV, dK and dQ
    work = costs.flash_backward(q.shape, k.shape, 2, causal=causal, window=window)
    nbytes = work.bytes
    b_ms, b_by = work_bound(work)
    kern = lambda: kbwd.flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, out, lse, dout, softmax_scale=scale, **mask)
    # plain: autograd's backward through ref.mha (in blocks of query rows where
    # its scores would not fit), its graph built outside the timing
    qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
    out_p = plain_mha(qp, kp, vp, softmax_scale=scale, **mask)
    plain_ms = time_ms(lambda: torch.autograd.grad(out_p, (qp, kp, vp), dout,
                                                   retain_graph=True), iters=3, warmup=1)
    del out_p, qp, kp, vp
    torch.cuda.empty_cache()
    # library: SDPA's forward + backward minus its forward (the port never calls it);
    # SDPA takes a window only as a mask, built outside the timing
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dout_t = dout.transpose(1, 2).contiguous()
    attn_mask = (ref.attention_mask(S, S, causal=True, window=window, device=dev)
                 if window else None)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=attn_mask, is_causal=causal and attn_mask is None, scale=scale,
        enable_gqa=True)
    sdpa_fb = lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dout_t)  # noqa: E731
    lib_ms = time_ms(sdpa_fb, iters=20) - time_ms(sdpa, iters=20)
    got = kern()
    rr = max(rel_rms(a, b.transpose(1, 2)) for a, b in zip(got, sdpa_fb()))
    flops = work.flops
    ms = time_ms(kern, iters=10)
    p = kbwd.plan(B, S, S, H, Hkv, Dh, torch.bfloat16)
    # the call's kernels by name part: the row dots, dK/dV, the sum of its head
    # subsets' partials (where the plan has more than one), dQ
    parts = {"dots": "flash_bwd_dot", "dkdv": f"flash_bwd_dkdv_{p.body}",
             "dq": f"flash_bwd_dq_{p.body}"}
    if len(p.head_subsets) > 1:
        parts["sum"] = "flash_bwd_dkdv_sum"
    return _row("flash_attention_bwd", label, launches, errs, card,
                ms=ms, flops=flops, tflop_per_s=flops / ms / 1e9, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                device_ms=device_ms(kern, "flash_bwd_", iters=10),
                device_ms_per_kernel={k: device_ms(kern, part, iters=10)
                                      for k, part in parts.items()},
                library_ms=lib_ms,
                library="scaled_dot_product_attention forward+backward minus its forward"
                        + (", window mask" if window else ""),
                library_backend=sdpa_backend(sdpa_fb),
                library_vs_kernel_rel_rms=(rr, rr <= FLASH_BWD_BF16_REL_RMS),
                body_head_dim=padded_head_dim(Dh),
                body_flops_over_bound_flops=padded_head_dim(Dh) / Dh,
                shape={"B": B, "Sq": S, "Skv": S, "H": H, "Hkv": Hkv, "Dh": Dh,
                       "causal": causal, "window": window, "dtype": "bfloat16",
                       "bytes": nbytes, "plan": p._asdict()})


def sdpa_backend(fn, calls=(5, 20, 50)):
    """Which of SDPA's backends ran ``fn``, named from the device kernels of
    a trace of ``calls`` calls: cuDNN, flash, memory-efficient (CUTLASS fmha)
    or math (no fused attention kernel, the products and softmax as separate
    kernels); with the four kernels that took the most time. The profiler
    can drop every event of a short trace, so a trace without one is taken
    again with more calls; after the last, the backend is None (not traced),
    never a guess."""
    by = {}
    for n in calls:
        for e in _cuda_events(lambda: [fn() for _ in range(n)]):
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / n
        if by:
            break
    if not by:
        return {"backend": None, "kernel_events": 0,
                "traces": f"{len(calls)} traces of {calls} calls held no kernel event"}
    names = " ".join(by).lower()
    backend = ("cudnn" if "cudnn" in names else "flash" if "flash" in names else
               "efficient" if "fmha" in names or "mem_eff" in names else "math")
    return {"backend": backend, "kernel_events": len(by),
            "top_kernels_us": [[k[:100], v] for k, v in
                               sorted(by.items(), key=lambda kv: -kv[1])[:4]]}


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


def host_ms(fn, calls=200):
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def engine_pass_split(host, calls=200):
    """make_pass("cuda")'s call at the bench epoch on the host clock, step by
    step, each step synchronised alone: staging (np.copyto into the pinned
    buffer), upload, kernel, download (status, arrivals and queues, then
    the copies returned); ms a call. None for a tree whose make_pass has no
    steps."""
    from repro_torch.kernels import epoch_pass as kep
    card = kep.make_pass("cuda")
    if not hasattr(card, "stage"):
        return None
    handed, ser, busy0, lat, table, fids = host
    n, sync = len(handed), torch.cuda.synchronize
    spent = dict.fromkeys(("staging", "upload", "kernel", "download"), 0.0)
    for k in range(calls + 5):
        with card.dev.lock:
            t0 = time.perf_counter()
            m = card.stage(handed, ser, fids)
            t1 = time.perf_counter()
            card.upload(n, m, True)
            sync()
            t2 = time.perf_counter()
            n_flows = card.launch(n, m, busy0, lat, table)
            sync()
            t3 = time.perf_counter()
            card.download(n, m, True)
            sync()
            card.finish(n, m, True, n_flows)
            t4 = time.perf_counter()
        if k >= 5:
            for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                spent[key] += dt
    out = {k: v / calls * 1e3 for k, v in spent.items()}
    out["sum"] = sum(out.values())
    return out


def epoch_pass_times(dev):
    """The epoch pass at the bench shape's first epoch, in the tree this
    process imports: the wrapper (its call reads busy_until back, a
    synchronisation) by CUDA events, the device time of its kernels (by the
    name part epoch_pass_) beside a kernel's that fills two words
    (device_floor_ms), a launch-and-read-back floor, the plain version
    (cumsum, cummax and a gather on the card), and the pass as the engine
    calls it (numpy in and out, the copies included) with its split, beside
    the numpy pass, on the host clock."""
    from repro_torch.kernels import epoch_pass as kep
    from repro_torch.kernels import ref
    host, (h, s, table, fids) = bench_epoch(dev)
    n, busy0, lat = h.numel(), host[2], host[3]
    kern = lambda: kep.epoch_pass_cuda(h, s, busy0, lat, table, fids)  # noqa: E731
    plain = lambda: ref.epoch_pass(h, s, busy0, lat, table, fids)  # noqa: E731
    engine_pass = kep.make_pass(dev.type)
    if not (epoch_equal(kern(), plain()) and epoch_equal(kern(), kep.epoch_pass_np(*host))
            and epoch_equal(engine_pass(*host), kep.epoch_pass_np(*host))):
        fail("epoch_pass at the bench epoch: the kernel, its plain version, the engine's "
             "pass and the numpy pass disagree")
    nbytes = 8 * (5 * n + table.numel())  # handed, ser, fids in; arrivals, queues out
    b_ms, b_by = bound(nbytes, 0)
    words = torch.empty(2, dtype=torch.int64, device=dev)
    return dict(ms=time_ms(kern, iters=200), device_ms=device_ms(kern, "epoch_pass_"),
                device_floor_ms=device_ms(lambda: words.fill_(0), "FillFunctor"),
                launch_floor_ms=time_ms(lambda: torch.empty(
                    2, dtype=torch.int64, device=dev).fill_(0).tolist(), iters=200),
                plain_ms=time_ms(plain, iters=200),
                engine_pass_ms=host_ms(lambda: engine_pass(*host)),
                engine_pass_split_ms=engine_pass_split(host),
                numpy_pass_ms=host_ms(lambda: kep.epoch_pass_np(*host)),
                bound_ms=b_ms, bound_by=b_by,
                shape={"n": n, "n_flows": table.numel(), "queues": EPOCH_QUEUES,
                       "bytes": nbytes, "plan": kep.plan(n)._asdict()})


def time_epoch_pass(launches, errs, card, dev):
    return _row("epoch_pass", SIM_LABEL, launches, errs, card, **epoch_pass_times(dev),
                library_ms=None,
                library="none: no single PyTorch call computes a max-plus scan")


def time_decode(arch, launches, errs, card, dev):
    from repro_torch.kernels import costs
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref
    from repro_torch.models.registry import get_config
    B, C, H, Hkv, Dh, _ = {**DECODE_SERVE, **TP_DECODE, **KV_SEQ_DECODE}[arch]
    # qwen3: the middle decode step over a cache of prompt + gen slots (the
    # vlm's prompt with its patches); recurrentgemma: the ring is full at
    # every decode step; a rank's share of a decode_32k cache (kv_seq): every
    # slot valid, the logsumexp written beside the output as that path asks
    with_lse = arch in KV_SEQ_DECODE
    if with_lse:
        n = C
    else:
        base = arch.split(",")[0]  # a tensor-parallel label's arch
        prompt = PROMPT[base] + n_patches(get_config(base))
        n = prompt + SERVE["gen_len"] // 2 + 1 if C > prompt else C
    q1, kc, vc, cl = decode_inputs((B, C, H, Hkv, Dh, (n,) * B), torch.bfloat16, dev, seed=4)
    scale = Dh ** -0.5
    valid = n * B
    kv_bytes = 2 * 2 * valid * Hkv * Dh
    # this run's valid slots (the dry run's counter counts every slot)
    b_ms, b_by = work_bound(costs.decode(q1.shape, kc.shape, 2, valid, with_lse=with_lse))
    plan = kdec.plan_splits(B, C, Hkv, H // Hkv, Dh, q1.dtype, kdec._sm_count(dev.index))
    # every row has the same length n, so SDPA on the first n slots, unmasked,
    # computes the same function
    q1t, kct, vct = q1[:, :, None], kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
    kern = lambda: kdec.decode_attention_cuda(  # noqa: E731
        q1, kc, vc, cl, softmax_scale=scale, return_lse=with_lse)
    kern_out = (lambda: kern()[0]) if with_lse else kern  # noqa: E731
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
                library="scaled_dot_product_attention", library_backend=sdpa_backend(lib),
                library_device_ms=device_ms(lib, ""),  # every kernel of the call
                library_vs_kernel_max_abs=max_err(lib(), kern_out(), BF16_TOL),
                library_head_major_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    *heads_major, scale=scale, enable_gqa=True), iters=200),
                kv_bytes=kv_bytes,
                plan={**plan._asdict(), "blocks": plan.n_splits * Hkv * B},
                shape={"B": B, "C": C, "H": H, "Hkv": Hkv, "Dh": Dh, "cache_len": [n] * B,
                       "dtype": "bfloat16", "return_lse": with_lse})


def time_ssd(launches, errs, card, dev, label="mamba2-1.3b", case=None):
    from repro_torch.kernels import costs
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    case = case or SSD_CASES[0]
    B, S, H, P, N, Q, _ = case
    x, dt, A, Bm, Cm, _ = ssd_inputs(case, torch.bfloat16, dev, seed=5)
    work = costs.ssd_forward(B, S, H, P, N, Q, 2)
    nbytes, flops = work.bytes, work.flops
    b_ms, b_by = work_bound(work)
    kern = lambda: kssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q)  # noqa: E731
    return _row("ssd_scan", label, launches, errs, card,
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


def ssd_bwd_mma_flops(B, S, H, P, N, Q):
    """The products of ``kernels.costs.ssd_backward`` that the bf16 backward
    kernels run on the tensor cores, lower triangles only: G (two raw bf16 operands),
    (L o S)^T dY, g B, dY^T h_c and X^T g (an f32 operand split into hi + lo,
    so two bf16 products each). Returns (their bf16 FLOP, split terms
    counted; their FLOP counted once). The chunk's state gradient and M B,
    M^T C stay on f32 FMAs."""
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    per_head = 2 * tri * P, 2 * tri * P + 3 * 2 * Q * P * N  # raw x raw; split
    return (B * nc * H * (per_head[0] + 2 * per_head[1]),
            B * nc * H * (per_head[0] + per_head[1]))


def time_ssd_bwd(launches, errs, card, dev, label=SSM_TRAIN_LABEL, case=None):
    from repro_torch.kernels import costs
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.kernels import ssd_scan_bwd as kbwd
    case = case or SSD_TRAIN
    B, S, H, P, N, Q, _, _ = case
    x, dt, A, Bm, Cm, _ = ssd_inputs(case[:7], torch.bfloat16, dev, seed=5)
    dy = randn(torch.Generator().manual_seed(6), x.shape, torch.bfloat16, dev)
    # read x, dy, dt, A, B, C once, write dx, ddt, dA, dB, dC
    work = costs.ssd_backward(B, S, H, P, N, Q, 2)
    nbytes, flops = work.bytes, work.flops
    mma_flops, mma_flops_once = ssd_bwd_mma_flops(B, S, H, P, N, Q)
    b_ms, b_by = work_bound(work)
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
    return _row("ssd_scan_bwd", label, launches, errs, card,
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


def time_rglru(launches, errs, card, dev, label="recurrentgemma-9b", case=None):
    from repro_torch.kernels import costs
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as krglru
    case = case or RGLRU_CASES[0]
    B, S, W, _ = case
    x, a_log, _ = rglru_inputs(case, torch.bfloat16, dev, seed=6)
    work = costs.rglru_forward(B, S, W, 2)
    nbytes = work.bytes
    b_ms, b_by = work_bound(work)
    p = krglru.plan(B, S, W)
    # what this design moves: x and a_log read by the chunk kernel (all chunks
    # but the last) and again by the out kernel, y and h_last written, and the
    # f32 workspace (P and E written, read by the pass, E rewritten, then read
    # by the out kernel), were none of it held in the L2
    slots = B * (p.n_chunks - 1) * W
    design_bytes = (slots * p.chunk * 6 + x.numel() * (6 + 2) + B * W * 2
                    + slots * (8 + 8 + 4 + 4))
    kern = lambda: krglru.rglru_scan_cuda(x, a_log)  # noqa: E731
    return _row("rglru_scan", label, launches, errs, card,
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


def rglru_bwd_train_call(dev, case=None):
    """(x, a_log, dy, the backward kernel's call on them and the forward's
    workspace) at recurrentgemma-9b's train shape (or ``case``), bf16, no h0
    and no final-state cotangent, as the train step calls it."""
    from repro_torch.kernels import rglru_scan as krglru
    from repro_torch.kernels import rglru_scan_bwd as kbwd
    x, a_log, _, dy, _ = rglru_bwd_inputs(case or RGLRU_TRAIN, torch.bfloat16, dev, seed=6)
    _, _, ws = krglru._forward(x, a_log, None)
    return x, a_log, dy, lambda: kbwd.rglru_scan_bwd_cuda(x, a_log, None, dy, None,
                                                         fwd_workspace=ws)


def time_rglru_bwd(launches, errs, card, dev, label=RG_TRAIN_LABEL, case=None):
    from repro_torch.kernels import costs
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan_bwd as kbwd
    case = case or RGLRU_TRAIN
    B, S, W = case[:3]
    x, a_log, dy, kern = rglru_bwd_train_call(dev, case)
    # read x, a_log and dy once, write dx and da_log: 14 bytes an element
    work = costs.rglru_backward(B, S, W, 2)
    nbytes = work.bytes
    b_ms, b_by = work_bound(work)
    p = kbwd.plan(B, S, W)
    # what this design moves, were none of it held in the L2: x, a_log and dy
    # read once, dx and da_log written once; for each (b, chunk 1 .. nc - 1,
    # w) the forward's entering state read, P and E written (f32), and the
    # 8-byte carry out zeroed, written and read by the chunk to the left
    slots = B * (p.n_chunks - 1) * W
    design_bytes = x.numel() * (2 + 4 + 2 + 2 + 4) + slots * (4 + 8 + 8 + 8 + 8)
    # plain: autograd's backward through ref.rglru_scan, its graph built outside the timing
    leaves = [t.clone().requires_grad_(True) for t in (x, a_log)]
    y_p, _ = ref.rglru_scan(*leaves)
    plain_ms = time_ms(lambda: torch.autograd.grad(y_p, leaves, dy, retain_graph=True),
                       iters=2, warmup=1)
    del y_p, leaves
    torch.cuda.empty_cache()
    return _row("rglru_scan_bwd", label, launches, errs, card,
                ms=time_ms(kern, iters=20),
                device_ms=device_ms(kern, RGLRU_BWD_KERNELS, iters=20),
                device_ms_per_kernel={ph: device_ms(kern, RGLRU_BWD_KERNELS + ph, iters=20)
                                      for ph in RGLRU_BWD_PHASES},
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                design_floor_ms=design_bytes / HBM_BYTES_PER_S * 1e3, library_ms=None,
                library="none: no single PyTorch call computes an RG-LRU gradient",
                shape={"B": B, "S": S, "W": W, "x": "bfloat16", "a_log": "float32",
                       "dy": "bfloat16", "bytes": nbytes, "design_bytes": design_bytes,
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
            time_flash_bwd(FLASH_TRAIN, TRAIN_LABEL, launches, errs, card, dev),
            time_ssd_bwd(launches, errs, card, dev),
            time_flash_bwd(FLASH_TRAIN_RG, RG_TRAIN_LABEL, launches, errs, card, dev),
            time_rglru_bwd(launches, errs, card, dev),
            time_flash("internvl2-26b", launches, errs, card, dev),
            time_decode("internvl2-26b", launches, errs, card, dev),
            time_flash(HUBERT_TRAIN_LABEL, launches, errs, card, dev),
            time_flash_bwd(FLASH_TRAIN_HUBERT, HUBERT_TRAIN_LABEL, launches, errs, card, dev),
            time_flash(MIXTRAL_TRAIN_LABEL, launches, errs, card, dev),
            time_flash_bwd(FLASH_TRAIN_MIXTRAL, MIXTRAL_TRAIN_LABEL, launches, errs, card, dev),
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
                 "a fused backward needs; the kernels do 7 at every head dim (the scores "
                 "and dP once in each of the dK/dV and the dQ kernel)", "card": r["card"]}
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


def run_tp_scan_checks(dev):
    """The SSD and RG-LRU scans, forward and backward, at one rank's share
    under tensor parallelism (TP_SSD, TP_SSD_TRAIN, TP_RGLRU,
    TP_RGLRU_TRAIN), f32 and bf16, against their plain versions at the
    full-width cases' bounds; returns the bf16 max abs errors keyed by
    (kernel, label)."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kernel, check, cases in (("ssd_scan", check_ssd, TP_SSD),
                                     ("ssd_scan_bwd", check_ssd_bwd, TP_SSD_TRAIN),
                                     ("rglru_scan", check_rglru, TP_RGLRU),
                                     ("rglru_scan_bwd", check_rglru_bwd, TP_RGLRU_TRAIN)):
            for label, case in cases.items():
                err = check(case, dtype, dev)
                if dtype == torch.bfloat16:
                    errs[(kernel, label)] = err
    return errs


def run_tp_times(errs, card, dev):
    """The flash forward and backward and decode at one rank's heads under
    tensor parallelism (TP_PREFILL, TP_TRAIN, TP_DECODE), and the SSD and
    RG-LRU scans and their backward at one rank's share (TP_SSD,
    TP_SSD_TRAIN, TP_RGLRU, TP_RGLRU_TRAIN), timed as the full-width rows
    are and beside them: each with its bound from ``kernels.costs``, its
    plain version's time and, for attention, SDPA's. On one card the main
    path runs whole (a model axis of 1), so these shapes have no launches
    there; they are not rows of the kernels line."""
    kinds = ("flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
             "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd")
    launches = {lab: dict.fromkeys(kinds, 0)
                for lab in (*TP_PREFILL, *TP_TRAIN, *TP_DECODE, *KV_SEQ_DECODE, *TP_SSD,
                            *TP_SSD_TRAIN, *TP_RGLRU, *TP_RGLRU_TRAIN)}
    rows = [time_flash(lab, launches, errs, card, dev) for lab in (*TP_PREFILL, *TP_TRAIN)]
    rows += [time_flash_bwd(case, lab, launches, errs, card, dev) for lab, case in TP_TRAIN.items()]
    rows += [time_decode(lab, launches, errs, card, dev) for lab in (*TP_DECODE, *KV_SEQ_DECODE)]
    rows += [time_ssd(launches, errs, card, dev, lab, c) for lab, c in TP_SSD.items()]
    rows += [time_ssd_bwd(launches, errs, card, dev, lab, c) for lab, c in TP_SSD_TRAIN.items()]
    rows += [time_rglru(launches, errs, card, dev, lab, c) for lab, c in TP_RGLRU.items()]
    rows += [time_rglru_bwd(launches, errs, card, dev, lab, c)
             for lab, c in TP_RGLRU_TRAIN.items()]
    for r in rows:
        emit("tp_time", r)
        agree = r.get("library_vs_kernel_max_abs", r.get("library_vs_kernel_rel_rms"))
        if agree is not None and not agree[1]:
            fail(f"{r['name']}: the library call disagrees with the kernel")
    emit("tp_times", [{k: r[k] for k in ("name", "shape", "max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms", "card")}
                      for r in rows])
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
    fresh_peak(dev)
    params = serve.init_params(cfg, SERVE["seed"], dev)
    served = run_serve(cfg, params, dev, card)
    run_trace(cfg, params, dev)
    gen = torch.Generator().manual_seed(1)
    prompt = prompt_batch(cfg, torch.randint(0, cfg.vocab_size, (SERVE["batch"], PROMPT[arch]),
                                             generator=gen).to(dev), gen)
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


# hubert-xlarge encodes whole: 4 x 2048 f32 frames (its train shape), one
# flash call a layer; the median of ENCODE_CALLS timed calls after a warm-up
ENCODE = dict(arch="hubert-xlarge", batch=4, frames=2048)
ENCODE_CALLS = 5
ENCODE_EXPECTED = {"flash_attention": 48}


def encode_vs_plain(cfg, params, frames):
    """lm.prefill of ``frames`` with the kernels against the same model on
    the plain versions, in the config's dtype: the logits at the last frame
    and the keys that every layer caches (each layer's pass through all the
    layers before it, at every frame), bf16 within SERVE_BF16_REL_RMS (the
    keys too), f32 within SERVE_F32_ABS."""
    from repro_torch.models import lm
    S = frames.shape[1]
    kern, cache = lm.prefill(cfg, params, {"frames": frames}, S)
    kern, kk = kern.float(), cache["k"]
    del cache
    with plain_kernels():
        plain, cache = lm.prefill(cfg, params, {"frames": frames}, S)
    plain, pk = plain.float(), cache["k"]
    del cache
    bf16 = cfg.param_dtype == "bfloat16"
    out = {"n_layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "logits_max_abs": float((kern - plain).abs().max()),
           "logits_rel_rms": rel_rms(kern, plain),
           "keys_max_abs": float((kk.float() - pk.float()).abs().max()),
           "keys_rel_rms": rel_rms(kk, pk),
           "argmax_agree": float((kern.argmax(-1) == plain.argmax(-1)).float().mean()),
           "max_abs_logit": float(plain.abs().max()),
           "bound": ({"rel_rms": SERVE_BF16_REL_RMS[cfg.arch_id]} if bf16
                     else {"max_abs": SERVE_F32_ABS})}
    if bf16:
        ok = max(out["logits_rel_rms"], out["keys_rel_rms"]) <= out["bound"]["rel_rms"]
    else:
        ok = max(out["logits_max_abs"], out["keys_max_abs"]) <= SERVE_F32_ABS
    out["ok"] = bool(torch.isfinite(kern).all()) and bool(torch.isfinite(kk).all()) and ok
    del kern, plain, kk, pk
    torch.cuda.empty_cache()
    return out


def run_encode(dev, card):
    """hubert-xlarge at full width, 48 layers: lm.prefill of 4 x 2048 frames
    with the counters set to 0 just before (exactly ENCODE_EXPECTED, 0 plain
    calls), its median time, then encode_vs_plain in bf16 and, the bf16
    params freed, in f32 (3.8 GB). Returns the counted call's launches."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config
    cfg = get_config(ENCODE["arch"])
    fresh_peak(dev)
    params = serve.init_params(cfg, SERVE["seed"], dev)
    gen = torch.Generator().manual_seed(1)
    # f32 frames, as the pipeline gives them; lm casts them to the compute dtype
    frames = (torch.randn((ENCODE["batch"], ENCODE["frames"], cfg.d_model), generator=gen)
              * 0.02).to(dev)

    def encode():
        return lm.prefill(cfg, params, {"frames": frames}, ENCODE["frames"])
    encode()  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    zero_counters()
    logits, _ = encode()
    torch.cuda.synchronize()
    launches, plain_calls = read_counters()
    expected = {name: ENCODE_EXPECTED.get(name, 0) for name in launches}
    ms = []
    for _ in range(ENCODE_CALLS):
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"card": card, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
           "params": cfg.param_count(), **ENCODE, "dtype": cfg.param_dtype,
           "encode_ms": ms, "encode_ms_median": _pct(ms, 50),
           "frames_per_s": ENCODE["batch"] * ENCODE["frames"] / (_pct(ms, 50) / 1e3),
           "launches": launches, "expected_launches": expected, "plain_calls": plain_calls,
           "finite": bool(torch.isfinite(logits).all()),
           "logits_shape": list(logits.shape),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    emit("encode", out)
    if launches != expected:
        fail(f"encode: launch counts {launches} != expected {expected}")
    if plain_calls:
        fail(f"encode: called the plain versions {plain_calls} times")
    if not out["finite"] or out["logits_shape"] != [ENCODE["batch"], cfg.vocab_size]:
        fail(f"encode: logits {out['logits_shape']}, finite {out['finite']}")
    res = {"arch": cfg.arch_id, "bfloat16": encode_vs_plain(cfg, params, frames)}
    c32, p32 = f32_copy(cfg, params)
    del params, logits
    torch.cuda.empty_cache()
    res["float32"] = encode_vs_plain(c32, p32, frames)
    del p32
    torch.cuda.empty_cache()
    emit("encode_vs_plain", res)
    for name in ("bfloat16", "float32"):
        if not res[name]["ok"]:
            fail(f"encode: the kernels disagree with the plain versions in {name}: "
                 f"{res[name]}")
    return launches


def rglru_bwd_bits():
    """The RG-LRU backward's bits and time in the tree whose repro_torch this
    process imports, for two trees on one card: recurrentgemma-9b's 8 train
    steps (run_train: its train line holds the losses; first, while the
    allocator is fresh, since its peak is within 3 GB of the card's memory),
    rglru_bwd_digest, and the kernel's wrapper and device ms a call at the
    train shape (rglru_bwd_time). Run on a git archive of another tree as

        PYTHONPATH=<archive>/src python3 -c 'import chip_smoke; chip_smoke.rglru_bwd_bits()'

    from this tree's root: chip_smoke puts its own src after PYTHONPATH."""
    import repro_torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    torch.cuda.init()  # the allocator's statistics, which run_train resets, need it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit("tree", str(Path(repro_torch.__file__).resolve().parents[2]))
    _build.build_all(["rglru_scan", "rglru_scan_bwd", "flash_attention", "flash_attention_bwd"])
    run_train(dev, card, "recurrentgemma-9b")
    digests["rglru_bwd_digest"] = rglru_bwd_digest(dev)
    emit("rglru_bwd_digest", digests["rglru_bwd_digest"])
    errs.update(run_tp_scan_checks(dev))
    kern = rglru_bwd_train_call(dev)[3]
    emit("rglru_bwd_time", {"ms": time_ms(kern, iters=20),
                            "device_ms": device_ms(kern, RGLRU_BWD_KERNELS, iters=20),
                            "card": card})


def moe_train_bits():
    """mixtral-8x7b's train cell alone, in the tree whose repro_torch this
    process imports: the flash checks at its train shape (f32 and bf16), its
    8 train steps with the routing, trace, phase and repeat lines
    (run_train), train_vs_plain, and the flash forward's and backward's time
    rows at its train shape. Run as

        python3 -c 'import chip_smoke; chip_smoke.moe_train_bits()'

    (a git archive of another tree: PYTHONPATH=<archive>/src first)."""
    import repro_torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit("tree", str(Path(repro_torch.__file__).resolve().parents[2]))
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    global FLASH_BWD_CASES
    saved, FLASH_BWD_CASES = FLASH_BWD_CASES, [FLASH_TRAIN_MIXTRAL]
    try:
        errs = run_flash_bwd_checks(dev)
    finally:
        FLASH_BWD_CASES = saved
    launches = {MIXTRAL_TRAIN_LABEL: run_train(dev, card, "mixtral-8x7b")["launches"]}
    run_train_vs_plain(dev, "mixtral-8x7b")
    for row in (time_flash(MIXTRAL_TRAIN_LABEL, launches, errs, card, dev),
                time_flash_bwd(FLASH_TRAIN_MIXTRAL, MIXTRAL_TRAIN_LABEL, launches, errs, card,
                               dev)):
        emit("time", row)


def tp_bits():
    """The kernels at one rank's share under tensor parallelism alone, in the
    tree whose repro_torch this process imports: the flash forward, its
    backward and decode checked at TP_PREFILL, TP_TRAIN, TP_DECODE and
    KV_SEQ_DECODE, the
    SSD and RG-LRU scans and their backward at TP_SSD, TP_SSD_TRAIN,
    TP_RGLRU and TP_RGLRU_TRAIN (f32 and bf16), then their time rows
    (run_tp_times). Run as

        python3 -c 'import chip_smoke; chip_smoke.tp_bits()'"""
    import repro_torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit("tree", str(Path(repro_torch.__file__).resolve().parents[2]))
    _build.build_all(["flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
                      "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd"])
    global FLASH_CASES, DECODE_CASES, SSD_CASES, RGLRU_CASES, FLASH_BWD_CASES
    saved = FLASH_CASES, DECODE_CASES, SSD_CASES, RGLRU_CASES, FLASH_BWD_CASES
    FLASH_CASES = [*TP_PREFILL.values(), *TP_TRAIN.values()]
    DECODE_CASES = [*TP_DECODE.values(), *KV_SEQ_DECODE.values()]
    SSD_CASES, RGLRU_CASES = [], []
    FLASH_BWD_CASES = list(TP_TRAIN.values())
    try:
        errs = run_checks(dev)
        errs.update(run_flash_bwd_checks(dev))
    finally:
        FLASH_CASES, DECODE_CASES, SSD_CASES, RGLRU_CASES, FLASH_BWD_CASES = saved
    errs.update(run_tp_scan_checks(dev))
    run_tp_times(errs, card, dev)


def kv_seq_bits():
    """Decode's logsumexp and context-sharded decode's merge alone, in the
    tree whose repro_torch this process imports: the decode checks at every
    case of DECODE_CASES (output, logsumexp, bits with and without it), then
    kv_seq_merge. Run as

        python3 -c 'import chip_smoke; chip_smoke.kv_seq_bits()'"""
    import repro_torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit("tree", str(Path(repro_torch.__file__).resolve().parents[2]))
    _build.build_all(["decode_attention"])
    global FLASH_CASES, SSD_CASES, RGLRU_CASES
    saved = FLASH_CASES, SSD_CASES, RGLRU_CASES
    FLASH_CASES, SSD_CASES, RGLRU_CASES = [], [], []
    try:
        run_checks(dev)
    finally:
        FLASH_CASES, SSD_CASES, RGLRU_CASES = saved
    run_kv_seq_merge(dev)


def epoch_pass_bits():
    """The epoch pass's time and bits in the tree whose repro_torch this
    process imports, for two trees on one card: epoch_pass_times at the bench
    epoch; each simulate shape through the numpy pass and the kernel in
    turns (numpy, kernel, kernel, numpy), with the wall and pass seconds, the
    launches and a digest of the observations; and the experiment phase's
    configs through the kernel only, with walls, pass seconds, calls, the
    histogram of n and a digest of the reports. Run on a git archive of
    another tree as

        PYTHONPATH=<archive>/src python3 -c 'import chip_smoke; chip_smoke.epoch_pass_bits()'

    from this tree's root: chip_smoke puts its own src after PYTHONPATH."""
    import repro_torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    dev = torch.device("cuda", 0)
    card = card_line()

    def digest(x):
        text = json.dumps(x, sort_keys=True, default=lambda o: o.item() if hasattr(o, "item")
                          else str(o))
        return hashlib.sha256(text.encode()).hexdigest()

    emit("tree", str(Path(repro_torch.__file__).resolve().parents[2]))
    _build.build_all(["epoch_pass"])
    emit("epoch_pass_time", {**epoch_pass_times(dev), "card": card})
    for name, (nports, rate, dur) in SIM_SHAPES.items():
        runs = []
        for device in (None, "cuda", "cuda", None):
            zero_counters()
            obs, info, wall, pass_s = sim_run(nports, rate, dur, device)
            runs.append((device, obs, info.n_epochs, wall, pass_s, read_counters()))
        emit("epoch_simulate", {
            "shape": name, "digest": digest(runs[0][1]),
            "equal": all(r[1] == runs[0][1] for r in runs),
            "runs": [{"device": str(d), "wall_s": w, "pass_s": p, "n_epochs": e,
                      "launches": c[0]["epoch_pass"], "plain_calls": c[1]}
                     for d, _, e, w, p, c in runs], "card": card})
    walls, pass_s, ns, reports = 0.0, 0.0, [], {}
    for label, cfg in experiment_configs().items():
        got, wall, spent, _, cu_ns = experiment_run(cfg, "epoch-torch")
        walls, pass_s, ns, reports[label] = walls + wall, pass_s + spent, ns + cu_ns, got
    emit("epoch_experiment", {"digest": digest(reports), "wall_s": walls, "pass_s": pass_s,
                              "pass_n": tiles_histogram(ns), "card": card})


EPOCH_TILE_SHAPES = ((128, 4), (256, 2), (64, 4), (128, 2), (64, 8), (128, 8), (256, 4),
                     (256, 8), (512, 2))  # threads x frames a thread
EPOCH_SWEEP_N = (4096, EPOCH_BENCH_N, 1 << 20)


def epoch_tile_sweep():
    """The epoch pass's kernel built at each of EPOCH_TILE_SHAPES
    (-DEPOCH_PASS_THREADS, -DEPOCH_PASS_ITEMS; one nvcc each, started
    together, into build/), each run through epoch_pass_cuda with the
    module's tile set to match: bit-equal to the numpy pass at EPOCH_SWEEP_N
    and EPOCH_SEQUENCE, then the wrapper's ms and the kernel's device ms at
    EPOCH_SWEEP_N, beside the device time of a kernel that fills two words
    (device_floor_ms). Run as

        python3 -c 'import chip_smoke; chip_smoke.epoch_tile_sweep()'"""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import epoch_pass as kep
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    dev = torch.device("cuda", 0)
    card = card_line()
    out = _build.BUILD_DIR / "epoch_tile_sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for th, it in EPOCH_TILE_SHAPES:
        so = out / f"libepoch_pass_{th}x{it}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DEPOCH_PASS_THREADS={th}",
               f"-DEPOCH_PASS_ITEMS={it}", "-I", str(_build.CSRC), "-o", str(so),
               str(_build.CSRC / "epoch_pass.cu")]
        procs[(th, it)] = so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)
    saved = kep._launcher, kep.THREADS, kep.ITEMS, kep.TILE, kep.LOOKBACK
    words = torch.empty(2, dtype=torch.int64, device=dev)
    floor = device_ms(lambda: words.fill_(0), "FillFunctor")
    rows = []
    try:
        for (th, it), (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                fail(f"epoch_tile_sweep: nvcc failed at {th} x {it}:\n{log}")
            lib = ctypes.CDLL(str(so))
            fn = lib.epoch_pass_fwd
            fn.argtypes, fn.restype = kep.ARGTYPES, ctypes.c_int
            kep._launcher = lib, fn, torch._C._cuda_getCurrentRawStream
            kep.THREADS, kep.ITEMS, kep.TILE, kep.LOOKBACK = th, it, th * it, th
            kep.plan.cache_clear()
            if lib.epoch_pass_tile() != kep.TILE:
                fail(f"epoch_tile_sweep: the {th} x {it} library's tile is "
                     f"{lib.epoch_pass_tile()}")
            row = {"threads": th, "items": it, "tile": th * it,
                   "device_floor_ms": floor, "n": {}}
            for k, n in enumerate(EPOCH_SWEEP_N + EPOCH_SEQUENCE):
                (h, s, table, fids), busy0 = epoch_inputs(n, dev, seed=200 + k)
                if not epoch_equal(kep.epoch_pass_cuda(h, s, busy0, 1000, table, fids),
                                   epoch_numpy(h, s, busy0, 1000, table, fids)):
                    fail(f"epoch_tile_sweep: {th} x {it} differs from numpy at n {n}")
            for n in EPOCH_SWEEP_N:
                (h, s, table, fids), busy0 = epoch_inputs(n, dev, seed=n)
                kern = lambda: kep.epoch_pass_cuda(h, s, busy0, 1000, table, fids)  # noqa: E731
                row["n"][n] = {"tiles": kep.plan(n).tiles, "ms": time_ms(kern, iters=200),
                               "device_ms": device_ms(kern, "epoch_pass_")}
            rows.append(row)
            emit("epoch_tile", {**row, "card": card})
    finally:
        kep._launcher, kep.THREADS, kep.ITEMS, kep.TILE, kep.LOOKBACK = saved
        kep.plan.cache_clear()
    return rows


# --------------------------------------------------------------------------
# dry run: the kernels as torch.library ops, serving on a mesh, the op
# counter's counts of real steps against the same steps on fake tensors,
# and the production cells
# --------------------------------------------------------------------------

# the first 8 hex digits of each digest since it was first recorded: the
# ops around the launchers must change no bit
DIGEST_PINS = {"flash_forward_digest": "bd0afc5c", "rglru_bwd_digest": "e372b405"}
MESH_SERVE = ("qwen3-1.7b", "mixtral-8x7b")  # depth as in serve (DEPTH)
# (label, arch, step, seq_len, global batch, layers or None for all, on the
# (1, 1) mesh): one step each, on the card and on fake tensors
CALIBRATION = [
    ("qwen3-1.7b train", "qwen3-1.7b", "train", 2048, 4, None, False),
    ("qwen3-1.7b prefill", "qwen3-1.7b", "prefill", 512, 4, None, False),
    # a decode step over a cache of prompt + gen slots, every slot valid
    ("qwen3-1.7b decode", "qwen3-1.7b", "decode", 544, 4, None, False),
    ("mamba2-1.3b train", "mamba2-1.3b", "train", 2048, 4, None, False),
    ("mixtral-8x7b train", "mixtral-8x7b", "train", 4608, 2, 2, True),
]
# the production cells run here: qwen3-1.7b and mixtral-8x7b at every shape on
# both meshes, then every other arch's train_4k on (16, 16); the longest first
DRYRUN_CELLS = ([(a, s, "both") for a in MESH_SERVE
                 for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
                + [(a, "train_4k", "single") for a in PROMPT if a not in MESH_SERVE]
                + [("hubert-xlarge", "train_4k", "single")]
                # the recurrent blocks split over model (tp: the batch of 32
                # does not split over 256 ranks)
                + [(a, "prefill_32k", "single") for a in RECURRENT_SHARDING]
                # context-sharded decode where the heads do not split (24 over 16)
                + [("phi4-mini-3.8b", "decode_32k", "single")])
DRYRUN_WORKERS = 8  # dry-run processes at once: the host's 8 cores, this process waiting


def ops_bits(dev, digests):
    """The seven kernels' ``torch.library`` ops change no bit: both digests
    through the ops equal the bare launchers' (``digests``, this run's) and
    their pins."""
    got = {"flash_forward_digest": forward_digest(dev, through_op=True)["sha256"],
           "rglru_bwd_digest": rglru_bwd_digest(dev, through_op=True)["sha256"]}
    out = {k: {"through_op": got[k], "bare": digests[k], "pin": DIGEST_PINS[k],
               "ok": got[k] == digests[k] and got[k].startswith(DIGEST_PINS[k])}
           for k in got}
    emit("ops_bits", out)
    if not all(v["ok"] for v in out.values()):
        fail(f"ops_bits: a digest through the ops differs: {out}")


def decode_host(dev, card):
    """Host us of one qwen3-1.7b decode call (its serve shape, every row's
    cache at the middle decode step) through ``decode_attention_cuda`` (the
    checks and the op), through the op alone, and through the bare launcher
    the op wraps (``planned_launch``), in turns, in this process."""
    from repro_torch.kernels import decode_attention as kdec
    B, C, H, Hkv, Dh, _ = DECODE_SERVE["qwen3-1.7b"]
    n = PROMPT["qwen3-1.7b"] + SERVE["gen_len"] // 2 + 1
    q, kc, vc, cl = decode_inputs((B, C, H, Hkv, Dh, (n,) * B), torch.bfloat16, dev, seed=4)
    scale = Dh ** -0.5
    calls = {"wrapper": lambda: kdec.decode_attention_cuda(q, kc, vc, cl, softmax_scale=scale),
             "op": lambda: kdec.decode_op(q, kc, vc, cl, scale),
             "bare": lambda: kdec.planned_launch(q, kc, vc, cl, scale)}
    us = {k: [] for k in calls}
    for _ in range(3):
        for k, fn in calls.items():
            us[k].append(host_us(fn))
    med = {k: sorted(v)[1] for k, v in us.items()}
    return {"card": card, "shape": {"B": B, "C": C, "H": H, "Hkv": Hkv, "Dh": Dh,
                                    "cache_len": n},
            "host_us_median": med, "host_us_runs": us,
            "op_minus_bare_us": med["op"] - med["bare"]}


def greedy(cfg, params, prompt, gen):
    """Prefill ``prompt`` (B, S) and ``gen`` greedy decode steps, each ended by
    a synchronise: (every step's logits, the tokens, TTFT ms, each decode
    step's ms)."""
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    B, S = prompt.shape
    prefill, decode = make_prefill_step(cfg, S + gen), make_decode_step(cfg, S + gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    ttft = (time.perf_counter() - t0) * 1e3
    out, toks, tpot = [logits], [tok], []
    pos = torch.full((B,), S, dtype=torch.int32, device=prompt.device)
    for _ in range(gen):
        t0 = time.perf_counter()
        tok, logits, cache = decode(params, cache, tok, pos)
        torch.cuda.synchronize()
        tpot.append((time.perf_counter() - t0) * 1e3)
        out.append(logits)
        toks.append(tok)
        pos = pos + 1
    return out, toks, ttft, tpot


def mesh_serve(dev, card):
    """qwen3-1.7b (28 layers) and mixtral-8x7b (16 of 32) at full width: a
    batch of 4 prompts (PROMPT), prefill and 32 greedy decode steps without a
    mesh and on a (1, 1) NCCL mesh under ``single_pod_rules`` (params
    DTensors gathered where read, MoE layers on the sharded path), the
    counters zeroed before each; every logit and token bitwise equal, the
    launches of a prefill and 32 steps, 0 plain calls, TTFT and TPOT of
    both. Returns qwen3-1.7b's unsharded TPOT median."""
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import place_params
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.parallel import axes
    from repro_torch.parallel.axes import single_pod_rules
    tpot = None
    for arch in MESH_SERVE:
        cfg = get_config(arch)
        if arch in DEPTH:
            cfg = cfg.replace(n_layers=DEPTH[arch])
        fresh_peak(dev)
        params = serve.init_params(cfg, SERVE["seed"], dev)
        gen = torch.Generator().manual_seed(2)
        prompt = torch.randint(0, cfg.vocab_size, (SERVE["batch"], PROMPT[arch]),
                               generator=gen).to(dev, torch.int32)
        want = {"flash_attention": cfg.n_layers,
                "decode_attention": cfg.n_layers * SERVE["gen_len"]}
        runs = {}
        with one_rank_world(dev):
            mesh, rules = make_smoke_mesh(1, device_type="cuda"), single_pod_rules()
            with axes.axis_rules(rules, mesh):
                placed = place_params(params, rules, mesh)
            for name in ("unsharded", "mesh"):
                on_mesh = name == "mesh"
                p = placed if on_mesh else params
                with axes.axis_rules(rules, mesh) if on_mesh else contextlib.nullcontext():
                    greedy(cfg, p, prompt, 2)  # warm-up at the run's shapes
                    zero_counters()
                    logits, toks, ttft, steps = greedy(cfg, p, prompt, SERVE["gen_len"])
                launches, plain = read_counters()
                runs[name] = {"logits": logits, "tokens": toks, "ttft_ms": ttft,
                              "tpot_ms_median": _pct(steps, 50), "tpot_ms": steps,
                              "launches": {k: v for k, v in launches.items() if v},
                              "plain_calls": plain}
        a, b = runs["unsharded"], runs["mesh"]
        out = {"card": card, "arch": arch, "n_layers": cfg.n_layers,
               "batch": SERVE["batch"], "prompt_len": PROMPT[arch],
               "gen_len": SERVE["gen_len"], "mesh": [1, 1], "rules": "single_pod_rules",
               "logits_bitwise_equal": all(torch.equal(x, y)
                                           for x, y in zip(a["logits"], b["logits"])),
               "tokens_bitwise_equal": all(torch.equal(x, y)
                                           for x, y in zip(a["tokens"], b["tokens"])),
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               **{f"{n}_{k}": r[k] for n, r in runs.items()
                  for k in ("ttft_ms", "tpot_ms_median", "launches", "plain_calls")},
               "expected_launches": want}
        emit("mesh_serve", out)
        if not (out["logits_bitwise_equal"] and out["tokens_bitwise_equal"]):
            fail(f"mesh_serve: {arch} on the (1, 1) mesh differs from the unsharded run")
        if any(r["launches"] != want or r["plain_calls"] for r in runs.values()):
            fail(f"mesh_serve: {arch} launches {[r['launches'] for r in runs.values()]} "
                 f"(expected {want}) or plain calls")
        if arch == "qwen3-1.7b":
            tpot = a["tpot_ms_median"]
        del params, placed, runs, a, b
        torch.cuda.empty_cache()
    return tpot


def calibration_config(arch, layers):
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    return cfg.replace(n_layers=layers) if layers else cfg


def calibration_inputs(cfg, kind, seq_len, batch, dev):
    """A step's real inputs at the dry run's shapes and dtypes
    (``launch/inputs.step_specs``): random tokens and labels, a zeroed cache
    at position seq_len - 1 for decode."""
    from repro_torch.models import lm
    gen = torch.Generator().manual_seed(3)

    def tokens(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen).to(dev, torch.int32)
    if kind == "train":
        return ({"tokens": tokens(batch, seq_len), "labels": tokens(batch, seq_len)},)
    if kind == "prefill":
        return ({"tokens": tokens(batch, seq_len)},)
    return (lm.init_cache(cfg, batch, seq_len, dev), tokens(batch),
            torch.full((batch,), seq_len - 1, dtype=torch.int32, device=dev))


def fake_calibration():
    """The CALIBRATION steps on fake tensors (the dry run's ``count_step``),
    the mesh's in a fake world of one rank: one JSON line of counts, per-op
    tallies and memory. Runs in a process of its own:

        python3 -c 'import chip_smoke; chip_smoke.fake_calibration()'"""
    from repro_torch.launch.dryrun import count_step, fake_world
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.axes import single_pod_rules
    out = {}
    for label, arch, kind, seq_len, batch, layers, on_mesh in CALIBRATION:
        cfg = calibration_config(arch, layers)
        with fake_world(1) if on_mesh else contextlib.nullcontext():
            mesh = make_smoke_mesh(1, device_type="cuda") if on_mesh else None
            got = count_step(cfg, kind, seq_len, batch, mesh=mesh,
                             rules=single_pod_rules() if on_mesh else None)
        out[label] = {"counts": got["cost"].counts(), "by_op": got["cost"].by_op,
                      "memory": got["memory"], "flop_counter": got["flop_counter"],
                      "trace_s": got["trace_s"]}
    print(json.dumps(out))


def calibrate(dev, card):
    """Each CALIBRATION step on the card: its device ms (CUDA events, the
    median of 3 after a warm-up) and peak (``fresh_peak`` with the step's
    arguments allocated), then once more under the op counter."""
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import count_step, place_params
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel import axes
    from repro_torch.parallel.axes import single_pod_rules
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step, make_train_step
    rows = []
    for label, arch, kind, seq_len, batch, layers, on_mesh in CALIBRATION:
        cfg = calibration_config(arch, layers)
        fresh_peak(dev)
        with one_rank_world(dev) if on_mesh else contextlib.nullcontext():
            mesh = make_smoke_mesh(1, device_type="cuda") if on_mesh else None
            rules = single_pod_rules() if on_mesh else None

            def on_rules():
                return axes.axis_rules(rules, mesh) if on_mesh else contextlib.nullcontext()
            opt_cfg, opt_state = adamw.AdamWConfig(), None
            params = serve.init_params(cfg, SERVE["seed"], dev)
            with on_rules():
                if on_mesh:
                    params = place_params(params, rules, mesh)
                if kind == "train":
                    opt_state = adamw.init(opt_cfg, params)
            inputs = calibration_inputs(cfg, kind, seq_len, batch, dev)
            args = (params, opt_state, *inputs) if kind == "train" else (params, *inputs)
            step = (make_train_step(cfg, opt_cfg) if kind == "train" else
                    make_prefill_step(cfg, seq_len) if kind == "prefill" else
                    make_decode_step(cfg))
            times = []
            with on_rules():
                step(*args)  # warm-up
                fresh_peak(dev)
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    step(*args)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated(dev)
            counted = count_step(cfg, kind, seq_len, batch, mesh=mesh, rules=rules, device=dev,
                                 params=params, opt_state=opt_state, inputs=inputs)
            del params, opt_state, inputs, args
            gc.collect()
            torch.cuda.empty_cache()
        rows.append({"label": label, "cfg": cfg, "on_mesh": on_mesh, "seq_len": seq_len,
                     "batch": batch, "times": times, "peak": peak, "counted": counted})
    return rows


def check_calibration(rows, fake, card):
    """Each calibration step's counts on the card against ``fake``'s
    (fake_calibration's), its roofline bound beside its device ms and its
    predicted peak beside the measured one: one ``calibration`` line each.
    Fails where the counts differ or a bound exceeds its measured time."""
    from repro_torch.parallel import analysis
    out = []
    for r in rows:
        cost, want = r["counted"]["cost"], fake[r["label"]]
        counts = cost.counts()
        roof = analysis.Roofline(cost.dot_flops, cost.hbm_bytes, cost.total_wire_bytes, 1,
                                 nvlink_wire_bytes_per_device=cost.nvlink_wire_bytes)
        device_ms = sorted(r["times"])[1]
        bound_ms = roof.step_time_lower_bound * 1e3
        mem = want["memory"]
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        row = {"card": card, "label": r["label"], "seq_len": r["seq_len"],
               "global_batch": r["batch"], "n_layers": r["cfg"].n_layers,
               "mesh": [1, 1] if r["on_mesh"] else None,
               "counts_equal": counts == want["counts"], "counts": counts,
               "fake_counts": "equal" if counts == want["counts"] else want["counts"],
               "ops_that_differ": {k: (cost.by_op.get(k), want["by_op"].get(k))
                                   for k in set(cost.by_op) | set(want["by_op"])
                                   if cost.by_op.get(k) != want["by_op"].get(k)},
               "flop_counter": r["counted"]["flop_counter"], "device_ms": device_ms,
               "device_ms_runs": r["times"], "bound_ms": bound_ms,
               "bound_over_measured": bound_ms / device_ms,
               "t_compute_ms": roof.t_compute * 1e3, "t_memory_ms": roof.t_memory * 1e3,
               "bottleneck": roof.bottleneck, "peak_gb_measured": r["peak"] / 1e9,
               "peak_gb_predicted": predicted / 1e9,
               "peak_predicted_over_measured": predicted / r["peak"],
               "fake_trace_s": want["trace_s"], "counted_step_s": r["counted"]["trace_s"]}
        emit("calibration", row)
        out.append(row)
    bad = [r["label"] for r in out if not r["counts_equal"]]
    if bad:
        fail(f"calibration: fake counts differ from the card's in {bad}")
    over = [r["label"] for r in out if r["bound_ms"] > r["device_ms"]]
    if over:
        fail(f"calibration: the roofline bound exceeds the measured device time in {over}")
    return out


def _subprocess_env():
    """This tree's src first on PYTHONPATH, as chip_smoke imports it."""
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                               else []))}


def dryrun_cells(pool):
    """DRYRUN_CELLS through ``python -m repro_torch.launch.dryrun``, one
    process a cell (its fake world cannot share this process with an NCCL
    group), on ``pool``: futures of (cell, records, exit code, stderr tail,
    wall s)."""
    def one(cell):
        arch, shape, mesh = cell
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", mesh]
        out = subprocess.run(cmd, capture_output=True, text=True, env=_subprocess_env(),
                             cwd=str(ROOT), timeout=900)
        recs = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
        return cell, recs, out.returncode, out.stderr[-2000:], time.perf_counter() - t0
    return [pool.submit(one, cell) for cell in DRYRUN_CELLS]


def run_dryrun(dev, card, digests):
    """The ``dryrun`` phase: ops_bits; the decode host us through the op
    beside the bare launcher, with qwen3-1.7b's TPOT; mesh_serve; the
    calibration steps on the card, then, in processes of their own,
    DRYRUN_WORKERS at once, the same steps on fake tensors and the
    production cells."""
    from concurrent.futures import ThreadPoolExecutor
    ops_bits(dev, digests)
    host = decode_host(dev, card)
    tpot = mesh_serve(dev, card)
    emit("decode_host", {**host, "qwen3_tpot_ms_median": tpot})
    rows = calibrate(dev, card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
        cmd = [sys.executable, "-c", "import chip_smoke; chip_smoke.fake_calibration()"]
        fake = pool.submit(subprocess.run, cmd, capture_output=True, text=True, cwd=str(ROOT),
                           env=_subprocess_env(), timeout=900)
        cells = [f.result() for f in dryrun_cells(pool)]
        fake = fake.result()
    if fake.returncode:
        fail(f"fake_calibration: {fake.stderr[-3000:]}")
    checked = check_calibration(rows, json.loads(fake.stdout.strip().splitlines()[-1]), card)
    failed = []
    for (arch, shape, mesh), recs, code, err, wall in cells:
        if code or not recs:
            failed.append((arch, shape, mesh, code, err))
        for r in recs:
            emit("dryrun_cell", {**{k: r.get(k) for k in (
                "arch", "shape", "mesh", "layout", "status", "reason", "n_devices",
                "roofline", "memory", "collective_counts", "collective_wire_bytes",
                "kernel_calls", "trace_s", "batch", "cache_layout")}, "process_s": wall})
    emit("dryrun_summary", {"processes_s": time.perf_counter() - t0, "cells": len(cells),
                            "workers": DRYRUN_WORKERS,
                            "calibration_bound_and_device_ms": {
                                r["label"]: [r["bound_ms"], r["device_ms"]] for r in checked}})
    if failed:
        fail(f"dryrun: cells failed: {failed}")


def dryrun_bits():
    """The dryrun phase alone, after the two digests it compares with, in the
    tree whose repro_torch this process imports. Run as

        python3 -c 'import chip_smoke; chip_smoke.dryrun_bits()'"""
    import repro_torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        fail("no CUDA device; this runs on the card only")
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit("tree", str(Path(repro_torch.__file__).resolve().parents[2]))
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    digests = {"flash_forward_digest": forward_digest(dev)["sha256"],
               "rglru_bwd_digest": rglru_bwd_digest(dev)["sha256"]}
    run_dryrun(dev, card, digests)
    emit("dryrun_bits_s", time.perf_counter() - t0)


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
    run_kv_seq_merge(dev)
    digests = {"flash_forward_digest": forward_digest(dev)}
    emit("flash_forward_digest", digests["flash_forward_digest"])
    launches = {}
    launches["bench"], errs[("burst_gather", "bench")] = run_gather(dev)
    errs[("epoch_pass", SIM_LABEL)] = run_epoch_checks(dev)
    launches.update(run_simulate(dev, card))
    launches.update(run_experiments(card))
    run_serving_sim(card)
    errs.update(run_flash_bwd_checks(dev))
    errs[("ssd_scan_bwd", SSM_TRAIN_LABEL)] = run_ssd_bwd_checks(dev)
    errs[("rglru_scan_bwd", RG_TRAIN_LABEL)] = run_rglru_bwd_checks(dev)
    digests["rglru_bwd_digest"] = rglru_bwd_digest(dev)
    emit("rglru_bwd_digest", digests["rglru_bwd_digest"])
    errs.update(run_tp_scan_checks(dev))
    launches.update({arch: run_arch(arch, dev, card) for arch in PROMPT})
    launches[f"{ENCODE['arch']} encode"] = run_encode(dev, card)
    for arch in TRAIN_FEEDS:
        train = run_train(dev, card, arch)
        launches[f"{arch} train"] = train["launches"]
        run_train_vs_plain(dev, arch)
        if arch == SHARDING_ARCH:
            run_sharding(dev, card, train)
    run_recurrent_sharding(dev, card)
    for arch in TRAIN_VS_PLAIN_ONLY:
        run_train_vs_plain(dev, arch)
    run_restart(dev)
    run_dryrun(dev, card, {k: v["sha256"] for k, v in digests.items()})
    rows = run_times(launches, errs, card, dev)
    run_tp_times(errs, card, dev)

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
