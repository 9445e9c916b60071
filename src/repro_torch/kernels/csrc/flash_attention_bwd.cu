// Backward of GQA flash attention for Hopper (sm_90a): bf16 on the tensor
// cores, f32 on the CUDA cores; f32 math in both.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py:92
// flash_attention_pallas. The JAX package has no backward kernel: it
// differentiates through its chunked jnp path under jax.checkpoint
// (src/repro/kernels/ops.py:98 and :179). This computes the gradient of the
// function the forward kernel (flash_attention.cu) computes, from what the
// forward saved: q, k, v, the output o and the logsumexp lse.
//
// What it computes, per (b, h) with kv head h / group, scale s and the
// causal / window / q_offset mask M:
//   D   = rowsum(dO * O)                       (kernel 1, both dtypes)
//   P   = exp(s * Q K^T - lse) on M, 0 off it  (recomputed, never stored)
//   dV  = P^T dO,   dS = P * (dO V^T - D)
//   dK  = s * dS^T Q                           (kernel 2, dV too)
//   dQ  = s * dS K                             (kernel 3)
// A row with no visible key has lse = +inf from the forward, so its P row is
// 0 and it contributes nothing and gets dQ = 0, as autograd through ref.mha
// gives.
//
// No floating-point atomics, in any body, so a step is bit-stable from run
// to run: every output element is summed in one block in a fixed order and
// written once, or, where the wide body spreads a GQA group over several
// blocks (below), summed from their f32 partials by a second kernel in a
// fixed order. Kernel 2 owns one (kv tile, kv head, batch row) and sums over
// the GQA group's query heads (or a subset of them) and, for each, the query
// tiles that can see the tile (the causal and window limits bound that range
// up front). Kernel 3 owns one (query tile, head, batch row) and loops over
// the kv tiles its rows can see, as the forward does. Both recompute the
// scores and dP: 7 products a visible (query, key) pair where one fused
// kernel would need 5, the price of having no atomics.
//
// Three bodies; the dtype and Dh pick one.
//
// bf16 up to Dh 128 (namespace mma: flash_bwd_dkdv_mma_kernel,
// flash_bwd_dq_mma_kernel). mma.sync m16n8k16 bf16 products with f32
// accumulation, operands by ldmatrix from rows padded by 16 bytes, tiles
// moved by cp.async of 16 bytes a thread with rows past Sq or Skv and columns
// past Dh zero-filled; the helpers are the forward's (mma.cuh). Each warp
// owns 16 rows of its block's tile.
// - Kernel 2 takes keys as the M dimension: each warp computes S^T = K.Q^T
//   and dP^T = V.dO^T for its 16 keys against a tile of BQ queries, so that
//   the accumulators of P^T = exp2(S^T scale log2 e - lse log2 e) (the lse
//   and D of the tile's query columns come from shared memory) and of
//   dS^T = P^T * (dP^T - D), packed to bf16, are the A operands of
//   dV += P^T.dO and dK += dS^T.Q, dO and Q through ldmatrix .trans. K and V
//   stay in shared memory for the whole block (a warp reads only its own 16
//   rows); the Q and dO tiles, with their lse and D, are double-buffered:
//   step t+1 is in flight while step t is multiplied. The steps run over the
//   group's heads and, for each, the query tiles from the first that can see
//   the kv tile. Under causal the blocks take the kv tiles heaviest first
//   (tile 0 sees every query tile), so the long blocks start in the first
//   wave. dK is scaled once, at the store; dK and dV are staged in the
//   warp's own K and V rows and stored as 16-byte rows.
// - Kernel 3 is the forward's layout: S = Q.K^T with Q's fragments in
//   registers, dP = dO.V^T with dO from shared memory, P and
//   dS = P * (dP - D) in the accumulators (each lane holds the lse and D of
//   its two rows), dQ += dS.K with K through ldmatrix .trans; K and V tiles
//   double-buffered by cp.async; the query tiles heaviest first.
// The element mask is applied only in tiles that cross the causal diagonal,
// the window edge or (kernel 3) Skv. P and dS are rounded to bf16 only as A
// operands; the sums are f32. The recomputed scores are the forward's bf16
// products (exact in f32) summed in another order, so the rows of
// exp(s - lse) sum to 1 within rounding (chip_smoke.py holds them there).
// Instantiated for Dh 32, 64 and 128; another multiple of 16 runs on the
// next instantiation with its extra columns zero and skipped. The inputs
// must start on 16-byte boundaries (the wrapper checks). A failed launch
// returns its error: there is no other bf16 path.
//
// bf16 from Dh 144 to 256 (the wide body: flash_bwd_dkdv_wide_kernel,
// flash_bwd_dq_wide_kernel, flash_bwd_dkdv_sum_kernel), the same two kernels
// on the same helpers, laid out for a head dim whose accumulators do not fit
// one warp (see Head dims).
//
// f32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): the same two kernels
// with f32 FMAs on the CUDA cores (the tensor cores would round f32 to TF32,
// and train_vs_plain, restart and every f32 check hold the f32 gradient to
// 1e-4). A block of 256 threads recomputes 64 x 64 tiles of S and dP, each
// thread 4 rows x 4 columns, from f32 tiles in shared memory (padded pitch
// Dh + 1); in f32 the scores are the forward's own order. At Dh 256 the
// tiles are 32 x 32, each thread 2 x 2: four 64-row tiles at pitch 257 would
// take 263 KB of shared memory, four of 32 rows take 132 KB.
//
// Head dims: a multiple of 16 up to 256 (qwen3's 128 and recurrentgemma's
// 256 included). A warp's dK and dV accumulators (16 keys x Dh) take 128
// registers a thread at Dh 128; at Dh 256 they would take 256, more than a
// thread has beside the score tiles. So past 128 the bf16 body gives each
// 16 rows (keys in kernel 2, query rows in kernel 3) a pair of warps, warp w
// and warp w + 4 of a block of 8 (two warpgroups), which split the output
// columns: the first 16 * ceil(Dh / 32) to warp w, the rest to warp w + 4
// (128 and 128 at Dh 256). The pair computes S and dP once, each over the
// whole Dh: warp w the scores and P, warp w + 4 dP. Warp w puts P (f32) in
// the pair's exchange buffer in shared memory; warp w + 4 takes it, forms
// dS = P * (dP - D) and puts dS back as the bf16 A operands both multiply
// with; a named barrier of the two warps orders each hand-over. Then each
// warp multiplies P and dS into its own columns: S, dP, dV and dK in kernel
// 2, S, dP and dQ in kernel 3, 7 products a pair as below Dh 128. The two
// warps of a pair run on one of the SM's four schedulers (warp w and
// w + 4), so while one waits at the barrier the other keeps that scheduler's
// tensor core fed. Both kernels take 64-row tiles and steps of 64 (queries in
// kernel 2, keys in kernel 3), double-buffered by cp.async. Kernel 2's
// shared memory (228 352 bytes: K, V, two Q / dO stages, 24 KB of exchange)
// and kernel 3's (227 328) hold one 8-warp block an SM, two warps a
// scheduler. In kernel 2 the 64 keys of a tile see up to 33 query tiles of
// each of the group's heads, and at Hkv 1 the kv tiles alone give few blocks
// (192 at recurrentgemma-9b's train shape, 1.45 waves on 132 SMs). So where
// they give fewer than two waves, the host plan (flash_attention_bwd.py)
// splits each GQA group into contiguous head subsets, one block each (two at
// that shape: 384 blocks). Such a block writes its f32 sums of dK
// (unscaled) and dV to a workspace; flash_bwd_dkdv_sum_kernel then adds the
// subsets in order, scales dK and writes both in bf16. With one subset the
// block writes dk and dv itself. The f32 body keeps its accumulators whole:
// 32-key tiles at Dh 256 hold as many (2 keys x 16 columns a thread) as
// 64-key tiles at Dh 128.
//
// What bounds it on the H100. At qwen3-1.7b's train shape (B 4, S 2048, H 16,
// Hkv 8, Dh 128, causal, bf16) the gradient needs 5 products of 2 * Dh FLOP
// per visible (query, key) pair and head (the scores recomputed, dP, dV, dK,
// dQ): 172 GFLOP, 0.17 ms at the tensor cores' 989 TFLOP/s, above the 0.04 ms
// of reading q, k, v, o, dO and writing dq, dk, dv. At recurrentgemma-9b's
// train shape (B 4, S 3072, H 16, Hkv 1, Dh 256, a 2048-key window, bf16)
// the same count is 687 GFLOP over 4.2 M visible pairs per (b, h): 0.70 ms,
// above the 0.13 ms of its 428 MB of reads and writes. Both bf16 bodies do 7
// such products on mma.sync, which reaches only part of Hopper's rate: every
// B operand goes through ldmatrix from shared memory, and one ldmatrix of a
// 16 x 16 fragment (512 bytes, 4 clocks of an SM's 128 bytes a clock) feeds
// two m16n8k16 products (2 clocks of the SM's tensor cores at 989 TFLOP/s),
// so shared memory caps them near half that rate. Below Dh 128 kernel 2's
// accumulators leave room for two blocks of 4 warps an SM, past it one block
// of 8. One fused pass (dQ summed across blocks in a deterministic second
// pass) and wgmma tiles fed by TMA are the way further down. PERF.md holds
// the measured times beside the bound.

#include "common.cuh"
#include "mma.cuh"

#include <math.h>

namespace {

constexpr int NT = 256;  // f32 body threads: 16 x 16, each owning a square of a score tile

// D[b,h,s] = sum_d dO[b,s,h,d] * O[b,s,h,d]: one warp per (b, s, h) row.
template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dot_kernel(
    const T* __restrict__ dout, const T* __restrict__ o, float* __restrict__ D, long rows,
    int Sq, int H, int Dh) {
  const long row = (long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = dout + row * Dh;
  const T* c = o + row * Dh;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32)
    acc = fmaf(repro::to_f32(a[d]), repro::to_f32(c[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long h = row % H, bs = row / H, s = bs % Sq, b = bs / Sq;
    D[(b * H + h) * Sq + s] = acc;
  }
}

template <typename T>
cudaError_t launch_dot(const void* dout, const void* o, float* D, int B, int Sq, int H,
                       int Dh, cudaStream_t st) {
  const long rows = (long)B * Sq * H;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o), D, rows, Sq, H, Dh);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// f32 body: FMAs on the CUDA cores
// --------------------------------------------------------------------------

// Tiles of TT query rows and TT keys (64 up to Dh 128, 32 at Dh 256, where
// four 64-row tiles at pitch Dh + 1 would not fit a block's shared memory);
// thread (ty, tx) of the 16 x 16 owns rows ty + 16 i and columns tx + 16 j,
// i, j < TT / 16, of a score tile.
__host__ __device__ constexpr size_t smem_floats(int dh, int tt) {
  // four (tt x (dh+1)) row tiles, two (tt x (tt+1)) score tiles, lse and D
  return 4 * (size_t)tt * (dh + 1) + 2 * (size_t)tt * (tt + 1) + 2 * (size_t)tt;
}

// Load `n` rows (of `rows` in the tile) of a head's Dh columns, padded
// pitch; rows past n are 0.
__device__ __forceinline__ void load_tile(float* dst, const float* src, long row_stride, int n,
                                          int rows, int Dh) {
  const int qp = Dh + 1;
  for (int i = threadIdx.x; i < rows * Dh; i += NT) {
    const int r = i / Dh, d = i - r * Dh;
    dst[r * qp + d] = r < n ? src[r * row_stride + d] : 0.f;
  }
}

// The TT x TT tiles of P and dS for query rows q0.. (nq valid) against keys
// k0.. (nk valid), from Qs, dOs, Ks, Vs, Ls, Ds in shared memory. Thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j. Writes Ps and dSs.
template <int TT>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs, const float* Ks,
                                            const float* Vs, const float* Ls, const float* Ds,
                                            float* Ps, float* dSs, int q0, int nq, int k0,
                                            int nk, int Dh, int causal, int window,
                                            int q_offset, float scale) {
  constexpr int R = TT / 16;
  const int qp = Dh + 1, pp = TT + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < Dh; ++d) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = Qs[(ty + 16 * i) * qp + d];
      ov[i] = dOs[(ty + 16 * i) * qp + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = Ks[(tx + 16 * j) * qp + d];
      vv[j] = Vs[(tx + 16 * j) * qp + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r + q_offset;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      bool ok = r < nq && c < nk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;  // lse +inf → 0
      Ps[r * pp + c] = p;
      dSs[r * pp + c] = p * (dp[i][j] - Ds[r]);
    }
  }
}

// dK and dV for one (kv tile, kv head, batch row).
template <int NC, int TT>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H, int Hkv, int Dh,
    int causal, int window, int q_offset, float scale) {
  constexpr int BQ = TT, BK = TT, R = TT / 16;
  extern __shared__ float smem[];
  const int qp = Dh + 1, pp = BK + 1;
  float* Ks = smem;             // BK x qp
  float* Vs = Ks + BK * qp;     // BK x qp
  float* Qs = Vs + BK * qp;     // BQ x qp
  float* dOs = Qs + BQ * qp;    // BQ x qp
  float* Ps = dOs + BQ * qp;    // BQ x pp
  float* dSs = Ps + BQ * pp;    // BQ x pp
  float* Ls = dSs + BQ * pp;    // BQ
  float* Ds = Ls + BQ;          // BQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int nk = min(BK, Skv - k0);
  const int nc = Dh >> 4;
  const long q_row = (long)H * Dh, kv_row = (long)Hkv * Dh;
  const long kv_off = ((long)b * Skv + k0) * kv_row + (long)kvh * Dh;

  load_tile(Ks, k + kv_off, kv_row, nk, BK, Dh);
  load_tile(Vs, v + kv_off, kv_row, nk, BK, Dh);

  // the query rows that can see a key of this tile
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = max(0, min(Sq, k0 + nk - 1 + window - q_offset));

  float dk_acc[R][NC], dv_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const float* lse_h = lse + ((long)b * H + h) * Sq;
    const float* D_h = D + ((long)b * H + h) * Sq;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      const int nq = min(BQ, Sq - q0);
      const long q_off = ((long)b * Sq + q0) * q_row + (long)h * Dh;
      __syncthreads();  // the previous tile's Qs, dOs, Ps, dSs are read
      load_tile(Qs, q + q_off, q_row, nq, BQ, Dh);
      load_tile(dOs, dout + q_off, q_row, nq, BQ, Dh);
      if (tid < BQ) {
        Ls[tid] = tid < nq ? lse_h[q0 + tid] : INFINITY;
        Ds[tid] = tid < nq ? D_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      score_tiles<TT>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, nq, k0, nk, Dh, causal, window,
                      q_offset, scale);
      __syncthreads();
      // dV[c] += sum_r P[r][c] dO[r];  dK[c] += sum_r dS[r][c] Q[r]
      for (int r = 0; r < nq; ++r) {
        float p[R], ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = Ps[r * pp + ty + 16 * i];
          ds[i] = dSs[r * pp + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) {
            const float ov = dOs[r * qp + tx + 16 * c], qv = Qs[r * qp + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              dv_acc[i][c] = fmaf(p[i], ov, dv_acc[i][c]);
              dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = ty + 16 * i;
    if (c < nk) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        if (cc < nc) {
          const long off = kv_off + (long)c * kv_row + tx + 16 * cc;
          dk[off] = dk_acc[i][cc] * scale;
          dv[off] = dv_acc[i][cc];
        }
    }
  }
}

// dQ for one (query tile, head, batch row).
template <int NC, int TT>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dq, int Sq, int Skv, int H, int Hkv, int Dh, int causal, int window,
    int q_offset, float scale) {
  constexpr int BQ = TT, BK = TT, R = TT / 16;
  extern __shared__ float smem[];
  const int qp = Dh + 1, pp = BK + 1;
  float* Qs = smem;             // BQ x qp
  float* dOs = Qs + BQ * qp;    // BQ x qp
  float* Ks = dOs + BQ * qp;    // BK x qp
  float* Vs = Ks + BK * qp;     // BK x qp
  float* Ps = Vs + BK * qp;     // BQ x pp
  float* dSs = Ps + BQ * pp;    // BQ x pp
  float* Ls = dSs + BQ * pp;    // BQ
  float* Ds = Ls + BQ;          // BQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int nq = min(BQ, Sq - q0);
  const int nc = Dh >> 4;
  const long q_row = (long)H * Dh, kv_row = (long)Hkv * Dh;
  const long q_off = ((long)b * Sq + q0) * q_row + (long)h * Dh;

  load_tile(Qs, q + q_off, q_row, nq, BQ, Dh);
  load_tile(dOs, dout + q_off, q_row, nq, BQ, Dh);
  if (tid < BQ) {
    const long base = ((long)b * H + h) * Sq + q0;
    Ls[tid] = tid < nq ? lse[base + tid] : INFINITY;
    Ds[tid] = tid < nq ? D[base + tid] : 0.f;
  }

  // the kv positions any row of this tile may see (as in the forward)
  const int qpos_lo = q0 + q_offset, qpos_hi = q0 + nq - 1 + q_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = max(0, min(Skv, qpos_hi + 1));
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);

  float acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    const int nk = min(BK, kv_hi - k0);
    const long kv_off = ((long)b * Skv + k0) * kv_row + (long)kvh * Dh;
    __syncthreads();  // Qs, dOs written; the previous tile's Ks, dSs read
    load_tile(Ks, k + kv_off, kv_row, nk, BK, Dh);
    load_tile(Vs, v + kv_off, kv_row, nk, BK, Dh);
    __syncthreads();
    score_tiles<TT>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, nq, k0, nk, Dh, causal, window,
                    q_offset, scale);
    __syncthreads();
    // dQ[r] += sum_c dS[r][c] K[c]
    for (int c = 0; c < nk; ++c) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(ty + 16 * i) * pp + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        if (cc < nc) {
          const float kv = Ks[c * qp + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][cc] = fmaf(ds[i], kv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        if (cc < nc) dq[q_off + (long)r * q_row + tx + 16 * cc] = acc[i][cc] * scale;
    }
  }
}

template <int NC, int TT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* D, void* dq, void* dk,
                   void* dv, int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                   int window, int q_offset, float scale, cudaStream_t st) {
  // one opt-in per instantiation and device, for the instantiation's largest Dh
  static std::atomic<bool> dkdv_set[repro::kMaxDevices], dq_set[repro::kMaxDevices];
  const int max_bytes = (int)(smem_floats(16 * NC, TT) * sizeof(float));
  cudaError_t e = repro::opt_in_smem(flash_bwd_dkdv_kernel<NC, TT>, max_bytes, dkdv_set);
  if (e != cudaSuccess) return e;
  e = repro::opt_in_smem(flash_bwd_dq_kernel<NC, TT>, max_bytes, dq_set);
  if (e != cudaSuccess) return e;
  const size_t bytes = smem_floats(Dh, TT) * sizeof(float);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);

  if ((e = launch_dot<float>(dout, o, D, B, Sq, H, Dh, st)) != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<NC, TT><<<dim3((Skv + TT - 1) / TT, Hkv, B), NT, bytes, st>>>(
      qt, kt, vt, dot, lse, D, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, H,
      Hkv, Dh, causal, window, q_offset, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq_kernel<NC, TT><<<dim3((Sq + TT - 1) / TT, H, B), NT, bytes, st>>>(
      qt, kt, vt, dot, lse, D, static_cast<float*>(dq), Sq, Skv, H, Hkv, Dh, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* D, void* dq, void* dk,
                     void* dv, int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                     int window, int q_offset, float scale, cudaStream_t st) {
  if (Dh <= 32)
    return launch<2, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                         window, q_offset, scale, st);
  if (Dh <= 64)
    return launch<4, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                         window, q_offset, scale, st);
  if (Dh <= 128)
    return launch<8, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                         window, q_offset, scale, st);
  return launch<16, 32>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                        window, q_offset, scale, st);
}

// --------------------------------------------------------------------------
// bf16 body: mma.sync tiles fed by cp.async
// --------------------------------------------------------------------------

namespace mma {

using namespace repro::mma;

// The tiles of an instantiation. 4 warps, each owning 16 rows: 64 keys of a
// dK/dV block, stepping over BQ queries; 64 query rows of a dQ block,
// stepping over BK keys. Rows in shared memory hold DH plus 16 bytes of
// padding, so that the 8 rows of an ldmatrix lie in distinct 16-byte bank
// groups. Shared memory: dK/dV K and V, then two stages of a Q tile, a dO
// tile and their lse and D; dQ Q and dO, then two stages of a K and a V
// tile. At Dh 64, ptxas spills a few registers of the dK/dV kernel with 64-query steps (at
// 168 registers) and none with 32-query steps; at Dh 32 and 128 the 64-query
// steps spill nothing and were the faster on the card.
// Instantiated at DH 32, 64 and 128 only, where a block owns all DC = DH
// output columns and SPLIT is 1: past Dh 128 the wide body below runs.
template <int DH>
struct Tile {
  static constexpr int WARPS = 4;
  static constexpr int NT = 32 * WARPS;
  static constexpr int BKV = 16 * WARPS;       // keys of a dK/dV block
  static constexpr int BQ = DH == 64 ? 32 : 64;  // queries of a dK/dV step
  static constexpr int BM = 16 * WARPS;   // query rows of a dQ block
  static constexpr int BK = DH > 128 ? 32 : 64;  // keys of a dQ step
  static constexpr int DC = DH > 128 ? 128 : DH;  // output columns a block owns
  static constexpr int SPLIT = DH / DC;           // blocks of one tile, one per column slice
  static constexpr int P = DH + 8;
  static constexpr size_t SMEM_DKDV =
      (size_t)(2 * BKV + 4 * BQ) * P * sizeof(bf16) + 4 * BQ * sizeof(float);
  static constexpr size_t SMEM_DQ = (size_t)(2 * BM + 4 * BK) * P * sizeof(bf16);
};

// dK and dV for one (kv tile, kv head, batch row). DH: the instantiation's
// head dim, at least the runtime Dh (a multiple of 16); columns Dh..DH-1 are
// zero in shared memory and skipped.
template <int DH>
__global__ void __launch_bounds__(Tile<DH>::NT) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ D, bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq,
    int Skv, int H, int Hkv, int Dh, int causal, int window, int q_offset, float scale,
    float scale_log2) {
  using T = Tile<DH>;
  constexpr int NT = T::NT, BKV = T::BKV, BQ = T::BQ, P = T::P, DC = T::DC;
  constexpr int CH = DH / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BKV x P
  bf16* Vs = Ks + BKV * P;                       // BKV x P
  bf16* QdO = Vs + BKV * P;  // stage s: Q at QdO + 2 s BQ P, dO BQ P after it
  float* LD = reinterpret_cast<float*>(QdO + 4 * BQ * P);  // stage s: lse, D at LD + 2 s BQ

  const int tile = blockIdx.x / T::SPLIT;
  const int c0 = (blockIdx.x % T::SPLIT) * DC;  // the first of the block's output columns
  const int hb = tile % (Hkv * B), kt = tile / (Hkv * B);
  const int kvh = hb % Hkv, b = hb / Hkv;
  const int k0 = kt * BKV;  // under causal, tile 0 sees the most queries: heaviest first
  const int nk = min(BKV, Skv - k0);
  const int group = H / Hkv;
  const int dch = Dh / 8;  // chunks that hold data
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = warp * 16;  // the warp's first key in the tile

  const long q_row = (long)H * Dh, kv_row = (long)Hkv * Dh;
  const long kv_off = ((long)b * Skv + k0) * kv_row + (long)kvh * Dh;

  // the query rows that can see a key of this tile, in tiles of BQ from the first
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = max(0, min(Sq, k0 + nk - 1 + window - q_offset));
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_steps = group * n_qt;  // (head of the group, query tile)

  for (int i = tid; i < BKV * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r < nk && c < dch;
    const long off = kv_off + (long)r * kv_row + c * 8;
    cp_async16(Ks + r * P + c * 8, in ? k + off : k, in);
    cp_async16(Vs + r * P + c * 8, in ? v + off : v, in);
  }
  auto load_q = [&](int t, int stage) {
    const int h = kvh * group + t / n_qt, q0 = q_lo + (t % n_qt) * BQ;
    const long q_off = ((long)b * Sq + q0) * q_row + (long)h * Dh;
    bf16* Qs = QdO + stage * 2 * BQ * P;
    bf16* dOs = Qs + BQ * P;
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool in = q0 + r < Sq && c < dch;
      const long off = q_off + (long)r * q_row + c * 8;
      cp_async16(Qs + r * P + c * 8, in ? q + off : q, in);
      cp_async16(dOs + r * P + c * 8, in ? dout + off : dout, in);
    }
    float* Ls = LD + stage * 2 * BQ;
    const long l_off = ((long)b * H + h) * Sq + q0;
    for (int i = tid; i < BQ; i += NT) {
      const bool in = q0 + i < Sq;
      cp_async4(Ls + i, in ? lse + l_off + i : lse, in);
      cp_async4(Ls + BQ + i, in ? D + l_off + i : D, in);
    }
  };
  if (n_steps > 0) load_q(0, 0);
  cp_async_commit();  // K, V and the first step (K and V alone when there is none)

  const int g = lane >> 2, cq = lane & 3;
  // ldmatrix row addresses of this lane: K's and V's A fragments (the warp's
  // 16 keys); Q's and dO's B fragments as Q^T, dO^T (two query n-tiles) and,
  // with .trans, as Q, dO (two column n-tiles)
  const uint32_t k_addr = smem_u32(Ks + wrow * P + a_off<P>(lane));
  const uint32_t v_addr = smem_u32(Vs + wrow * P + a_off<P>(lane));
  const int qb_off = b_off<P>(lane), qt_off = bt_off<P>(lane);

  float acc_dk[DC / 8][4], acc_dv[DC / 8][4];  // columns c0 .. c0 + DC - 1
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_steps) {
      load_q(t + 1, stage ^ 1);  // its stage was last read in step t - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step t (and K, V) visible to every warp
    const int q0 = q_lo + (t % n_qt) * BQ;
    const bf16* Qs = QdO + stage * 2 * BQ * P;
    const bf16* dOs = Qs + BQ * P;
    const float* Ls = LD + stage * 2 * BQ;
    const float* Ds = Ls + BQ;

    // S^T = K . Q^T: the warp's 16 keys x BQ queries
    float s[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      const uint32_t qb = smem_u32(Qs + qb_off);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        if (kk * 16 < Dh) {
          uint32_t a[4];
          ldmatrix_x4(a, k_addr + kk * 32);
#pragma unroll
          for (int np = 0; np < BQ / 16; ++np) {
            uint32_t bq[4];
            ldmatrix_x4(bq, qb + (np * 16 * P + kk * 16) * 2);
            mma_bf16(s[2 * np], a, bq[0], bq[1]);
            mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
          }
        }
      }
    }

    // P^T = exp2(S^T scale log2 e - lse log2 e) of each query column; 0 off
    // the mask (only where the tile crosses the diagonal or the window edge;
    // keys past Skv are never stored, and query rows past Sq are zero in Q
    // and dO, so they add nothing)
    const bool need_mask = (causal && k0 + BKV - 1 > q0 + q_offset) ||
                           (window > 0 && k0 <= q0 + BQ - 1 + q_offset - window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(Ls + j * 8 + 2 * cq);
      const float nl0 = -l.x * kLog2e, nl1 = -l.y * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, (e & 1) ? nl1 : nl0));
        if (need_mask) {
          const int kpos = k0 + wrow + g + (e >> 1) * 8;
          const int qpos = q0 + j * 8 + 2 * cq + (e & 1) + q_offset;
          bool ok = true;
          if (causal) ok = kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) p = 0.f;
        }
        s[j][e] = p;
      }
    }

    // dV += P^T . dO, P^T rounded to bf16 in registers as the A operand
    {
      const uint32_t dot = smem_u32(dOs + qt_off);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
          if (c0 + dp * 16 < Dh) {
            uint32_t bo[4];
            ldmatrix_x4_trans(bo, dot + (kk * 16 * P + c0 + dp * 16) * 2);
            mma_bf16(acc_dv[2 * dp], a, bo[0], bo[1]);
            mma_bf16(acc_dv[2 * dp + 1], a, bo[2], bo[3]);
          }
        }
      }
    }

    // dP^T = V . dO^T, then dS^T = P^T * (dP^T - D) in place
    float ds[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    {
      const uint32_t ob = smem_u32(dOs + qb_off);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        if (kk * 16 < Dh) {
          uint32_t a[4];
          ldmatrix_x4(a, v_addr + kk * 32);
#pragma unroll
          for (int np = 0; np < BQ / 16; ++np) {
            uint32_t bo[4];
            ldmatrix_x4(bo, ob + (np * 16 * P + kk * 16) * 2);
            mma_bf16(ds[2 * np], a, bo[0], bo[1]);
            mma_bf16(ds[2 * np + 1], a, bo[2], bo[3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(Ds + j * 8 + 2 * cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = s[j][e] * (ds[j][e] - ((e & 1) ? d.y : d.x));
    }

    // dK += dS^T . Q (scaled at the store)
    {
      const uint32_t qt = smem_u32(Qs + qt_off);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        pack_a(a, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
          if (c0 + dp * 16 < Dh) {
            uint32_t bq[4];
            ldmatrix_x4_trans(bq, qt + (kk * 16 * P + c0 + dp * 16) * 2);
            mma_bf16(acc_dk[2 * dp], a, bq[0], bq[1]);
            mma_bf16(acc_dk[2 * dp + 1], a, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp done with this stage before it is refilled
  }
  cp_async_wait<0>();  // with no step, K and V may still be in flight
  __syncthreads();

  // epilogue: dK (scaled) and dV of the block's columns staged in the warp's
  // own K and V rows, stored as 16-byte rows
  bf16* dKs = Ks + wrow * P;
  bf16* dVs = Vs + wrow * P;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = (g + 8 * i) * P + j * 8 + 2 * cq;
      *reinterpret_cast<uint32_t*>(dKs + o) =
          pack_bf16(acc_dk[j][2 * i] * scale, acc_dk[j][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dVs + o) = pack_bf16(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
    }
  __syncwarp();
  for (int i = lane; i < 16 * (DC / 8); i += 32) {
    const int r = i / (DC / 8), c = i % (DC / 8), row = wrow + r;
    if (row < nk && c0 + c * 8 < Dh) {
      const long off = kv_off + (long)row * kv_row + c0 + c * 8;
      *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(dKs + r * P + c * 8);
      *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(dVs + r * P + c * 8);
    }
  }
}

// dQ for one (query tile, head, batch row).
template <int DH>
__global__ void __launch_bounds__(Tile<DH>::NT) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ D, bf16* __restrict__ dq, int B, int Sq, int Skv, int H,
    int Hkv, int Dh, int causal, int window, int q_offset, float scale, float scale_log2) {
  using T = Tile<DH>;
  constexpr int NT = T::NT, BM = T::BM, BK = T::BK, P = T::P, DC = T::DC;
  constexpr int CH = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BM x P
  bf16* dOs = Qs + BM * P;                       // BM x P
  bf16* KVs = dOs + BM * P;  // stage s: K at KVs + 2 s BK P, V BK P after it

  const int n_qt = (Sq + BM - 1) / BM;
  const int tile = blockIdx.x / T::SPLIT;
  const int c0 = (blockIdx.x % T::SPLIT) * DC;  // the first of the block's output columns
  const int hb = tile % (H * B), qt_lin = tile / (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (causal ? n_qt - 1 - qt_lin : qt_lin) * BM;  // heaviest first
  const int nq = min(BM, Sq - q0);
  const int kvh = h / (H / Hkv);
  const int dch = Dh / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = warp * 16;

  const long q_row = (long)H * Dh, kv_row = (long)Hkv * Dh;
  const long q_off = ((long)b * Sq + q0) * q_row + (long)h * Dh;
  const bf16* kb = k + (long)b * Skv * kv_row + (long)kvh * Dh;
  const bf16* vb = v + (long)b * Skv * kv_row + (long)kvh * Dh;

  // the kv positions any row of this tile may see (as in the forward)
  const int qpos_lo = q0 + q_offset, qpos_hi = q0 + nq - 1 + q_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = max(0, min(Skv, qpos_hi + 1));
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const int n_kt = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  for (int i = tid; i < BM * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r < nq && c < dch;
    const long off = q_off + (long)r * q_row + c * 8;
    cp_async16(Qs + r * P + c * 8, in ? q + off : q, in);
    cp_async16(dOs + r * P + c * 8, in ? dout + off : dout, in);
  }
  cp_async_commit();  // Q and dO
  auto load_kv = [&](int t, int stage) {
    const int k0 = kv_lo + t * BK;
    bf16* Ks = KVs + stage * 2 * BK * P;
    bf16* Vs = Ks + BK * P;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < Skv && c < dch;
      const long off = (long)(k0 + r) * kv_row + c * 8;
      cp_async16(Ks + r * P + c * 8, in ? kb + off : kb, in);
      cp_async16(Vs + r * P + c * 8, in ? vb + off : vb, in);
    }
  };
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();  // the first kv tile (an empty group when there is none)

  const int g = lane >> 2, cq = lane & 3;
  // this lane's two rows: lse in log2 units (+inf past Sq, so P is 0) and D
  float lse2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    const long at = ((long)b * H + h) * Sq + row;
    lse2[i] = row < Sq ? lse[at] * kLog2e : INFINITY;
    Dr[i] = row < Sq ? D[at] : 0.f;
  }
  // ldmatrix row addresses of this lane: Q's and dO's A fragments; K's and
  // V's B fragments as K^T, V^T (two key n-tiles) and, with .trans, K's as K
  // (two column n-tiles)
  const uint32_t q_addr = smem_u32(Qs + wrow * P + a_off<P>(lane));
  const uint32_t do_addr = smem_u32(dOs + wrow * P + a_off<P>(lane));
  const int kb_off = b_off<P>(lane), kt_off = bt_off<P>(lane);

  // the warp's Q fragments stay in registers for the whole kv loop
  uint32_t qa[DH / 16][4];
  cp_async_wait<1>();  // Q and dO landed; the first kv tile may still be in flight
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    if (kk * 16 < Dh) ldmatrix_x4(qa[kk], q_addr + kk * 32);

  float acc[DC / 8][4];  // columns c0 .. c0 + DC - 1
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_kt) {
      load_kv(t + 1, stage ^ 1);  // its stage was last read in tile t - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q, dO) visible to every warp
    const int k0 = kv_lo + t * BK;
    const bf16* Ks = KVs + stage * 2 * BK * P;
    const bf16* Vs = Ks + BK * P;

    // S = Q . K^T: 16 rows x BK keys a warp
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      const uint32_t kb_addr = smem_u32(Ks + kb_off);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        if (kk * 16 < Dh) {
#pragma unroll
          for (int np = 0; np < BK / 16; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, kb_addr + (np * 16 * P + kk * 16) * 2);
            mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
          }
        }
      }
    }

    // P = exp2(S scale log2 e - lse log2 e); 0 off the mask, which applies
    // only where the tile crosses the causal diagonal, the window edge or Skv
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > qpos_lo) ||
                           (window > 0 && k0 <= qpos_hi - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
        if (need_mask) {
          const int kpos = k0 + j * 8 + 2 * cq + (e & 1);
          const int qpos = q0 + wrow + g + (e >> 1) * 8 + q_offset;
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) p = 0.f;
        }
        s[j][e] = p;
      }

    // dP = dO . V^T, then dS = P * (dP - D) in place
    float ds[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    {
      const uint32_t vb_addr = smem_u32(Vs + kb_off);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        if (kk * 16 < Dh) {
          uint32_t a[4];
          ldmatrix_x4(a, do_addr + kk * 32);
#pragma unroll
          for (int np = 0; np < BK / 16; ++np) {
            uint32_t bv[4];
            ldmatrix_x4(bv, vb_addr + (np * 16 * P + kk * 16) * 2);
            mma_bf16(ds[2 * np], a, bv[0], bv[1]);
            mma_bf16(ds[2 * np + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = s[j][e] * (ds[j][e] - Dr[e >> 1]);

    // dQ += dS . K (scaled at the store), dS rounded to bf16 as the A operand
    {
      const uint32_t kt_addr = smem_u32(Ks + kt_off);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        pack_a(a, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
          if (c0 + dp * 16 < Dh) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, kt_addr + (kk * 16 * P + c0 + dp * 16) * 2);
            mma_bf16(acc[2 * dp], a, bk[0], bk[1]);
            mma_bf16(acc[2 * dp + 1], a, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp done with this stage before it is refilled
  }
  cp_async_wait<0>();  // with no kv tile, Q and dO may still be in flight
  __syncthreads();

  // epilogue: dQ (scaled) of the block's columns staged in the warp's own Q
  // rows, stored as 16-byte rows
  bf16* dQs = Qs + wrow * P;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(dQs + (g + 8 * i) * P + j * 8 + 2 * cq) =
          pack_bf16(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  __syncwarp();
  for (int i = lane; i < 16 * (DC / 8); i += 32) {
    const int r = i / (DC / 8), c = i % (DC / 8), row = wrow + r;
    if (row < nq && c0 + c * 8 < Dh)
      *reinterpret_cast<uint4*>(dq + q_off + (long)row * q_row + c0 + c * 8) =
          *reinterpret_cast<const uint4*>(dQs + r * P + c * 8);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* D, void* dq, void* dk,
                   void* dv, int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                   int window, int q_offset, float scale, cudaStream_t st) {
  using T = Tile<DH>;
  static std::atomic<bool> dkdv_set[repro::kMaxDevices], dq_set[repro::kMaxDevices];
  cudaError_t e =
      repro::opt_in_smem(flash_bwd_dkdv_mma_kernel<DH>, (int)T::SMEM_DKDV, dkdv_set);
  if (e != cudaSuccess) return e;
  e = repro::opt_in_smem(flash_bwd_dq_mma_kernel<DH>, (int)T::SMEM_DQ, dq_set);
  if (e != cudaSuccess) return e;
  const long dkdv_blocks = (long)((Skv + T::BKV - 1) / T::BKV) * Hkv * B * T::SPLIT;
  const long dq_blocks = (long)((Sq + T::BM - 1) / T::BM) * H * B * T::SPLIT;
  if (dkdv_blocks > 0x7fffffffL || dq_blocks > 0x7fffffffL)
    return cudaErrorInvalidConfiguration;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float scale_log2 = scale * kLog2e;

  if ((e = launch_dot<bf16>(dout, o, D, B, Sq, H, Dh, st)) != cudaSuccess) return e;
  flash_bwd_dkdv_mma_kernel<DH><<<(unsigned)dkdv_blocks, T::NT, T::SMEM_DKDV, st>>>(
      qt, kt, vt, dot, lse, D, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, H,
      Hkv, Dh, causal, window, q_offset, scale, scale_log2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq_mma_kernel<DH><<<(unsigned)dq_blocks, T::NT, T::SMEM_DQ, st>>>(
      qt, kt, vt, dot, lse, D, static_cast<bf16*>(dq), B, Sq, Skv, H, Hkv, Dh, causal, window,
      q_offset, scale, scale_log2);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16 body past Dh 128: a pair of warps for each 16 rows
// --------------------------------------------------------------------------

// The tiles of the wide body (Head dims, at the top). 8 warps; warp w and
// warp w + PAIRS are the pair that owns rows 16 w .. 16 w + 15 of the
// block's tile: 64 keys of a dK/dV block, stepping over BQ queries; 64 query
// rows of a dQ block, stepping over BK keys. Rows in shared memory hold 256
// columns plus 16 bytes of padding. Shared memory: dK/dV K and V, two stages
// of a Q tile, a dO tile and their lse and D, then the pairs' exchange
// buffers; dQ Q and dO, two stages of a K and a V tile, then the exchange
// buffers. Both kernels read every A operand from shared memory (the dQ
// kernel keeps no Q fragments in registers). ptxas gives the dK/dV kernel
// 252 registers, the dQ kernel 192 and the sum kernel 32, none spilling (the
// f32 body's Dh 256 dQ kernel: 64 registers, 20 bytes of spill).
struct Wide {
  static constexpr int DH = 256;
  static constexpr int PAIRS = 4;
  static constexpr int NT = 64 * PAIRS;   // threads: two warps a pair
  static constexpr int BKV = 16 * PAIRS;  // keys of a dK/dV block
  static constexpr int BQ = 64;           // queries of a dK/dV step
  static constexpr int BM = 16 * PAIRS;   // query rows of a dQ block
  static constexpr int BK = 64;           // keys of a dQ step
  static constexpr int DC = DH / 2;       // output columns a warp owns, at most
  static constexpr int P = DH + 8;
  // a pair's exchange: P (16 x BQ, f32) and dS (16 x BQ, bf16), each in the
  // layout of a warp's registers
  static constexpr int XCH = 16 * BQ * (4 + 2);
  static constexpr size_t SMEM_DKDV = (size_t)(2 * BKV + 4 * BQ) * P * sizeof(bf16) +
                                      4 * BQ * sizeof(float) + PAIRS * XCH;
  static constexpr size_t SMEM_DQ = (size_t)(2 * BM + 4 * BK) * P * sizeof(bf16) + PAIRS * XCH;
};
static_assert(Wide::BQ == Wide::BK, "both kernels share the exchange layout");
static_assert(Wide::SMEM_DKDV <= 232448 && Wide::SMEM_DQ <= 232448,
              "a block's shared memory on the H100");

// The two warps of pair `pair` wait for each other: named barrier 1 + pair (0
// is __syncthreads'), 64 threads. It orders their shared-memory accesses.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// x (the warp's 16 rows x W columns) += A . B^T over the first Dh columns: A
// the warp's 16 rows, B W rows, both in shared memory at this lane's
// ldmatrix addresses (a_off, b_off included).
template <int W>
__device__ __forceinline__ void mma_scores(float (&x)[W / 8][4], uint32_t a_addr,
                                           uint32_t b_addr, int Dh) {
  constexpr int P = Wide::P;
#pragma unroll
  for (int kk = 0; kk < Wide::DH / 16; ++kk) {
    if (kk * 16 < Dh) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < W / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_addr + (np * 16 * P + kk * 16) * 2);
        mma_bf16(x[2 * np], a, b[0], b[1]);
        mma_bf16(x[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc (the warp's 16 rows x its columns c0 .. c0 + nc - 1) += a . T[:, c0 ..]:
// a the warp's A operands over W rows of T, T in shared memory at this
// lane's ldmatrix .trans address (bt_off included).
template <int W>
__device__ __forceinline__ void mma_cols(float (&acc)[Wide::DC / 8][4],
                                         const uint32_t (&a)[W / 16][4], uint32_t t_addr,
                                         int c0, int nc) {
  constexpr int P = Wide::P;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
    for (int dp = 0; dp < Wide::DC / 16; ++dp)
      if (dp * 16 < nc) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, t_addr + (kk * 16 * P + c0 + dp * 16) * 2);
        mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
      }
}

// dK and dV for one (kv tile, kv head, batch row) over head subset `sub` of
// n_sub, the contiguous heads [sub * group / n_sub, (sub + 1) * group /
// n_sub) of the GQA group. With one subset (ws null) the block writes dk and
// dv in bf16; else its f32 sums, dK unscaled, go to ws, laid out
// [n_sub][dK, dV][B][Skv][Hkv][Dh], for flash_bwd_dkdv_sum_kernel.
__global__ void __launch_bounds__(Wide::NT, 1) flash_bwd_dkdv_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ D, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ ws, int n_sub, int B, int Sq, int Skv, int H, int Hkv, int Dh,
    int causal, int window, int q_offset, float scale, float scale_log2) {
  using W = Wide;
  constexpr int NT = W::NT, BKV = W::BKV, BQ = W::BQ, P = W::P, DC = W::DC;
  constexpr int CH = W::DH / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BKV x P
  bf16* Vs = Ks + BKV * P;                       // BKV x P
  bf16* QdO = Vs + BKV * P;  // stage s: Q at QdO + 2 s BQ P, dO BQ P after it
  float* LD = reinterpret_cast<float*>(QdO + 4 * BQ * P);  // stage s: lse, D at LD + 2 s BQ
  unsigned char* X = reinterpret_cast<unsigned char*>(LD + 4 * BQ);  // PAIRS x XCH

  const int hb = blockIdx.x % (Hkv * B), rest = blockIdx.x / (Hkv * B);
  const int sub = rest % n_sub, kt = rest / n_sub;
  const int kvh = hb % Hkv, b = hb / Hkv;
  const int k0 = kt * BKV;  // under causal, tile 0 sees the most queries: heaviest first
  const int nk = min(BKV, Skv - k0);
  const int group = H / Hkv;
  const int g_lo = sub * group / n_sub;  // the subset's first head of the group
  const int n_heads = (sub + 1) * group / n_sub - g_lo;
  const int dch = Dh / 8;  // chunks that hold data
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp % W::PAIRS, role = warp / W::PAIRS;  // role 0: S and P; 1: dP and dS
  const int wrow = pair * 16;  // the pair's first key in the tile
  const int half = 16 * ((Dh / 16 + 1) / 2);
  const int c0 = role ? half : 0, nc = role ? Dh - half : half;  // the warp's output columns

  const long q_row = (long)H * Dh, kv_row = (long)Hkv * Dh;
  const long kv_off = ((long)b * Skv + k0) * kv_row + (long)kvh * Dh;

  // the query rows that can see a key of this tile, in tiles of BQ from the first
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = max(0, min(Sq, k0 + nk - 1 + window - q_offset));
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_steps = n_heads * n_qt;  // (head of the subset, query tile)

  for (int i = tid; i < BKV * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r < nk && c < dch;
    const long off = kv_off + (long)r * kv_row + c * 8;
    cp_async16(Ks + r * P + c * 8, in ? k + off : k, in);
    cp_async16(Vs + r * P + c * 8, in ? v + off : v, in);
  }
  auto load_q = [&](int t, int stage) {
    const int h = kvh * group + g_lo + t / n_qt, q0 = q_lo + (t % n_qt) * BQ;
    const long q_off = ((long)b * Sq + q0) * q_row + (long)h * Dh;
    bf16* Qs = QdO + stage * 2 * BQ * P;
    bf16* dOs = Qs + BQ * P;
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool in = q0 + r < Sq && c < dch;
      const long off = q_off + (long)r * q_row + c * 8;
      cp_async16(Qs + r * P + c * 8, in ? q + off : q, in);
      cp_async16(dOs + r * P + c * 8, in ? dout + off : dout, in);
    }
    float* Ls = LD + stage * 2 * BQ;
    const long l_off = ((long)b * H + h) * Sq + q0;
    for (int i = tid; i < BQ; i += NT) {
      const bool in = q0 + i < Sq;
      cp_async4(Ls + i, in ? lse + l_off + i : lse, in);
      cp_async4(Ls + BQ + i, in ? D + l_off + i : D, in);
    }
  };
  if (n_steps > 0) load_q(0, 0);
  cp_async_commit();  // K, V and the first step (K and V alone when there is none)

  const int g = lane >> 2, cq = lane & 3;
  // ldmatrix row addresses of this lane: the A fragments of the pair's 16
  // keys of K (role 0) or V (role 1); Q's and dO's B fragments as Q^T, dO^T
  // and, with .trans, as Q, dO
  const uint32_t a_addr = smem_u32((role ? Vs : Ks) + wrow * P + a_off<P>(lane));
  const int qb_off = b_off<P>(lane), qt_off = bt_off<P>(lane);
  // the pair's exchange: P^T as f32 accumulator tiles (tile j of lane l at
  // j * 32 + l), dS^T as bf16 A operands (16 columns kk of lane l at kk * 32 + l)
  float4* xp = reinterpret_cast<float4*>(X + pair * W::XCH);
  uint4* xds = reinterpret_cast<uint4*>(xp + BQ / 8 * 32);

  float acc_dk[DC / 8][4], acc_dv[DC / 8][4];  // columns c0 .. c0 + nc - 1
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_steps) {
      load_q(t + 1, stage ^ 1);  // its stage was last read in step t - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step t (and K, V) visible to every warp
    const int q0 = q_lo + (t % n_qt) * BQ;
    const bf16* Qs = QdO + stage * 2 * BQ * P;
    const bf16* dOs = Qs + BQ * P;
    const float* Ls = LD + stage * 2 * BQ;
    const float* Ds = Ls + BQ;

    // role 0: S^T = K . Q^T; role 1: dP^T = V . dO^T (the pair's 16 keys x BQ queries)
    float x[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    mma_scores<BQ>(x, a_addr, smem_u32((role ? dOs : Qs) + qb_off), Dh);

    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T as A operands
    if (role == 0) {
      // P^T = exp2(S^T scale log2 e - lse log2 e) of each query column; 0 off
      // the mask (only where the tile crosses the diagonal or the window
      // edge; keys past Skv are never stored, and query rows past Sq are zero
      // in Q and dO, so they add nothing)
      const bool need_mask = (causal && k0 + BKV - 1 > q0 + q_offset) ||
                             (window > 0 && k0 <= q0 + BQ - 1 + q_offset - window);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(Ls + j * 8 + 2 * cq);
        const float nl0 = -l.x * kLog2e, nl1 = -l.y * kLog2e;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(x[j][e], scale_log2, (e & 1) ? nl1 : nl0));
          if (need_mask) {
            const int kpos = k0 + wrow + g + (e >> 1) * 8;
            const int qpos = q0 + j * 8 + 2 * cq + (e & 1) + q_offset;
            bool ok = true;
            if (causal) ok = kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) p = 0.f;
          }
          x[j][e] = p;
        }
        xp[j * 32 + lane] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) pack_a(pa[kk], x[2 * kk], x[2 * kk + 1]);
    }
    pair_sync(pair);  // P^T in the exchange
    if (role == 1) {
      // dS^T = P^T * (dP^T - D), with role 0's P^T; both as bf16 A operands
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = 2 * kk + i;
          const float4 f = xp[j * 32 + lane];
          p[i][0] = f.x, p[i][1] = f.y, p[i][2] = f.z, p[i][3] = f.w;
          const float2 d = *reinterpret_cast<const float2*>(Ds + j * 8 + 2 * cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[j][e] = p[i][e] * (x[j][e] - ((e & 1) ? d.y : d.x));
        }
        pack_a(pa[kk], p[0], p[1]);
        pack_a(da[kk], x[2 * kk], x[2 * kk + 1]);
        xds[kk * 32 + lane] = make_uint4(da[kk][0], da[kk][1], da[kk][2], da[kk][3]);
      }
    } else {
      mma_cols<BQ>(acc_dv, pa, smem_u32(dOs + qt_off), c0, nc);  // dV += P^T . dO
    }
    pair_sync(pair);  // dS^T in the exchange
    if (role == 0) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint4 u = xds[kk * 32 + lane];
        da[kk][0] = u.x, da[kk][1] = u.y, da[kk][2] = u.z, da[kk][3] = u.w;
      }
    } else {
      mma_cols<BQ>(acc_dv, pa, smem_u32(dOs + qt_off), c0, nc);  // dV += P^T . dO
    }
    mma_cols<BQ>(acc_dk, da, smem_u32(Qs + qt_off), c0, nc);  // dK += dS^T . Q
    __syncthreads();  // every warp done with this stage before it is refilled
  }
  cp_async_wait<0>();  // with no step, K and V may still be in flight
  __syncthreads();

  if (ws == nullptr) {
    // dK (scaled) and dV of the warp's columns staged in the pair's own K and
    // V rows, stored as 16-byte rows
    bf16* dKs = Ks + wrow * P;
    bf16* dVs = Vs + wrow * P;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
      if (j * 8 < nc)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int o = (g + 8 * i) * P + c0 + j * 8 + 2 * cq;
          *reinterpret_cast<uint32_t*>(dKs + o) =
              pack_bf16(acc_dk[j][2 * i] * scale, acc_dk[j][2 * i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dVs + o) =
              pack_bf16(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
        }
    __syncwarp();
    for (int i = lane; i < 16 * (DC / 8); i += 32) {
      const int r = i / (DC / 8), c = c0 + (i % (DC / 8)) * 8, row = wrow + r;
      if (row < nk && c < c0 + nc) {
        const long off = kv_off + (long)row * kv_row + c;
        *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(dKs + r * P + c);
        *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(dVs + r * P + c);
      }
    }
  } else {
    // the subset's f32 sums of the warp's columns
    const long E = (long)B * Skv * Hkv * Dh;
    float* wk = ws + (long)sub * 2 * E;
    float* wv = wk + E;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
      if (j * 8 < nc)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = wrow + g + 8 * i;
          if (row < nk) {
            const long off = kv_off + (long)row * kv_row + c0 + j * 8 + 2 * cq;
            *reinterpret_cast<float2*>(wk + off) =
                make_float2(acc_dk[j][2 * i], acc_dk[j][2 * i + 1]);
            *reinterpret_cast<float2*>(wv + off) =
                make_float2(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
          }
        }
  }
}

// dk = scale * (sum of the subsets' dK) and dv = sum of their dV, the subsets
// added in order 0, 1, ...: four elements a thread, dk's E elements first.
__global__ void __launch_bounds__(256) flash_bwd_dkdv_sum_kernel(const float* __restrict__ ws,
                                                                 bf16* __restrict__ dk,
                                                                 bf16* __restrict__ dv, long E,
                                                                 int n_sub, float scale) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * E) return;
  const long which = i >= E;  // 0 dK, 1 dV; E is a multiple of 16, so no four straddle
  const long e = i - which * E;
  float4 acc = *reinterpret_cast<const float4*>(ws + which * E + e);
  for (int s = 1; s < n_sub; ++s) {
    const float4 t = *reinterpret_cast<const float4*>(ws + (2 * s + which) * E + e);
    acc.x += t.x, acc.y += t.y, acc.z += t.z, acc.w += t.w;
  }
  const float m = which ? 1.f : scale;
  *reinterpret_cast<uint2*>((which ? dv : dk) + e) =
      make_uint2(pack_bf16(acc.x * m, acc.y * m), pack_bf16(acc.z * m, acc.w * m));
}

// dQ for one (query tile, head, batch row).
__global__ void __launch_bounds__(Wide::NT, 1) flash_bwd_dq_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ D, bf16* __restrict__ dq, int B, int Sq, int Skv, int H,
    int Hkv, int Dh, int causal, int window, int q_offset, float scale, float scale_log2) {
  using W = Wide;
  constexpr int NT = W::NT, BM = W::BM, BK = W::BK, P = W::P, DC = W::DC;
  constexpr int CH = W::DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BM x P
  bf16* dOs = Qs + BM * P;                       // BM x P
  bf16* KVs = dOs + BM * P;  // stage s: K at KVs + 2 s BK P, V BK P after it
  unsigned char* X = reinterpret_cast<unsigned char*>(KVs + 4 * BK * P);  // PAIRS x XCH

  const int n_qt = (Sq + BM - 1) / BM;
  const int hb = blockIdx.x % (H * B), qt_lin = blockIdx.x / (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (causal ? n_qt - 1 - qt_lin : qt_lin) * BM;  // heaviest first
  const int nq = min(BM, Sq - q0);
  const int kvh = h / (H / Hkv);
  const int dch = Dh / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp % W::PAIRS, role = warp / W::PAIRS;  // role 0: S and P; 1: dP and dS
  const int wrow = pair * 16;  // the pair's first query row in the tile
  const int half = 16 * ((Dh / 16 + 1) / 2);
  const int c0 = role ? half : 0, nc = role ? Dh - half : half;  // the warp's output columns

  const long q_row = (long)H * Dh, kv_row = (long)Hkv * Dh;
  const long q_off = ((long)b * Sq + q0) * q_row + (long)h * Dh;
  const bf16* kb = k + (long)b * Skv * kv_row + (long)kvh * Dh;
  const bf16* vb = v + (long)b * Skv * kv_row + (long)kvh * Dh;

  // the kv positions any row of this tile may see (as in the forward)
  const int qpos_lo = q0 + q_offset, qpos_hi = q0 + nq - 1 + q_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = max(0, min(Skv, qpos_hi + 1));
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const int n_kt = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  for (int i = tid; i < BM * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r < nq && c < dch;
    const long off = q_off + (long)r * q_row + c * 8;
    cp_async16(Qs + r * P + c * 8, in ? q + off : q, in);
    cp_async16(dOs + r * P + c * 8, in ? dout + off : dout, in);
  }
  cp_async_commit();  // Q and dO
  auto load_kv = [&](int t, int stage) {
    const int k0 = kv_lo + t * BK;
    bf16* Ks = KVs + stage * 2 * BK * P;
    bf16* Vs = Ks + BK * P;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < Skv && c < dch;
      const long off = (long)(k0 + r) * kv_row + c * 8;
      cp_async16(Ks + r * P + c * 8, in ? kb + off : kb, in);
      cp_async16(Vs + r * P + c * 8, in ? vb + off : vb, in);
    }
  };
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();  // the first kv tile (an empty group when there is none)

  const int g = lane >> 2, cq = lane & 3;
  // this lane's two rows: lse in log2 units (+inf past Sq, so P is 0) and D
  float lse2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    const long at = ((long)b * H + h) * Sq + row;
    lse2[i] = row < Sq ? lse[at] * kLog2e : INFINITY;
    Dr[i] = row < Sq ? D[at] : 0.f;
  }
  // ldmatrix row addresses of this lane: the A fragments of the pair's 16
  // rows of Q (role 0) or dO (role 1); K's and V's B fragments as K^T, V^T
  // and, with .trans, K's as K
  const uint32_t a_addr = smem_u32((role ? dOs : Qs) + wrow * P + a_off<P>(lane));
  const int kb_off = b_off<P>(lane), kt_off = bt_off<P>(lane);
  // the pair's exchange, laid out as kernel 2's
  float4* xp = reinterpret_cast<float4*>(X + pair * W::XCH);
  uint4* xds = reinterpret_cast<uint4*>(xp + BK / 8 * 32);

  float acc[DC / 8][4];  // columns c0 .. c0 + nc - 1
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_kt) {
      load_kv(t + 1, stage ^ 1);  // its stage was last read in tile t - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q, dO) visible to every warp
    const int k0 = kv_lo + t * BK;
    const bf16* Ks = KVs + stage * 2 * BK * P;
    const bf16* Vs = Ks + BK * P;

    // role 0: S = Q . K^T; role 1: dP = dO . V^T (the pair's 16 rows x BK keys)
    float x[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    mma_scores<BK>(x, a_addr, smem_u32((role ? Vs : Ks) + kb_off), Dh);

    uint32_t da[BK / 16][4];  // dS as A operands
    if (role == 0) {
      // P = exp2(S scale log2 e - lse log2 e); 0 off the mask, which applies
      // only where the tile crosses the causal diagonal, the window edge or Skv
      const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > qpos_lo) ||
                             (window > 0 && k0 <= qpos_hi - window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(x[j][e], scale_log2, -lse2[e >> 1]));
          if (need_mask) {
            const int kpos = k0 + j * 8 + 2 * cq + (e & 1);
            const int qpos = q0 + wrow + g + (e >> 1) * 8 + q_offset;
            bool ok = kpos < Skv;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) p = 0.f;
          }
          x[j][e] = p;
        }
        xp[j * 32 + lane] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      }
    }
    pair_sync(pair);  // P in the exchange
    if (role == 1) {
      // dS = P * (dP - D), with role 0's P, as bf16 A operands
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = 2 * kk + i;
          const float4 f = xp[j * 32 + lane];
          x[j][0] = f.x * (x[j][0] - Dr[0]);
          x[j][1] = f.y * (x[j][1] - Dr[0]);
          x[j][2] = f.z * (x[j][2] - Dr[1]);
          x[j][3] = f.w * (x[j][3] - Dr[1]);
        }
        pack_a(da[kk], x[2 * kk], x[2 * kk + 1]);
        xds[kk * 32 + lane] = make_uint4(da[kk][0], da[kk][1], da[kk][2], da[kk][3]);
      }
    }
    pair_sync(pair);  // dS in the exchange
    if (role == 0) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint4 u = xds[kk * 32 + lane];
        da[kk][0] = u.x, da[kk][1] = u.y, da[kk][2] = u.z, da[kk][3] = u.w;
      }
    }
    mma_cols<BK>(acc, da, smem_u32(Ks + kt_off), c0, nc);  // dQ += dS . K (scaled at the store)
    __syncthreads();  // every warp done with this stage before it is refilled
  }
  cp_async_wait<0>();  // with no kv tile, Q and dO may still be in flight
  __syncthreads();

  // epilogue: dQ (scaled) of the warp's columns staged in the pair's own Q
  // rows, stored as 16-byte rows
  bf16* dQs = Qs + wrow * P;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
    if (j * 8 < nc)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(dQs + (g + 8 * i) * P + c0 + j * 8 + 2 * cq) =
            pack_bf16(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  __syncwarp();
  for (int i = lane; i < 16 * (DC / 8); i += 32) {
    const int r = i / (DC / 8), c = c0 + (i % (DC / 8)) * 8, row = wrow + r;
    if (row < nq && c < c0 + nc)
      *reinterpret_cast<uint4*>(dq + q_off + (long)row * q_row + c) =
          *reinterpret_cast<const uint4*>(dQs + r * P + c);
  }
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* D, void* dq, void* dk,
                        void* dv, float* ws, int n_sub, int B, int Sq, int Skv, int H, int Hkv,
                        int Dh, int causal, int window, int q_offset, float scale,
                        cudaStream_t st) {
  using W = Wide;
  static std::atomic<bool> dkdv_set[repro::kMaxDevices], dq_set[repro::kMaxDevices];
  cudaError_t e = repro::opt_in_smem(flash_bwd_dkdv_wide_kernel, (int)W::SMEM_DKDV, dkdv_set);
  if (e != cudaSuccess) return e;
  e = repro::opt_in_smem(flash_bwd_dq_wide_kernel, (int)W::SMEM_DQ, dq_set);
  if (e != cudaSuccess) return e;
  const long dkdv_blocks = (long)((Skv + W::BKV - 1) / W::BKV) * Hkv * B * n_sub;
  const long dq_blocks = (long)((Sq + W::BM - 1) / W::BM) * H * B;
  const long E = (long)B * Skv * Hkv * Dh;
  const long sum_blocks = (2 * E / 4 + 255) / 256;
  if (dkdv_blocks > 0x7fffffffL || dq_blocks > 0x7fffffffL || sum_blocks > 0x7fffffffL)
    return cudaErrorInvalidConfiguration;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  const float scale_log2 = scale * kLog2e;

  if ((e = launch_dot<bf16>(dout, o, D, B, Sq, H, Dh, st)) != cudaSuccess) return e;
  flash_bwd_dkdv_wide_kernel<<<(unsigned)dkdv_blocks, W::NT, W::SMEM_DKDV, st>>>(
      qt, kt, vt, dot, lse, D, dkt, dvt, n_sub > 1 ? ws : nullptr, n_sub, B, Sq, Skv, H, Hkv,
      Dh, causal, window, q_offset, scale, scale_log2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (n_sub > 1) {
    flash_bwd_dkdv_sum_kernel<<<(unsigned)sum_blocks, 256, 0, st>>>(ws, dkt, dvt, E, n_sub,
                                                                    scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  flash_bwd_dq_wide_kernel<<<(unsigned)dq_blocks, W::NT, W::SMEM_DQ, st>>>(
      qt, kt, vt, dot, lse, D, static_cast<bf16*>(dq), B, Sq, Skv, H, Hkv, Dh, causal, window,
      q_offset, scale, scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* D, void* dq, void* dk,
                     void* dv, float* ws, int n_sub, int B, int Sq, int Skv, int H, int Hkv,
                     int Dh, int causal, int window, int q_offset, float scale,
                     cudaStream_t st) {
  if (Dh <= 32)
    return launch<32>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                      window, q_offset, scale, st);
  if (Dh <= 64)
    return launch<64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                      window, q_offset, scale, st);
  if (Dh <= 128)
    return launch<128>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                       window, q_offset, scale, st);
  return launch_wide(q, k, v, o, dout, lse, D, dq, dk, dv, ws, n_sub, B, Sq, Skv, H, Hkv, Dh,
                     causal, window, q_offset, scale, st);
}

// The dynamic shared memory (bytes) of the dK/dV and the dQ kernel that
// dispatch launches at head dim Dh.
template <int DH>
void tile_smem(int (&bytes)[2]) {
  bytes[0] = (int)Tile<DH>::SMEM_DKDV;
  bytes[1] = (int)Tile<DH>::SMEM_DQ;
}
void smem_bytes(int Dh, int (&bytes)[2]) {
  if (Dh <= 32) return tile_smem<32>(bytes);
  if (Dh <= 64) return tile_smem<64>(bytes);
  if (Dh <= 128) return tile_smem<128>(bytes);
  bytes[0] = (int)Wide::SMEM_DKDV;
  bytes[1] = (int)Wide::SMEM_DQ;
}

}  // namespace mma

}  // namespace

REPRO_ERROR_STRING_FN(flash_attention_bwd)

// q, o, dout, dq (B,Sq,H,Dh); k, v, dk, dv (B,Skv,Hkv,Dh); all contiguous and
// of one dtype (repro::kF32 or repro::kBF16; bf16 ones starting on 16-byte
// boundaries); lse (B,H,Sq) f32 from the forward; delta (B,H,Sq) f32
// scratch. Dh a multiple of 16, at most 256. head_subsets: the blocks that
// share each kv tile's GQA group (flash_attention_bwd.py's plan), 1 but for
// bf16 past Dh 128; where it is more, workspace holds head_subsets x 2 x B x
// Skv x Hkv x Dh f32 (else it is null). Launches three kernels on `stream`,
// four with a workspace; returns the first cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, void* workspace,
                                   int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                                   int window, int q_offset, int head_subsets, float scale,
                                   int dtype, void* stream) {
  if (Dh <= 0 || Dh % 16 != 0 || Dh > 256 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      H > 65535 || head_subsets < 1 || head_subsets > H / Hkv)
    return cudaErrorInvalidValue;
  const bool wide = dtype == repro::kBF16 && Dh > 128;
  if ((head_subsets > 1) != (workspace != nullptr) || (head_subsets > 1 && !wide))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* D = static_cast<float*>(delta);
  if (dtype == repro::kF32)
    return dispatch(q, k, v, o, dout, l, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal, window,
                    q_offset, scale, st);
  if (dtype == repro::kBF16)
    return mma::dispatch(q, k, v, o, dout, l, D, dq, dk, dv, static_cast<float*>(workspace),
                         head_subsets, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale,
                         st);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) that flash_attention_bwd launches its
// dK/dV kernel (bytes[0]) and its dQ kernel (bytes[1]) with, for inputs of
// `dtype` and head dim Dh; cudaErrorInvalidValue for what it refuses.
extern "C" int flash_attention_bwd_smem(int dtype, int Dh, int* bytes) {
  if (Dh <= 0 || Dh % 16 != 0 || Dh > 256) return cudaErrorInvalidValue;
  int b[2];
  if (dtype == repro::kF32) {
    b[0] = b[1] = (int)(smem_floats(Dh, Dh > 128 ? 32 : 64) * sizeof(float));
  } else if (dtype == repro::kBF16) {
    mma::smem_bytes(Dh, b);
  } else {
    return cudaErrorInvalidValue;
  }
  bytes[0] = b[0];
  bytes[1] = b[1];
  return 0;
}
