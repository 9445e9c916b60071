// The gradient of the Mamba-2 SSD scan (csrc/ssd_scan.cu) for Hopper (sm_90a),
// bf16 or f32 x, B, C and dy, f32 math.
//
// Replaces: no Pallas kernel. The JAX package takes this gradient by
// differentiating its chunked form (src/repro/kernels/ops.py:305-393); the
// forward it differentiates is ssd_scan_pallas (src/repro/kernels/ssd_scan.py:66).
//
// What it computes, per batch row b and head h, chunk c of Q steps, with cum
// the in-chunk prefix sum of dt * A[h], xdt_k = dt_k x_k, S = C . B^T,
// L_qk = exp(cum_q - cum_k) for k <= q, h_c the state entering chunk c (the
// forward's) and g_c the gradient of h_c (kernels/ref.py ssd_scan_bwd holds
// the same formulas in PyTorch):
//   g_nc = dh_final (or 0), g_c = exp(cum_end) g_{c+1} + sum_q exp(cum_q) dy_q (x) C_q
//   dxdt_k = sum_{q>=k} L_qk S_qk dy_q + exp(cum_end - cum_k) g_{c+1} B_k
//   dx = dt dxdt,  ddt = sum_p x dxdt + A[h] d(dA),  dA[h] = sum d(dA) dt,  dh0 = g_0
//   dC_q = sum_k M_qk B_k + sum_h exp(cum_q) dy_q^T h_c
//   dB_k = sum_q M_qk C_q + sum_h exp(cum_end - cum_k) xdt_k^T g_{c+1}
// with M = sum_h L o G and G_qk = dy_q . xdt_k, the head sums of the one B/C
// group; d(dA) is the reverse cumsum inside the chunk of dcum = the row sums
// minus the column sums of L o S o G, plus the carried term exp(cum_q) dy_q .
// (h_c C_q), minus the state term u_k = exp(cum_end - cum_k) xdt_k .
// (g_{c+1} B_k), plus, at every step, sum_k u_k + exp(cum_end) <g_{c+1}, h_c>
// (the terms of cum_end). Steps past S read as dt = 0, x = B = C = dy = 0, as
// in the forward, and their gradients are not written.
//
// Saved state. The backward reads three of the forward's f32 workspaces, kept
// by the autograd.Function (kernels/ssd_scan.py SSDScan) rather than
// recomputed: cum, the C . B^T tiles and the entering states h_c, which the
// forward's pass kernel leaves in place of the chunk states. At mamba2-1.3b's
// train shape (B 4, S 2048, H 64, P 64, N 128, chunk 256) that is 2.1 + 5.2 +
// 67.1 MB per call; under per-layer recompute one layer's is alive at a time.
// Its own f32 workspace, from the caching allocator, is 193 MB there: the
// head groups' parts of M 41.9 and of dB and dC 67.1, the state gradients
// 67.1, the row and column sums of L o S o G 10.5, three per-step rows 6.3.
//
// Design: the forward's chunk-parallel layout, eight kernels launched in order
// on the caller's stream. Every output and workspace element has one writer
// and a fixed summation order, with no atomics: two calls give bitwise-equal
// gradients. The sums over the heads that dB and dC need (64 at the train
// shape) run in order over groups of HG = 8 heads inside a block, and then
// over the groups in order: with one block for all 64 heads, 320 and 256
// blocks at two an SM, those two kernels took most of a call's time.
//   1. ssd_bwd_dstate, one block per (row, chunk, head): the chunk's own part
//      of the state gradient sum_q exp(cum_q) dy_q (x) C_q, a P x N product
//      over the chunk's query tiles (the forward's ssd_scan_state with dy and
//      C in place of the weighted x and B).
//   2. ssd_bwd_pass, one thread per (row, head, p, n): g over the chunks in
//      reverse from dh_final or 0, overwriting each chunk's slot with
//      g_{c+1}, the gradient leaving it; writes dh0 = g_0 when h0 was given.
//   3. ssd_bwd_scores, one block per (row, chunk, 64 x 64 tile pair at or
//      below the diagonal, head group), its heads in order: G = dY . X^T over
//      P, then dt_k, the mask and L, L o G summed over the group into its
//      part of M, and the row and column sums of L o S o G per head (the
//      forward's C . B^T tile as S).
//   4. ssd_bwd_dbc_part, one block per (row, chunk, 64-row tile, dC or dB, head
//      group), its heads in order: dY h_c (dC) or X g_{c+1} (dB), each row
//      then weighted by exp(cum_q) (dC) or exp(cum_end - cum_k) dt_k (dB),
//      each head's 64 x N product summed into the group's part and dotted
//      with the rows' own C or B for the carried and state terms of dcum.
//   5. ssd_bwd_dbc_sum, one block per (row, chunk, 64-row tile, dC or dB):
//      the groups' parts in order, plus M (dC) or M^T (dB), M the groups'
//      parts in order, times the B or C tiles; writes dC or dB.
//   6. ssd_bwd_dx, one block per (row, chunk, head, 64-row key tile): the
//      state term B_k g_{c+1}^T, each key row weighted by
//      exp(cum_end - cum_k), then (L o S)^T dY over the query tiles at or
//      above it; writes dx and sum_p x dxdt. The first key tile's block also
//      takes <g_{c+1}, h_c>, in f32.
//   7. ssd_bwd_dt, one block per (row, chunk, head), a thread per step:
//      dcum from the partial sums in order, the reverse cumsum d(dA) by a
//      block scan, ddt, and the chunk's part of dA.
//   8. ssd_bwd_da, one thread per head: dA over the rows and chunks in order.
//
// Tensor cores. Kernels 3, 4 and 6 take their products on mma.sync m16n8k16
// (bf16 operands, f32 accumulators; the helpers of mma.cuh, as the flash
// kernels do), 8 warps a block, each 16 rows of a 64-row tile by 32 (3, 6) or
// 64 (4) of its columns. Every product there has an operand that is a raw
// input, dy, x or B, which a bf16 call holds exactly; the other is f32 (h_c,
// g_{c+1}, or L o S built from the forward's C . B^T and cum) and is split
// into bf16 hi = bf16(a) and lo = bf16(a - hi), two products whose sum is
// within 2^-16 |a| of the f32 one. G has two raw operands and dt_k comes
// after the product; the decay weights of the rows are applied to the f32
// results, never to an operand. An f32 call splits every operand in three
// parts and sums the six products of parts i, j with i + j < 3, within about
// 2^-24 (kRawParts, kF32Parts). tests/test_torch_ssd_bwd_split.py holds a
// mirror of this rounding (kernels/ref.py ssd_scan_bwd(split=...)) against
// jax.vjp at the f32 gradients' 1e-4 bound. Raw bf16 rows (P or N contiguous
// elements) move into shared memory by 16-byte cp.async when they start on
// 16-byte boundaries (the launcher checks), else by plain loads; f32 operands
// are split while they are staged, each thread's loads all in flight before
// its first split. Rows are padded by 16 bytes, so ldmatrix is free of bank
// conflicts. Kernel 3 double-buffers its heads' dy and x tiles; kernel 6's
// intra-chunk tiles reuse the state term's shared memory. The dynamic shared
// memory of each kernel is in smem_bytes (kernels/ssd_scan_bwd.py plan()
// gives the same numbers). Kernels 1 and 5 run on f32 FMAs from shared memory
// on 4 x 8 register tiles, as in the forward. On the H100, 4 warps of 16 x 64
// were no faster in kernel 3 and slower in kernel 6, and a cp.async prefetch
// of the next head's state gained kernel 4 too little for a second staging
// path and 32 KB of shared memory, so it was left out.
//
// What bounds it on the H100. At the train shape the function must move x,
// dy and dx (3 x 67 MB bf16), dt and ddt (2 x 2.1 MB), B, C, dB and dC (4 x
// 2.1 MB): 214 MB, 64 us at 3.35 TB/s. Its arithmetic, the chunked form's
// products over lower triangles only, is 52 GFLOP (four P x N-by-chunk
// products per (row, chunk, head), 8.6 GFLOP each: the chunk state gradient,
// g B, dY^T h_c, XDT^T g; G and (L o S)^T dY, 8.6 each; M B and M^T C, 0.5),
// 53 us at the 989 TFLOP/s bf16 tensor-core peak, so bytes set the card's
// floor. This design takes 43 of those GFLOP as 77 GFLOP of bf16 products
// (the split terms counted), 78 us at 989 TFLOP/s, and the chunk state
// gradient, M B and M^T C (9.1 GFLOP) on f32 FMAs, 136 us at 67 TFLOP/s: a
// floor of about 0.21 ms. PERF.md holds the measured times beside it.

#include "common.cuh"
#include "mma.cuh"

#include <limits.h>
#include <math.h>

#include <type_traits>

namespace {

using namespace repro::mma;

constexpr int NT = 256;    // threads a block of the f32 kernels: 16 x 16
constexpr int TQ = 64;     // rows of a query tile and of a key tile
constexpr int MAXQ = NT;   // chunk bound: one step per thread in ssd_bwd_dt
constexpr int MAXP = 64;   // head dim bound (4 columns per thread)
constexpr int MAXN = 128;  // state dim bound (8 columns per thread in the P x N products)
constexpr int PT = TQ + 4; // pitch of a transposed tile: 16-byte rows, conflict-free stores
constexpr int PA = TQ + 8;    // pitch (bf16) of a 64-column mma operand tile: 144-byte rows
constexpr int PB = MAXN + 8;  // pitch (bf16) of a 128-column mma operand tile: 272-byte rows
constexpr int kPassUnroll = 8;  // chunks whose loads the state pass issues together
constexpr int HG = 8;      // heads a block of ssd_bwd_scores and ssd_bwd_dbc_part sums
constexpr unsigned kFull = 0xffffffffu;

// Operand parts. A tensor-core operand is staged as K bf16 tiles whose sum is
// its value: a raw bf16 input is exact (K = 1); an f32 value a splits into
// hi = bf16(a), then what is left (exact in f32) splits again, so two parts
// hold a to 2^-16 |a| and three to about 2^-24 |a|. bf16 calls split their
// f32 operands (h_c, g_{c+1}, L o S) in two. f32 calls split every operand
// in three, the precision of the f32 FMAs they replace: the row and column
// sums of L o S o G cancel in dcum, and with two parts dA reached its f32
// bound at adversarial magnitudes (PERF.md).
template <typename T>
constexpr int kRawParts = std::is_same<T, float>::value ? 3 : 1;
template <typename T>
constexpr int kF32Parts = std::is_same<T, float>::value ? 3 : 2;

// shared floats of the f32 kernels
constexpr int kDstateSmem = TQ * MAXP + TQ * MAXN + MAXQ;
constexpr int kDbcSumSmem = TQ * PT + TQ * MAXN;

// ssd_bwd_scores: 8 warps, each 16 query rows x 32 of the 64 keys of the tile
// pair. Two stages, each the parts of the dy tile, then of the x tile, and
// the cum of the query and key rows and dt of the keys; then the column sums
// of each 16-row band and the row sums of each key half.
constexpr int kScoresThreads = 256;
template <typename T>
struct ScoresSmem {
  static constexpr int kTiles = 2 * kRawParts<T>;
  static constexpr int kStage = kTiles * TQ * PA * 2 + 3 * TQ * 4;
  static constexpr int kBytes = 2 * kStage + 6 * TQ * 4;
};

// ssd_bwd_dbc_part: 8 warps, each 16 rows x 64 state columns. The parts of
// the rows' dy or x tile and of the head's h_c or g_{c+1}, the rows' own C or
// B (in T), the row weights, two halves of the dcum dots.
constexpr int kDbcThreads = 256;
template <typename T>
struct DbcSmem {
  static constexpr int kA = TQ * PA * 2;
  static constexpr int kH = MAXP * PB * 2;
  static constexpr int kOwn = TQ * PB * (int)sizeof(T);
  static constexpr int kBytes = kRawParts<T> * kA + kF32Parts<T> * kH + kOwn + 3 * TQ * 4;
};

// ssd_bwd_dx: 8 warps, each 16 keys x 32 of the P columns. The state term
// reads the parts of the key tile of B and of g_{c+1}; the intra term, over
// the same bytes, the parts of L o S of a tile pair and of the query tile of
// dy; then cum, 8 warp sums and the two column halves' sums of x dxdt.
constexpr int kDxThreads = 256;
template <typename T>
struct DxSmem {
  static constexpr int kB = TQ * PB * 2;
  static constexpr int kG = MAXP * PB * 2;
  static constexpr int kW = TQ * PA * 2;
  static constexpr int kState = kRawParts<T> * kB + kF32Parts<T> * kG;
  static_assert((kF32Parts<T> + kRawParts<T>) * kW <= kState,
                "dx: the intra tiles reuse the state tiles");
  static constexpr int kBytes = kState + (MAXQ + kDxThreads / 32 + 2 * TQ) * 4;
};
static_assert(ScoresSmem<float>::kBytes <= 232448 && DbcSmem<float>::kBytes <= 232448 &&
                  DxSmem<float>::kBytes <= 232448, "an SM's shared memory");

struct Dims {
  int B, S, H, P, N, Q;
  int nc;  // chunks of a row
  int nt;  // TQ-row tiles of a chunk
  int np;  // tile pairs (query tile, key tile at or below it) of a chunk
  int ng;  // groups of HG heads
  int vec; // bf16 rows of x, dy, B and C start on 16-byte boundaries: cp.async
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += a[i] b[j] for the 8 columns 4 tx + 64 (j / 4) + j % 4 of a
// row of MAXN floats
__device__ __forceinline__ void fma48(float (&acc)[4][8], float4 a, const float* brow, int tx) {
  const float4 b0 = ld4(brow + tx * 4), b1 = ld4(brow + 64 + tx * 4);
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

__device__ __forceinline__ int col8(int tx, int j) { return tx * 4 + 64 * (j >> 2) + (j & 3); }

// the sum over the 4 lanes of a quad (an mma row), the same butterfly on every call
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Inclusive prefix sum of v over threadIdx.x in a fixed order, and the
// block's total; every thread of the block must call it.
__device__ __forceinline__ float block_scan(float v, float* wsum, float& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  __syncthreads();  // wsum is free: its previous use is read
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  float before = 0.f, all = 0.f;
  for (int w = 0; w < NT / 32; ++w) {
    if (w < warp) before += wsum[w];
    all += wsum[w];
  }
  total = all;
  return v + before;
}

// dst[c * PT + r] = get(r, c) for r < TQ, c < cols8 (a multiple of 8). A warp
// takes 8 columns of 4 rows: its reads are 4 runs of 8 columns, and its
// stores land on 32 distinct banks (4c + r mod 32 at pitch 68).
template <typename F>
__device__ __forceinline__ void stage_t(float* dst, int cols8, F get) {
  const int groups = cols8 >> 3;  // 8-column groups across a row
  for (int i = threadIdx.x; i < TQ * cols8; i += NT) {
    const int g = i >> 5, lane = i & 31;
    const int c = (g % groups) * 8 + (lane & 7), r = (g / groups) * 4 + (lane >> 3);
    dst[c * PT + r] = get(r, c);
  }
}

// two adjacent elements (the first on a 2-element boundary) as f32, and stored
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The K parts of the f32 pair (a, b), each a bf16 pair in one register:
// kernels/ref.py split_bf16 is the same rounding in PyTorch
template <int K>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t (&p)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    p[k] = *reinterpret_cast<const uint32_t*>(&h);
    a -= __low2float(h);
    b -= __high2float(h);
  }
}

// TQ rows x 8 CH columns of a T matrix as its kRawParts<T> mma operand tiles
// of pitch `pitch`, `part` elements apart: tile row r is src[r * stride + c]
// for r < nrows, c < ncols, else 0. With vec (bf16 rows on 16-byte
// boundaries, ncols a multiple of 8) the rows move by cp.async; the caller
// commits and waits. `base` is any valid address of the matrix (the source
// of zero-filled copies).
template <typename T, int CH>
__device__ __forceinline__ void stage_rows(bf16* dst, int part, int pitch, const T* src,
                                           const T* base, long stride, int nrows, int ncols,
                                           bool vec) {
  constexpr int K = kRawParts<T>;
  for (int i = threadIdx.x; i < TQ * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const T* s = src + r * stride + c;
    if constexpr (K == 1) {
      if (vec) {
        const bool in = r < nrows && c < ncols;
        cp_async16(dst + r * pitch + c, in ? s : base, in);
        continue;
      }
    }
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = r < nrows && c + j < ncols ? repro::to_f32(s[j]) : 0.f;
    uint32_t p[4][K];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_pair<K>(v[2 * j], v[2 * j + 1], p[j]);
#pragma unroll
    for (int k = 0; k < K; ++k)
      *reinterpret_cast<uint4*>(dst + k * part + r * pitch + c) =
          make_uint4(p[0][k], p[1][k], p[2][k], p[3][k]);
  }
}

// A head's P x N f32 state (row-major at src) as its K parts, tiles
// [MAXP][PB] MAXP * PB elements apart, 0 outside P x N, by a block of NTH
// threads: all of a thread's loads are in flight before its first split
template <int NTH, int K>
__device__ __forceinline__ void stage_state(bf16* dst, const float* src, int P, int N) {
  constexpr int part = MAXP * PB;
  if ((N & 3) == 0) {  // 16-byte loads: every row starts on a 16-byte boundary
    constexpr int kIters = MAXP * MAXN / 4 / NTH;
    float4 v[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * NTH, p = i / (MAXN / 4), n = (i % (MAXN / 4)) * 4;
      v[it] = p < P && n < N ? ld4(src + p * N + n) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * NTH, p = i / (MAXN / 4), n = (i % (MAXN / 4)) * 4;
      uint32_t lo[K], hi[K];
      split_pair<K>(v[it].x, v[it].y, lo);
      split_pair<K>(v[it].z, v[it].w, hi);
#pragma unroll
      for (int k = 0; k < K; ++k)
        *reinterpret_cast<uint2*>(dst + k * part + p * PB + n) = make_uint2(lo[k], hi[k]);
    }
  } else {
    for (int i = threadIdx.x; i < MAXP * (MAXN / 2); i += NTH) {
      const int p = i / (MAXN / 2), n = (i % (MAXN / 2)) * 2;
      const float a = p < P && n < N ? src[p * N + n] : 0.f;
      const float b = p < P && n + 1 < N ? src[p * N + n + 1] : 0.f;
      uint32_t q[K];
      split_pair<K>(a, b, q);
#pragma unroll
      for (int k = 0; k < K; ++k) *reinterpret_cast<uint32_t*>(dst + k * part + p * PB + n) = q[k];
    }
  }
}

// acc0, acc1 += a . b over one k-step of 16, for the two 8-column n-tiles
// whose B fragments are b[j] (regs 0, 1 and 2, 3), a and b in KA and KB
// parts: the products of parts i and j with i + j below the larger count,
// largest first; for three and three parts the rest is below 2^-24 of a . b
template <int KA, int KB>
__device__ __forceinline__ void mma_parts(float (&acc0)[4], float (&acc1)[4],
                                          const uint32_t (&a)[KA][4],
                                          const uint32_t (&b)[KB][4]) {
  constexpr int kTerms = KA > KB ? KA : KB;
#pragma unroll
  for (int t = 0; t < kTerms; ++t)
#pragma unroll
    for (int i = 0; i < KA; ++i) {
      const int j = t - i;
      if (j >= 0 && j < KB) {
        mma_bf16(acc0, a[i], b[j][0], b[j][1]);
        mma_bf16(acc1, a[i], b[j][2], b[j][3]);
      }
    }
}

// 1. the chunk's own part of the state gradient, per (row, chunk, head):
//    d_c[p][n] = sum_q exp(cum_q) dy_q[p] C_q[n]
template <typename T>
__global__ void __launch_bounds__(NT, 3) ssd_bwd_dstate(
    const T* __restrict__ dy, const T* __restrict__ Cm, const float* __restrict__ cum_ws,
    float* __restrict__ gs, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Ys = smem;              // [TQ][MAXP] exp(cum_q)-weighted dy of a query tile
  float* Cs = Ys + TQ * MAXP;    // [TQ][MAXN] C of the query tile
  float* ecum = Cs + TQ * MAXN;  // [MAXQ] exp(cum_q)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x % d.H, bc = blockIdx.x / d.H, c = bc % d.nc, b = bc / d.nc;
  const long bch = (long)bc * d.H + h;
  const int t0 = c * d.Q;
  const long xrow = (long)d.H * d.P;  // stride of one step in x and dy
  if (tid < d.Q) ecum[tid] = expf(cum_ws[bch * d.Q + tid]);

  // this thread: p = 4 ty + i, n = 4 tx + 64 j + l
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int q0 = 0; q0 < d.Q; q0 += TQ) {
    const int nq = min(TQ, d.Q - q0);
    const int rows = min(nq, d.S - t0 - q0);  // rows of the tile inside S
    __syncthreads();  // ecum is written; the previous query tile is read
    {  // Ys: column p = tid % 64 of rows tid / 64 + 4 i
      const int p = tid & (MAXP - 1);
      const T* src = dy + ((long)b * d.S + t0 + q0) * xrow + (long)h * d.P + p;
      for (int r = tid / MAXP; r < TQ; r += NT / MAXP)
        Ys[r * MAXP + p] =
            (r < rows && p < d.P) ? repro::to_f32(src[r * xrow]) * ecum[q0 + r] : 0.f;
    }
    {  // Cs: column n = tid % 128 of rows tid / 128 + 2 i
      const int n = tid & (MAXN - 1);
      const T* src = Cm + ((long)b * d.S + t0 + q0) * d.N + n;
      for (int r = tid / MAXN; r < TQ; r += NT / MAXN)
        Cs[r * MAXN + n] = (r < rows && n < d.N) ? repro::to_f32(src[(long)r * d.N]) : 0.f;
    }
    __syncthreads();
    for (int q = 0; q < nq; ++q) fma48(acc, ld4(Ys + q * MAXP + ty * 4), Cs + q * MAXN, tx);
  }

  float* out = gs + bch * d.P * d.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty * 4 + i;
    if (p >= d.P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = col8(tx, j);
      if (n < d.N) out[(long)p * d.N + n] = acc[i][j];
    }
  }
}

// 2. the state gradient over the chunks in reverse, one thread per (row, head, p, n)
__global__ void __launch_bounds__(NT) ssd_bwd_pass(
    const float* __restrict__ dh_final, const float* __restrict__ cum_ws,
    float* __restrict__ gs, float* __restrict__ dh0, Dims d) {
  const long pn_count = (long)d.P * d.N;
  const long e = (long)blockIdx.x * NT + threadIdx.x;
  if (e >= (long)d.B * d.H * pn_count) return;
  const long bh = e / pn_count, pn = e - bh * pn_count;
  const int h = (int)(bh % d.H), b = (int)(bh / d.H);
  const long step = (long)d.H * pn_count;  // from one chunk's slot to the next
  float* slot = gs + ((long)b * d.nc * d.H + h) * pn_count + pn;
  const float* cum_end = cum_ws + ((long)b * d.nc * d.H + h) * d.Q + d.Q - 1;
  float g = dh_final != nullptr ? dh_final[e] : 0.f;
  for (int c1 = d.nc; c1 > 0; c1 -= kPassUnroll) {
    // the loads of chunks c1 - 1 down to c1 - kPassUnroll first, in flight together
    float contrib[kPassUnroll], ce[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = c1 - 1 - u;
      if (c >= 0) {
        contrib[u] = slot[c * step];
        ce[u] = cum_end[(long)c * d.H * d.Q];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = c1 - 1 - u;
      if (c >= 0) {
        slot[c * step] = g;  // the gradient leaving chunk c, g_{c+1}
        g = fmaf(expf(ce[u]), g, contrib[u]);
      }
    }
  }
  if (dh0 != nullptr) dh0[e] = g;
}

// 3. G = dY . X^T per head over a tile pair, on the tensor cores, then dt_k
//    and the mask; the group's part of M = sum_h L o G, and the row and
//    column sums of L o S o G per head
template <typename T>
__global__ void __launch_bounds__(kScoresThreads, 3) ssd_bwd_scores(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ dy,
    const float* __restrict__ cum_ws, const float* __restrict__ sc_ws,
    float* __restrict__ m_ws, float* __restrict__ rs_ws, float* __restrict__ cs_ws, Dims d) {
  using L = ScoresSmem<T>;
  constexpr int KR = kRawParts<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw + 2 * L::kStage);  // [4][TQ] bands' column sums
  float* rpart = part + 4 * TQ;  // [2][TQ] the key halves' row sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, cl = lane & 3;
  const int grp = blockIdx.x % d.ng, rest = blockIdx.x / d.ng;
  const int pair = rest % d.np, bc = rest / d.np;
  const int c = bc % d.nc, b = bc / d.nc;
  const int h_first = grp * HG, nh = min(d.H, h_first + HG) - h_first;
  int qi = 0;  // pair = qi (qi + 1) / 2 + ki with ki <= qi
  while ((qi + 1) * (qi + 2) / 2 <= pair) ++qi;
  const int ki = pair - qi * (qi + 1) / 2;
  const int t0 = c * d.Q, q0 = qi * TQ, k0 = ki * TQ;
  const int nq = min(TQ, d.Q - q0), nk = min(TQ, d.Q - k0);
  const int qrows = min(nq, d.S - t0 - q0), krows = min(nk, d.S - t0 - k0);
  const long xrow = (long)d.H * d.P;
  const long tile = ((long)bc * d.np + pair) * TQ * TQ;
  const int wq = (warp & 3) * 16, wk = (warp >> 2) * 32;  // the warp's first query row, key

  // stage s of head h_first + i: the dy rows of the query tile and the x rows
  // of the key tile, cum of both and dt of the keys
  auto stage = [&](int i, int s) {
    const int h = h_first + i;
    const long bch = (long)bc * d.H + h;
    unsigned char* at = smem_raw + s * L::kStage;
    bf16* ys = reinterpret_cast<bf16*>(at);  // the parts of dy, then of x
    stage_rows<T, TQ / 8>(ys, TQ * PA, PA,
                          dy + ((long)b * d.S + t0 + q0) * xrow + (long)h * d.P, dy, xrow,
                          qrows, d.P, d.vec);
    stage_rows<T, TQ / 8>(ys + KR * TQ * PA, TQ * PA, PA,
                          x + ((long)b * d.S + t0 + k0) * xrow + (long)h * d.P, x, xrow,
                          krows, d.P, d.vec);
    float* cq = reinterpret_cast<float*>(at + L::kTiles * TQ * PA * 2);
    if (tid < TQ) {
      cq[tid] = tid < nq ? cum_ws[bch * d.Q + q0 + tid] : 0.f;
      cq[TQ + tid] = tid < nk ? cum_ws[bch * d.Q + k0 + tid] : 0.f;
      cq[2 * TQ + tid] = tid < krows ? dt[((long)b * d.S + t0 + k0 + tid) * d.H + h] : 0.f;
    }
  };

  // S of this tile pair, key-major in the forward's workspace, at this
  // thread's accumulator elements: n-tile j, element e is query
  // wq + g + 8 (e / 2), key wk + 8 j + 2 cl + e % 2
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = sc_ws[tile + (wk + 8 * j + 2 * cl + (e & 1)) * TQ + wq + g + 8 * (e >> 1)];

  float macc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) macc[j][e] = 0.f;
  const int ksteps = (d.P + 15) >> 4;
  stage(0, 0);
  cp_async_commit();
  for (int i = 0; i < nh; ++i) {
    const int h = h_first + i, st = i & 1;
    if (i + 1 < nh) {
      stage(i + 1, st ^ 1);  // its buffers were last read in step i - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step i visible to every warp
    const unsigned char* at = smem_raw + st * L::kStage;
    const bf16* ys = reinterpret_cast<const bf16*>(at);
    const bf16* xs = ys + KR * TQ * PA;
    const float* cq = reinterpret_cast<const float*>(at + L::kTiles * TQ * PA * 2);
    const float* ck = cq + TQ;
    const float* dtk = ck + TQ;

    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t a[KR][4];
#pragma unroll
      for (int k = 0; k < KR; ++k)
        ldmatrix_x4(a[k], smem_u32(ys + k * TQ * PA + wq * PA + a_off<PA>(lane) + kk * 16));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = (wk + np * 16) * PA + b_off<PA>(lane) + kk * 16;
        uint32_t bf[KR][4];
#pragma unroll
        for (int k = 0; k < KR; ++k) ldmatrix_x4(bf[k], smem_u32(xs + k * TQ * PA + off));
        mma_parts<KR, KR>(acc[2 * np], acc[2 * np + 1], a, bf);
      }
    }

    // G dt_k L on the mask (key at or below the query), 0 off it
    float rsum[2] = {0.f, 0.f}, csum[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      csum[j][0] = csum[j][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = wq + g + 8 * (e >> 1), k = wk + 8 * j + 2 * cl + (e & 1);
        const float w = (q < nq && k < nk && k0 + k <= q0 + q)
                            ? acc[j][e] * dtk[k] * expf(cq[q] - ck[k]) : 0.f;
        macc[j][e] += w;
        const float t = w * s[j][e];
        rsum[e >> 1] += t;
        csum[j][e & 1] += t;
      }
    }
    // row sums: a quad holds a row's 32 keys of the warp's half, then the
    // two halves in order
    rsum[0] = quad_sum(rsum[0]);
    rsum[1] = quad_sum(rsum[1]);
    if (cl == 0) {
      rpart[(warp >> 2) * TQ + wq + g] = rsum[0];
      rpart[(warp >> 2) * TQ + wq + g + 8] = rsum[1];
    }
    // column sums: over the 8 quads of the warp, then the 4 bands in order
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = csum[j][u];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        if (g == 0) part[(warp & 3) * TQ + wk + 8 * j + 2 * cl + u] = v;
      }
    __syncthreads();  // part and rpart written; every warp done with stage st
    const long sums = (((long)bc * d.np + pair) * d.H + h) * TQ;
    if (tid < TQ)
      cs_ws[sums + tid] = part[tid] + part[TQ + tid] + part[2 * TQ + tid] + part[3 * TQ + tid];
    else if (tid < 2 * TQ)
      rs_ws[sums + tid - TQ] = rpart[tid - TQ] + rpart[tid];
  }
  float* out = m_ws + (((long)bc * d.np + pair) * d.ng + grp) * TQ * TQ;  // key-major, as S
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(wk + 8 * j + 2 * cl + (e & 1)) * TQ + wq + g + 8 * (e >> 1)] = macc[j][e];
}

// 4. a group's part of dC (role 0, query rows) or dB (role 1, key rows) of
//    one 64-row tile, its heads in order, into an f32 workspace; and each
//    head's carried (dC) or state (dB) term of dcum. Per head, on the tensor
//    cores, dY h_c (dC) or X g_{c+1} (dB) over P, each row then weighted by
//    exp(cum_q) (dC) or exp(cum_end - cum_k) dt_k (dB).
template <typename T>
__global__ void __launch_bounds__(kDbcThreads, 2) ssd_bwd_dbc_part(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dy, const float* __restrict__ cum_ws,
    const float* __restrict__ st_ws, const float* __restrict__ gs,
    float* __restrict__ part_ws, float* __restrict__ car_ws, float* __restrict__ u_ws, Dims d) {
  using L = DbcSmem<T>;
  constexpr int KR = kRawParts<T>, KF = kF32Parts<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // KR x [TQ][PA] the head's dy or x rows
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw + KR * L::kA);  // KF x [MAXP][PB] h_c or g_{c+1}
  T* own = reinterpret_cast<T*>(h_s + KF * MAXP * PB);  // [TQ][PB] the rows' own C or B
  float* w = reinterpret_cast<float*>(own + TQ * PB);  // [TQ] the rows' weights
  float* dots = w + TQ;                             // [2][TQ] the dcum dots of each column half

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, cl = lane & 3;
  const int grp = blockIdx.x % d.ng, tile = blockIdx.x / d.ng;  // tile: (row, chunk, t, role)
  const int role = tile & 1, rest = tile >> 1;
  const int t = rest % d.nt, bc = rest / d.nt, c = bc % d.nc, b = bc / d.nc;
  const int h_first = grp * HG, h_end = min(d.H, h_first + HG);
  const int t0 = c * d.Q, r0 = t * TQ, nr = min(TQ, d.Q - r0);
  const int rows = min(nr, d.S - t0 - r0);  // rows of the tile inside S
  const long xrow = (long)d.H * d.P;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 64;  // the warp's first row and column
  const T* arows = (role == 0 ? dy : x) + ((long)b * d.S + t0 + r0) * xrow;

  {  // the rows' own C (dC) or B (dB), the same for every head
    const T* src = (role == 0 ? Cm : Bm) + ((long)b * d.S + t0 + r0) * d.N;
    for (int i = tid; i < TQ * MAXN; i += kDbcThreads) {
      const int r = i / MAXN, n = i % MAXN;
      own[r * PB + n] = r < rows && n < d.N ? src[(long)r * d.N + n] : repro::from_f32<T>(0.f);
    }
  }
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int ksteps = (d.P + 15) >> 4;
  for (int h = h_first; h < h_end; ++h) {
    const long bch = (long)bc * d.H + h;
    const float* cum = cum_ws + bch * d.Q;
    __syncthreads();  // the previous head's tiles and dots are read
    stage_rows<T, TQ / 8>(a_s, TQ * PA, PA, arows + (long)h * d.P, role == 0 ? dy : x, xrow,
                          rows, d.P, d.vec);
    cp_async_commit();
    stage_state<kDbcThreads, KF>(h_s, (role == 0 ? st_ws : gs) + bch * d.P * d.N, d.P, d.N);
    if (tid < TQ) {  // dC: exp(cum_q); dB: exp(cum_end - cum_k) dt_k
      float wv = 0.f;
      if (tid < rows) {
        if (role == 0) wv = expf(cum[r0 + tid]);
        else wv = expf(cum[d.Q - 1] - cum[r0 + tid]) *
                  dt[((long)b * d.S + t0 + r0 + tid) * d.H + h];
      }
      w[tid] = wv;
    }
    cp_async_wait<0>();
    __syncthreads();

    // the warp's 16 rows x 64 columns of the head's product
    float ph[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ph[j][e] = 0.f;
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t a[KR][4];
#pragma unroll
      for (int k = 0; k < KR; ++k)
        ldmatrix_x4(a[k], smem_u32(a_s + k * TQ * PA + wr * PA + a_off<PA>(lane) + kk * 16));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = kk * 16 * PB + bt_off<PB>(lane) + wc + np * 16;
        uint32_t bf[KF][4];
#pragma unroll
        for (int k = 0; k < KF; ++k) ldmatrix_x4_trans(bf[k], smem_u32(h_s + k * MAXP * PB + off));
        mma_parts<KR, KF>(ph[2 * np], ph[2 * np + 1], a, bf);
      }
    }
    // weight the rows, add the head to the group's sum, and dot each row
    // with its own C or B: the carried (dC) or state (dB) term of dcum
    const float w0 = w[wr + g], w1 = w[wr + g + 8];
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + g + 8 * (e >> 1), n = wc + 8 * j + 2 * cl + (e & 1);
        const float v = ph[j][e] * ((e >> 1) ? w1 : w0);
        acc[j][e] += v;
        dot[e >> 1] = fmaf(v, repro::to_f32(own[r * PB + n]), dot[e >> 1]);
      }
    dot[0] = quad_sum(dot[0]);
    dot[1] = quad_sum(dot[1]);
    if (cl == 0) {
      dots[(warp >> 2) * TQ + wr + g] = dot[0];
      dots[(warp >> 2) * TQ + wr + g + 8] = dot[1];
    }
    __syncthreads();  // both column halves' dots written
    if (tid < nr) (role == 0 ? car_ws : u_ws)[bch * d.Q + r0 + tid] = dots[tid] + dots[TQ + tid];
  }

  float* out = part_ws + ((long)tile * d.ng + grp) * TQ * MAXN;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(out + (wr + g + 8 * i) * MAXN + wc + 8 * j + 2 * cl) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
}

// 5. dC or dB of one 64-row tile: the groups' parts in order, then M (dC)
//    or M^T (dB), M the groups' parts in order, times the B or C tiles
template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_bwd_dbc_sum(
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ m_ws,
    const float* __restrict__ part_ws, T* __restrict__ dB, T* __restrict__ dC, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Mt = smem;              // [TQ][PT] a tile of M, [inner][r]
  float* Os = Mt + TQ * PT;      // [TQ][MAXN] the B or C rows it multiplies

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tile = blockIdx.x, role = tile & 1, rest = tile >> 1;
  const int t = rest % d.nt, bc = rest / d.nt, c = bc % d.nc, b = bc / d.nc;
  const int t0 = c * d.Q, r0 = t * TQ, nr = min(TQ, d.Q - r0);
  const int rows = min(nr, d.S - t0 - r0);  // rows of the tile inside S
  const T* other = role == 0 ? Bm : Cm;

  // this thread: rows r = 4 ty + i, columns n = 4 tx + 64 j + l
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int g = 0; g < d.ng; ++g) {
    const float* part = part_ws + ((long)tile * d.ng + g) * TQ * MAXN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* prow = part + (ty * 4 + i) * MAXN + tx * 4;
      const float4 a = ld4(prow), e = ld4(prow + 64);
      const float pv[8] = {a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += pv[j];
    }
  }

  // dC_q += sum_k M_qk B_k over the key tiles at or below t; dB_k += sum_q
  // M_qk C_q over the query tiles at or above it
  const int lo = role == 0 ? 0 : t, hi = role == 0 ? t : d.nt - 1;
  for (int o = lo; o <= hi; ++o) {
    const int pair = role == 0 ? t * (t + 1) / 2 + o : o * (o + 1) / 2 + t;
    const float* m = m_ws + ((long)bc * d.np + pair) * d.ng * TQ * TQ;  // key-major [k][q]
    auto msum = [&](int i) {  // M over the head groups, in order
      float v = 0.f;
      for (int g = 0; g < d.ng; ++g) v += m[(long)g * TQ * TQ + i];
      return v;
    };
    const int o0 = o * TQ, orows = min(min(TQ, d.Q - o0), d.S - t0 - o0);
    __syncthreads();  // the previous products are done with Mt and Os
    if (role == 0) {  // Mt[k][q] = M[q][k]: a copy
      for (int i = tid; i < TQ * TQ; i += NT) Mt[(i / TQ) * PT + i % TQ] = msum(i);
    } else {          // Mt[q][k] = M[q][k]: a transpose
      stage_t(Mt, TQ, [&](int k, int q) { return msum(k * TQ + q); });
    }
    for (int i = tid; i < TQ * MAXN; i += NT) {
      const int r = i / MAXN, n = i % MAXN;
      Os[i] = (r < orows && n < d.N)
                  ? repro::to_f32(other[((long)b * d.S + t0 + o0 + r) * d.N + n]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < TQ; ++kk) fma48(acc, ld4(Mt + kk * PT + ty * 4), Os + kk * MAXN, tx);
  }

  T* out = role == 0 ? dC : dB;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    T* orow = out + ((long)b * d.S + t0 + r0 + r) * d.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = col8(tx, j);
      if (n < d.N) orow[n] = repro::from_f32<T>(acc[i][j]);
    }
  }
}

// 6. dxdt of one key tile per (row, chunk, head), on the tensor cores: the
//    state term B g_{c+1}^T over N, each key row then weighted by
//    exp(cum_end - cum_k), and (L o S)^T dY over the query tiles at or above
//    it; writes dx and sum_p x dxdt
template <typename T>
__global__ void __launch_bounds__(kDxThreads, 3) ssd_bwd_dx(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ dy, const float* __restrict__ cum_ws, const float* __restrict__ sc_ws,
    const float* __restrict__ st_ws, const float* __restrict__ gs, T* __restrict__ dx,
    float* __restrict__ xd_ws, float* __restrict__ gh_ws, Dims d) {
  using L = DxSmem<T>;
  constexpr int KR = kRawParts<T>, KF = kF32Parts<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the state term's tiles: KR x [TQ][PB] B of the key tile, KF x [MAXP][PB]
  // g_{c+1} as [p][n]
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = b_s + KR * TQ * PB;
  // the intra term's, over the same bytes: KF x [TQ][PA] (L o S)^T of a tile
  // pair as [k][q], KR x [TQ][PA] dy of the query tile as [q][p]
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* y_s = w_s + KF * TQ * PA;
  float* cum = reinterpret_cast<float*>(smem_raw + L::kState);  // [MAXQ]
  float* red = cum + MAXQ;                                      // [8] warp sums
  float* xsum = red + kDxThreads / 32;                          // [2][TQ] x dxdt per column half

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, cl = lane & 3;
  const int ki = blockIdx.x % d.nt, rest = blockIdx.x / d.nt;
  const int h = rest % d.H, bc = rest / d.H, c = bc % d.nc, b = bc / d.nc;
  const long bch = (long)bc * d.H + h;
  const int t0 = c * d.Q, k0 = ki * TQ, nk = min(TQ, d.Q - k0);
  const int krows = min(nk, d.S - t0 - k0);  // key rows inside S
  const long xrow = (long)d.H * d.P;
  const int wk = (warp & 3) * 16, wp = (warp >> 2) * 32;  // the warp's first key row, column
  const float* g_c = gs + bch * d.P * d.N;

  for (int i = tid; i < d.Q; i += kDxThreads) cum[i] = cum_ws[bch * d.Q + i];
  stage_rows<T, MAXN / 8>(b_s, TQ * PB, PB, Bm + ((long)b * d.S + t0 + k0) * d.N, Bm, d.N,
                          krows, d.N, d.vec);
  cp_async_commit();
  stage_state<kDxThreads, KF>(g_s, g_c, d.P, d.N);
  if (ki == 0) {  // <g_{c+1}, h_c> in f32, once per (row, chunk, head)
    const float* hc = st_ws + bch * d.P * d.N;
    float v = 0.f;
    if ((d.N & 3) == 0) {  // 16-byte loads, four of each in flight
#pragma unroll 4
      for (int i = 4 * tid; i < d.P * d.N; i += 4 * kDxThreads) {
        const float4 a = ld4(g_c + i), e = ld4(hc + i);
        v = fmaf(a.x, e.x, fmaf(a.y, e.y, fmaf(a.z, e.z, fmaf(a.w, e.w, v))));
      }
    } else {
      for (int i = tid; i < d.P * d.N; i += kDxThreads) v = fmaf(g_c[i], hc[i], v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < kDxThreads / 32; ++w) sum += red[w];
      gh_ws[bch] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // state term exp(cum_end - cum_k) (g_{c+1} B_k)[p]: the warp's 16 keys x 32 columns
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < (d.N + 15) >> 4; ++kk) {
    uint32_t a[KR][4];
#pragma unroll
    for (int k = 0; k < KR; ++k)
      ldmatrix_x4(a[k], smem_u32(b_s + k * TQ * PB + wk * PB + a_off<PB>(lane) + kk * 16));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int off = (wp + np * 16) * PB + b_off<PB>(lane) + kk * 16;
      uint32_t bf[KF][4];
#pragma unroll
      for (int k = 0; k < KF; ++k) ldmatrix_x4(bf[k], smem_u32(g_s + k * MAXP * PB + off));
      mma_parts<KR, KF>(acc[2 * np], acc[2 * np + 1], a, bf);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = wk + g + 8 * i;
    const float f = k < nk ? expf(cum[d.Q - 1] - cum[k0 + k]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j][2 * i] *= f;
      acc[j][2 * i + 1] *= f;
    }
  }

  // intra term (L o S)^T dY over the query tiles at or above this key tile
  for (int qi = ki; qi < d.nt; ++qi) {
    const int q0 = qi * TQ, nq = min(TQ, d.Q - q0), qrows = min(nq, d.S - t0 - q0);
    const float* sc = sc_ws + ((long)bc * d.np + qi * (qi + 1) / 2 + ki) * TQ * TQ;  // [k][q]
    __syncthreads();  // the previous products are done with shared memory
    stage_rows<T, TQ / 8>(y_s, TQ * PA, PA,
                          dy + ((long)b * d.S + t0 + q0) * xrow + (long)h * d.P, dy, xrow,
                          qrows, d.P, d.vec);
    cp_async_commit();
    constexpr int kPairs = TQ * TQ / 2 / kDxThreads;  // L o S at (k, q), (k, q + 1)
    float2 sv[kPairs];
#pragma unroll
    for (int it = 0; it < kPairs; ++it) {  // the loads first, all in flight
      const int i = tid + it * kDxThreads;
      sv[it] = *reinterpret_cast<const float2*>(sc + 2 * i);
    }
#pragma unroll
    for (int it = 0; it < kPairs; ++it) {
      const int i = tid + it * kDxThreads, k = i / (TQ / 2), q = (i % (TQ / 2)) * 2;
      const bool key = k < nk;
      const float v0 = key && q < nq && k0 + k <= q0 + q
                           ? sv[it].x * expf(cum[q0 + q] - cum[k0 + k]) : 0.f;
      const float v1 = key && q + 1 < nq && k0 + k <= q0 + q + 1
                           ? sv[it].y * expf(cum[q0 + q + 1] - cum[k0 + k]) : 0.f;
      uint32_t w[KF];
      split_pair<KF>(v0, v1, w);
#pragma unroll
      for (int j = 0; j < KF; ++j)
        *reinterpret_cast<uint32_t*>(w_s + j * TQ * PA + k * PA + q) = w[j];
    }
    cp_async_wait<0>();
    __syncthreads();
    // on the diagonal tile, keys k see queries q >= k only: the warp's
    // k-steps below its own rows are 0
    for (int kk = qi == ki ? wk / 16 : 0; kk < TQ / 16; ++kk) {
      uint32_t a[KF][4];
#pragma unroll
      for (int k = 0; k < KF; ++k)
        ldmatrix_x4(a[k], smem_u32(w_s + k * TQ * PA + wk * PA + a_off<PA>(lane) + kk * 16));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = kk * 16 * PA + bt_off<PA>(lane) + wp + np * 16;
        uint32_t bf[KR][4];
#pragma unroll
        for (int k = 0; k < KR; ++k) ldmatrix_x4_trans(bf[k], smem_u32(y_s + k * TQ * PA + off));
        mma_parts<KF, KR>(acc[2 * np], acc[2 * np + 1], a, bf);
      }
    }
  }

  // dx = dt dxdt; sum_p x dxdt, the x part of ddt. A thread holds columns
  // p, p + 1 of its rows: one 2-element access each where P is even
  const bool pairs = (d.P & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = wk + g + 8 * i;
    const bool valid = k < krows;
    const long trow = (long)b * d.S + t0 + k0 + k;
    const float dtk = valid ? dt[trow * d.H + h] : 0.f;
    float xs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = wp + 8 * j + 2 * cl;
      const long at = trow * xrow + (long)h * d.P + p;
      const float a0 = acc[j][2 * i], a1 = acc[j][2 * i + 1];
      if (valid && pairs && p < d.P) {
        const float2 xv = load2(x + at);
        store2(dx + at, dtk * a0, dtk * a1);
        xs = fmaf(xv.x, a0, xs);
        xs = fmaf(xv.y, a1, xs);
      } else if (valid) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (p + u < d.P) {
            xs = fmaf(repro::to_f32(x[at + u]), u ? a1 : a0, xs);
            dx[at + u] = repro::from_f32<T>(dtk * (u ? a1 : a0));
          }
      }
    }
    xs = quad_sum(xs);
    if (cl == 0) xsum[(warp >> 2) * TQ + k] = xs;
  }
  __syncthreads();
  if (tid < nk) xd_ws[bch * d.Q + k0 + tid] = xsum[tid] + xsum[TQ + tid];
}

// 7. dcum, d(dA) by a reverse cumsum, ddt and the chunk's part of dA, per
//    (row, chunk, head); thread tid takes step q = Q - 1 - tid, so that an
//    inclusive prefix sum over the threads is the suffix sum over the steps
__global__ void __launch_bounds__(NT) ssd_bwd_dt(
    const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ cum_ws,
    const float* __restrict__ rs_ws, const float* __restrict__ cs_ws,
    const float* __restrict__ car_ws, const float* __restrict__ u_ws,
    const float* __restrict__ xd_ws, const float* __restrict__ gh_ws, float* __restrict__ ddt,
    float* __restrict__ dap_ws, Dims d) {
  __shared__ float wsum[NT / 32];
  const int tid = threadIdx.x;
  const int h = blockIdx.x % d.H, bc = blockIdx.x / d.H, c = bc % d.nc, b = bc / d.nc;
  const long bch = (long)bc * d.H + h;
  const int q = d.Q - 1 - tid;
  float dcum = 0.f, u = 0.f;
  if (q >= 0) {
    const int qi = q / TQ, r = q % TQ;
    float rows = 0.f, cols = 0.f;
    for (int ki = 0; ki <= qi; ++ki)  // q as a query: its row over the key tiles
      rows += rs_ws[(((long)bc * d.np + qi * (qi + 1) / 2 + ki) * d.H + h) * TQ + r];
    for (int qj = qi; qj < d.nt; ++qj)  // q as a key: its column over the query tiles
      cols += cs_ws[(((long)bc * d.np + qj * (qj + 1) / 2 + qi) * d.H + h) * TQ + r];
    u = u_ws[bch * d.Q + q];
    dcum = rows - cols + car_ws[bch * d.Q + q] - u;
  }
  float sum_u, unused;
  block_scan(u, wsum, sum_u);
  const float suffix = block_scan(dcum, wsum, unused);
  // the terms of cum_end reach every step of the chunk
  const float end = sum_u + expf(cum_ws[bch * d.Q + d.Q - 1]) * gh_ws[bch];
  float part = 0.f;
  if (q >= 0 && c * d.Q + q < d.S) {
    const float dda = suffix + end;
    const long i = ((long)b * d.S + c * d.Q + q) * d.H + h;
    ddt[i] = fmaf(A[h], dda, xd_ws[bch * d.Q + q]);
    part = dt[i] * dda;
  }
  float total;
  block_scan(part, wsum, total);
  if (tid == 0) dap_ws[bch] = total;
}

// 8. dA[h] over the rows and chunks in order
__global__ void __launch_bounds__(NT) ssd_bwd_da(const float* __restrict__ dap_ws,
                                                 float* __restrict__ dA, Dims d) {
  const int h = blockIdx.x * NT + threadIdx.x;
  if (h >= d.H) return;
  float s = 0.f;
  for (long bc = 0; bc < (long)d.B * d.nc; ++bc) s += dap_ws[bc * d.H + h];
  dA[h] = s;
}

long ceil_div(long a, long b) { return (a + b - 1) / b; }

struct Ptrs {
  const void *x, *dt, *A, *Bm, *Cm, *dy, *dh_final, *sc, *st, *cum;
  void *dx, *ddt, *dA, *dB, *dC, *dh0, *ws;
};

// dynamic shared memory (bytes) of the kernels that take it, in launch order:
// dstate, scores, dbc_part, dbc_sum, dx
template <typename T>
void smem_bytes(int (&bytes)[5]) {
  bytes[0] = kDstateSmem * (int)sizeof(float);
  bytes[1] = ScoresSmem<T>::kBytes;
  bytes[2] = DbcSmem<T>::kBytes;
  bytes[3] = kDbcSumSmem * (int)sizeof(float);
  bytes[4] = DxSmem<T>::kBytes;
}

template <typename T>
cudaError_t launch(const Ptrs& a, const Dims& d, const long blocks[8], cudaStream_t stream) {
  static std::atomic<bool> dstate_set[repro::kMaxDevices], scores_set[repro::kMaxDevices],
      dbc_set[repro::kMaxDevices], dbc_sum_set[repro::kMaxDevices], dx_set[repro::kMaxDevices];
  int bytes[5];
  smem_bytes<T>(bytes);
  const int dstate_bytes = bytes[0], scores_bytes = bytes[1], dbc_bytes = bytes[2],
            dbc_sum_bytes = bytes[3], dx_bytes = bytes[4];
  cudaError_t e = repro::opt_in_smem(ssd_bwd_dstate<T>, dstate_bytes, dstate_set);
  if (e == cudaSuccess) e = repro::opt_in_smem(ssd_bwd_scores<T>, scores_bytes, scores_set);
  if (e == cudaSuccess) e = repro::opt_in_smem(ssd_bwd_dbc_part<T>, dbc_bytes, dbc_set);
  if (e == cudaSuccess) e = repro::opt_in_smem(ssd_bwd_dbc_sum<T>, dbc_sum_bytes, dbc_sum_set);
  if (e == cudaSuccess) e = repro::opt_in_smem(ssd_bwd_dx<T>, dx_bytes, dx_set);
  if (e != cudaSuccess) return e;

  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const T* dy = static_cast<const T*>(a.dy);
  const float* dt = static_cast<const float*>(a.dt);
  const float* A = static_cast<const float*>(a.A);
  const float* sc = static_cast<const float*>(a.sc);
  const float* st = static_cast<const float*>(a.st);
  const float* cum = static_cast<const float*>(a.cum);
  // the workspace, in the order of kernels/ssd_scan_bwd.py plan()
  const long bcs = (long)d.B * d.nc, bch = bcs * d.H;
  float* m = static_cast<float*>(a.ws);
  float* part = m + bcs * d.np * d.ng * TQ * TQ;
  float* gs = part + bcs * d.nt * 2 * d.ng * TQ * MAXN;
  float* rs = gs + bch * d.P * d.N;
  float* cs = rs + bch * d.np * TQ;
  float* car = cs + bch * d.np * TQ;
  float* u = car + bch * d.Q;
  float* xd = u + bch * d.Q;
  float* gh = xd + bch * d.Q;
  float* dap = gh + bch;

  ssd_bwd_dstate<T><<<(unsigned)blocks[0], NT, dstate_bytes, stream>>>(dy, Cm, cum, gs, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_pass<<<(unsigned)blocks[1], NT, 0, stream>>>(
      static_cast<const float*>(a.dh_final), cum, gs, static_cast<float*>(a.dh0), d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_scores<T><<<(unsigned)blocks[2], kScoresThreads, scores_bytes, stream>>>(
      x, dt, dy, cum, sc, m, rs, cs, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_dbc_part<T><<<(unsigned)blocks[3], kDbcThreads, dbc_bytes, stream>>>(
      x, dt, Bm, Cm, dy, cum, st, gs, part, car, u, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_dbc_sum<T><<<(unsigned)blocks[4], NT, dbc_sum_bytes, stream>>>(
      Bm, Cm, m, part, static_cast<T*>(a.dB), static_cast<T*>(a.dC), d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_dx<T><<<(unsigned)blocks[5], kDxThreads, dx_bytes, stream>>>(
      x, dt, Bm, dy, cum, sc, st, gs, static_cast<T*>(a.dx), xd, gh, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_dt<<<(unsigned)blocks[6], NT, 0, stream>>>(dt, A, cum, rs, cs, car, u, xd, gh,
                                                     static_cast<float*>(a.ddt), dap, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_da<<<(unsigned)blocks[7], NT, 0, stream>>>(dap, static_cast<float*>(a.dA), d);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING_FN(ssd_scan_bwd)

// The dynamic shared memory (bytes) of the five kernels that take it, in
// launch order (dstate, scores, dbc_part, dbc_sum, dx), for repro::kF32 or
// repro::kBF16 inputs, into bytes[5]; kernels/ssd_scan_bwd.py plan() gives the
// same numbers. Returns 0, or cudaErrorInvalidValue for another dtype.
extern "C" int ssd_scan_bwd_smem(int dtype, int* bytes) {
  int b[5];
  if (dtype == repro::kF32) smem_bytes<float>(b);
  else if (dtype == repro::kBF16) smem_bytes<__nv_bfloat16>(b);
  else return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) bytes[i] = b[i];
  return cudaSuccess;
}

// x, dy, dx (B,S,H,P) and Bm, Cm, dB, dC (B,S,N) of one dtype (repro::kF32 or
// repro::kBF16); dt, ddt (B,S,H), A, dA (H,), dh_final and dh0 (B,H,P,N) f32,
// either or both null (no gradient on the final state; no h0). sc_ws, st_ws
// and cum_ws are the forward's workspaces after its call (the C . B^T tiles,
// the entering states, cum; kernels/ssd_scan.py plan()); ws is this call's
// f32 workspace on a 16-byte boundary, kernels/ssd_scan_bwd.py plan()'s
// workspace_floats. All contiguous; Q is the chunk, at most S. Launches the
// eight kernels in order on `stream`; returns the first CUDA error, or 0.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, const void* dh_final,
                            const void* sc_ws, const void* st_ws, const void* cum_ws, void* dx,
                            void* ddt, void* dA, void* dB, void* dC, void* dh0, void* ws, int B,
                            int S, int H, int P, int N, int Q, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAXP || N <= 0 || N > MAXN || Q <= 0 ||
      Q > MAXQ || Q > S)
    return cudaErrorInvalidValue;
  auto on16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = P % 8 == 0 && N % 8 == 0 && on16(x) && on16(dy) && on16(Bm) && on16(Cm);
  Dims d{B, S, H, P, N, Q, (int)ceil_div(S, Q), (int)ceil_div(Q, TQ), 0, (int)ceil_div(H, HG),
         vec};
  d.np = d.nt * (d.nt + 1) / 2;
  const long bc = (long)B * d.nc;
  long blocks[8] = {bc * H, ceil_div((long)B * H * P * N, NT), bc * d.np * d.ng,
                    bc * d.nt * 2 * d.ng, bc * d.nt * 2, bc * H * d.nt, bc * H, ceil_div(H, NT)};
  for (long n : blocks)
    if (n > INT_MAX) return cudaErrorInvalidConfiguration;
  Ptrs a{x, dt, A, Bm, Cm, dy, dh_final, sc_ws, st_ws, cum_ws, dx, ddt, dA, dB, dC, dh0, ws};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return launch<float>(a, d, blocks, st);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(a, d, blocks, st);
  return cudaErrorInvalidValue;
}
