// Mamba-2 SSD scan (chunked state-space duality) for Hopper (sm_90a), bf16 or
// f32 x, B and C, f32 math.
//
// Replaces: src/repro/kernels/ssd_scan.py:66 ssd_scan_pallas (Pallas body
// _ssd_kernel at :20, pallas_call at :87).
//
// What it computes, per batch row b and head h, with one B/C group, chunks of
// Q steps and cum the inclusive prefix sum of dA = dt * A[h] over a chunk:
//   y[q]  = sum_{k<=q} exp(cum[q] - cum[k]) (C_q . B_k) dt_k x_k     (intra)
//         + exp(cum[q]) C_q . h                                      (carried)
//   h'    = exp(cum[Q-1]) h + sum_k exp(cum[Q-1] - cum[k]) dt_k x_k (x) B_k
// starting from h0 (or 0), and writes the final h (P x N, f32). Unlike the
// Pallas kernel it takes an h0 and an S that is not a multiple of the chunk:
// the steps past S read as dt = 0, x = B = C = 0, which leave h as it is,
// and their y rows are not written.
//
// Arithmetic. Every product and sum is an f32 FMA on the CUDA cores: inputs
// are upcast on load, cum, the decays and every sum stay f32, and y is
// rounded once to x's dtype at the store. That is the Pallas kernel's f32
// semantics. The port's plain version (kernels/ref.py ssd_scan) follows the
// JAX package's chunked path instead, which rounds its dot inputs to bf16
// for a bf16 x; chip_smoke.py bounds the difference in relative RMS.
//
// Design: the Mamba-2 paper's chunk state / state passing / chunk scan split,
// as four kernels that ssd_scan_fwd launches in order on the caller's stream.
// No kernel but the elementwise state pass walks the chunks of a row in
// order, and every output and workspace element has one writer and a fixed
// summation order, with no atomics: two calls give bitwise-equal y and h.
//   1. ssd_scan_state, one block per (row, chunk, head): cum by a block
//      prefix sum (one step per thread), written to an f32 workspace
//      (B, nc, H, Q); then the chunk's own state contribution
//      s_c = sum_k exp(cum_end - cum_k) dt_k x_k (x) B_k, a P x N product
//      over the chunk's key tiles from shared memory, each thread 4 x 8 of
//      it, written to an f32 workspace (B, nc, H, P, N).
//   2. ssd_scan_scores, one block per (row, chunk, 64 x 64 tile at or below
//      the diagonal): C . B^T once per (row, chunk), for every head, into an
//      f32 workspace of tiles stored key-major (B, nc, tile pairs, 64, 64).
//   3. ssd_scan_pass, one thread per (row, head, p, n): h <- exp(cum_end) h
//      + s_c over the chunks from h0 or 0, the Pallas kernel's state update
//      (ssd_scan.py:56-59) in the same order; it overwrites each s_c in place
//      with the state entering chunk c and writes the final h.
//   4. ssd_scan_out, one block per (row, chunk, head, 64-row query tile),
//      a head's query tiles issued together (they share its entering state
//      and x in the L2), the heaviest first: the carried term
//      exp(cum_q) C_q . h_enter, then for each key tile at or below the
//      query tile the stored scores weighted by exp(cum_q - cum_k) under the
//      k <= q mask, times the dt-weighted x tile; on the diagonal tile a
//      thread stops at its last row's key.
// Every product runs from shared memory, each thread on a 4 x 4 (4 x 8 in
// the state products) register tile fed by 16-byte loads that hit distinct
// banks or broadcast. Tiles that are read down their columns (C and B in the
// scores, C and h in the carried term) are staged transposed at a pitch of
// 68 floats: a warp stores 8 columns of 4 rows, 32 distinct banks. Shared
// memory is 52 / 70 / 72 KB a block in kernels 1 / 2 / 4, so three or more
// blocks fit an SM.
//
// What bounds it on the H100. At mamba2-1.3b's prefill (B 4, S 2048, H 64,
// P 64, N 128, chunk 256, bf16) the function must move x and y (2 x 67 MB),
// dt, B, C and the final state (2 + 2 x 2 + 8.4 MB): 149 MB, 44 us at 3.35
// TB/s. Its arithmetic, the chunked form's products over lower triangles
// only, is 26 GFLOP, 26 us at the 989 TFLOP/s bf16 tensor-core peak, so
// bytes set the card's floor. On the CUDA cores the same products take at
// least 0.39 ms at the 67 TFLOP/s f32 FMA peak: that, not the bytes, bounds
// this design. Per call it executes about 26 GFLOP of FMAs (C . B^T 0.34,
// the chunk states 8.6, the carried term 8.6, the intra term 8.9 with the
// diagonal tiles' upper halves mostly skipped) on 2048 + 320 + 8192 + 8192
// blocks, and its 67 MB f32 state workspace crosses the L2 about seven
// times (written, read and rewritten by the pass, read by each of the four
// query tiles). The tensor cores are the next step, on this layout.

#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int NT = 256;    // threads a block: 16 x 16
constexpr int TQ = 64;     // rows of a query tile and of a key tile
constexpr int MAXQ = NT;   // chunk bound: one prefix-sum step per thread
constexpr int MAXP = 64;   // head dim bound (4 columns per thread)
constexpr int MAXN = 128;  // state dim bound (8 columns per thread in the state products)
constexpr int PT = TQ + 4; // pitch of a transposed tile: 16-byte rows, conflict-free stores
constexpr int kPassUnroll = 8;  // chunks whose loads the state pass issues together

// shared floats of each kernel
constexpr int kStateSmem = TQ * MAXP + TQ * MAXN + 3 * MAXQ + NT / 32;
constexpr int kScoresSmem = 2 * MAXN * PT;
constexpr int kOutSmem = 2 * MAXN * PT + 2 * MAXQ;
static_assert(2 * TQ * TQ <= MAXN * PT, "the intra term's tiles reuse the carried term's");

struct Dims {
  int B, S, H, P, N, Q;
  int nc;  // chunks of a row
  int nt;  // TQ-row tiles of a chunk
  int np;  // tile pairs (query tile, key tile at or below it) of a chunk
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += a[i] b[j]
__device__ __forceinline__ void fma44(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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

// 1. cum and the chunk's own state contribution s_c, per (row, chunk, head)
template <typename T>
__global__ void __launch_bounds__(NT, 3) ssd_scan_state(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, float* __restrict__ cum_ws, float* __restrict__ st_ws, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;             // [TQ][MAXP] dt- and decay-weighted x of a key tile
  float* Bs = Xs + TQ * MAXP;   // [TQ][MAXN] B of the key tile
  float* cum = Bs + TQ * MAXN;  // [MAXQ]
  float* dts = cum + MAXQ;      // [MAXQ]
  float* dec = dts + MAXQ;      // [MAXQ] exp(cum_end - cum[k])
  float* wsum = dec + MAXQ;     // [NT / 32]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % d.H, bc = blockIdx.x / d.H, c = bc % d.nc, b = bc / d.nc;
  const long bch = (long)bc * d.H + h;
  const int t0 = c * d.Q;
  const long xrow = (long)d.H * d.P;  // stride of one step in x

  // dt of the chunk and the inclusive prefix sum of dA = dt * A[h]
  const float dv = (tid < d.Q && t0 + tid < d.S) ? dt[((long)b * d.S + t0 + tid) * d.H + h] : 0.f;
  float v = dv * A[h];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  if (tid < d.Q) {
    cum[tid] = v;
    dts[tid] = dv;
    cum_ws[bch * d.Q + tid] = v;
  }
  __syncthreads();
  if (tid < d.Q) dec[tid] = expf(cum[d.Q - 1] - cum[tid]);

  // s_c[p][n] = sum_k (x_k[p] dt_k dec_k) B_k[n]; this thread: p = 4 ty + i,
  // n = 4 tx + 64 j + l
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d.Q; k0 += TQ) {
    const int nk = min(TQ, d.Q - k0);
    const int rows = min(nk, d.S - t0 - k0);  // rows of the tile inside S
    __syncthreads();  // dec is written; the previous key tile is read
    {  // Xs: column p = tid % 64 of rows tid / 64 + 4 i
      const int p = tid & (MAXP - 1);
      const T* src = x + ((long)b * d.S + t0 + k0) * xrow + (long)h * d.P + p;
      for (int r = tid / MAXP; r < TQ; r += NT / MAXP)
        Xs[r * MAXP + p] = (r < rows && p < d.P)
                               ? repro::to_f32(src[r * xrow]) * dts[k0 + r] * dec[k0 + r] : 0.f;
    }
    {  // Bs: column n = tid % 128 of rows tid / 128 + 2 i
      const int n = tid & (MAXN - 1);
      const T* src = Bm + ((long)b * d.S + t0 + k0) * d.N + n;
      for (int r = tid / MAXN; r < TQ; r += NT / MAXN)
        Bs[r * MAXN + n] = (r < rows && n < d.N) ? repro::to_f32(src[(long)r * d.N]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      const float4 xv = ld4(Xs + k * MAXP + ty * 4);
      const float4 b0 = ld4(Bs + k * MAXN + tx * 4), b1 = ld4(Bs + k * MAXN + 64 + tx * 4);
      const float av[4] = {xv.x, xv.y, xv.z, xv.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = st_ws + bch * d.P * d.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty * 4 + i;
    if (p >= d.P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx * 4 + 64 * (j >> 2) + (j & 3);
      if (n < d.N) out[(long)p * d.N + n] = acc[i][j];
    }
  }
}

// 2. C . B^T once per (row, chunk), one 64 x 64 tile at or below the diagonal
template <typename T>
__global__ void __launch_bounds__(NT, 3) ssd_scan_scores(
    const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ sc_ws, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;            // [MAXN][PT] C of the query tile, transposed
  float* Bt = Ct + MAXN * PT;  // [MAXN][PT] B of the key tile, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int pair = blockIdx.x % d.np, bc = blockIdx.x / d.np;
  const int c = bc % d.nc, b = bc / d.nc;
  int qi = 0;  // pair = qi (qi + 1) / 2 + ki with ki <= qi
  while ((qi + 1) * (qi + 2) / 2 <= pair) ++qi;
  const int ki = pair - qi * (qi + 1) / 2;
  const int t0 = c * d.Q, n8 = (d.N + 7) & ~7;
  auto rows_of = [&](const T* src, int r0) {
    return [=](int r, int n) {
      const int t = t0 + r0 + r;
      return (r0 + r < d.Q && t < d.S && n < d.N)
                 ? repro::to_f32(src[((long)b * d.S + t) * d.N + n]) : 0.f;
    };
  };
  stage_t(Ct, n8, rows_of(Cm, qi * TQ));
  stage_t(Bt, n8, rows_of(Bm, ki * TQ));
  __syncthreads();

  // acc[i][j] = C_q . B_k with q = 4 ty + i, k = 4 tx + j of the tiles
  float acc[4][4] = {};
  for (int n = 0; n < d.N; ++n) fma44(acc, ld4(Ct + n * PT + ty * 4), ld4(Bt + n * PT + tx * 4));
  float* out = sc_ws + ((long)bc * d.np + pair) * TQ * TQ;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(out + (tx * 4 + j) * TQ + ty * 4) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
}

// 3. the state pass over the chunks, one thread per (row, head, p, n)
__global__ void __launch_bounds__(NT) ssd_scan_pass(
    const float* __restrict__ h0, const float* __restrict__ cum_ws, float* __restrict__ st_ws,
    float* __restrict__ hout, Dims d) {
  const long pn_count = (long)d.P * d.N;
  const long e = (long)blockIdx.x * NT + threadIdx.x;
  if (e >= (long)d.B * d.H * pn_count) return;
  const long bh = e / pn_count, pn = e - bh * pn_count;
  const int h = (int)(bh % d.H), b = (int)(bh / d.H);
  const long step = (long)d.H * pn_count;  // from one chunk's slot to the next
  float* slot = st_ws + ((long)b * d.nc * d.H + h) * pn_count + pn;
  const float* cum_end = cum_ws + ((long)b * d.nc * d.H + h) * d.Q + d.Q - 1;
  float s = h0 != nullptr ? h0[e] : 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += kPassUnroll) {
    // the loads of kPassUnroll chunks first, so that they are in flight together
    float contrib[kPassUnroll], ce[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u < d.nc) {
        contrib[u] = slot[(c0 + u) * step];
        ce[u] = cum_end[(long)(c0 + u) * d.H * d.Q];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u < d.nc) {
        slot[(c0 + u) * step] = s;  // the state entering the chunk
        s = fmaf(expf(ce[u]), s, contrib[u]);
      }
    }
  }
  hout[e] = s;
}

// 4. y per (row, chunk, head, query tile)
template <typename T>
__global__ void __launch_bounds__(NT, 3) ssd_scan_out(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Cm,
    const float* __restrict__ cum_ws, const float* __restrict__ st_ws,
    const float* __restrict__ sc_ws, T* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;              // [MAXN][PT] C of the query tile, transposed
  float* Ht = Ct + MAXN * PT;    // [MAXN][PT] the entering state, transposed: [n][p]
  float* Wt = smem;              // [TQ][TQ] weighted scores, key-major (over Ct and Ht)
  float* Xs = Wt + TQ * TQ;      // [TQ][TQ] dt-weighted x of the key tile, [k][p]
  float* cum = Ht + MAXN * PT;   // [MAXQ]
  float* dts = cum + MAXQ;       // [MAXQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qi = d.nt - 1 - blockIdx.x % d.nt;  // the heaviest query tile of a head first
  const int rest = blockIdx.x / d.nt;
  const int h = rest % d.H, bc = rest / d.H, c = bc % d.nc, b = bc / d.nc;
  const long bch = (long)bc * d.H + h;
  const int t0 = c * d.Q, q0 = qi * TQ, nq = min(TQ, d.Q - q0), n8 = (d.N + 7) & ~7;
  const long xrow = (long)d.H * d.P;

  for (int i = tid; i < q0 + nq; i += NT) {
    cum[i] = cum_ws[bch * d.Q + i];
    dts[i] = t0 + i < d.S ? dt[((long)b * d.S + t0 + i) * d.H + h] : 0.f;
  }
  stage_t(Ct, n8, [&](int r, int n) {
    const int t = t0 + q0 + r;
    return (r < nq && t < d.S && n < d.N) ? repro::to_f32(Cm[((long)b * d.S + t) * d.N + n])
                                          : 0.f;
  });
  const float* h_in = st_ws + bch * d.P * d.N;
  stage_t(Ht, n8, [&](int p, int n) {
    return (p < d.P && n < d.N) ? h_in[(long)p * d.N + n] : 0.f;
  });
  __syncthreads();

  // carried term: exp(cum[q]) C_q . h[p]; this thread: q = 4 ty + i, p = 4 tx + j
  float acc[4][4] = {};
  for (int n = 0; n < d.N; ++n) fma44(acc, ld4(Ct + n * PT + ty * 4), ld4(Ht + n * PT + tx * 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float f = r < nq ? expf(cum[q0 + r]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= f;
  }

  // intra-chunk term over the key tiles at or below this query tile
  const float* sc = sc_ws + ((long)bc * d.np + qi * (qi + 1) / 2) * TQ * TQ;
  for (int ki = 0; ki <= qi; ++ki, sc += TQ * TQ) {
    const int k0 = ki * TQ, nk = min(TQ, d.Q - k0);
    const int rows = min(nk, d.S - t0 - k0);  // key rows inside S
    __syncthreads();  // the previous products are done with Ct and Ht, or Wt and Xs
    {  // Wt[k][q], column q = tid % 64 of key rows tid / 64 + 4 i, k <= q
      const int qq = tid & (TQ - 1), kmax = min(nk - 1, q0 + qq - k0);
      const float cq = qq < nq ? cum[q0 + qq] : 0.f;
      for (int kk = tid / TQ; kk < TQ; kk += NT / TQ)
        Wt[kk * TQ + qq] =
            (qq < nq && kk <= kmax) ? sc[kk * TQ + qq] * expf(cq - cum[k0 + kk]) : 0.f;
    }
    {  // Xs[k][p], column p = tid % 64 of key rows tid / 64 + 4 i
      const int p = tid & (TQ - 1);
      const T* src = x + ((long)b * d.S + t0 + k0) * xrow + (long)h * d.P + p;
      for (int kk = tid / TQ; kk < TQ; kk += NT / TQ)
        Xs[kk * TQ + p] =
            (kk < rows && p < d.P) ? repro::to_f32(src[kk * xrow]) * dts[k0 + kk] : 0.f;
    }
    __syncthreads();
    const int kend = ki == qi ? min(nk, ty * 4 + 4) : nk;  // past it, this thread's rows see 0
    for (int kk = 0; kk < kend; ++kk)
      fma44(acc, ld4(Wt + kk * TQ + ty * 4), ld4(Xs + kk * TQ + tx * 4));
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, t = t0 + q0 + r;
    if (r >= nq || t >= d.S) continue;
    T* yrow = y + ((long)b * d.S + t) * xrow + (long)h * d.P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx * 4 + j;
      if (p < d.P) yrow[p] = repro::from_f32<T>(acc[i][j]);
    }
  }
}

long ceil_div(long a, long b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* h0, void* y, float* hout, float* sc_ws,
                   float* st_ws, float* cum_ws, const Dims& d, long blocks[4],
                   cudaStream_t stream) {
  static std::atomic<bool> state_set[repro::kMaxDevices], scores_set[repro::kMaxDevices],
      out_set[repro::kMaxDevices];
  const int state_bytes = kStateSmem * (int)sizeof(float);
  const int scores_bytes = kScoresSmem * (int)sizeof(float);
  const int out_bytes = kOutSmem * (int)sizeof(float);
  cudaError_t e = repro::opt_in_smem(ssd_scan_state<T>, state_bytes, state_set);
  if (e == cudaSuccess) e = repro::opt_in_smem(ssd_scan_scores<T>, scores_bytes, scores_set);
  if (e == cudaSuccess) e = repro::opt_in_smem(ssd_scan_out<T>, out_bytes, out_set);
  if (e != cudaSuccess) return e;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  ssd_scan_state<T><<<(unsigned)blocks[0], NT, state_bytes, stream>>>(xt, dt, A, Bt, cum_ws,
                                                                      st_ws, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_scan_scores<T><<<(unsigned)blocks[1], NT, scores_bytes, stream>>>(Bt, Ct, sc_ws, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_scan_pass<<<(unsigned)blocks[2], NT, 0, stream>>>(h0, cum_ws, st_ws, hout, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_scan_out<T><<<(unsigned)blocks[3], NT, out_bytes, stream>>>(
      xt, dt, Ct, cum_ws, st_ws, sc_ws, static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING_FN(ssd_scan)

// x (B,S,H,P), Bm and Cm (B,S,N), y (B,S,H,P) of one dtype (repro::kF32 or
// repro::kBF16); dt (B,S,H), A (H,), h0 (B,H,P,N) or null, hout (B,H,P,N) f32.
// All contiguous; Q is the chunk length, at most S. The f32 workspaces, in
// the layouts of kernels/ssd_scan.py plan(): sc_ws (B, nc, np, 64, 64) on a
// 16-byte boundary, st_ws (B, nc, H, P, N), cum_ws (B, nc, H, Q), with nc =
// ceil(S / Q), nt = ceil(Q / 64), np = nt (nt + 1) / 2. Launches the four
// kernels in order on `stream`; returns the first CUDA error, or 0.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* hout, void* sc_ws,
                            void* st_ws, void* cum_ws, int B, int S, int H, int P, int N,
                            int Q, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAXP || N <= 0 || N > MAXN || Q <= 0 ||
      Q > MAXQ || Q > S)
    return cudaErrorInvalidValue;
  Dims d{B, S, H, P, N, Q, (int)ceil_div(S, Q), (int)ceil_div(Q, TQ), 0};
  d.np = d.nt * (d.nt + 1) / 2;
  long blocks[4] = {(long)B * d.nc * H, (long)B * d.nc * d.np,
                    ceil_div((long)B * H * P * N, NT), (long)B * d.nc * H * d.nt};
  for (long n : blocks)
    if (n > INT_MAX) return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(hout);
  float* sc = static_cast<float*>(sc_ws);
  float* stw = static_cast<float*>(st_ws);
  float* cw = static_cast<float*>(cum_ws);
  if (dtype == repro::kF32)
    return launch<float>(x, dtf, Af, Bm, Cm, h0f, y, ho, sc, stw, cw, d, blocks, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, h0f, y, ho, sc, stw, cw, d, blocks, st);
  return cudaErrorInvalidValue;
}
