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
//      below the diagonal, head group), its heads in order: G = dY . XDT^T
//      over P, then L o G summed over the group into its part of M, and the
//      row and column sums of L o S o G per head (the forward's C . B^T tile
//      as S).
//   4. ssd_bwd_dbc_part, one block per (row, chunk, 64-row tile, dC or dB, head
//      group), its heads in order: exp(cum_q) dY^T h_c (dC) or
//      exp(cum_end - cum_k) XDT^T g_{c+1} (dB), each head's 64 x N product
//      summed into the group's part and dotted with the rows' own C or B for
//      the carried and state terms of dcum.
//   5. ssd_bwd_dbc_sum, one block per (row, chunk, 64-row tile, dC or dB):
//      the groups' parts in order, plus M (dC) or M^T (dB), M the groups'
//      parts in order, times the B or C tiles; writes dC or dB.
//   6. ssd_bwd_dx, one block per (row, chunk, head, 64-row key tile): the
//      state term exp(cum_end - cum_k) g_{c+1} B_k, then (L o S)^T dY over
//      the query tiles at or above it; writes dx and sum_p x dxdt. The first
//      key tile's block also takes <g_{c+1}, h_c>.
//   7. ssd_bwd_dt, one block per (row, chunk, head), a thread per step:
//      dcum from the partial sums in order, the reverse cumsum d(dA) by a
//      block scan, ddt, and the chunk's part of dA.
//   8. ssd_bwd_da, one thread per head: dA over the rows and chunks in order.
// Products run from shared memory on 4 x 4 or 4 x 8 register tiles fed by
// 16-byte loads, as in the forward; tiles read down their columns are staged
// transposed at a pitch of 68 floats. The two head-sum kernels run three
// blocks an SM (80 registers, some spilled in ssd_bwd_dbc_part, which reads
// the rows' own C or B through the L1 to stay under 50 KB of shared memory):
// at two blocks an SM, without spills, both took longer on the H100.
//
// What bounds it on the H100. At the train shape the function must move x,
// dy and dx (3 x 67 MB bf16), dt and ddt (2 x 2.1 MB), B, C, dB and dC (4 x
// 2.1 MB): 214 MB, 64 us at 3.35 TB/s. Its arithmetic, the chunked form's
// products over lower triangles only, is 52 GFLOP (four P x N-by-chunk
// products per (row, chunk, head), 8.6 GFLOP each: the chunk state gradient,
// g B, dY^T h_c, XDT^T g; G and (L o S)^T dY, 8.6 each; M B and M^T C, 0.5),
// 53 us at the 989 TFLOP/s bf16 tensor-core peak, so bytes set the card's
// floor. On the CUDA cores the same products take at least 0.78 ms at the
// 67 TFLOP/s f32 FMA peak, twice the forward's 0.39: that bounds this design.
// The tensor cores are later work, on this layout.

#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int NT = 256;    // threads a block: 16 x 16
constexpr int TQ = 64;     // rows of a query tile and of a key tile
constexpr int MAXQ = NT;   // chunk bound: one step per thread in ssd_bwd_dt
constexpr int MAXP = 64;   // head dim bound (4 columns per thread)
constexpr int MAXN = 128;  // state dim bound (8 columns per thread in the P x N products)
constexpr int PT = TQ + 4; // pitch of a transposed tile: 16-byte rows, conflict-free stores
constexpr int kPassUnroll = 8;  // chunks whose loads the state pass issues together
constexpr int HG = 8;      // heads a block of ssd_bwd_scores and ssd_bwd_dbc_part sums
constexpr unsigned kFull = 0xffffffffu;

// shared floats of each kernel
constexpr int kDstateSmem = TQ * MAXP + TQ * MAXN + MAXQ;
constexpr int kScoresSmem = 2 * MAXP * PT + 2 * TQ + 16 * TQ;
constexpr int kDbcSmem = MAXP * PT + MAXP * MAXN + TQ;
constexpr int kDbcSumSmem = TQ * PT + TQ * MAXN;
constexpr int kDxSmem = 2 * MAXN * PT + MAXQ + NT / 32;
static_assert(TQ * PT + TQ * TQ <= MAXN * PT + MAXN * PT, "dx: the intra tiles reuse Bt and Gt");

struct Dims {
  int B, S, H, P, N, Q;
  int nc;  // chunks of a row
  int nt;  // TQ-row tiles of a chunk
  int np;  // tile pairs (query tile, key tile at or below it) of a chunk
  int ng;  // groups of HG heads
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

// the sum over the 16 lanes of a half warp (the threads that share ty), the
// same butterfly on every call
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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

// 3. G = dY . XDT^T per head over a tile pair; the group's part of
//    M = sum_h L o G, and the row and column sums of L o S o G per head
template <typename T>
__global__ void __launch_bounds__(NT, 3) ssd_bwd_scores(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ dy,
    const float* __restrict__ cum_ws, const float* __restrict__ sc_ws,
    float* __restrict__ m_ws, float* __restrict__ rs_ws, float* __restrict__ cs_ws, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Yt = smem;            // [MAXP][PT] dy of the query tile, transposed: [p][q]
  float* Xt = Yt + MAXP * PT;  // [MAXP][PT] dt-weighted x of the key tile, transposed: [p][k]
  float* cq = Xt + MAXP * PT;  // [TQ] cum of the query rows
  float* ck = cq + TQ;         // [TQ] cum of the key rows
  float* part = ck + TQ;       // [16][TQ] column sums of each ty's 4 rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = blockIdx.x % d.ng, rest = blockIdx.x / d.ng;
  const int pair = rest % d.np, bc = rest / d.np;
  const int c = bc % d.nc, b = bc / d.nc;
  const int h_end = min(d.H, (grp + 1) * HG);
  int qi = 0;  // pair = qi (qi + 1) / 2 + ki with ki <= qi
  while ((qi + 1) * (qi + 2) / 2 <= pair) ++qi;
  const int ki = pair - qi * (qi + 1) / 2;
  const int t0 = c * d.Q, q0 = qi * TQ, k0 = ki * TQ;
  const int nq = min(TQ, d.Q - q0), nk = min(TQ, d.Q - k0);
  const int qrows = min(nq, d.S - t0 - q0), krows = min(nk, d.S - t0 - k0);
  const int p8 = (d.P + 7) & ~7;
  const long xrow = (long)d.H * d.P;
  const long tile = ((long)bc * d.np + pair) * TQ * TQ;

  // S of this tile pair, key-major in the forward's workspace; this thread:
  // q = 4 ty + i, k = 4 tx + j
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = ld4(sc_ws + tile + (tx * 4 + j) * TQ + ty * 4);
    s[0][j] = v.x, s[1][j] = v.y, s[2][j] = v.z, s[3][j] = v.w;
  }
  auto column_sums = [&](int hh) {  // part holds head hh's column partials
    if (tid < TQ) {
      float v = 0.f;
      for (int r = 0; r < 16; ++r) v += part[r * TQ + tid];
      cs_ws[(((long)bc * d.np + pair) * d.H + hh) * TQ + tid] = v;
    }
  };
  float macc[4][4] = {};
  for (int h = grp * HG; h < h_end; ++h) {
    const long bch = (long)bc * d.H + h;
    __syncthreads();  // the previous head's tiles are read and its column partials written
    if (h > grp * HG) column_sums(h - 1);  // read before the next sync, written after it
    stage_t(Yt, p8, [&](int r, int p) {
      return (r < qrows && p < d.P)
                 ? repro::to_f32(dy[((long)b * d.S + t0 + q0 + r) * xrow + (long)h * d.P + p])
                 : 0.f;
    });
    stage_t(Xt, p8, [&](int r, int p) {
      const long t = (long)b * d.S + t0 + k0 + r;
      return (r < krows && p < d.P)
                 ? repro::to_f32(x[t * xrow + (long)h * d.P + p]) * dt[t * d.H + h] : 0.f;
    });
    if (tid < TQ) cq[tid] = tid < nq ? cum_ws[bch * d.Q + q0 + tid] : 0.f;
    else if (tid < 2 * TQ) ck[tid - TQ] = tid - TQ < nk ? cum_ws[bch * d.Q + k0 + tid - TQ] : 0.f;
    __syncthreads();

    float g[4][4] = {};
    for (int p = 0; p < d.P; ++p) fma44(g, ld4(Yt + p * PT + ty * 4), ld4(Xt + p * PT + tx * 4));
    float rsum[4] = {}, csum[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tx * 4 + j;
        const float w = (q < nq && k < nk && k0 + k <= q0 + q) ? g[i][j] * expf(cq[q] - ck[k])
                                                               : 0.f;
        macc[i][j] += w;
        const float tt = w * s[i][j];
        rsum[i] += tt;
        csum[j] += tt;
      }
    }
    float* rs = rs_ws + (((long)bc * d.np + pair) * d.H + h) * TQ;
#pragma unroll
    for (int i = 0; i < 4; ++i) rsum[i] = half_warp_sum(rsum[i]);
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) rs[ty * 4 + i] = rsum[i];
    *reinterpret_cast<float4*>(part + ty * TQ + tx * 4) =
        make_float4(csum[0], csum[1], csum[2], csum[3]);
  }
  __syncthreads();
  column_sums(h_end - 1);
  float* out = m_ws + (((long)bc * d.np + pair) * d.ng + grp) * TQ * TQ;  // key-major, as S
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(out + (tx * 4 + j) * TQ + ty * 4) =
        make_float4(macc[0][j], macc[1][j], macc[2][j], macc[3][j]);
}

// 4. a group's part of dC (role 0, query rows) or dB (role 1, key rows) of
//    one 64-row tile, its heads in order, into an f32 workspace; and each
//    head's carried (dC) or state (dB) term of dcum
template <typename T>
__global__ void __launch_bounds__(NT, 3) ssd_bwd_dbc_part(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dy, const float* __restrict__ cum_ws,
    const float* __restrict__ st_ws, const float* __restrict__ gs,
    float* __restrict__ part_ws, float* __restrict__ car_ws, float* __restrict__ u_ws, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* At = smem;              // [MAXP][PT] a head's weighted dy or xdt rows, transposed: [p][r]
  float* Hs = At + MAXP * PT;    // [MAXP][MAXN] the head's h_c (dC) or g_{c+1} (dB)
  float* w = Hs + MAXP * MAXN;   // [TQ] the rows' weights

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = blockIdx.x % d.ng, tile = blockIdx.x / d.ng;  // tile: (row, chunk, t, role)
  const int role = tile & 1, rest = tile >> 1;
  const int t = rest % d.nt, bc = rest / d.nt, c = bc % d.nc, b = bc / d.nc;
  const int h_end = min(d.H, (grp + 1) * HG);
  const int t0 = c * d.Q, r0 = t * TQ, nr = min(TQ, d.Q - r0);
  const int rows = min(nr, d.S - t0 - r0);  // rows of the tile inside S
  const int p8 = (d.P + 7) & ~7;
  const long xrow = (long)d.H * d.P;
  const T* own = (role == 0 ? Cm : Bm) + ((long)b * d.S + t0 + r0) * d.N;  // the tile's rows

  // this thread: rows r = 4 ty + i, columns n = 4 tx + 64 j + l
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int h = grp * HG; h < h_end; ++h) {
    const long bch = (long)bc * d.H + h;
    const float* cum = cum_ws + bch * d.Q;
    __syncthreads();  // the previous head's tiles are read
    if (tid < TQ) {  // dC: exp(cum_q); dB: exp(cum_end - cum_k) dt_k
      float wv = 0.f;
      if (tid < rows) {
        if (role == 0) wv = expf(cum[r0 + tid]);
        else wv = expf(cum[d.Q - 1] - cum[r0 + tid]) *
                  dt[((long)b * d.S + t0 + r0 + tid) * d.H + h];
      }
      w[tid] = wv;
    }
    const float* hsrc = (role == 0 ? st_ws : gs) + bch * d.P * d.N;
    for (int i = tid; i < d.P * MAXN; i += NT) {
      const int p = i / MAXN, n = i % MAXN;
      Hs[i] = n < d.N ? hsrc[(long)p * d.N + n] : 0.f;
    }
    __syncthreads();  // w is written
    const T* asrc = (role == 0 ? dy : x) + ((long)b * d.S + t0 + r0) * xrow + (long)h * d.P;
    stage_t(At, p8, [&](int r, int p) {
      return (r < rows && p < d.P) ? repro::to_f32(asrc[r * xrow + p]) * w[r] : 0.f;
    });
    __syncthreads();

    float ah[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ah[i][j] = 0.f;
    for (int p = 0; p < d.P; ++p) fma48(ah, ld4(At + p * PT + ty * 4), Hs + p * MAXN, tx);
    // this head's carried (dC) or state (dB) term of dcum: the row dotted with
    // its own C or B, read from the L1 (the same 64 rows for every head)
    float dot[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = col8(tx, j);
        if (r < rows && n < d.N) v = fmaf(ah[i][j], repro::to_f32(own[(long)r * d.N + n]), v);
        acc[i][j] += ah[i][j];
      }
      dot[i] = half_warp_sum(v);
    }
    if (tx == 0) {
      float* dst = (role == 0 ? car_ws : u_ws) + bch * d.Q + r0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ty * 4 + i < nr) dst[ty * 4 + i] = dot[i];
    }
  }

  float* out = part_ws + ((long)tile * d.ng + grp) * TQ * MAXN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* orow = out + (ty * 4 + i) * MAXN + tx * 4;
    *reinterpret_cast<float4*>(orow) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(orow + 64) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
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

// 6. dxdt of one key tile per (row, chunk, head): dx and sum_p x dxdt
template <typename T>
__global__ void __launch_bounds__(NT, 3) ssd_bwd_dx(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ dy, const float* __restrict__ cum_ws, const float* __restrict__ sc_ws,
    const float* __restrict__ st_ws, const float* __restrict__ gs, T* __restrict__ dx,
    float* __restrict__ xd_ws, float* __restrict__ gh_ws, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Bt = smem;              // [MAXN][PT] B of the key tile, transposed: [n][k]
  float* Gt = Bt + MAXN * PT;    // [MAXN][PT] g_{c+1} of the head, transposed: [n][p]
  float* Ws = smem;              // [TQ][PT] decay-weighted S of a tile pair, [q][k] (over Bt)
  float* Ys = Ws + TQ * PT;      // [TQ][TQ] dy of the query tile, [q][p] (over Bt)
  float* cum = Gt + MAXN * PT;   // [MAXQ]
  float* red = cum + MAXQ;       // [NT / 32] warp sums

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ki = blockIdx.x % d.nt, rest = blockIdx.x / d.nt;
  const int h = rest % d.H, bc = rest / d.H, c = bc % d.nc, b = bc / d.nc;
  const long bch = (long)bc * d.H + h;
  const int t0 = c * d.Q, k0 = ki * TQ, nk = min(TQ, d.Q - k0);
  const int krows = min(nk, d.S - t0 - k0);  // key rows inside S
  const int n8 = (d.N + 7) & ~7;
  const long xrow = (long)d.H * d.P;

  for (int i = tid; i < d.Q; i += NT) cum[i] = cum_ws[bch * d.Q + i];
  stage_t(Bt, n8, [&](int r, int n) {
    return (r < krows && n < d.N) ? repro::to_f32(Bm[((long)b * d.S + t0 + k0 + r) * d.N + n])
                                  : 0.f;
  });
  const float* g = gs + bch * d.P * d.N;
  stage_t(Gt, n8, [&](int p, int n) {
    return (p < d.P && n < d.N) ? g[(long)p * d.N + n] : 0.f;
  });
  __syncthreads();
  if (ki == 0) {  // <g_{c+1}, h_c>, once per (row, chunk, head)
    const float* hc = st_ws + bch * d.P * d.N;
    float v = 0.f;
    for (int i = tid; i < d.P * d.N; i += NT) v = fmaf(Gt[(i % d.N) * PT + i / d.N], hc[i], v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if ((tid & 31) == 0) red[tid >> 5] = v;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int wi = 0; wi < NT / 32; ++wi) s += red[wi];
      gh_ws[bch] = s;
    }
  }

  // state term exp(cum_end - cum_k) (g_{c+1} B_k)[p]; this thread: k = 4 ty + i, p = 4 tx + j
  float acc[4][4] = {};
  for (int n = 0; n < d.N; ++n) fma44(acc, ld4(Bt + n * PT + ty * 4), ld4(Gt + n * PT + tx * 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = ty * 4 + i;
    const float f = k < nk ? expf(cum[d.Q - 1] - cum[k0 + k]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= f;
  }

  // intra term (L o S)^T dY over the query tiles at or above this key tile
  for (int qi = ki; qi < d.nt; ++qi) {
    const int q0 = qi * TQ, nq = min(TQ, d.Q - q0), qrows = min(nq, d.S - t0 - q0);
    const float* sc = sc_ws + ((long)bc * d.np + qi * (qi + 1) / 2 + ki) * TQ * TQ;  // [k][q]
    __syncthreads();  // the previous products are done with Bt and Gt, or Ws and Ys
    stage_t(Ws, TQ, [&](int k, int q) {
      return (k < nk && q < nq && k0 + k <= q0 + q) ? sc[k * TQ + q] * expf(cum[q0 + q] - cum[k0 + k])
                                                    : 0.f;
    });
    {  // Ys[q][p], column p = tid % 64 of query rows tid / 64 + 4 i
      const int p = tid & (TQ - 1);
      const T* src = dy + ((long)b * d.S + t0 + q0) * xrow + (long)h * d.P + p;
      for (int qq = tid / TQ; qq < TQ; qq += NT / TQ)
        Ys[qq * TQ + p] = (qq < qrows && p < d.P) ? repro::to_f32(src[qq * xrow]) : 0.f;
    }
    __syncthreads();
    const int qstart = qi == ki ? ty * 4 : 0;  // on the diagonal, key k sees queries q >= k
    for (int q = qstart; q < nq; ++q) fma44(acc, ld4(Ws + q * PT + ty * 4), ld4(Ys + q * TQ + tx * 4));
  }

  // dx = dt dxdt; sum_p x dxdt, the x part of ddt
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = ty * 4 + i;
    const bool valid = k < krows;
    const long trow = (long)b * d.S + t0 + k0 + k;
    const float dtk = valid ? dt[trow * d.H + h] : 0.f;
    float xs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx * 4 + j;
      if (valid && p < d.P) {
        const long at = trow * xrow + (long)h * d.P + p;
        xs = fmaf(repro::to_f32(x[at]), acc[i][j], xs);
        dx[at] = repro::from_f32<T>(dtk * acc[i][j]);
      }
    }
    xs = half_warp_sum(xs);
    if (tx == 0 && k < nk) xd_ws[bch * d.Q + k0 + k] = xs;
  }
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

template <typename T>
cudaError_t launch(const Ptrs& a, const Dims& d, const long blocks[8], cudaStream_t stream) {
  static std::atomic<bool> dstate_set[repro::kMaxDevices], scores_set[repro::kMaxDevices],
      dbc_set[repro::kMaxDevices], dbc_sum_set[repro::kMaxDevices], dx_set[repro::kMaxDevices];
  const int dstate_bytes = kDstateSmem * (int)sizeof(float);
  const int scores_bytes = kScoresSmem * (int)sizeof(float);
  const int dbc_bytes = kDbcSmem * (int)sizeof(float);
  const int dbc_sum_bytes = kDbcSumSmem * (int)sizeof(float);
  const int dx_bytes = kDxSmem * (int)sizeof(float);
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
  ssd_bwd_scores<T><<<(unsigned)blocks[2], NT, scores_bytes, stream>>>(x, dt, dy, cum, sc, m,
                                                                       rs, cs, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_dbc_part<T><<<(unsigned)blocks[3], NT, dbc_bytes, stream>>>(
      x, dt, Bm, Cm, dy, cum, st, gs, part, car, u, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_dbc_sum<T><<<(unsigned)blocks[4], NT, dbc_sum_bytes, stream>>>(
      Bm, Cm, m, part, static_cast<T*>(a.dB), static_cast<T*>(a.dC), d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_dx<T><<<(unsigned)blocks[5], NT, dx_bytes, stream>>>(
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
  Dims d{B, S, H, P, N, Q, (int)ceil_div(S, Q), (int)ceil_div(Q, TQ), 0, (int)ceil_div(H, HG)};
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
