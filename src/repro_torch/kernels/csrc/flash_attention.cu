// Forward GQA flash attention for Hopper (sm_90a): bf16 on the tensor cores,
// f32 on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py:92 flash_attention_pallas
// (Pallas body _flash_kernel at :33, pallas_call at :141).
//
// What it computes: out[b,s,h] = softmax(scale * q[b,s,h] . k[b,:,h/group])
// . v[b,:,h/group] under the causal, sliding-window (window > 0) and q_offset
// masks, with kv positions >= Skv masked. Rows with no visible key give 0,
// as the reference's jnp.where(isnan) and the Pallas l == 0 guard do.
// Optionally (lse != nullptr) it also writes lse[b,h,s], the natural-log
// logsumexp of the row's scaled, masked scores, which the backward kernel
// (flash_attention_bwd.cu) uses to recompute the softmax; a row with no
// visible key gets +inf there, so that exp(score - lse) is 0 and the row
// gets no gradient.
//
// Two bodies, and the dtype picks one: each dtype has exactly one kernel.
//
// bf16 (flash_fwd_mma_kernel). One block per (query tile, head, batch
// row), each warp owning 16 query rows: 4 warps and 64 rows at Dh <= 128, 8
// warps and 128 rows at Dh 256 (see Tile below). Under causal the blocks
// walk the query tiles heaviest first (the linear block index puts the tile
// slowest and reversed), so the long tiles near the diagonal's end start in
// the first wave. Q goes to shared memory once and the K and V tiles of 64
// keys are double-buffered there, all by cp.async of 16 bytes a thread: tile
// j+1 is in flight while tile j is multiplied. At Dh <= 128 each warp then
// keeps its Q fragments in registers for the whole kv loop. Rows past Skv and columns
// past Dh are zero-filled (cp.async with src-size 0). Rows are padded by 16
// bytes, so the 8 row addresses of each ldmatrix fall in 8 distinct bank
// groups. S = Q.K^T and O += P.V are mma.sync m16n8k16 bf16 products with
// f32 accumulation, their operands loaded with ldmatrix (V with .trans). The
// online softmax runs in the accumulator fragments: a row's max is taken
// across the quad of lanes that holds it, the exponent is exp2f with
// scale * log2(e) folded in, and the "all masked so far" guard keeps a row
// of -inf at 0. P is rounded to bf16 in registers and reused as the A
// operand of P.V (the m16n8 accumulator layout of two n-tiles is the
// m16n8k16 A layout), as the JAX package rounds probabilities on its bf16
// path (src/repro/kernels/ops.py:69-72, :134); the row sums l are taken
// before that rounding. The element mask is applied only in tiles that
// cross the causal diagonal, the window edge or Skv. The epilogue stages
// O / l (0 where l == 0) in the warp's own Q rows and stores 16-byte rows.
// Instantiated for Dh 32, 64, 128 and 256; another multiple of 16 runs on
// the next instantiation with its extra columns zero and skipped. No
// atomics, and a fixed order of products and sums for a given shape, so a
// call is bitwise repeatable. The inputs must start on 16-byte boundaries
// (the wrapper checks). A failed launch returns its error: there is no
// other bf16 path.
//
// f32 (flash_fwd_kernel), as the JAX package's chunked path keeps "full f32
// for f32 inputs so oracle comparisons stay exact" (ops.py:69-72): the
// tensor cores would round f32 to TF32 and break the 2e-5 agreement with the
// plain version. One block of 256 threads per (q-tile of 64 rows, head,
// batch row); the Pallas kernel's sequential kv grid axis becomes a loop
// over kv tiles of 64 keys with m, l and the 64 x Dh accumulator in
// registers; each thread owns 4 rows x 4 columns of the score tile. Tiles
// sit in shared memory as f32 with a padded pitch (Dh + 1). All products
// are f32 FMAs, never TF32.
//
// Both bodies compute the kv range a tile can see once, from the causal and
// window limits and q_offset, and never load tiles outside it: the
// block-level skip of the Pallas kernel.
//
// What bounds it on the H100. At qwen3-1.7b's train shape (B 4, S 2048, H
// 16, Hkv 8, Dh 128, causal, bf16) the work is 4 * Dh FLOP per visible
// (query, key) pair and head, 69 GFLOP: 0.07 ms at the tensor cores' 989
// TFLOP/s, above the 0.03 ms of moving q, k, v, out and lse. The bf16 body
// is bound by the SM, not by device memory: each warp reads the whole K and
// V tile from shared memory for its 16 rows (16 FLOP per byte, where an SM
// reads 128 bytes a clock); mma.sync reaches only part of the rate of
// Hopper's warpgroup MMA; and the two barriers a tile put every warp of a
// block into its softmax at once, which leaves the tensor cores to the
// other blocks on the SM (two at Dh <= 128, by shared memory; one at Dh
// 256, hence its 8 warps). The next step is wgmma tiles fed by TMA, with a
// warpgroup of 64 rows sharing each K and V fragment and the softmax of one
// warpgroup overlapping the products of another. PERF.md holds the measured
// times beside the bound.

#include "common.cuh"
#include "mma.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per kv tile
constexpr int NT = 256;  // threads: 16 x 16, each 4 rows x 4 columns of S

__host__ __device__ constexpr size_t smem_floats(int dh) {
  return (size_t)BQ * (dh + 1) + (size_t)BK * (dh + 1) + (size_t)BK * dh +
         (size_t)BQ * (BK + 1);
}

// NC bounds Dh / 16 at compile time so the accumulator lives in registers;
// the actual Dh (a multiple of 16, at most 16 * NC) is a runtime value.
template <int NC>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int Hkv, int Dh,
    int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int qp = Dh + 1;  // padded pitch of the Q and K rows
  const int pp = BK + 1;  // padded pitch of the P rows
  float* Qs = smem;       // BQ x qp
  float* Ks = Qs + BQ * qp;
  float* Vs = Ks + BK * qp;  // BK x Dh
  float* Ps = Vs + BK * Dh;  // BQ x pp

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int nq = min(BQ, Sq - q0);
  const int nc = Dh >> 4;

  const long q_row = (long)H * Dh, kv_row = (long)Hkv * Dh;
  const float* qb = q + ((long)b * Sq + q0) * q_row + (long)h * Dh;
  const float* kb = k + (long)b * Skv * kv_row + (long)kvh * Dh;
  const float* vb = v + (long)b * Skv * kv_row + (long)kvh * Dh;
  float* ob = o + ((long)b * Sq + q0) * q_row + (long)h * Dh;

  for (int i = tid; i < BQ * Dh; i += NT) {
    const int r = i / Dh, d = i - r * Dh;
    Qs[r * qp + d] = r < nq ? qb[r * q_row + d] : 0.f;
  }

  // the kv positions any row of this tile may see
  const int qpos_lo = q0 + q_offset, qpos_hi = q0 + nq - 1 + q_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = max(0, min(Skv, qpos_hi + 1));
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    const int nk = min(BK, kv_hi - k0);
    __syncthreads();  // Qs written; the previous tile's Ks, Vs, Ps read
    for (int i = tid; i < BK * Dh; i += NT) {
      const int r = i / Dh, d = i - r * Dh;
      const bool in = r < nk;
      const long off = (long)(k0 + r) * kv_row + d;
      Ks[r * qp + d] = in ? kb[off] : 0.f;
      Vs[r * Dh + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * qp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * qp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        bool ok = c < nk && r < nq;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // a row's 64 columns live on the 16 lanes that share ty
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[r * pp + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    for (int kk = 0; kk < nk; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * pp + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          const float vv = Vs[kk * Dh + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no visible key → 0
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < nc) ob[r * q_row + tx + 16 * c] = acc[i][c] * inv;
      if (lse != nullptr && tx == 0)
        lse[((long)b * H + h) * Sq + q0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

template <int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int Hkv, int Dh, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  // one opt-in per instantiation and device, for the instantiation's largest Dh
  static std::atomic<bool> attr_set[repro::kMaxDevices];
  const cudaError_t e = repro::opt_in_smem(
      flash_fwd_kernel<NC>, (int)(smem_floats(16 * NC) * sizeof(float)), attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<NC><<<grid, NT, smem_floats(Dh) * sizeof(float), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal, int window,
                     int q_offset, float scale, cudaStream_t st) {
  if (Dh <= 32)
    return launch<2>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset,
                        scale, st);
  if (Dh <= 64)
    return launch<4>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset,
                        scale, st);
  if (Dh <= 128)
    return launch<8>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset,
                        scale, st);
  return launch<16>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset,
                       scale, st);
}

// --------------------------------------------------------------------------
// bf16 body: mma.sync tiles fed by cp.async
// --------------------------------------------------------------------------

namespace mma {

using namespace repro::mma;

// The tiles of an instantiation: WARPS warps, each owning 16 query rows,
// and kv tiles of BK keys. Rows in shared memory hold Dh plus 16 bytes of
// padding, so that the 8 rows of an ldmatrix lie in distinct 16-byte bank
// groups. Shared memory: the Q tile, then two stages of a K tile and a V
// tile. At Dh 256 a block of 4 warps fits once on an SM (169 KB), so the
// tensor cores idle while its warps do the softmax; 8 warps (203 KB) put
// two warps on each of the SM's schedulers. At Dh <= 128, 4 warps already
// run two blocks to an SM, and 8 warps would run one (by registers).
template <int DH>
struct Tile {
  static constexpr int WARPS = DH == 256 ? 8 : 4;
  static constexpr int BK = 64;
  static constexpr int NT = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;
  static constexpr int P = DH + 8;
  static constexpr size_t SMEM = (size_t)(BM + 4 * BK) * P * sizeof(bf16);
};

// Fragment layouts and the helpers: mma.cuh.
//
// DH: the instantiation's head dim, at least the runtime Dh (a multiple of
// 16); columns Dh..DH-1 are zero in shared memory and skipped.
template <int DH>
__global__ void __launch_bounds__(Tile<DH>::NT) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int B, int Sq, int Skv, int H, int Hkv,
    int Dh, int causal, int window, int q_offset, float scale_log2) {
  using T = Tile<DH>;
  constexpr int NT = T::NT, BM = T::BM, BK = T::BK, P = T::P;
  constexpr int CH = DH / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BM x P
  bf16* KVs = Qs + BM * P;  // stage s: K at KVs + 2 s BK P, V BK P after it

  const int n_qt = (Sq + BM - 1) / BM;
  const int hb = blockIdx.x % (H * B), qt_lin = blockIdx.x / (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (causal ? n_qt - 1 - qt_lin : qt_lin) * BM;  // heaviest first
  const int nq = min(BM, Sq - q0);
  const int kvh = h / (H / Hkv);
  const int dch = Dh / 8;  // chunks that hold data
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = warp * 16;  // the warp's first row in the tile

  const long q_row = (long)H * Dh, kv_row = (long)Hkv * Dh;
  const bf16* qb = q + ((long)b * Sq + q0) * q_row + (long)h * Dh;
  const bf16* kb = k + (long)b * Skv * kv_row + (long)kvh * Dh;
  const bf16* vb = v + (long)b * Skv * kv_row + (long)kvh * Dh;
  bf16* ob = o + ((long)b * Sq + q0) * q_row + (long)h * Dh;

  // the kv positions any row of this tile may see
  const int qpos_lo = q0 + q_offset, qpos_hi = q0 + nq - 1 + q_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = max(0, min(Skv, qpos_hi + 1));
  if (window > 0) kv_lo = max(0, qpos_lo - window + 1);
  const int n_kt = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  for (int i = tid; i < BM * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r < nq && c < dch;
    cp_async16(Qs + r * P + c * 8, in ? qb + r * q_row + c * 8 : qb, in);
  }
  cp_async_commit();  // Q
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
  // ldmatrix row addresses of this lane: Q's A fragment, K's B fragments of
  // two key n-tiles, V's transposed B fragments of two column n-tiles
  const uint32_t q_addr = smem_u32(Qs + wrow * P + a_off<P>(lane));
  const int k_off = b_off<P>(lane);
  const int v_off = bt_off<P>(lane);

  // At Dh <= 128 the warp's Q fragments stay in registers for the whole kv
  // loop (32 registers at Dh 128), which saves one ldmatrix of five in
  // S = Q.K^T (one of nine in a kv tile, with P.V's); at Dh 256 they would take 64 registers beside the
  // 128 of the accumulator, so there they are reloaded with each kv tile.
  constexpr bool QREG = DH <= 128;
  uint32_t qa[QREG ? DH / 16 : 1][4];
  if constexpr (QREG) {
    cp_async_wait<1>();  // Q landed; the first kv tile may still be in flight
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      if (kk * 16 < Dh) ldmatrix_x4(qa[kk], q_addr + kk * 32);
  }

  float acc_o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_r[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int t = 0; t < n_kt; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_kt) {
      load_kv(t + 1, stage ^ 1);  // its stage was last read in tile t - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const int k0 = kv_lo + t * BK;
    const bf16* Ks = KVs + stage * 2 * BK * P;
    const uint32_t k_addr = smem_u32(Ks + k_off), v_addr = smem_u32(Ks + BK * P + v_off);

    // S = Q . K^T: 16 rows x BK keys a warp
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      if (kk * 16 < Dh) {
        uint32_t a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        } else {
          ldmatrix_x4(a, q_addr + kk * 32);
        }
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_addr + (np * 16 * P + kk * 16) * 2);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }

    // scale into log2 units; the element mask only where the tile crosses
    // the causal diagonal, the window edge or Skv
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > qpos_lo) ||
                           (window > 0 && k0 <= qpos_hi - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + j * 8 + 2 * cq + (e & 1);
          const int qpos = q0 + wrow + g + (e >> 1) * 8 + q_offset;
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) x = -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax: the row max across the quad, then rescale
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_use[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // all masked so far
      alpha[i] = exp2f(m_r[i] - m_use[i]);
      m_r[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_use[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rs[i];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc_o[j][0] *= alpha[0];
      acc_o[j][1] *= alpha[0];
      acc_o[j][2] *= alpha[1];
      acc_o[j][3] *= alpha[1];
    }

    // O += P . V, P rounded to bf16 in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        if (dp * 16 < Dh) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_addr + (kk * 16 * P + dp * 16) * 2);
          mma_bf16(acc_o[2 * dp], a, bv[0], bv[1]);
          mma_bf16(acc_o[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp done with this stage before it is refilled
  }
  cp_async_wait<0>();  // with no kv tile, Q may still be in flight
  __syncthreads();

  // epilogue: O / l (0 on a row with no visible key), staged in the warp's
  // own Q rows, stored as 16-byte rows
  bf16* Os = Qs + wrow * P;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * i) * P + j * 8 + 2 * cq) =
          pack_bf16(acc_o[j][2 * i] * inv[i], acc_o[j][2 * i + 1] * inv[i]);
  if (lse != nullptr && cq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + g + 8 * i;
      if (row < nq)
        lse[((long)b * H + h) * Sq + q0 + row] =
            l_r[i] > 0.f ? m_r[i] * kLn2 + logf(l_r[i]) : INFINITY;
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, row = wrow + r;
    if (row < nq && c < dch)
      *reinterpret_cast<uint4*>(ob + row * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * P + c * 8);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int Hkv, int Dh, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  using T = Tile<DH>;
  static std::atomic<bool> attr_set[repro::kMaxDevices];
  const cudaError_t e = repro::opt_in_smem(flash_fwd_mma_kernel<DH>, (int)T::SMEM, attr_set);
  if (e != cudaSuccess) return e;
  const long blocks = (long)((Sq + T::BM - 1) / T::BM) * H * B;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  flash_fwd_mma_kernel<DH><<<(unsigned)blocks, T::NT, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset,
      scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int Sq, int Skv, int H, int Hkv, int Dh, int causal, int window,
                     int q_offset, float scale, cudaStream_t st) {
  if (Dh <= 32)
    return launch<32>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale,
                      st);
  if (Dh <= 64)
    return launch<64>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale,
                      st);
  if (Dh <= 128)
    return launch<128>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset,
                       scale, st);
  return launch<256>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale,
                     st);
}

}  // namespace mma

}  // namespace

REPRO_ERROR_STRING_FN(flash_attention)

// q (B,Sq,H,Dh), k and v (B,Skv,Hkv,Dh), o (B,Sq,H,Dh), all contiguous and of
// one dtype (repro::kF32 or repro::kBF16); lse (B,H,Sq) f32, or null when the
// caller needs no logsumexp. Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Skv, int H,
                                   int Hkv, int Dh, int causal, int window, int q_offset,
                                   float scale, int dtype, void* stream) {
  if (Dh <= 0 || Dh % 16 != 0 || Dh > 256 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == repro::kF32)
    return dispatch(q, k, v, o, l, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale,
                    st);
  if (dtype == repro::kBF16)
    return mma::dispatch(q, k, v, o, l, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset,
                         scale, st);
  return cudaErrorInvalidValue;
}
