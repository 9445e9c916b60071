// Backward of GQA flash attention for Hopper (sm_90a), bf16 or f32 in, f32 math.
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
//   D   = rowsum(dO * O)                       (kernel 1)
//   P   = exp(s * Q K^T - lse) on M, 0 off it  (recomputed, never stored)
//   dV  = P^T dO,   dS = P * (dO V^T - D)
//   dK  = s * dS^T Q                           (kernel 2, dV too)
//   dQ  = s * dS K                             (kernel 3)
// A row with no visible key has lse = +inf from the forward, so its P row is
// 0 and it contributes nothing and gets dQ = 0, as autograd through ref.mha
// gives.
//
// Design. No floating-point atomics, so a step is bit-stable from run to run:
// every output element is summed in one block in a fixed order and written
// once. Kernel 2 gives a block of 256 threads one (kv tile of 64 keys, kv
// head, batch row); it keeps its K and V tiles in shared memory and dK, dV in
// registers while it loops over the group's query heads and, for each, over
// the query tiles that can see the tile (the causal and window limits bound
// that range up front), so the GQA sum over the group happens inside the
// block. Kernel 3 gives a block one (query tile of 64 rows, head, batch row)
// and loops over the kv tiles its rows can see, as the forward does, with dQ
// in registers. Both recompute the 64 x 64 score tile from Q and K with the
// same f32 FMA order as the forward, so P matches the forward's softmax. Tiles
// sit in shared memory as f32 with a padded pitch (Dh + 1) so that the column
// reads of Q, K, V and dO hit distinct banks. All products are f32 FMAs on the
// CUDA cores, never TF32.
//
// Head dims: a multiple of 16 up to 128 (qwen3's 128 included). dK and dV of
// 4 keys x Dh/16 columns a thread take 64 registers at Dh 128; at Dh 256 they
// would take 128 plus the score tiles, past what a thread can hold, so the
// wrapper refuses larger head dims (ROADMAP.md lists the redesign).
//
// What bounds it on the H100. At qwen3-1.7b's train shape (B 4, S 2048, H 16,
// Hkv 8, Dh 128, causal, bf16) the gradient needs 5 products of 2 * Dh FLOP
// per visible (query, key) pair and head (the scores recomputed, dP, dV, dK,
// dQ): 172 GFLOP, 0.17 ms at the tensor cores' 989 TFLOP/s, above the 0.04 ms
// of reading q, k, v, o, dO and writing dq, dk, dv. This kernel recomputes the
// scores and dP in both kernels 2 and 3 (7 products a pair) on the f32 CUDA
// cores from shared memory, so, like the forward, it is bound by f32 FMA issue
// and shared-memory reads, far above that floor; wgmma tiles fed by TMA are
// the way down.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: 16 x 16, each 4 rows x 4 columns of a score tile

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

__host__ __device__ constexpr size_t smem_floats(int dh) {
  // four (64 x (dh+1)) row tiles, two (64 x 65) score tiles, lse and D
  return 4 * (size_t)64 * (dh + 1) + 2 * (size_t)BQ * (BK + 1) + 2 * (size_t)BQ;
}

// Load `n` rows (of `rows` in the tile) of a head's Dh columns, f32, padded
// pitch; rows past n are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long row_stride, int n,
                                          int rows, int Dh) {
  const int qp = Dh + 1;
  for (int i = threadIdx.x; i < rows * Dh; i += NT) {
    const int r = i / Dh, d = i - r * Dh;
    dst[r * qp + d] = r < n ? repro::to_f32(src[r * row_stride + d]) : 0.f;
  }
}

// The 64 x 64 tiles of P and dS for query rows q0.. (nq valid) against keys
// k0.. (nk valid), from Qs, dOs, Ks, Vs, Ls, Ds in shared memory. Thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j. Writes Ps and dSs.
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs, const float* Ks,
                                            const float* Vs, const float* Ls, const float* Ds,
                                            float* Ps, float* dSs, int q0, int nq, int k0,
                                            int nk, int Dh, int causal, int window,
                                            int q_offset, float scale) {
  const int qp = Dh + 1, pp = BK + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < Dh; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * qp + d];
      ov[i] = dOs[(ty + 16 * i) * qp + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * qp + d];
      vv[j] = Vs[(tx + 16 * j) * qp + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r + q_offset;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
template <typename T, int NC>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int Hkv, int Dh,
    int causal, int window, int q_offset, float scale) {
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

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
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
      score_tiles(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, nq, k0, nk, Dh, causal, window,
                  q_offset, scale);
      __syncthreads();
      // dV[c] += sum_r P[r][c] dO[r];  dK[c] += sum_r dS[r][c] Q[r]
      for (int r = 0; r < nq; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[r * pp + ty + 16 * i];
          ds[i] = dSs[r * pp + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) {
            const float ov = dOs[r * qp + tx + 16 * c], qv = Qs[r * qp + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv_acc[i][c] = fmaf(p[i], ov, dv_acc[i][c]);
              dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c < nk) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        if (cc < nc) {
          const long off = kv_off + (long)c * kv_row + tx + 16 * cc;
          dk[off] = repro::from_f32<T>(dk_acc[i][cc] * scale);
          dv[off] = repro::from_f32<T>(dv_acc[i][cc]);
        }
    }
  }
}

// dQ for one (query tile, head, batch row).
template <typename T, int NC>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dq, int Sq, int Skv, int H, int Hkv, int Dh, int causal, int window,
    int q_offset, float scale) {
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

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    const int nk = min(BK, kv_hi - k0);
    const long kv_off = ((long)b * Skv + k0) * kv_row + (long)kvh * Dh;
    __syncthreads();  // Qs, dOs written; the previous tile's Ks, dSs read
    load_tile(Ks, k + kv_off, kv_row, nk, BK, Dh);
    load_tile(Vs, v + kv_off, kv_row, nk, BK, Dh);
    __syncthreads();
    score_tiles(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, nq, k0, nk, Dh, causal, window,
                q_offset, scale);
    __syncthreads();
    // dQ[r] += sum_c dS[r][c] K[c]
    for (int c = 0; c < nk; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * pp + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        if (cc < nc) {
          const float kv = Ks[c * qp + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(ds[i], kv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        if (cc < nc) dq[q_off + (long)r * q_row + tx + 16 * cc] = repro::from_f32<T>(acc[i][cc] * scale);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* D, void* dq, void* dk,
                   void* dv, int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                   int window, int q_offset, float scale, cudaStream_t st) {
  // one opt-in per instantiation and device, for the instantiation's largest Dh
  static std::atomic<bool> dkdv_set[repro::kMaxDevices], dq_set[repro::kMaxDevices];
  const int max_bytes = (int)(smem_floats(16 * NC) * sizeof(float));
  cudaError_t e = repro::opt_in_smem(flash_bwd_dkdv_kernel<T, NC>, max_bytes, dkdv_set);
  if (e != cudaSuccess) return e;
  e = repro::opt_in_smem(flash_bwd_dq_kernel<T, NC>, max_bytes, dq_set);
  if (e != cudaSuccess) return e;
  const size_t bytes = smem_floats(Dh) * sizeof(float);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const long rows = (long)B * Sq * H;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      dot, static_cast<const T*>(o), D, rows, Sq, H, Dh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<T, NC><<<dim3((Skv + BK - 1) / BK, Hkv, B), NT, bytes, st>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, Hkv, Dh,
      causal, window, q_offset, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, NC><<<dim3((Sq + BQ - 1) / BQ, H, B), NT, bytes, st>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dq), Sq, Skv, H, Hkv, Dh, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* D, void* dq, void* dk,
                     void* dv, int B, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                     int window, int q_offset, float scale, cudaStream_t st) {
  if (Dh <= 32)
    return launch<T, 2>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                        window, q_offset, scale, st);
  if (Dh <= 64)
    return launch<T, 4>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                        window, q_offset, scale, st);
  return launch<T, 8>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                      window, q_offset, scale, st);
}

}  // namespace

REPRO_ERROR_STRING_FN(flash_attention_bwd)

// q, o, dout, dq (B,Sq,H,Dh); k, v, dk, dv (B,Skv,Hkv,Dh); all contiguous and
// of one dtype (repro::kF32 or repro::kBF16); lse (B,H,Sq) f32 from the
// forward; delta (B,H,Sq) f32 scratch. Dh a multiple of 16, at most 128.
// Launches three kernels on `stream`; returns the first cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                   int Skv, int H, int Hkv, int Dh, int causal, int window,
                                   int q_offset, float scale, int dtype, void* stream) {
  if (Dh <= 0 || Dh % 16 != 0 || Dh > 128 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* D = static_cast<float*>(delta);
  if (dtype == repro::kF32)
    return dispatch<float>(q, k, v, o, dout, l, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh, causal,
                           window, q_offset, scale, st);
  if (dtype == repro::kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, l, D, dq, dk, dv, B, Sq, Skv, H, Hkv, Dh,
                                   causal, window, q_offset, scale, st);
  return cudaErrorInvalidValue;
}
