// Forward GQA flash attention for Hopper (sm_90a), bf16 or f32 in, f32 math.
//
// Replaces: src/repro/kernels/flash_attention.py:92 flash_attention_pallas
// (Pallas body _flash_kernel at :33, pallas_call at :141).
//
// What it computes: out[b,s,h] = softmax(scale * q[b,s,h] . k[b,:,h/group])
// . v[b,:,h/group] under the causal, sliding-window (window > 0) and q_offset
// masks, with kv positions >= Skv masked. Rows with no visible key give 0,
// as the reference's jnp.where(isnan) and the Pallas l == 0 guard do.
//
// Design. One block of 256 threads per (q-tile of 64 rows, head, batch row).
// The Pallas kernel's sequential kv grid axis becomes a loop over kv tiles of
// 64 keys; the running max m, denominator l and the 64 x Dh output
// accumulator stay in registers for the whole loop (online softmax), so
// scores never reach device memory. GQA reads kv head h / group directly, with
// no repeat. The kv range a tile can see is computed up front from the causal
// and window limits and q_offset, and tiles outside it are never loaded: the
// block-level skip of the Pallas kernel. Each thread owns 4 rows x 4 columns
// of the 64 x 64 score tile and 4 rows x Dh/16 columns of the accumulator.
// Tiles are staged in shared memory as f32 with a padded pitch (Dh + 1) so
// that the column reads of Q and K hit distinct banks. All products are f32
// FMAs on the CUDA cores, never TF32, so f32 inputs agree with the plain
// version to 2e-5.
//
// What bounds it on the H100. At the serving shape (B 4, S 512, H 16, Hkv 8,
// Dh 128, bf16, causal) the work is 4.3 GFLOP and 25 MB of q, k, v and out:
// the card's floor is the 7.5 us of moving those bytes at 3.35 TB/s (the
// 4.3 us of bf16 tensor-core time is below it). This kernel does its products
// on the f32 CUDA cores from shared memory, so it is bound by f32 FMA issue
// and shared-memory reads, far above that floor. It is the simple, exact
// first version; wgmma tiles fed by TMA are the way to the floor.

#include "common.cuh"

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
template <typename T, int NC>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Skv, int H, int Hkv, int Dh, int causal,
    int window, int q_offset, float scale) {
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
  const T* qb = q + ((long)b * Sq + q0) * q_row + (long)h * Dh;
  const T* kb = k + (long)b * Skv * kv_row + (long)kvh * Dh;
  const T* vb = v + (long)b * Skv * kv_row + (long)kvh * Dh;
  T* ob = o + ((long)b * Sq + q0) * q_row + (long)h * Dh;

  for (int i = tid; i < BQ * Dh; i += NT) {
    const int r = i / Dh, d = i - r * Dh;
    Qs[r * qp + d] = r < nq ? repro::to_f32(qb[r * q_row + d]) : 0.f;
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
      Ks[r * qp + d] = in ? repro::to_f32(kb[off]) : 0.f;
      Vs[r * Dh + d] = in ? repro::to_f32(vb[off]) : 0.f;
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
        if (c < nc) ob[r * q_row + tx + 16 * c] = repro::from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int Hkv, int Dh, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  // one opt-in per instantiation and device, for the instantiation's largest Dh
  static std::atomic<bool> attr_set[repro::kMaxDevices];
  const cudaError_t e = repro::opt_in_smem(
      flash_fwd_kernel<T, NC>, (int)(smem_floats(16 * NC) * sizeof(float)), attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, NC><<<grid, NT, smem_floats(Dh) * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Skv, int H, int Hkv, int Dh, int causal, int window,
                     int q_offset, float scale, cudaStream_t st) {
  if (Dh <= 32)
    return launch<T, 2>(q, k, v, o, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale, st);
  if (Dh <= 64)
    return launch<T, 4>(q, k, v, o, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale, st);
  if (Dh <= 128)
    return launch<T, 8>(q, k, v, o, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale, st);
  return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale, st);
}

}  // namespace

REPRO_ERROR_STRING_FN(flash_attention)

// q (B,Sq,H,Dh), k and v (B,Skv,Hkv,Dh), o (B,Sq,H,Dh), all contiguous and of
// one dtype (repro::kF32 or repro::kBF16). Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H, int Hkv,
                                   int Dh, int causal, int window, int q_offset,
                                   float scale, int dtype, void* stream) {
  if (Dh <= 0 || Dh % 16 != 0 || Dh > 256 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch<float>(q, k, v, o, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset, scale, st);
  if (dtype == repro::kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, Dh, causal, window, q_offset,
                                   scale, st);
  return cudaErrorInvalidValue;
}
