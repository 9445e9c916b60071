// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py:62 decode_attention_pallas
// (Pallas body _decode_kernel at :21, pallas_call at :112).
//
// What it computes: for each batch row b and query head h,
// out[b,h] = softmax(scale * q[b,h] . k_cache[b,:len,h/group]) . v_cache[b,:len,h/group]
// with len = cache_len[b] clamped to [0, C]. A row with len 0 gives 0.
//
// Design. One block of 8 warps per (kv head, batch row, slice of up to 8
// query heads of the group) serves that slice, so each K and V row is read
// from device memory once per slice rather than once per query head (the
// Pallas kernel fetches it per head). A group of up to 8 is one slice; a
// larger group (recurrentgemma-9b's MQA: 16 query heads on one kv head, Dh
// 256) is split into slices, since holding q and the accumulators of 16
// heads of 256 dims in registers (2 x 128 f32 a lane) would spill.
// Warp w takes keys w, w + 8, w + 16, ... below len: keys at or past len are
// never read, which is the Pallas kernel's block skip at key granularity. The
// 32 lanes split Dh, each holding Dh/32 elements of q, k, v and the output
// accumulator in registers; one warp-wide sum gives a score, and each warp
// keeps its own online-softmax state (m, l, acc) per head of the slice. At the end
// the 8 partial states are merged through shared memory (the split-KV combine
// done inside the block instead of in a second pass). Any C works: the block
// walks the cache rows in place, with no padding copy.
//
// What bounds it on the H100. The work is moving the valid part of the cache:
// at the serving shape (B 4, C 544, Hkv 8, Dh 128, bf16) at most 8.9 MB of K
// and V, 2.7 us at 3.35 TB/s; the arithmetic (2 FLOP per cached element per
// group head) is far below the tensor-core floor. With B * Hkv = 32 blocks
// on 132 SMs this simple layout cannot draw the full memory rate; splitting
// the cache across more blocks is the next step toward the bound. At
// recurrentgemma-9b's shape (B 4, C 2048, Hkv 1, Dh 256, group 16) the valid
// cache is 8.4 MB (2.5 us), read by 4 x 2 blocks: the second slice reads it
// again, mostly from L2.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int NW = 8;
constexpr int NT = NW * 32;
constexpr int kMaxGroup = 16;  // the wrapper's bound; a group of 9..16 runs as two slices

__host__ __device__ constexpr size_t smem_floats(int g, int dh) {
  return (size_t)NW * g * dh + 2 * (size_t)NW * g;
}

// G bounds the heads of a slice and ND bounds Dh / 32 (rounded up) at compile
// time, so q and the accumulators live in registers; the group, the slice's
// head count gn and Dh are runtime values.
template <typename T, int G, int ND>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ cache_len, T* __restrict__ o, int C, int H, int Hkv,
    int Dh, float scale) {
  extern __shared__ float sm[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = H / Hkv;
  const int hq0 = kvh * g + blockIdx.z * G;  // first query head of this slice
  const int gn = min(G, g - (int)blockIdx.z * G);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int len = min(max(cache_len[b], 0), C);

  float qr[G][ND], acc[G][ND], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      qr[gi][j] = (gi < gn && d < Dh)
                      ? repro::to_f32(q[((long)b * H + hq0 + gi) * Dh + d])
                      : 0.f;
      acc[gi][j] = 0.f;
    }
  }

  for (int t = w; t < len; t += NW) {
    const long row = (((long)b * C + t) * Hkv + kvh) * Dh;
    float kv[ND], vv[ND];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      kv[j] = d < Dh ? repro::to_f32(kc[row + d]) : 0.f;
      vv[j] = d < Dh ? repro::to_f32(vc[row + d]) : 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < gn) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < ND; ++j) s = fmaf(qr[gi][j], kv[j], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale;
        const float m_new = fmaxf(m[gi], s);
        const float alpha = expf(m[gi] - m_new);
        const float p = expf(s - m_new);
        l[gi] = l[gi] * alpha + p;
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[gi][j] = fmaf(p, vv[j], acc[gi][j] * alpha);
        m[gi] = m_new;
      }
    }
  }

  // merge the NW partial softmax states: sm = acc [NW][gn][Dh], m [NW][gn], l [NW][gn]
  float* sm_acc = sm;
  float* sm_m = sm + (size_t)NW * gn * Dh;
  float* sm_l = sm_m + NW * gn;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < gn) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = lane + 32 * j;
        if (d < Dh) sm_acc[((size_t)w * gn + gi) * Dh + d] = acc[gi][j];
      }
      if (lane == 0) {
        sm_m[w * gn + gi] = m[gi];
        sm_l[w * gn + gi] = l[gi];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * Dh; i += NT) {
    const int gi = i / Dh, d = i - gi * Dh;
    float mx = -INFINITY;
    for (int ww = 0; ww < NW; ++ww) mx = fmaxf(mx, sm_m[ww * gn + gi]);
    float den = 0.f, num = 0.f;
    if (mx != -INFINITY) {
      for (int ww = 0; ww < NW; ++ww) {
        const float f = expf(sm_m[ww * gn + gi] - mx);  // a warp with no key: 0
        den = fmaf(sm_l[ww * gn + gi], f, den);
        num = fmaf(sm_acc[((size_t)ww * gn + gi) * Dh + d], f, num);
      }
    }
    const float out = den > 0.f ? num / den : 0.f;  // cache_len 0 → 0
    o[((long)b * H + hq0 + gi) * Dh + d] = repro::from_f32<T>(out);
  }
}

template <typename T, int G, int ND>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* len,
                   void* o, int B, int C, int H, int Hkv, int Dh, float scale,
                   cudaStream_t stream) {
  // one opt-in per instantiation and device, for the instantiation's largest shape
  static std::atomic<bool> attr_set[repro::kMaxDevices];
  const cudaError_t e = repro::opt_in_smem(
      decode_kernel<T, G, ND>, (int)(smem_floats(G, 32 * ND) * sizeof(float)), attr_set);
  if (e != cudaSuccess) return e;
  const int g = H / Hkv;
  const dim3 grid(Hkv, B, (g + G - 1) / G);
  decode_kernel<T, G, ND><<<grid, NT, smem_floats(g < G ? g : G, Dh) * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), len,
      static_cast<T*>(o), C, H, Hkv, Dh, scale);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t by_dh(const void* q, const void* kc, const void* vc, const int* len, void* o,
                  int B, int C, int H, int Hkv, int Dh, float scale, cudaStream_t st) {
  if (Dh <= 32) return launch<T, G, 1>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
  if (Dh <= 64) return launch<T, G, 2>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
  if (Dh <= 128) return launch<T, G, 4>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
  return launch<T, G, 8>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
}

template <typename T>
cudaError_t by_group(const void* q, const void* kc, const void* vc, const int* len, void* o,
                     int B, int C, int H, int Hkv, int Dh, float scale, cudaStream_t st) {
  const int g = H / Hkv;
  if (g <= 1) return by_dh<T, 1>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
  if (g <= 2) return by_dh<T, 2>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
  if (g <= 4) return by_dh<T, 4>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
  return by_dh<T, 8>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);  // slices of 8
}

}  // namespace

REPRO_ERROR_STRING_FN(decode_attention)

// q (B,H,Dh), k_cache and v_cache (B,C,Hkv,Dh), o (B,H,Dh), all contiguous and
// of one dtype (repro::kF32 or repro::kBF16); cache_len (B,) int32 on the card.
// Returns cudaGetLastError().
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* cache_len, void* o, int B, int C, int H,
                                    int Hkv, int Dh, float scale, int dtype, void* stream) {
  if (Dh <= 0 || Dh > 256 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(cache_len);
  if (dtype == repro::kF32)
    return by_group<float>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
  if (dtype == repro::kBF16)
    return by_group<__nv_bfloat16>(q, kc, vc, len, o, B, C, H, Hkv, Dh, scale, st);
  return cudaErrorInvalidValue;
}
