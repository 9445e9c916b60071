// RG-LRU linear recurrence (recurrentgemma) for Hopper (sm_90a), bf16 or f32
// in, f32 state.
//
// Replaces: src/repro/kernels/rglru_scan.py:46 rglru_scan_pallas (Pallas body
// _rglru_kernel at :22, pallas_call at :63).
//
// What it computes: for each batch row b and channel w, with a = exp(a_log),
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * x_t,   h_{-1} = h0 or 0,
// writing y[b,t,w] = h_t and h_last[b,w] = h_{S-1}, both in x's dtype; the
// carried h stays f32, as in the Pallas kernel's VMEM scratch. Any S and W:
// unlike the Pallas kernel, nothing has to divide a block size.
//
// Design. One thread per (b, w) column walks the S steps in order with h in a
// register; neighbouring threads take neighbouring w, so every load and store
// of a step is coalesced across the warp. The loads of 8 steps are issued
// before their 8 dependent updates, so the recurrence waits on memory once
// per 8 steps rather than once per step. This is the Pallas kernel's
// sequential seq axis with its width blocks spread over the SMs.
//
// What bounds it on the H100. The work is moving x and a_log in and y out:
// at recurrentgemma-9b's prefill (B 4, S 3072, W 4096, bf16 x, f32 a_log)
// 8 bytes per (b, t, w), 403 MB, 0.12 ms at 3.35 TB/s; the arithmetic (an
// exp, a sqrt and three FMAs per element) is far below any compute floor.
// The known loss of this simple layout: B * W = 16 384 threads are 128
// blocks of 128, under one wave on 132 SMs with 4 warps each, too few loads
// in flight to draw the full memory rate. A chunked two-pass scan over S
// (per-chunk decay products and end states, then a pass that folds the
// carried states in) is the redesign that fills the card.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int NT = 128;  // threads per block, one per channel
constexpr int U = 8;     // steps whose loads are issued together

template <typename T>
__global__ void __launch_bounds__(NT) rglru_kernel(
    const T* __restrict__ x, const float* __restrict__ a_log, const float* __restrict__ h0,
    T* __restrict__ y, T* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x, b = blockIdx.y;
  if (w >= W) return;
  const long col = (long)b * S * W + w;
  float h = h0 != nullptr ? h0[(long)b * W + w] : 0.f;
  int t = 0;
  for (; t + U <= S; t += U) {
    float xv[U], av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long i = col + (long)(t + u) * W;
      xv[u] = repro::to_f32(x[i]);
      av[u] = a_log[i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float a = expf(av[u]);
      h = a * h + sqrtf(fmaxf(1.f - a * a, 1e-12f)) * xv[u];
      y[col + (long)(t + u) * W] = repro::from_f32<T>(h);
    }
  }
  for (; t < S; ++t) {
    const long i = col + (long)t * W;
    const float a = expf(a_log[i]);
    h = a * h + sqrtf(fmaxf(1.f - a * a, 1e-12f)) * repro::to_f32(x[i]);
    y[i] = repro::from_f32<T>(h);
  }
  h_last[(long)b * W + w] = repro::from_f32<T>(h);
}

template <typename T>
cudaError_t launch(const void* x, const float* a_log, const float* h0, void* y, void* h_last,
                   int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), a_log, h0,
                                           static_cast<T*>(y), static_cast<T*>(h_last), S, W);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING_FN(rglru_scan)

// x (B,S,W) and y (B,S,W), h_last (B,W) of one dtype (repro::kF32 or
// repro::kBF16); a_log (B,S,W) f32; h0 (B,W) f32 or null for a zero start.
// All contiguous. Returns cudaGetLastError().
extern "C" int rglru_scan_fwd(const void* x, const void* a_log, const void* h0, void* y,
                              void* h_last, int B, int S, int W, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(a_log);
  const float* hi = static_cast<const float*>(h0);
  if (dtype == repro::kF32) return launch<float>(x, al, hi, y, h_last, B, S, W, st);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(x, al, hi, y, h_last, B, S, W, st);
  return cudaErrorInvalidValue;
}
