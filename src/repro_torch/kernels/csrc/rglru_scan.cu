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
// Design: a chunked two-pass scan over time. The S steps of a row are cut
// into chunks of L steps (the last one may be shorter), L and the grids
// planned on the host by kernels/rglru_scan.py plan(). rglru_scan_fwd
// launches three kernels in order on the caller's stream, every one with
// one thread per channel and neighbouring threads on neighbouring w, so
// every load and store of a step is coalesced across the warp:
//   1. rglru_scan_chunk, one thread per (b, chunk, w) for every chunk but
//      the last: walks its L steps from h = 0 and writes two f32 values to
//      the workspace, the chunk's decay product P = a_0 a_1 ... a_{L-1} (in
//      step order) and its local end state E.
//   2. rglru_scan_pass, one thread per (b, w): folds h0 (or 0) through the
//      chunks in order, h <- P_c h + E_c, and overwrites E_c with the state
//      entering chunk c + 1. It issues the loads of kPassUnroll chunks
//      before their dependent FMAs, so that its serial chain waits on
//      memory once per kPassUnroll chunks.
//   3. rglru_scan_out, one thread per (b, chunk, w): starts from the state
//      entering its chunk (h0 or 0 for the first) and walks its steps with
//      the same per-step arithmetic as a sequential scan (rglru_step.cuh, in
//      every kernel), writing y; the last chunk's thread writes h_last from
//      its own h, so h_last is y's last row to the bit, as in the
//      sequential scan.
// Within a chunk every y is the sequential recurrence; only the state
// entering each chunk is reassociated, as P h + E: the reordering that the
// JAX package's jnp path makes with its associative scan (ops.py:266-281).
// f32 differs from the sequential oracle by about L ulp, relative. There
// are no atomics and the pass runs in chunk order, so two calls give
// bitwise-equal outputs. The walks issue the loads of U steps before their
// dependent updates. Where S <= L there is one chunk: only the out kernel
// runs, which is then the sequential scan from h0.
//
// What bounds it on the H100. The function must move x and a_log in and y
// out: at recurrentgemma-9b's prefill (B 4, S 3072, W 4096, bf16 x, f32
// a_log) 8 bytes per (b, t, w), 403 MB, 0.12 ms at 3.35 TB/s; the
// arithmetic (an exp, a sqrt and a few FMAs per element) is far below any
// compute floor. This design reads x and a_log twice (chunk and out
// kernels), 14 bytes per element, plus 8 bytes per (b, chunk, w) of f32
// workspace written, read and half rewritten (6.2 MB at L 64, mostly in
// the 50 MB L2): its own floor is about 0.21 ms. In exchange it runs
// B * W * n_chunks threads (786 432 at the prefill shape, L 64, about
// three waves of full SMs) where one thread per (b, w) gave 16 384, under
// one wave with too few loads in flight to draw the memory rate. A single
// chained pass would read x and a_log once, but with each chunk waiting on
// its predecessor's inclusive state alone, a row's chunks form one serial
// chain of handoffs that cost more than the second read (ROADMAP, Queue 2
// C item 4); it needs a look-back over several chunks in flight.

#include "common.cuh"
#include "rglru_step.cuh"

#include <math.h>

namespace {

constexpr int NT = 128;          // threads per block, one per channel
constexpr int U = 8;             // steps whose loads a walk issues together
constexpr int kPassUnroll = 16;  // chunks whose loads the pass issues together
constexpr int kMaxGridYZ = 65535;

struct Dims {
  int B, S, W;
  int L;   // steps of every chunk but the last
  int nc;  // chunks of a row
};


// Walks n steps of one channel from element index i (stride W), calling
// f(t, a_t, x_t) in step order with a_t = expf(a_log_t); the loads of U
// steps are issued before their U calls.
template <typename T, typename F>
__device__ __forceinline__ void walk(const T* __restrict__ x, const float* __restrict__ a_log,
                                     long i, int n, int W, F f) {
  int t = 0;
  for (; t + U <= n; t += U) {
    float xv[U], av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long j = i + (long)(t + u) * W;
      xv[u] = repro::to_f32(x[j]);
      av[u] = a_log[j];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) f(t + u, expf(av[u]), xv[u]);
  }
  for (; t < n; ++t) {
    const long j = i + (long)t * W;
    f(t, expf(a_log[j]), repro::to_f32(x[j]));
  }
}

// 1. per (b, chunk, w), every chunk but the last: P and E of the chunk
template <typename T>
__global__ void __launch_bounds__(NT) rglru_scan_chunk(
    const T* __restrict__ x, const float* __restrict__ a_log, float* __restrict__ prod,
    float* __restrict__ end, Dims d) {
  const int w = blockIdx.x * NT + threadIdx.x, c = blockIdx.y, b = blockIdx.z;
  if (w >= d.W) return;
  float h = 0.f, p = 1.f;
  walk(x, a_log, ((long)b * d.S + (long)c * d.L) * d.W + w, d.L, d.W,
       [&](int, float a, float xv) {
         h = repro::rglru_step(h, a, xv);
         p *= a;
       });
  const long slot = ((long)b * (d.nc - 1) + c) * d.W + w;
  prod[slot] = p;
  end[slot] = h;
}

// 2. per (b, w): the states entering chunks 1 .. nc-1, over E in place
__global__ void __launch_bounds__(NT) rglru_scan_pass(
    const float* __restrict__ h0, const float* __restrict__ prod, float* __restrict__ end,
    Dims d) {
  const int w = blockIdx.x * NT + threadIdx.x, b = blockIdx.y;
  if (w >= d.W) return;
  const int n = d.nc - 1;
  const long base = (long)b * n * d.W + w;
  float h = h0 != nullptr ? h0[(long)b * d.W + w] : 0.f;
  for (int c0 = 0; c0 < n; c0 += kPassUnroll) {
    float p[kPassUnroll], e[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u < n) {
        p[u] = prod[base + (long)(c0 + u) * d.W];
        e[u] = end[base + (long)(c0 + u) * d.W];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (c0 + u < n) {
        h = fmaf(p[u], h, e[u]);
        end[base + (long)(c0 + u) * d.W] = h;  // the state entering chunk c0 + u + 1
      }
    }
  }
}

// 3. per (b, chunk, w): y from the state entering the chunk
template <typename T>
__global__ void __launch_bounds__(NT) rglru_scan_out(
    const T* __restrict__ x, const float* __restrict__ a_log, const float* __restrict__ h0,
    const float* __restrict__ enter, T* __restrict__ y, T* __restrict__ h_last, Dims d) {
  const int w = blockIdx.x * NT + threadIdx.x, c = blockIdx.y, b = blockIdx.z;
  if (w >= d.W) return;
  float h = c > 0 ? enter[((long)b * (d.nc - 1) + c - 1) * d.W + w]
                  : (h0 != nullptr ? h0[(long)b * d.W + w] : 0.f);
  const long i = ((long)b * d.S + (long)c * d.L) * d.W + w;
  walk(x, a_log, i, min(d.L, d.S - c * d.L), d.W, [&](int t, float a, float xv) {
    h = repro::rglru_step(h, a, xv);
    y[i + (long)t * d.W] = repro::from_f32<T>(h);
  });
  if (c == d.nc - 1) h_last[(long)b * d.W + w] = repro::from_f32<T>(h);
}

template <typename T>
cudaError_t launch(const void* x, const float* a_log, const float* h0, void* y, void* h_last,
                   float* ws, const Dims& d, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const unsigned wb = (unsigned)(((long)d.W + NT - 1) / NT);
  float* prod = ws;
  float* end = ws + (long)d.B * (d.nc - 1) * d.W;
  cudaError_t e;
  if (d.nc > 1) {
    rglru_scan_chunk<T><<<dim3(wb, d.nc - 1, d.B), NT, 0, stream>>>(xt, a_log, prod, end, d);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    rglru_scan_pass<<<dim3(wb, d.B), NT, 0, stream>>>(h0, prod, end, d);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  rglru_scan_out<T><<<dim3(wb, d.nc, d.B), NT, 0, stream>>>(
      xt, a_log, h0, end, static_cast<T*>(y), static_cast<T*>(h_last), d);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING_FN(rglru_scan)

// x (B,S,W) and y (B,S,W), h_last (B,W) of one dtype (repro::kF32 or
// repro::kBF16); a_log (B,S,W) f32; h0 (B,W) f32 or null for a zero start.
// All contiguous. L is the chunk length, 1 <= L <= S; ws is the f32
// workspace of kernels/rglru_scan.py plan(), (2, B, nc - 1, W) with nc =
// ceil(S / L): the decay products, then the end states (empty, and may be
// null, when nc is 1).
// Launches the kernels in order on `stream`; returns the first CUDA error,
// or 0.
extern "C" int rglru_scan_fwd(const void* x, const void* a_log, const void* h0, void* y,
                              void* h_last, void* ws, int B, int S, int W, int L, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || L <= 0 || L > S || B > kMaxGridYZ)
    return cudaErrorInvalidValue;
  const Dims d{B, S, W, L, (int)(((long)S + L - 1) / L)};
  if (d.nc > kMaxGridYZ || (d.nc > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(a_log);
  const float* hi = static_cast<const float*>(h0);
  float* w = static_cast<float*>(ws);
  if (dtype == repro::kF32) return launch<float>(x, al, hi, y, h_last, w, d, st);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(x, al, hi, y, h_last, w, d, st);
  return cudaErrorInvalidValue;
}
