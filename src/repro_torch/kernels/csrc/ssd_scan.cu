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
// Design. One block of 256 threads per (head, batch row) walks the chunks in
// order: the Pallas kernel's sequential chunk axis becomes a loop, with the
// state h (P x N <= 64 x 128 f32, 32 KB) resident in shared memory for the
// whole walk. Per chunk: the chunk's dt is loaded and cum built by a block
// prefix sum (one step per thread, warp shuffles, then the warp totals);
// then, for each tile of 64 query rows, the carried term C . h, and for each
// tile of 64 key rows at or below it the 64 x 64 score tile C . B^T,
// weighted by exp(cum[q] - cum[k]) under the k <= q mask and applied to the
// dt-weighted x tile (the attention-like dual form, with the decay in place
// of a softmax); last, the state update over the chunk's key tiles. Tiles
// are staged in shared memory as f32 with a padded pitch (129) so that the
// column reads of C, B and h hit distinct banks. Each thread owns 4 x 4 of a
// score tile and of the y tile and 4 x 8 of the state update. All products
// are f32 FMAs, as the Pallas kernel computes in f32.
//
// What bounds it on the H100. At mamba2-1.3b's prefill (B 4, S 2048, H 64,
// P 64, N 128, chunk 256, bf16) the function must move x and y (2 x 67 MB),
// dt, B, C and the final state (2 + 2 x 2 + 8.4 MB): 149 MB, 44 us at 3.35
// TB/s. Its arithmetic, the chunked form's products over lower triangles
// only, is 26 GFLOP, 26 us at the 989 TFLOP/s bf16 tensor-core peak, so
// bytes set the floor. This kernel is far above it: it executes about 49
// GFLOP of f32 FMAs on the CUDA cores from shared memory, and its known
// loss is that C . B^T, which depends on neither the head nor the state, is
// recomputed by each of the 64 head blocks of a batch row (34 GFLOP of
// score tiles where 0.5 would do). Computing the scores once per (batch
// row, chunk) and running the products as bf16 wgmma tiles is the redesign
// toward the floor. With 134 KB of shared memory a block, one block runs
// per SM: 256 blocks are two waves on 132 SMs.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int NT = 256;   // threads: 16 x 16
constexpr int TQ = 64;    // rows of a query tile and of a key tile
constexpr int MAXQ = NT;  // chunk bound: one prefix-sum step per thread
constexpr int MAXP = 64;  // head dim bound (4 columns per thread)
constexpr int MAXN = 128; // state dim bound (8 columns per thread in the update)
constexpr int NP = MAXN + 1;  // padded pitch of the C, B and h rows

// hs [MAXP][NP], Cs [TQ][NP], Bs [TQ][NP], Xs [TQ][MAXP], Ws [TQ][TQ+1],
// cum [MAXQ], dts [MAXQ], warp totals [NT/32]
constexpr size_t kSmemFloats = (size_t)MAXP * NP + 2 * (size_t)TQ * NP + (size_t)TQ * MAXP +
                               (size_t)TQ * (TQ + 1) + 2 * MAXQ + NT / 32;

template <typename T>
__global__ void __launch_bounds__(NT) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ hout, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* Cs = hs + MAXP * NP;
  float* Bs = Cs + TQ * NP;
  float* Xs = Bs + TQ * NP;
  float* Ws = Xs + TQ * MAXP;
  float* cum = Ws + TQ * (TQ + 1);
  float* dts = cum + MAXQ;
  float* wsum = dts + MAXQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const long xrow = (long)H * P;  // stride of one step in x and y
  const long hbase = ((long)b * H + h) * P * N;

  // the state, zero outside P x N so the inner loops need no guards
  for (int i = tid; i < MAXP * NP; i += NT) {
    const int p = i / NP, n = i - p * NP;
    hs[i] = (p < P && n < N && h0 != nullptr) ? h0[hbase + (long)p * N + n] : 0.f;
  }

  // stage rows [r0, r0 + TQ) of a (B,S,N) matrix, zero past the chunk or S
  auto load_bc = [&](float* dst, const T* src, int t0, int r0, int nrows) {
    for (int i = tid; i < TQ * MAXN; i += NT) {
      const int r = i / MAXN, n = i - r * MAXN;
      const int t = t0 + r0 + r;
      dst[r * NP + n] = (r < nrows && n < N && t < S)
                            ? repro::to_f32(src[((long)b * S + t) * N + n]) : 0.f;
    }
  };
  // stage rows [r0, r0 + TQ) of x for this head, times dt and a per-row factor
  auto load_x = [&](int t0, int r0, int nrows, bool to_end, float cum_end) {
    for (int i = tid; i < TQ * MAXP; i += NT) {
      const int r = i / MAXP, p = i - r * MAXP;
      const int t = t0 + r0 + r;
      float v = 0.f;
      if (r < nrows && p < P && t < S) {
        v = repro::to_f32(x[((long)b * S + t) * xrow + (long)h * P + p]) * dts[r0 + r];
        if (to_end) v *= expf(cum_end - cum[r0 + r]);
      }
      Xs[r * MAXP + p] = v;
    }
  };

  const int n_chunks = (S + Q - 1) / Q;
  const int n_tiles = (Q + TQ - 1) / TQ;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk is done with cum, dts and the tiles

    // dt of the chunk and the inclusive prefix sum of dA = dt * A[h]
    const float d = (tid < Q && t0 + tid < S) ? dt[((long)b * S + t0 + tid) * H + h] : 0.f;
    float v = d * Ah;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int ww = 0; ww < warp; ++ww) v += wsum[ww];
    if (tid < Q) {
      cum[tid] = v;
      dts[tid] = d;
    }
    __syncthreads();
    const float cum_end = cum[Q - 1];

    // y, one tile of query rows at a time
    for (int qi = 0; qi < n_tiles; ++qi) {
      const int q0 = qi * TQ, nq = min(TQ, Q - q0);
      __syncthreads();  // Cs, Bs, Xs, Ws free
      load_bc(Cs, Cm, t0, q0, nq);
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      // carried term: exp(cum[q]) * C_q . h[p]
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float f = r < nq ? expf(cum[q0 + r]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= f;
      }

      // intra-chunk term over the key tiles at or below this query tile
      for (int ki = 0; ki <= qi; ++ki) {
        const int k0 = ki * TQ, nk = min(TQ, Q - k0);
        __syncthreads();  // Bs, Xs, Ws of the previous key tile read
        load_bc(Bs, Bm, t0, k0, nk);
        load_x(t0, k0, nk, false, 0.f);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i, q = q0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cc = tx + 16 * j, k = k0 + cc;
            const bool ok = r < nq && cc < nk && k <= q;
            Ws[r * (TQ + 1) + cc] = ok ? s[i][j] * expf(cum[q] - cum[k]) : 0.f;
          }
        }
        __syncthreads();
        for (int kk = 0; kk < nk; ++kk) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty + 16 * i) * (TQ + 1) + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[kk * MAXP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, t = t0 + q0 + r;
        if (r < nq && t < S) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            if (p < P)
              y[((long)b * S + t) * xrow + (long)h * P + p] = repro::from_f32<T>(acc[i][j]);
          }
        }
      }
    }

    // state update: h = exp(cum_end) h + sum_k exp(cum_end - cum[k]) dt_k x_k (x) B_k
    float st[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[i][j] = 0.f;
    for (int ki = 0; ki < n_tiles; ++ki) {
      const int k0 = ki * TQ, nk = min(TQ, Q - k0);
      __syncthreads();  // the y pass (and hs reads) or the previous key tile done
      load_bc(Bs, Bm, t0, k0, nk);
      load_x(t0, k0, nk, true, cum_end);
      __syncthreads();
      for (int kk = 0; kk < nk; ++kk) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[kk * MAXP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * NP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) st[i][j] = fmaf(xv[i], bv[j], st[i][j]);
      }
    }
    const float dec = expf(cum_end);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        if (p < P && n < N) hs[p * NP + n] = fmaf(dec, hs[p * NP + n], st[i][j]);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += NT) {
    const int p = i / N, n = i - p * N;
    hout[hbase + i] = hs[p * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* h0, void* y, float* hout, int Bb, int S, int H,
                   int P, int N, int Q, cudaStream_t stream) {
  static std::atomic<bool> attr_set[repro::kMaxDevices];
  const int bytes = (int)(kSmemFloats * sizeof(float));
  const cudaError_t e = repro::opt_in_smem(ssd_kernel<T>, bytes, attr_set);
  if (e != cudaSuccess) return e;
  ssd_kernel<T><<<dim3(H, Bb), NT, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      h0, static_cast<T*>(y), hout, S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING_FN(ssd_scan)

// x (B,S,H,P), Bm and Cm (B,S,N), y (B,S,H,P) of one dtype (repro::kF32 or
// repro::kBF16); dt (B,S,H), A (H,), h0 (B,H,P,N) or null, hout (B,H,P,N) f32.
// All contiguous; Q is the chunk length, at most S. Returns cudaGetLastError().
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* hout, int B, int S,
                            int H, int P, int N, int Q, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || P <= 0 || P > MAXP || N <= 0 || N > MAXN ||
      Q <= 0 || Q > MAXQ)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(hout);
  if (dtype == repro::kF32)
    return launch<float>(x, dtf, Af, Bm, Cm, h0f, y, ho, B, S, H, P, N, Q, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, h0f, y, ho, B, S, H, P, N, Q, st);
  return cudaErrorInvalidValue;
}
