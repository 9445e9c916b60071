// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a):
// split-KV over the whole card, then a fixed-order combine.
//
// Replaces: src/repro/kernels/decode_attention.py:62 decode_attention_pallas
// (Pallas body _decode_kernel at :21, pallas_call at :112).
//
// What it computes: for each batch row b and query head h,
// out[b,h] = softmax(scale * q[b,h] . k_cache[b,:len,h/group]) . v_cache[b,:len,h/group]
// with len = cache_len[b] clamped to [0, C]. A row with len 0 gives 0. The
// order of the cache slots does not matter (softmax does not depend on key
// order), so a ring cache is read in place.
//
// What bounds it on the H100. The work is moving the valid part of the
// cache once: at recurrentgemma-9b's decode shape (B 4, C 2048 full ring, H
// 16 on Hkv 1, Dh 256, bf16) 8.4 MB of K and V, 2.5 us at 3.35 TB/s; at
// qwen3-1.7b's (B 4, C 544, H 16 on Hkv 8, Dh 128) at most 8.9 MB. The
// arithmetic, 4 Dh FLOP per valid key and query head, is far below the
// tensor cores' floor. So the kernel has to keep enough bytes in flight on
// every SM: with one block per (kv head, batch row) there are only 4 blocks
// at recurrentgemma's shape and 32 at qwen3's, each walking its whole cache.
//
// Design: two kernels, launched one after the other from one C entry point.
//
// 1. The partial pass (flash-decoding). The host plans the splits from C,
//    B, Hkv and the SM count (decode_attention.py, plan_splits): splits of
//    split_keys slots, a multiple of the 64-key tile, enough of them that
//    the grid (n_splits, Hkv, B) fills the card; the plan never reads
//    cache_len, which lives on the device. One block per (split, kv head,
//    batch row) holds the whole GQA group, so each K and V row is read from
//    device memory once for all of the group's query heads. Keys at or past
//    len are never read (cp.async zero-fills them and the score is masked);
//    a split that starts at or past len only writes an empty state. Each
//    block writes, per query head, its running max m (log2 units), its sum
//    l and its unnormalised f32 accumulator into a workspace that the
//    wrapper allocates.
//
//    bf16 with Dh a multiple of 8 (decode_attn_partial_mma): the group's
//    query heads are the 16 rows of one m16n8k16 tile (rows past the group
//    are zero), so S = Q.K^T and O += P.V are mma.sync bf16 products with f32
//    accumulation, on the helpers of mma.cuh. 4 warps; warp w owns keys
//    16w..16w+15 of each 64-key tile and moves its own K and V rows into
//    shared memory with 16-byte cp.async, double-buffered when the split
//    holds more than one tile, so the warps never wait for each other inside
//    the loop. The online softmax runs in the accumulator fragments (exp2f,
//    scale * log2(e) folded in), and P, rounded to bf16 in registers, is the
//    A operand of P.V, as in the flash forward; the row sums l are taken
//    before that rounding. Dh that is not a multiple of 16 runs with its
//    last columns zero-filled. At the end the 4 warps' states are merged
//    through shared memory, in warp order.
//
//    f32, and bf16 with Dh not a multiple of 8 (decode_attn_partial_fma):
//    the tensor cores would round f32 to TF32 and lose the 2e-5 agreement with
//    the plain version, so f32 keeps f32 FMAs. 8 warps; the 64-key tile is
//    staged in shared memory as f32 (16-byte loads for f32 rows of a
//    multiple of 4, 4-byte loads for bf16 rows of an even Dh); one thread
//    per (head, key) score, one warp per head for the softmax, and each
//    thread owns up to 16 (head, column) outputs of P.V.
//
// 2. The combine (decode_attn_combine), one thread per (b, h, column): the
//    max of the splits' m, then exp2(m_i - m) weights (in shared memory, once
//    a block), the column summed over the splits in split order, and acc / l
//    (0 when every split is empty). No atomics and a fixed order of sums for
//    a given shape and plan: calls are bitwise repeatable. Where the caller
//    asks for it, the first block of each (b, h) also writes the logsumexp of
//    the scaled scores, (m + log2 l) ln 2 in f32 (-inf when every split is
//    empty), which context-sharded decode needs to merge the slot shares of
//    several ranks; the output's bits do not depend on it.
//
// What bounds the design: each split moves one tile, so a block's time is
// mostly the latency of its first loads, its merge and its writes, and the
// combine is a second launch; the 8 MB never stream long enough to reach the
// memory rate. At the serve shapes the host's time per call exceeds both
// kernels' together (PERF.md holds the times beside the bound).

#include "common.cuh"
#include "mma.cuh"

#include <math.h>

namespace {

constexpr int kTile = 64;       // keys per tile of both bodies; splits are multiples of it
constexpr int kMaxGroup = 16;   // the wrapper's bound: one m16n8k16 tile of query heads
constexpr int kMaxDh = 256;
constexpr float kLn2 = 0.693147180559945309f;

// The workspace: acc [B][H][n_splits][Dh], then m and l [B][H][n_splits].
// The state of (b, h, split) is row ((b H + h) n_splits + split).
struct Ws {
  float* acc;
  float* m;
  float* l;
};

// A split with no key below len: m = -inf, l = 0, and no accumulator (the
// combine never reads it).
__device__ __forceinline__ void write_empty(const Ws& ws, long row0, int g, int n_splits,
                                            int tid, int nt) {
  for (int r = tid; r < g; r += nt) {
    ws.m[row0 + (long)r * n_splits] = -INFINITY;
    ws.l[row0 + (long)r * n_splits] = 0.f;
  }
}

// --------------------------------------------------------------------------
// bf16 partial pass on mma.sync
// --------------------------------------------------------------------------

namespace mmab {

using namespace repro::mma;

constexpr int W = 4;  // warps; warp w owns keys 16 w .. 16 w + 15 of each tile
constexpr int NT = 32 * W;
static_assert(16 * W == kTile, "a tile is one 16-key slice per warp");

// Shared memory: Q (16 rows), then per stage the K and V rows of every
// warp; bf16 rows padded by 16 bytes so that the 8 rows of an ldmatrix fall
// in distinct bank groups. After the loop the merge area (each warp's f32
// accumulator, m and l) overlays them.
template <int DH>
struct Shape {
  static constexpr int P = DH + 8;   // bf16 pitch
  static constexpr int AP = DH + 8;  // f32 pitch of the merge rows
  static constexpr size_t Q_BYTES = (size_t)16 * P * sizeof(bf16);
  static constexpr size_t WARP_STAGE = (size_t)2 * 16 * P;  // elements: K rows, V rows
  static constexpr size_t STAGE_BYTES = W * WARP_STAGE * sizeof(bf16);
  // the merge: each warp's rows, its m, l and weight, and each head's m, l
  static constexpr size_t MERGE_BYTES =
      ((size_t)W * 16 * AP + 3 * W * 16 + 2 * 16) * sizeof(float);
  static constexpr size_t smem(int stages) {
    return Q_BYTES + stages * STAGE_BYTES > MERGE_BYTES ? Q_BYTES + stages * STAGE_BYTES
                                                        : MERGE_BYTES;
  }
};

// DH: the instantiation's head dim, at least Dh (a multiple of 8); columns
// Dh..DH-1 are zero in shared memory and the k-steps past them are skipped.
template <int DH>
__global__ void __launch_bounds__(NT) decode_attn_partial_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ kc, const bf16* __restrict__ vc,
    const int* __restrict__ cache_len, Ws ws, int C, int H, int Hkv, int Dh, int split_keys,
    int stages, float scale_log2) {
  using S = Shape<DH>;
  constexpr int P = S::P, AP = S::AP, CH = DH / 8;  // CH: 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int g = H / Hkv, h0 = kvh * g;  // the group: query heads h0 .. h0 + g - 1
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(cache_len[b], 0), C);
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, len);
  const long row0 = ((long)b * H + h0) * n_splits + split;
  if (k_begin >= k_end) {
    write_empty(ws, row0, g, n_splits, tid, NT);
    return;
  }

  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + 16 * P;
  const int dch = Dh / 8;  // chunks that hold data
  const long kv_row = (long)Hkv * Dh;
  const bf16* qb = q + ((long)b * H + h0) * Dh;
  const bf16* kb = kc + (long)b * C * kv_row + (long)kvh * Dh;
  const bf16* vb = vc + (long)b * C * kv_row + (long)kvh * Dh;

  for (int i = tid; i < 16 * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r < g && c < dch;
    cp_async16(Qs + r * P + c * 8, in ? qb + r * Dh + c * 8 : qb, in);
  }
  cp_async_commit();  // Q

  // the warp's 16-key slices: keys wk0 + t 16 W .. + 15, below k_end
  const int wk0 = k_begin + 16 * warp;
  const int n_sub = wk0 < k_end ? (k_end - wk0 + kTile - 1) / kTile : 0;
  auto rows = [&](int s) { return KV + ((size_t)s * W + warp) * S::WARP_STAGE; };
  auto load = [&](int t, int s) {
    const int k0 = wk0 + t * kTile;
    bf16* Ks = rows(s);
    bf16* Vs = Ks + 16 * P;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < k_end && c < dch;
      const long off = (long)(k0 + r) * kv_row + c * 8;
      cp_async16(Ks + r * P + c * 8, in ? kb + off : kb, in);
      cp_async16(Vs + r * P + c * 8, in ? vb + off : vb, in);
    }
  };
  if (n_sub > 0) load(0, 0);
  cp_async_commit();  // the first slice (an empty group when there is none)
  cp_async_wait<1>();
  __syncthreads();  // Q visible to every warp

  const int gq = lane >> 2, cq = lane & 3;
  // ldmatrix row addresses of this lane: Q's A fragment, K's B fragments of
  // the slice's two 8-key n-tiles, V's transposed B fragments
  const uint32_t q_addr = smem_u32(Qs + a_off<P>(lane));
  const int k_off = b_off<P>(lane), v_off = bt_off<P>(lane);

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows gq, gq + 8, log2 units
  float l_r[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int t = 0; t < n_sub; ++t) {
    const int s = stages == 2 ? (t & 1) : 0;
    if (stages == 2 && t + 1 < n_sub) {
      load(t + 1, s ^ 1);  // its stage was last read in slice t - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // the slice's rows, copied by every lane, visible to the warp
    const bf16* Ks = rows(s);
    const uint32_t k_addr = smem_u32(Ks + k_off), v_addr = smem_u32(Ks + 16 * P + v_off);

    // S = Q . K^T: 16 heads x 16 keys
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      if (kk * 16 < Dh) {
        uint32_t a[4], bk[4];
        ldmatrix_x4(a, q_addr + kk * 32);
        ldmatrix_x4(bk, k_addr + kk * 32);
        mma_bf16(sc[0], a, bk[0], bk[1]);
        mma_bf16(sc[1], a, bk[2], bk[3]);
      }
    }

    // log2 units; keys at or past k_end masked (only in the last slice)
    const int k0 = wk0 + t * kTile;
    const bool need_mask = k0 + 16 > k_end;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (need_mask && k0 + j * 8 + 2 * cq + (e & 1) >= k_end) x = -INFINITY;
        sc[j][e] = x;
      }

    // online softmax: the row max across the quad of lanes, then rescale
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_use[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = exp2f(m_r[i] - m_use[i]);
      m_r[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - m_use[e >> 1]);
        rs[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rs[i];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P . V, P rounded to bf16 in registers as the A operand
    uint32_t pa[4];
    pack_a(pa, sc[0], sc[1]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      if (dp * 16 < Dh) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_addr + dp * 32);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncwarp();  // every lane done with this stage before it is refilled
    if (stages == 1 && t + 1 < n_sub) {
      load(t + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp done with Q and its rows: the merge area overlays them

  // merge the W warps' states in warp order; warp w's rows at Acc + w 16 AP
  float* Acc = reinterpret_cast<float*>(smem_raw);
  float* Ms = Acc + W * 16 * AP;
  float* Ls = Ms + W * 16;
  float* Fs = Ls + W * 16;  // each warp's weight exp2(m_w - m) per head
  float* Mh = Fs + W * 16;  // each head's merged m and l
  float* Lh = Mh + 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    if (cq == 0) {
      Ms[warp * 16 + gq + 8 * i] = m_r[i];
      Ls[warp * 16 + gq + 8 * i] = l_r[i];
    }
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(Acc + (warp * 16 + gq + 8 * i) * AP + j * 8 + 2 * cq) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  __syncthreads();
  if (tid < 16) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) m = fmaxf(m, Ms[w * 16 + tid]);
    float den = 0.f;  // m is finite: warp 0 holds key k_begin < k_end
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = exp2f(Ms[w * 16 + tid] - m);  // a warp with no key: 0
      Fs[w * 16 + tid] = f;
      den = fmaf(f, Ls[w * 16 + tid], den);
    }
    Mh[tid] = m;
    Lh[tid] = den;
  }
  __syncthreads();
  for (int i = tid; i < g * Dh; i += NT) {
    const int r = i / Dh, d = i - r * Dh;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) num = fmaf(Fs[w * 16 + r], Acc[(w * 16 + r) * AP + d], num);
    const long row = row0 + (long)r * n_splits;
    ws.acc[row * Dh + d] = num;
    if (d == 0) {
      ws.m[row] = Mh[r];
      ws.l[row] = Lh[r];
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* len, Ws ws,
                   int B, int C, int H, int Hkv, int Dh, int split_keys, int n_splits,
                   float scale_log2, cudaStream_t st) {
  using S = Shape<DH>;
  static std::atomic<bool> attr_set[repro::kMaxDevices];
  const cudaError_t e = repro::opt_in_smem(decode_attn_partial_mma<DH>, (int)S::smem(2), attr_set);
  if (e != cudaSuccess) return e;
  const int stages = split_keys > kTile ? 2 : 1;  // a one-tile split has nothing to prefetch
  decode_attn_partial_mma<DH><<<dim3(n_splits, Hkv, B), NT, S::smem(stages), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      len, ws, C, H, Hkv, Dh, split_keys, stages, scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* kc, const void* vc, const int* len, Ws ws,
                     int B, int C, int H, int Hkv, int Dh, int split_keys, int n_splits,
                     float scale_log2, cudaStream_t st) {
  if (Dh <= 32)
    return launch<32>(q, kc, vc, len, ws, B, C, H, Hkv, Dh, split_keys, n_splits, scale_log2, st);
  if (Dh <= 64)
    return launch<64>(q, kc, vc, len, ws, B, C, H, Hkv, Dh, split_keys, n_splits, scale_log2, st);
  if (Dh <= 128)
    return launch<128>(q, kc, vc, len, ws, B, C, H, Hkv, Dh, split_keys, n_splits, scale_log2,
                       st);
  return launch<256>(q, kc, vc, len, ws, B, C, H, Hkv, Dh, split_keys, n_splits, scale_log2, st);
}

}  // namespace mmab

// --------------------------------------------------------------------------
// f32 FMA partial pass (f32, and bf16 at a Dh that is not a multiple of 8)
// --------------------------------------------------------------------------

namespace fmab {

constexpr int NW = 8;
constexpr int NT = 32 * NW;
constexpr int BK = kTile;
constexpr int NO = kMaxGroup * kMaxDh / NT;  // (head, column) outputs a thread owns, at most
static_assert(BK == 64, "the softmax gives each lane two keys of a tile");

size_t smem_bytes(int g, int dh) {
  return sizeof(float) * ((size_t)g * dh + (size_t)BK * (dh + 1) + (size_t)BK * dh +
                          (size_t)g * BK + 3 * (size_t)g);
}

// VEC elements of a row to f32: one 16-byte load for 4 floats, one 4-byte
// load for 2 bf16
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else {
    out[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT) decode_attn_partial_fma(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ cache_len, Ws ws, int C, int H, int Hkv, int Dh, int split_keys,
    float scale_log2) {
  extern __shared__ float sm[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int g = H / Hkv, h0 = kvh * g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(cache_len[b], 0), C);
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, len);
  const long row0 = ((long)b * H + h0) * n_splits + split;
  if (k_begin >= k_end) {
    write_empty(ws, row0, g, n_splits, tid, NT);
    return;
  }

  const int kp = Dh + 1;  // padded pitch of the K rows
  float* Qs = sm;              // g x Dh
  float* Ks = Qs + g * Dh;     // BK x kp
  float* Vs = Ks + BK * kp;    // BK x Dh
  float* Ps = Vs + BK * Dh;    // g x BK: scores, then probabilities
  float* Ms = Ps + g * BK;     // g: running max, log2 units
  float* Ls = Ms + g;          // g: running sum
  float* As = Ls + g;          // g: this tile's rescale factor

  const long kv_row = (long)Hkv * Dh;
  const T* qb = q + ((long)b * H + h0) * Dh;
  const T* kb = kc + (long)b * C * kv_row + (long)kvh * Dh;
  const T* vb = vc + (long)b * C * kv_row + (long)kvh * Dh;
  for (int i = tid; i < g * Dh; i += NT) Qs[i] = repro::to_f32(qb[i]);
  for (int r = tid; r < g; r += NT) {
    Ms[r] = -INFINITY;
    Ls[r] = 0.f;
  }

  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;

  const int nv = Dh / VEC;  // vectors of a row
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, k_end - k0);
    __syncthreads();  // Qs, Ms, Ls written; the previous tile's Ks, Vs, Ps, As read
    for (int i = tid; i < nk * nv; i += NT) {
      const int r = i / nv, c = (i - r * nv) * VEC;
      const long off = (long)(k0 + r) * kv_row + c;
      float kx[VEC], vx[VEC];
      load_f32<VEC>(kb + off, kx);
      load_f32<VEC>(vb + off, vx);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * kp + c + e] = kx[e];
        Vs[r * Dh + c + e] = vx[e];
      }
    }
    __syncthreads();
    // scores in log2 units, one thread a (head, key); keys past nk masked
    for (int i = tid; i < g * BK; i += NT) {
      const int r = i / BK, k = i - r * BK;
      float s = -INFINITY;
      if (k < nk) {
        const float* qr = Qs + r * Dh;
        const float* kr = Ks + k * kp;
        float dot = 0.f;
#pragma unroll 4
        for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale_log2;
      }
      Ps[i] = s;
    }
    __syncthreads();
    // online softmax, one warp a head, two keys a lane
    for (int r = warp; r < g; r += NW) {
      const float s0 = Ps[r * BK + lane], s1 = Ps[r * BK + 32 + lane];
      const float m_old = Ms[r];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f(s0 - m_use), p1 = exp2f(s1 - m_use);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r * BK + lane] = p0;
      Ps[r * BK + 32 + lane] = p1;
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + sum;
        As[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc alpha + P . V, one thread a (head, column) output
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int i = tid + j * NT;
      if (i < g * Dh) {
        const int r = i / Dh, d = i - r * Dh;
        const float* pr = Ps + r * BK;
        float a = acc[j] * As[r];
        for (int k = 0; k < nk; ++k) a = fmaf(pr[k], Vs[k * Dh + d], a);
        acc[j] = a;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int i = tid + j * NT;
    if (i < g * Dh) {
      const int r = i / Dh, d = i - r * Dh;
      const long row = row0 + (long)r * n_splits;
      ws.acc[row * Dh + d] = acc[j];
      if (d == 0) {
        ws.m[row] = Ms[r];
        ws.l[row] = Ls[r];
      }
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* len, Ws ws,
                   int B, int C, int H, int Hkv, int Dh, int split_keys, int n_splits,
                   float scale_log2, cudaStream_t st) {
  static std::atomic<bool> attr_set[repro::kMaxDevices];
  const cudaError_t e = repro::opt_in_smem(decode_attn_partial_fma<T, VEC>,
                                           (int)smem_bytes(kMaxGroup, kMaxDh), attr_set);
  if (e != cudaSuccess) return e;
  decode_attn_partial_fma<T, VEC><<<dim3(n_splits, Hkv, B), NT, smem_bytes(H / Hkv, Dh), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), len, ws,
      C, H, Hkv, Dh, split_keys, scale_log2);
  return cudaGetLastError();
}

// the widest load the rows allow: every row offset is a multiple of Dh
// elements, so Dh and the cache's base address decide it
template <typename T, int VEC>
bool vec_ok(const void* kc, const void* vc, int Dh) {
  const uintptr_t bytes = VEC * sizeof(T);
  return Dh % VEC == 0 && reinterpret_cast<uintptr_t>(kc) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(vc) % bytes == 0;
}

template <typename T, int VEC>
cudaError_t dispatch(const void* q, const void* kc, const void* vc, const int* len, Ws ws,
                     int B, int C, int H, int Hkv, int Dh, int split_keys, int n_splits,
                     float scale_log2, cudaStream_t st) {
  if (vec_ok<T, VEC>(kc, vc, Dh))
    return launch<T, VEC>(q, kc, vc, len, ws, B, C, H, Hkv, Dh, split_keys, n_splits,
                          scale_log2, st);
  return launch<T, 1>(q, kc, vc, len, ws, B, C, H, Hkv, Dh, split_keys, n_splits, scale_log2,
                      st);
}

}  // namespace fmab

// --------------------------------------------------------------------------
// combine
// --------------------------------------------------------------------------

constexpr int kCombineThreads = 64;
constexpr int kMaxSplits = 12288;  // the combine's weights, in 48 KB of shared memory

// The block's max (order-free) and sum (a fixed tree: lanes, then warps in
// order) of one value a thread; every thread gets the result.
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w) x = fmaxf(x, red[w]);
  __syncthreads();  // red is reused
  return x;
}
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w) x += red[w];
  __syncthreads();
  return x;
}

// One block per (64 columns, head, batch row). The splits' weights
// exp2(m_i - m), 0 for an empty split, go to shared memory once; each thread
// then sums its column over the splits in split order, its loads independent
// of each other so that many are in flight. lse (B, H) f32, or null: the
// logsumexp of the row's scaled scores, from the block of the first columns.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads) decode_attn_combine(
    const float* __restrict__ acc, const float* __restrict__ ms, const float* __restrict__ ls,
    T* __restrict__ o, float* __restrict__ lse, int H, int Dh, int n_splits) {
  extern __shared__ float wts[];  // n_splits
  __shared__ float red[kCombineThreads / 32];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kCombineThreads + tid, h = blockIdx.y, b = blockIdx.z;
  const long row0 = ((long)b * H + h) * n_splits;
  float m = -INFINITY;
  for (int i = tid; i < n_splits; i += kCombineThreads) m = fmaxf(m, ms[row0 + i]);
  m = block_max(m, red);
  float den = 0.f;
  for (int i = tid; i < n_splits; i += kCombineThreads) {
    const float mi = ms[row0 + i];
    const float f = mi == -INFINITY ? 0.f : exp2f(mi - m);  // every split empty: all 0
    wts[i] = f;
    den = fmaf(f, ls[row0 + i], den);
  }
  den = block_sum(den, red);  // its barriers also publish wts
  if (lse != nullptr && blockIdx.x == 0 && tid == 0)  // m in log2 units; len 0 → -inf
    lse[(long)b * H + h] = den > 0.f ? (m + log2f(den)) * kLn2 : -INFINITY;
  if (d >= Dh) return;
  const float* a = acc + row0 * Dh + d;
  float num = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_splits; ++i) {
    const float f = wts[i], x = a[(long)i * Dh];
    num = fmaf(f, f != 0.f ? x : 0.f, num);  // an empty split's accumulator is never written
  }
  o[((long)b * H + h) * Dh + d] = repro::from_f32<T>(den > 0.f ? num / den : 0.f);  // len 0 → 0
}

template <typename T>
cudaError_t combine(Ws ws, void* o, float* lse, int B, int H, int Dh, int n_splits,
                    cudaStream_t st) {
  const dim3 grid((Dh + kCombineThreads - 1) / kCombineThreads, H, B);
  decode_attn_combine<T><<<grid, kCombineThreads, n_splits * sizeof(float), st>>>(
      ws.acc, ws.m, ws.l, static_cast<T*>(o), lse, H, Dh, n_splits);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING_FN(decode_attention)

// q (B,H,Dh), k_cache and v_cache (B,C,Hkv,Dh), o (B,H,Dh), all contiguous and
// of one dtype (repro::kF32 or repro::kBF16); cache_len (B,) int32 on the card;
// lse (B,H) f32 for the rows' logsumexp, or null for none;
// ws f32, B H n_splits (Dh + 2) elements. The plan: splits of split_keys
// slots (a multiple of 64), n_splits = ceil(C / split_keys) (1 when C is 0,
// at most 12288). bf16 with Dh a multiple of 8 runs the mma.sync body and
// needs q and the caches on 16-byte boundaries; everything else runs the FMA
// body. Launches the partial pass and the combine on `stream`; returns the
// first cudaGetLastError() that is not cudaSuccess.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* cache_len, void* o, void* ws, int B, int C,
                                    int H, int Hkv, int Dh, int split_keys, int n_splits,
                                    float scale, int dtype, void* stream, void* lse) {
  if (Dh <= 0 || Dh > kMaxDh || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || B <= 0 ||
      C < 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (split_keys <= 0 || split_keys % kTile != 0 || n_splits > kMaxSplits ||
      n_splits != (C > 0 ? (int)(((long)C + split_keys - 1) / split_keys) : 1))
    return cudaErrorInvalidValue;
  const bool mma = dtype == repro::kBF16 && Dh % 8 == 0;
  if (mma && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kc) |
               reinterpret_cast<uintptr_t>(vc)) & 15) != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(cache_len);
  float* w = static_cast<float*>(ws);
  float* lse_out = static_cast<float*>(lse);
  const long rows = (long)B * H * n_splits;
  const Ws s{w, w + rows * Dh, w + rows * Dh + rows};
  const float scale_log2 = scale * repro::mma::kLog2e;
  cudaError_t e;
  if (dtype == repro::kF32) {
    e = fmab::dispatch<float, 4>(q, kc, vc, len, s, B, C, H, Hkv, Dh, split_keys, n_splits,
                                 scale_log2, st);
    return e != cudaSuccess ? e : combine<float>(s, o, lse_out, B, H, Dh, n_splits, st);
  }
  if (dtype == repro::kBF16) {
    e = mma ? mmab::dispatch(q, kc, vc, len, s, B, C, H, Hkv, Dh, split_keys, n_splits,
                             scale_log2, st)
            : fmab::dispatch<__nv_bfloat16, 2>(q, kc, vc, len, s, B, C, H, Hkv, Dh, split_keys,
                                               n_splits, scale_log2, st);
    return e != cudaSuccess ? e : combine<__nv_bfloat16>(s, o, lse_out, B, H, Dh, n_splits, st);
  }
  return cudaErrorInvalidValue;
}
