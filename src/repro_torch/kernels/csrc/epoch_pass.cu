// The epoch pass of the simulator's epoch-batched engine for Hopper (sm_90a):
// the FIFO wire's arrival times of one epoch slice of frames, and each
// frame's RSS queue, in int64.
//
// Replaces: src/repro/kernels/epoch_fastpath.py:108 get_epoch_pass_jax, its
// jitted _scan and _gather (:126-137); that is XLA, not Pallas, and the
// numpy pass epoch_pass_np (:72) is the reference both are bit-equal to.
//
// What it computes. Frames handed to the wire at t_i (non-decreasing), each
// on the wire for s_i ns: end_i = max(end_{i-1}, t_i) + s_i from end_{-1} =
// busy0, arrival_i = end_i + latency, busy_until = end_{n-1}; and queue_i =
// table[fid_i] where a table is given. The reference closes the recursion to
// end_i = max(busy0, max_{j<=i}(t_j - S_{j-1})) + S_i, S the prefix sum of s.
// Here a segment [a, b] of frames is the pair (S, M): S the sum of its s, M
// the largest t_j - (s_a + ... + s_{j-1}) over its frames. Two neighbouring
// segments join as (S_L + S_R, max(M_L, M_R - S_L)), which is associative
// and exact in integers, so one inclusive scan over the pairs gives every
// (S_i, M_i) from frame 0 and end_i = max(busy0, M_i) + S_i: the reference's
// own expression, term by term. Any association gives the same bits wherever
// no sum wraps past int64 (times and sums below 2^62 ns, about 146 years).
// The empty segment (0, kNone) is an identity on either side (join skips an
// M of kNone), so partial warps and tiles need no special case.
//
// Flow ids index the table as numpy does: a negative id has n_flows added
// once. An id that is still outside [0, n_flows) is not read; it writes 0
// and counts in status[1], and the wrapper raises IndexError, as numpy
// raises on table[fids].
//
// What bounds it on the H100. About 40 bytes a frame (t, s and a flow id in,
// an arrival and a queue out) plus the table, and a few integer operations:
// 2.5 MB, 0.76 us over 3.35 TB/s at the engine's epoch of about 63 000
// frames. That is below a launch, so at the engine's shapes the launches and
// the host's copies around them set the time.
//
// Design (simple first). Three phases over tiles of kTile = 2048 frames, 8
// consecutive frames a thread, 256 threads a block: epoch_pass_reduce gives
// each tile's pair (a block scan of the threads' sequential pairs);
// epoch_pass_carry, one block of 1024 threads, scans the tiles' pairs into
// each tile's carry-in (its exclusive prefix); epoch_pass_apply rescans each
// tile from its carry-in and writes the arrivals, the queues and, from the
// thread that holds frame n - 1, busy_until into status[0]. A call of one
// tile launches epoch_pass_apply alone. Block scans are warp shuffles, then
// one warp over the warps' totals. No atomics on the scan's path, so every
// call gives the same bits.
//
// Counterpart: src/repro_torch/kernels/epoch_pass.py (epoch_pass_cuda).

#include "common.cuh"

#include <climits>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads of a tile's block (epoch_pass.THREADS)
constexpr int kItems = 8;          // consecutive frames of a thread (epoch_pass.ITEMS)
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;  // the carry pass's one block
constexpr long long kNone = LLONG_MIN;  // M of the empty segment

struct Seg {
  long long s;  // the segment's serialisation ns
  long long m;  // max over its frames of t_j minus the ns before j in it
};

__device__ __forceinline__ Seg none() { return {0, kNone}; }

// Wrapping int64 arithmetic (numpy's own): no signed-overflow UB.
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

// Segment l, then segment r.
__device__ __forceinline__ Seg join(Seg l, Seg r) {
  const long long m = r.m == kNone ? l.m : max(l.m, wsub(r.m, l.s));
  return {wadd(l.s, r.s), m};
}

__device__ __forceinline__ Seg shfl_up(Seg v, int d) {
  return {__shfl_up_sync(0xffffffffu, v.s, d), __shfl_up_sync(0xffffffffu, v.m, d)};
}

// Inclusive scan of one warp's pairs, in lane order.
__device__ __forceinline__ Seg warp_inclusive(Seg v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const Seg o = shfl_up(v, d);
    if (lane >= d) v = join(o, v);
  }
  return v;
}

// The block's exclusive scan of one pair a thread, in thread order, and the
// block's total. kWarps is blockDim.x / 32, at most 32.
template <int kWarps>
__device__ __forceinline__ Seg block_exclusive(Seg v, Seg& total) {
  __shared__ long long ws[kWarps], wm[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Seg inc = warp_inclusive(v, lane);
  if (lane == 31) {
    ws[warp] = inc.s;
    wm[warp] = inc.m;
  }
  __syncthreads();
  if (warp == 0) {
    Seg w = lane < kWarps ? Seg{ws[lane], wm[lane]} : none();
    w = warp_inclusive(w, lane);
    if (lane < kWarps) {
      ws[lane] = w.s;
      wm[lane] = w.m;
    }
  }
  __syncthreads();
  total = {ws[kWarps - 1], wm[kWarps - 1]};
  Seg excl = shfl_up(inc, 1);
  if (lane == 0) excl = none();
  const Seg before = warp > 0 ? Seg{ws[warp - 1], wm[warp - 1]} : none();
  return join(before, excl);
}

// The pair of this thread's frames [i0, i0 + kItems) that lie below n.
__device__ __forceinline__ Seg thread_pair(const long long* __restrict__ handed,
                                           const long long* __restrict__ ser, long long i0,
                                           long long n) {
  Seg v = none();
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (i0 + k < n) v = join(v, Seg{__ldg(ser + i0 + k), __ldg(handed + i0 + k)});
  return v;
}

// Phase 1: each tile's pair.
__global__ void __launch_bounds__(kThreads) epoch_pass_reduce(
    const long long* __restrict__ handed, const long long* __restrict__ ser, long long n,
    long long* __restrict__ tile_s, long long* __restrict__ tile_m) {
  const long long i0 = blockIdx.x * (long long)kTile + threadIdx.x * (long long)kItems;
  Seg total;
  block_exclusive<kThreads / 32>(thread_pair(handed, ser, i0, n), total);
  if (threadIdx.x == 0) {
    tile_s[blockIdx.x] = total.s;
    tile_m[blockIdx.x] = total.m;
  }
}

// Phase 2: each tile's carry-in, the join of every tile before it; thread t
// takes tiles [t * per, (t + 1) * per) in order.
__global__ void __launch_bounds__(kScanThreads) epoch_pass_carry(
    const long long* __restrict__ tile_s, const long long* __restrict__ tile_m,
    long long tiles, long long per, long long* __restrict__ carry_s,
    long long* __restrict__ carry_m) {
  const long long lo = threadIdx.x * per, hi = min(lo + per, tiles);
  Seg v = none();
  for (long long k = lo; k < hi; ++k) v = join(v, Seg{tile_s[k], tile_m[k]});
  Seg total;
  Seg run = block_exclusive<kScanThreads / 32>(v, total);
  for (long long k = lo; k < hi; ++k) {
    carry_s[k] = run.s;
    carry_m[k] = run.m;
    run = join(run, Seg{tile_s[k], tile_m[k]});
  }
}

// Phase 3: arrivals, queues and busy_until from each tile's carry-in (none
// where carry_s is null: a call of one tile).
__global__ void __launch_bounds__(kThreads) epoch_pass_apply(
    const long long* __restrict__ handed, const long long* __restrict__ ser, long long n,
    long long busy0, long long latency, const long long* __restrict__ carry_s,
    const long long* __restrict__ carry_m, const long long* __restrict__ table,
    long long n_flows, const long long* __restrict__ fids, long long* __restrict__ arrivals,
    long long* __restrict__ queues, long long* __restrict__ status) {
  const long long i0 = blockIdx.x * (long long)kTile + threadIdx.x * (long long)kItems;
  Seg total;
  const Seg excl = block_exclusive<kThreads / 32>(thread_pair(handed, ser, i0, n), total);
  const Seg carry = carry_s ? Seg{carry_s[blockIdx.x], carry_m[blockIdx.x]} : none();
  Seg run = join(carry, excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = i0 + k;
    if (i >= n) break;
    run = join(run, Seg{__ldg(ser + i), __ldg(handed + i)});
    const long long end = wadd(max(busy0, run.m), run.s);
    arrivals[i] = wadd(end, latency);
    if (i == n - 1) status[0] = end;
    if (queues) {
      long long id = __ldg(fids + i);
      if (id < 0) id += n_flows;
      if (id >= 0 && id < n_flows) {
        queues[i] = __ldg(table + id);
      } else {
        queues[i] = 0;
        atomicAdd(reinterpret_cast<unsigned long long*>(status + 1), 1ull);
      }
    }
  }
}

}  // namespace

REPRO_ERROR_STRING_FN(epoch_pass)

// handed, ser (n,) int64, n >= 1; table (n_flows,) and fids (n,) int64, or
// both null for no steering; arrivals (n,) and queues (n,) (null with no
// table) int64 out; work, int64, of 2 + 4 * tiles words: status (busy_until,
// out-of-range flow ids), then the tiles' pairs and carry-ins. tiles is
// ceil(n / 2048) (epoch_pass.plan). All contiguous, on the current device.
// Returns cudaGetLastError(), or an error without launching for arguments
// that do not fit together.
extern "C" int epoch_pass_fwd(const void* handed, const void* ser, const void* table,
                              const void* fids, void* arrivals, void* queues, void* work,
                              long long n, long long n_flows, long long busy0,
                              long long latency, long long tiles, void* stream) {
  if (n < 1 || n_flows < 0 || tiles != (n + kTile - 1) / kTile || tiles > INT_MAX ||
      (table == nullptr) != (fids == nullptr) || (table == nullptr) != (queues == nullptr))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<long long*>(work);
  long long *tile_s = w + 2, *tile_m = tile_s + tiles, *carry_s = tile_m + tiles,
            *carry_m = carry_s + tiles;
  const auto* h = static_cast<const long long*>(handed);
  const auto* s = static_cast<const long long*>(ser);
  cudaError_t e = cudaMemsetAsync(w, 0, 2 * sizeof(long long), st);
  if (e != cudaSuccess) return e;
  if (tiles > 1) {
    epoch_pass_reduce<<<int(tiles), kThreads, 0, st>>>(h, s, n, tile_s, tile_m);
    const long long per = (tiles + kScanThreads - 1) / kScanThreads;
    epoch_pass_carry<<<1, kScanThreads, 0, st>>>(tile_s, tile_m, tiles, per, carry_s,
                                                 carry_m);
  } else {
    carry_s = carry_m = nullptr;
  }
  epoch_pass_apply<<<int(tiles), kThreads, 0, st>>>(
      h, s, n, busy0, latency, carry_s, carry_m, static_cast<const long long*>(table), n_flows,
      static_cast<const long long*>(fids), static_cast<long long*>(arrivals),
      static_cast<long long*>(queues), w);
  return cudaGetLastError();
}
