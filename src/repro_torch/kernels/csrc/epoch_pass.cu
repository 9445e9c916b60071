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
// no sum wraps past int64 (times and sums below 2^62 ns, about 146 years), so
// every call gives the same bits, wherever its look-backs stop. The empty
// segment (0, kNone) is an identity on either side (join skips an M of
// kNone), so partial warps and tiles need no special case.
//
// Flow ids index the table as numpy does: a negative id has n_flows added
// once. An id that is still outside [0, n_flows) is not read; it writes 0
// and counts in status[1], and the wrapper raises IndexError, as numpy
// raises on table[fids].
//
// What bounds it on the H100. About 40 bytes a frame (t, s and a flow id in,
// an arrival and a queue out) plus the table, and a few integer operations:
// 2.5 MB, 0.76 us over 3.35 TB/s at the engine's bench epoch of 63 343
// frames. That is below a launch, so at the engine's shapes the launch, the
// chain of tiles and the host's copies around them set the time.
//
// Design: one kernel a call, one pass. Tiles of kTile = kThreads x kItems
// frames (128 x 4 = 512 unless built otherwise: the fastest at the bench
// epoch of the shapes chip_smoke.epoch_tile_sweep times, 124 tiles there,
// one wave over the 132 SMs), one block a tile. A block
//   0. takes its tile from a ticket, an atomicAdd on a counter in a workspace
//      the wrapper keeps across calls and never resets: tile = ticket - base,
//      base being the tickets issued before the call (the wrapper's count).
//      Tickets go out in the order blocks start, so a block waits only on
//      tiles whose blocks are running;
//   1. issues every load of its frames at once, each thread kItems frames as
//      16-byte words of two (8-byte loads where an array is not on a 16-byte
//      boundary), the block's threads side by side, so a warp's load is one
//      contiguous span: t, s and the flow ids into registers, then t and s
//      into shared memory;
//   2. each thread joins its kItems consecutive frames' pairs from shared
//      memory; a scan in each warp (shuffles), then each thread's join of the
//      warps' totals, gives each thread its exclusive prefix and the tile's
//      pair;
//   3. thread 0 publishes the tile's aggregate pair (tile 0 its inclusive
//      pair; the last tile's pairs have no reader, and it publishes none);
//      every thread issues the table loads of its staged frames; the block
//      then finds the carry into the tile by a decoupled look-back over
//      windows of kThreads tiles, thread x reading both slots of the window's
//      x-th tile: once every tile of the window has a pair of this call, it
//      joins, in tile order, the pairs from the window's last inclusive pair
//      on (that pair, then aggregates) and stops, or joins all the window's
//      aggregates and moves the window down (at the bench epoch every tile's
//      window reaches tile 0). Thread 0 publishes the inclusive pair
//      join(carry, aggregate);
//   4. every thread stores its queues (16-byte words where it can), and the
//      block's count of bad flow ids goes to status[1] (below);
//   5. each thread rescans its frames from join(carry, its prefix), writes
//      the arrivals into shared memory, and the block stores them as 16-byte
//      (or 8-byte) words; the thread holding frame n - 1 writes busy_until
//      into status[0].
//
// Publishing a pair. A pair is 128 bits, and each tile has two slots, an
// aggregate and an inclusive one, written at most once a call. A slot is four
// 64-bit words, each the tag of the call's tile (base + tile + 1, 32 bits) in
// its high half and 32 bits of the pair in its low half, stored with
// st.relaxed.gpu (two 2-word vectors) and loaded with ld.relaxed.gpu. Each
// 64-bit element of those accesses is single-copy atomic, so a word whose tag
// is this call's holds this call's half, and a slot whose four tags are this
// call's holds the pair its block published: no flag, no release and no fence
// on the look-back's path, and one round trip a window. That replaces a flag
// behind the pair (the pair's stores, st.release of the flag, ld.acquire or
// a fence at the reader, then the pair's loads), whose release, fence and
// second round trip lay on every look-back's path (PERF.md, Findings). A 128-bit
// access alone would not do either: the PTX memory model treats a vector
// access as separate accesses of its elements, and the pair has no room for
// a tag.
//
// Slots of earlier calls. A tag never repeats over a workspace's life: the
// wrapper makes a new, zeroed workspace before its ticket counter would pass
// 2^32 - 2 (ticket + 1 fits 32 bits and is never 0, a zeroed word's tag). So a
// word left by an earlier call, of any size, is never read as this call's, and
// no call needs a memset.
//
// The count of bad flow ids. Each block counts its own in shared memory.
// Tile 0's thread 0 stores its count into status[1] and then releases a mark,
// base + 1, in the workspace; a block with bad ids adds its count (an
// atomicAdd, the one atomic besides the ticket) once it has acquired that
// mark, so every add follows the store, and status needs no memset either.
// Only blocks with bad ids wait for it, and only on tile 0, which is running.
//
// No floating point and no atomics on the scan's values: every join is
// join(), so repeat calls are bitwise equal.
//
// Counterpart: src/repro_torch/kernels/epoch_pass.py (epoch_pass_cuda, plan).

#include "common.cuh"

#include <climits>
#include <stdint.h>

#ifndef EPOCH_PASS_THREADS
#define EPOCH_PASS_THREADS 128  // epoch_pass.THREADS
#endif
#ifndef EPOCH_PASS_ITEMS
#define EPOCH_PASS_ITEMS 4  // epoch_pass.ITEMS
#endif

namespace {

constexpr int kThreads = EPOCH_PASS_THREADS;  // threads of a tile's block
constexpr int kItems = EPOCH_PASS_ITEMS;      // consecutive frames of a thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "whole warps, at most 32");
static_assert(kItems % 2 == 0, "16-byte words of two frames");
static_assert(2 * kTile * 8 <= 48 * 1024, "t and s of a tile in static shared memory");
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
// block's total: a scan in each warp, then each thread joins the warps'
// totals itself (kWarps of them, 4 at the default shape), one barrier.
__device__ __forceinline__ Seg block_exclusive(Seg v, Seg& total) {
  __shared__ long long ws[kWarps], wm[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Seg inc = warp_inclusive(v, lane);
  if (lane == 31) {
    ws[warp] = inc.s;
    wm[warp] = inc.m;
  }
  Seg excl = shfl_up(inc, 1);
  if (lane == 0) excl = none();
  __syncthreads();
  Seg before = none();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) excl = join(before, excl);
    before = join(before, Seg{ws[w], wm[w]});
  }
  total = before;
  return excl;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Two tagged words, each a relaxed (single-copy atomic) 64-bit access. No
// "memory" clobber on the loads: a tile's four go out together.
__device__ __forceinline__ void ld_words(const unsigned long long* p, unsigned long long& a,
                                         unsigned long long& b) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p));
}
__device__ __forceinline__ void st_words(unsigned long long* p, unsigned long long a,
                                         unsigned long long b) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b)
               : "memory");
}

// A slot: a pair as four words, each its tag in the high half and 32 bits of
// the pair in the low half (S low, S high, M low, M high).
__device__ __forceinline__ unsigned long long word(unsigned tag, long long v, int half) {
  return ((unsigned long long)tag << 32) | (unsigned)((unsigned long long)v >> (32 * half));
}

__device__ __forceinline__ void publish(unsigned long long* slot, Seg v, unsigned tag) {
  st_words(slot, word(tag, v.s, 0), word(tag, v.s, 1));
  st_words(slot + 2, word(tag, v.m, 0), word(tag, v.m, 1));
}

// The pair of a slot whose four words carry tag, else false.
__device__ __forceinline__ bool unpack(const unsigned long long* w, unsigned tag, Seg& v) {
  const bool ok = (unsigned)(w[0] >> 32) == tag && (unsigned)(w[1] >> 32) == tag &&
                  (unsigned)(w[2] >> 32) == tag && (unsigned)(w[3] >> 32) == tag;
  v.s = (long long)(((w[1] & 0xffffffffull) << 32) | (w[0] & 0xffffffffull));
  v.m = (long long)(((w[3] & 0xffffffffull) << 32) | (w[2] & 0xffffffffull));
  return ok;
}

// Tile t's pair, if a slot of it carries this call's tag (its inclusive
// slot first), from one read of both slots.
__device__ __forceinline__ bool read_tile(const unsigned long long* slots, long long t,
                                          unsigned long long base, Seg& p, bool& inclusive) {
  unsigned long long w[8];
  const unsigned long long* slot = slots + 8 * t;
#pragma unroll
  for (int x = 0; x < 8; x += 2) ld_words(slot + x, w[x], w[x + 1]);
  const unsigned tag = (unsigned)(base + (unsigned long long)t + 1);
  Seg a, c;
  const bool ok_a = unpack(w, tag, a);
  inclusive = unpack(w + 4, tag, c);
  p = inclusive ? c : a;
  return ok_a || inclusive;
}

// The join of tiles [0, j) for tile j > 0, by the whole block, from the pairs
// this call's blocks published. A step reads a window of kThreads tiles
// ending at tile k, thread x tile k - kThreads + 1 + x (both slots), and reads
// again the tiles that have no pair of this call yet until every tile of the
// window has one; then it joins, in tile order, the pairs from the window's
// last inclusive pair on (that pair, then aggregates) and stops, or all the
// window's aggregates and moves the window down.
__device__ Seg look_back(const unsigned long long* slots, long long j, unsigned long long base) {
  __shared__ int s_last[kWarps];
  __shared__ long long s_ws[kWarps], s_wm[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Seg acc = none();
  for (long long k = j - 1;; k -= kThreads) {
    const long long t = k - kThreads + 1 + tid;  // this thread's tile
    Seg p = none();  // tiles below 0: the empty aggregate
    bool inclusive = false, ready = t < 0 || read_tile(slots, t, base, p, inclusive);
    while (!__syncthreads_and(ready))
      if (!ready) ready = read_tile(slots, t, base, p, inclusive);
    const unsigned b = __ballot_sync(0xffffffffu, inclusive);
    if (lane == 0) s_last[warp] = b ? warp * 32 + 31 - __clz(b) : -1;
    __syncthreads();
    int lo = -1;  // the thread of the window's last inclusive pair
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lo = max(lo, s_last[w]);
    if (tid < lo) p = none();
    const Seg v = warp_inclusive(p, lane);
    if (lane == 31) {
      s_ws[warp] = v.s;
      s_wm[warp] = v.m;
    }
    __syncthreads();
    Seg window = none();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) window = join(window, Seg{s_ws[w], s_wm[w]});
    acc = join(window, acc);
    if (lo >= 0) return acc;
  }
}

__device__ __forceinline__ long long steer(long long id, const long long* __restrict__ table,
                                           long long n_flows, unsigned& bad) {
  if (id < 0) id += n_flows;
  if (id >= 0 && id < n_flows) return __ldg(table + id);
  ++bad;
  return 0;
}

// The tile's frame that thread tid stages as its e-th: consecutive pairs of
// frames a thread (16-byte words) where vec, else single frames, the block's
// threads side by side.
__device__ __forceinline__ int staged(int tid, int e, bool vec) {
  return vec ? 2 * (tid + (e >> 1) * kThreads) + (e & 1) : tid + e * kThreads;
}

__global__ void __launch_bounds__(kThreads) epoch_pass_onepass(
    const long long* __restrict__ handed, const long long* __restrict__ ser, long long n,
    long long busy0, long long latency, const long long* __restrict__ table,
    long long n_flows, const long long* __restrict__ fids, long long* __restrict__ arrivals,
    long long* __restrict__ queues, long long* status, unsigned long long* counter,
    unsigned long long* counted, unsigned long long* slots, unsigned long long base, bool vec) {
  __shared__ __align__(16) long long sh[kTile];  // t, then the arrivals
  __shared__ __align__(16) long long ss[kTile];  // s
  __shared__ unsigned long long s_ticket;
  __shared__ unsigned s_bad;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_ticket = atomicAdd(counter, 1ull);
    s_bad = 0;
  }
  __syncthreads();
  const unsigned long long ticket = s_ticket;
  const long long tile = (long long)(ticket - base);
  const long long i0 = tile * kTile;
  const int cnt = (int)min((long long)kTile, n - i0);

  // 1. every load of the thread's staged frames at once: t, s, flow ids
  long long h[kItems], s[kItems], f[kItems];
  if (vec) {
#pragma unroll
    for (int e = 0; e < kItems; e += 2) {
      const int i = staged(tid, e, true);
      if (i + 1 < cnt) {
        const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(handed + i0 + i));
        const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(ser + i0 + i));
        h[e] = a.x, h[e + 1] = a.y, s[e] = b.x, s[e + 1] = b.y;
        if (queues) {
          const longlong2 c = __ldg(reinterpret_cast<const longlong2*>(fids + i0 + i));
          f[e] = c.x, f[e + 1] = c.y;
        }
      } else if (i < cnt) {  // an odd tail
        h[e] = __ldg(handed + i0 + i), s[e] = __ldg(ser + i0 + i);
        if (queues) f[e] = __ldg(fids + i0 + i);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = staged(tid, e, false);
      if (i < cnt) {
        h[e] = __ldg(handed + i0 + i), s[e] = __ldg(ser + i0 + i);
        if (queues) f[e] = __ldg(fids + i0 + i);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int i = staged(tid, e, vec);
    if (i < cnt) sh[i] = h[e], ss[i] = s[e];
  }
  __syncthreads();

  // 2. this thread's kItems consecutive frames, their pair, and the block scan
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = tid * kItems + k;
    if (i < cnt) h[k] = sh[i], s[k] = ss[i];
  }
  Seg v = none();
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (tid * kItems + k < cnt) v = join(v, Seg{s[k], h[k]});
  Seg total;
  const Seg excl = block_exclusive(v, total);

  // 3. thread 0 publishes the tile's aggregate (tile 0 its inclusive pair;
  //    the last tile's pairs have no reader); every thread issues the table
  //    loads of its staged frames, which land while the block looks back;
  //    thread 0 publishes the inclusive pair
  const bool last = tile + 1 == (long long)gridDim.x;
  const unsigned tag = (unsigned)(ticket + 1);
  if (tid == 0 && !last) publish(slots + 8 * tile + (tile > 0 ? 0 : 4), total, tag);
  long long q[kItems];
  unsigned bad = 0;
  if (queues) {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if (staged(tid, e, vec) < cnt) q[e] = steer(f[e], table, n_flows, bad);
  }
  const Seg carry = tile > 0 ? look_back(slots, tile, base) : none();
  if (tid == 0 && tile > 0 && !last) publish(slots + 8 * tile + 4, join(carry, total), tag);

  // 4. the queues of the staged frames
  if (queues) {
#pragma unroll
    for (int e = 0; e < kItems; e += 2) {
      const int i = staged(tid, e, vec), i1 = staged(tid, e + 1, vec);
      if (vec && i1 < cnt) {
        *reinterpret_cast<longlong2*>(queues + i0 + i) = make_longlong2(q[e], q[e + 1]);
      } else {
        if (i < cnt) queues[i0 + i] = q[e];
        if (i1 < cnt) queues[i0 + i1] = q[e + 1];
      }
    }
    if (bad) atomicAdd(&s_bad, bad);
  }
  __syncthreads();

  // 5. the count of bad flow ids: tile 0 stores its own, then marks it stored;
  //    a block with bad ids adds its count once that mark is out
  if (tid == 0) {
    if (tile == 0) {
      status[1] = (long long)s_bad;
      st_release(counted, base + 1);
    } else if (s_bad) {
      while (ld_relaxed(counted) != base + 1) __nanosleep(256);
      __threadfence();
      atomicAdd(reinterpret_cast<unsigned long long*>(status + 1), (unsigned long long)s_bad);
    }
  }

  // 6. the arrivals, through shared memory, and busy_until
  Seg run = join(carry, excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = tid * kItems + k;
    if (i < cnt) {
      run = join(run, Seg{s[k], h[k]});
      const long long end = wadd(max(busy0, run.m), run.s);
      sh[i] = wadd(end, latency);
      if (i0 + i == n - 1) status[0] = end;
    }
  }
  __syncthreads();
  if (vec) {
    auto* a2 = reinterpret_cast<longlong2*>(arrivals + i0);
    for (int w = tid; w < cnt >> 1; w += kThreads) a2[w] = reinterpret_cast<longlong2*>(sh)[w];
    if ((cnt & 1) && tid == 0) arrivals[i0 + cnt - 1] = sh[cnt - 1];
  } else {
    for (int i = tid; i < cnt; i += kThreads) arrivals[i0 + i] = sh[i];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

REPRO_ERROR_STRING_FN(epoch_pass)

// Frames a tile (epoch_pass.TILE; a card test holds the two equal).
extern "C" int epoch_pass_tile() { return kTile; }

// handed, ser (n,) int64, n >= 1; table (n_flows,) and fids (n,) int64, or
// fids null for no steering (table may be null where n_flows is 0: every id
// is then out of range); arrivals (n,) and queues (n,) (null with no fids)
// int64 out; status, 2 int64 out: busy_until, then the count of
// out-of-range flow ids. work, the workspace (epoch_pass.plan): a ticket
// counter, tile 0's mark of its stored count, 2 words for the wrapper's
// status, then 8 words a tile (its aggregate and inclusive slots) for cap
// tiles, zeroed once when made and kept across calls; base the tickets issued
// on it before this call, base + tiles below 2^32 - 1. tiles is ceil(n / kTile),
// at most cap. All on the current device. Returns cudaGetLastError(), or an
// error without launching for arguments that do not fit together.
extern "C" int epoch_pass_fwd(const void* handed, const void* ser, const void* table,
                              const void* fids, void* arrivals, void* queues, void* status,
                              void* work, long long n, long long n_flows, long long busy0,
                              long long latency, long long tiles, long long cap,
                              unsigned long long base, void* stream) {
  if (n < 1 || n_flows < 0 || tiles != (n + kTile - 1) / kTile || tiles > INT_MAX ||
      tiles > cap || base + tiles >= 0xffffffffull || status == nullptr || work == nullptr ||
      (fids == nullptr) != (queues == nullptr) ||
      (fids != nullptr && n_flows > 0 && table == nullptr))
    return cudaErrorInvalidValue;
  const bool vec = aligned16(handed) && aligned16(ser) && aligned16(arrivals) &&
                   (queues == nullptr || (aligned16(fids) && aligned16(queues)));
  auto* w = static_cast<unsigned long long*>(work);
  epoch_pass_onepass<<<int(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(handed), static_cast<const long long*>(ser), n, busy0,
      latency, static_cast<const long long*>(table), n_flows,
      static_cast<const long long*>(fids), static_cast<long long*>(arrivals),
      static_cast<long long*>(queues), static_cast<long long*>(status), w, w + 1, w + 4, base,
      vec);
  return cudaGetLastError();
}
