// Descriptor-driven packet gather for Hopper (sm_90a): packets scattered over
// a uint8 arena become one dense (n, out_width) batch.
//
// Replaces: src/repro/kernels/burst_gather.py:34 burst_gather_pallas (Pallas
// body _gather_kernel at :25, pallas_call at :60).
//
// What it computes: out[i, j] = arena[slot(i), j] for j < min(lengths[i],
// slot_size), else 0, for j < out_width; a row wider than the arena's slots is
// zero-padded. slot(i) is slots[i] normalised as JAX indexing does it (the
// reference gathers with arena[slots]): a negative index has n_slots added
// once, then the index is clamped to [0, n_slots - 1]. So no descriptor can
// read outside the arena. A negative length gives a zero row, a length past
// out_width the whole row.
//
// What bounds it on the H100. The bytes are each packet's valid bytes read,
// each output row written and the descriptors read: about 2316 bytes a
// packet at lengths 64-1517 and out_width 1518, 0.18 us at a burst of 256
// over 3.35 TB/s and 2.8 us at 4096. Up to about a thousand packets a call
// is shorter than the launch and two memory round trips (descriptor, then
// data), so those set the time; at 4096 the instructions a chunk takes and
// then the bytes do.
//
// Design. The first kernel gave each packet a block of 128 threads that
// walked its row a byte at a time, a one-byte store per step. Here the grid
// is flat over the output's 16-byte chunks: thread c owns the flat output
// bytes [16c, 16c + 16), issues every load of its chunk at once, and writes
// them with one aligned 16-byte store (the output comes from the caching
// allocator; the entry point refuses one off a 16-byte boundary). The last
// chunk is partial when n * out_width is not a multiple of 16 and is stored
// byte by byte. Rows start slot_size bytes apart (only 2-byte aligned at
// 1518) and the arena may be a view that starts anywhere, so the source
// side assumes no alignment: each of the chunk's positions that a row's
// valid bytes cover is one byte load, at an immediate offset from one base
// address and predicated on the count of valid bytes, and every other
// position is 0 without a load. So only valid bytes are read, never a byte
// past the arena. A warp's 32 chunks of one row are 512 neighbouring bytes,
// so its byte loads fall in the same few sectors, which the L1 serves.
// Measured on an H100 at bursts of 32 to 4096 packets, aligned 4-byte words
// lined up with funnel shifts (bytes at the edges of the valid bytes) were
// slower than the per-packet kernel at every burst up to 1024, and a
// branch-free form of them twice as slow at 4096: they cost more
// instructions than they save loads. A chunk that straddles rows (out_width
// not a multiple of 16) takes each row's part with that row's own
// descriptor. Where out_width >= 16 a chunk touches at most two rows, and a
// thread loads both descriptors, then every byte of both rows into separate
// registers, before it uses any: a version that walked the rows one after
// another put two descriptor-then-data round trips in series on each
// straddling thread, and the warps that held one set the time. Where
// out_width < 16 (up to 16 rows a chunk) the same kernel walks the rows in
// turn instead, a branch that every thread of a call takes the same way. The
// grid (chunks, the partial tail, blocks) is planned on the host from the
// shapes alone (burst_gather.plan); each chunk divides by out_width once, in
// 32 bits where n * out_width < 2^32, else in 64.
//
// Counterpart: src/repro_torch/kernels/burst_gather.py (burst_gather_cuda;
// the JAX function is src/repro/kernels/burst_gather.py:34).

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kChunk = 16;     // output bytes of a thread
constexpr int kThreads = 128;  // threads of a block (burst_gather.THREADS)

// Row i's descriptor: the address of its slot and its valid bytes.
__device__ __forceinline__ void descriptor(const uint8_t* arena, const int* slots,
                                           const int* lengths, long long i, int n_slots,
                                           int slot_size, int width, uintptr_t& row,
                                           int& valid) {
  long long s = __ldg(slots + i);
  if (s < 0) s += n_slots;
  s = s < 0 ? 0 : (s >= n_slots ? n_slots - 1 : s);
  valid = max(0, min(__ldg(lengths + i), width));
  row = reinterpret_cast<uintptr_t>(arena) + uintptr_t(s) * slot_size;
}

// Chunk c's length (16, or the tail's), and the row and column of its first
// byte: one division by out_width, in 32 bits where the flat indices fit.
__device__ __forceinline__ int locate(long long c, long long n_chunks, int tail, int out_width,
                                      long long& i, int& j) {
  const long long start = c * kChunk;
  if (n_chunks <= (1LL << 32) / kChunk) {
    const unsigned st = unsigned(start), w = unsigned(out_width), r = st / w;
    i = r;
    j = int(st - r * w);
  } else {
    i = start / out_width;
    j = int(start - i * out_width);
  }
  return (c == n_chunks - 1 && tail) ? tail : kChunk;
}

// The chunk's 16 bytes, one in the low byte of each b[p], packed into four
// words before the store (so that the byte registers die first): one
// 16-byte store, or bytes for a partial last chunk.
__device__ __forceinline__ void store(uint8_t* out, long long c, int len,
                                      const uint32_t b[kChunk]) {
  uint32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = b[4 * k] | (b[4 * k + 1] << 8) | (b[4 * k + 2] << 16) | (b[4 * k + 3] << 24);
  uint8_t* o = out + c * kChunk;
  if (len == kChunk) {
    *reinterpret_cast<uint4*>(o) = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int p = 0; p < kChunk; ++p)
      if (p < len) o[p] = uint8_t(q[p >> 2] >> (8 * (p & 3)));
  }
}

// out_width >= 16: a chunk touches at most two rows. Both descriptors, then
// every byte load of both rows into separate registers, before any use.
// Position p < m comes from row i at src0 + p, for the r0 valid ones;
// position p >= m from row i + 1 at src1 + p, for the r1 valid ones. Each
// load is at an immediate offset from its row's base and predicated.
__device__ __forceinline__ void two_rows(const uint8_t* arena, const int* slots,
                                         const int* lengths, long long i, int j, int len,
                                         int n_slots, int slot_size, int out_width,
                                         uint32_t b[kChunk]) {
  const int width = min(slot_size, out_width);
  const int m = min(len, out_width - j);  // the chunk's bytes in row i
  uintptr_t row, row1 = 0;
  int valid, valid1 = 0;
  descriptor(arena, slots, lengths, i, n_slots, slot_size, width, row, valid);
  if (m < len) descriptor(arena, slots, lengths, i + 1, n_slots, slot_size, width, row1, valid1);
  const uintptr_t src0 = row + j, src1 = row1 - m;
  const int r0 = min(m, max(0, valid - j));
  const uint8_t* a0 = reinterpret_cast<const uint8_t*>(src0);
  uint32_t b1[kChunk];
#pragma unroll
  for (int p = 0; p < kChunk; ++p) b[p] = p < r0 ? uint32_t(__ldg(a0 + p)) : 0u;
#pragma unroll
  for (int p = 0; p < kChunk; ++p) b1[p] = 0u;
  if (m < len) {
    const int r1 = min(len - m, valid1);
    const uint8_t* a1 = reinterpret_cast<const uint8_t*>(src1);
#pragma unroll
    for (int p = 0; p < kChunk; ++p)
      if (unsigned(p - m) < unsigned(r1)) b1[p] = __ldg(a1 + p);
  }
#pragma unroll
  for (int p = 0; p < kChunk; ++p) b[p] |= b1[p];
}

// out_width < 16: up to 16 rows a chunk, one after another. Row i gives
// positions [p, p + m), the first r of them valid, from src + q for
// position q.
__device__ __forceinline__ void rows_in_turn(const uint8_t* arena, const int* slots,
                                             const int* lengths, long long i, int j, int len,
                                             int n_slots, int slot_size, int out_width,
                                             uint32_t b[kChunk]) {
  const int width = min(slot_size, out_width);
#pragma unroll
  for (int q = 0; q < kChunk; ++q) b[q] = 0u;
  for (int p = 0; p < len; ++i, j = 0) {
    const int m = min(len - p, out_width - j);  // the chunk's bytes in row i
    uintptr_t row;
    int valid;
    descriptor(arena, slots, lengths, i, n_slots, slot_size, width, row, valid);
    const int r = min(m, max(0, valid - j));
    const uint8_t* src = reinterpret_cast<const uint8_t*>(row + j - p);
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (unsigned(q - p) < unsigned(r)) b[q] = __ldg(src + q);
    p += m;
  }
}

// One thread a chunk; the branch on out_width is the same for every thread.
__global__ void __launch_bounds__(kThreads) burst_gather_kernel(
    const uint8_t* __restrict__ arena, const int* __restrict__ slots,
    const int* __restrict__ lengths, uint8_t* __restrict__ out, long long n_chunks,
    int tail, int n_slots, int slot_size, int out_width) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  long long i;
  int j;
  const int len = locate(c, n_chunks, tail, out_width, i, j);
  uint32_t b[kChunk];
  if (out_width >= kChunk)
    two_rows(arena, slots, lengths, i, j, len, n_slots, slot_size, out_width, b);
  else
    rows_in_turn(arena, slots, lengths, i, j, len, n_slots, slot_size, out_width, b);
  store(out, c, len, b);
}

}  // namespace

REPRO_ERROR_STRING_FN(burst_gather)

// arena (n_slots, slot_size) uint8, slots and lengths (n,) int32, out
// (n, out_width) uint8 on a 16-byte boundary, all contiguous; n_slots >= 1
// when n >= 1. The plan (burst_gather.plan): n_chunks = ceil(n * out_width /
// 16) chunks, the last of `tail` bytes (0: a whole chunk), in `grid` blocks
// of `threads`. Returns cudaGetLastError(), or an error without launching
// for arguments that do not fit together.
extern "C" int burst_gather_fwd(const void* arena, const void* slots, const void* lengths,
                                void* out, int n, int n_slots, int slot_size, int out_width,
                                long long n_chunks, int tail, int grid, int threads,
                                void* stream) {
  if (n < 0 || out_width < 0 || slot_size < 0 || (n > 0 && n_slots <= 0))
    return cudaErrorInvalidValue;
  const long long total = (long long)n * out_width;
  if (n_chunks != (total + kChunk - 1) / kChunk || tail != int(total % kChunk) ||
      threads < 1 || threads > kThreads || (long long)grid * threads < n_chunks)
    return cudaErrorInvalidValue;
  if (n_chunks == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(out) % kChunk) return cudaErrorMisalignedAddress;
  const auto* a = static_cast<const uint8_t*>(arena);
  const auto* s = static_cast<const int*>(slots);
  const auto* l = static_cast<const int*>(lengths);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  burst_gather_kernel<<<grid, threads, 0, st>>>(a, s, l, o, n_chunks, tail, n_slots,
                                                slot_size, out_width);
  return cudaGetLastError();
}
