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
// Design. The Pallas kernel prefetches the descriptors into scalar memory and
// lets each grid step's index map DMA its row; here one block of 128 threads
// per packet reads its own descriptor, normalises it, then walks the row.
// Rows start slot_size bytes apart, and at the Ethernet frame size 1518 that
// is only 2-byte aligned, so 16-byte vector loads would need an aligned window
// and a ragged head and tail per row. This first kernel moves one byte per
// thread per step instead: a warp's 32 neighbouring bytes fall in one 32-byte
// sector, so loads and stores stay coalesced.
//
// What bounds it on the H100: the bytes, 2 * n * out_width + 8 * n (each row
// read once and written once, plus the descriptors), 0.23 us at 256 packets
// of 1518 bytes over 3.35 TB/s; a kernel launch costs several microseconds,
// so at that shape the launch, not the copy, sets the time.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int NT = 128;

__global__ void __launch_bounds__(NT) burst_gather_kernel(
    const uint8_t* __restrict__ arena, const int* __restrict__ slots,
    const int* __restrict__ lengths, uint8_t* __restrict__ out, int n_slots,
    int slot_size, int out_width) {
  const long i = blockIdx.x;
  long s = slots[i];
  if (s < 0) s += n_slots;
  s = s < 0 ? 0 : (s >= n_slots ? n_slots - 1 : s);
  const int valid = max(0, min(lengths[i], slot_size));
  const uint8_t* row = arena + s * (long)slot_size;
  uint8_t* o = out + i * (long)out_width;
  for (int j = threadIdx.x; j < out_width; j += NT) o[j] = j < valid ? row[j] : 0;
}

}  // namespace

REPRO_ERROR_STRING_FN(burst_gather)

// arena (n_slots, slot_size) uint8, slots and lengths (n,) int32, out
// (n, out_width) uint8, all contiguous; n_slots >= 1 when n >= 1.
// Returns cudaGetLastError().
extern "C" int burst_gather_fwd(const void* arena, const void* slots, const void* lengths,
                                void* out, int n, int n_slots, int slot_size, int out_width,
                                void* stream) {
  if (n < 0 || out_width < 0 || slot_size < 0 || (n > 0 && n_slots <= 0))
    return cudaErrorInvalidValue;
  if (n == 0 || out_width == 0) return cudaSuccess;
  burst_gather_kernel<<<n, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(arena), static_cast<const int*>(slots),
      static_cast<const int*>(lengths), static_cast<uint8_t*>(out), n_slots, slot_size,
      out_width);
  return cudaGetLastError();
}
