// Tensor-core building blocks of the bf16 attention kernels (sm_90a): async
// copies global -> shared, ldmatrix fragment loads and the mma.sync m16n8k16
// bf16 product with f32 accumulation. flash_attention.cu (the forward) and
// flash_attention_bwd.cu (the backward) both include this header.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, c = lane % 4): an
// f32 accumulator holds rows g (elements 0, 1) and g + 8 (elements 2, 3) at
// columns 2c, 2c + 1 of its 8-column tile; a quad of lanes holds a row. The
// accumulators of two adjacent 8-column tiles, packed to bf16 pairs with
// pack_bf16, are exactly the A operand of a product whose depth runs over
// those 16 columns, so a softmax computed in the accumulators feeds the next
// product without a trip through shared memory.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace repro {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in (src-size 0,
// nothing is read from src)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a . b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one register of bf16: lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two accumulators of adjacent 8-column tiles t0, t1 as an A operand
// over their 16 columns
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&t0)[4],
                                       const float (&t1)[4]) {
  a[0] = pack_bf16(t0[0], t0[1]);
  a[1] = pack_bf16(t0[2], t0[3]);
  a[2] = pack_bf16(t1[0], t1[1]);
  a[3] = pack_bf16(t1[2], t1[3]);
}

// ldmatrix row offsets (in elements, for rows of pitch P) of this lane:
//  a_off: an A fragment, 16 rows x 16 columns (rows lane % 16, columns
//    8 (lane / 16));
//  b_off: the B fragments of two 8-row n-tiles of a row-major operand used
//    as B^T, 16 columns deep (rows lane % 8 + 8 (lane / 16), columns
//    8 ((lane / 8) % 2)): regs 0, 1 the first n-tile, 2, 3 the second;
//  bt_off: with ldmatrix .trans, the B fragments of two 8-column n-tiles of
//    a row-major operand used as B, 16 rows deep (rows lane % 8 +
//    8 ((lane / 8) % 2), columns 8 (lane / 16)).
template <int P>
__device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * P + (lane >> 4) * 8;
}
template <int P>
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
}
template <int P>
__device__ __forceinline__ int bt_off(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * P + (lane >> 4) * 8;
}

}  // namespace mma
}  // namespace repro
