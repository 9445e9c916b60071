// The RG-LRU recurrence's one step, shared by the forward (rglru_scan.cu) and
// the backward (rglru_scan_bwd.cu), which recomputes the forward's f32 states:
// one definition, so that no contraction or fast-math variant can differ
// between them.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// h_t = a h_{t-1} + sqrt(max(1 - a^2, 1e-12)) x, from a = exp(a_log).
__device__ __forceinline__ float rglru_step(float h, float a, float x) {
  const float g = sqrtf(fmaxf(fmaf(-a, a, 1.f), 1e-12f));
  return fmaf(a, h, __fmul_rn(g, x));
}

}  // namespace repro
