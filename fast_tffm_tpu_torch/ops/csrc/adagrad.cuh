// The Adagrad update of one table element, shared by every K2 layout:
// k2_apply (row-major [V, D], csrc/sparse_apply.cu) and the layout probe's
// transposed [D, V] and packed [V/8, 128] kernels (csrc/layout_probe.cu).
//
//   acc[pos] += g2;  table[pos] -= lr * g1 * rsqrt(acc[pos] + eps)
//
// with g1 = sum g and g2 = sum g^2 of the element's occurrences.  Every
// step is rounded to nearest on its own (no FMA contraction), so the three
// layouts give bitwise-equal elements for equal sums.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

static __device__ __forceinline__ void adagrad_at(float* __restrict__ table,
                                                  float* __restrict__ acc,
                                                  int64_t pos, float g1,
                                                  float g2, float lr,
                                                  float eps) {
  const float a = __fadd_rn(acc[pos], g2);
  acc[pos] = a;
  const float step = __fmul_rn(__fmul_rn(lr, g1), rsqrtf(__fadd_rn(a, eps)));
  table[pos] = __fsub_rn(table[pos], step);
}
