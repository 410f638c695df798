// FmScorer forward: per-example FM scores and the s1 residual from
// gathered table rows, for Hopper (sm_90a).
//
// Replaces fast_tffm_tpu/ops/fm_pallas.py::_fwd_kernel (the Pallas kernel
// behind fm_scores_pallas).  Same function, same f32 accumulation:
//
//   rows [B, F, D] f32 (column 0 = linear weight w, columns 1.. = factors v)
//   vals [B, F]    f32 (0 marks a padded feature slot)
//   s1[b, k]   = sum_f v[b, f, k] * x[b, f]
//   s2[b, k]   = sum_f (v[b, f, k] * x[b, f])^2
//   score[b]   = sum_f w[b, f] * x[b, f] + 0.5 * sum_k (s1[b, k]^2 - s2[b, k])
//
// Outputs scores [B] and s1 [B, D-1], both f32.  Any B, F and D >= 1.
//
// Bound: memory.  The kernel reads each row element and value once,
// B*F*(4D+4) bytes (1.6 MB at B=1024, F=39, D=9: about 0.5 us at
// 3.35 TB/s), and does about B*F*(4D-2) flops, two orders of magnitude
// below the f32 rate.  At serving batch sizes the launch itself costs
// more than the bytes.  The design therefore keeps the kernel to one
// pass over the rows with no intermediate in device memory: one warp per
// example, lanes over the factor dimension k, a loop over F that keeps
// linear, s1_k and s2_k in registers, then two warp-shuffle reductions.
// The TPU kernel's [B, F*D] flattening, one-hot selection matmuls and
// three-way bf16 split exist for the TPU's 128 lanes and matrix unit and
// have no counterpart here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

__global__ void fm_scores_fwd_kernel(const float* __restrict__ rows,
                                     const float* __restrict__ vals,
                                     float* __restrict__ scores,
                                     float* __restrict__ s1_out, int B,
                                     int F, int D) {
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  // b is the same for every lane of a warp, so a warp leaves whole and
  // the full-mask shuffles below never wait on an exited lane.
  if (b >= B) return;
  const int K = D - 1;
  const float* row_b = rows + static_cast<int64_t>(b) * F * D;
  const float* val_b = vals + static_cast<int64_t>(b) * F;

  float linear = 0.0f;
  for (int f = lane; f < F; f += kWarp) {
    linear += row_b[static_cast<int64_t>(f) * D] * val_b[f];
  }

  float inter = 0.0f;  // this lane's sum over its k of s1_k^2 - s2_k
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int k = k0 + lane;
    if (k < K) {
      float s1 = 0.0f;
      float s2 = 0.0f;
      for (int f = 0; f < F; ++f) {
        const float xv = row_b[static_cast<int64_t>(f) * D + 1 + k] * val_b[f];
        s1 += xv;
        s2 += xv * xv;
      }
      s1_out[static_cast<int64_t>(b) * K + k] = s1;
      inter += s1 * s1 - s2;
    }
  }
  linear = warp_sum(linear);
  inter = warp_sum(inter);
  if (lane == 0) scores[b] = linear + 0.5f * inter;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes, types and contiguity and allocates outputs.
extern "C" int fm_scores_fwd(const void* rows, const void* vals,
                             void* scores, void* s1, int B, int F, int D,
                             void* stream) {
  if (B <= 0 || F < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fm_scores_fwd_kernel<<<blocks, kWarp * kWarpsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(vals),
      static_cast<float*>(scores), static_cast<float*>(s1), B, F, D);
  return static_cast<int>(cudaGetLastError());
}
