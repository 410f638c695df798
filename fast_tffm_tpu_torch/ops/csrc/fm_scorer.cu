// FmScorer forward: per-example FM scores and the s1 residual from
// gathered table rows, for Hopper (sm_90a).
//
// Replaces fast_tffm_tpu/ops/fm_pallas.py::_fwd_kernel (the Pallas kernel
// behind fm_scores_pallas), in both of its modes.  Same function, same f32
// accumulation:
//
//   rows [B, F, D] f32 or bf16 (column 0 = linear weight w, columns 1.. = v)
//   vals [B, F]    the rows' type (0 marks a padded feature slot)
//   s1[b, k]   = sum_f v[b, f, k] * x[b, f]
//   s2[b, k]   = sum_f (v[b, f, k] * x[b, f])^2
//   score[b]   = sum_f w[b, f] * x[b, f] + 0.5 * sum_k (s1[b, k]^2 - s2[b, k])
//
// Outputs scores [B] and s1 [B, D-1], both f32 in both modes.  Any B, F
// and D >= 1.  The bf16 mode (fm_scores_fwd_bf16, the reference's
// compute_dtype = bfloat16 training) widens each element with
// __bfloat162float as it is loaded and computes as the f32 mode does,
// as the Pallas kernel upcasts its bf16 blocks; only the stored rows
// and values were rounded.
//
// Bound: memory.  The kernel reads each row element and value once,
// B*F*(4D+4) bytes in f32 (1.6 MB at B=1024, F=39, D=9: about 0.5 us at
// 3.35 TB/s) and B*F*(2D+2) in bf16 (3.2 MB at B=4096), and does about
// B*F*(4D-2) flops, two orders of magnitude below the f32 rate.  At
// serving batch sizes the launch itself costs more than the bytes.  The
// design therefore keeps the kernel to one pass over the rows with no
// intermediate in device memory: one warp per example, lanes over the
// factor dimension k, a loop over F that keeps linear, s1_k and s2_k in
// registers, then two warp-shuffle reductions.  The TPU kernel's
// [B, F*D] flattening, one-hot selection matmuls and three-way bf16 split
// exist for the TPU's 128 lanes and matrix unit and have no counterpart
// here.

#include <cuda_bf16.h>
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

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void fm_scores_fwd_kernel(const T* __restrict__ rows,
                                     const T* __restrict__ vals,
                                     float* __restrict__ scores,
                                     float* __restrict__ s1_out, int B,
                                     int F, int D) {
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  // b is the same for every lane of a warp, so a warp leaves whole and
  // the full-mask shuffles below never wait on an exited lane.
  if (b >= B) return;
  const int K = D - 1;
  const T* row_b = rows + static_cast<int64_t>(b) * F * D;
  const T* val_b = vals + static_cast<int64_t>(b) * F;

  float linear = 0.0f;
  for (int f = lane; f < F; f += kWarp) {
    linear += widen(row_b[static_cast<int64_t>(f) * D]) * widen(val_b[f]);
  }

  float inter = 0.0f;  // this lane's sum over its k of s1_k^2 - s2_k
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int k = k0 + lane;
    if (k < K) {
      float s1 = 0.0f;
      float s2 = 0.0f;
      for (int f = 0; f < F; ++f) {
        const int64_t at = static_cast<int64_t>(f) * D + 1 + k;
        const float xv = widen(row_b[at]) * widen(val_b[f]);
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

template <typename T>
int launch(const void* rows, const void* vals, void* scores, void* s1, int B,
           int F, int D, void* stream) {
  if (B <= 0 || F < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fm_scores_fwd_kernel<T><<<blocks, kWarp * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(vals),
      static_cast<float*>(scores), static_cast<float*>(s1), B, F, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 = launched).  The
// caller checks shapes, types and contiguity and allocates the f32
// outputs.  fm_scores_fwd takes f32 rows and vals, fm_scores_fwd_bf16
// bf16 ones.
extern "C" int fm_scores_fwd(const void* rows, const void* vals,
                             void* scores, void* s1, int B, int F, int D,
                             void* stream) {
  return launch<float>(rows, vals, scores, s1, B, F, D, stream);
}

extern "C" int fm_scores_fwd_bf16(const void* rows, const void* vals,
                                  void* scores, void* s1, int B, int F,
                                  int D, void* stream) {
  return launch<__nv_bfloat16>(rows, vals, scores, s1, B, F, D, stream);
}
