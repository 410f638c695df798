// FmGrad backward: per-occurrence row gradients of the FM score, for
// Hopper (sm_90a).
//
// Replaces fast_tffm_tpu/ops/fm_pallas.py::_bwd_kernel (the Pallas kernel
// behind fm_grad_pallas).  Same closed form, same f32 arithmetic:
//
//   rows    [B, F, D] f32 (column 0 = linear weight w, columns 1.. = v)
//   vals    [B, F]    f32 (0 marks a padded feature slot)
//   s1      [B, D-1]  f32 (the forward's saved sum_f v[b, f, k] * x[b, f])
//   dscores [B]       f32 (dL/dscore)
//   drows[b, f, 0]   = g_b * x_bf
//   drows[b, f, 1+k] = g_b * x_bf * (s1[b, k] - v[b, f, k] * x_bf)
//
// Output drows [B, F, D] f32.  Any B, F and D >= 1.
//
// Bound: memory.  One pass reads rows and vals, s1 and dscores once and
// writes drows once: 4 * (2*B*F*D + B*F + B*(D-1) + B) bytes, 12.4 MB at
// B = 4096, F = 39, D = 9 (about 3.7 us at 3.35 TB/s), against about
// 3 flops per output element.  The design is one thread per output
// element of the flattened [B, F*D] row, so neighbouring threads read and
// write neighbouring addresses of rows and drows; the small vals, s1 and
// dscores reads hit the same few cache lines across a warp.  The TPU
// kernel's one-hot selection matmuls (broadcasting x_f and s1_k across
// the flattened row on the MXU) and its three-way bf16 split have no
// counterpart here: the thread computes its own (b, f, j) from its index.
// The arithmetic uses round-to-nearest intrinsics so the compiler does
// not contract it into FMAs: the kernel gives the plain PyTorch version's
// result bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void fm_grad_bwd_kernel(const float* __restrict__ rows,
                                   const float* __restrict__ vals,
                                   const float* __restrict__ s1,
                                   const float* __restrict__ dscores,
                                   float* __restrict__ drows, int64_t total,
                                   int F, int D) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t fd = static_cast<int64_t>(F) * D;
  const int64_t b = idx / fd;
  const int r = static_cast<int>(idx - b * fd);
  const int f = r / D;
  const int j = r - f * D;
  const float x = vals[b * F + f];
  const float gx = __fmul_rn(dscores[b], x);
  if (j == 0) {
    drows[idx] = gx;
    return;
  }
  const float s = s1[b * (D - 1) + (j - 1)];
  drows[idx] = __fmul_rn(gx, __fsub_rn(s, __fmul_rn(rows[idx], x)));
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes, types and contiguity and allocates drows.
extern "C" int fm_grad_bwd(const void* rows, const void* vals,
                           const void* s1, const void* dscores, void* drows,
                           int B, int F, int D, void* stream) {
  if (B <= 0 || F <= 0 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(B) * F * D;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fm_grad_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(vals),
      static_cast<const float*>(s1), static_cast<const float*>(dscores),
      static_cast<float*>(drows), total, F, D);
  return static_cast<int>(cudaGetLastError());
}
