// FmGrad backward: per-occurrence row gradients of the FM score, for
// Hopper (sm_90a).
//
// Replaces fast_tffm_tpu/ops/fm_pallas.py::_bwd_kernel (the Pallas kernel
// behind fm_grad_pallas), in both of its modes.  Same closed form, same
// f32 arithmetic:
//
//   rows    [B, F, D] f32 or bf16 (column 0 = linear weight w, 1.. = v)
//   vals    [B, F]    the rows' type (0 marks a padded feature slot)
//   s1      [B, D-1]  f32 (the forward's saved sum_f v[b, f, k] * x[b, f])
//   dscores [B]       f32 (dL/dscore)
//   drows[b, f, 0]   = g_b * x_bf
//   drows[b, f, 1+k] = g_b * x_bf * (s1[b, k] - v[b, f, k] * x_bf)
//
// Output drows [B, F, D] in the rows' type.  Any B, F and D >= 1.  The
// bf16 mode (fm_grad_bwd_bf16) widens rows and vals with
// __bfloat162float, computes in f32 as the f32 mode does and rounds each
// result once to nearest even with __float2bfloat16_rn, as the Pallas
// kernel's drows.astype(bf16) and torch's .to(torch.bfloat16) do.
//
// Bound: memory.  One pass reads rows and vals, s1 and dscores once and
// writes drows once: 4 * (2*B*F*D + B*F + B*(D-1) + B) bytes in f32,
// 12.4 MB at B = 4096, F = 39, D = 9 (about 3.7 us at 3.35 TB/s), and
// 2 * (2*B*F*D + B*F) + 4 * (B*(D-1) + B) in bf16, 6.2 MB, against about
// 3 flops per output element.  The design is one thread per output
// element of the flattened [B, F*D] row, so neighbouring threads read and
// write neighbouring addresses of rows and drows; the small vals, s1 and
// dscores reads hit the same few cache lines across a warp.  The TPU
// kernel's one-hot selection matmuls (broadcasting x_f and s1_k across
// the flattened row on the MXU) and its three-way bf16 split have no
// counterpart here: the thread computes its own (b, f, j) from its index.
// The arithmetic uses round-to-nearest intrinsics so the compiler does
// not contract it into FMAs: in both modes the kernel gives the plain
// PyTorch version's result bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Index arithmetic in 32 bits (the launch refuses 2^31 elements or
// more): the divisions by F*D and D are the kernel's costliest
// instructions, and a 64-bit division is a software routine.
template <typename T>
__global__ void fm_grad_bwd_kernel(const T* __restrict__ rows,
                                   const T* __restrict__ vals,
                                   const float* __restrict__ s1,
                                   const float* __restrict__ dscores,
                                   T* __restrict__ drows, unsigned total,
                                   unsigned F, unsigned D) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const unsigned fd = F * D;
  const unsigned b = idx / fd;
  const unsigned r = idx - b * fd;
  const unsigned f = r / D;
  const unsigned j = r - f * D;
  const float x = widen(vals[b * F + f]);
  const float gx = __fmul_rn(dscores[b], x);
  if (j == 0) {
    store(drows + idx, gx);
    return;
  }
  const float s = s1[b * (D - 1) + (j - 1)];
  store(drows + idx,
        __fmul_rn(gx, __fsub_rn(s, __fmul_rn(widen(rows[idx]), x))));
}

template <typename T>
int launch(const void* rows, const void* vals, const void* s1,
           const void* dscores, void* drows, int B, int F, int D,
           void* stream) {
  if (B <= 0 || F <= 0 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(B) * F * D;
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  fm_grad_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(vals),
      static_cast<const float*>(s1), static_cast<const float*>(dscores),
      static_cast<T*>(drows), static_cast<unsigned>(total),
      static_cast<unsigned>(F), static_cast<unsigned>(D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 = launched).  The
// caller checks shapes, types and contiguity and allocates drows in the
// rows' type.  fm_grad_bwd takes f32 rows and vals, fm_grad_bwd_bf16
// bf16 ones; s1 and dscores are f32 in both.
extern "C" int fm_grad_bwd(const void* rows, const void* vals,
                           const void* s1, const void* dscores, void* drows,
                           int B, int F, int D, void* stream) {
  return launch<float>(rows, vals, s1, dscores, drows, B, F, D, stream);
}

extern "C" int fm_grad_bwd_bf16(const void* rows, const void* vals,
                                const void* s1, const void* dscores,
                                void* drows, int B, int F, int D,
                                void* stream) {
  return launch<__nv_bfloat16>(rows, vals, s1, dscores, drows, B, F, D,
                               stream);
}
