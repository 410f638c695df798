// Sparse Adagrad on the table-layout probe's two other layouts, for Hopper
// (sm_90a): K2T on a transposed [D, V] table and K2P on a packed
// [V/8, 128] one.
//
// Replaces tools/micro_probe.py::_k2t_kernel (behind k2t_apply) and
// ::_k2p_kernel (behind k2p_apply).  Both take K1's deduped stream, as K2
// does (csrc/sparse_apply.cu): urows [U] i32, ascending and unique, and
// sums [U, 2D] f32 = [sum g | sum g^2] per row.  Both update the table and
// its Adagrad accumulator in place at the touched elements only,
//   acc += sum g^2;  table -= lr * sum g * rsqrt(acc + eps),
// through adagrad.cuh, which K2 uses too: the three layouts round alike and
// give bitwise-equal elements for equal sums.  An untouched element is
// neither read nor written, so it stays bitwise as it was (the TPU kernels
// rewrite it with a zero update, which leaves it the same).
//
// K2T: table_t and acc_t [D, V]; element (c, r) at c * V + r.  One thread
// per (c, u) with u the fastest index, so the threads of a warp take
// neighbouring entries of one column c: they read neighbouring ascending
// urows and touch one row of the transposed table, in ascending order.
// Indexing (u, c) with c fastest, as K2 does, would put neighbouring
// threads V floats apart.
//
// K2P: table_p and acc_p [V/8, 128] f32, which is bytewise [V, 16]: row r's
// column c at float 16 * r + c.  Columns c < D (D <= 16) are updated; the
// slots D..15 are never written.  One thread per (u, c), c fastest, as K2.
//
// The TPU kernels sweep the whole table tile by tile and place the entries
// with bf16 hi/lo one-hot matmuls (a [D, R] transposed placement for K2T,
// lane-spread and line matmuls for K2P), because TPU scatters serialize.
// Here each thread updates its own element.
//
// Bound: memory, as K2's: the stream (U * (2D + 1) * 4 bytes) read, and
// U * D * 4 bytes of the table and of the accumulator each read and written
// (23.3 MB at one training batch, U = 105,739 of V = 2^22, D = 9; 130 MB at
// the probe's 638,976 uniform ids, U ~ 593,000), a handful of flops per
// byte.  What a layout changes is the sectors those bytes fall in: a
// touched row of K2 ([V, 9], 36 bytes) or K2P (64-byte lines) spans two
// 32-byte sectors, while at these densities (a touched row every 7 to 40
// rows) each touched (c, r) of K2T lies in a sector of its own: nine.

#include <cuda_runtime.h>

#include <cstdint>

#include "adagrad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPackedSlots = 16;  // floats per row of the packed layout

__global__ void k2t_kernel(const int* __restrict__ urows,
                           const float* __restrict__ sums,
                           float* __restrict__ table_t,
                           float* __restrict__ acc_t, int64_t U, int D,
                           int64_t V, float lr, float eps) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= U * D) return;
  const int64_t c = idx / U;
  const int64_t u = idx - c * U;
  const float* s = sums + u * 2 * D;
  adagrad_at(table_t, acc_t, c * V + urows[u], s[c], s[D + c], lr, eps);
}

__global__ void k2p_kernel(const int* __restrict__ urows,
                           const float* __restrict__ sums,
                           float* __restrict__ table_p,
                           float* __restrict__ acc_p, int64_t total, int D,
                           float lr, float eps) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t u = idx / D;
  const int c = static_cast<int>(idx - u * D);
  const float* s = sums + u * 2 * D;
  adagrad_at(table_p, acc_p,
             static_cast<int64_t>(urows[u]) * kPackedSlots + c, s[c],
             s[D + c], lr, eps);
}

int blocks_for(int64_t total, unsigned* grid) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *grid = static_cast<unsigned>(blocks);
  return 0;
}

}  // namespace

// K2T.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).  The caller checks shapes, types and contiguity: urows [U]
// in [0, V), sums [U, 2D], table_t and acc_t [D, V].
extern "C" int k2t_apply(const void* urows, const void* sums, void* table_t,
                         void* acc_t, int U, int D, long long V, float lr,
                         float eps, void* stream) {
  if (U <= 0 || D < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid = 0;
  if (const int err = blocks_for(static_cast<int64_t>(U) * D, &grid)) {
    return err;
  }
  k2t_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(urows), static_cast<const float*>(sums),
      static_cast<float*>(table_t), static_cast<float*>(acc_t), U, D, V, lr,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// K2P: urows [U] in [0, V), sums [U, 2D] with 1 <= D <= 16, table_p and
// acc_p [V/8, 128].
extern "C" int k2p_apply(const void* urows, const void* sums, void* table_p,
                         void* acc_p, int U, int D, float lr, float eps,
                         void* stream) {
  if (U <= 0 || D < 1 || D > kPackedSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(U) * D;
  unsigned grid = 0;
  if (const int err = blocks_for(total, &grid)) return err;
  k2p_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(urows), static_cast<const float*>(sums),
      static_cast<float*>(table_p), static_cast<float*>(acc_p), total, D, lr,
      eps);
  return static_cast<int>(cudaGetLastError());
}
