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
// K2T: table_t and acc_t [D, V]; element (c, r) at c * V + r.  A block
// takes a tile of consecutive entries, one entry a thread (128, or fewer
// where a wide row's stage would pass 48 KB, down to 32).  The stage of a
// 32-entry tile, 32 * (2D + 1) * 4 bytes, fits the SM's 227 KB up to
// D = 907 (kK2tMaxD); a wider D is refused (cudaErrorInvalidValue, and
// micro_probe raises before it launches).
//
// - The tile's sums [tile, 2D] are contiguous: the block stages them in
//   shared memory in one coalesced pass of 4-byte cp.async copies (lanes
//   on neighbouring floats), rows padded to 2D + 1 floats so that the
//   threads' reads of one column fall in distinct banks (at 2D = 18 an
//   unpadded stride is a two-way conflict).  A 16-byte copy cannot land
//   in padded rows; the padding costs the copy 4x the instructions and
//   saves every read of the stage a conflict.  The stream is read once.
// - Thread t loads its own id urows[tile0 + t] (coalesced: it needs no
//   stage) and walks the D columns one at a time; its first column's
//   table and accumulator loads go out before it waits for the stage, so
//   the copy and that round trip overlap.  A warp's lanes take
//   neighbouring ascending ids of one column per load, so they share
//   sectors where the ids are that close.
// - No division but one 32-bit one per thread for its place in the copy;
//   64-bit arithmetic only for c * V + r.
//
// One column at a time keeps a thread at 26 registers, so a full SM of
// threads has loads in flight.  Issuing 8 or 16 columns' loads at once
// (more registers, fewer threads), the next column's loads before the
// current update, loads past L1, and 256-entry tiles all measured slower
// or level (PERF.md).  The layout sets what is left: U uniform ids
// of V touch a share 1 - (1 - U/V)^8 of each column's 32-byte sectors
// (about 70 % at the probe's stream, 18 % at a batch's), each read and
// written in two tables; chip_smoke.py's k2t_sector_ms counts them from
// the stream.  At a batch's stream those are isolated sectors in a
// 151 MB table, read and written at about a third of the card's rate.
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
constexpr int kK2tTile = 128;     // entries (and threads) of a K2T block
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;  // an sm_90 block's opt-in limit
constexpr int kK2tMaxD = 907;         // 32 * (2 * 907 + 1) * 4 <= kMaxSmem

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of a K2T tile of `tile` entries: rows of 2D + 1 floats.
int64_t k2t_stage_bytes(int tile, int D) {
  return static_cast<int64_t>(tile) * (2 * D + 1) * sizeof(float);
}

__global__ void __launch_bounds__(kK2tTile)
    k2t_kernel(const int* __restrict__ urows, const float* __restrict__ sums,
               float* __restrict__ table_t, float* __restrict__ acc_t, int U,
               int D, int64_t V, float lr, float eps) {
  extern __shared__ float stage[];  // [tile][2D + 1]
  const int tile = blockDim.x;
  const int t = threadIdx.x;
  const int tile0 = blockIdx.x * tile;
  const int n = min(tile, U - tile0);
  const int width = 2 * D;
  const int pitch = width + 1;

  // Stage the tile's n * 2D floats: thread t copies floats t, t + tile,
  // ...; their (row, column) step by tile = q * 2D + r.
  {
    const float* src = sums + static_cast<int64_t>(tile0) * width;
    const int q = tile / width;
    const int r = tile - q * width;
    int row = t / width;
    int col = t - row * width;
    for (int i = t; i < n * width; i += tile) {
      copy_async4(stage + row * pitch + col, src + i);
      row += q;
      col += r;
      if (col >= width) {
        col -= width;
        ++row;
      }
    }
  }

  const bool live = t < n;
  const int64_t id = live ? urows[tile0 + t] : 0;
  const float* mine = stage + t * pitch;
  for (int c = 0; c < D; ++c) {
    const int64_t pos = c * V + id;
    float w = 0.0f, a = 0.0f;
    if (live) {
      w = table_t[pos];
      a = acc_t[pos];
    }
    if (c == 0) {  // the stage, once its copies have landed
      wait_async_copies();
      __syncthreads();
    }
    if (live) {
      adagrad_step(w, a, mine[c], mine[D + c], lr, eps);
      acc_t[pos] = a;
      table_t[pos] = w;
    }
  }
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
  if (U <= 0 || D < 1 || D > kK2tMaxD || V < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The widest tile whose stage fits the static 48 KB, down to a warp;
  // past that the stage asks for more (up to kMaxSmem).
  int tile = kK2tTile;
  while (tile > 32 && k2t_stage_bytes(tile, D) > kStaticSmem) tile /= 2;
  const int64_t smem = k2t_stage_bytes(tile, D);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        k2t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid =
      static_cast<unsigned>((static_cast<int64_t>(U) + tile - 1) / tile);
  k2t_kernel<<<grid, tile, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(
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
