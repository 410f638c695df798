// Sparse optimizer apply for Hopper (sm_90a): K1 (dedup, and its merge
// mode), K2 (apply) and K-place (dense expansion).
//
// Replaces fast_tffm_tpu/ops/sparse_apply.py::_k1_kernel (behind
// _k1_dedup), ::_k2_group_kernel / _k2_group_kernel_compact (behind
// _k2_call) and ::_kplace_kernel (behind _kplace_call).  Same semantics
// as the reference's tile apply and its scatter path (train/sparse.py):
// per-occurrence g^2 accumulation and one shared post-update denominator
// per row (Adagrad), one -sigma*w correction per row (FTRL), plain SGD.
//
// Inputs come from a stable sort of the batch's flat ids (on the host or
// on the device, both give the same arrays):
//   perm      [n]     i32  occurrence index of each sorted position
//   seg_start [U + 1] i32  first sorted position of each unique id; U = n
//                          at most, seg_start[U] = n
//
// K1 (k1_dedup): per unique id u, the sums over its occurrences of the
// per-occurrence row gradients g_rows[perm[i]] ([n, D] f32, unsorted:
// the gather by perm happens inside the kernel) and of their squares,
//   sums[u] = [sum g | sum g^2]  ([U, 2D] f32),  urows[u] = the id.
// Merge mode (k1_merge) sums a [n, P] payload as it is, sums[u] [U, P]:
// the sharded entries exchange feeds it streams that already hold
// [sum g | sum g^2] per row (the reference's merge_entries).
// One warp per segment.  A segment of one occurrence (most of them on
// hashed data) is copied by lane 0; a longer one is split across the 32
// lanes by stride and reduced with shuffles, so a hot id of thousands of
// occurrences costs one warp a loop of (count / 32) steps.  No float
// atomics: the order of every sum is fixed by (perm, seg_start), so two
// runs give bitwise-equal sums.  The TPU kernel's [C, C] one-hot matmul
// and its VMEM carry across chunk boundaries exist because a TPU grid
// runs in order and scatters serialize; here a segment of any length
// belongs to one warp and nothing carries between blocks.
//
// K2 (k2_apply): one thread per (unique row, column) updates the table
// and its optimizer tables in place at that row only (Adagrad through
// adagrad.cuh, which the layout probe's kernels share).  Rows are unique,
// so no two threads write one address.  The TPU kernel's full-table tile
// sweep and its compact group remap have no counterpart: they exist
// because TPU scatters serialize.
//
// K-place (kplace): the deduped entry stream (urows [U] ascending, as K1
// emits them; sums [U, W]) expanded into a dense per-shard delta
// [vocab_local, W]: row urows[u] - row_lo gets sums[u], every other row
// 0, entries outside [row_lo, row_lo + vocab_local) dropped (the
// sentinel id of off-shard occurrences among them).  One block per tile
// of output rows: it finds the tile's entries by binary search in the
// sorted urows (they are one contiguous run of sums), places them into a
// zeroed tile in shared memory and writes the tile out once, densely and
// coalesced.  Every output byte is written once, with no zero fill
// before a scatter.  The TPU kernel's per-tile DMA window and one-hot
// placement matmul are the same idea in the TPU's terms.
//
// Bound: memory.  At B = 4096, F = 39, D = 9 (n = 159,744 occurrences)
// K1 reads g_rows (5.75 MB), perm and the flat ids (0.64 MB each at most)
// and seg_start, and writes U * (2D + 1) * 4 bytes; K2 reads the sums and
// the row ids and reads and writes U * D * 4 bytes of each table it
// updates.  K-place writes vocab_local * W * 4 bytes (151 MB at
// vocab_local = 2^21, W = 18) and reads U * (W + 1) * 4.  All do a
// handful of flops per byte.

#include <cuda_runtime.h>

#include <cstdint>

#include "adagrad.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kCols = 16;  // columns summed per pass over a segment
constexpr int kThreads = 256;

constexpr int kSgd = 0;
constexpr int kAdagrad = 1;
constexpr int kFtrl = 2;

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// kSquare: [sum g | sum g^2] of a [n, D] payload (sums [U, 2D]);
// otherwise the sum of a [n, D] payload as it is (sums [U, D]).
template <bool kSquare>
__global__ void k1_dedup_kernel(const float* __restrict__ g_rows,
                                const int* __restrict__ ids,
                                const int* __restrict__ perm,
                                const int* __restrict__ seg_start,
                                int* __restrict__ urows,
                                float* __restrict__ sums, int U, int D) {
  const int lane = threadIdx.x % kWarp;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  // u is the same for every lane of a warp, so a warp leaves whole and
  // the full-mask shuffles below never wait on an exited lane.
  if (u >= U) return;
  const int s0 = seg_start[u];
  const int s1 = seg_start[u + 1];
  constexpr int kWidth = kSquare ? 2 : 1;
  float* out = sums + u * kWidth * D;
  if (s1 - s0 == 1) {
    // One occurrence: copy its row (and, in dedup mode, square it).
    if (lane == 0) urows[u] = ids[perm[s0]];
    const float* g = g_rows + static_cast<int64_t>(perm[s0]) * D;
    for (int c = lane; c < D; c += kWarp) {
      const float v = g[c];
      out[c] = v;
      if (kSquare) out[D + c] = __fmul_rn(v, v);
    }
    return;
  }
  if (lane == 0) urows[u] = ids[perm[s0]];
  for (int c0 = 0; c0 < D; c0 += kCols) {
    float a1[kCols];
    float a2[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      a1[c] = 0.0f;
      a2[c] = 0.0f;
    }
    for (int i = s0 + lane; i < s1; i += kWarp) {
      const float* g = g_rows + static_cast<int64_t>(perm[i]) * D + c0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c0 + c < D) {
          const float v = g[c];
          a1[c] = __fadd_rn(a1[c], v);
          if (kSquare) a2[c] = __fadd_rn(a2[c], __fmul_rn(v, v));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c0 + c < D) {  // warp-uniform: every lane takes the same branch
        const float t1 = warp_sum(a1[c]);
        const float t2 = kSquare ? warp_sum(a2[c]) : 0.0f;
        if (lane == 0) {
          out[c0 + c] = t1;
          if (kSquare) out[D + c0 + c] = t2;
        }
      }
    }
  }
}

template <int kOpt>
__global__ void k2_apply_kernel(const int* __restrict__ urows,
                                const float* __restrict__ sums,
                                float* __restrict__ table,
                                float* __restrict__ state1,
                                float* __restrict__ state2, int64_t total,
                                int D, float lr, float p1, float p2,
                                float p3) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t u = idx / D;
  const int c = static_cast<int>(idx - u * D);
  const float g1 = sums[u * 2 * D + c];
  const float g2 = sums[u * 2 * D + D + c];
  const int64_t pos = static_cast<int64_t>(urows[u]) * D + c;
  const float w = table[pos];
  if (kOpt == kSgd) {
    table[pos] = __fsub_rn(w, __fmul_rn(lr, g1));
  } else if (kOpt == kAdagrad) {
    // p1 = eps.  acc += sum g^2; w -= lr * sum g * rsqrt(acc + eps).
    adagrad_at(table, state1, pos, g1, g2, lr, p1);
  } else {
    // FTRL-proximal, p1 = l1, p2 = l2, p3 = beta; state1 = z, state2 = n.
    const float n_old = state2[pos];
    const float n_new = __fadd_rn(n_old, g2);
    const float sigma = __fdiv_rn(__fsub_rn(sqrtf(n_new), sqrtf(n_old)), lr);
    const float z =
        __fsub_rn(__fadd_rn(state1[pos], g1), __fmul_rn(sigma, w));
    state1[pos] = z;
    state2[pos] = n_new;
    const float denom = __fadd_rn(__fdiv_rn(__fadd_rn(p3, sqrtf(n_new)), lr), p2);
    const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
    table[pos] = fabsf(z) <= p1
                     ? 0.0f
                     : __fdiv_rn(-__fsub_rn(z, __fmul_rn(sign, p1)), denom);
  }
}

// First index of sorted a[0..n) whose value is >= key (n when none is).
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int64_t key) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (static_cast<int64_t>(a[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// K-place: block b owns output rows [b * tile_rows, + tile_rows) of the
// shard, i.e. global rows from row_lo + b * tile_rows.  Its entries are
// the run urows[e0 .. e1) found by binary search, whose sums are
// contiguous too.
__global__ void kplace_kernel(const int* __restrict__ urows,
                              const float* __restrict__ sums, int U,
                              int64_t row_lo, int64_t vocab_local, int W,
                              int tile_rows, float* __restrict__ delta) {
  extern __shared__ float tile[];  // [tile_rows, W]
  __shared__ int range[2];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t left = vocab_local - r0;
  const int rows = left < tile_rows ? static_cast<int>(left) : tile_rows;
  const int n = rows * W;
  if (threadIdx.x < 2) {
    range[threadIdx.x] =
        lower_bound(urows, U, row_lo + r0 + (threadIdx.x ? rows : 0));
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();
  const int e0 = range[0];
  const int m = (range[1] - e0) * W;
  const float* src = sums + static_cast<int64_t>(e0) * W;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int e = i / W;
    const int64_t r = static_cast<int64_t>(urows[e0 + e]) - row_lo - r0;
    // Always true for an ascending urows; keeps a caller that broke
    // that contract inside the tile.
    if (r >= 0 && r < rows) tile[r * W + (i - e * W)] = src[i];
  }
  __syncthreads();
  float* dst = delta + r0 * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = tile[i];
}

}  // namespace

// K1.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).  The caller checks shapes, types and contiguity and
// allocates urows [U] and sums [U, 2D].
extern "C" int k1_dedup(const void* g_rows, const void* ids,
                        const void* perm, const void* seg_start, void* urows,
                        void* sums, int U, int D, void* stream) {
  if (U <= 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (static_cast<int64_t>(U) + kWarpsPerBlock - 1) /
                         kWarpsPerBlock;
  k1_dedup_kernel<true><<<static_cast<unsigned>(blocks),
                          kWarp * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g_rows), static_cast<const int*>(ids),
      static_cast<const int*>(perm), static_cast<const int*>(seg_start),
      static_cast<int*>(urows), static_cast<float*>(sums), U, D);
  return static_cast<int>(cudaGetLastError());
}

// K1 merge mode: sums [U, P] of a [n, P] payload taken as it is.
extern "C" int k1_merge(const void* payload, const void* ids,
                        const void* perm, const void* seg_start, void* urows,
                        void* sums, int U, int P, void* stream) {
  if (U <= 0 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (static_cast<int64_t>(U) + kWarpsPerBlock - 1) /
                         kWarpsPerBlock;
  k1_dedup_kernel<false><<<static_cast<unsigned>(blocks),
                           kWarp * kWarpsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(payload), static_cast<const int*>(ids),
      static_cast<const int*>(perm), static_cast<const int*>(seg_start),
      static_cast<int*>(urows), static_cast<float*>(sums), U, P);
  return static_cast<int>(cudaGetLastError());
}

// K2.  `opt`: 0 = SGD (table only), 1 = Adagrad (state1 = accumulator,
// p1 = eps), 2 = FTRL (state1 = z, state2 = n, p1 = l1, p2 = l2,
// p3 = beta).  Updates the tables in place at rows urows[0..U).
extern "C" int k2_apply(int opt, const void* urows, const void* sums,
                        void* table, void* state1, void* state2, int U, int D,
                        float lr, float p1, float p2, float p3,
                        void* stream) {
  if (U <= 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(U) * D;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int*>(urows);
  const auto* s = static_cast<const float*>(sums);
  auto* t = static_cast<float*>(table);
  auto* a = static_cast<float*>(state1);
  auto* b = static_cast<float*>(state2);
  if (opt == kSgd) {
    k2_apply_kernel<kSgd><<<grid, kThreads, 0, st>>>(r, s, t, a, b, total, D,
                                                      lr, p1, p2, p3);
  } else if (opt == kAdagrad) {
    k2_apply_kernel<kAdagrad><<<grid, kThreads, 0, st>>>(
        r, s, t, a, b, total, D, lr, p1, p2, p3);
  } else if (opt == kFtrl) {
    k2_apply_kernel<kFtrl><<<grid, kThreads, 0, st>>>(r, s, t, a, b, total, D,
                                                       lr, p1, p2, p3);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K-place.  Writes every element of delta [vocab_local, W]; urows [U]
// ascending (U may be 0), sums [U, W].  A tile of rows fits the 48 KB
// of shared memory a block may take without an opt-in, beside the
// kernel's own 8 static bytes.
extern "C" int kplace(const void* urows, const void* sums, int U,
                      long long row_lo, long long vocab_local, int W,
                      void* delta, void* stream) {
  constexpr int kSmemFloats = (48 * 1024 - 64) / 4;
  if (U < 0 || W < 1 || W > kSmemFloats || vocab_local < 1 || row_lo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_rows = kSmemFloats / W < 256 ? kSmemFloats / W : 256;
  const int64_t blocks = (vocab_local + tile_rows - 1) / tile_rows;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kplace_kernel<<<static_cast<unsigned>(blocks), kThreads,
                  static_cast<size_t>(tile_rows) * W * sizeof(float),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(urows), static_cast<const float*>(sums), U,
      row_lo, vocab_local, W, tile_rows, static_cast<float*>(delta));
  return static_cast<int>(cudaGetLastError());
}
