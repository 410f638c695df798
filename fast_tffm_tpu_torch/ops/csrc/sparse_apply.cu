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
// One thread per segment, a whole warp only for a long one.  A block
// owns 128 consecutive segments, one per thread, so the loads of
// seg_start are coalesced.  A segment of at most kShort = 16
// occurrences (on hashed data nearly all have one or two) is summed by
// its own thread in sorted order, so a warp walks 32 such segments at
// once and their perm and row loads are independent; a thread issues
// four occurrences' loads before their adds.  The warp finds its longer
// segments by ballot and sums each in turn, lanes by stride and then a
// shuffle tree, so a hot id of thousands of occurrences costs one warp
// (count / 32) steps and only its block waits on it.  The block stages
// its [128, W] sums in shared memory and writes them as one contiguous,
// coalesced range of sums (directly when 128 * W floats do not fit
// 48 KB).  What bounds it is not the bytes (~15 MB at a training
// batch, 4.6 us at full HBM bandwidth, against some 14.6 us on an H100):
// at D = 9 a warp's 4-byte load of its 32 lanes' rows touches 32 rows'
// sectors, 9 L1 wavefronts per occurrence.  A warp gathering rows into
// shared memory to cut that, and fewer registers for more resident
// blocks, both measured slower (PERF.md).  No float
// atomics: the order of every sum is fixed by (perm, seg_start) and
// kShort, so two runs give bitwise-equal sums (sparse_apply.
// k1_error_bound follows that order).  The TPU kernel's [C, C] one-hot
// matmul and its VMEM carry across chunk boundaries exist because a TPU
// grid runs in order and scatters serialize; here a segment of any
// length belongs to one thread or one warp and nothing carries between
// blocks.
//
// K2 (k2_apply): a group of kK2Lanes = 16 lanes per unique row updates
// the table and its optimizer tables in place at that row only (Adagrad
// through adagrad.cuh, which the layout probe's kernels share).  Rows are
// unique, so no two lanes write one address.  What bounds it is not the
// byte count (23.3 MB at a training batch, U = 105,739, D = 9: 6.9 us at
// full HBM bandwidth) but the granules its rows fall in.  A 36-byte row
// at a 4-byte offset spans two 32-byte sectors (27 MB with the sums at
// that batch, 10.5 us at 3.35 TB/s), and half of the rows straddle a
// 64-byte boundary of device memory, which moves 64 bytes at a time:
// 1.5 of those a row in each table each way.  The probe's packed layout
// (K2P, rows at a 64-byte stride, csrc/layout_probe.cu) takes 1.5x less
// time on the same stream with the same arithmetic: the [V, D] layout,
// not the thread mapping, sets K2's time (PERF.md).  The design removes
// what the mapping did cost: a group's lane 0 loads the row's id once
// and shuffles it to the group; the group's lanes take neighbouring
// columns, so each load and store touches only the row's own sectors;
// a lane issues every load of its element (its sums, the table, the
// optimizer state) before the element's arithmetic, and up to D = 16 a
// lane holds one element, so a row's loads are in flight together; the
// thread-to-row mapping multiplies and shifts only, with no division,
// 64-bit or otherwise.
// A thread per row (its sums staged through shared memory), 8 lanes a
// row and two rows a group of 16 lanes measured no faster (PERF.md).
// The TPU kernel's full-table tile sweep and its compact group remap
// have no counterpart: they exist because TPU scatters serialize.
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
constexpr int kThreads = 256;
// K1: segments per block (one per thread), the longest segment a thread
// sums alone (sparse_apply.K1_SHORT must agree), the occurrences whose
// loads a thread issues together, and the floats of sums a block may
// stage in shared memory without an opt-in.
constexpr int kSegs = 128;
constexpr int kShort = 16;
constexpr int kUnroll = 4;
constexpr int kStageFloats = 48 * 1024 / 4;
// K2: threads per block, and lanes per row (columns of a row per pass).
constexpr int kK2Threads = 128;
constexpr int kK2Lanes = 16;

constexpr int kSgd = 0;
constexpr int kAdagrad = 1;
constexpr int kFtrl = 2;

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Adds row g[0 .. kCols) (columns c0 + c < D only) of one occurrence
// to the accumulators, and its squares in dedup mode.
template <bool kSquare, int kCols>
__device__ __forceinline__ void add_row(const float* __restrict__ g, int c0,
                                        int D, float (&a1)[kCols],
                                        float (&a2)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c0 + c < D) {
      const float v = g[c];
      a1[c] = __fadd_rn(a1[c], v);
      if (kSquare) a2[c] = __fadd_rn(a2[c], __fmul_rn(v, v));
    }
  }
}

// Adds the rows of sorted positions i, i + step, ... below `end`, in
// that order, columns [c0, c0 + kCols).  The perm and row loads of
// kUnroll positions are issued before their adds.
template <bool kSquare, int kCols>
__device__ __forceinline__ void add_rows(const float* __restrict__ g_rows,
                                         const int* __restrict__ perm, int i,
                                         int end, int step, int c0, int D,
                                         float (&a1)[kCols],
                                         float (&a2)[kCols]) {
  for (; i < end; i += kUnroll * step) {
    int p[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      p[k] = k * step < end - i ? perm[i + k * step] : -1;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (p[k] >= 0) {
        add_row<kSquare>(g_rows + static_cast<int64_t>(p[k]) * D + c0, c0, D,
                         a1, a2);
      }
    }
  }
}

// kSquare: [sum g | sum g^2] of a [n, D] payload (sums [U, 2D]);
// otherwise the sum of a [n, D] payload as it is (sums [U, D]).  kCols
// columns per pass over a segment: 16 in dedup mode (D <= 16 in one
// pass), 32 in merge mode (P = 2D <= 32), 32 accumulators either way.
// `stage`: the block's sums go through shared memory ([kSegs, W]).
template <bool kSquare, int kCols>
__global__ void __launch_bounds__(kSegs)
    k1_kernel(const float* __restrict__ g_rows, const int* __restrict__ ids,
              const int* __restrict__ perm,
              const int* __restrict__ seg_start, int* __restrict__ urows,
              float* __restrict__ sums, int U, int D, bool stage) {
  extern __shared__ float staged[];
  constexpr int kWidth = kSquare ? 2 : 1;
  const int W = kWidth * D;
  const int t = threadIdx.x;
  const int lane = t % kWarp;
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * kSegs;
  const int64_t u = u0 + t;
  // Every thread stays to the end: the warp's ballot and shuffles and
  // the block's barrier take them all.  A thread past U has an empty
  // segment and writes nothing.
  int s0 = 0;
  int s1 = 0;
  if (u < U) {
    s0 = seg_start[u];
    s1 = seg_start[u + 1];
    urows[u] = ids[perm[s0]];
  }
  float* const out = stage ? staged + t * W : sums + u * W;
  if (s1 - s0 <= kShort) {
    for (int c0 = 0; c0 < D && s1 > s0; c0 += kCols) {
      float a1[kCols];
      float a2[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        a1[c] = 0.0f;
        a2[c] = 0.0f;
      }
      add_rows<kSquare>(g_rows, perm, s0, s1, 1, c0, D, a1, a2);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c0 + c < D) {
          out[c0 + c] = a1[c];
          if (kSquare) out[D + c0 + c] = a2[c];
        }
      }
    }
  }
  // The warp's long segments, one after another.
  unsigned todo = __ballot_sync(0xffffffffu, s1 - s0 > kShort);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const int b = __shfl_sync(0xffffffffu, s0, owner);
    const int e = __shfl_sync(0xffffffffu, s1, owner);
    float* const dst = out + (owner - lane) * W;
    for (int c0 = 0; c0 < D; c0 += kCols) {
      float a1[kCols];
      float a2[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        a1[c] = 0.0f;
        a2[c] = 0.0f;
      }
      add_rows<kSquare>(g_rows, perm, b + lane, e, kWarp, c0, D, a1, a2);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c0 + c < D) {  // warp-uniform: every lane takes the same branch
          const float t1 = warp_sum(a1[c]);
          const float t2 = kSquare ? warp_sum(a2[c]) : 0.0f;
          if (lane == 0) {
            dst[c0 + c] = t1;
            if (kSquare) dst[D + c0 + c] = t2;
          }
        }
      }
    }
  }
  if (stage) {
    __syncthreads();
    const int64_t left = U - u0;
    const int m = (left < kSegs ? static_cast<int>(left) : kSegs) * W;
    float* const block_sums = sums + u0 * W;
    for (int i = t; i < m; i += kSegs) block_sums[i] = staged[i];
  }
}

// The optimizer's formula at one element, on values in registers: the
// table's w, the optimizer state a (Adagrad's accumulator, FTRL's z) and
// b (FTRL's n), from the row's sums g1 = sum g and g2 = sum g^2.
// p1 = eps (Adagrad); p1 = l1, p2 = l2, p3 = beta (FTRL).
template <int kOpt>
__device__ __forceinline__ void k2_update(float g1, float g2, float lr,
                                          float p1, float p2, float p3,
                                          float& w, float& a, float& b) {
  if (kOpt == kSgd) {
    w = __fsub_rn(w, __fmul_rn(lr, g1));
  } else if (kOpt == kAdagrad) {
    adagrad_step(w, a, g1, g2, lr, p1);
  } else {
    // FTRL-proximal: n += sum g^2; z += sum g - sigma * w; w from (z, n).
    const float n_new = __fadd_rn(b, g2);
    const float sigma = __fdiv_rn(__fsub_rn(sqrtf(n_new), sqrtf(b)), lr);
    const float z = __fsub_rn(__fadd_rn(a, g1), __fmul_rn(sigma, w));
    a = z;
    b = n_new;
    const float denom =
        __fadd_rn(__fdiv_rn(__fadd_rn(p3, sqrtf(n_new)), lr), p2);
    const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
    w = fabsf(z) <= p1 ? 0.0f
                       : __fdiv_rn(-__fsub_rn(z, __fmul_rn(sign, p1)), denom);
  }
}

// K2: kK2Lanes lanes per unique row.  Row u of the stream goes to group
// u of the grid, so neighbouring groups take neighbouring rows (coalesced
// id and sums loads).  Lane l takes columns l, l + kK2Lanes, ...
template <int kOpt>
__global__ void __launch_bounds__(kK2Threads)
    k2_kernel(const int* __restrict__ urows, const float* __restrict__ sums,
              float* __restrict__ table, float* __restrict__ state1,
              float* __restrict__ state2, int U, int D, float lr, float p1,
              float p2, float p3) {
  constexpr int kGroups = kK2Threads / kK2Lanes;
  const int lane = threadIdx.x % kK2Lanes;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / kK2Lanes;
  // The row's id, loaded once by the group's lane 0.  Every lane of the
  // warp reaches the shuffle.
  int id = (lane == 0 && u < U) ? urows[u] : 0;
  id = __shfl_sync(0xffffffffu, id, 0, kK2Lanes);
  if (u >= U) return;
  const int64_t pos0 = static_cast<int64_t>(id) * D;
  const float* s = sums + u * 2 * D;
  for (int c = lane; c < D; c += kK2Lanes) {
    // Every load of the element first, then its arithmetic and stores.
    const float g1 = s[c];
    const float g2 = s[D + c];
    float w = table[pos0 + c];
    float a = kOpt != kSgd ? state1[pos0 + c] : 0.0f;
    float b = kOpt == kFtrl ? state2[pos0 + c] : 0.0f;
    k2_update<kOpt>(g1, g2, lr, p1, p2, p3, w, a, b);
    table[pos0 + c] = w;
    if (kOpt != kSgd) state1[pos0 + c] = a;
    if (kOpt == kFtrl) state2[pos0 + c] = b;
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

// Launches K1 in either mode: one block per kSegs segments, the
// block's sums staged in shared memory when they fit.
template <bool kSquare>
int k1_launch(const void* payload, const void* ids, const void* perm,
              const void* seg_start, void* urows, void* sums, int U, int D,
              void* stream) {
  if (U <= 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kCols = kSquare ? 16 : 32;
  const int64_t w = (kSquare ? 2 : 1) * static_cast<int64_t>(D);
  const bool stage = w * kSegs <= kStageFloats;
  const int64_t blocks = (static_cast<int64_t>(U) + kSegs - 1) / kSegs;
  k1_kernel<kSquare, kCols><<<static_cast<unsigned>(blocks), kSegs,
                              stage ? w * kSegs * sizeof(float) : 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(payload), static_cast<const int*>(ids),
      static_cast<const int*>(perm), static_cast<const int*>(seg_start),
      static_cast<int*>(urows), static_cast<float*>(sums), U, D, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).  The caller checks shapes, types and contiguity and
// allocates urows [U] and sums [U, 2D].
extern "C" int k1_dedup(const void* g_rows, const void* ids,
                        const void* perm, const void* seg_start, void* urows,
                        void* sums, int U, int D, void* stream) {
  return k1_launch<true>(g_rows, ids, perm, seg_start, urows, sums, U, D,
                         stream);
}

// K1 merge mode: sums [U, P] of a [n, P] payload taken as it is.
extern "C" int k1_merge(const void* payload, const void* ids,
                        const void* perm, const void* seg_start, void* urows,
                        void* sums, int U, int P, void* stream) {
  return k1_launch<false>(payload, ids, perm, seg_start, urows, sums, U, P,
                          stream);
}

// K2.  `opt`: 0 = SGD (table only), 1 = Adagrad (state1 = accumulator,
// p1 = eps), 2 = FTRL (state1 = z, state2 = n, p1 = l1, p2 = l2,
// p3 = beta).  Updates the tables in place at rows urows[0..U).
extern "C" int k2_apply(int opt, const void* urows, const void* sums,
                        void* table, void* state1, void* state2, int U, int D,
                        float lr, float p1, float p2, float p3,
                        void* stream) {
  if (U <= 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kRowsPerBlock = kK2Threads / kK2Lanes;
  const auto grid = static_cast<unsigned>(
      (static_cast<int64_t>(U) + kRowsPerBlock - 1) / kRowsPerBlock);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int*>(urows);
  const auto* s = static_cast<const float*>(sums);
  auto* t = static_cast<float*>(table);
  auto* a = static_cast<float*>(state1);
  auto* b = static_cast<float*>(state2);
  if (opt == kSgd) {
    k2_kernel<kSgd><<<grid, kK2Threads, 0, st>>>(r, s, t, a, b, U, D, lr, p1,
                                                 p2, p3);
  } else if (opt == kAdagrad) {
    k2_kernel<kAdagrad><<<grid, kK2Threads, 0, st>>>(r, s, t, a, b, U, D, lr,
                                                     p1, p2, p3);
  } else if (opt == kFtrl) {
    k2_kernel<kFtrl><<<grid, kK2Threads, 0, st>>>(r, s, t, a, b, U, D, lr,
                                                  p1, p2, p3);
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
