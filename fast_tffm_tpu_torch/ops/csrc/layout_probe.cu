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
// give bitwise-equal elements for equal sums.  An untouched row is neither
// read nor written, so it stays bitwise as it was (the TPU kernels rewrite
// it with a zero update, which leaves it the same); K2P's pad slots of a
// touched row are written back with the bits it loaded from them.
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
// column c at float 16 * r + c, a row one aligned 64-byte line of four
// 16-byte chunks (columns 4q..4q+3 are chunk q).  Columns c < D (D <= 16)
// are updated.  The table, the accumulator and the stream must start on
// 16-byte boundaries (else cudaErrorInvalidValue; micro_probe raises
// before it launches).
//
// - kLanes lanes a row, the row's ceil(D / 4) live chunks rounded up to a
//   power of two (1 up to D = 4, 2 up to 8, else 4): lane l loads chunk
//   l of the table and of the accumulator as one float4 each, both before
//   any arithmetic.  A chunk with 4q >= D is neither loaded for itself
//   nor stored; a chunk that straddles D is stored whole, its pad columns
//   with the values loaded from them, one writer a row (urows is unique).
//   Storing only its live columns one by one, a thread a row with
//   ceil(D / 4) float4 loads, two rows a lane group in flight, two lanes a
//   row at D = 9 and a lane for each live chunk packed densely all
//   measured slower at the probe's stream (PERF.md).
// - A block of 256 threads takes a tile of 256 / kLanes consecutive
//   entries and stages their sums [tile, 2D] in shared memory once, in
//   coalesced 16-byte cp.async copies (the tile starts 16-byte aligned; an
//   odd number of float pairs ends in one 8-byte copy); its row ids load
//   once, coalesced, and its table loads go out before it waits for the
//   stage.  Reading the sums from device memory instead measured 4-6 %
//   slower.  No division; 64-bit arithmetic only for addresses (id * 16
//   and the tile's offset in the stream).
// - The grid holds kK2pRowsPerSm = 256 rows an SM in flight, blocks
//   walking the tiles in turn.  What bounds K2P at the probe's stream
//   (about 590,000 random 64-byte rows of 268 MB tables) is the rows, not
//   the bytes: a kernel with one thread an element takes about as long at
//   D = 2 as at D = 16, and every mapping here got slower with more rows
//   in flight on an SM (PERF.md).  A batch's stream, whose rows stay in
//   L2 across calls, gains from the fewer instructions.
//
// The TPU kernels sweep the whole table tile by tile and place the entries
// with bf16 hi/lo one-hot matmuls (a [D, R] transposed placement for K2T,
// lane-spread and line matmuls for K2P), because TPU scatters serialize.
// Here each thread or lane updates its own elements.
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

#include <algorithm>
#include <cstdint>

#include "adagrad.cuh"

namespace {

constexpr int kK2pThreads = 256;
constexpr int kK2pRowsPerSm = 256;  // K2P rows in flight on an SM
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

__device__ __forceinline__ void copy_async8(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four floats of shared memory at p, read kAlign floats at a time (p is
// 4 * kAlign-byte aligned).
template <int kAlign>
__device__ __forceinline__ float4 load_chunk(const float* p) {
  if constexpr (kAlign == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else if constexpr (kAlign == 2) {
    const float2 lo = reinterpret_cast<const float2*>(p)[0];
    const float2 hi = reinterpret_cast<const float2*>(p)[1];
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    return make_float4(p[0], p[1], p[2], p[3]);
  }
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

// K2P: kLanes lanes a row (a power of two), lane l taking the row's
// 16-byte chunks l, l + kLanes, ... below kChunks = ceil(D / 4).  A tile
// is the kTile consecutive entries of kK2pThreads threads; block b takes
// tiles b, b + gridDim.x, ...
template <int D, int kLanes>
__global__ void __launch_bounds__(kK2pThreads)
    k2p_kernel(const int* __restrict__ urows, const float* __restrict__ sums,
               float4* __restrict__ table_p, float4* __restrict__ acc_p,
               int U, float lr, float eps) {
  constexpr int kChunks = (D + 3) / 4;
  constexpr int kPerLane = (kChunks + kLanes - 1) / kLanes;
  constexpr int kTile = kK2pThreads / kLanes;
  constexpr int kWidth = 2 * D;
  // The tile's sums, and 4 floats past them: a chunk's vector read may
  // take the floats after the row's last column (never used).
  __shared__ __align__(16) float stage[kTile * kWidth + 4];
  const int t = threadIdx.x;
  const int lane = t % kLanes;
  const int group = t / kLanes;
  const int tiles =
      static_cast<int>((static_cast<int64_t>(U) + kTile - 1) / kTile);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tile0 = tile * kTile;
    const int n = min(kTile, U - tile0);
    // Stage the tile's n * 2D floats in 16-byte copies (and one 8-byte
    // copy for an odd number of pairs): they start 16-byte aligned, as
    // tile0 * 2D * 4 bytes is a multiple of 16 for an even kTile.
    {
      const float* src = sums + static_cast<int64_t>(tile0) * kWidth;
      const int m = n * kWidth;
      for (int k = 4 * t; k + 4 <= m; k += 4 * kK2pThreads) {
        copy_async16(stage + k, src + k);
      }
      if (t == 0 && (m & 2)) copy_async8(stage + m - 2, src + m - 2);
    }

    // The row's id, loaded by its lanes from one address: a warp's load
    // reads its rows' neighbouring ids once.  A lane group past the stream
    // takes the tile's last id and stores nothing.
    const int64_t base =  // the row's first chunk: id * 16 floats
        static_cast<int64_t>(urows[tile0 + min(group, n - 1)]) *
        (kPackedSlots / 4);
    // Every chunk of the table and of the accumulator first: a lane past
    // the row's chunks loads its last one again (same sector) and stores
    // nothing, so every load goes out unconditionally.
    float4 w[kPerLane], a[kPerLane];
#pragma unroll
    for (int p = 0; p < kPerLane; ++p) {
      const int q = min(lane + p * kLanes, kChunks - 1);
      w[p] = table_p[base + q];
      a[p] = acc_p[base + q];
    }
    wait_async_copies();
    __syncthreads();

    if (group < n) {
      const float* s = stage + group * kWidth;
#pragma unroll
      for (int p = 0; p < kPerLane; ++p) {
        const int q = lane + p * kLanes;
        if (q >= kChunks) continue;
        // The row's sums start at float group * 2D of the stage: g1's
        // chunk is 8-byte aligned (16 at even D), g2's 16 at D % 4 == 0
        // and 8 at even D.
        const float4 g1 = load_chunk<D % 2 == 0 ? 4 : 2>(s + 4 * q);
        const float4 g2 =
            load_chunk<D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1)>(s + D + 4 * q);
        float* wv = &w[p].x;
        float* av = &a[p].x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j < D) {
            adagrad_step(wv[j], av[j], (&g1.x)[j], (&g2.x)[j], lr, eps);
          }
        }
        // A chunk that straddles D stores its pad columns with the values
        // loaded from them: the row has one writer (urows is unique), so
        // the pad slots keep their bits.
        acc_p[base + q] = a[p];
        table_p[base + q] = w[p];
      }
    }
    __syncthreads();  // the stage is read: the next tile may overwrite it
  }
}

// Launches K2P at the compile-time width D == d: the row's chunks rounded
// up to a power of two lanes a row, and a grid that holds kK2pRowsPerSm
// rows an SM (or a block a tile, for a short stream).
template <int D>
int k2p_launch(int d, const int* urows, const float* sums, float4* table_p,
               float4* acc_p, int U, float lr, float eps,
               cudaStream_t stream) {
  if constexpr (D > kPackedSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (d != D) {
      return k2p_launch<D + 1>(d, urows, sums, table_p, acc_p, U, lr, eps,
                               stream);
    }
    constexpr int kLanes = D <= 4 ? 1 : (D <= 8 ? 2 : 4);
    constexpr int kTile = kK2pThreads / kLanes;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t tiles = (static_cast<int64_t>(U) + kTile - 1) / kTile;
    const int64_t grid =
        std::min<int64_t>(tiles, static_cast<int64_t>(sms) * kK2pRowsPerSm /
                                     kTile);
    k2p_kernel<D, kLanes><<<static_cast<unsigned>(grid), kK2pThreads, 0,
                            stream>>>(urows, sums, table_p, acc_p, U, lr,
                                      eps);
    return static_cast<int>(cudaGetLastError());
  }
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
// acc_p [V/8, 128]; sums, table_p and acc_p start on 16-byte boundaries,
// else cudaErrorInvalidValue and no launch.
extern "C" int k2p_apply(const void* urows, const void* sums, void* table_p,
                         void* acc_p, int U, int D, float lr, float eps,
                         void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (U <= 0 || D < 1 || D > kPackedSlots || misaligned(sums) ||
      misaligned(table_p) || misaligned(acc_p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return k2p_launch<1>(D, static_cast<const int*>(urows),
                       static_cast<const float*>(sums),
                       static_cast<float4*>(table_p),
                       static_cast<float4*>(acc_p), U, lr, eps,
                       static_cast<cudaStream_t>(stream));
}
