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
// One thread per segment, a warp for a longer one, and many warps for a
// segment longer than a piece.  A block owns 128 consecutive segments,
// one per thread, so the loads of seg_start are coalesced.  A segment of
// at most kShort = 16 occurrences (on hashed data nearly all have one or
// two) is summed by its own thread in sorted order, so a warp walks 32
// such segments at once and their perm and row loads are independent; a
// thread issues four occurrences' loads before their adds.  The warp
// finds its longer segments by ballot and sums each in turn, lanes by
// stride and then a shuffle tree.  A pass covers kCols columns: 16 in
// dedup mode; in merge mode 16 up to P = 16 (64 registers, not 95) and
// 32 past it.  The block stages its [128, W] sums in shared memory and
// writes them as one contiguous, coalesced range of sums (directly when
// 128 * W floats do not fit 48 KB).
//
// Long segments.  A hot id (Avazu's padding id 0, 16,384 occurrences a
// batch; the head of a Zipf(1.1) stream, 10^6 of config 4's 10.2 M ids)
// on one warp made the warp wait on every scattered row while the card
// sat idle: 363.9 us on Avazu's batch from HBM and 39,240 us on the Zipf
// stream, 2.1x and 3.8x the plain version, 5x and 7x index_add_ (NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md).  So a segment of more than kPiece
// = 512 occurrences is cut into pieces of kPiece sorted positions counted
// from its first: piece j is [s0 + j kPiece, s0 + (j + 1) kPiece) cut at
// s1, a rule of seg_start alone.  Piece 0 is summed by the owner's warp
// as above.  Piece j >= 1 starts in chunk floor(s0 / kPiece) + j of the
// sorted positions (chunks of kPiece, aligned), and no chunk holds the
// start of two such pieces (they are more than kPiece apart), so that
// chunk's warp sums it, in the warp's order, into the chunk's row of a
// workspace of ceil(n / kPiece) rows.  The chunk warps are the grid's
// first blocks, four a block; a chunk warp past seg_start[U] stops after
// one load, and the others find the segment holding their first position
// by a warp-wide search of seg_start (4-5 dependent loads).  The join is
// the last piece's: every piece, once its sums are stored, counts itself
// on the segment's counter with a fence before an atomicInc (an integer
// atomic: no float atomic anywhere), and the warp that counts last adds
// the pieces in position order, piece 0 (the segment's own row of sums)
// first, then pieces 1, 2, ... of the workspace, and writes the row.
// Which warp joins depends on timing; the order of the adds does not, so
// two runs give bitwise-equal sums.  Piece 0 counts once it is in sums:
// at once where the warp wrote it there, after the block's copy where it
// was staged (the warps' flags ride the copy's barrier, so a block with
// no split segment pays no second barrier).  The counters are the
// caller's: ceil(n / kPiece) + 1 u32, zeroed once, one a split segment
// (at floor(s0 / kPiece) + 1), and atomicInc wraps each back to 0 at its
// last piece, so every launch leaves them as it found them: no memset,
// no host read, nothing sized by U or by the longest segment (the
// workspace, the counters and the grid follow n), so a CUDA graph holds
// it.  Two launches that may run at once need counters of their own
// (sparse_apply keeps a set for each stream).  The chunk warps and the
// counting are out of line, so the segment blocks' hot path compiles as
// before: inlined, they cost the short-segment shapes up to 30 %
// (PERF.md).
//
// Which sums keep which order.  A segment of at most kShort occurrences:
// one thread in sorted order; of at most kPiece: the warp order above;
// both bitwise the sums of the one-warp design.  A longer one: each
// piece in the warp order, then the sequential join, so its sums differ
// from the one-warp order by rounding only, within
// sparse_apply.k1_error_bound (a piece's roundings plus the join's
// pieces - 1).
//
// What bounds it on short segments is not the bytes (~15 MB at a
// training batch, 4.6 us at full HBM bandwidth, against some 14.4 us on
// an H100): at D = 9 a warp's 4-byte load of its 32 lanes' rows touches
// 32 rows' sectors, 9 L1 wavefronts per occurrence.  A warp gathering
// rows into shared memory to cut that, and fewer registers for more
// resident blocks, both measured slower (PERF.md).  On long segments the
// pieces spread the rows over the card; what is left is latency: a
// warp's medium segments (up to kPiece each) one after another, and the
// hottest segment's join, pieces - 1 rows read in a chain of 8-deep
// loads.  Measured (tools/k1_bench.py --parent, from HBM, NVIDIA H100
// 80GB HBM3, 700.00 W), this design against the one-warp design,
// index_add_ and the byte bound: Avazu's batch 49.8 us (392.8, 69.6,
// 3.2); config 4's Zipf stream 686.3 us (39,249.7, 5,315.2, 166.4);
// config 4 at uniform ids 888.8 us (1,100.9, 1,541.9, 293.5); a Zipf
// stream at Criteo-Kaggle's n 28.9 us (423.9, 82.4, 3.1); the
// short-segment shapes from 16 % faster to 1.0 % slower, bitwise.
// The TPU kernel's [C, C] one-hot matmul and its VMEM carry across chunk
// boundaries exist because a TPU grid runs in order and scatters
// serialize; here the carry becomes the workspace and the counted join.
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
// The whole slot: K1 and K2 also take the whole seg_start slot of n + 1
// entries that the transfer stage ships, its tail past the batch's U
// unique ids padded with n.  K1 then covers n segments, every one past U
// empty (row -1, its sums not written), and K2 n rows, returning at once
// at a row -1.  Shapes and grids then depend on n alone and no host value
// of U is read, which a CUDA graph of the train step needs (the
// reference's static _k1_dedup(..., n_out) does the same for its jitted
// scan).  The first U rows are bitwise those of the cut slot [U + 1]:
// empty segments only ever follow the last real one.  The cost is the
// n - U empty slots: a seg_start load and a row id store each in K1, an
// id load in K2.
//
// K-place (kplace): the deduped entry stream (urows [U] ascending, as K1 emits
// them, a trailing run of -1 absent; sums [U, W]) expanded into a dense
// per-shard delta (or the dense step's table gradient) [vocab_local, W]: row
// urows[u] - row_lo gets sums[u], every other row 0, entries outside [row_lo,
// row_lo + vocab_local) dropped (the sentinel id of off-shard occurrences
// among them).  Nearly all of delta is zeros, so the kernel is a fill at the
// card's write rate with a few rows placed over it.  A 256-thread block owns a
// 16 KB tile of delta (1024 quads, any rows) and the grid is one block a tile,
// in order, as a fill's: the card then writes one dense front of delta, zeros
// alone at 0.89-0.98 of the byte bound, against 0.79-0.96 for a grid of as
// many blocks as fit, each sweeping its own run.  A block first stores its
// zeros, 16 bytes a store straight from registers, and only then looks for its
// entries: warps 0 and 1 find the run whose rows overlap the tile by a
// warp-wide search of urows (4 dependent loads at U = 2^17, against 17 for a
// binary search).  After one barrier the block writes those entries' floats
// that fall in its tile over its zeros, while they are still in L2: U * W * 4
// bytes written twice (about 1.7 MB against 151 MB at [2^21, 18]).  Two things
// the design turns on (PERF.md): stores first, since a block that reads urows
// or sums before its stores, or waits on them (a search, a map of its rows,
// its entries' rows in registers), holds its zeros back; and no DRAM reads
// amid the write stream, which cost more than the search itself.  So the first
// 1024 blocks, before their stores, ask L2 for all of urows and sums (U * (W +
// 1) * 4 bytes, a 1024th each, no wait) with evict_last priority, and the
// searches and the entries then read L2.  Nothing is staged in shared memory,
// so W sets neither the occupancy nor a width limit.  The design it replaces
// ran a block per tile of 256 rows held in shared memory: a 17-load binary
// search by two threads and two barriers before the tile's first store, 4-byte
// stores, 4 blocks an SM at W = 66, and 0.5-0.8 of its bound.  The TPU
// kernel's per-tile DMA window of entries and its one-hot placement matmul
// have no counterpart: a TPU grid step writes a fixed output block from VMEM,
// so it must bring its tile's entries in and place them by a matmul; here a
// store goes to any address of device memory, the zeros never pass through
// on-chip memory, and an entry is written where it belongs.
//
// Bound: memory.  At B = 4096, F = 39, D = 9 (n = 159,744 occurrences)
// K1 reads g_rows (5.75 MB), perm and the flat ids (0.64 MB each at most)
// and seg_start, and writes U * (2D + 1) * 4 bytes; K2 reads the sums and
// the row ids and reads and writes U * D * 4 bytes of each table it
// updates.  All do a handful of flops per byte.  K-place does none: it
// writes vocab_local * W * 4 bytes (151 MB at vocab_local = 2^21, W =
// 18, 45 us at 3.35 TB/s) and must read U * (W + 1) * 4 of the entries
// inside the shard (under 2 MB there); its prefetch reads all U.

#include <cuda_runtime.h>

#include <cstdint>

#include "adagrad.cuh"

namespace {

constexpr int kWarp = 32;
// K1: segments per block (one per thread), the longest segment a thread
// sums alone (sparse_apply.K1_SHORT must agree), the occurrences whose
// loads a thread issues together, and the floats of sums a block may
// stage in shared memory without an opt-in (48 KB less the block's
// split-segment masks).
constexpr int kSegs = 128;
constexpr int kShort = 16;
constexpr int kUnroll = 4;
constexpr int kStageFloats = 48 * 1024 / 4 - kSegs / kWarp;
// K1's pieces: the longest segment a warp sums alone, and the sorted
// positions of a piece and of a chunk (sparse_apply.K1_PIECE must
// agree); the chunks a block of chunk warps takes; and the partial sums
// a join loads before their adds.
constexpr int kPiece = 512;
constexpr int kChunkWarps = kSegs / kWarp;
constexpr int kJoinUnroll = 8;
// K2: threads per block, and lanes per row (columns of a row per pass).
constexpr int kK2Threads = 128;
constexpr int kK2Lanes = 16;
// K-place: threads per block, quads (16-byte stores) per tile, a block's
// share of delta (16 KB, 4 stores a thread), and the blocks that
// prefetch the entries into L2, about the card's first wave.
constexpr int kPlaceThreads = 256;
constexpr int kPlaceTileQuads = 1024;
constexpr unsigned kPlacePrefetchBlocks = 1024;

constexpr int kSgd = 0;
constexpr int kAdagrad = 1;
constexpr int kFtrl = 2;

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// First index of sorted a[0..n) whose value is >= key (n when none is),
// for a key >= 0, found by the whole warp: each step probes 32 evenly
// spaced entries at once and keeps the gap between the last one below
// the key and the first one not, so U = 2^17 entries take 4 dependent
// loads, not 17.  A negative entry counts as past every key: K1's rows
// on the whole slot end in a run of -1, which thereby sorts last and
// falls in no block's range (K-place).  K1's chunk warps search
// seg_start with it.  Every lane of the warp calls it and gets the
// index.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int n, int64_t key) {
  const int lane = threadIdx.x % kWarp;
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int step = (hi - lo - 1) / kWarp + 1;
    const int64_t i = lo + static_cast<int64_t>(lane) * step;
    bool below = false;
    if (i < hi) {
      const int v = a[i];
      below = v >= 0 && static_cast<int64_t>(v) < key;
    }
    // On a sorted a the lanes below the key are a prefix: c of them.
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) {
      hi = lo;
    } else {
      const int64_t top = lo + static_cast<int64_t>(c) * step;
      lo += (c - 1) * step + 1;
      hi = top < hi ? static_cast<int>(top) : hi;
    }
  }
  return lo;
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

// One warp's sum of sorted positions [b, e), columns in passes of kCols:
// lane l adds positions b + l, b + l + 32, ... in turn, a shuffle tree
// joins the lanes, and lane 0 stores the row at dst ([W] floats).
template <bool kSquare, int kCols>
__device__ __forceinline__ void warp_piece(const float* __restrict__ g_rows,
                                           const int* __restrict__ perm,
                                           int b, int e, int D,
                                           float* __restrict__ dst) {
  const int lane = threadIdx.x % kWarp;
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

// Counts one stored piece of the split segment [s0, s1) on its counter
// in `joins`; true for the piece that counts last.  The fence orders the
// piece's stores (and those the calling thread has seen through a
// barrier) before the count.
__device__ __forceinline__ bool count_piece(unsigned* __restrict__ joins,
                                            int s0, int s1) {
  const unsigned last = static_cast<unsigned>(s1 - s0 - 1) / kPiece;
  __threadfence();
  return atomicInc(&joins[s0 / kPiece + 1], last) == last;
}

// The join of a split segment, by one warp, lanes over the W columns:
// its row (piece 0's sums) plus the `more` workspace rows from `first`
// on (pieces 1, 2, ...), added in that order, the row stored back.  The
// loads go to L2 (the pieces were stored by other SMs).
__device__ __forceinline__ void join_pieces(float* __restrict__ row,
                                            const float* __restrict__ ws,
                                            int64_t first, int more,
                                            int W) {
  __threadfence();
  for (int c = threadIdx.x % kWarp; c < W; c += kWarp) {
    float acc = __ldcg(row + c);
    const float* col = ws + first * W + c;
    for (int j = 0; j < more; j += kJoinUnroll) {
      float x[kJoinUnroll];
#pragma unroll
      for (int q = 0; q < kJoinUnroll; ++q) {
        x[q] = j + q < more ? __ldcg(col + static_cast<int64_t>(j + q) * W)
                            : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kJoinUnroll; ++q) {
        if (j + q < more) acc = __fadd_rn(acc, x[q]);
      }
    }
    row[c] = acc;
  }
}

// The warp's split segments of the block at u0, once their piece 0 is
// stored in sums (by this warp, or by the block's copy before a
// barrier): each counts on its counter, and the warp joins each segment
// whose count it closed.  It reloads the segments' bounds, and stays out
// of line, so that the segment blocks' hot path carries nothing for it.
__device__ __noinline__ void count_splits(float* __restrict__ sums,
                                          const float* __restrict__ ws,
                                          unsigned* __restrict__ joins,
                                          const int* __restrict__ seg_start,
                                          int U, int W, int64_t u0) {
  const int lane = threadIdx.x % kWarp;
  const int64_t u = u0 + threadIdx.x;
  const int s0 = u < U ? seg_start[u] : 0;
  const int s1 = u < U ? seg_start[u + 1] : 0;
  __threadfence();
  __syncwarp();
  unsigned mine = __ballot_sync(
      0xffffffffu, s1 - s0 > kPiece && count_piece(joins, s0, s1));
  while (mine) {
    const int owner = __ffs(mine) - 1;
    mine &= mine - 1;
    const int b = __shfl_sync(0xffffffffu, s0, owner);
    const int e = __shfl_sync(0xffffffffu, s1, owner);
    join_pieces(sums + (u - lane + owner) * W, ws, b / kPiece + 1,
                (e - b - 1) / kPiece, W);
  }
}

// A chunk warp: chunk k >= 1 of the sorted positions (chunk 0 holds no
// piece j >= 1).  A chunk at or past seg_start[U] (the whole slot's
// padding, the cut slot's sentinel occurrences, or past n) has none;
// otherwise the segment holding position p0 = k kPiece is the last v
// with seg_start[v] <= p0.  If v started before
// the chunk and has a piece that starts in it, the warp sums that piece
// into ws row k, counts it, and joins the segment if it counted last.
// Every condition is the warp's.  Kept out of line, as the join is, so
// that the segment blocks' registers are their own.
template <bool kSquare, int kCols>
__device__ __noinline__ void chunk_warp(const float* __restrict__ g_rows,
                                        const int* __restrict__ perm,
                                        const int* __restrict__ seg_start,
                                        float* __restrict__ sums,
                                        float* __restrict__ ws,
                                        unsigned* __restrict__ joins, int U,
                                        int D, int64_t k) {
  const int64_t p0 = k * kPiece;
  // Past the last real position (the cut slot's sentinel tail) without
  // a search.
  if (p0 >= seg_start[U]) return;
  const int v = warp_lower_bound(seg_start, U + 1, p0 + 1) - 1;
  const int s0 = seg_start[v];
  const int s1 = seg_start[v + 1];
  const int64_t p = s0 + (p0 - s0 + kPiece - 1) / kPiece * kPiece;
  if (s0 >= p0 || p >= s1) return;
  const int W = (kSquare ? 2 : 1) * D;
  const int e = p + kPiece < s1 ? static_cast<int>(p + kPiece) : s1;
  warp_piece<kSquare, kCols>(g_rows, perm, static_cast<int>(p), e, D,
                             ws + k * W);
  const bool last = threadIdx.x % kWarp == 0 && count_piece(joins, s0, s1);
  if (__shfl_sync(0xffffffffu, last, 0)) {
    join_pieces(sums + static_cast<int64_t>(v) * W, ws, s0 / kPiece + 1,
                (s1 - s0 - 1) / kPiece, W);
  }
}

// kSquare: [sum g | sum g^2] of a [n, D] payload (sums [U, 2D]);
// otherwise the sum of a [n, D] payload as it is (sums [U, D]).  kCols
// columns per pass over a segment (k1_launch picks it).
// `stage`: the block's sums go through shared memory ([kSegs, W]).
// Blocks [0, chunk_blocks) are chunk warps (pieces j >= 1 of the split
// segments, into ws [ceil(n / kPiece), W], counted on joins
// [ceil(n / kPiece) + 1]); the others own kSegs segments each.
template <bool kSquare, int kCols>
__global__ void __launch_bounds__(kSegs)
    k1_kernel(const float* __restrict__ g_rows, const int* __restrict__ ids,
              const int* __restrict__ perm,
              const int* __restrict__ seg_start, int* __restrict__ urows,
              float* __restrict__ sums, float* __restrict__ ws,
              unsigned* __restrict__ joins, int U, int D, int chunk_blocks,
              bool stage) {
  extern __shared__ float staged[];
  __shared__ unsigned split_mask[kSegs / kWarp];
  constexpr int kWidth = kSquare ? 2 : 1;
  const int W = kWidth * D;
  const int t = threadIdx.x;
  const int lane = t % kWarp;
  if (static_cast<int>(blockIdx.x) < chunk_blocks) {
    chunk_warp<kSquare, kCols>(
        g_rows, perm, seg_start, sums, ws, joins, U, D,
        1 + static_cast<int64_t>(blockIdx.x) * kChunkWarps + t / kWarp);
    return;
  }
  const int64_t u0 =
      static_cast<int64_t>(static_cast<int>(blockIdx.x) - chunk_blocks) *
      kSegs;
  const int64_t u = u0 + t;
  // Every thread of a segment block stays to the end: the warp's ballot
  // and shuffles and the block's barrier take them all.  A thread past U
  // has an empty segment and writes nothing.  An empty segment below U
  // (the whole slot's past the batch's unique ids) gets row -1, which K2
  // skips, and no sums.
  int s0 = 0;
  int s1 = 0;
  if (u < U) {
    s0 = seg_start[u];
    s1 = seg_start[u + 1];
    urows[u] = s1 > s0 ? ids[perm[s0]] : -1;
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
  // The warp's long segments, one after another: the whole segment, or
  // piece 0 of a split one.  warp_piece's sum, written out: through the
  // helper the merge shapes with such segments measured up to 37 %
  // slower (PERF.md).
  unsigned todo = __ballot_sync(0xffffffffu, s1 - s0 > kShort);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const int b = __shfl_sync(0xffffffffu, s0, owner);
    const int e = __shfl_sync(0xffffffffu, s1, owner);
    const int e0 = e - b > kPiece ? b + kPiece : e;
    float* const dst = out + (owner - lane) * W;
    for (int c0 = 0; c0 < D; c0 += kCols) {
      float a1[kCols];
      float a2[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        a1[c] = 0.0f;
        a2[c] = 0.0f;
      }
      add_rows<kSquare>(g_rows, perm, b + lane, e0, kWarp, c0, D, a1, a2);
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
  // The split segments count once piece 0 is in sums: at once where the
  // warp wrote it there, after the block's copy where it was staged (the
  // warps' flags ride the copy's barrier; a second barrier only in a
  // block that has one).
  const unsigned splits = __ballot_sync(0xffffffffu, s1 - s0 > kPiece);
  bool count = splits != 0;
  if (stage) {
    if (lane == 0) split_mask[t / kWarp] = splits;
    // The block's non-empty segments are its first ones: a barrier that
    // counts them.
    const int m = __syncthreads_count(s1 > s0) * W;
    unsigned any = 0;
#pragma unroll
    for (int w = 0; w < kSegs / kWarp; ++w) any |= split_mask[w];
    float* const block_sums = sums + u0 * W;
    for (int i = t; i < m; i += kSegs) block_sums[i] = staged[i];
    if (any) {
      __threadfence();
      __syncthreads();
    }
    count = split_mask[t / kWarp] != 0;
  }
  if (count) count_splits(sums, ws, joins, seg_start, U, W, u0);
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
  // warp reaches the shuffle.  A group past U, or at row -1 (the whole
  // slot's past the batch's unique ids), writes nothing.
  int id = (lane == 0 && u < U) ? urows[u] : -1;
  id = __shfl_sync(0xffffffffu, id, 0, kK2Lanes);
  if (id < 0) return;
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

// K-place: block b owns tile b, the floats [f0, f1) of delta ([vocab_local,
// W], row-major): quads [b * kPlaceTileQuads, + kPlaceTileQuads), and the
// last block also the n % 4 floats past the last quad.  The first
// kPlacePrefetchBlocks blocks first ask L2 for a share of urows and sums
// (no wait).  Every thread stores its quads' zeros; then warps 0 and 1
// find the run of entries whose rows overlap the tile (its first and its
// end); after a barrier, which orders the block's own stores to one
// address, the block writes those entries' floats that fall inside
// [f0, f1).  A row that
// crosses into the next tile is written by each block in its own part,
// so no two blocks write one address.
__global__ void __launch_bounds__(kPlaceThreads)
    kplace_kernel(const int* __restrict__ urows,
                  const float* __restrict__ sums, int U, int64_t row_lo,
                  int64_t vocab_local, int W, float* __restrict__ delta) {
  __shared__ int range[2];
  const int t = threadIdx.x;
  const int warp = t / kWarp;
  const int64_t n = vocab_local * W;
  const int64_t quads = n / 4;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kPlaceTileQuads;
  const int64_t q1 =
      q0 + kPlaceTileQuads < quads ? q0 + kPlaceTileQuads : quads;
  const bool last = blockIdx.x == gridDim.x - 1;
  const int64_t f0 = 4 * q0;
  const int64_t f1 = last ? n : 4 * q1;
  if (blockIdx.x < kPlacePrefetchBlocks) {
    // A share of urows and sums into L2 ahead of the blocks that read
    // them, kept there (evict_last) while delta streams through.
    const int64_t blocks = gridDim.x < kPlacePrefetchBlocks
                               ? gridDim.x : kPlacePrefetchBlocks;
    const int64_t sum_lines = (static_cast<int64_t>(U) * W + 31) / 32;
    const int64_t lines = sum_lines + (static_cast<int64_t>(U) + 31) / 32;
    const int64_t l1 = lines * (blockIdx.x + 1) / blocks;
    for (int64_t l = lines * blockIdx.x / blocks + t; l < l1;
         l += kPlaceThreads) {
      const char* p =
          l < sum_lines
              ? reinterpret_cast<const char*>(sums) + 128 * l
              : reinterpret_cast<const char*>(urows) + 128 * (l - sum_lines);
      asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(p));
    }
  }
  float4* const out = reinterpret_cast<float4*>(delta);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int64_t q = q0 + t; q < q1; q += kPlaceThreads) out[q] = zero;
  if (last && 4 * quads + t < n) delta[4 * quads + t] = 0.0f;
  // The stores go first: keep the compiler from hoisting the search's
  // loads above them.
  asm volatile("" ::: "memory");
  if (warp < 2) {
    // Rows [f0 / W, ceil(f1 / W)) overlap the tile.
    const int64_t row = warp == 0 ? f0 / W : (f1 + W - 1) / W;
    const int e = warp_lower_bound(urows, U, row_lo + row);
    if (t % kWarp == 0) range[warp] = e;
  }
  __syncthreads();
  const int e0 = range[0];
  const int e1 = range[1];
  if (e0 >= e1) return;
  // The entries' sums are one flat run of (e1 - e0) * W floats; the
  // first entry's row may start before f0 and the last one's end past
  // f1, so the walk starts and stops at the tile's edges.  Position i
  // of the run is entry k = i / W, column c = i % W, kept by adding the
  // stride's quotient and remainder (one division a thread).
  const int64_t first = (static_cast<int64_t>(urows[e0]) - row_lo) * W;
  const int64_t end = (static_cast<int64_t>(urows[e1 - 1]) - row_lo) * W;
  const int64_t i0 = f0 > first ? f0 - first : 0;
  const int64_t i1 = static_cast<int64_t>(e1 - 1 - e0) * W +
                     (f1 - end < W ? f1 - end : W);
  int64_t i = i0 + t;
  int64_t k = i / W;
  int64_t c = i - k * W;
  const int step_k = kPlaceThreads / W;
  const int step_c = kPlaceThreads % W;
  for (; i < i1; i += kPlaceThreads) {
    const int e = e0 + static_cast<int>(k);
    const int64_t f = (static_cast<int64_t>(urows[e]) - row_lo) * W + c;
    // Always true for an ascending urows; keeps a caller that broke
    // that contract inside the block's tile.
    if (f >= f0 && f < f1) delta[f] = sums[static_cast<int64_t>(e) * W + c];
    k += step_k;
    c += step_c;
    if (c >= W) {
      c -= W;
      ++k;
    }
  }
}

// Launches K1 in either mode: the chunk warps' blocks (four chunks a
// block, from chunk 1 on), then one block per kSegs segments, the
// block's sums staged in shared memory when they fit.  kCols columns a
// pass over a segment's positions.
template <bool kSquare, int kCols>
int k1_launch(const void* payload, const void* ids, const void* perm,
              const void* seg_start, void* urows, void* sums, void* ws,
              void* joins, int U, int n, int D, void* stream) {
  if (U <= 0 || n < U || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t w = (kSquare ? 2 : 1) * static_cast<int64_t>(D);
  const bool stage = w * kSegs <= kStageFloats;
  const int64_t chunks = (static_cast<int64_t>(n) + kPiece - 1) / kPiece;
  const int64_t chunk_blocks =
      chunks > 1 ? (chunks - 1 + kChunkWarps - 1) / kChunkWarps : 0;
  const int64_t blocks =
      chunk_blocks + (static_cast<int64_t>(U) + kSegs - 1) / kSegs;
  k1_kernel<kSquare, kCols><<<static_cast<unsigned>(blocks), kSegs,
                              stage ? w * kSegs * sizeof(float) : 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(payload), static_cast<const int*>(ids),
      static_cast<const int*>(perm), static_cast<const int*>(seg_start),
      static_cast<int*>(urows), static_cast<float*>(sums),
      static_cast<float*>(ws), static_cast<unsigned*>(joins), U, D,
      static_cast<int>(chunk_blocks), stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).  The caller checks shapes, types and contiguity and
// allocates urows [U], sums [U, 2D] and the workspace ws
// [ceil(n / K1_PIECE), 2D], and owns the join counters joins
// [ceil(n / K1_PIECE) + 1] u32, zero before the first launch and left
// zero by each; n is the payload's rows.
extern "C" int k1_dedup(const void* g_rows, const void* ids,
                        const void* perm, const void* seg_start, void* urows,
                        void* sums, void* ws, void* joins, int U, int n,
                        int D, void* stream) {
  return k1_launch<true, 16>(g_rows, ids, perm, seg_start, urows, sums, ws,
                             joins, U, n, D, stream);
}

// K1 merge mode: sums [U, P] of a [n, P] payload taken as it is (ws
// [ceil(n / K1_PIECE), P]).  16 columns a pass up to P = 16, else 32; a
// column's sum is the same at any width.  Dedup mode takes 16 (32
// accumulators with the squares): D = 33 in two passes of 17 measured
// 25 % slower than three of 16 (PERF.md).
extern "C" int k1_merge(const void* payload, const void* ids,
                        const void* perm, const void* seg_start, void* urows,
                        void* sums, void* ws, void* joins, int U, int n,
                        int P, void* stream) {
  const auto launch = P <= 16 ? k1_launch<false, 16> : k1_launch<false, 32>;
  return launch(payload, ids, perm, seg_start, urows, sums, ws, joins, U, n,
                P, stream);
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

// K-place.  Writes every element of delta [vocab_local, W] (16-byte
// aligned); urows [U] ascending (U may be 0), sums [U, W].  One block a
// tile of kPlaceTileQuads quads: the grid depends on vocab_local and W
// alone.
extern "C" int kplace(const void* urows, const void* sums, int U,
                      long long row_lo, long long vocab_local, int W,
                      void* delta, void* stream) {
  if (U < 0 || W < 1 || vocab_local < 1 || row_lo < 0 ||
      reinterpret_cast<uintptr_t>(delta) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t quads = vocab_local * W / 4;
  const int64_t tiles =
      quads > 0 ? (quads + kPlaceTileQuads - 1) / kPlaceTileQuads : 1;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kplace_kernel<<<static_cast<unsigned>(tiles), kPlaceThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(urows), static_cast<const float*>(sums), U,
      row_lo, vocab_local, W, static_cast<float*>(delta));
  return static_cast<int>(cudaGetLastError());
}
