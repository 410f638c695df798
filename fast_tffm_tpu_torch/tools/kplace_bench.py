"""K-place at the four shapes the main paths launch it at, beside its
plain version, its library formulation, its byte bound and, on request,
an earlier tree's kernel and the probes its design was chosen by.

    python -m fast_tffm_tpu_torch.tools.kplace_bench [--parent TREE] [--probes]

Needs a CUDA device and ``nvcc``.  Each shape's entry stream is made from
a seed: ``placed`` ascending unique rows inside the shard (uniform over
it), ``below`` rows of the shard below it and one sentinel row above it
(K-place drops both), then ``absent`` rows -1 (the whole slot's tail),
with normal ``sums [U, W]``.  Per shape, in one process on one card:

- ``kernel``: ``ops.sparse_apply.kplace_cuda``;
- ``plain``: ``kplace_plain`` (zeros, a spare row, ``index_copy_``);
- ``library``: two PyTorch calls on a preallocated delta, ``zero_()``
  then one ``index_copy_`` of the entries inside the shard (their rows
  and sums cut beforehand); ``fill``: the ``zero_()`` alone;
- ``parent`` (``--parent TREE``): the ``kplace`` entry point of
  ``TREE/fast_tffm_tpu_torch/ops/csrc/sparse_apply.cu`` (an unpacked
  earlier commit), built here with ``nvcc`` alone;
- with ``--probes``, the kernels of ``PROBE_SRC`` (see ``PROBES``): the
  tile-in-shared-memory design K-place had before with its binary search
  replaced by the true tile ranges, zeros alone with 16-byte stores on
  two grids, and the alternatives to the kernel's design that were
  measured against it.

Every output is checked against the plain version bit for bit (the
zero and load probes against zeros).  Each variant is timed in CUDA
graphs of 10 calls (the median of 7 replays), the list in order and
reversed in turn (``--turns``, 2 by default); ``ms`` is the least.
Prints the card's name and power limit, then one JSON line.  The builds
go to ``ops/_build/kplace_bench/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from fast_tffm_tpu_torch.tools.bench_common import PEAK_BYTES_PER_S, build_lib

# name: (vocab_local, W, row_lo, placed, below, absent); the smoke's
# record each one stands for.
SHAPES = {
    # kernel_timing's [2^21, 18]: the sharded dense exchange (path 3) on
    # model shard 1, K1's rows of a data block's ids.
    "kplace": (1 << 21, 18, 1 << 21, 24_000, 24_000, 0),
    # path 9's [2^22, 9]: the dense gradient of a 4096-line batch, the
    # whole slot of n = 159,744 rows.
    "kplace_dense": (1 << 22, 9, 0, 106_000, 0, 53_744),
    # path 12's kplace_w9 and kplace_w66: the dense mesh gradient and
    # FFM's dense exchange on a shard, in its own coordinates.
    "kplace_w9": (1 << 21, 9, 0, 30_000, 0, 0),
    "kplace_w66": (1 << 21, 66, 0, 27_000, 0, 0),
}
CALLS = 10  # calls a graph: up to 554 MB written a call
RESIDENT = 8  # blocks of 256 threads an SM holds at once
# name: (probe kernel, quads a tile; 0: the quads over as many tiles as
# blocks fit on the card at once, one long run a block).  A block a tile,
# in order.  Kernels (probe_run): 0 zeros alone; 1 warps 0 and 1 search
# the tile's entry run before their zeros, a barrier, the entries (the
# others store at once); 2 as 1 with the run passed in (no search); 3
# zeros, then a second kernel scattering every entry; 5 as 2 with the
# entries loaded, not stored; 6 as 5 with the loads from the first 4 KB
# of urows and sums (in cache); 7 each float stored once, a quad
# composed from a map of the tile's rows in shared memory (the run
# passed in); 10 + f: the kernel's design (zeros, then the search, a
# barrier, the entries) with f & 1: the first 1024 blocks first prefetch
# urows and sums into L2 (evict_last), as the kernel does; f & 2:
# evict-first zero stores; f & 4: every warp searches (no shared
# memory).
PROBES = {
    "zeros_runs": (0, 0),
    "zeros_tiles": (0, 1024),
    "search_first_runs": (1, 0),
    "search_first_tiles": (1, 1024),
    "run_given_tiles": (2, 1024),
    "fill_then_scatter": (3, 1024),
    "loads_only": (5, 1024),
    "cached_loads_only": (6, 1024),
    "merged": (7, 1024),
    "no_prefetch": (10, 1024),
    "evict_first": (13, 1024),
    "every_warp_searches": (15, 1024),
    "tiles_8k": (11, 512),
    "tiles_32k": (11, 2048),
}

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// K-place's design before this one ran a block per tile of output rows
// held in shared memory; here the tile's entry run comes in as
// starts[b], starts[b + 1] in place of its 17-load binary search.
__global__ void tile_starts_kernel(const int* __restrict__ urows,
                                   const float* __restrict__ sums,
                                   const int* __restrict__ starts,
                                   int64_t row_lo, int64_t vocab_local,
                                   int W, int tile_rows,
                                   float* __restrict__ delta) {
  extern __shared__ float tile[];
  const int e0 = starts[blockIdx.x];
  const int e1 = starts[blockIdx.x + 1];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t left = vocab_local - r0;
  const int rows = left < tile_rows ? static_cast<int>(left) : tile_rows;
  const int n = rows * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();
  const int m = (e1 - e0) * W;
  const float* src = sums + static_cast<int64_t>(e0) * W;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int e = i / W;
    const int64_t r = static_cast<int64_t>(urows[e0 + e]) - row_lo - r0;
    if (r >= 0 && r < rows) tile[r * W + (i - e * W)] = src[i];
  }
  __syncthreads();
  float* dst = delta + r0 * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = tile[i];
}

__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int n, int64_t key) {
  const int lane = threadIdx.x % 32;
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int step = (hi - lo - 1) / 32 + 1;
    const int64_t i = lo + static_cast<int64_t>(lane) * step;
    bool below = false;
    if (i < hi) {
      const int v = a[i];
      below = v >= 0 && static_cast<int64_t>(v) < key;
    }
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

// The tile [f0, f1)'s entry run [e0, e1) written over its zeros, each
// thread a float in turn; kLoadsOnly: loaded, not stored (kCached: from
// the first 4 KB of urows and sums, over the run's whole length).
template <bool kLoadsOnly, bool kCached>
__device__ __forceinline__ void place(const int* __restrict__ urows,
                                      const float* __restrict__ sums,
                                      int64_t row_lo, int W, int64_t f0,
                                      int64_t f1, int e0, int e1,
                                      float* __restrict__ delta) {
  const int hot = kCached ? 1023 : -1;
  const int t = threadIdx.x;
  const int64_t first =
      kCached ? f0 : (static_cast<int64_t>(urows[e0]) - row_lo) * W;
  const int64_t end =
      kCached ? f1 : (static_cast<int64_t>(urows[e1 - 1]) - row_lo) * W;
  const int64_t i0 = f0 > first ? f0 - first : 0;
  const int64_t i1 = static_cast<int64_t>(e1 - 1 - e0) * W +
                     (f1 - end < W ? f1 - end : W);
  int64_t i = i0 + t;
  int64_t k = i / W;
  int64_t c = i - k * W;
  float acc = 0.0f;
  for (; i < i1; i += 256) {
    const int e = e0 + static_cast<int>(k);
    const int64_t f = (static_cast<int64_t>(urows[e & hot]) - row_lo) * W + c;
    if ((f >= f0 && f < f1) || kCached) {
      const float v = sums[(static_cast<int64_t>(e) * W + c) & hot];
      if (kLoadsOnly) {
        acc += v + static_cast<float>(f);
      } else {
        delta[f] = v;
      }
    }
    k += 256 / W;
    c += 256 % W;
    if (c >= W) {
      c -= W;
      ++k;
    }
  }
  if (kLoadsOnly && acc == 1.2345e30f) delta[f0] = acc;
}

// Block j: tile j of tq quads (the last also the floats past the last
// quad).  kKind as probe_run's.
template <int kKind>
__global__ void __launch_bounds__(256)
    tiles_kernel(const int* __restrict__ urows,
                 const float* __restrict__ sums,
                 const int* __restrict__ ranges, int U, int64_t row_lo,
                 int64_t vocab_local, int W, int64_t tq,
                 float* __restrict__ delta) {
  __shared__ int range[2];
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int64_t n = vocab_local * W;
  const int64_t quads = n / 4;
  const int64_t j = blockIdx.x;
  const int64_t q0 = j * tq;
  const int64_t q1 = q0 + tq < quads ? q0 + tq : quads;
  const bool last = blockIdx.x == gridDim.x - 1;
  const int64_t f0 = 4 * q0;
  const int64_t f1 = last ? n : 4 * q1;
  if (kKind == 1 && warp < 2) {
    const int64_t row = warp == 0 ? f0 / W : (f1 + W - 1) / W;
    const int e = warp_lower_bound(urows, U, row_lo + row);
    if (t % 32 == 0) range[warp] = e;
  }
  if (kKind >= 2 && kKind != 3 && t < 2) range[t] = ranges[2 * j + t];
  float4* const out = reinterpret_cast<float4*>(delta);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int64_t q = q0 + t; q < q1; q += 256) out[q] = zero;
  if (last && 4 * quads + t < n) delta[4 * quads + t] = 0.0f;
  if (kKind == 0 || kKind == 3) return;
  __syncthreads();
  if (range[0] < range[1]) {
    place<kKind >= 5, kKind == 6>(urows, sums, row_lo, W, f0, f1, range[0],
                                  range[1], delta);
  }
}

// After a zero fill: every in-shard entry's row, a thread an element.
__global__ void scatter_kernel(const int* __restrict__ urows,
                               const float* __restrict__ sums, int U,
                               int64_t row_lo, int64_t vocab_local, int W,
                               float* __restrict__ delta) {
  const int64_t m = static_cast<int64_t>(U) * W;
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < m;
       i += 256LL * gridDim.x) {
    const int64_t e = i / W;
    const int64_t r = static_cast<int64_t>(urows[e]) - row_lo;
    if (urows[e] >= 0 && r >= 0 && r < vocab_local) {
      delta[r * W + (i - e * W)] = sums[i];
    }
  }
}

// Each float written once: the tile's rows -> entry map in shared
// memory, then each quad composed (zeros, or its entries' sums) and
// stored.  A block a tile, the run from ranges.
__global__ void __launch_bounds__(256)
    merged_kernel(const int* __restrict__ urows,
                  const float* __restrict__ sums,
                  const int* __restrict__ ranges, int64_t row_lo,
                  int64_t vocab_local, int W, int64_t tq,
                  float* __restrict__ delta) {
  extern __shared__ int map[];
  const int t = threadIdx.x;
  const int64_t n = vocab_local * W;
  const int64_t quads = n / 4;
  const int64_t j = blockIdx.x;
  const int64_t q0 = j * tq;
  const int64_t q1 = q0 + tq < quads ? q0 + tq : quads;
  const bool last = blockIdx.x == gridDim.x - 1;
  const int64_t f0 = 4 * q0;
  const int64_t f1 = last ? n : 4 * q1;
  const int64_t r_lo = f0 / W;
  const int rows = static_cast<int>((f1 + W - 1) / W - r_lo);
  for (int i = t; i < rows; i += 256) map[i] = -1;
  __syncthreads();
  for (int e = ranges[2 * j] + t; e < ranges[2 * j + 1]; e += 256) {
    const int64_t r = static_cast<int64_t>(urows[e]) - row_lo - r_lo;
    if (r >= 0 && r < rows) map[r] = e;
  }
  __syncthreads();
  float4* const out = reinterpret_cast<float4*>(delta);
  int64_t r = (f0 + 4 * t) / W;
  int64_t c = f0 + 4 * t - r * W;
  for (int64_t q = q0 + t; q < q1; q += 256) {
    float v[4];
    int64_t rr = r;
    int64_t cc = c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = map[rr - r_lo];
      v[k] = e >= 0 ? sums[static_cast<int64_t>(e) * W + cc] : 0.0f;
      if (++cc == W) {
        cc = 0;
        ++rr;
      }
    }
    out[q] = make_float4(v[0], v[1], v[2], v[3]);
    r += 1024 / W;
    c += 1024 % W;
    if (c >= W) {
      c -= W;
      ++r;
    }
  }
  const int64_t ft = 4 * quads + t;
  if (last && ft < n) {
    const int64_t rt = ft / W;
    const int e = map[rt - r_lo];
    delta[ft] = e >= 0 ? sums[static_cast<int64_t>(e) * W + ft - rt * W]
                       : 0.0f;
  }
}

// The kernel's design, a block a tile: zeros, then the search (warps 0
// and 1, or every warp with kFlags & 4), a barrier, the entries; & 1:
// the first 1024 blocks first prefetch urows and sums into L2
// (evict_last), a 1024th each; & 2: evict-first zero stores.
template <int kFlags>
__global__ void __launch_bounds__(256)
    after_kernel(const int* __restrict__ urows,
                 const float* __restrict__ sums,
                 const int* __restrict__ ranges, int U, int64_t row_lo,
                 int64_t vocab_local, int W, int64_t tq,
                 float* __restrict__ delta) {
  __shared__ int range[2];
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int64_t n = vocab_local * W;
  const int64_t quads = n / 4;
  if ((kFlags & 1) && blockIdx.x < 1024) {
    const int64_t nb = gridDim.x < 1024 ? gridDim.x : 1024;
    const int64_t lines_s = (static_cast<int64_t>(U) * W * 4 + 127) / 128;
    const int64_t lines = lines_s + (static_cast<int64_t>(U) * 4 + 127) / 128;
    const int64_t l1 = lines * (blockIdx.x + 1) / nb;
    for (int64_t l = lines * blockIdx.x / nb + t; l < l1; l += 256) {
      const char* p = l < lines_s
          ? reinterpret_cast<const char*>(sums) + 128 * l
          : reinterpret_cast<const char*>(urows) + 128 * (l - lines_s);
      asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(p));
    }
  }
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * tq;
  const int64_t q1 = q0 + tq < quads ? q0 + tq : quads;
  const bool last = blockIdx.x == gridDim.x - 1;
  const int64_t f0 = 4 * q0;
  const int64_t f1 = last ? n : 4 * q1;
  float4* const out = reinterpret_cast<float4*>(delta);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int64_t q = q0 + t; q < q1; q += 256) {
    if (kFlags & 2) {
      __stcs(out + q, zero);
    } else {
      out[q] = zero;
    }
  }
  if (last && 4 * quads + t < n) delta[4 * quads + t] = 0.0f;
  int e0;
  int e1;
  if (kFlags & 4) {
    e0 = warp_lower_bound(urows, U, row_lo + f0 / W);
    e1 = warp_lower_bound(urows, U, row_lo + (f1 + W - 1) / W);
    __syncthreads();
  } else {
    if (warp < 2) {
      const int64_t row = warp == 0 ? f0 / W : (f1 + W - 1) / W;
      const int e = warp_lower_bound(urows, U, row_lo + row);
      if (t % 32 == 0) range[warp] = e;
    }
    __syncthreads();
    e0 = range[0];
    e1 = range[1];
  }
  if (e0 < e1) {
    place<false, false>(urows, sums, row_lo, W, f0, f1, e0, e1, delta);
  }
}

}  // namespace

extern "C" int probe_tile_starts(const void* urows, const void* sums,
                                 const void* starts, long long row_lo,
                                 long long vocab_local, int W,
                                 void* delta, void* stream) {
  constexpr int kSmemFloats = (48 * 1024 - 64) / 4;
  const int tile_rows = kSmemFloats / W < 256 ? kSmemFloats / W : 256;
  const int64_t blocks = (vocab_local + tile_rows - 1) / tile_rows;
  tile_starts_kernel<<<static_cast<unsigned>(blocks), 256,
                       static_cast<size_t>(tile_rows) * W * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(urows), static_cast<const float*>(sums),
      static_cast<const int*>(starts), row_lo, vocab_local, W, tile_rows,
      static_cast<float*>(delta));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_tile_rows(int W) {
  constexpr int kSmemFloats = (48 * 1024 - 64) / 4;
  return kSmemFloats / W < 256 ? kSmemFloats / W : 256;
}

// kind as the tool's PROBES; a block a tile of tq quads.
extern "C" int probe_run(int kind, const void* urows, const void* sums,
                         const void* ranges, int U, long long row_lo,
                         long long vocab_local, int W, long long tq,
                         void* delta, void* stream) {
  const int64_t quads = vocab_local * W / 4;
  const int64_t g = quads > 0 ? (quads + tq - 1) / tq : 1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int*>(urows);
  const auto* s = static_cast<const float*>(sums);
  const auto* rg = static_cast<const int*>(ranges);
  auto* d = static_cast<float*>(delta);
  const auto go = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(g), 256, 0, st>>>(
        r, s, rg, U, row_lo, vocab_local, W, tq, d);
  };
  switch (kind) {
    case 0: go(tiles_kernel<0>); break;
    case 1: go(tiles_kernel<1>); break;
    case 2: go(tiles_kernel<2>); break;
    case 3: {
      go(tiles_kernel<3>);
      const int64_t m = static_cast<int64_t>(U) * W;
      const int64_t sg = m > 0 ? (m + 255) / 256 : 1;
      scatter_kernel<<<static_cast<unsigned>(sg < 1056 ? sg : 1056), 256, 0,
                       st>>>(r, s, U, row_lo, vocab_local, W, d);
      break;
    }
    case 5: go(tiles_kernel<5>); break;
    case 6: go(tiles_kernel<6>); break;
    case 7:
      merged_kernel<<<static_cast<unsigned>(g), 256,
                      ((4 * tq + 3) / W + 3) * sizeof(int), st>>>(
          r, s, rg, row_lo, vocab_local, W, tq, d);
      break;
    case 10: go(after_kernel<0>); break;
    case 11: go(after_kernel<1>); break;
    case 13: go(after_kernel<3>); break;
    case 15: go(after_kernel<5>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def entries(shape: str, dev):
    """``(urows [U] i32, sums [U, W] f32)`` of one shape, from a seed."""
    vocab_local, w, row_lo, placed, below, absent = SHAPES[shape]
    rng = np.random.default_rng(w + vocab_local)
    rows = [np.sort(rng.choice(row_lo, below, replace=False))] if below \
        else []
    rows.append(row_lo + np.sort(rng.choice(vocab_local, placed,
                                            replace=False)))
    rows.append([row_lo + vocab_local])  # the sentinel
    rows.append(np.full(absent, -1))
    urows = np.concatenate(rows).astype(np.int32)
    sums = rng.normal(size=(urows.size, w)).astype(np.float32)
    return torch.from_numpy(urows).to(dev), torch.from_numpy(sums).to(dev)


def tile_ranges(urows, row_lo: int, vocab_local: int, w: int, tq: int):
    """Per tile of ``tq`` quads, the run of entries whose rows overlap it:
    ``[e0, e1]`` pairs, int32, from ``torch.searchsorted``."""
    n = vocab_local * w
    quads = n // 4
    tiles = max(1, -(-quads // tq))
    j = torch.arange(tiles, device=urows.device, dtype=torch.int64)
    f0 = 4 * tq * j
    f1 = torch.clamp(4 * tq * (j + 1), max=4 * quads)
    f1[-1] = n
    key = torch.where(urows < 0, torch.iinfo(torch.int64).max, urows.long())
    lo = torch.searchsorted(key, row_lo + f0 // w)
    hi = torch.searchsorted(key, row_lo + (f1 + w - 1) // w)
    return torch.stack([lo, hi], 1).reshape(-1).to(torch.int32).contiguous()


def bound_ms(shape: str) -> float:
    """The placed entries read once (row and sums), delta written once."""
    vocab_local, w, _, placed, _, _ = SHAPES[shape]
    return 4 * (placed * (w + 1) + vocab_local * w) / PEAK_BYTES_PER_S * 1e3


def variants(shape: str, dev, parent, probes) -> dict:
    """name -> ``(call returning delta, what it must equal)``."""
    from fast_tffm_tpu_torch.ops import sparse_apply as sa

    vocab_local, w, row_lo, *_ = SHAPES[shape]
    urows, sums = entries(shape, dev)
    want = sa.kplace_plain(urows, sums, row_lo, vocab_local)
    zeros = torch.zeros_like(want)
    inside = (urows >= row_lo) & (urows < row_lo + vocab_local)
    idx = (urows[inside].long() - row_lo).contiguous()
    vals = sums[inside].contiguous()
    lib_delta = torch.empty_like(want)

    def library():
        lib_delta.zero_()
        return lib_delta.index_copy_(0, idx, vals)

    def native(fn, args):
        def call():
            delta = torch.empty_like(want)
            err = fn(*args(delta), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
            return delta
        return call

    out = {
        "kernel": (lambda: sa.kplace_cuda(urows, sums, row_lo, vocab_local),
                   want),
        "plain": (lambda: sa.kplace_plain(urows, sums, row_lo, vocab_local),
                  want),
        "library": (library, want),
        "fill": (lambda: lib_delta.zero_(), zeros),
    }
    u = urows.numel()
    if parent is not None:
        out["parent"] = (native(parent.kplace, lambda d: (
            urows.data_ptr(), sums.data_ptr(), u, row_lo, vocab_local, w,
            d.data_ptr())), want)
    if probes is not None:
        tile_rows = probes.probe_tile_rows(w)
        bounds = row_lo + torch.clamp(torch.arange(
            0, vocab_local + tile_rows, tile_rows, device=dev),
            max=vocab_local)
        key = torch.where(urows < 0, torch.iinfo(torch.int64).max,
                          urows.long())
        starts = torch.searchsorted(key, bounds).to(torch.int32)
        out["tile_starts"] = (native(probes.probe_tile_starts, lambda d: (
            urows.data_ptr(), sums.data_ptr(), starts.data_ptr(), row_lo,
            vocab_local, w, d.data_ptr())), want)
        resident = RESIDENT * torch.cuda.get_device_properties(
            dev).multi_processor_count
        quads = vocab_local * w // 4
        for name, (kind, tq) in PROBES.items():
            tq = tq or -(-quads // resident)
            ranges = tile_ranges(urows, row_lo, vocab_local, w, tq)
            out[name] = (native(probes.probe_run, lambda d, k=kind, r=ranges,
                                tq=tq: (
                k, urows.data_ptr(), sums.data_ptr(), r.data_ptr(), u,
                row_lo, vocab_local, w, tq, d.data_ptr())),
                zeros if kind in (0, 5, 6) else want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree of this repo whose "
                    "sparse_apply.cu to time beside the kernel")
    ap.add_argument("--probes", action="store_true",
                    help="also time the probes of PROBE_SRC")
    ap.add_argument("--turns", type=int, default=2,
                    help="times each variant is timed, the list in order "
                    "and reversed in turn (default 2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kplace_bench: needs a CUDA device", file=sys.stderr)
        return 1
    from fast_tffm_tpu_torch.ops import _build
    from fast_tffm_tpu_torch.tools.fm_widths import graph_ms

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(card, flush=True)
    out_dir = os.path.join(_build.BUILD_DIR, "kplace_bench")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    parent = probes = None
    if args.parent:
        csrc = os.path.join(os.path.abspath(args.parent),
                            "fast_tffm_tpu_torch", "ops", "csrc")
        parent, log = build_lib(out_dir, "parent",
                                os.path.join(csrc, "sparse_apply.cu"), csrc)
        print(log, file=sys.stderr, flush=True)
        parent.kplace.argtypes = [ptr, ptr, i32, i64, i64, i32, ptr, ptr]
        parent.kplace.restype = i32
    if args.probes:
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(out_dir, "kplace_probes.cu")
        with open(src, "w") as f:
            f.write(PROBE_SRC)
        probes, log = build_lib(out_dir, "probes", src)
        print(log, file=sys.stderr, flush=True)
        probes.probe_tile_starts.argtypes = [ptr, ptr, ptr, i64, i64, i32,
                                             ptr, ptr]
        probes.probe_run.argtypes = [i32, ptr, ptr, ptr, i32, i64, i64, i32,
                                     i64, ptr, ptr]
        probes.probe_tile_rows.argtypes = [i32]
        for fn in (probes.probe_tile_starts, probes.probe_run,
                   probes.probe_tile_rows):
            fn.restype = i32
    record = {}
    for shape in SHAPES:
        calls = variants(shape, dev, parent, probes)
        rec = {"vocab_local": SHAPES[shape][0], "W": SHAPES[shape][1],
               "row_lo": SHAPES[shape][2], "placed": SHAPES[shape][3],
               "bound_ms": bound_ms(shape), "bound_by": "bytes",
               "bitwise": {}, "graph_ms": {name: [] for name in calls}}
        for name, (fn, want) in calls.items():
            got = fn()
            torch.cuda.synchronize()
            rec["bitwise"][name] = bool(torch.equal(got, want))
            del got
        for turn in range(args.turns):
            for name in list(calls)[::-1 if turn % 2 else 1]:
                rec["graph_ms"][name].append(
                    graph_ms(calls[name][0], calls=CALLS))
        rec["ms"] = {name: min(t) for name, t in rec["graph_ms"].items()}
        rec["of_bound"] = {name: rec["bound_ms"] / t
                           for name, t in rec["ms"].items()}
        record[shape] = rec
        del calls
        torch.cuda.empty_cache()
        print(json.dumps({shape: rec["ms"], "bitwise": rec["bitwise"]}),
              flush=True)
    print(json.dumps({"kplace_bench": record, "card": card}), flush=True)
    ok = all(all(r["bitwise"].values()) for r in record.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
