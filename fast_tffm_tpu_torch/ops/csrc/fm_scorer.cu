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
// Bound: the bytes, in principle.  The kernel reads each row element and
// value once, B*F*(4D+4) bytes in f32 (1.6 MB at B=1024, F=39, D=9: about
// 0.5 us at 3.35 TB/s) and B*F*(2D+2) in bf16 (3.2 MB at B=4096), and does
// about B*F*(4D-2) flops, two orders of magnitude below the f32 rate.  In
// practice the latency of its loads sets its time: a warp per example
// with lanes over k walks the F features one after another, each add
// waiting on a load, with 24 of 32 lanes idle at D = 9; halving the
// bytes (bf16) moved its time little.  The design:
//
// - Lanes over (example, k): an example takes g = K rounded up to a power
//   of two lanes, at least 8 and at most 32 (a wider row takes several
//   column passes), so a warp sums 32 / g examples (four at D = 9) and
//   each of its loads covers that many rows' neighbouring columns.
// - Loads before adds: a lane loads a batch of 32 features' row elements
//   into registers before it adds any of them, every load issued at an
//   address clamped into the row (no load behind a divergent branch),
//   so it waits for two round trips at F = 39, not 39.  A batch's values
//   are loaded once for the example, coalesced (lane p takes features p,
//   p + g, ...), and passed round by shuffles rather than loaded again
//   by each of its lanes; the linear term's weights are loaded with the
//   batch and added after it.  Where an example has a warp to itself (K > 16)
//   a row's last batch takes only its own features, 8 at a time: at
//   F = 39 the 25 clamped loads and shuffles of a full batch cost each
//   example more than the round trip they save once the card is full
//   (D = 33, B = 4096: 5.7 against 7.9 us in bf16, PERF.md).
// - The earlier kernel's order of summation, kept exactly: s1_k and s2_k
//   over f = 0 .. F-1 in turn; the linear term as a warp of lanes over f
//   sums it (lane v adds f = v, v + 32, ... in turn, and a butterfly
//   joins the 32 lanes), here with each lane of an example holding the
//   32 / g butterfly inputs v = p, p + g, ... (their loads in the same
//   batches) and joining them in the butterfly's order before the
//   shuffles; the interaction term over the example's g lanes, which is
//   what a warp's butterfly gives when every lane from K on holds 0.  So
//   the outputs are bitwise the earlier kernel's, and two runs are
//   bitwise equal.
//
// The rows of an example start at a 4-byte boundary (F*D*4 = 1,404 bytes
// at F = 39), so the loads stay 4 bytes wide.  Copying a block's rows
// into shared memory first (one coalesced copy, then the sums from
// there) measured slower below B = 4096 (PERF.md).  Spreading one example's F
// over several warps would fill more SMs at the smallest batches, but it
// changes the order of summation, which the bf16 training step's checks
// see through bf16 roundings of the gradient.  The TPU kernel's [B, F*D]
// flattening, one-hot selection matmuls and three-way bf16 split exist
// for the TPU's 128 lanes and matrix unit and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The features a part of a trimmed batch takes (see `trim` below).
constexpr int kTail = 8;

// 2^kLog2 lanes per example (3 <= kLog2 <= 5), one warp a block.  A
// batch is kWarp features, so that the linear term's butterfly input of
// feature f is the same in every batch (f mod 32).
template <typename T, int kLog2>
__global__ void __launch_bounds__(kWarp)
    fm_scores_fwd_kernel(const T* __restrict__ rows,
                         const T* __restrict__ vals,
                         float* __restrict__ scores,
                         float* __restrict__ s1_out, int B, int F, int D) {
  constexpr int kLanes = 1 << kLog2;      // g
  constexpr int kParts = kWarp >> kLog2;  // examples a warp, inputs a lane
  const int lane = threadIdx.x;
  const int p = lane & (kLanes - 1);      // this lane's place in its example
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kParts + (lane >> kLog2);
  // Every lane stays to the end and runs every loop, for the full-mask
  // shuffles; a lane past the batch reads the first example's row (its
  // clamped loads need an address) and adds and writes nothing.
  const bool live = b < B;
  const int K = D - 1;
  const int Fl = live ? F : 0;  // the features this lane adds
  const T* row_b = rows + (live ? b : 0) * F * D;
  const T* val_b = vals + (live ? b : 0) * F;

  float part[kParts];  // linear: butterfly input v = p + g*m
#pragma unroll
  for (int m = 0; m < kParts; ++m) part[m] = 0.0f;
  float inter = 0.0f;  // this lane's sum over its k of s1_k^2 - s2_k
  for (int k0 = 0; k0 < K || k0 == 0; k0 += kLanes) {
    const int c = 1 + k0 + p;  // the row's column of factor k
    const bool on = c <= K;
    float s1 = 0.0f;
    float s2 = 0.0f;
    // F, not Fl: every lane of the warp takes the shuffles below.
    for (int f0 = 0; f0 < F; f0 += kWarp) {
      // The batch's values, each loaded once for the example (lane p
      // holds features f0 + p + g*m) and passed round by shuffles; its
      // row elements, this lane's column of each feature.  Every load
      // is issued (at an address clamped into the row), so none waits
      // on a branch; what lies past the row is never added.
      float xs[kParts];
      float v[kWarp];
#pragma unroll
      for (int m = 0; m < kParts; ++m) {
        const int f = f0 + p + kLanes * m;
        const float x = widen(val_b[min(f, F - 1)]);
        xs[m] = f < Fl ? x : 0.0f;
      }
      // With a warp to an example (K > 16), a row's last batch, if the
      // row ends inside it, takes only its features, kTail at a time:
      // there the full batch's clamped loads and shuffles cost each
      // example more than its one round trip saves.  F is the same in
      // every lane, so `trim` does not diverge.
      const bool trim = kLog2 == 5 && f0 + kWarp > F;
      if (!trim) {
#pragma unroll
        for (int i = 0; i < kWarp; ++i) {
          v[i] = widen(row_b[min(f0 + i, F - 1) * D + (on ? c : 0)]);
        }
      }
      // The linear term's weights: loaded here, added last.
      float w[kParts];
      if (k0 == 0) {
#pragma unroll
        for (int m = 0; m < kParts; ++m) {
          w[m] = widen(row_b[min(f0 + p + kLanes * m, F - 1) * D]);
        }
      }
      if (!trim) {
#pragma unroll
        for (int i = 0; i < kWarp; ++i) {
          const float x = __shfl_sync(0xffffffffu, xs[i / kLanes],
                                      i % kLanes, kLanes);
          if (on && f0 + i < Fl) {
            const float xv = v[i] * x;
            s1 += xv;
            s2 += xv * xv;
          }
        }
      } else {
        // kParts = 1 here: lane i of the example holds feature f0 + i's
        // value in xs[0].
        for (int i0 = 0; f0 + i0 < F; i0 += kTail) {
#pragma unroll
          for (int i = 0; i < kTail; ++i) {
            v[i] = widen(row_b[min(f0 + i0 + i, F - 1) * D + (on ? c : 0)]);
          }
#pragma unroll
          for (int i = 0; i < kTail; ++i) {
            const float x = __shfl_sync(0xffffffffu, xs[0], i0 + i, kLanes);
            if (on && f0 + i0 + i < Fl) {
              const float xv = v[i] * x;
              s1 += xv;
              s2 += xv * xv;
            }
          }
        }
      }
      if (k0 == 0) {
#pragma unroll
        for (int m = 0; m < kParts; ++m) {
          if (f0 + p + kLanes * m < Fl) part[m] += w[m] * xs[m];
        }
      }
    }
    if (on && live) {
      s1_out[b * K + c - 1] = s1;
      inter += s1 * s1 - s2;
    }
  }
  // The butterfly's levels 16 .. g pair inputs m and m + mo of one lane;
  // its levels below g pair lanes.
#pragma unroll
  for (int mo = kParts / 2; mo > 0; mo >>= 1) {
#pragma unroll
    for (int m = 0; m < mo; ++m) part[m] += part[m + mo];
  }
  float linear = part[0];
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    linear += __shfl_xor_sync(0xffffffffu, linear, off, kLanes);
    inter += __shfl_xor_sync(0xffffffffu, inter, off, kLanes);
  }
  if (live && p == 0) scores[b] = linear + 0.5f * inter;
}

template <typename T, int kLog2>
int launch_with(const T* rows, const T* vals, float* scores, float* s1,
                int B, int F, int D, cudaStream_t stream) {
  constexpr int kExamples = kWarp >> kLog2;
  fm_scores_fwd_kernel<T, kLog2>
      <<<(B + kExamples - 1) / kExamples, kWarp, 0, stream>>>(
          rows, vals, scores, s1, B, F, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rows, const void* vals, void* scores, void* s1, int B,
           int F, int D, void* stream) {
  if (B <= 0 || F < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const T*>(rows);
  const auto* v = static_cast<const T*>(vals);
  auto* sc = static_cast<float*>(scores);
  auto* s1f = static_cast<float*>(s1);
  const auto st = static_cast<cudaStream_t>(stream);
  // Lanes per example: K = D - 1 rounded up to a power of two, 8 to 32.
  if (D - 1 <= 8) return launch_with<T, 3>(r, v, sc, s1f, B, F, D, st);
  if (D - 1 <= 16) return launch_with<T, 4>(r, v, sc, s1f, B, F, D, st);
  return launch_with<T, 5>(r, v, sc, s1f, B, F, D, st);
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
