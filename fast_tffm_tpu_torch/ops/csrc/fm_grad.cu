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
// Output drows [B, F, D] in the rows' type.  Any B, F and D >= 1 and any
// element alignment of rows and vals; drows starts on a 16-byte boundary
// (the allocator's), else the launch returns cudaErrorInvalidValue.  The bf16 mode
// (fm_grad_bwd_bf16) widens rows and vals exactly (a bf16's bits are the
// high half of its f32), computes in f32 as the f32 mode does and rounds
// each result once to nearest even with __float2bfloat16_rn, as the
// Pallas kernel's drows.astype(bf16) and torch's .to(torch.bfloat16) do.
//
// Bound: memory.  One pass reads rows and vals, s1 and dscores once and
// writes drows once: 4 * (2*B*F*D + B*F + B*(D-1) + B) bytes in f32,
// 12.4 MB at B = 4096, F = 39, D = 9 (about 3.7 us at 3.35 TB/s), and
// 2 * (2*B*F*D + B*F) + 4 * (B*(D-1) + B) in bf16, 6.2 MB, against about
// 3 flops per output element.  The design:
//
// - A thread owns a chunk of 4 neighbouring elements of the flattened
//   [B*F*D] output (16 bytes in f32, 8 in bf16): one vector load of rows
//   and one vector store of drows, a warp's chunks side by side.
// - The chunk's first (b, f, j) comes from two divisions by multiply and
//   shift (Div: constants made on the host); its other elements step
//   j -> f -> b by increments and selects.
// - Every load of the chunk (rows, and per element vals, dscores and s1
//   through the read-only path; they are small and shared across a
//   warp) is issued before the first result is computed: one round trip.
//   A j = 0 element's s1 load goes to dscores[b] instead, whose value it
//   does not use: an address that is always valid (D = 1 has no s1 at
//   all), so no load waits behind a branch.
// - Blocks of 256 threads where that gives the card kMinBlocks blocks;
//   a smaller batch takes blocks of 128 or 64 threads, so that it spreads
//   over the SMs.
// - The ragged tail after the last whole chunk runs element by element,
//   in the first threads of block 0.  Where rows is not chunk-aligned (a
//   view one element into its storage), a chunk's rows come in single
//   loads.
//
// Chunks of 8 bf16 elements (16 bytes), and two chunks a thread, measured
// no faster at B = 4096 and slower at small batches (PERF.md).  The
// arithmetic uses round-to-nearest intrinsics so the compiler does not
// contract it into FMAs, in the plain version's order: in both modes the
// outputs are bitwise the plain PyTorch version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Blocks a launch should give the card (two for each of its 132 SMs)
// before it takes smaller blocks.
constexpr int64_t kMinBlocks = 264;
// A chunk is 4 elements in both modes: 16 bytes of f32, 8 of bf16.
constexpr int kElems = 4;

// n / d for 0 <= n < 2^31 as (n * m) >> s, with l = ceil(log2 d),
// s = 31 + l and m = ceil(2^s / d) < 2^32 (Granlund and Montgomery,
// "Division by invariant integers using multiplication", 1994: m * d =
// 2^s + e with e < d <= 2^l, so n * e < 2^s and the quotient is exact).
struct Div {
  unsigned m;
  unsigned s;
};

Div make_div(unsigned d) {
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned s = 31 + l;
  return {static_cast<unsigned>(((1ull << s) + d - 1) / d), s};
}

__device__ __forceinline__ unsigned quot(unsigned n, Div q) {
  return static_cast<unsigned>((static_cast<unsigned long long>(n) * q.m) >>
                               q.s);
}

struct Shape {
  unsigned F, D;
  unsigned chunks;  // whole chunks
  unsigned tail;    // elements after the last whole chunk
  Div by_d, by_f;
  bool rows_vec;    // rows is chunk-aligned where the chunks start
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  using Raw = uint4;
  __device__ static float widen(const float* p) { return __ldg(p); }
  __device__ static void unpack(Raw r, float (&v)[kElems]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static Raw single_loads(const float* p) {
    return make_uint4(__float_as_uint(__ldg(p)), __float_as_uint(__ldg(p + 1)),
                      __float_as_uint(__ldg(p + 2)),
                      __float_as_uint(__ldg(p + 3)));
  }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static Raw pack(const float (&v)[kElems]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Io<__nv_bfloat16> {
  using Raw = uint2;
  // A bf16 widens exactly to the f32 whose high 16 bits are its bits
  // (what __bfloat162float computes).
  __device__ static float widen(const __nv_bfloat16* p) {
    const unsigned short h = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned>(h) << 16);
  }
  __device__ static void unpack(Raw r, float (&v)[kElems]) {
    v[0] = __uint_as_float(r.x << 16);  // element 2i is the low half
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ static Raw single_loads(const __nv_bfloat16* p) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    return make_uint2(
        static_cast<unsigned>(__ldg(h)) |
            (static_cast<unsigned>(__ldg(h + 1)) << 16),
        static_cast<unsigned>(__ldg(h + 2)) |
            (static_cast<unsigned>(__ldg(h + 3)) << 16));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static unsigned rounded(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static Raw pack(const float (&v)[kElems]) {
    return make_uint2(rounded(v[0]) | (rounded(v[1]) << 16),
                      rounded(v[2]) | (rounded(v[3]) << 16));
  }
};

// One element's gradient from its loaded inputs: row value r, value x,
// dscore g and s1 value s (unused at j = 0).
__device__ __forceinline__ float grad(bool linear, float r, float x, float g,
                                      float s) {
  const float gx = __fmul_rn(g, x);
  return linear ? gx : __fmul_rn(gx, __fsub_rn(s, __fmul_rn(r, x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fm_grad_bwd_kernel(const T* __restrict__ rows, const T* __restrict__ vals,
                       const float* __restrict__ s1,
                       const float* __restrict__ dscores,
                       T* __restrict__ drows, Shape sh) {
  using io = Io<T>;
  using Raw = typename io::Raw;
  const unsigned K = sh.D - 1;

  // The tail, an element a thread (fewer than kElems).
  if (blockIdx.x == 0 && threadIdx.x < sh.tail) {
    const unsigned idx = threadIdx.x + sh.chunks * kElems;
    const unsigned p = quot(idx, sh.by_d);  // b * F + f
    const unsigned j = idx - p * sh.D;
    const unsigned b = quot(p, sh.by_f);
    const float* sp = j ? s1 + b * K + (j - 1) : dscores + b;
    io::store(drows + idx, grad(j == 0, io::widen(rows + idx),
                                io::widen(vals + p), __ldg(dscores + b),
                                __ldg(sp)));
  }
  const unsigned chunk = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk >= sh.chunks) return;

  // Every load of the chunk first.
  const unsigned idx = chunk * kElems;
  const T* rp = rows + idx;
  const Raw raw = sh.rows_vec ? __ldg(reinterpret_cast<const Raw*>(rp))
                              : io::single_loads(rp);
  unsigned p = quot(idx, sh.by_d);  // b * F + f
  unsigned j = idx - p * sh.D;
  unsigned b = quot(p, sh.by_f);
  unsigned f = p - b * sh.F;
  float x[kElems], g[kElems], s[kElems];
  bool linear[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    linear[e] = j == 0;
    x[e] = io::widen(vals + p);
    g[e] = __ldg(dscores + b);
    s[e] = __ldg(j ? s1 + b * K + (j - 1) : dscores + b);
    // Next element: j -> f -> b.
    const bool next_f = j + 1 == sh.D;
    j = next_f ? 0 : j + 1;
    p += next_f;
    f += next_f;
    const bool next_b = f == sh.F;
    f = next_b ? 0 : f;
    b += next_b;
  }
  float r[kElems], out[kElems];
  io::unpack(raw, r);
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    out[e] = grad(linear[e], r[e], x[e], g[e], s[e]);
  }
  *reinterpret_cast<Raw*>(drows + idx) = io::pack(out);
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
  constexpr uintptr_t chunk_bytes = kElems * sizeof(T);
  if (reinterpret_cast<uintptr_t>(drows) & (chunk_bytes - 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh;
  sh.F = static_cast<unsigned>(F);
  sh.D = static_cast<unsigned>(D);
  sh.chunks = static_cast<unsigned>(total / kElems);
  sh.tail = static_cast<unsigned>(total % kElems);
  sh.by_d = make_div(sh.D);
  sh.by_f = make_div(sh.F);
  sh.rows_vec = (reinterpret_cast<uintptr_t>(rows) & (chunk_bytes - 1)) == 0;
  int threads = kThreads;
  auto blocks = [&]() {
    return sh.chunks ? (static_cast<int64_t>(sh.chunks) + threads - 1) /
                           threads
                     : int64_t{1};
  };
  while (threads > 64 && blocks() < kMinBlocks) threads /= 2;
  fm_grad_bwd_kernel<T><<<static_cast<unsigned>(blocks()), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(vals),
      static_cast<const float*>(s1), static_cast<const float*>(dscores),
      static_cast<T*>(drows), sh);
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
