// Native libsvm/ffm batch parser of the PyTorch port: the port's own copy
// of fast_tffm_tpu/data/_src/fm_parser.cc (the reference's C++ `FmParser`
// equivalent), with the port's host sort meta in place of the TPU one.
//
// Exposed as a C ABI for ctypes.  The Python parser is
// fast_tffm_tpu_torch/data/libsvm.py; tests hold the two bitwise equal
// (same MurmurHash64A, same label/field/id/val semantics), and both
// bitwise equal to the reference's parser.
//
// Threading model: the caller hands one contiguous text buffer plus line
// offsets; lines are split evenly across worker threads, each writing its
// own disjoint rows of the output arrays -- no locks in the hot path.  The
// port's pipeline runs one such parser (one thread) per parse worker.
//
// Build (fast_tffm_tpu_torch/data/native.py, at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -pthread fm_parser.cc -o libfm_parser.so
// (plain -O3, no -march=native: the library stays portable across CPUs).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>
#include <atomic>

namespace {

constexpr uint64_t kMurmurM = 0xc6a4a7935bd1e995ULL;
constexpr int kMurmurR = 47;

// MurmurHash64A, seed 0 — must match libsvm.murmur64 bit-for-bit.
uint64_t Murmur64(const char* data, size_t len) {
  uint64_t h = 0 ^ (static_cast<uint64_t>(len) * kMurmurM);
  const size_t n_blocks = len / 8;
  for (size_t i = 0; i < n_blocks; ++i) {
    uint64_t k;
    std::memcpy(&k, data + i * 8, 8);  // little-endian hosts only (x86/ARM)
    k *= kMurmurM;
    k ^= k >> kMurmurR;
    k *= kMurmurM;
    h ^= k;
    h *= kMurmurM;
  }
  const size_t tail_len = len & 7;
  if (tail_len) {
    uint64_t t = 0;
    std::memcpy(&t, data + n_blocks * 8, tail_len);
    h ^= t;
    h *= kMurmurM;
  }
  h ^= h >> kMurmurR;
  h *= kMurmurM;
  h ^= h >> kMurmurR;
  return h;
}

inline bool IsSpace(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

// Blank/comment test shared by both batch entry points (their rows get
// weight 0; ParseLine keeps its own early-return as a safety net for
// direct calls, where such a row merely stays zeroed).
inline bool BlankOrComment(const char* s, const char* e) {
  while (s < e && IsSpace(*s)) ++s;
  return s >= e || *s == '#';
}

struct Parser {
  uint64_t vocabulary_size;
  int max_features;
  bool hash_feature_id;
  int field_num;
  int num_threads;
};

// Python-compatible modulo (result always in [0, m)).
inline int64_t PyMod(int64_t x, int64_t m) {
  int64_t r = x % m;
  return r < 0 ? r + m : r;
}

// Fast integer parse of [s, e): full-token decimal with optional sign.
// (strtoll is several times slower due to locale/errno handling.)
inline bool ParseInt(const char* s, const char* e, int64_t* out) {
  if (s >= e) return false;
  bool neg = false;
  if (*s == '+' || *s == '-') {
    neg = (*s == '-');
    ++s;
  }
  if (s >= e) return false;
  // Skip leading zeros so only SIGNIFICANT digits count toward the cap —
  // Python's int() accepts "000...0123" and so must we (bit-exactness with
  // the oracle).  At least one digit remains semantically: all-zero input
  // falls through with v == 0, digits == 0.
  while (s < e && *s == '0') ++s;
  uint64_t v = 0;
  int digits = 0;
  for (; s < e; ++s) {
    char c = *s;
    if (c < '0' || c > '9') return false;
    // 19 significant digits max 9999999999999999999 < 2^64, so v never
    // wraps; the int64 limit check below is the real range guard.
    if (++digits > 19) return false;
    v = v * 10 + (c - '0');
  }
  uint64_t limit = neg ? (1ull << 63) : (1ull << 63) - 1;
  if (v > limit) return false;
  // Negate in unsigned space: -INT64_MIN via signed unary minus is UB.
  *out = neg ? static_cast<int64_t>(0ull - v) : static_cast<int64_t>(v);
  return true;
}

// Parses a decimal feature id of ANY length and reduces it mod m,
// matching Python's arbitrary-precision int(token) % m exactly
// (including the non-negative result for negative ids). Requires
// m < 2^59 so r*10 + digit cannot overflow uint64.
//
// Fast path: ids with <= 19 significant digits (everything real data
// contains) accumulate without reduction and take ONE final mod —
// per-digit "% m" costs a 20-40 cycle divide per digit and dominated the
// whole parse at ~7-digit Criteo ids.  Longer ids reduce per digit.
inline bool ParseIdMod(const char* s, const char* e, uint64_t m,
                       int64_t* out) {
  if (s >= e) return false;
  bool neg = false;
  if (*s == '+' || *s == '-') {
    neg = (*s == '-');
    ++s;
  }
  if (s >= e) return false;
  // Skip leading zeros so only significant digits count toward the 19.
  while (s < e && *s == '0') ++s;
  uint64_t r = 0;
  if (e - s <= 19) {
    for (; s < e; ++s) {
      char c = *s;
      if (c < '0' || c > '9') return false;
      r = r * 10 + static_cast<uint64_t>(c - '0');
    }
    r %= m;  // 19 digits < 2^64: no overflow before the single mod
  } else {
    for (; s < e; ++s) {
      char c = *s;
      if (c < '0' || c > '9') return false;
      r = (r * 10 + static_cast<uint64_t>(c - '0')) % m;
    }
  }
  if (neg && r) r = m - r;
  *out = static_cast<int64_t>(r);
  return true;
}

const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                         1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                         1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Fast float parse of the full token [s, e). The fast path covers
// [+-]digits[.digits] with <=15 significant digits — mantissa and power of
// ten are then both exact doubles, so the single division is correctly
// rounded and matches strtod (and Python's float()) bit-for-bit. Anything
// else (exponents, inf/nan, long mantissas) falls back to strtof.
inline bool ParseFloat(const char* s, const char* e, float* out) {
  const char* p = s;
  bool neg = false;
  if (p < e && (*p == '+' || *p == '-')) {
    neg = (*p == '-');
    ++p;
  }
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  bool any = false, dot = false, fast = true;
  for (; p < e; ++p) {
    char c = *p;
    if (c >= '0' && c <= '9') {
      if (digits < 15) {
        mant = mant * 10 + (c - '0');
        ++digits;
        if (dot) ++frac;
        any = true;
      } else {
        fast = false;
        break;
      }
    } else if (c == '.' && !dot) {
      dot = true;
    } else {
      fast = false;
      break;
    }
  }
  if (fast && any) {
    double v = static_cast<double>(mant) / kPow10[frac];
    *out = static_cast<float>(neg ? -v : v);
    return true;
  }
  // strtod accepts forms Python's float() rejects: hex floats ("0x10",
  // via 'x') and nan payloads ("nan(chars)", via '(').  The Python
  // oracle symmetrically rejects forms strtod can't parse (underscore
  // literals, Unicode digits); both sides pin to the ASCII intersection.
  for (const char* q = s; q < e; ++q) {
    if (*q == 'x' || *q == 'X' || *q == '(') return false;
  }
  char* endp = nullptr;
  // strtod then cast, NOT strtof: Python parses to float64 and numpy
  // rounds that to float32 (double rounding).  strtof's single rounding
  // differs by an ULP on >15-significant-digit tokens near f32 tie
  // midpoints — the oracle's two-step path is the contract.
  double v = std::strtod(s, &endp);
  if (endp != e || s == e) return false;
  *out = static_cast<float>(v);
  return true;
}

// Parses one line into row `row` of the outputs. Returns the number of
// feature tokens dropped by max_features truncation; -1 on malformed input.
int ParseLine(const Parser& p, const char* s, const char* end, int64_t row,
              float* labels, int32_t* ids, float* vals, int32_t* fields) {
  // Trim.
  while (s < end && IsSpace(*s)) ++s;
  while (end > s && IsSpace(end[-1])) --end;
  if (s >= end || *s == '#') return 0;  // blank/comment: row stays zeroed

  const char* label_end = s;
  while (label_end < end && !IsSpace(*label_end)) ++label_end;
  float label;
  // The label token must be fully consumed ("1x" is malformed, like
  // Python float("1x")).
  if (!ParseFloat(s, label_end, &label)) return -1;
  if (label == -1.0f) label = 0.0f;  // accept {-1,1} label convention
  labels[row] = label;

  const char* cur = label_end;
  int count = 0;
  int dropped = 0;
  int32_t* row_ids = ids + row * p.max_features;
  float* row_vals = vals + row * p.max_features;
  int32_t* row_fields = fields + row * p.max_features;

  while (cur < end) {
    while (cur < end && IsSpace(*cur)) ++cur;
    if (cur >= end) break;
    // One pass: find the token end and split on ':' as we go — up to 3
    // pieces: [field:]id[:val].
    const char* tok = cur;
    const char* c1 = nullptr;
    const char* c2 = nullptr;
    for (; cur < end && !IsSpace(*cur); ++cur) {
      if (*cur == ':') {
        if (!c1) {
          c1 = cur;
        } else if (!c2) {
          c2 = cur;
        } else {
          return -1;  // too many colons
        }
      }
    }
    const char* tok_end = cur;
    const char *id_s, *id_e;
    const char *val_s = nullptr, *val_e = nullptr;
    int64_t field = 0;
    if (c2) {  // field:id:val
      if (!ParseInt(tok, c1, &field)) return -1;  // empty/partial field
      id_s = c1 + 1;
      id_e = c2;
      val_s = c2 + 1;
      val_e = tok_end;
    } else if (c1) {  // id:val
      id_s = tok;
      id_e = c1;
      val_s = c1 + 1;
      val_e = tok_end;
    } else {  // bare id => val 1.0
      id_s = tok;
      id_e = tok_end;
    }

    // Validate BEFORE the truncation check so a malformed over-limit token
    // errors exactly like the Python oracle (which parses, then truncates).
    int64_t fid;
    if (p.hash_feature_id) {
      fid = static_cast<int64_t>(Murmur64(id_s, id_e - id_s) %
                                 p.vocabulary_size);
    } else {
      // int("") raises in Python: ParseIdMod rejects empty/partial ids,
      // and handles ids of any digit length (Python-int parity).
      if (!ParseIdMod(id_s, id_e, p.vocabulary_size, &fid)) return -1;
    }
    float v = 1.0f;
    if (val_s) {
      if (!ParseFloat(val_s, val_e, &v)) return -1;  // float("") raises
    }
    if (p.field_num > 0) field = PyMod(field, p.field_num);

    if (count >= p.max_features) {
      ++dropped;
      continue;
    }
    row_ids[count] = static_cast<int32_t>(fid);
    row_vals[count] = v;
    row_fields[count] = static_cast<int32_t>(field);
    ++count;
  }
  return dropped;
}

}  // namespace

// Shared parallel harness for the batch entry points: splits [0, n_lines)
// across the parser's threads, aggregates truncation counts, and tracks
// the first malformed line. per_line(i, local_dropped) returns false on
// malformed input. Returns total dropped, or -(first_bad_index + 1).
template <typename F>
int64_t RunLines(const Parser& p, int64_t n_lines, F&& per_line) {
  std::atomic<int64_t> dropped{0};
  std::atomic<int64_t> first_bad{INT64_MAX};

  auto work = [&](int64_t begin, int64_t stop) {
    int64_t local_dropped = 0;
    for (int64_t i = begin; i < stop; ++i) {
      if (!per_line(i, &local_dropped)) {
        int64_t cur = first_bad.load(std::memory_order_relaxed);
        while (i < cur &&
               !first_bad.compare_exchange_weak(cur, i,
                                                std::memory_order_relaxed)) {
        }
        break;
      }
    }
    dropped.fetch_add(local_dropped, std::memory_order_relaxed);
  };

  int nt = p.num_threads;
  if (nt <= 1 || n_lines < 2 * nt) {
    work(0, n_lines);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n_lines + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t b = t * chunk;
      int64_t e = b + chunk < n_lines ? b + chunk : n_lines;
      if (b >= e) break;
      threads.emplace_back(work, b, e);
    }
    for (auto& th : threads) th.join();
  }
  int64_t bad = first_bad.load();
  if (bad != INT64_MAX) return -(bad + 1);
  return dropped.load();
}

extern "C" {

void* fm_parser_create(uint64_t vocabulary_size, int max_features,
                       int hash_feature_id, int field_num, int num_threads) {
  if (vocabulary_size == 0 || vocabulary_size >= (1ULL << 59)) {
    return nullptr;  // ParseIdMod requires m < 2^59 (r*10+9 in uint64)
  }
  Parser* p = new Parser();
  p->vocabulary_size = vocabulary_size;
  p->max_features = max_features;
  p->hash_feature_id = hash_feature_id != 0;
  p->field_num = field_num;
  p->num_threads = num_threads < 1 ? 1 : num_threads;
  return p;
}

void fm_parser_destroy(void* handle) { delete static_cast<Parser*>(handle); }

// Parse n_lines lines (buf + offsets, offsets has n_lines+1 entries) into
// the first n_lines rows of the [batch_size, max_features] outputs.  All
// output arrays must be pre-zeroed by the caller (padding convention).
// weights_in may be null (-> 1.0 for parsed rows).  Blank/comment lines
// become weight-0 rows (same convention as parse_raw — a weight-1 empty
// row would train w0 on a phantom label-0 example).  Returns total
// dropped (truncated) feature count, or -(first_bad_index + 1) if a
// line was malformed (callers decode the line number from it).
int64_t fm_parser_parse(void* handle, const char* buf,
                        const int64_t* offsets, int64_t n_lines,
                        float* labels, int32_t* ids, float* vals,
                        int32_t* fields, float* weights,
                        const float* weights_in) {
  const Parser& p = *static_cast<Parser*>(handle);
  return RunLines(p, n_lines, [&](int64_t i, int64_t* local_dropped) {
    const char* s = buf + offsets[i];
    const char* e = buf + offsets[i + 1];
    if (BlankOrComment(s, e)) {
      weights[i] = 0.0f;
      return true;
    }
    int d = ParseLine(p, s, e, i, labels, ids, vals, fields);
    if (d < 0) return false;
    *local_dropped += d;
    weights[i] = weights_in ? weights_in[i] : 1.0f;
    return true;
  });
}

uint64_t fm_parser_murmur64(const char* data, int64_t len) {
  return Murmur64(data, len);
}

// Scans buf for line-start offsets (byte after each '\n', plus offset 0).
// Writes up to max_out offsets; returns the number found (may exceed
// max_out to signal the caller to grow its buffer). The caller derives
// line ends from the next start (ParseLine trims the trailing newline).
int64_t fm_parser_find_lines(const char* buf, int64_t len, int64_t* out,
                             int64_t max_out) {
  int64_t count = 0;
  if (len <= 0) return 0;
  if (count < max_out) out[count] = 0;
  ++count;
  const char* p = buf;
  const char* end = buf + len;
  while ((p = static_cast<const char*>(memchr(p, '\n', end - p)))) {
    ++p;
    if (p >= end) break;  // trailing newline: no new line starts after it
    if (count < max_out) out[count] = p - buf;
    ++count;
  }
  return count;
}

// Like fm_parser_parse but takes per-line [start, end) extents — lines
// need not be contiguous or ordered in buf (the pipeline's line-level
// shuffle hands a permuted view of a window) — and marks blank/comment
// lines with weight 0 (the raw-chunk path has no Python-side blank
// filtering). Lines that parse get weight weights_in[i] (or 1.0). Same
// return convention.
int64_t fm_parser_parse_raw(void* handle, const char* buf,
                            const int64_t* starts, const int64_t* ends,
                            int64_t n_lines, float* labels, int32_t* ids,
                            float* vals, int32_t* fields, float* weights,
                            const float* weights_in) {
  const Parser& p = *static_cast<Parser*>(handle);
  return RunLines(p, n_lines, [&](int64_t i, int64_t* local_dropped) {
    const char* s = buf + starts[i];
    const char* e = buf + ends[i];
    if (BlankOrComment(s, e)) {
      weights[i] = 0.0f;
      return true;
    }
    int d = ParseLine(p, s, e, i, labels, ids, vals, fields);
    if (d < 0) return false;
    *local_dropped += d;
    weights[i] = weights_in ? weights_in[i] : 1.0f;
    return true;
  });
}


// Host sort meta of the port's sparse apply: a STABLE sort of a batch's
// flat ids, as the port's numpy host_sort_meta and its device sort_meta
// give it (fast_tffm_tpu_torch/data/libsvm.py::SortMeta):
//
// In:  ids [n] int32 in [0, vocab).
// Out (caller-allocated):
//   perm      [n]     i32  occurrence index of each sorted position
//   seg_start [n + 1] i32  first sorted position of each unique id, then n
//                          (only the first U + 1 entries are written)
// Returns U, the number of unique ids, or -1 on bad arguments or an id
// outside [0, vocab) (checked before anything is written past the keys: an
// id out of range would index the bucket histogram out of bounds).
//
// The sort is the reference's fm_sort_meta MSB-bucket radix sort of packed
// (id << 31 | index) keys, without its TPU chunk, tile and lrow_last
// outputs and without sentinel padding: one scattered pass distributes
// the keys into <= 4097 top-bit buckets, then each small bucket is
// finished with cache-resident 11-bit counting passes over the low id
// bits.  The occurrence index lives in the low 31 bits and is never
// sorted on, so equal ids keep occurrence order.
int64_t fm_sort_meta(const int32_t* ids, int64_t n, int64_t vocab,
                     int32_t* perm, int32_t* seg_start) {
  if (n < 0 || vocab <= 0 || vocab > INT32_MAX || n >= (1LL << 31)) {
    return -1;
  }
  if (n == 0) {
    seg_start[0] = 0;
    return 0;
  }
  constexpr int kIdxBits = 31;
  constexpr int kRadixBits = 11;
  constexpr int64_t kRadix = 1 << kRadixBits;
  int id_bits = 0;
  while ((static_cast<uint64_t>(vocab) >> id_bits) != 0) ++id_bits;
  const int top_bits = id_bits < 12 ? id_bits : 12;
  const int lo_bits = id_bits - top_bits;
  const int64_t n_buckets = (static_cast<int64_t>(vocab) >> lo_bits) + 1;
  // Up to 12 top bits (<= 4097 buckets): Criteo-Kaggle's 2^22 ids (23
  // bits with the vocabulary itself) leave 11 low bits to a bucket.
  std::vector<uint64_t> key(n), key2(n);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = ids[i];
    if (v < 0 || v >= vocab) return -1;
    key[i] = (static_cast<uint64_t>(static_cast<uint32_t>(v)) << kIdxBits) |
             static_cast<uint64_t>(i);
  }
  // Bucket histogram over the top id bits, then scatter.
  std::vector<int64_t> bstart(n_buckets + 1, 0);
  const int top_shift = kIdxBits + lo_bits;
  for (int64_t i = 0; i < n; ++i) ++bstart[(key[i] >> top_shift) + 1];
  for (int64_t b = 0; b < n_buckets; ++b) bstart[b + 1] += bstart[b];
  {
    std::vector<int64_t> pos(bstart.begin(), bstart.end() - 1);
    for (int64_t i = 0; i < n; ++i) key2[pos[key[i] >> top_shift]++] = key[i];
  }
  // Per bucket: LSD counting passes over the low id bits.  lo_bits == 0
  // means a bucket holds one id value only: already sorted.
  uint64_t* k_src = key2.data();
  uint64_t* k_dst = key.data();
  if (lo_bits > 0) {
    int64_t count[kRadix + 1];
    for (int64_t b = 0; b < n_buckets; ++b) {
      uint64_t* src = k_src + bstart[b];
      uint64_t* dst = k_dst + bstart[b];
      const int64_t m = bstart[b + 1] - bstart[b];
      if (m <= 1) {
        if (m == 1) dst[0] = src[0];
        continue;
      }
      for (int shift = 0; shift < lo_bits; shift += kRadixBits) {
        const int bits = std::min(kRadixBits, lo_bits - shift);
        const uint64_t mask = (1u << bits) - 1;
        std::fill(count, count + (1 << bits) + 1, 0);
        for (int64_t i = 0; i < m; ++i) {
          ++count[((src[i] >> (kIdxBits + shift)) & mask) + 1];
        }
        for (int64_t v = 0; v < (1 << bits); ++v) count[v + 1] += count[v];
        for (int64_t i = 0; i < m; ++i) {
          dst[count[(src[i] >> (kIdxBits + shift)) & mask]++] = src[i];
        }
        std::swap(src, dst);
      }
      // The swaps alternate buffers: gather every bucket's sorted run
      // into k_dst so one buffer holds the whole sorted sequence.
      if (src != k_dst + bstart[b]) {
        std::memcpy(k_dst + bstart[b], src, m * sizeof(uint64_t));
      }
    }
    k_src = k_dst;
  }
  // One scan: the permutation and the segment starts.
  int64_t nu = 0;
  uint64_t prev_id = 0;
  for (int64_t p = 0; p < n; ++p) {
    const uint64_t id = k_src[p] >> kIdxBits;
    if (p == 0 || id != prev_id) seg_start[nu++] = static_cast<int32_t>(p);
    prev_id = id;
    perm[p] = static_cast<int32_t>(k_src[p] & ((1ull << kIdxBits) - 1));
  }
  seg_start[nu] = static_cast<int32_t>(n);
  return nu;
}

}  // extern "C"
