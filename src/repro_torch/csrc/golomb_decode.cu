// ungolomb_sum and ungolomb_wsum: the decode side of the Golomb/Rice wire on
// Hopper, fused with the sum over the gathered workers' messages.
//
// Replaces: src/repro/kernels/golomb/kernel.py:109 (ungolomb_sum) and
// src/repro/kernels/golomb/kernel.py:130 (ungolomb_wsum), Pallas TPU.
//
//   sum:  out[pos] = sum_m votes_m[pos]                                  int32
//   wsum: out[pos] = (((0 + v_0 w_0) + v_1 w_1) + ...) + v_{M-1} w_{M-1}  float32
//
// over M gathered messages of `rows` 128-byte rows (golomb.cuh's layout), each
// the header's shipped count of Rice codes; positions >= n are dropped, and
// an all-zero message (a masked worker) adds nothing.
//
// Bound on an H100 (3.35 TB/s): bytes. Each message is read once and the
// (n,) sum written once: M * rows * 128 + 4 n bytes.
//
// Design: code boundaries are unknown until the stream is read from its
// start, so each message's body is cut into segments of 4096 bits, one thread
// a segment, and each segment's entry (where its first code starts) is found
// exactly, in parallel, before any vote is decoded:
//   - A zero bit after at least b + 1 one-bits is an anchor: it can only be a
//     stop bit, since a code's remainder and sign bits follow its stop bit, so
//     at most b one-bits precede any of them. The code after it starts b + 2
//     bits later.
//   - A segment's transfer function maps its entry to its exit (where the
//     last code starting in it ends). It is a constant for a segment with an
//     anchor (parse from its last anchor), for a segment of one-bits only
//     (inside a unary run: the exit follows the next zero bit, found through
//     a suffix-min scan of the segments' first zero bits), and for each
//     message's first segment (entered at bit 0). Any other segment is
//     entered less than 2b + 2 bits past its start: a code crossing into it
//     either has a quotient <= b, so is at most 2b + 2 bits long, or ends on
//     an anchor, which would lie before the segment or in it. Its transfer
//     function is a table of 2b + 2 exits, one a possible entry (parsed one by
//     one; for a segment of zero bits, the capacity padding, in closed form);
//     an exit more than 254 bits past the segment's end is its last code's
//     unary run crossing it, so it is the zero bit after the segment, + 2 + b.
//     Such segments are the low-entropy stretches where a speculative parse
//     can stay misaligned for good: dense, saturated rows of gap-0 codes
//     `0 0000 s` that never read a sign bit as unary.
//   - An exclusive scan composes the transfer functions (golomb.cuh's scan,
//     on 104-byte elements); each message's first segment is a constant, so
//     every prefix is one, and it is the next segment's exact entry.
// Then: each segment is decoded from its entry, counting its codes and the
// positions they advance; an exclusive sum scan gives each segment's first
// code index and position; and, per message in worker order, each segment
// adds the votes of its codes with index < shipped. Positions are distinct
// within a message, so the adds are plain read-modify-writes, and worker
// order is the stream order of the launches. The weighted sum starts at +0.0
// and rounds each product and sum on its own (__fmul_rn, __fadd_rn): a
// coordinate a message does not touch would add +0.0, which leaves an
// accumulator that is never -0.0 unchanged, so skipping it is exact.
// The composition reproduces the parse from bit 0 of any bit string: every
// anchor is a stop bit of it, and every table segment's true entry is in its
// table. Segments whose decoded exit is not their successor's composed entry
// are counted (`stats`), as a check that this holds.
// Bits past a message's body read as 0; no read leaves its buffer.
#include "golomb.cuh"

namespace {

using namespace repro;
using namespace repro::golomb;

constexpr int kDecThreads = 256;
constexpr unsigned long long kSegBits = 4096;
constexpr unsigned long long kUnknown = ~0ull;
constexpr int kKeyShift = 40;  // key = message << 40 | bit
constexpr int kMaxEntries = 64;     // 2b + 2 for b <= 31
constexpr unsigned int kFar = 255;  // a table exit past the table's reach

struct Pair {
  unsigned long long adv;  // positions advanced: sum of gap + 1
  unsigned long long cnt;  // codes
};

__device__ __forceinline__ Pair shfl_up(const Pair& p, int d) {
  return Pair{__shfl_up_sync(0xffffffffu, p.adv, d), __shfl_up_sync(0xffffffffu, p.cnt, d)};
}

struct SumOp {
  __device__ __forceinline__ Pair identity() const { return Pair{0ull, 0ull}; }
  __device__ __forceinline__ Pair operator()(const Pair& a, const Pair& c) const {
    return Pair{a.adv + c.adv, a.cnt + c.cnt};
  }
};

struct MinOp {
  __device__ __forceinline__ unsigned long long identity() const { return kUnknown; }
  __device__ __forceinline__ unsigned long long operator()(unsigned long long a,
                                                           unsigned long long c) const {
    return a < c ? a : c;
  }
};

// The transfer function of a run of consecutive segments, from the bit
// `start` where the first one begins to the bit `end` where the last one ends.
enum : unsigned int { kIdentity = 0, kConstant = 1, kTable = 2 };

struct Xfer {
  unsigned long long start;
  unsigned long long end;
  unsigned long long exit;  // kConstant: where the run's last code ends
  unsigned long long far;   // kTable: the exit of an entry whose last code runs past
                            // end + 254: the zero bit after end, + 2 + b
  unsigned int kind;
  unsigned int pad;
  uint32_t tab[kMaxEntries / 4];  // kTable: exit - end for entry start + j, one byte each

  __device__ __forceinline__ unsigned int at(int j) const {
    return (tab[j >> 2] >> (8 * (j & 3))) & 0xFFu;
  }
  __device__ __forceinline__ void put(int j, unsigned int v) {
    tab[j >> 2] = (tab[j >> 2] & ~(0xFFu << (8 * (j & 3)))) | (v << (8 * (j & 3)));
  }
};

__device__ __forceinline__ Xfer shfl_up(const Xfer& x, int d) {
  Xfer r;
  r.start = __shfl_up_sync(0xffffffffu, x.start, d);
  r.end = __shfl_up_sync(0xffffffffu, x.end, d);
  r.exit = __shfl_up_sync(0xffffffffu, x.exit, d);
  r.far = __shfl_up_sync(0xffffffffu, x.far, d);
  r.kind = __shfl_up_sync(0xffffffffu, x.kind, d);
  r.pad = 0u;
#pragma unroll
  for (int k = 0; k < kMaxEntries / 4; ++k) r.tab[k] = __shfl_up_sync(0xffffffffu, x.tab[k], d);
  return r;
}

struct XferOp {
  int entries;  // 2b + 2

  __device__ __forceinline__ Xfer identity() const {
    Xfer r{};
    r.kind = kIdentity;
    return r;
  }
  // a runs before c. Entering a table segment farther than `entries` bits
  // past its start cannot be the true parse (that segment would hold an
  // anchor, and be a constant), so such entries compose to kUnknown / kFar.
  __device__ Xfer operator()(const Xfer& a, const Xfer& c) const {
    if (a.kind == kIdentity) return c;
    if (c.kind == kIdentity) return a;
    Xfer r = c;
    r.start = a.start;
    if (c.kind == kConstant) return r;
    if (a.kind == kConstant) {
      r.kind = kConstant;
      const unsigned long long off = a.exit - c.start;
      r.exit = kUnknown;
      if (a.exit != kUnknown && a.exit >= c.start &&
          off < static_cast<unsigned long long>(entries)) {
        const unsigned int t = c.at(static_cast<int>(off));
        r.exit = t == kFar ? c.far : c.end + t;
      }
      return r;
    }
    for (int j = 0; j < entries; ++j) {
      const unsigned int t = a.at(j);
      r.put(j, t < static_cast<unsigned int>(entries) ? c.at(static_cast<int>(t)) : kFar);
    }
    return r;
  }
};

// The working arrays, carved from one scratch buffer.
struct Work {
  const uint32_t* msgs;
  long long rows;
  int m;
  long long ns;            // segments a message
  int b;
  unsigned long long nb;   // body bits a message
  unsigned long long* key;     // [m * ns] first zero keys, in reverse segment order
  unsigned long long* keyp;    // their exclusive min prefixes
  unsigned long long* keyt;    // the scan's block totals
  Xfer* xf;                    // transfer functions, then their exclusive prefixes
  Xfer* xft;
  unsigned long long* start1;  // each segment's entry
  Pair* pair;                  // (advance, codes) of each segment
  Pair* pairp;                 // their exclusive prefixes
  Pair* pairt;
  unsigned long long* stats;   // [1]: segments whose exit is not the next entry

  __device__ __forceinline__ long long total() const { return m * ns; }
  __device__ __forceinline__ const uint32_t* header(int i) const {
    return msgs + static_cast<long long>(i) * rows * 32;
  }
  __device__ __forceinline__ unsigned long long seg_end(long long s) const {
    const unsigned long long e = (s + 1) * kSegBits;
    return e < nb ? e : nb;
  }
};

struct Stream {
  const uint32_t* body;
  unsigned long long nwords;

  __device__ __forceinline__ uint32_t word(unsigned long long w) const {
    return w < nwords ? body[w] : 0u;
  }
  // bits [x, x + len), len <= 32, LSB-first
  __device__ __forceinline__ uint32_t bits(unsigned long long x, int len) const {
    if (len == 0) return 0u;
    const unsigned long long w = x >> 5;
    const int sh = static_cast<int>(x & 31);
    uint32_t v = word(w) >> sh;
    if (sh) v |= word(w + 1) << (32 - sh);
    return len == 32 ? v : v & ((1u << len) - 1u);
  }
  // the first zero bit in [x, lim), lim a multiple of 32, or kUnknown
  __device__ __forceinline__ unsigned long long zero_within(unsigned long long x,
                                                            unsigned long long lim) const {
    unsigned long long w = x >> 5;
    uint32_t v = ~word(w) & (0xFFFFFFFFu << (x & 31));
    while (!v) {
      if (++w >= (lim >> 5)) return kUnknown;
      v = ~word(w);
    }
    return (w << 5) + __ffs(v) - 1;
  }
  // the last anchor in the words [from, lim) (multiples of 32), or kUnknown.
  // v holds a word above the one before it, so the b + 1 bits before each of
  // the word's bits are in v.
  __device__ __forceinline__ unsigned long long last_anchor(unsigned long long from,
                                                            unsigned long long lim,
                                                            int b) const {
    for (long long w = static_cast<long long>(lim >> 5) - 1;
         w >= static_cast<long long>(from >> 5); --w) {
      const unsigned long long v = (static_cast<unsigned long long>(word(w)) << 32) |
                                   (w > 0 ? word(w - 1) : 0u);
      unsigned long long ones = ~0ull;
      for (int j = 1; j <= b + 1; ++j) ones &= v << j;
      const uint32_t anchors = static_cast<uint32_t>((~v & ones) >> 32);
      if (anchors) return (static_cast<unsigned long long>(w) << 5) + 31 - __clz(anchors);
    }
    return kUnknown;
  }
  __device__ __forceinline__ bool all_zero(unsigned long long from,
                                           unsigned long long lim) const {
    for (unsigned long long w = from >> 5; w < (lim >> 5); ++w)
      if (word(w)) return false;
    return true;
  }
};

__device__ __forceinline__ Stream stream_of(const Work& wk, int i) {
  return Stream{wk.header(i) + kHeaderWords, static_cast<unsigned long long>(wk.rows) * 32 -
                                                  kHeaderWords};
}

// The first zero bit at or after segment s + 1's start (message i), or nb.
__device__ __forceinline__ unsigned long long zero_after(const Work& wk, int i, long long s) {
  const long long g = static_cast<long long>(i) * wk.ns + s;
  const unsigned long long k = scanned(wk.keyp, wk.keyt, wk.total() - 1 - g, MinOp{});
  return (k >> kKeyShift) == static_cast<unsigned long long>(i)
             ? (k & ((1ull << kKeyShift) - 1)) : wk.nb;
}

// The stop bit of the code starting at bit x of segment s.
__device__ __forceinline__ unsigned long long stop_bit(const Work& wk, const Stream& st, int i,
                                                       long long s, unsigned long long x) {
  const unsigned long long z = st.zero_within(x, wk.seg_end(s));
  return z != kUnknown ? z : zero_after(wk, i, s);
}

// Where the last code starting in segment s ends, parsing from bit x.
__device__ __forceinline__ unsigned long long parse_exit(const Work& wk, const Stream& st,
                                                         int i, long long s,
                                                         unsigned long long x) {
  const unsigned long long lim = wk.seg_end(s);
  while (x < lim) x = stop_bit(wk, st, i, s, x) + 2 + wk.b;
  return x;
}

struct Code {
  unsigned long long gap;
  unsigned int sign;
  unsigned long long end;
};

// The code starting at bit x of segment s.
__device__ __forceinline__ Code decode_code(const Work& wk, const Stream& st, int i, long long s,
                                            unsigned long long x) {
  const unsigned long long z = stop_bit(wk, st, i, s, x);
  Code c;
  c.gap = ((z - x) << wk.b) | st.bits(z + 1, wk.b);
  c.sign = st.bits(z + 1 + wk.b, 1);
  c.end = z + 2 + wk.b;
  return c;
}

// Decode segment s from bit x0: codes that start in it, positions they
// advance, and where the last one ends.
__device__ __forceinline__ Pair decode_segment(const Work& wk, const Stream& st, int i,
                                               long long s, unsigned long long x0,
                                               unsigned long long* end) {
  Pair p{0ull, 0ull};
  unsigned long long x = x0;
  const unsigned long long lim = wk.seg_end(s);
  while (x < lim) {
    const Code c = decode_code(wk, st, i, s, x);
    p.adv += c.gap + 1;
    ++p.cnt;
    x = c.end;
  }
  *end = x;
  return p;
}

// Each segment's first zero bit, as a key for the suffix-min scan.
__global__ void __launch_bounds__(kDecThreads) zero_keys(Work wk) {
  const long long g = static_cast<long long>(blockIdx.x) * kDecThreads + threadIdx.x;
  if (g >= wk.total()) return;
  const int i = static_cast<int>(g / wk.ns);
  const long long s = g - i * wk.ns;
  const unsigned long long lim = wk.seg_end(s);
  unsigned long long z = wk.nb;
  if (wk.header(i)[0] != 0u) {  // a message that shipped nothing is never decoded
    const unsigned long long z0 = stream_of(wk, i).zero_within(s * kSegBits, lim);
    if (z0 != kUnknown) z = z0;
  }
  wk.key[wk.total() - 1 - g] = (static_cast<unsigned long long>(i) << kKeyShift) | z;
}

__global__ void __launch_bounds__(kDecThreads) transfer_pass(Work wk) {
  const long long g = static_cast<long long>(blockIdx.x) * kDecThreads + threadIdx.x;
  if (g >= wk.total()) return;
  const int i = static_cast<int>(g / wk.ns);
  const long long s = g - i * wk.ns;
  const unsigned long long start = s * kSegBits;
  const unsigned long long lim = wk.seg_end(s);
  Xfer x{};
  x.start = start;
  x.end = lim;
  x.kind = kConstant;
  if (wk.header(i)[0] == 0u) {
    x.exit = lim;
    wk.xf[g] = x;
    return;
  }
  const Stream st = stream_of(wk, i);
  const int entries = 2 * wk.b + 2;
  if (s == 0) {
    x.exit = parse_exit(wk, st, i, s, 0ull);
  } else if (st.zero_within(start, lim) == kUnknown) {  // inside a unary run
    x.exit = zero_after(wk, i, s) + 2 + wk.b;
  } else {
    const unsigned long long a = st.last_anchor(start, lim, wk.b);
    if (a != kUnknown) {
      x.exit = parse_exit(wk, st, i, s, a + 2 + wk.b);
    } else {
      x.kind = kTable;
      x.far = zero_after(wk, i, s) + 2 + wk.b;
      const bool zeros = st.all_zero(start, lim);
      const unsigned long long len = 2 + wk.b;
      for (int j = 0; j < entries; ++j) {
        const unsigned long long e0 = start + j;
        const unsigned long long e =
            e0 >= lim ? e0
                      : (zeros ? e0 + (lim - e0 + len - 1) / len * len
                               : parse_exit(wk, st, i, s, e0));
        const unsigned long long rel = e - lim;
        x.put(j, rel < kFar ? static_cast<unsigned int>(rel) : kFar);
      }
    }
  }
  wk.xf[g] = x;
}

__global__ void __launch_bounds__(kDecThreads) count_pass(Work wk) {
  const long long g = static_cast<long long>(blockIdx.x) * kDecThreads + threadIdx.x;
  if (g >= wk.total()) return;
  const int i = static_cast<int>(g / wk.ns);
  const long long s = g - i * wk.ns;
  if (wk.header(i)[0] == 0u) {
    wk.start1[g] = s * kSegBits;
    wk.pair[g] = Pair{0ull, 0ull};
    return;
  }
  const XferOp op{2 * wk.b + 2};
  const unsigned long long x0 = s == 0 ? 0ull : scanned(wk.xf, wk.xft, g, op).exit;
  unsigned long long e = x0;
  Pair p{0ull, 0ull};
  if (x0 != kUnknown) p = decode_segment(wk, stream_of(wk, i), i, s, x0, &e);
  wk.pair[g] = p;
  wk.start1[g] = x0;
  if (x0 == kUnknown || (s + 1 < wk.ns && e != scanned(wk.xf, wk.xft, g + 1, op).exit)) {
    atomicAdd(&wk.stats[0], 1ull);
  }
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(kDecThreads)
emit_pass(Work wk, int i, const float* __restrict__ weights, void* __restrict__ out,
          long long n) {
  const long long s = static_cast<long long>(blockIdx.x) * kDecThreads + threadIdx.x;
  if (s >= wk.ns) return;
  const unsigned long long shipped = wk.header(i)[0];
  if (shipped == 0) return;
  const long long g = static_cast<long long>(i) * wk.ns + s;
  const SumOp op;
  const Pair at = scanned(wk.pairp, wk.pairt, g, op);
  const Pair base = scanned(wk.pairp, wk.pairt, static_cast<long long>(i) * wk.ns, op);
  unsigned long long k = at.cnt - base.cnt;
  if (k >= shipped) return;
  const Stream st = stream_of(wk, i);
  long long prev = static_cast<long long>(at.adv - base.adv) - 1;
  unsigned long long x = wk.start1[g];
  const unsigned long long lim = wk.seg_end(s);
  const float w = WEIGHTED ? weights[i] : 0.0f;
  while (x < lim && k < shipped) {
    const Code c = decode_code(wk, st, i, s, x);
    const long long pos = prev + 1 + static_cast<long long>(c.gap);
    prev = pos;
    if (pos < n) {
      if constexpr (WEIGHTED) {
        float* o = static_cast<float*>(out) + pos;
        *o = __fadd_rn(*o, __fmul_rn(c.sign ? -1.0f : 1.0f, w));
      } else {
        static_cast<int32_t*>(out)[pos] += c.sign ? -1 : 1;
      }
    }
    ++k;
    x = c.end;
  }
}

inline long long segments_for(long long rows) {
  return (body_bits(rows) + static_cast<long long>(kSegBits) - 1) /
         static_cast<long long>(kSegBits);
}

// Lays the scratch buffer out; returns its size in bytes.
inline long long layout(Work* wk, void* scratch, int m, long long rows) {
  const long long tot = m * segments_for(rows);
  const long long blocks = scan_blocks_for(tot);
  char* p = static_cast<char*>(scratch);
  long long off = 0;
  auto take = [&](long long bytes) {
    char* q = p ? p + off : nullptr;
    off += (bytes + 15) / 16 * 16;
    return q;
  };
  wk->key = reinterpret_cast<unsigned long long*>(take(8 * tot));
  wk->keyp = reinterpret_cast<unsigned long long*>(take(8 * tot));
  wk->keyt = reinterpret_cast<unsigned long long*>(take(8 * blocks));
  wk->xf = reinterpret_cast<Xfer*>(take(static_cast<long long>(sizeof(Xfer)) * tot));
  wk->xft = reinterpret_cast<Xfer*>(take(static_cast<long long>(sizeof(Xfer)) * blocks));
  wk->start1 = reinterpret_cast<unsigned long long*>(take(8 * tot));
  wk->pair = reinterpret_cast<Pair*>(take(16 * tot));
  wk->pairp = reinterpret_cast<Pair*>(take(16 * tot));
  wk->pairt = reinterpret_cast<Pair*>(take(16 * blocks));
  wk->stats = reinterpret_cast<unsigned long long*>(take(8));
  return off;
}

}  // namespace

// Scratch bytes ungolomb_launch needs for m messages of `rows` rows.
extern "C" long long ungolomb_scratch_bytes(int m, long long rows) {
  Work wk{};
  return layout(&wk, nullptr, m, rows);
}

// gathered: uint8[m, rows, 128], 4-byte aligned; weights: float32[m] for the
// weighted sum, null for the integer one; out: int32 or float32 [n];
// scratch: ungolomb_scratch_bytes(m, rows), 16-byte aligned; stats: uint64[1]
// (segments whose decoded exit is not the next one's entry: 0) or null.
// 0 <= b <= 30.
extern "C" int ungolomb_launch(const void* gathered, const void* weights, void* out,
                               void* scratch, void* stats, int m, long long rows, long long n,
                               int b, void* stream) {
  if (m <= 0 || rows <= 0 || n <= 0) return 0;
  if (!aligned(gathered, 4) || !aligned(out, 4) || !aligned(scratch, 16)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (b < 0 || b > 30 || m >= (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Work wk{};
  wk.msgs = static_cast<const uint32_t*>(gathered);
  wk.rows = rows;
  wk.m = m;
  wk.ns = segments_for(rows);
  wk.b = b;
  wk.nb = static_cast<unsigned long long>(body_bits(rows));
  layout(&wk, scratch, m, rows);
  const long long tot = m * wk.ns;
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * 4, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(wk.stats, 0, 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((tot + kDecThreads - 1) / kDecThreads);
  zero_keys<<<grid, kDecThreads, 0, s>>>(wk);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = exclusive_scan(wk.key, wk.keyp, wk.keyt, tot, MinOp{}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  transfer_pass<<<grid, kDecThreads, 0, s>>>(wk);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = exclusive_scan(wk.xf, wk.xf, wk.xft, tot, XferOp{2 * b + 2}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_pass<<<grid, kDecThreads, 0, s>>>(wk);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = exclusive_scan(wk.pair, wk.pairp, wk.pairt, tot, SumOp{}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned seg_grid = static_cast<unsigned>((wk.ns + kDecThreads - 1) / kDecThreads);
  for (int i = 0; i < m; ++i) {
    if (weights) {
      emit_pass<true><<<seg_grid, kDecThreads, 0, s>>>(wk, i, static_cast<const float*>(weights),
                                                       out, n);
    } else {
      emit_pass<false><<<seg_grid, kDecThreads, 0, s>>>(wk, i, nullptr, out, n);
    }
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stats) {
    err = cudaMemcpyAsync(stats, wk.stats, 8, cudaMemcpyDeviceToDevice, s);
  }
  return static_cast<int>(err);
}
