// The int8 encoder of rows 1 and 4 on Hopper: the drawing rules of
// pack2_encode.cuh, each coordinate's symbol written as one int8, over
// encode_tiles.cuh's frame for many rows (encode_rows_kernel). sparsign.cu
// launches its sparsign instantiation, ternary.cu one instantiation per rule.
//
// What it computes: out[r, j] = RULE(g[r, j], u(seed[r], counter_base + j),
// param[r]) in {-1, 0, +1}, for rows of n contiguous coordinates; with a
// counter map (a model rank's slice of a leaf) column j draws counter
// counter_base + j + (j / run) * skip, as the 2-bit encoder's does.
//
// Bound on an H100 (3.35 TB/s): bytes, 3 B/coord in bf16 (the gradient once,
// the int8 symbol once), 5 in float32. What it carries over from the 2-bit
// encoder, which reaches 88.7 % of its tighter 2.25 B/coord bound with the
// same rules (PERF.md):
//   - the persistent grid, each thread's loads of its next tile in flight in
//     registers while it encodes one;
//   - a row's setup (seed hash, folds, param) once per row a block meets, in
//     shared memory (encode_tiles.cuh's TileRows), never once per thread;
//   - no 64-bit division per thread: a tile knows its row and column base,
//     and a run of 16 coordinates inside one row (all but about 16 / n of
//     them) draws from one counter, each coordinate's one add from it;
//   - the unclamped margin u - p, whose sign bit says keep, and four symbols
//     at once from byte masks: keep & (neg | 0x01) is 0x01, 0xFF or 0x00 a
//     byte (a rule keeps only nonzero, non-NaN x, so neg is x's sign there);
//     noisy_sign's fast symbols are its bytes;
//   - the fast paths of stochastic_ternary (a reciprocal a row, no division
//     a coordinate) and noisy_sign (the hardware's log2, square root and
//     cosine, and an interval test) in pack2_encode.cuh's rules, exact: a
//     run's undecided coordinates show in its bytes (a band margin's sign
//     bytes, or a symbol byte of 0), and only a run that has one branches,
//     to the plain version's arithmetic out of line, coordinate by
//     coordinate. Written as a branch a coordinate, or as a second exact
//     pass over the run in line, the same rules ran up to twice as slow on
//     the H100 (PERF.md, PR 27).
// Layout: thread x of a tile owns kRuns runs of kRun = 16 consecutive
// coordinates, at 16 x and 4096 + 16 x: a warp's loads and its 16-byte
// stores of symbols cover 512 contiguous coordinates, as qsgd8's encoder
// (pack8.cu) lays them out. Two runs in bf16 (a tile of 8,192) and one in
// float32 (4,096) keep a chunk at 16 words, so the prefetch holds 32
// registers in either type; every instantiation fits 80 registers at 3
// blocks an SM. The tiles are flat over rows * n (encode_tiles.cuh says
// why); a run that crosses a row's end, or the message's, takes the
// coordinate-by-coordinate path, as does every run of a short map run
// (kShortRunMap, a division a coordinate). With kRunMap a run of 16 splits
// its first column once (a 32-bit division where it fits) and crosses at
// most one map run's end, since that run is at least 16 long.
#pragma once

#include "pack2_encode.cuh"

namespace repro {

// q = c / d, r = c - q d, in 32 bits where both fit
__device__ __forceinline__ void divmod(long long c, long long d, long long& q, long long& r) {
  if (((c | d) >> 32) == 0) {
    const uint32_t q32 = static_cast<uint32_t>(c) / static_cast<uint32_t>(d);
    q = q32;
  } else {
    q = c / d;
  }
  r = c - q * d;
}

template <typename T, class Rule>
struct Int8Encoder {
  using In = T;
  using State = Rule;
  static constexpr int kRun = 16;                       // one 16-byte store of symbols
  static constexpr int kRuns = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kRunStride = kThreads * kRun;    // 4096
  static constexpr long long kTileCoords = static_cast<long long>(kRunStride) * kRuns;
  static constexpr int kMinBlocks = 3;                  // at most 85 registers a thread
  static constexpr int kOutAlign = 16;
  static constexpr int kWords = kRun * static_cast<int>(sizeof(T)) / 4;
  struct Chunk {
    uint32_t w[kRuns][kWords];
  };
  struct Lane {
    long long off;
  };

  static __device__ __forceinline__ Lane lane() {
    return {static_cast<long long>(threadIdx.x) * kRun};
  }

  static __device__ __forceinline__ void load_full(Chunk& c, const T* __restrict__ g,
                                                   long long i) {
    constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int j = 0; j < kRuns; ++j)
#pragma unroll
      for (int v = 0; v < kWords / 4; ++v) {
        const uint4 q =
            __ldg(reinterpret_cast<const uint4*>(g + i + j * kRunStride + v * kPerVec));
        c.w[j][4 * v] = q.x;
        c.w[j][4 * v + 1] = q.y;
        c.w[j][4 * v + 2] = q.z;
        c.w[j][4 * v + 3] = q.w;
      }
  }

  // element by element, values at or past total read as 0 (any alignment)
  static __device__ __forceinline__ void load_edge(Chunk& c, const T* __restrict__ g,
                                                   long long t, const Lane& l, long long total) {
    using Raw = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
    const Raw* p = reinterpret_cast<const Raw*>(g);
    const long long i = t * kTileCoords + l.off;
#pragma unroll
    for (int j = 0; j < kRuns; ++j)
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const long long pos = i + j * kRunStride + e;
        const uint32_t v = pos < total ? static_cast<uint32_t>(p[pos]) : 0u;
        if constexpr (sizeof(T) == 2) {
          if (e & 1) c.w[j][e >> 1] |= v << 16; else c.w[j][e >> 1] = v;
        } else {
          c.w[j][e] = v;
        }
      }
  }

  static __device__ __forceinline__ float value(const Chunk& c, int j, int e) {
    if constexpr (sizeof(T) == 2) {  // bf16 -> f32 is the 16 bits moved up
      const uint32_t v = c.w[j][e >> 1];
      return __uint_as_float((e & 1) ? (v & 0xFFFF0000u) : (v << 16));
    } else {
      return __uint_as_float(c.w[j][e]);
    }
  }

  // byte i: 0xFF if coordinate 4 q + i of run j has its sign bit set, else 0
  static __device__ __forceinline__ uint32_t neg_bytes(const Chunk& c, int j, int q) {
    if constexpr (sizeof(T) == 2) {
      return prmt(c.w[j][2 * q], c.w[j][2 * q + 1], 0xFDB9u);
    } else {
      return sign_bytes(c.w[j][4 * q], c.w[j][4 * q + 1], c.w[j][4 * q + 2], c.w[j][4 * q + 3]);
    }
  }

  // The 16 symbols of run j inside one row, as four words (byte i of word q:
  // coordinate 4 q + i). Coordinate e draws a = a0 + e RNG_GOLDEN, plus
  // skip_a from e = cross on (kCross: the run crosses a map run's end). The
  // coordinates the rule's fast path leaves undecided (bit 0 of their byte
  // in und[q]; every one, in a row that takes no fast path) are settled by
  // its exact arithmetic, out of line, one call each.
  template <bool kCross>
  static __device__ __forceinline__ uint4 encode_run(const Rule& rule, const Chunk& c, int j,
                                                     uint32_t a0, int cross, uint32_t skip_a) {
    uint32_t w[4], und[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t m[4], bd[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * q + b;
        const float x = value(c, j, e);
        const uint32_t a = counter_a<kCross>(a0, e, cross, skip_a);
        if constexpr (Rule::kInputSign) {
          float band = 0.0f;
          m[b] = __float_as_uint(rule.margin(x, a, band));
          bd[b] = __float_as_uint(band);
        } else {   // the fast symbol, 0 where undecided
          m[b] = static_cast<uint32_t>(rule.fast_symbol(x, a));
        }
      }
      if constexpr (Rule::kInputSign) {
        const uint32_t keep = sign_bytes(m[0], m[1], m[2], m[3]);
        w[q] = keep & (neg_bytes(c, j, q) | 0x01010101u);
        if constexpr (Rule::kFallBack)
          und[q] = sign_bytes(bd[0], bd[1], bd[2], bd[3]) & ~keep & 0x01010101u;
      } else {
        w[q] = prmt(prmt(m[0], m[1], 0x0040u), prmt(m[2], m[3], 0x0040u), 0x5410u);
        und[q] = ~w[q] & 0x01010101u;   // a symbol byte 0x01 or 0xFF has bit 0 set
      }
    }
    if constexpr (Rule::kFallBack) {
      if (rule.exact_only()) und[0] = und[1] = und[2] = und[3] = 0x01010101u;
      if (und[0] | und[1] | und[2] | und[3]) {
        count_fallbacks(rule, __popc(und[0]) + __popc(und[1]) + __popc(und[2]) +
                                  __popc(und[3]));
#pragma unroll
        for (int e = 0; e < kRun; ++e) {
          const int shift = 8 * (e & 3);
          if (und[e >> 2] & (1u << shift)) {
            const uint32_t s = static_cast<uint8_t>(
                rule.exact_symbol(value(c, j, e), counter_a<kCross>(a0, e, cross, skip_a)));
            w[e >> 2] = (w[e >> 2] & ~(0xFFu << shift)) | (s << shift);
          }
        }
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  template <bool kCross>
  static __device__ __forceinline__ uint32_t counter_a(uint32_t a0, int e, int cross,
                                                       uint32_t skip_a) {
    const uint32_t a = a0 + static_cast<uint32_t>(e) * RNG_GOLDEN;
    return kCross && e >= cross ? a + skip_a : a;
  }

  // Run j coordinate by coordinate from row r, column col: row ends, the
  // message's end, a short map run.
  template <int kMap>
  static __device__ __forceinline__ uint4 encode_slow(const TileRows<Rule>& rows, const Chunk& c,
                                                      int j, long long pos, long long total,
                                                      long long r, long long col,
                                                      uint32_t counter_base,
                                                      const CounterMap& map) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    Rule rule = rows.state(r);
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      if (pos + e < total) {
        if (col == rows.n) {
          ++r;
          col = 0;
          rule = rows.state(r);
        }
        const uint32_t counter = counter_base + (kMap == kNoMap ? static_cast<uint32_t>(col)
                                                                : map.offset(col));
        const uint32_t s = static_cast<uint8_t>(rule_symbol(rule, value(c, j, e),
                                                            counter * RNG_GOLDEN));
        w[e >> 2] |= s << (8 * (e & 3));
        ++col;
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  template <bool kMasked, int kMap>
  static __device__ __forceinline__ void store(const TileRows<Rule>& rows, const Chunk& c,
                                               uint8_t* __restrict__ out, long long t,
                                               const Lane& l, long long total,
                                               uint32_t counter_base, const CounterMap& map) {
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
      const long long o = l.off + j * kRunStride;
      const long long pos = t * kTileCoords + o;
      if (kMasked && pos >= total) continue;
      long long r, col;
      rows.locate(o, r, col);
      uint4 v;
      if ((kMasked && pos + kRun > total) || col + kRun > rows.n ||
          (kMap == kShortRunMap)) {
        v = encode_slow<kMap>(rows, c, j, pos, total, r, col, counter_base, map);
      } else {
        const Rule rule = rows.state(r);
        if constexpr (kMap == kRunMap) {
          long long q, rr;
          divmod(col, map.run, q, rr);
          const uint32_t a0 = (counter_base + static_cast<uint32_t>(col) +
                               static_cast<uint32_t>(q) * map.skip) * RNG_GOLDEN;
          const long long left = map.run - rr;
          if (left < kRun) {
            v = encode_run<true>(rule, c, j, a0, static_cast<int>(left), map.skip * RNG_GOLDEN);
          } else {
            v = encode_run<false>(rule, c, j, a0, kRun, 0u);
          }
        } else {
          v = encode_run<false>(rule, c, j, (counter_base + static_cast<uint32_t>(col)) *
                                                RNG_GOLDEN, kRun, 0u);
        }
      }
      if (kMasked && pos + kRun > total) {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < kRun; ++e)
          if (pos + e < total) out[pos + e] = static_cast<uint8_t>(w[e >> 2] >> (8 * (e & 3)));
      } else {
        *reinterpret_cast<uint4*>(out + pos) = v;
      }
    }
  }
};

}  // namespace repro
