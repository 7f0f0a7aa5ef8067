// The fused compress -> 2-bit wire encoder on Hopper, one template for both
// encoders: sparsign_pack2bit.cu launches its sparsign instantiation,
// ternary.cu's pack variant one instantiation per rule. ternary.cu's flat
// kernel draws from the same rule structs.
//
// What it computes: pack2bit.cuh's wire of the rule's int8 symbols over the
// flat n-coordinate gradient, coordinate j drawing at counter
// counter_base + j (uint32, wrapping); coordinates past n and the canonical
// pad rows pack as code 0.
//
// Bound on an H100 (3.35 TB/s): bytes, 2.25 B/coord in bf16 (the gradient
// once, a quarter byte of wire). The drawing rules come close to the issue
// limit instead: the counter hash is integer work on the ALU pipe, 64 lanes a
// clock an SM, against about 11 such instructions a coordinate at the byte
// bound. So the design spends as few of them as it can:
//   - the seed's half of mix32's first xor-shift is taken once a stream
//     (common.cuh uniform01_folded), and the counter's product with the
//     golden ratio is one add from the thread's base;
//   - the probability is not clamped: u < clip(r, 0, 1) == u < r for every
//     u = k * 2^-24, k < 2^24, and every r (NaN, +-inf, negative, +-0);
//   - a symbol becomes its code without an int8 value or a compare: the
//     rule's margin (u - p for the drawing rules) is a float subtraction on
//     the FMA pipe whose sign bit says keep, and byte permutes that replicate
//     sign bits turn four margins, or four gradients' signs, into byte masks
//     at once; three bit-selects spread a column block's masks into its bit
//     pair, and the code word is keep & (neg ^ 0x55...). This holds because
//     a rule keeps a coordinate of input x only for x nonzero and not NaN;
//     noisy_sign, whose symbol is the sign of x plus noise, sets its bits by
//     compare;
//   - only the tiles at the tensor's end test pos < n.
// Layout: a thread owns kEncSpan = 8 bytes of one packed row, i.e. 8
// consecutive coordinates of each of the row's four column blocks, read as
// one 16-byte vector each in bf16; a 256-thread block covers a tile of 16
// rows. The tiles are walked by encode_tiles.cuh's frame, which pack8.cu's
// qsgd8 encoder shares: a persistent grid (3 blocks an SM here), each block
// walking the tiles in a stride, a thread's loads of its next tile in flight
// while it encodes one. On the H100 this register prefetch was as fast as a
// ring of four shared-memory stages filled by a producer warp with
// cp.async.bulk (0.5353 against 0.5366 ms for sparsign at w_down bf16,
// faster in the drawing rules), and 16 bytes a thread (201 registers) or 2
// blocks an SM were slower (PERF.md, PR 17).
// Every float operation of a rule is an _rn intrinsic, or CUDA's
// full-precision logf, cosf, sqrtf (the build has no --use_fast_math), as the
// plain version's torch operations compute them on the card.
#pragma once

#include <type_traits>

#include "encode_tiles.cuh"
#include "pack2bit.cuh"

namespace repro {

constexpr float kTwoPi = 6.28318530717958647692f;  // float32(2 * pi), as XLA rounds it
constexpr float kEps = 1e-12f;

// The int8 symbol of jnp.sign(x).astype(int8): +-0.0 and NaN give 0.
__device__ __forceinline__ int8_t symbol(float x) {
  return x > 0.0f ? int8_t(1) : (x < 0.0f ? int8_t(-1) : int8_t(0));
}

// The drawing rules of kernels/ternary/rules.py, for one stream, built once
// from its seed and param. a = counter * RNG_GOLDEN. A rule with kInputSign
// gives sign(x) or 0: it keeps x where the sign bit of margin(x, a) is set,
// only ever for x nonzero and not NaN. For the drawing rules the margin is
// u - p: its sign bit is set exactly when u < p, since with subnormals kept
// u - p is zero only for u == p, and a NaN p gives the card's canonical NaN,
// whose sign bit is clear. noisy_sign gives the value whose sign is the symbol.
struct SparsignRule {  // sign(g) if u < clip(|g| * B, 0, 1) else 0
  static constexpr bool kInputSign = true;
  uint32_t s;
  float b;
  static __device__ SparsignRule make(uint32_t seed, float param) {
    return {fold_hash(mix32(seed + RNG_GOLDEN)), param};
  }
  __device__ __forceinline__ float margin(float x, uint32_t a) const {
    return __fsub_rn(uniform01_folded(s, a), __fmul_rn(fabsf(x), b));
  }
};

struct SignRule {  // sign(g): no draw, param unused
  static constexpr bool kInputSign = true;
  static __device__ SignRule make(uint32_t, float) { return {}; }
  __device__ __forceinline__ float margin(float x, uint32_t) const {
    return __fadd_rn(-fabsf(x), 0.0f);  // -0 + 0 is +0: x = +-0 is not kept
  }
};

struct NoisySignRule {  // sign(g + sigma * sqrt(-2 log max(u_1, 1e-12)) * cos(2 pi u_2))
  static constexpr bool kInputSign = false;
  uint32_t s1, s2;  // the streams of the seed folded by 1 and by 2
  float sigma;
  static __device__ NoisySignRule make(uint32_t seed, float param) {
    return {fold_hash(mix32(fold_seed(seed, 1u) + RNG_GOLDEN)),
            fold_hash(mix32(fold_seed(seed, 2u) + RNG_GOLDEN)), param};
  }
  __device__ __forceinline__ float value(float x, uint32_t a) const {
    const float u1 = fmaxf(uniform01_folded(s1, a), kEps);
    const float u2 = uniform01_folded(s2, a);
    const float noise = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
    return __fadd_rn(x, __fmul_rn(sigma, noise));
  }
};

struct StochasticTernaryRule {  // sign(g) if u < clip(|g| / max(s, 1e-12), 0, 1) else 0
  static constexpr bool kInputSign = true;
  uint32_t s;
  float scale;
  static __device__ StochasticTernaryRule make(uint32_t seed, float param) {
    // jnp.maximum(s, 1e-12): a NaN normalizer stays NaN (fmaxf would drop it)
    return {fold_hash(mix32(seed + RNG_GOLDEN)), param != param ? param : fmaxf(param, kEps)};
  }
  __device__ __forceinline__ float margin(float x, uint32_t a) const {
    return __fsub_rn(uniform01_folded(s, a), __fdiv_rn(fabsf(x), scale));
  }
};

// rule ids: the order of kernels/ternary/rules.py RULES
enum RuleId : int { SPARSIGN = 0, SIGN = 1, NOISY_SIGN = 2, STOCHASTIC_TERNARY = 3 };
template <int R>
using RuleFor = std::conditional_t<
    R == SPARSIGN, SparsignRule,
    std::conditional_t<R == SIGN, SignRule,
                       std::conditional_t<R == NOISY_SIGN, NoisySignRule, StochasticTernaryRule>>>;

template <class Rule>
__device__ __forceinline__ int8_t rule_symbol(const Rule& rule, float x, uint32_t a) {
  if constexpr (Rule::kInputSign) {
    return rule.margin(x, a) < 0.0f ? symbol(x) : int8_t(0);
  } else {
    return symbol(rule.value(x, a));
  }
}

constexpr int kEncSpan = 8;         // packed bytes a thread owns: 32 coordinates
constexpr int kEncMinBlocks = 3;    // blocks an SM, so at most 85 registers a thread
constexpr int kEncThreadsPerRow = kRowBytes / kEncSpan;
constexpr int kEncTileRows = kThreads / kEncThreadsPerRow;
constexpr long long kEncTileCoords = static_cast<long long>(kEncTileRows) * kLanes;

// bits 2k, 2k + 1 of byte i from byte i of m[k]: (m0 & 0x03..) | (m1 & 0x0C..) | ...
__device__ __forceinline__ uint32_t spread_pairs(uint32_t m0, uint32_t m1, uint32_t m2,
                                                 uint32_t m3) {
  const uint32_t m01 = (m0 & 0x03030303u) | (m1 & ~0x03030303u);
  const uint32_t m012 = (m01 & 0x0F0F0F0Fu) | (m2 & ~0x0F0F0F0Fu);
  return (m012 & 0x3F3F3F3Fu) | (m3 & ~0x3F3F3F3Fu);
}

// A thread's coordinates of one tile as raw 32-bit words: w[k] holds the
// kEncSpan consecutive values of column block k.
template <typename T>
struct Chunk {
  static constexpr int kWords = kEncSpan * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[4][kWords];

  __device__ __forceinline__ float value(int k, int e) const {
    if constexpr (sizeof(T) == 2) {  // bf16 -> f32 is the 16 bits moved up
      const uint32_t v = w[k][e >> 1];
      return __uint_as_float((e & 1) ? (v & 0xFFFF0000u) : (v << 16));
    } else {
      return __uint_as_float(w[k][e]);
    }
  }

  // byte i: 0xFF if coordinate 4 q + i of column block k has its sign bit set, else 0
  __device__ __forceinline__ uint32_t neg_bytes(int k, int q) const {
    if constexpr (sizeof(T) == 2) {
      return prmt(w[k][2 * q], w[k][2 * q + 1], 0xFDB9u);
    } else {
      return sign_bytes(w[k][4 * q], w[k][4 * q + 1], w[k][4 * q + 2], w[k][4 * q + 3]);
    }
  }
};

// i: the flat index of the thread's first coordinate in column block 0
template <typename T>
__device__ __forceinline__ void load_full(Chunk<T>& c, const T* __restrict__ g, long long i) {
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int v = 0; v < Chunk<T>::kWords / 4; ++v) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(g + i + k * kRowBytes + v * kPerVec));
      c.w[k][4 * v] = q.x;
      c.w[k][4 * v + 1] = q.y;
      c.w[k][4 * v + 2] = q.z;
      c.w[k][4 * v + 3] = q.w;
    }
}

// element by element, values at or past n read as 0 (any alignment)
template <typename T>
__device__ __forceinline__ void load_masked(Chunk<T>& c, const T* __restrict__ g, long long i,
                                            long long n) {
  using Raw = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
  const Raw* p = reinterpret_cast<const Raw*>(g);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < kEncSpan; ++e) {
      const long long pos = i + k * kRowBytes + e;
      const uint32_t v = pos < n ? static_cast<uint32_t>(p[pos]) : 0u;
      if constexpr (sizeof(T) == 2) {
        if (e & 1) c.w[k][e >> 1] |= v << 16; else c.w[k][e >> 1] = v;
      } else {
        c.w[k][e] = v;
      }
    }
}

// The kEncSpan packed bytes of a thread's coordinates, as words: byte 4 q + i
// of the span packs column block k's coordinate 4 q + i at bits 2k, 2k + 1.
// a0: the first coordinate's counter times RNG_GOLDEN. A kept coordinate's
// bit pair is 11 in the keep mask and its sign's in the sign mask, so its
// code is keep & (neg ^ 01): 01 for +, 10 for -. With kRunMap, column block
// k draws from ak[k] (its first coordinate's a); with kCross too, adding
// skip_a (the map's skip times RNG_GOLDEN) from its coordinate cross[k] on.
// With kShortRunMap, a0 is counter_base and every coordinate's counter is
// map->offset's.
template <typename T, class Rule, bool kMasked, int kMap = kNoMap, bool kCross = false>
__device__ __forceinline__ Vec<uint32_t, kEncSpan / 4> encode(
    const Rule& rule, const Chunk<T>& c, uint32_t a0, long long i, long long n,
    const uint32_t* ak = nullptr, const int* cross = nullptr, uint32_t skip_a = 0u,
    const CounterMap* map = nullptr) {
  Vec<uint32_t, kEncSpan / 4> out;
#pragma unroll
  for (int q = 0; q < kEncSpan / 4; ++q) {
    uint32_t keep[4], bits = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t m[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * q + b;
        uint32_t a;
        if constexpr (kMap == kShortRunMap) {
          a = (a0 + map->offset(i + k * kRowBytes + e)) * RNG_GOLDEN;
        } else if constexpr (kCross) {
          a = ak[k] + static_cast<uint32_t>(e) * RNG_GOLDEN + (e >= cross[k] ? skip_a : 0u);
        } else if constexpr (kMap == kRunMap) {
          a = ak[k] + static_cast<uint32_t>(e) * RNG_GOLDEN;
        } else {
          a = a0 + static_cast<uint32_t>(k * kRowBytes + e) * RNG_GOLDEN;
        }
        const bool valid = !kMasked || i + k * kRowBytes + e < n;
        if constexpr (Rule::kInputSign) {
          m[b] = valid ? __float_as_uint(rule.margin(c.value(k, e), a)) : 0u;
        } else {
          const float y = rule.value(c.value(k, e), a);
          if (valid && y > 0.0f) bits |= 1u << (8 * b + 2 * k);
          if (valid && y < 0.0f) bits |= 2u << (8 * b + 2 * k);
        }
      }
      if constexpr (Rule::kInputSign) keep[k] = sign_bytes(m[0], m[1], m[2], m[3]);
    }
    if constexpr (Rule::kInputSign) {
      const uint32_t neg = spread_pairs(c.neg_bytes(0, q), c.neg_bytes(1, q),
                                        c.neg_bytes(2, q), c.neg_bytes(3, q));
      bits = spread_pairs(keep[0], keep[1], keep[2], keep[3]) & (neg ^ 0x55555555u);
    }
    out.v[q] = bits;
  }
  return out;
}

// One tile of a thread: its chunk's wire bytes to row (tile, sub), bytes slot * kEncSpan on.
template <typename T, class Rule, bool kMasked, int kMap>
__device__ __forceinline__ void encode_store(const Rule& rule, const Chunk<T>& c,
                                             uint8_t* __restrict__ out, long long tile, int sub,
                                             int slot, long long n, uint32_t counter_base,
                                             const CounterMap& map) {
  const long long row = tile * kEncTileRows + sub;
  const long long i = row * kLanes + slot * kEncSpan;
  auto* dst = reinterpret_cast<Vec<uint32_t, kEncSpan / 4>*>(out + row * kRowBytes +
                                                             slot * kEncSpan);
  if constexpr (kMap == kShortRunMap) {
    *dst = encode<T, Rule, kMasked, kShortRunMap>(rule, c, counter_base, i, n, nullptr,
                                                   nullptr, 0u, &map);
  } else if constexpr (kMap == kRunMap) {
    uint32_t ak[4];
    int cross[4];
    long long q, r;
    map.split(i, q, r);
    bool crosses = false;   // a run ends inside a column block's span: rare
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k > 0) map.advance(q, r, kRowBytes);
      map.group(counter_base, i + k * kRowBytes, q, r, ak[k], cross[k]);
      crosses |= cross[k] < kEncSpan;
    }
    if (crosses) {
      *dst = encode<T, Rule, kMasked, kRunMap, true>(rule, c, 0u, i, n, ak, cross,
                                                     map.skip * RNG_GOLDEN);
    } else {
      *dst = encode<T, Rule, kMasked, kRunMap>(rule, c, 0u, i, n, ak);
    }
  } else {
    const uint32_t a0 = (counter_base + static_cast<uint32_t>(i)) * RNG_GOLDEN;
    *dst = encode<T, Rule, kMasked>(rule, c, a0, i, n);
  }
}

// The 2-bit encoder of rule Rule for encode_tiles.cuh's walker: a thread owns
// kEncSpan bytes (slot) of one packed row (sub) of a tile.
template <typename T, class Rule>
struct Pack2Encoder {
  using In = T;
  using State = Rule;
  using Chunk = repro::Chunk<T>;
  struct Lane {
    int slot, sub;
    long long off;
  };
  static constexpr int kMinBlocks = kEncMinBlocks;
  static constexpr int kTileRows = kEncTileRows;
  static constexpr long long kTileCoords = kEncTileCoords;
  static constexpr int kOutAlign = kEncSpan;

  static __device__ __forceinline__ Lane lane() {
    const int slot = threadIdx.x % kEncThreadsPerRow, sub = threadIdx.x / kEncThreadsPerRow;
    return {slot, sub, static_cast<long long>(sub) * kLanes + slot * kEncSpan};
  }
  static __device__ __forceinline__ void load_full(Chunk& c, const T* __restrict__ g,
                                                   long long i) {
    repro::load_full(c, g, i);
  }
  static __device__ __forceinline__ void load_edge(Chunk& c, const T* __restrict__ g,
                                                   long long t, const Lane& l, long long n) {
    load_masked(c, g, (t * kEncTileRows + l.sub) * kLanes + l.slot * kEncSpan, n);
  }
  template <bool kMasked, int kMap>
  static __device__ __forceinline__ void store(const Rule& rule, const Chunk& c,
                                               uint8_t* __restrict__ out, long long t,
                                               const Lane& l, long long n,
                                               uint32_t counter_base, const CounterMap& map) {
    encode_store<T, Rule, kMasked, kMap>(rule, c, out, t, l.sub, l.slot, n, counter_base, map);
  }
};

}  // namespace repro
