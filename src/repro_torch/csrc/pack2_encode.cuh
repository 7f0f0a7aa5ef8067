// The fused compress -> 2-bit wire encoder on Hopper, one template for both
// encoders: sparsign_pack2bit.cu launches its sparsign instantiation,
// ternary.cu's pack variant one instantiation per rule. int8_encode.cuh's
// encoder (rows 1 and 4) draws from the same rule structs.
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
//     noisy_sign, whose symbol is the sign of x plus noise, sets its bits
//     from its fast symbol;
//   - stochastic_ternary and noisy_sign decide by exact fast paths (the
//     rules below), and a span whose codes show an undecided coordinate
//     takes it again through the plain version's arithmetic, out of line;
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
// Every float operation of a rule's exact arithmetic is an _rn intrinsic, or
// CUDA's full-precision logf, cosf, sqrtf (the build has no --use_fast_math),
// as the plain version's torch operations compute them on the card; the
// fast paths' approximations decide only where a proven bound covers them.
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
// gives sign(x) or 0: it keeps x where the sign bit of margin(x, a, ...) is
// set, only ever for x nonzero and not NaN. For the drawing rules the margin
// is u - p: its sign bit is set exactly when u < p, since with subnormals kept
// u - p is zero only for u == p, and a NaN p gives the card's canonical NaN,
// whose sign bit is clear. noisy_sign gives the value whose sign is the symbol.
//
// A rule with kFallBack has a fast path that may leave a coordinate
// undecided, which the encoders tell from its output four coordinates at a
// time: stochastic_ternary's margin comes with a second one, band, whose
// sign bit is set where u < hi (not dropped), so a coordinate is undecided
// where band's sign bit is set and margin's is not; noisy_sign's fast
// symbol is 0 exactly where it is undecided. Once a span of coordinates is
// encoded, the encoder takes its undecided ones again through
// exact_symbol, the plain version's arithmetic out of line: the hot loop
// holds one branch a span, none a coordinate. A row whose param the fast
// path does not take (exact_only) takes every coordinate so. The other
// rules are exact as they stand.
struct SparsignRule {  // sign(g) if u < clip(|g| * B, 0, 1) else 0
  static constexpr bool kInputSign = true;
  static constexpr bool kFallBack = false;
  uint32_t s;
  float b;
  static __device__ SparsignRule make(uint32_t seed, float param) {
    return {fold_hash(mix32(seed + RNG_GOLDEN)), param};
  }
  __device__ __forceinline__ float margin(float x, uint32_t a, float&) const {
    return __fsub_rn(uniform01_folded(s, a), __fmul_rn(fabsf(x), b));
  }
};

struct SignRule {  // sign(g): no draw, param unused
  static constexpr bool kInputSign = true;
  static constexpr bool kFallBack = false;
  static __device__ SignRule make(uint32_t, float) { return {}; }
  __device__ __forceinline__ float margin(float x, uint32_t, float&) const {
    return __fadd_rn(-fabsf(x), 0.0f);  // -0 + 0 is +0: x = +-0 is not kept
  }
};

// The exact fast paths of noisy_sign and stochastic_ternary. Each decides a
// coordinate from cheap arithmetic wherever a proven error bound settles the
// symbol; the encoders take the plain version's expression (below,
// __noinline__, so a kernel keeps one copy of it) only for the coordinates
// it leaves undecided. The decision rules are mirrored in float32
// by tests/test_torch_encode_int8.py (stochastic_decision, noisy_decision),
// which holds them against the exact comparison on adversarial inputs;
// chip_smoke.py counts the fallbacks (rule_fallbacks below, read through
// ternary_fallbacks_launch) and measures the noise bound over every uniform
// the kernel can draw.
//
// Undecided coordinates of this library's rules since the count was reset
// (a row the fast path does not take is not counted).
static __device__ unsigned long long rule_fallbacks = 0;

template <class Rule>
__device__ __forceinline__ void count_fallbacks(const Rule& rule, int undecided) {
  if (rule.fast && undecided)
    atomicAdd(&rule_fallbacks, static_cast<unsigned long long>(undecided));
}

// noisy_sign's noise, as the plain version computes it: n = RN(A(u1) C(u2)),
// A = sqrt(-2 log u1) and C = cos(2 pi u2) in CUDA's full-precision functions.
__device__ __forceinline__ float noise_radius(float u1) {
  return sqrtf(__fmul_rn(-2.0f, logf(u1)));
}
__device__ __forceinline__ float noise_angle(float u2) { return cosf(__fmul_rn(kTwoPi, u2)); }

// The special-function unit's approximations, flushing subnormals (the
// arguments here are normal or 0, and so are the results: the noise table
// below holds them at every argument the kernels pass)
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float cos_approx(float x) {
  float y;
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Ahat(u1) ~ A(u1) for u1 in [1e-12, 1): -2 log u1 from the hardware log2
// where it is large, and for m = 1 - u1 < 1/32 (exact: u1 >= 1/2) from its
// series 2m + m^2 + 2m^3/3 + m^4/2, where the log2's absolute error would
// dwarf the value; then the hardware square root.
__device__ __forceinline__ float noise_radius_approx(float u1) {
  const float m = __fsub_rn(1.0f, u1);
  float p = __fmaf_rn(m, 0.5f, 0.6666667f);
  p = __fmaf_rn(m, p, 1.0f);
  p = __fmaf_rn(m, p, 2.0f);
  const float near = __fmul_rn(m, p);
  const float far = __fmul_rn(lg2_approx(u1), -1.3862944f);   // -2 ln 2
  return sqrt_approx(m < 0.03125f ? near : far);
}

// Chat(u2) ~ C(u2): the hardware cosine on 2 pi r, r = u2 or u2 - 1 (exact)
// in [-1/2, 1/2), where its range reduction loses least.
__device__ __forceinline__ float noise_angle_approx(float u2) {
  const float r = u2 >= 0.5f ? __fsub_rn(u2, 1.0f) : u2;
  return cos_approx(__fmul_rn(kTwoPi, r));
}

// |n - Ahat Chat| <= kNoiseDelta for every pair of uniforms the kernel draws:
// chip_smoke.py's noise_bound evaluates Ahat, A, Chat and C at all 2^24
// values of each uniform with this library's code and fails unless
// kNoiseDelta >= max|Ahat - A| max|Chat| + max|A| max|Chat - C| + 2^-22, the
// last term n's own rounding (|A C| < 8). On the H100 (PERF.md, PR 27):
// 4.77e-7 x 1 + 7.434 x 6.86e-7 + 2.38e-7 = 5.81e-6.
constexpr float kNoiseDelta = 1e-5f;

// The plain version's symbols of noisy_sign and stochastic_ternary, out of
// line (their arguments the rule's fields, so a rule never leaves
// registers): the cold path of an undecided coordinate.
static __device__ __noinline__ int noisy_exact(float x, uint32_t a, uint32_t s1, uint32_t s2,
                                               float sigma) {
  const float u1 = fmaxf(uniform01_folded(s1, a), kEps);
  const float u2 = uniform01_folded(s2, a);
  return symbol(__fadd_rn(x, __fmul_rn(sigma, __fmul_rn(noise_radius(u1), noise_angle(u2)))));
}
static __device__ __noinline__ int stochastic_exact(float x, uint32_t a, uint32_t s,
                                                    float scale) {
  return __fsub_rn(uniform01_folded(s, a), __fdiv_rn(fabsf(x), scale)) < 0.0f ? symbol(x) : 0;
}

struct NoisySignRule {  // sign(g + sigma * sqrt(-2 log max(u_1, 1e-12)) * cos(2 pi u_2))
  static constexpr bool kInputSign = false;
  static constexpr bool kFallBack = true;
  uint32_t s1, s2;  // the streams of the seed folded by 1 and by 2
  float sigma;
  bool fast;        // |sigma| < 2^100, so sigma t is finite for |t| < 8 (NaN: false)
  static __device__ NoisySignRule make(uint32_t seed, float param) {
    return {fold_hash(mix32(fold_seed(seed, 1u) + RNG_GOLDEN)),
            fold_hash(mix32(fold_seed(seed, 2u) + RNG_GOLDEN)), param,
            fabsf(param) < 0x1p100f};
  }
  // The symbol where the fast path decides it (+-1), else 0. With
  // lo = RD(Ahat Chat - delta) <= n <= hi = RU(Ahat Chat + delta), RN(sigma t)
  // is monotone in t and finite, and RN(x + s) monotone in s, so y = RN(x +
  // RN(sigma n)) lies between y1 = RN(x + RN(sigma lo)) and y2 = RN(x +
  // RN(sigma hi)) whatever sigma's sign: both > 0 (both < 0) give y > 0
  // (y < 0). A y1 or y2 of +-0 (the plain version's y may be -0.0, symbol 0)
  // or NaN (x NaN) decides nothing; an infinite x gives y1 = y2 = y = x.
  __device__ __forceinline__ int fast_symbol(float x, uint32_t a) const {
    const float u1 = fmaxf(uniform01_folded(s1, a), kEps);
    const float u2 = uniform01_folded(s2, a);
    const float ah = noise_radius_approx(u1), ch = noise_angle_approx(u2);
    const float y1 = __fadd_rn(x, __fmul_rn(sigma, __fmaf_rd(ah, ch, -kNoiseDelta)));
    const float y2 = __fadd_rn(x, __fmul_rn(sigma, __fmaf_ru(ah, ch, kNoiseDelta)));
    const bool pos = (y1 > 0.0f) & (y2 > 0.0f), neg = (y1 < 0.0f) & (y2 < 0.0f);
    return pos ? 1 : (neg ? -1 : 0);
  }
  __device__ __forceinline__ bool exact_only() const { return !fast; }
  __device__ __forceinline__ int exact_symbol(float x, uint32_t a) const {
    return noisy_exact(x, a, s1, s2, sigma);
  }
};

// stochastic_ternary's band around qhat = RN(|x| RN(1 / s)): q = RN(|x| / s)
// lies within 3 2^-24 |x| / s + 2^-149 of qhat (three roundings, each within
// half an ulp or 2^-150 below the normal range), so within 2^-22 qhat +
// 2^-148; lo = RN(qhat (1 - 2^-21) - 2^-126) <= q and hi = RN(qhat (1 +
// 2^-21) + 2^-126) >= q (with room for their own rounding), so u < lo keeps
// and u >= hi drops.
constexpr float kBandLo = 1.0f - 0x1p-21f;
constexpr float kBandHi = 1.0f + 0x1p-21f;
constexpr float kBandTiny = 0x1p-126f;

struct StochasticTernaryRule {  // sign(g) if u < clip(|g| / max(s, 1e-12), 0, 1) else 0
  static constexpr bool kInputSign = true;
  static constexpr bool kFallBack = true;
  uint32_t s;
  float scale;      // max(s, 1e-12), NaN kept
  float recip;      // RN(1 / scale)
  bool fast;        // scale < 2^126: recip normal (NaN: false)
  static __device__ StochasticTernaryRule make(uint32_t seed, float param) {
    // jnp.maximum(s, 1e-12): a NaN normalizer stays NaN (fmaxf would drop it)
    const float scale = param != param ? param : fmaxf(param, kEps);
    return {fold_hash(mix32(seed + RNG_GOLDEN)), scale, __frcp_rn(scale), scale < 0x1p126f};
  }
  // The margin u - lo keeps where u < lo; band = u - hi drops where u >= hi
  // or x is NaN (a NaN's sign bit is clear), so u in [lo, hi) is undecided.
  // |x| = inf gives qhat = lo = inf: kept, as inf / s is. x = +-0 gives
  // qhat = 0: dropped, or undecided at u = 0.
  __device__ __forceinline__ float margin(float x, uint32_t a, float& band) const {
    const float u = uniform01_folded(s, a);
    const float q = __fmul_rn(fabsf(x), recip);
    band = __fsub_rn(u, __fmaf_rn(q, kBandHi, kBandTiny));
    return __fsub_rn(u, __fmaf_rn(q, kBandLo, -kBandTiny));
  }
  __device__ __forceinline__ bool exact_only() const { return !fast; }
  __device__ __forceinline__ int exact_symbol(float x, uint32_t a) const {
    return stochastic_exact(x, a, s, scale);
  }
};

// rule ids: the order of kernels/ternary/rules.py RULES
enum RuleId : int { SPARSIGN = 0, SIGN = 1, NOISY_SIGN = 2, STOCHASTIC_TERNARY = 3 };
template <int R>
using RuleFor = std::conditional_t<
    R == SPARSIGN, SparsignRule,
    std::conditional_t<R == SIGN, SignRule,
                       std::conditional_t<R == NOISY_SIGN, NoisySignRule, StochasticTernaryRule>>>;

// One coordinate's int8 symbol, exactly: the fast path, and the plain
// version's arithmetic where it leaves the coordinate undecided.
template <class Rule>
__device__ __forceinline__ int8_t rule_symbol(const Rule& rule, float x, uint32_t a) {
  if constexpr (Rule::kInputSign) {
    float band = 0.0f;
    const float m = rule.margin(x, a, band);
    if constexpr (Rule::kFallBack) {
      const bool und = (__float_as_uint(band) & ~__float_as_uint(m)) >> 31;
      if (und || rule.exact_only()) {
        count_fallbacks(rule, und);
        return static_cast<int8_t>(rule.exact_symbol(x, a));
      }
    }
    return m < 0.0f ? symbol(x) : int8_t(0);
  } else {
    const int s = rule.fast_symbol(x, a);
    if (s == 0 || rule.exact_only()) {
      count_fallbacks(rule, s == 0);
      return static_cast<int8_t>(rule.exact_symbol(x, a));
    }
    return static_cast<int8_t>(s);
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

// Coordinate e of column block k's counter times RNG_GOLDEN (encode's
// counter modes below).
template <int kMap, bool kCross>
__device__ __forceinline__ uint32_t coordinate_a(uint32_t a0, long long i, int k, int e,
                                                 const uint32_t* ak, const int* cross,
                                                 uint32_t skip_a, const CounterMap* map) {
  if constexpr (kMap == kShortRunMap) {
    return (a0 + map->offset(i + k * kRowBytes + e)) * RNG_GOLDEN;
  } else if constexpr (kCross) {
    return ak[k] + static_cast<uint32_t>(e) * RNG_GOLDEN + (e >= cross[k] ? skip_a : 0u);
  } else if constexpr (kMap == kRunMap) {
    return ak[k] + static_cast<uint32_t>(e) * RNG_GOLDEN;
  } else {
    return a0 + static_cast<uint32_t>(k * kRowBytes + e) * RNG_GOLDEN;
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
// map->offset's. und[q] gets bit 8 i + 2 k where the rule's fast path
// leaves coordinate 4 q + i of column block k undecided (below n).
template <typename T, class Rule, bool kMasked, int kMap = kNoMap, bool kCross = false>
__device__ __forceinline__ Vec<uint32_t, kEncSpan / 4> encode(
    const Rule& rule, const Chunk<T>& c, uint32_t a0, long long i, long long n,
    const uint32_t* ak, const int* cross, uint32_t skip_a, const CounterMap* map,
    uint32_t* und) {
  Vec<uint32_t, kEncSpan / 4> out;
#pragma unroll
  for (int q = 0; q < kEncSpan / 4; ++q) {
    uint32_t keep[4], below[4], bits = 0u, valid_pairs = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t m[4], bd[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * q + b;
        const uint32_t a = coordinate_a<kMap, kCross>(a0, i, k, e, ak, cross, skip_a, map);
        const bool valid = !kMasked || i + k * kRowBytes + e < n;
        if constexpr (Rule::kInputSign) {
          float band = 0.0f;
          m[b] = valid ? __float_as_uint(rule.margin(c.value(k, e), a, band)) : 0u;
          bd[b] = valid ? __float_as_uint(band) : 0u;
        } else {   // the fast symbol's code: 01 for +1, 10 for -1, 00 undecided
          const int s = rule.fast_symbol(c.value(k, e), a);
          if (valid) bits |= (s > 0 ? 1u : (s < 0 ? 2u : 0u)) << (8 * b + 2 * k);
          if (kMasked && valid) valid_pairs |= 1u << (8 * b + 2 * k);
        }
      }
      if constexpr (Rule::kInputSign) {
        keep[k] = sign_bytes(m[0], m[1], m[2], m[3]);
        if constexpr (Rule::kFallBack) below[k] = sign_bytes(bd[0], bd[1], bd[2], bd[3]);
      }
    }
    if constexpr (Rule::kInputSign) {
      const uint32_t neg = spread_pairs(c.neg_bytes(0, q), c.neg_bytes(1, q),
                                        c.neg_bytes(2, q), c.neg_bytes(3, q));
      const uint32_t kept = spread_pairs(keep[0], keep[1], keep[2], keep[3]);
      bits = kept & (neg ^ 0x55555555u);
      if constexpr (Rule::kFallBack)
        und[q] = spread_pairs(below[0], below[1], below[2], below[3]) & ~kept & 0x55555555u;
    } else {
      und[q] = ~(bits | bits >> 1) & (kMasked ? valid_pairs : 0x55555555u);
    }
    out.v[q] = bits;
  }
  return out;
}

// The pair bits (8 i + 2 k of word q) of a span's coordinates below n.
template <bool kMasked>
__device__ __forceinline__ uint32_t valid_pairs(long long i, long long n, int q) {
  if constexpr (!kMasked) return 0x55555555u;
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bits |= i + k * kRowBytes + 4 * q + b < n ? 1u << (8 * b + 2 * k) : 0u;
  return bits;
}

// The codes of the coordinates set in und (every one below n in a row that
// takes no fast path), again through the rule's exact arithmetic, out of
// line, one call each.
template <typename T, class Rule, bool kMasked, int kMap, bool kCross>
__device__ __forceinline__ void settle(Vec<uint32_t, kEncSpan / 4>& out, uint32_t* und,
                                       const Rule& rule, const Chunk<T>& c, uint32_t a0,
                                       long long i, long long n, const uint32_t* ak,
                                       const int* cross, uint32_t skip_a, const CounterMap* map) {
  if constexpr (Rule::kFallBack) {
    if (rule.exact_only()) {
#pragma unroll
      for (int q = 0; q < kEncSpan / 4; ++q) und[q] = valid_pairs<kMasked>(i, n, q);
    }
    uint32_t any = 0u;
#pragma unroll
    for (int q = 0; q < kEncSpan / 4; ++q) any |= und[q];
    if (!any) return;
    int count = 0;
#pragma unroll
    for (int q = 0; q < kEncSpan / 4; ++q) count += __popc(und[q]);
    count_fallbacks(rule, count);
#pragma unroll
    for (int q = 0; q < kEncSpan / 4; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int shift = 8 * b + 2 * k;
          if (und[q] & (1u << shift)) {
            const uint32_t a =
                coordinate_a<kMap, kCross>(a0, i, k, 4 * q + b, ak, cross, skip_a, map);
            const int s = rule.exact_symbol(c.value(k, 4 * q + b), a);
            const uint32_t code = s > 0 ? 1u : (s < 0 ? 2u : 0u);
            out.v[q] = (out.v[q] & ~(3u << shift)) | (code << shift);
          }
        }
  }
}

// One tile of a thread: its chunk's wire bytes to row (tile, sub), bytes
// slot * kEncSpan on, the coordinates the rule's fast path leaves undecided
// settled by its exact arithmetic.
template <typename T, class Rule, bool kMasked, int kMap>
__device__ __forceinline__ void encode_store(const Rule& rule, const Chunk<T>& c,
                                             uint8_t* __restrict__ out, long long tile, int sub,
                                             int slot, long long n, uint32_t counter_base,
                                             const CounterMap& map) {
  const long long row = tile * kEncTileRows + sub;
  const long long i = row * kLanes + slot * kEncSpan;
  auto* dst = reinterpret_cast<Vec<uint32_t, kEncSpan / 4>*>(out + row * kRowBytes +
                                                             slot * kEncSpan);
  uint32_t ak[4];
  int cross[4];
  bool crosses = false;   // kRunMap: a run ends inside a column block's span: rare
  if constexpr (kMap == kRunMap) {
    long long q, r;
    map.split(i, q, r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k > 0) map.advance(q, r, kRowBytes);
      map.group(counter_base, i + k * kRowBytes, q, r, ak[k], cross[k]);
      crosses |= cross[k] < kEncSpan;
    }
  }
  uint32_t a0 = 0u;
  if constexpr (kMap == kShortRunMap) a0 = counter_base;
  if constexpr (kMap == kNoMap) a0 = (counter_base + static_cast<uint32_t>(i)) * RNG_GOLDEN;
  const uint32_t skip_a = map.skip * RNG_GOLDEN;
  uint32_t und[kEncSpan / 4];
  Vec<uint32_t, kEncSpan / 4> v;
  if constexpr (kMap == kRunMap) {
    if (crosses) {
      v = encode<T, Rule, kMasked, kMap, true>(rule, c, a0, i, n, ak, cross, skip_a, &map, und);
      settle<T, Rule, kMasked, kMap, true>(v, und, rule, c, a0, i, n, ak, cross, skip_a, &map);
    } else {
      v = encode<T, Rule, kMasked, kMap>(rule, c, a0, i, n, ak, cross, skip_a, &map, und);
      settle<T, Rule, kMasked, kMap, false>(v, und, rule, c, a0, i, n, ak, cross, skip_a, &map);
    }
  } else {
    v = encode<T, Rule, kMasked, kMap>(rule, c, a0, i, n, ak, cross, skip_a, &map, und);
    settle<T, Rule, kMasked, kMap, false>(v, und, rule, c, a0, i, n, ak, cross, skip_a, &map);
  }
  *dst = v;
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
