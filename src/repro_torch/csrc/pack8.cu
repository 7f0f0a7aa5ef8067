// qsgd8_pack8 and unpack8_sum: the 8-bit QSGD (pack8) wire on Hopper.
//
// Replaces: src/repro/kernels/pack8/kernel.py:91 (qsgd8_pack8_2d) and
// src/repro/kernels/pack8/kernel.py:111 (unpack8_sum_2d), Pallas TPU.
//
//   qsgd8_pack8: r     = |g[c]| / pm, pm = max(param, 1e-20)  (correctly rounded)
//                level = min(floor(r) + [u(seed, counter_base + c) < r - floor(r)], 127)
//                out   = int8(sign(g[c]) * level)  over the canonical (rows, 512)
//                        view, rows = canonical_rows(n); coordinates past n are 0
//   unpack8_sum: out[c] = (((a + l_0[c] s_0) + l_1[c] s_1) + ...) + l_{M-1}[c] s_{M-1}
//                a = 0 (+0.0), or with accumulate a = out[c] (the ring's hop)
//
// with u = k 2^-24 the counter-hash uniform of repro.core.prng, regenerated in
// registers; max and min propagate NaN as jnp's do, and a NaN level (a NaN
// gradient or scale) quantizes to 0, as XLA's float -> int8 convert gives it.
// The decode's products and sums are __fmul_rn and __fadd_rn, each rounded on
// its own, so no multiply-add contraction moves the sum off the decoded-psum
// wire, which materializes (rounds) every product before its worker-order
// sum. The sum starts at +0.0, as the plain version and the TPU kernel's
// accumulator do, or, accumulating, at the output's value.
//
// Bound on an H100 (3.35 TB/s): bytes. qsgd8_pack8 reads the gradient once
// and writes a byte: 3 B/coord in bf16, 5 in f32; its 27 operations a
// coordinate (chip_smoke.py's QSGD8_OPS_PER_COORD) take under half that time
// at the float32 rate, but at the issue rate measured for the fused 2-bit
// encoders (23.6 us at w_down per SASS instruction a coordinate, PERF.md)
// the bf16 byte bound leaves about 27 instructions a coordinate. unpack8_sum
// reads one byte per worker and writes 4 (and reads them, accumulating):
// (M + 4) or (M + 8) B/coord; 3 operations per worker.
//
// qsgd8_pack8's design: encode_tiles.cuh's frame (the 2-bit encoders'), a
// thread owning two runs of 16 consecutive coordinates of a 8192-coordinate
// tile, 16-byte loads, each run's levels stored as one 16-byte vector; 3
// blocks an SM in bf16 (80 registers), 2 in float32 (127). On the H100 at
// w_down (PERF.md) this took bf16 from 1.497 to 0.736-0.753 ms, 86 %
// of the byte bound, at 23.5 SASS instructions a coordinate, so neither the
// issue rate (about 0.55 ms) nor the bytes alone bound it; 4 blocks an SM,
// runs of 8 with 8-byte stores, streaming (.cs) loads and stores, and one
// fma correction instead of two were each as fast or slower. The level is
// computed so (tests/test_torch_pack8_encode.py holds each step on the CPU,
// chip_smoke.py the kernel on the card, bit for bit):
//  1. In integers. k < ceil(f 2^24) <=> u < f, and r 2^24 is exact, so with
//     C = ceil(r 2^24) = floor(r) 2^24 + ceil(frac 2^24), the sum
//     min(C, 127 2^24) + 2^24 - 1 - k carries into bit 24 exactly when
//     u < frac: its top byte is the level, for every r >= 0, r >= 127 and inf
//     giving 127. C is one cvt.rpi.u32, which saturates and takes NaN to 0,
//     so NaN needs no test; 2^24 - 1 - k is the hash's top 24 bits
//     complemented (common.cuh uniform_complement); byte permutes collect
//     four top bytes into a word.
//  2. The sign, four bytes at once: a negative byte is (0x80 - L) ^ 0x80, a
//     positive one 0x7F - (L ^ 0x7F) = L. No byte borrows, and L = 0 stays 0
//     (-0.0, and NaN of either sign).
//  3. The division, for 1e-20 <= pm < 2 (tested once a message; a larger,
//     inf or NaN pm takes __fdiv_rn per coordinate, then r 2^24). With
//     d = pm 2^-24 (exact, >= 2^-91), y = RN(1/d) (__frcp_rn, once a block)
//     and a = min(|g|, 128 pm) (min.NaN keeps NaN; 128 pm is exact, and
//     a / pm >= 128 gives 127 either way), three fmas after a multiply give
//     Q = RN(a / d) = 2^24 RN(a / pm):
//         q0 = RN(a y), q1 = RN(q0 + RN(a - q0 d) y), Q = RN(q1 + (a - q1 d) y).
//     Why, with z = a / d <= 2^31, U = ulp(z), B < 2^24 d's significand as an
//     integer, so that d |y - 1/d| <= B 2^-48 < 2^-24:
//     - z >= 2^-11. q0 is within 1.5 U, so q1 is within U/2 + 3 U 2^-24 (the
//       first remainder rounds at most once), hence within 1 U, and a - q1 d
//       is exact (Markstein's lemma; z >= 2^-11 and d >= 2^-91 keep it on or
//       above the subnormal grid). z = A 2^i / (B 2^j) with 24-bit A is never
//       a midpoint: it differs from the nearest one by m >= U / (2 B). Then
//       |z - q1| <= U/2 + m, and q1 + (a - q1 d) y = z + (z - q1) d (y - 1/d)
//       is within (U/2 + m) B 2^-48 < m of z, as B (B + 1) < 2^48: on z's side
//       of every midpoint, so Q = RN(z) (Markstein's theorem). RN(a / pm) is
//       normal there, where scaling by 2^24 commutes with rounding.
//     - z < 2^-11. Then C = 1 exactly when a > 0 (pm < 2 keeps a / pm above
//       2^-150 for a >= 2^-149). y > 2^23 keeps q0 normal, and each step moves
//       the value by less than 2^-22 of itself (a rounded remainder is off by
//       at most its own size), so 0 < Q < 1 for a > 0, and Q = 0 for a = 0.
//     This spends a multiply, four fmas and a min a coordinate where __fdiv_rn
//     spent a reciprocal on the special-function unit, five fmas, a range
//     check and a branch.
//
// unpack8_sum's design: pack2bit.cuh's warp-a-row layout. Lane l of the warp
// that owns a canonical row holds its coordinates 4l + e + 128k (e, k in
// 0..3): per worker it loads four 4-byte words of levels (a warp load reads
// 128 contiguous bytes), and it stores four 16-byte vectors of sums (a warp
// store writes 512 contiguous bytes). The words of kDecodeBatch workers are
// loaded before their adds (all M of them up to M = 8), with the
// accumulator's four vectors when accumulating; 16 float sums in registers,
// no scratch that grows with M. Offsets are 64-bit: M x rows x 512 passes
// 2^31 at the trainer's shapes. On the H100 at w_down (PERF.md,
// --decode-split A B B A against the parent): M = 1 2.1031 -> 1.2062 ms
// (87.6 % of the 1.0564 ms byte bound), M = 4 2.0262 -> 1.8727 (90.3 % of
// 1.6902). The parent's
// thread owned 16 consecutive coordinates and stored them as four 16-byte
// vectors 64 bytes apart, so each warp store instruction half-filled 64
// sectors over 2 KB; at M = 1 the stores are 80 % of the bytes, which is why
// M = 1 ran slower than M = 4 there (and why M = 4, half stores, gains
// least). Tried and not kept: M = 1 and 4 as compile-time constants (1.2208,
// 1.9002 ms), one worker's words at a time (1.2154, 1.9040), streaming (.cs)
// stores (1.2155, 1.9007).
#include <type_traits>

#include "encode_tiles.cuh"
#include "pack2bit.cuh"   // the decode-sums' warp-a-row layout

namespace {

using namespace repro;

constexpr int kDecodeBatch = 8;            // unpack8_sum: workers in flight a thread
constexpr uint32_t kTop = 127u << 24;      // the clip at QSGD8_LEVELS = 127, times 2^24
constexpr float kTwo24 = 16777216.0f;

// jnp.maximum: a NaN operand gives NaN (fmaxf would return the other operand)
__device__ __forceinline__ float nan_max(float a, float b) { return isnan(a) ? a : fmaxf(a, b); }

// min that keeps a NaN operand (PTX min.NaN)
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// A message's constants, built once a block.
struct Qsgd8State {
  uint32_t folded;   // fold_hash of the stream's seed hash
  float pm;          // max(param, 1e-20), NaN kept
  float d, y, cap;   // the hoisted division's pm 2^-24, RN(1 / d) and 128 pm
  bool hoisted;      // 1e-20 <= pm < 2
  static __device__ Qsgd8State make(uint32_t seed, float param) {
    const float pm = nan_max(param, 1e-20f);
    const float d = __fmul_rn(pm, 1.0f / kTwo24);
    return {fold_hash(mix32(seed + RNG_GOLDEN)), pm, d, __frcp_rn(d), __fmul_rn(pm, 128.0f),
            pm < 2.0f};
  }
};

// min(ceil(2^24 r), 127 2^24) for r = |x| / pm (header, steps 1 and 3)
template <bool kHoisted>
__device__ __forceinline__ uint32_t scaled_ceil(const Qsgd8State& s, float x) {
  float q;
  if constexpr (kHoisted) {
    const float a = min_nan(fabsf(x), s.cap);
    const float q0 = __fmul_rn(a, s.y);
    const float q1 = __fmaf_rn(__fmaf_rn(-q0, s.d, a), s.y, q0);
    q = __fmaf_rn(__fmaf_rn(-q1, s.d, a), s.y, q1);
  } else {
    q = __fmul_rn(__fdiv_rn(fabsf(x), s.pm), kTwo24);
  }
  return min(__float2uint_ru(q), kTop);
}

// byte i: level byte i of lv (0..127), negated where byte i of neg is 0xFF
__device__ __forceinline__ uint32_t signed_levels(uint32_t lv, uint32_t neg) {
  return ((0x7F7F7F7Fu ^ neg) - (lv ^ (~neg & 0x7F7F7F7Fu))) ^ (neg & 0x80808080u);
}

// The qsgd8 encoder for encode_tiles.cuh's walker: thread x of a tile owns
// the runs of kRun coordinates at x kRun and kRunStride + x kRun.
template <typename T>
struct Qsgd8Encoder {
  using In = T;
  using State = Qsgd8State;
  static constexpr int kRun = 16;                       // one 16-byte store of levels
  static constexpr int kRuns = 2;
  static constexpr int kRunStride = kThreads * kRun;    // a block's run: 4096 coordinates
  static constexpr long long kTileCoords = static_cast<long long>(kRunStride) * kRuns;
  static constexpr int kTileRows = static_cast<int>(kTileCoords / kLanes);
  static constexpr int kOutAlign = kRun;
  static constexpr int kMinBlocks = sizeof(T) == 2 ? 3 : 2;   // 85 or 128 registers
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

  // element by element, values at or past n read as 0 (any alignment); a
  // zero encodes as level 0, so the pad needs no test of its own
  static __device__ __forceinline__ void load_edge(Chunk& c, const T* __restrict__ g,
                                                   long long t, const Lane& l, long long n) {
    using Raw = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
    const Raw* p = reinterpret_cast<const Raw*>(g);
    const long long i = t * kTileCoords + l.off;
#pragma unroll
    for (int j = 0; j < kRuns; ++j)
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const long long pos = i + j * kRunStride + e;
        const uint32_t v = pos < n ? static_cast<uint32_t>(p[pos]) : 0u;
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

  // i: the flat index of the thread's first coordinate; a0: its counter
  // times RNG_GOLDEN. With kRunMap, run j draws from aj[j] (its first
  // coordinate's a); with kCross too, adding skip_a from its coordinate
  // cross[j] on. With kShortRunMap, a0 is counter_base and every
  // coordinate's counter is map->offset's.
  template <bool kHoisted, int kMap = kNoMap, bool kCross = false>
  static __device__ __forceinline__ void encode(const State& s, const Chunk& c,
                                                uint8_t* __restrict__ out, long long i,
                                                uint32_t a0, const uint32_t* aj = nullptr,
                                                const int* cross = nullptr,
                                                uint32_t skip_a = 0u,
                                                const CounterMap* map = nullptr) {
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
      Vec<uint32_t, kRun / 4> o;
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) {
        uint32_t top[4];   // level in the top byte (header, step 1)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int e = 4 * q + b;
          uint32_t a;
          if constexpr (kMap == kShortRunMap) {
            a = (a0 + map->offset(i + j * kRunStride + e)) * RNG_GOLDEN;
          } else if constexpr (kCross) {
            a = aj[j] + static_cast<uint32_t>(e) * RNG_GOLDEN + (e >= cross[j] ? skip_a : 0u);
          } else if constexpr (kMap == kRunMap) {
            a = aj[j] + static_cast<uint32_t>(e) * RNG_GOLDEN;
          } else {
            a = a0 + static_cast<uint32_t>(j * kRunStride + e) * RNG_GOLDEN;
          }
          top[b] = scaled_ceil<kHoisted>(s, value(c, j, e)) + uniform_complement(s.folded, a);
        }
        const uint32_t lv = prmt(prmt(top[0], top[1], 0x0073u), prmt(top[2], top[3], 0x0073u),
                                 0x5410u);
        o.v[q] = signed_levels(lv, neg_bytes(c, j, q));
      }
      *reinterpret_cast<Vec<uint32_t, kRun / 4>*>(out + i + j * kRunStride) = o;
    }
  }

  // kMasked is not needed: load_edge's zeros encode as 0
  template <bool kMasked, int kMap>
  static __device__ __forceinline__ void store(const State& s, const Chunk& c,
                                               uint8_t* __restrict__ out, long long t,
                                               const Lane& l, long long, uint32_t counter_base,
                                               const CounterMap& map) {
    const long long i = t * kTileCoords + l.off;
    if constexpr (kMap == kShortRunMap) {
      if (s.hoisted) {
        encode<true, kShortRunMap>(s, c, out, i, counter_base, nullptr, nullptr, 0u, &map);
      } else {
        encode<false, kShortRunMap>(s, c, out, i, counter_base, nullptr, nullptr, 0u, &map);
      }
    } else if constexpr (kMap == kRunMap) {
      uint32_t aj[kRuns];
      int cross[kRuns];
      long long q, r;
      map.split(i, q, r);
      bool crosses = false;   // a slice run ends inside one of the thread's runs: rare
#pragma unroll
      for (int j = 0; j < kRuns; ++j) {
        if (j > 0) map.advance(q, r, kRunStride);
        map.group(counter_base, i + j * kRunStride, q, r, aj[j], cross[j]);
        crosses |= cross[j] < kRun;
      }
      const uint32_t skip_a = map.skip * RNG_GOLDEN;
      if (crosses) {
        if (s.hoisted) {
          encode<true, kRunMap, true>(s, c, out, i, 0u, aj, cross, skip_a);
        } else {
          encode<false, kRunMap, true>(s, c, out, i, 0u, aj, cross, skip_a);
        }
      } else if (s.hoisted) {
        encode<true, kRunMap>(s, c, out, i, 0u, aj);
      } else {
        encode<false, kRunMap>(s, c, out, i, 0u, aj);
      }
    } else {
      const uint32_t a0 = (counter_base + static_cast<uint32_t>(i)) * RNG_GOLDEN;
      if (s.hoisted) {
        encode<true>(s, c, out, i, a0);
      } else {
        encode<false>(s, c, out, i, a0);
      }
    }
  }
};

// one worker's 16 levels into the accumulators: byte e of lv[k] is the level
// of coordinate jq + e + 128 k
__device__ __forceinline__ void add_levels(float (&acc)[4][4], const uint32_t (&lv)[4],
                                           float s) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = static_cast<float>(static_cast<int8_t>(lv[k] >> (8 * e)));
      acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(l, s));
    }
}

template <int kB>
__device__ __forceinline__ void load_levels(uint32_t (&lv)[kB][4], float (&s)[kB],
                                            const int8_t* __restrict__ p,
                                            const float* __restrict__ scales, long long stride,
                                            int i0, int m) {
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int i = i0 + b;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      lv[b][k] = i < m ? __ldg(reinterpret_cast<const uint32_t*>(p + i * stride + k * kBlockCols))
                       : 0u;
    s[b] = i < m ? __ldg(scales + i) : 0.0f;
  }
}

template <bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
unpack8_sum_kernel(const int8_t* __restrict__ levels, const float* __restrict__ scales,
                   float* __restrict__ out, int m, long long rows) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * kThreadsPerRow) return;
  const long long r = t / kThreadsPerRow;
  const int jq = static_cast<int>(t % kThreadsPerRow) * 4;
  const long long stride = rows * kLanes;
  const int8_t* p = levels + r * kLanes + jq;
  float* o = out + r * kLanes + jq;
  uint32_t lv[kDecodeBatch][4];
  float s[kDecodeBatch];
  load_levels<kDecodeBatch>(lv, s, p, scales, stride, 0, m);
  float acc[4][4];
  row_acc_init<kAccumulate>(acc, o);
  for (int i0 = 0;;) {
#pragma unroll
    for (int b = 0; b < kDecodeBatch; ++b)
      if (i0 + b < m) add_levels(acc, lv[b], s[b]);
    i0 += kDecodeBatch;
    if (i0 >= m) break;
    load_levels<kDecodeBatch>(lv, s, p, scales, stride, i0, m);
  }
  row_acc_store(acc, o);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g: n contiguous values; out: int8[rows, 512],
// rows = canonical_rows(n). seed: int64[1] holding a uint32 value; param:
// float32[1], the decode scale.
extern "C" int qsgd8_pack8_launch(const void* g, void* out, const void* seed,
                                  const void* param, long long n, long long rows,
                                  unsigned int counter_base, int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_encode<Qsgd8Encoder<float>>(g, out, seed, param, n, rows, counter_base, s);
  if (dtype == 1)
    return launch_encode<Qsgd8Encoder<__nv_bfloat16>>(g, out, seed, param, n, rows,
                                                      counter_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A model rank's slice: as qsgd8_pack8_launch, coordinate i drawing counter
// counter_base + i + (i / run) * skip (encode_tiles.cuh's CounterMap, run >= 1).
extern "C" int qsgd8_pack8_map_launch(const void* g, void* out, const void* seed,
                                      const void* param, long long n, long long rows,
                                      unsigned int counter_base, long long run,
                                      unsigned int skip, int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CounterMap map{run, skip};
  if (dtype == 0)
    return launch_encode<Qsgd8Encoder<float>, true>(g, out, seed, param, n, rows,
                                                    counter_base, s, map);
  if (dtype == 1)
    return launch_encode<Qsgd8Encoder<__nv_bfloat16>, true>(g, out, seed, param, n, rows,
                                                            counter_base, s, map);
  return static_cast<int>(cudaErrorInvalidValue);
}

// levels: int8[m, rows, 512]; scales: float32[m]; out: float32[rows, 512];
// accumulate: add into out instead of writing it.
extern "C" int unpack8_sum_into_launch(const void* levels, const void* scales, void* out, int m,
                                       long long rows, int accumulate, void* stream) {
  if (rows <= 0) return 0;
  if (!aligned(levels, 4) || !aligned(out, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* lv = static_cast<const int8_t*>(levels);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (accumulate)
    unpack8_sum_kernel<true><<<pack_grid(rows), kThreads, 0, st>>>(lv, sc, o, m, rows);
  else
    unpack8_sum_kernel<false><<<pack_grid(rows), kThreads, 0, st>>>(lv, sc, o, m, rows);
  return static_cast<int>(cudaGetLastError());
}
