// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is a flat elementwise pass over contiguous tensors:
// thread t owns elements [t*N, t*N + N). When every pointer is aligned to the
// vector width the thread moves them with one vector load/store (16 bytes for
// the widest operand), otherwise, and on the ragged tail, element by element.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace repro {

// murmur3 fmix32 and the counter-hash stream of repro.core.prng, bit for bit.
constexpr uint32_t RNG_C1 = 0x85EBCA6Bu;
constexpr uint32_t RNG_C2 = 0xC2B2AE35u;
constexpr uint32_t RNG_GOLDEN = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= RNG_C1;
  x ^= x >> 13;
  x *= RNG_C2;
  x ^= x >> 16;
  return x;
}

// uniform in [0, 1) from the top 24 bits: exact in float32.
// seed_hash = mix32(seed + RNG_GOLDEN), hoisted by the caller per stream.
__device__ __forceinline__ float uniform01(uint32_t seed_hash, uint32_t counter) {
  uint32_t bits = mix32((counter * RNG_GOLDEN) ^ seed_hash);
  return __uint2float_rn(bits >> 8) * (1.0f / 16777216.0f);
}

// repro.core.prng.fold_seed with one salt
__device__ __forceinline__ uint32_t fold_seed(uint32_t seed, uint32_t salt) {
  return mix32(seed ^ (salt * RNG_GOLDEN));
}

// The fused encoders' form of uniform01 (pack2_encode.cuh), equal to it bit
// for bit: uniform01(seed_hash, c) == uniform01_folded(fold_hash(seed_hash),
// c * RNG_GOLDEN). mix32's first xor-shift distributes over the seed's xor,
// (a ^ s) ^ ((a ^ s) >> 16) == a ^ (a >> 16) ^ (s ^ (s >> 16)), so the seed's
// half is taken once a stream and the step is one three-way xor. The last
// step keeps the top 24 bits where they are ((x ^ x >> 16) & ~0xFF, one
// three-input op): 256 k converts exactly, and times 2^-32 it is k * 2^-24,
// uniform01's float.
__device__ __forceinline__ uint32_t fold_hash(uint32_t seed_hash) {
  return seed_hash ^ (seed_hash >> 16);
}

// mix32 after its first xor-shift, on the folded form, but for the last
// xor-shift: the hash is x ^ (x >> 16) of what this returns.
__device__ __forceinline__ uint32_t hash_folded(uint32_t folded, uint32_t a) {
  uint32_t x = a ^ (a >> 16) ^ folded;
  x *= RNG_C1;
  x ^= x >> 13;
  return x * RNG_C2;
}

__device__ __forceinline__ float uniform01_folded(uint32_t folded, uint32_t a) {
  const uint32_t x = hash_folded(folded, a);
  return __fmul_rn(__uint2float_rn((x ^ (x >> 16)) & 0xFFFFFF00u), 1.0f / 4294967296.0f);
}

// 2^24 - 1 - k, for uniform01_folded(folded, a) = k * 2^-24: the hash's top
// 24 bits, complemented (the complement is taken before the shift, in the
// last xor's three-input op).
__device__ __forceinline__ uint32_t uniform_complement(uint32_t folded, uint32_t a) {
  const uint32_t x = hash_folded(folded, a);
  return ~(x ^ (x >> 16)) >> 8;
}

// jnp.sign: +1 / -1 for nonzero, and x itself for +-0.0 and NaN
// (torch.sign and copysign would turn -0.0 into +0.0 and NaN into 0).
__device__ __forceinline__ float jnp_sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Load/store N consecutive elements starting at element i: one vector access
// when the caller proved alignment and i + N <= n, else element-wise with
// the tail masked (missing elements read as zero and are never stored).
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p, long long i, long long n,
                                              bool vec_ok) {
  Vec<T, N> r;
  if (vec_ok && i + N <= n) {
    r = *reinterpret_cast<const Vec<T, N>*>(p + i);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) r.v[k] = (i + k < n) ? p[i + k] : T{};
  }
  return r;
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, long long i, long long n, bool vec_ok,
                                          const Vec<T, N>& r) {
  if (vec_ok && i + N <= n) {
    *reinterpret_cast<Vec<T, N>*>(p + i) = r;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (i + k < n) p[i + k] = r.v[k];
  }
}

constexpr int kThreads = 256;
constexpr int kLanes = 512;        // coordinates of a canonical row

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// byte i: 0xFF if the sign bit of 32-bit word i is set, else 0 (prmt's
// selector nibble 8 | b replicates the sign of byte b)
__device__ __forceinline__ uint32_t sign_bytes(uint32_t w0, uint32_t w1, uint32_t w2,
                                               uint32_t w3) {
  return prmt(prmt(w0, w1, 0x00FBu), prmt(w2, w3, 0xFB00u), 0x7610u);
}

inline unsigned int grid_for(long long n, int per_thread) {
  long long threads = (n + per_thread - 1) / per_thread;
  long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace repro
