// qsgd8_pack8 and unpack8_sum: the 8-bit QSGD (pack8) wire on Hopper.
//
// Replaces: src/repro/kernels/pack8/kernel.py:91 (qsgd8_pack8_2d) and
// src/repro/kernels/pack8/kernel.py:111 (unpack8_sum_2d), Pallas TPU.
//
//   qsgd8_pack8: r     = |g[c]| / max(param, 1e-20)           (correctly rounded)
//                level = min(floor(r) + [u(seed, counter_base + c) < r - floor(r)], 127)
//                out   = int8(sign(g[c]) * level)  over the canonical (rows, 512)
//                        view, rows = canonical_rows(n); coordinates past n are 0
//   unpack8_sum: out[c] = (((0 + l_0[c] s_0) + l_1[c] s_1) + ...) + l_{M-1}[c] s_{M-1}
//
// with u the counter-hash uniform of repro.core.prng, regenerated in
// registers; max and min propagate NaN as jnp's do, and a NaN level (a NaN
// gradient or scale) quantizes to 0, as XLA's float -> int8 convert gives it.
// The division is __fdiv_rn (never an approximate divide); the decode's
// products and sums are __fmul_rn and __fadd_rn, each rounded on its own, so
// no multiply-add contraction moves the sum off the decoded-psum wire, which
// materializes (rounds) every product before its worker-order sum. The sum
// starts at +0.0, as the plain version and the TPU kernel's accumulator do.
//
// Bound on an H100 (3.35 TB/s): bytes. qsgd8_pack8 reads the gradient once
// and writes a byte: 3 B/coord in bf16, 5 in f32; its 27 operations a
// coordinate (chip_smoke.py's QSGD8_OPS_PER_COORD: the uniform's 13, the
// division, floor, compare, clip, sign) take under half that time at the
// float32 rate. unpack8_sum reads one byte per worker and writes 4:
// (M + 4) B/coord; 3 operations per worker (convert, multiply, add).
//
// Design: flat elementwise passes, 16 coordinates a thread. qsgd8_pack8
// loads them as four 4-wide vectors (16 B in f32, 8 B in bf16) and stores 16
// int8 levels as one 16-byte vector. unpack8_sum streams the M messages in
// worker order, one 16-byte load of each, with 16 float accumulators in
// registers, and stores four 16-byte vectors: no scratch that grows with M.
// Offsets are 64-bit: M x rows x 512 passes 2^31 at the trainer's shapes.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kPer = 16;            // coordinates a thread
constexpr float kLevels = 127.0f;   // QSGD8_LEVELS

// jnp.maximum / jnp.minimum: a NaN operand gives NaN (fmaxf and fminf would
// return the other operand)
__device__ __forceinline__ float nan_max(float a, float b) { return isnan(a) ? a : fmaxf(a, b); }
__device__ __forceinline__ float nan_min(float a, float b) { return isnan(a) ? a : fminf(a, b); }

__device__ __forceinline__ int8_t qsgd8_level(float x, float param, uint32_t seed_hash,
                                              uint32_t counter) {
  const float r = __fdiv_rn(fabsf(x), nan_max(param, 1e-20f));
  const float l = floorf(r);
  const float u = uniform01(seed_hash, counter);
  const float up = (u < __fsub_rn(r, l)) ? 1.0f : 0.0f;
  const float level = nan_min(__fadd_rn(l, up), kLevels);
  const float s = __fmul_rn(jnp_sign(x), level);
  if (isnan(s)) return 0;
  return static_cast<int8_t>(static_cast<int>(s));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qsgd8_pack8_kernel(const T* __restrict__ g, int8_t* __restrict__ out,
                   const long long* __restrict__ seed, const float* __restrict__ param,
                   long long n, long long total, uint32_t counter_base, bool vec_ok) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i0 = t * kPer;
  if (i0 >= total) return;
  const uint32_t seed_hash = mix32(static_cast<uint32_t>(seed[0]) + RNG_GOLDEN);
  const float prm = param[0];
  Vec<int8_t, kPer> o;
#pragma unroll
  for (int k = 0; k < kPer / 4; ++k) {
    const long long i = i0 + 4 * k;
    const Vec<T, 4> gv = load_vec<T, 4>(g, i, n, vec_ok);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long pos = i + e;
      o.v[4 * k + e] = pos < n ? qsgd8_level(to_f32<T>(gv.v[e]), prm, seed_hash,
                                             counter_base + static_cast<uint32_t>(pos))
                               : int8_t(0);
    }
  }
  *reinterpret_cast<Vec<int8_t, kPer>*>(out + i0) = o;
}

__global__ void __launch_bounds__(kThreads)
unpack8_sum_kernel(const int8_t* __restrict__ levels, const float* __restrict__ scales,
                   float* __restrict__ out, int m, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i0 = t * kPer;
  if (i0 >= total) return;
  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.0f;
  for (int w = 0; w < m; ++w) {
    const Vec<int8_t, kPer> lv =
        *reinterpret_cast<const Vec<int8_t, kPer>*>(levels + w * total + i0);
    const float s = __ldg(scales + w);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      acc[e] = __fadd_rn(acc[e], __fmul_rn(static_cast<float>(lv.v[e]), s));
  }
#pragma unroll
  for (int k = 0; k < kPer / 4; ++k) {
    Vec<float, 4> v;
#pragma unroll
    for (int e = 0; e < 4; ++e) v.v[e] = acc[4 * k + e];
    *reinterpret_cast<Vec<float, 4>*>(out + i0 + 4 * k) = v;
  }
}

template <typename T>
int launch_pack(const void* g, void* out, const void* seed, const void* param, long long n,
                long long rows, unsigned int counter_base, cudaStream_t stream) {
  if (!aligned(out, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long total = rows * 512;
  const bool vec_ok = aligned(g, sizeof(T) * 4);
  qsgd8_pack8_kernel<T><<<grid_for(total, kPer), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<int8_t*>(out),
      static_cast<const long long*>(seed), static_cast<const float*>(param), n, total,
      counter_base, vec_ok);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 0) return launch_pack<float>(g, out, seed, param, n, rows, counter_base, s);
  if (dtype == 1)
    return launch_pack<__nv_bfloat16>(g, out, seed, param, n, rows, counter_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// levels: int8[m, rows, 512]; scales: float32[m]; out: float32[rows, 512].
extern "C" int unpack8_sum_launch(const void* levels, const void* scales, void* out, int m,
                                  long long rows, void* stream) {
  if (rows <= 0) return 0;
  if (!aligned(levels, 16) || !aligned(out, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long total = rows * 512;
  unpack8_sum_kernel<<<grid_for(total, kPer), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(levels), static_cast<const float*>(scales),
      static_cast<float*>(out), m, total);
  return static_cast<int>(cudaGetLastError());
}
