// ternary: the generic stochastic ternarizer of the Table 1-2 baselines on Hopper,
// and its fused variant straight to the 2-bit packed vote wire.
//
// Replaces: src/repro/kernels/ternary/kernel.py:79 (ternary_compress_2d) and
// src/repro/kernels/ternary/kernel.py:99 (ternary_pack2bit_2d), Pallas TPU.
//
//   out[r, j] = RULE(g[r, j], u_s(seed[r], counter_base + j), param[r])   in {-1, 0, +1}
//
// with the rule one of (repro_torch/kernels/ternary/rules.py, in that order):
//   0 sparsign            sign(g) if u_0 < clip(|g| * B, 0, 1) else 0
//   1 sign                sign(g)                                  (no draw, param unused)
//   2 noisy_sign          sign(g + sigma * sqrt(-2 log max(u_1, 1e-12)) * cos(2 pi u_2))
//   3 stochastic_ternary  sign(g) if u_0 < clip(|g| / max(s, 1e-12), 0, 1) else 0
// where u_k is the counter-hash uniform of repro.core.prng under the row's seed
// folded by k (k = 0: the seed itself). A NaN symbol is 0.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32): every rule is bound by
// bytes: each coordinate reads its gradient once (4 B f32, 2 B bf16) and
// writes one int8, 3 B/coord in bf16 and 5 in f32, against 4 (sign), 23
// (sparsign, stochastic_ternary) or 39 (noisy_sign: two hashes, log, cos,
// sqrt) operations per coordinate that the rule itself needs (chip_smoke.py's
// OPS_PER_COORD). The issue rate is what the drawing rules meet first: at
// w_down in bf16 (PERF.md, PR 27) sparsign and stochastic_ternary ran at
// 0.7404 and 0.7506 ms against the 0.6338 ms bound (1.2019 and 1.4054 in
// the flat kernel this replaced), noisy_sign, 54 SASS instructions a
// coordinate on its hot path, at 1.4603 (2.7607), and sign at 0.7133
// (0.6931).
//
// Design: int8_encode.cuh's encoder, one instantiation per rule (the rule
// a template parameter, as the TPU kernel specialises at compile time), on
// encode_tiles.cuh's frame for many rows; csrc/sparsign.cu launches its
// sparsign instantiation. The leading dimension is the worker: row r draws
// from seed[r] and param[r] (or one param for all rows), so one launch
// ternarizes every worker of a round. The row's seed hashes (seed, fold(seed,
// 1), fold(seed, 2), as many as the rule draws) are computed on the card,
// once per row a block meets, never on the host. Every float operation on
// the rule's exact path is an _rn intrinsic, or CUDA's full-precision logf,
// cosf and sqrtf (the build uses no --use_fast_math), the ones the plain
// version's torch.log, torch.cos and torch.sqrt call on the card;
// stochastic_ternary's and noisy_sign's fast paths (pack2_encode.cuh) decide
// a coordinate only where a proven bound makes them agree with it. A model
// rank's slice of a leaf (ternary_map_launch) draws the whole leaf's
// counters, as csrc/sparsign.cu's map does.
//
// The pack variant (ternary_pack2bit_launch) takes one message: the rule's
// instantiation of pack2_encode.cuh's encoder, the template that
// sparsign_pack2bit.cu launches for sparsign; coordinates past n (the TPU
// kernel's n_valid) and the canonical pad rows pack as 0, which matters for
// noisy_sign, whose rule gives nonzero symbols at zero input. Bound on an
// H100: bytes, 2.25 B/coord in bf16 (the gradient once, a quarter byte of
// wire), against the same rule operations plus 3 a coordinate for the
// packing. The rules themselves (pack2_encode.cuh) are shared by both
// variants.
#include "int8_encode.cuh"

namespace {

using namespace repro;

template <typename T, bool kMap = false>
int launch_rule(int rule, const void* g, void* out, const void* seeds, const void* param,
                int param_per_row, long long rows, long long n, unsigned int counter_base,
                cudaStream_t s, CounterMap map = {1, 0u}) {
  switch (rule) {
    case SPARSIGN:
      return launch_encode_rows<Int8Encoder<T, SparsignRule>, kMap>(
          g, out, seeds, param, param_per_row, rows, n, counter_base, s, map);
    case SIGN:
      return launch_encode_rows<Int8Encoder<T, SignRule>, kMap>(
          g, out, seeds, param, param_per_row, rows, n, counter_base, s, map);
    case NOISY_SIGN:
      return launch_encode_rows<Int8Encoder<T, NoisySignRule>, kMap>(
          g, out, seeds, param, param_per_row, rows, n, counter_base, s, map);
    case STOCHASTIC_TERNARY:
      return launch_encode_rows<Int8Encoder<T, StochasticTernaryRule>, kMap>(
          g, out, seeds, param, param_per_row, rows, n, counter_base, s, map);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Ahat, A, Chat and C of pack2_encode.cuh's noise at k 2^-24 (u1 clamped at
// 1e-12 as the rule clamps it), k < 2^24: out[v * 2^24 + k], v in that order;
// out[4 * 2^24]: kNoiseDelta
__global__ void noise_table_kernel(float* __restrict__ out) {
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = size_t{1} << 24;
  if (k == 0) out[4 * n] = kNoiseDelta;
  const float u = __uint2float_rn(k) * (1.0f / 16777216.0f);
  const float u1 = fmaxf(u, kEps);
  out[k] = noise_radius_approx(u1);
  out[n + k] = noise_radius(u1);
  out[2 * n + k] = noise_angle_approx(u);
  out[3 * n + k] = noise_angle(u);
}

__global__ void fallbacks_kernel(unsigned long long* __restrict__ out, int reset) {
  *out = rule_fallbacks;
  if (reset) rule_fallbacks = 0;
}

template <typename T, bool kMap = false>
int launch_pack_rule(int rule, const void* g, void* out, const void* seed, const void* param,
                     long long n, long long rows, unsigned int counter_base, cudaStream_t s,
                     CounterMap map = {1, 0u}) {
  switch (rule) {
    case SPARSIGN:
      return launch_encode<Pack2Encoder<T, SparsignRule>, kMap>(g, out, seed, param, n, rows,
                                                                counter_base, s, map);
    case SIGN:
      return launch_encode<Pack2Encoder<T, SignRule>, kMap>(g, out, seed, param, n, rows,
                                                            counter_base, s, map);
    case NOISY_SIGN:
      return launch_encode<Pack2Encoder<T, NoisySignRule>, kMap>(g, out, seed, param, n, rows,
                                                                 counter_base, s, map);
    case STOCHASTIC_TERNARY:
      return launch_encode<Pack2Encoder<T, StochasticTernaryRule>, kMap>(
          g, out, seed, param, n, rows, counter_base, s, map);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rule: the ids above. seeds: int64[rows]
// holding uint32 values. param: float32[rows] when param_per_row, else float32[1].
extern "C" int ternary_launch(const void* g, void* out, const void* seeds, const void* param,
                              int param_per_row, long long rows, long long n,
                              unsigned int counter_base, int dtype, int rule, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rule<float>(rule, g, out, seeds, param, param_per_row, rows, n, counter_base,
                              s);
  if (dtype == 1)
    return launch_rule<__nv_bfloat16>(rule, g, out, seeds, param, param_per_row, rows, n,
                                      counter_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A model rank's slice: as ternary_launch, each row's column j drawing counter
// counter_base + j + (j / run) * skip (run >= 1; counter_base holds the slice's
// offset in the leaf's run, skip the leaf's run less the slice's).
extern "C" int ternary_map_launch(const void* g, void* out, const void* seeds,
                                  const void* param, int param_per_row, long long rows,
                                  long long n, unsigned int counter_base, long long run,
                                  unsigned int skip, int dtype, int rule, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (run <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CounterMap map{run, skip};
  if (dtype == 0)
    return launch_rule<float, true>(rule, g, out, seeds, param, param_per_row, rows, n,
                                    counter_base, s, map);
  if (dtype == 1)
    return launch_rule<__nv_bfloat16, true>(rule, g, out, seeds, param, param_per_row, rows, n,
                                            counter_base, s, map);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused pack variant, one message. g: n contiguous values; out: rows * 128
// bytes, rows = canonical_rows(n). seed: int64[1] holding a uint32 value;
// param: float32[1].
extern "C" int ternary_pack2bit_launch(const void* g, void* out, const void* seed,
                                       const void* param, long long n, long long rows,
                                       unsigned int counter_base, int dtype, int rule,
                                       void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pack_rule<float>(rule, g, out, seed, param, n, rows, counter_base, s);
  if (dtype == 1)
    return launch_pack_rule<__nv_bfloat16>(rule, g, out, seed, param, n, rows, counter_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A model rank's slice: as ternary_pack2bit_launch, coordinate i drawing
// counter counter_base + i + (i / run) * skip (encode_tiles.cuh's CounterMap,
// run >= 1).
extern "C" int ternary_pack2bit_map_launch(const void* g, void* out, const void* seed,
                                           const void* param, long long n, long long rows,
                                           unsigned int counter_base, long long run,
                                           unsigned int skip, int dtype, int rule,
                                           void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CounterMap map{run, skip};
  if (dtype == 0)
    return launch_pack_rule<float, true>(rule, g, out, seed, param, n, rows, counter_base, s,
                                         map);
  if (dtype == 1)
    return launch_pack_rule<__nv_bfloat16, true>(rule, g, out, seed, param, n, rows,
                                                 counter_base, s, map);
  return static_cast<int>(cudaErrorInvalidValue);
}

// pack2_encode.cuh's noise table (noise_table_kernel): out float32[4 * 2^24 + 1].
extern "C" int noise_table_launch(void* out, void* stream) {
  noise_table_kernel<<<(1u << 24) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The fallback coordinates of this library's rules (rows 4 and 5) since the
// last reset, into out (uint64[1] on the card); reset: zero the count after.
extern "C" int ternary_fallbacks_launch(void* out, int reset, void* stream) {
  fallbacks_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out), reset);
  return static_cast<int>(cudaGetLastError());
}
