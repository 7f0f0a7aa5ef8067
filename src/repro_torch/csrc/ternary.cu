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
// writes one int8, 5 B/coord in f32, against 4 (sign), 23 (sparsign,
// stochastic_ternary) or 39 (noisy_sign: two hashes, log, cos, sqrt)
// operations per coordinate that the rule itself needs (chip_smoke.py's
// OPS_PER_COORD). CUDA's full-precision logf and cosf execute many more
// instructions than that, so the noisy rule's kernel may not reach the bound.
//
// Design: as csrc/sparsign.cu. One flat pass over the contiguous (rows, n)
// tensor with the tail masked; no padded (rows, 512) copy, because the counter
// is the column index (the TPU kernel's n_valid mask is this tail mask). A
// thread owns 16 bytes of gradient (4 f32 or 8 bf16) loaded with one vector
// load. The leading dimension is the worker: row r draws from seed[r] and
// param[r] (or one param for all rows), so one launch ternarizes every worker of
// a round. The row's seed hashes (seed, fold(seed, 1), fold(seed, 2), as many
// as the rule draws) are computed here, once per row a thread touches, never on
// the host. The rule is a template parameter, one instantiation per rule, as
// the TPU kernel specialises at compile time. Every float operation on the
// rule's path is an _rn intrinsic, so no multiply-add contraction moves a bit
// away from the plain version; logf, cosf and sqrtf are CUDA's full-precision
// library functions (the build uses no --use_fast_math), the ones the plain
// version's torch.log, torch.cos and torch.sqrt call on the card.
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
#include "pack2_encode.cuh"

namespace {

using namespace repro;

// What a row contributes: its rule, built from its seed and param.
template <int R>
__device__ __forceinline__ RuleFor<R> load_row(const long long* __restrict__ seeds,
                                               const float* __restrict__ param,
                                               int param_per_row, long long r) {
  return RuleFor<R>::make(static_cast<uint32_t>(seeds[r]), param[param_per_row ? r : 0]);
}

template <typename T, int N, int R>
__global__ void __launch_bounds__(kThreads)
ternary_kernel(const T* __restrict__ g, int8_t* __restrict__ out,
               const long long* __restrict__ seeds, const float* __restrict__ param,
               int param_per_row, long long rows, long long n, uint32_t counter_base,
               bool vec_ok) {
  const long long total = rows * n;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= total) return;
  const Vec<T, N> gv = load_vec<T, N>(g, i, total, vec_ok);
  long long r = i / n;
  long long col = i - r * n;
  RuleFor<R> row = load_row<R>(seeds, param, param_per_row, r);
  Vec<int8_t, N> o;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (col == n) {  // this thread's elements run into the next worker's row
      ++r;
      col = 0;
      if (r < rows) row = load_row<R>(seeds, param, param_per_row, r);
    }
    o.v[k] = rule_symbol(row, to_f32<T>(gv.v[k]),
                         (counter_base + static_cast<uint32_t>(col)) * RNG_GOLDEN);
    ++col;
  }
  store_vec<int8_t, N>(out, i, total, vec_ok, o);
}

template <typename T, int N, int R>
int launch(const void* g, void* out, const void* seeds, const void* param, int param_per_row,
           long long rows, long long n, unsigned int counter_base, cudaStream_t stream) {
  const long long total = rows * n;
  const bool vec_ok = aligned(g, sizeof(T) * N) && aligned(out, N);
  ternary_kernel<T, N, R><<<grid_for(total, N), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<int8_t*>(out),
      static_cast<const long long*>(seeds), static_cast<const float*>(param), param_per_row,
      rows, n, counter_base, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_rule(int rule, const void* g, void* out, const void* seeds, const void* param,
                int param_per_row, long long rows, long long n, unsigned int counter_base,
                cudaStream_t s) {
  switch (rule) {
    case SPARSIGN:
      return launch<T, N, SPARSIGN>(g, out, seeds, param, param_per_row, rows, n, counter_base, s);
    case SIGN:
      return launch<T, N, SIGN>(g, out, seeds, param, param_per_row, rows, n, counter_base, s);
    case NOISY_SIGN:
      return launch<T, N, NOISY_SIGN>(g, out, seeds, param, param_per_row, rows, n,
                                      counter_base, s);
    case STOCHASTIC_TERNARY:
      return launch<T, N, STOCHASTIC_TERNARY>(g, out, seeds, param, param_per_row, rows, n,
                                              counter_base, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
    return launch_rule<float, 4>(rule, g, out, seeds, param, param_per_row, rows, n,
                                 counter_base, s);
  if (dtype == 1)
    return launch_rule<__nv_bfloat16, 8>(rule, g, out, seeds, param, param_per_row, rows, n,
                                         counter_base, s);
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
