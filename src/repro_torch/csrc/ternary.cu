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
// A model rank's slice of a leaf (ternary_map_launch) draws the counters of
// the whole leaf's coordinates, as csrc/sparsign.cu's map does: slice column j
// takes counter_base + j + (j / run) * skip. The division is taken once a
// thread, its later columns step the quotient as they cross a run, and a
// thread whose columns lie in one run and one row takes the contiguous loop
// from its own base counter. kMap false is the contiguous kernel, code for
// code.
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

template <typename T, int N, int R, bool kMap>
__global__ void __launch_bounds__(kThreads)
ternary_kernel(const T* __restrict__ g, int8_t* __restrict__ out,
               const long long* __restrict__ seeds, const float* __restrict__ param,
               int param_per_row, long long rows, long long n, uint32_t counter_base,
               bool vec_ok, long long run, uint32_t skip) {
  const long long total = rows * n;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= total) return;
  const Vec<T, N> gv = load_vec<T, N>(g, i, total, vec_ok);
  long long r = i / n;
  long long col = i - r * n;
  RuleFor<R> row = load_row<R>(seeds, param, param_per_row, r);
  long long q = 0, in_run = 0;  // kMap: col = q * run + in_run
  Vec<int8_t, N> o;
  if constexpr (kMap) {
    q = col / run;
    in_run = col - q * run;
    if (col + N <= n && in_run + N <= run) {  // the thread's columns in one run: the rule
      const uint32_t c0 = counter_base + static_cast<uint32_t>(col) +
                          static_cast<uint32_t>(q) * skip;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        o.v[k] = rule_symbol(row, to_f32<T>(gv.v[k]),
                             (c0 + static_cast<uint32_t>(k)) * RNG_GOLDEN);
      }
      store_vec<int8_t, N>(out, i, total, vec_ok, o);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (col == n) {  // this thread's elements run into the next worker's row
      ++r;
      col = 0;
      if constexpr (kMap) q = in_run = 0;
      if (r < rows) row = load_row<R>(seeds, param, param_per_row, r);
    }
    uint32_t counter = counter_base + static_cast<uint32_t>(col);
    if constexpr (kMap) counter += static_cast<uint32_t>(q) * skip;
    o.v[k] = rule_symbol(row, to_f32<T>(gv.v[k]), counter * RNG_GOLDEN);
    ++col;
    if constexpr (kMap) {
      if (++in_run == run) {
        in_run = 0;
        ++q;
      }
    }
  }
  store_vec<int8_t, N>(out, i, total, vec_ok, o);
}

template <typename T, int N, int R, bool kMap>
int launch(const void* g, void* out, const void* seeds, const void* param, int param_per_row,
           long long rows, long long n, unsigned int counter_base, long long run,
           unsigned int skip, cudaStream_t stream) {
  const long long total = rows * n;
  const bool vec_ok = aligned(g, sizeof(T) * N) && aligned(out, N);
  ternary_kernel<T, N, R, kMap><<<grid_for(total, N), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<int8_t*>(out),
      static_cast<const long long*>(seeds), static_cast<const float*>(param), param_per_row,
      rows, n, counter_base, vec_ok, run, skip);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N, bool kMap>
int launch_rule(int rule, const void* g, void* out, const void* seeds, const void* param,
                int param_per_row, long long rows, long long n, unsigned int counter_base,
                long long run, unsigned int skip, cudaStream_t s) {
  switch (rule) {
    case SPARSIGN:
      return launch<T, N, SPARSIGN, kMap>(g, out, seeds, param, param_per_row, rows, n,
                                          counter_base, run, skip, s);
    case SIGN:
      return launch<T, N, SIGN, kMap>(g, out, seeds, param, param_per_row, rows, n,
                                      counter_base, run, skip, s);
    case NOISY_SIGN:
      return launch<T, N, NOISY_SIGN, kMap>(g, out, seeds, param, param_per_row, rows, n,
                                            counter_base, run, skip, s);
    case STOCHASTIC_TERNARY:
      return launch<T, N, STOCHASTIC_TERNARY, kMap>(g, out, seeds, param, param_per_row, rows,
                                                    n, counter_base, run, skip, s);
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
    return launch_rule<float, 4, false>(rule, g, out, seeds, param, param_per_row, rows, n,
                                        counter_base, n, 0u, s);
  if (dtype == 1)
    return launch_rule<__nv_bfloat16, 8, false>(rule, g, out, seeds, param, param_per_row,
                                                rows, n, counter_base, n, 0u, s);
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
  if (dtype == 0)
    return launch_rule<float, 4, true>(rule, g, out, seeds, param, param_per_row, rows, n,
                                       counter_base, run, skip, s);
  if (dtype == 1)
    return launch_rule<__nv_bfloat16, 8, true>(rule, g, out, seeds, param, param_per_row,
                                               rows, n, counter_base, run, skip, s);
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
