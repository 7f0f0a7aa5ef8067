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
// The pack variant (ternary_pack2bit_kernel, ternary_pack2bit_launch) takes one message:
// the same rule code, with pack2bit.cuh's wire layout instead of the flat
// pass. A thread owns 4 bytes of a packed row and draws the 16 symbols they
// pack; coordinates past n (the TPU kernel's n_valid) and the canonical pad
// rows pack as 0, which matters for noisy_sign, whose rule gives nonzero
// symbols at zero input. Bound on an H100: bytes, 2.25 B/coord in bf16 (the
// gradient once, a quarter byte of wire), against the same rule operations
// plus 3 a coordinate for the packing.
#include "pack2bit.cuh"

namespace {

using namespace repro;

enum Rule : int { SPARSIGN = 0, SIGN = 1, NOISY_SIGN = 2, STOCHASTIC_TERNARY = 3 };

constexpr float kTwoPi = 6.28318530717958647692f;  // float32(2 * pi), as XLA rounds it
constexpr float kEps = 1e-12f;

// repro.core.prng.fold_seed with one salt
__device__ __forceinline__ uint32_t fold_seed(uint32_t seed, uint32_t salt) {
  return mix32(seed ^ (salt * RNG_GOLDEN));
}

// The int8 symbol of jnp.sign(x).astype(int8): +-0.0 and NaN give 0.
__device__ __forceinline__ int8_t symbol(float x) {
  return x > 0.0f ? int8_t(1) : (x < 0.0f ? int8_t(-1) : int8_t(0));
}

// What a row contributes: the hashed seeds its rule draws from, and its param.
struct Row {
  uint32_t h0, h1, h2;
  float param;
};

template <int R>
__device__ __forceinline__ Row load_row(const long long* __restrict__ seeds,
                                        const float* __restrict__ param, int param_per_row,
                                        long long r) {
  Row row{0u, 0u, 0u, 0.0f};
  const uint32_t seed = static_cast<uint32_t>(seeds[r]);
  if (R == SPARSIGN || R == STOCHASTIC_TERNARY) row.h0 = mix32(seed + RNG_GOLDEN);
  if (R == NOISY_SIGN) {
    row.h1 = mix32(fold_seed(seed, 1u) + RNG_GOLDEN);
    row.h2 = mix32(fold_seed(seed, 2u) + RNG_GOLDEN);
  }
  if (R != SIGN) {
    float p = param[param_per_row ? r : 0];
    // jnp.maximum(s, 1e-12): a NaN normalizer stays NaN (fmaxf would drop it)
    if (R == STOCHASTIC_TERNARY) p = (p != p) ? p : fmaxf(p, kEps);
    row.param = p;
  }
  return row;
}

template <int R>
__device__ __forceinline__ int8_t ternarize(float x, const Row& row, uint32_t counter) {
  if constexpr (R == SIGN) {
    return symbol(x);
  } else if constexpr (R == NOISY_SIGN) {
    const float u1 = fmaxf(uniform01(row.h1, counter), kEps);
    const float u2 = uniform01(row.h2, counter);
    const float noise = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
    return symbol(__fadd_rn(x, __fmul_rn(row.param, noise)));
  } else {
    // clip(., 0, 1) with fmaxf/fminf maps a NaN probability to 0, where the
    // plain version keeps NaN: both then fail u < p, so the symbol is 0 either way
    const float r = (R == SPARSIGN) ? __fmul_rn(fabsf(x), row.param)
                                    : __fdiv_rn(fabsf(x), row.param);
    const float p = fminf(fmaxf(r, 0.0f), 1.0f);
    return uniform01(row.h0, counter) < p ? symbol(x) : int8_t(0);
  }
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
  Row row = load_row<R>(seeds, param, param_per_row, r);
  Vec<int8_t, N> o;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (col == n) {  // this thread's elements run into the next worker's row
      ++r;
      col = 0;
      if (r < rows) row = load_row<R>(seeds, param, param_per_row, r);
    }
    o.v[k] = ternarize<R>(to_f32<T>(gv.v[k]), row, counter_base + static_cast<uint32_t>(col));
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

template <int R>
struct RuleSym {
  Row row;
  __device__ __forceinline__ int8_t operator()(float x, uint32_t counter) const {
    return ternarize<R>(x, row, counter);
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
ternary_pack2bit_kernel(const T* __restrict__ g, uint8_t* __restrict__ out,
                        const long long* __restrict__ seed, const float* __restrict__ param,
                        long long n, long long rows, uint32_t counter_base, bool vec_ok) {
  const RuleSym<R> sym{load_row<R>(seed, param, 0, 0)};
  pack_thread<T>(g, out, n, rows, counter_base, vec_ok, sym);
}

template <typename T, int R>
int launch_pack(const void* g, void* out, const void* seed, const void* param, long long n,
                long long rows, unsigned int counter_base, cudaStream_t stream) {
  if (!aligned(out, 4)) return static_cast<int>(cudaErrorMisalignedAddress);
  const bool vec_ok = aligned(g, sizeof(T) * 4);
  ternary_pack2bit_kernel<T, R><<<pack_grid(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<uint8_t*>(out),
      static_cast<const long long*>(seed), static_cast<const float*>(param), n, rows,
      counter_base, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pack_rule(int rule, const void* g, void* out, const void* seed, const void* param,
                     long long n, long long rows, unsigned int counter_base, cudaStream_t s) {
  switch (rule) {
    case SPARSIGN:
      return launch_pack<T, SPARSIGN>(g, out, seed, param, n, rows, counter_base, s);
    case SIGN:
      return launch_pack<T, SIGN>(g, out, seed, param, n, rows, counter_base, s);
    case NOISY_SIGN:
      return launch_pack<T, NOISY_SIGN>(g, out, seed, param, n, rows, counter_base, s);
    case STOCHASTIC_TERNARY:
      return launch_pack<T, STOCHASTIC_TERNARY>(g, out, seed, param, n, rows, counter_base, s);
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
