// sparsign: magnitude-aware stochastic ternarization (Def. 1) on Hopper.
//
// Replaces: src/repro/kernels/sparsign/kernel.py:48 (sparsign_2d, Pallas TPU).
//
//   out[r, j] = sign(g[r, j])  if  u(seed[r], counter_base + j) < clip(|g[r, j]| * B[r], 0, 1)
//             = 0              otherwise
//
// with u the counter-hash uniform of repro.core.prng, regenerated in registers.
//
// Bound on an H100 (3.35 TB/s): bytes. Each coordinate reads its gradient once
// (4 B f32, 2 B bf16) and writes one int8: 5 B/coord in f32. The hash costs
// about 15 integer operations per coordinate, far below the integer rate.
//
// Design: one flat pass over the contiguous (rows, n) tensor with the tail
// masked; no padded (rows, 512) copy is made, because the counter is the
// column index and the stream does not depend on the layout. A thread owns
// 16 bytes of gradient (4 f32 or 8 bf16), loaded with one vector load, and
// stores its int8 results with one 4- or 8-byte store. The leading dimension
// is the worker: row r draws from seed[r], so one launch compresses every
// worker of a round (the port's form of jax.vmap over the Pallas call). B is
// read from device memory (one value, or one per row), so a budget computed on
// the device never needs a host round trip.
//
// A model rank's slice of a leaf (sparsign_map_launch) draws the counters of
// the whole leaf's coordinates: slice column j takes counter_base + j +
// (j / run) * skip, with run the slice's contiguous run and skip the rest of
// the leaf's run (counter_base already holds the slice's offset in it). The
// division is taken once a thread; its later columns step the quotient as
// they cross a run; a thread whose columns lie in one run and one row (all
// but about N / run of them) takes the contiguous loop from its own base
// counter. kMap false is the contiguous kernel, code for code.
#include "common.cuh"

namespace {

using namespace repro;

template <typename T, int N, bool kMap>
__global__ void __launch_bounds__(kThreads)
sparsign_kernel(const T* __restrict__ g, int8_t* __restrict__ out,
                const long long* __restrict__ seeds, const float* __restrict__ budget,
                int budget_per_row, long long rows, long long n, uint32_t counter_base,
                bool vec_ok, long long run, uint32_t skip) {
  const long long total = rows * n;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= total) return;
  const Vec<T, N> gv = load_vec<T, N>(g, i, total, vec_ok);
  long long r = i / n;
  long long col = i - r * n;
  uint32_t seed_hash = mix32(static_cast<uint32_t>(seeds[r]) + RNG_GOLDEN);
  float b = budget[budget_per_row ? r : 0];
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
        const float x = to_f32<T>(gv.v[k]);
        const float p = fminf(fmaxf(__fmul_rn(fabsf(x), b), 0.0f), 1.0f);
        const float u = uniform01(seed_hash, c0 + static_cast<uint32_t>(k));
        o.v[k] = (u < p) ? static_cast<int8_t>(jnp_sign(x)) : static_cast<int8_t>(0);
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
      if (r < rows) {
        seed_hash = mix32(static_cast<uint32_t>(seeds[r]) + RNG_GOLDEN);
        b = budget[budget_per_row ? r : 0];
      }
    }
    const float x = to_f32<T>(gv.v[k]);
    const float p = fminf(fmaxf(__fmul_rn(fabsf(x), b), 0.0f), 1.0f);
    uint32_t counter = counter_base + static_cast<uint32_t>(col);
    if constexpr (kMap) counter += static_cast<uint32_t>(q) * skip;
    const float u = uniform01(seed_hash, counter);
    o.v[k] = (u < p) ? static_cast<int8_t>(jnp_sign(x)) : static_cast<int8_t>(0);
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

template <typename T, int N, bool kMap>
int launch(const void* g, void* out, const void* seeds, const void* budget,
           int budget_per_row, long long rows, long long n, unsigned int counter_base,
           long long run, unsigned int skip, cudaStream_t stream) {
  const long long total = rows * n;
  const bool vec_ok = aligned(g, sizeof(T) * N) && aligned(out, N);
  sparsign_kernel<T, N, kMap><<<grid_for(total, N), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<int8_t*>(out),
      static_cast<const long long*>(seeds), static_cast<const float*>(budget),
      budget_per_row, rows, n, counter_base, vec_ok, run, skip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. seeds: int64[rows] holding uint32 values.
// budget: float32[rows] when budget_per_row, else float32[1].
extern "C" int sparsign_launch(const void* g, void* out, const void* seeds,
                               const void* budget, int budget_per_row, long long rows,
                               long long n, unsigned int counter_base, int dtype,
                               void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 4, false>(g, out, seeds, budget, budget_per_row, rows, n,
                                   counter_base, n, 0u, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8, false>(g, out, seeds, budget, budget_per_row, rows, n,
                                           counter_base, n, 0u, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A model rank's slice: as sparsign_launch, each row's column j drawing counter
// counter_base + j + (j / run) * skip (run >= 1; counter_base holds the slice's
// offset in the leaf's run, skip the leaf's run less the slice's).
extern "C" int sparsign_map_launch(const void* g, void* out, const void* seeds,
                                   const void* budget, int budget_per_row, long long rows,
                                   long long n, unsigned int counter_base, long long run,
                                   unsigned int skip, int dtype, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (run <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 4, true>(g, out, seeds, budget, budget_per_row, rows, n,
                                  counter_base, run, skip, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8, true>(g, out, seeds, budget, budget_per_row, rows, n,
                                          counter_base, run, skip, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
