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
#include "common.cuh"

namespace {

using namespace repro;

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
sparsign_kernel(const T* __restrict__ g, int8_t* __restrict__ out,
                const long long* __restrict__ seeds, const float* __restrict__ budget,
                int budget_per_row, long long rows, long long n, uint32_t counter_base,
                bool vec_ok) {
  const long long total = rows * n;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= total) return;
  const Vec<T, N> gv = load_vec<T, N>(g, i, total, vec_ok);
  long long r = i / n;
  long long col = i - r * n;
  uint32_t seed_hash = mix32(static_cast<uint32_t>(seeds[r]) + RNG_GOLDEN);
  float b = budget[budget_per_row ? r : 0];
  Vec<int8_t, N> o;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (col == n) {  // this thread's elements run into the next worker's row
      ++r;
      col = 0;
      if (r < rows) {
        seed_hash = mix32(static_cast<uint32_t>(seeds[r]) + RNG_GOLDEN);
        b = budget[budget_per_row ? r : 0];
      }
    }
    const float x = to_f32<T>(gv.v[k]);
    const float p = fminf(fmaxf(__fmul_rn(fabsf(x), b), 0.0f), 1.0f);
    const float u = uniform01(seed_hash, counter_base + static_cast<uint32_t>(col));
    o.v[k] = (u < p) ? static_cast<int8_t>(jnp_sign(x)) : static_cast<int8_t>(0);
    ++col;
  }
  store_vec<int8_t, N>(out, i, total, vec_ok, o);
}

template <typename T, int N>
int launch(const void* g, void* out, const void* seeds, const void* budget,
           int budget_per_row, long long rows, long long n, unsigned int counter_base,
           cudaStream_t stream) {
  const long long total = rows * n;
  const bool vec_ok = aligned(g, sizeof(T) * N) && aligned(out, N);
  sparsign_kernel<T, N><<<grid_for(total, N), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<int8_t*>(out),
      static_cast<const long long*>(seeds), static_cast<const float*>(budget),
      budget_per_row, rows, n, counter_base, vec_ok);
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
    return launch<float, 4>(g, out, seeds, budget, budget_per_row, rows, n, counter_base, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8>(g, out, seeds, budget, budget_per_row, rows, n,
                                    counter_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
