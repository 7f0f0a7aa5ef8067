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
// (4 B f32, 2 B bf16) and writes one int8: 3 B/coord in bf16, 5 in f32. The
// hash costs about 15 integer operations per coordinate, below the issue
// rate at that bound.
//
// Design: the sparsign instantiation of int8_encode.cuh's encoder, the
// template that ternary.cu launches for every rule, on encode_tiles.cuh's
// frame for many rows; its notes say how. The leading dimension is the
// worker: row r draws from seed[r], so one launch compresses every worker
// of a round (the port's form of jax.vmap over the Pallas call), and no
// padded (rows, 512) copy is made, because the counter is the column index.
// B is read from device memory (one value, or one per row), once per row a
// block meets, so a budget computed on the device never needs a host round
// trip. On the H100 (PERF.md, PR 27) this took w_down in bf16 from 1.2509 to
// 0.7411 ms against the 0.6338 ms byte bound, and the FL round's 100 x
// 545,002 float32 rows from 0.1205 to 0.1054 ms; the flat kernel it replaced
// gave each thread 8 coordinates, a 64-bit division and its own row setup.
//
// A model rank's slice of a leaf (sparsign_map_launch) draws the counters of
// the whole leaf's coordinates: slice column j takes counter_base + j +
// (j / run) * skip, with run the slice's contiguous run and skip the rest of
// the leaf's run (counter_base already holds the slice's offset in it); the
// encoder's map modes (encode_tiles.cuh's CounterMap) take it.
#include "int8_encode.cuh"

// dtype: 0 = float32, 1 = bfloat16. seeds: int64[rows] holding uint32 values.
// budget: float32[rows] when budget_per_row, else float32[1].
extern "C" int sparsign_launch(const void* g, void* out, const void* seeds,
                               const void* budget, int budget_per_row, long long rows,
                               long long n, unsigned int counter_base, int dtype,
                               void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_encode_rows<Int8Encoder<float, SparsignRule>>(
        g, out, seeds, budget, budget_per_row, rows, n, counter_base, s);
  if (dtype == 1)
    return launch_encode_rows<Int8Encoder<__nv_bfloat16, SparsignRule>>(
        g, out, seeds, budget, budget_per_row, rows, n, counter_base, s);
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
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CounterMap map{run, skip};
  if (dtype == 0)
    return launch_encode_rows<Int8Encoder<float, SparsignRule>, true>(
        g, out, seeds, budget, budget_per_row, rows, n, counter_base, s, map);
  if (dtype == 1)
    return launch_encode_rows<Int8Encoder<__nv_bfloat16, SparsignRule>, true>(
        g, out, seeds, budget, budget_per_row, rows, n, counter_base, s, map);
  return static_cast<int>(cudaErrorInvalidValue);
}
