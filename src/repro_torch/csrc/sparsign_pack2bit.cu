// sparsign_pack2bit: sparsign (Def. 1) fused to the 2-bit packed vote wire on Hopper.
//
// Replaces: src/repro/kernels/sparsign_pack2bit/kernel.py:61
// (sparsign_pack2bit_2d, Pallas TPU).
//
//   t[c]  = sign(g[c]) if u(seed, counter_base + c) < clip(|g[c]| * B, 0, 1) else 0
//   out   = the canonical (rows, 128) uint8 packing of t (pack2bit.cuh),
//           rows = canonical_rows(n); coordinates past n pack as 0
//
// with u the counter-hash uniform of repro.core.prng, regenerated in registers.
//
// Bound on an H100 (3.35 TB/s): bytes. Each coordinate reads its gradient
// once (2 B bf16, 4 B f32) and writes a quarter byte: 2.25 B/coord in bf16.
// The rule's operations (chip_smoke.py's OPS_PER_COORD) and the packing's
// take less than half that time at the float32 rate, but the counter hash's
// integer instructions come close to the ALU pipe's limit.
//
// Design: the sparsign instantiation of pack2_encode.cuh's encoder, the
// template that ternary.cu's pack variant launches for every rule; its notes
// say how it keeps the hash's instructions few and the loads in flight. One
// pass from gradient to wire bytes: the int8 ternary tensor never exists. The
// seed and B are read from device memory, once a block, so a budget reduced
// on the card costs no host round trip.
#include "pack2_encode.cuh"

// dtype: 0 = float32, 1 = bfloat16. g: n contiguous values; out: rows * 128
// bytes, rows = canonical_rows(n). seed: int64[1] holding a uint32 value;
// budget: float32[1].
extern "C" int sparsign_pack2bit_launch(const void* g, void* out, const void* seed,
                                        const void* budget, long long n, long long rows,
                                        unsigned int counter_base, int dtype, void* stream) {
  using namespace repro;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_encode<Pack2Encoder<float, SparsignRule>>(g, out, seed, budget, n, rows,
                                                            counter_base, s);
  if (dtype == 1)
    return launch_encode<Pack2Encoder<__nv_bfloat16, SparsignRule>>(g, out, seed, budget, n,
                                                                    rows, counter_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A model rank's slice: as sparsign_pack2bit_launch, coordinate i drawing
// counter counter_base + i + (i / run) * skip (encode_tiles.cuh's CounterMap,
// run >= 1).
extern "C" int sparsign_pack2bit_map_launch(const void* g, void* out, const void* seed,
                                            const void* budget, long long n, long long rows,
                                            unsigned int counter_base, long long run,
                                            unsigned int skip, int dtype, void* stream) {
  using namespace repro;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CounterMap map{run, skip};
  if (dtype == 0)
    return launch_encode<Pack2Encoder<float, SparsignRule>, true>(g, out, seed, budget, n, rows,
                                                                  counter_base, s, map);
  if (dtype == 1)
    return launch_encode<Pack2Encoder<__nv_bfloat16, SparsignRule>, true>(
        g, out, seed, budget, n, rows, counter_base, s, map);
  return static_cast<int>(cudaErrorInvalidValue);
}
