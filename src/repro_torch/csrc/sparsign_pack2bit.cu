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
// The rule's 23 operations a coordinate (chip_smoke.py's OPS_PER_COORD) and
// the packing's 3 take less than half that time at the float32 rate.
//
// Design: one pass from gradient to wire bytes; the int8 ternary tensor
// never exists. A thread owns 4 bytes of a packed row (16 coordinates in four
// column blocks of the row, each a 16-byte f32 or 8-byte bf16 vector load) and
// writes one 4-byte word; a warp covers one 512-coordinate row, so every load
// and store is contiguous across the warp. The layout is the wire's, not a
// flat pass as in sparsign.cu: a byte's four symbols lie 128 columns apart.
// Rows past the tensor's end are the canonical pad and come out as zero
// bytes. The seed and B are read from device memory, so a budget reduced on
// the card costs no host round trip. Every float operation is an _rn
// intrinsic, as in sparsign.cu, so no contraction moves a bit from the plain
// version.
#include "pack2bit.cuh"

namespace {

using namespace repro;

struct SparsignSym {
  uint32_t seed_hash;
  float b;
  __device__ __forceinline__ int8_t operator()(float x, uint32_t counter) const {
    const float p = fminf(fmaxf(__fmul_rn(fabsf(x), b), 0.0f), 1.0f);
    if (!(uniform01(seed_hash, counter) < p)) return 0;
    return x > 0.0f ? int8_t(1) : (x < 0.0f ? int8_t(-1) : int8_t(0));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparsign_pack2bit_kernel(const T* __restrict__ g, uint8_t* __restrict__ out,
                         const long long* __restrict__ seed, const float* __restrict__ budget,
                         long long n, long long rows, uint32_t counter_base, bool vec_ok) {
  const SparsignSym sym{mix32(static_cast<uint32_t>(seed[0]) + RNG_GOLDEN), budget[0]};
  pack_thread<T>(g, out, n, rows, counter_base, vec_ok, sym);
}

template <typename T>
int launch(const void* g, void* out, const void* seed, const void* budget, long long n,
           long long rows, unsigned int counter_base, cudaStream_t stream) {
  const bool vec_ok = aligned(g, sizeof(T) * 4) && aligned(out, 4);
  if (!aligned(out, 4)) return static_cast<int>(cudaErrorMisalignedAddress);
  sparsign_pack2bit_kernel<T><<<pack_grid(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<uint8_t*>(out),
      static_cast<const long long*>(seed), static_cast<const float*>(budget), n, rows,
      counter_base, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g: n contiguous values; out: rows * 128
// bytes, rows = canonical_rows(n). seed: int64[1] holding a uint32 value;
// budget: float32[1].
extern "C" int sparsign_pack2bit_launch(const void* g, void* out, const void* seed,
                                        const void* budget, long long n, long long rows,
                                        unsigned int counter_base, int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, out, seed, budget, n, rows, counter_base, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, out, seed, budget, n, rows, counter_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
