// unpack2bit_sum and unpack2bit_wsum: the decode side of the 2-bit packed vote
// wire on Hopper, fused with the sum over the gathered workers' messages.
//
// Replaces: src/repro/kernels/pack2bit/kernel.py:91 (unpack2bit_sum_2d) and
// src/repro/kernels/pack2bit/kernel.py:111 (unpack2bit_wsum_2d), Pallas TPU.
//
//   sum:  out[r, c] = sum_m dec(p[m, r, c])                        int32
//   wsum: out[r, c] = (((0 + dec_0 w_0) + dec_1 w_1) + ...) + dec_{M-1} w_{M-1}  float32
//
// over (M, rows, 128) gathered packed messages (pack2bit.cuh's format),
// writing the (rows, 512) sum only. The weighted sum starts at +0.0, not at
// the first term, and adds in worker order with every product and sum rounded
// on its own (__fmul_rn, __fadd_rn: no multiply-add contraction), which is
// the plain version's and the TPU oracle's association: a zero weight times a
// -1 vote is -0.0 and 0.0 + (-0.0) is +0.0.
//
// Bound on an H100 (3.35 TB/s): bytes. Each coordinate reads a quarter byte
// per worker and writes 4 bytes: (0.25 M + 4) B/coord. Decoding costs about 6
// integer or float operations a code per worker, under the byte time at the
// float32 rate for every M.
//
// Design: a thread owns 4 consecutive byte columns of one packed row, so a
// warp reads the row's 128 contiguous bytes of each message with one 4-byte
// load a thread, loops over the M messages in order with 16 accumulators in
// registers (4 columns x 4 codes), and writes four 16-byte vectors, one per
// column block of the output row. The (M, rows, 512) int8 votes never exist.
// Offsets are 64-bit: M x rows x 128 exceeds 2^31 at the trainer's shapes.
#include <type_traits>

#include "pack2bit.cuh"

namespace {

using namespace repro;

template <bool WEIGHTED>
__device__ __forceinline__ void unpack_thread(const uint8_t* __restrict__ packed,
                                              const float* __restrict__ weights,
                                              void* __restrict__ out, int m, long long rows) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * kThreadsPerRow) return;
  const long long r = t / kThreadsPerRow;
  const int jq = static_cast<int>(t % kThreadsPerRow) * 4;
  const long long stride = rows * kRowBytes;
  const uint8_t* p = packed + r * kRowBytes + jq;
  using Acc = typename std::conditional<WEIGHTED, float, int>::type;
  Acc acc[4][4];  // [column block k][byte e]
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = Acc(0);
  for (int i = 0; i < m; ++i) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(p + i * stride);
    float w = 0.0f;
    if constexpr (WEIGHTED) w = weights[i];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = decode2((word >> (8 * e + 2 * k)) & 3u);
        if constexpr (WEIGHTED) {
          acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(static_cast<float>(v), w));
        } else {
          acc[k][e] += v;
        }
      }
    }
  }
  Acc* o = static_cast<Acc*>(out) + r * kLanes + jq;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Vec<Acc, 4> v;
#pragma unroll
    for (int e = 0; e < 4; ++e) v.v[e] = acc[k][e];
    *reinterpret_cast<Vec<Acc, 4>*>(o + k * kRowBytes) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
unpack2bit_sum_kernel(const uint8_t* __restrict__ packed, int32_t* __restrict__ out, int m,
                      long long rows) {
  unpack_thread<false>(packed, nullptr, out, m, rows);
}

__global__ void __launch_bounds__(kThreads)
unpack2bit_wsum_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ weights,
                       float* __restrict__ out, int m, long long rows) {
  unpack_thread<true>(packed, weights, out, m, rows);
}

inline bool unpack_aligned(const void* packed, const void* out) {
  return aligned(packed, 4) && aligned(out, 16);
}

}  // namespace

// packed: uint8[m, rows, 128]; out: int32[rows, 512].
extern "C" int unpack2bit_sum_launch(const void* packed, void* out, int m, long long rows,
                                     void* stream) {
  if (rows <= 0) return 0;
  if (!unpack_aligned(packed, out)) return static_cast<int>(cudaErrorMisalignedAddress);
  unpack2bit_sum_kernel<<<pack_grid(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<int32_t*>(out), m, rows);
  return static_cast<int>(cudaGetLastError());
}

// packed: uint8[m, rows, 128]; weights: float32[m]; out: float32[rows, 512].
extern "C" int unpack2bit_wsum_launch(const void* packed, const void* weights, void* out,
                                      int m, long long rows, void* stream) {
  if (rows <= 0) return 0;
  if (!unpack_aligned(packed, out)) return static_cast<int>(cudaErrorMisalignedAddress);
  unpack2bit_wsum_kernel<<<pack_grid(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(weights),
      static_cast<float*>(out), m, rows);
  return static_cast<int>(cudaGetLastError());
}
