// The 2-bit packed vote wire of repro.kernels.pack2bit, shared by the fused
// compress -> pack kernels (sparsign_pack2bit.cu, ternary.cu's pack variant)
// and the decode-sum kernels (unpack2bit.cu).
//
// Wire format: the flat n-coordinate stream is viewed as canonical rows of
// 512 coordinates (padded with zero coordinates to a multiple of 32 rows);
// byte j of a row packs the symbols at columns j, j + 128, j + 256, j + 384 in
// bits 0-1, 2-3, 4-5, 6-7. Codes: 0 -> 00, +1 -> 01, -1 -> 10; code 11 decodes
// as 0. A row is 128 bytes.
//
// Thread layout shared by every kernel here: thread t owns 4 consecutive
// bytes (columns jq .. jq + 3, jq = 4 * (t % 32)) of packed row r = t / 32, so
// a warp owns one row: its 128-byte loads and stores of packed bytes, and its
// loads of the four 128-coordinate column blocks, are each contiguous.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kLanes = 512;        // coordinates of a canonical row
constexpr int kRowBytes = 128;     // packed bytes of a row
constexpr int kThreadsPerRow = kRowBytes / 4;

// int8 ternary symbol {-1, 0, +1} -> 2-bit code {2, 0, 1}
__device__ __forceinline__ uint32_t code2(int8_t s) {
  return s < 0 ? 2u : static_cast<uint32_t>(s);
}

// 2-bit code -> ternary vote; code 3 (never written) decodes as 0
__device__ __forceinline__ int decode2(uint32_t c) {
  return c == 1u ? 1 : (c == 2u ? -1 : 0);
}

inline unsigned int pack_grid(long long rows) {
  const long long threads = rows * kThreadsPerRow;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

// One thread of a fused compress -> pack kernel: reads the 16 coordinates it
// packs (four 4-wide vector loads, masked past n: a coordinate >= n packs as
// code 0 whatever the rule would give it), asks ``sym(x, counter)`` for each
// symbol, with counter = counter_base + flat index (uint32, wrapping as the
// TPU kernel's uint32 index does), and stores one 4-byte word.
template <typename T, typename Sym>
__device__ __forceinline__ void pack_thread(const T* __restrict__ g, uint8_t* __restrict__ out,
                                            long long n, long long rows,
                                            uint32_t counter_base, bool vec_ok,
                                            const Sym& sym) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * kThreadsPerRow) return;
  const long long r = t / kThreadsPerRow;
  const int jq = static_cast<int>(t % kThreadsPerRow) * 4;
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = r * kLanes + k * kRowBytes + jq;
    const Vec<T, 4> gv = load_vec<T, 4>(g, i, n, vec_ok);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long pos = i + e;
      const int8_t s = pos < n ? sym(to_f32<T>(gv.v[e]),
                                     counter_base + static_cast<uint32_t>(pos))
                               : int8_t(0);
      word |= code2(s) << (8 * e + 2 * k);
    }
  }
  *reinterpret_cast<uint32_t*>(out + r * kRowBytes + jq) = word;
}

}  // namespace repro
