// The 2-bit packed vote wire of repro.kernels.pack2bit, shared by the fused
// compress -> pack encoder (pack2_encode.cuh), the stand-alone pack and
// unpack (pack2bit.cu) and the decode-sum kernels (unpack2bit.cu).
//
// Wire format: the flat n-coordinate stream is viewed as canonical rows of
// 512 coordinates (padded with zero coordinates to a multiple of 32 rows);
// byte j of a row packs the symbols at columns j, j + 128, j + 256, j + 384 in
// bits 0-1, 2-3, 4-5, 6-7. Codes: 0 -> 00, +1 -> 01, -1 -> 10; code 11 decodes
// as 0. A row is 128 bytes.
//
// Thread layout of pack2bit.cu and unpack2bit.cu (the warp-a-row layout,
// also pack8.cu's unpack8_sum): thread t owns 4 consecutive bytes (columns
// jq .. jq + 3, jq = 4 * (t % 32)) of packed row r = t / 32, so a warp owns
// one row: its 128-byte loads and stores of packed bytes, and its loads of the
// four 128-coordinate column blocks, are each contiguous. The thread's 16
// coordinates are jq + e + 128 k (e, k in 0..3): 4 consecutive in each column
// block, so a warp's access to one block of 4-byte outputs spans 512
// contiguous bytes.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kRowBytes = 128;     // packed bytes of a row
constexpr int kThreadsPerRow = kRowBytes / 4;
constexpr int kBlockCols = kLanes / 4;   // coordinates of a column block

// 2-bit code -> ternary vote; code 3 (never written) decodes as 0
__device__ __forceinline__ int decode2(uint32_t c) {
  return c == 1u ? 1 : (c == 2u ? -1 : 0);
}

inline unsigned int pack_grid(long long rows) {
  const long long threads = rows * kThreadsPerRow;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

// The decode-sums' accumulators in this layout: acc[k][e] holds coordinate
// jq + e + 128 k of the row whose outputs start at o + jq. With kAccumulate
// they start from the output's values, else from zero (+0.0 for a float).
template <bool kAccumulate, typename Acc, typename Out>
__device__ __forceinline__ void row_acc_init(Acc (&acc)[4][4], const Out* __restrict__ o) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kAccumulate) {
      const Vec<Out, 4> v = *reinterpret_cast<const Vec<Out, 4>*>(o + k * kBlockCols);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][e] = static_cast<Acc>(v.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][e] = Acc(0);
    }
  }
}

// the 16 sums as four vectors of 4 outputs, one a column block; an integer
// sum narrows by truncation, which is the narrow type's own wrapping add
template <typename Acc, typename Out>
__device__ __forceinline__ void row_acc_store(const Acc (&acc)[4][4], Out* __restrict__ o) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Vec<Out, 4> v;
#pragma unroll
    for (int e = 0; e < 4; ++e) v.v[e] = static_cast<Out>(acc[k][e]);
    *reinterpret_cast<Vec<Out, 4>*>(o + k * kBlockCols) = v;
  }
}

}  // namespace repro
