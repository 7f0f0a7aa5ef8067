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
// Thread layout of pack2bit.cu and unpack2bit.cu: thread t owns 4 consecutive
// bytes (columns jq .. jq + 3, jq = 4 * (t % 32)) of packed row r = t / 32, so
// a warp owns one row: its 128-byte loads and stores of packed bytes, and its
// loads of the four 128-coordinate column blocks, are each contiguous.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kRowBytes = 128;     // packed bytes of a row
constexpr int kThreadsPerRow = kRowBytes / 4;

// 2-bit code -> ternary vote; code 3 (never written) decodes as 0
__device__ __forceinline__ int decode2(uint32_t c) {
  return c == 1u ? 1 : (c == 2u ? -1 : 0);
}

inline unsigned int pack_grid(long long rows) {
  const long long threads = rows * kThreadsPerRow;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

}  // namespace repro
