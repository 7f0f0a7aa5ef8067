// pack2bit and unpack2bit: the stand-alone 2-bit pack and unpack of int8
// ternary tensors on Hopper, the serving replica's downlink.
//
// Replaces: src/repro/kernels/pack2bit/kernel.py:77 (pack2bit_2d) and
// src/repro/kernels/pack2bit/kernel.py:133 (unpack2bit_2d), Pallas TPU.
//
//   pack:   byte j of packed row r = c(t[r, j]) | c(t[r, j + 128]) << 2
//                                  | c(t[r, j + 256]) << 4 | c(t[r, j + 384]) << 6
//           over the canonical (rows, 512) view of the flat n-element t
//           (pack2bit.cuh's format; coordinates past n pack as code 0), with
//           c(s) = 2 for s < 0, else s as uint8, and every shift taken in uint8
//           as the plain version takes it (so even a non-ternary byte packs as
//           the plain version packs it)
//   unpack: out[r, j + 128 k] = dec((p[r, j] >> 2k) & 3), dec: 1 -> +1, 2 -> -1,
//           0 and 3 -> 0; out is the (rows, 512) int8 view
//
// Bound on an H100 (3.35 TB/s): bytes, 1.25 B/coord either way (one int8 and
// a quarter byte); a handful of integer operations a coordinate.
//
// Design: pack2bit.cuh's thread layout. A thread owns 4 consecutive bytes of
// one packed row, a warp one row: the pack reads four 4-byte int8 vectors
// (one in each column block of the row, masked past n) and stores one 4-byte
// word; the unpack loads the word and stores four 4-byte int8 vectors. Every
// access is contiguous across the warp. Offsets are 64-bit.
#include "pack2bit.cuh"

namespace {

using namespace repro;

// the plain version's code: uint8(s) for s >= 0 (a ternary +1 is 01), 2 for s < 0
__device__ __forceinline__ uint32_t code8(int8_t s) {
  return s < 0 ? 2u : static_cast<uint32_t>(static_cast<uint8_t>(s));
}

__global__ void __launch_bounds__(kThreads)
pack2bit_kernel(const int8_t* __restrict__ t, uint8_t* __restrict__ out, long long n,
                long long rows, bool vec_ok) {
  const long long th = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (th >= rows * kThreadsPerRow) return;
  const long long r = th / kThreadsPerRow;
  const int jq = static_cast<int>(th % kThreadsPerRow) * 4;
  uint32_t bytes[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = r * kLanes + k * kRowBytes + jq;
    const Vec<int8_t, 4> tv = load_vec<int8_t, 4>(t, i, n, vec_ok);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bytes[e] |= (code8(tv.v[e]) << (2 * k)) & 0xFFu;   // a uint8 shift
  }
  const uint32_t word = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) | (bytes[3] << 24);
  *reinterpret_cast<uint32_t*>(out + r * kRowBytes + jq) = word;
}

__global__ void __launch_bounds__(kThreads)
unpack2bit_kernel(const uint8_t* __restrict__ packed, int8_t* __restrict__ out,
                  long long rows) {
  const long long th = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (th >= rows * kThreadsPerRow) return;
  const long long r = th / kThreadsPerRow;
  const int jq = static_cast<int>(th % kThreadsPerRow) * 4;
  const uint32_t word = *reinterpret_cast<const uint32_t*>(packed + r * kRowBytes + jq);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Vec<int8_t, 4> v;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v.v[e] = static_cast<int8_t>(decode2((word >> (8 * e + 2 * k)) & 3u));
    *reinterpret_cast<Vec<int8_t, 4>*>(out + r * kLanes + k * kRowBytes + jq) = v;
  }
}

}  // namespace

// t: n contiguous int8; out: uint8[rows, 128], rows = canonical_rows(n).
extern "C" int pack2bit_launch(const void* t, void* out, long long n, long long rows,
                               void* stream) {
  if (rows <= 0) return 0;
  if (!aligned(out, 4)) return static_cast<int>(cudaErrorMisalignedAddress);
  pack2bit_kernel<<<pack_grid(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(t), static_cast<uint8_t*>(out), n, rows, aligned(t, 4));
  return static_cast<int>(cudaGetLastError());
}

// packed: uint8[rows, 128]; out: int8[rows, 512].
extern "C" int unpack2bit_launch(const void* packed, void* out, long long rows, void* stream) {
  if (rows <= 0) return 0;
  if (!aligned(packed, 4) || !aligned(out, 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  unpack2bit_kernel<<<pack_grid(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<int8_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
