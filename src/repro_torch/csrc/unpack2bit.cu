// unpack2bit_sum and unpack2bit_wsum: the decode side of the 2-bit packed vote
// wire on Hopper, fused with the sum over the gathered workers' messages.
//
// Replaces: src/repro/kernels/pack2bit/kernel.py:91 (unpack2bit_sum_2d) and
// src/repro/kernels/pack2bit/kernel.py:111 (unpack2bit_wsum_2d), Pallas TPU.
//
//   sum:  out[r, c] = ((a + dec_0) + dec_1) + ... + dec_{M-1}           int8, int16, int32
//   wsum: out[r, c] = (((a + dec_0 w_0) + dec_1 w_1) + ...) + dec_{M-1} w_{M-1}   float32
//
// over (M, rows, 128) gathered packed messages (pack2bit.cuh's format), with
// a = 0 (+0.0), JAX's function, or, with accumulate, a = out[r, c]: the ring
// (dist/collectives.py) adds each arriving message into its chunk of the
// output in place. The weighted sum adds in worker order with every product
// and sum rounded on its own (__fmul_rn, __fadd_rn: no multiply-add
// contraction), the plain version's and the TPU oracle's association: a zero
// weight times a -1 vote is -0.0, and +0.0 + (-0.0) is +0.0.
//
// The integer sum narrows to the output type: it adds in int32 registers and
// stores the low bytes, which is the narrow type's wrapping add at every
// step, as the plain version's in-place add. The wire's output type is
// _sum_dtype(M) (int8 up to M = 127, int16 up to 32,767), and it never wraps:
// every partial sum of k <= M ternary votes lies in [-k, k], inside [-M, M],
// and an accumulated output holds such a partial sum of the same M messages.
//
// Bound on an H100 (3.35 TB/s): bytes. Each coordinate reads a quarter byte
// per worker and writes its sum (1, 2 or 4 B; the weighted 4), and reads it
// too when accumulating: (0.25 M + s) or (0.25 M + 2 s) B/coord. Decoding
// costs about 6 integer or float operations a code per worker, under the
// byte time at the float32 rate for every M.
//
// Design: pack2bit.cuh's warp-a-row layout. A thread owns 4 consecutive byte
// columns of one packed row, so a warp reads the row's 128 contiguous bytes
// of each message with one 4-byte load a thread, and writes each column
// block's sums as one vector a thread (16 bytes in int32 or float32, 512
// contiguous a warp). The words of kBatch messages are loaded before their
// adds (all M of them up to M = 8), with the accumulator's four vectors. The
// integer sum counts votes four coordinates a word operation: a vote is its
// code's low bit minus its high bit, so shifting and masking a word gives, in
// each byte, the low (or high) bit of one coordinate's code, and byte
// counters add them for up to 255 messages before they are flushed into the
// sums (in int8, kept four to a word and added mod 256 byte by byte). The
// weighted sum selects each vote's product from the worker's three and adds
// it in order. The (M, rows, 512) int8 votes never exist. Offsets are
// 64-bit: M x rows x 128 exceeds 2^31 at the trainer's shapes. On the H100
// at w_down (PERF.md, --decode-split A B B A against the parent, which
// decoded each code with two compares and two selects, 7.25 SASS
// instructions a code and worker in its sum, 9.7 in its weighted sum): the
// sum at M = 4 1.2342 -> 1.2129 ms in int32 (87.1 % of its 1.0564 ms byte
// bound), 0.5260 into int8 (80.3 % of 0.4226); the weighted sum at M = 4
// 1.3618 -> 1.3076. Tried and not kept: the parent's decode with the words
// loaded first (M = 4 1.2693 and 1.5516 ms: 34 and 68 registers; M = 20
// 5.6140), the same at a minimum of 8 blocks an SM (1.2621, and 2.8341 for
// the weighted sum, which spilled), one message at a time (1.3732, 1.5283),
// M = 1 and 4 as compile-time constants (1.2282; into int8 0.4754 and the
// weighted sum 1.2637, 10 % and 3 % faster, not worth a second path),
// streaming (.cs) stores (1.2232, 1.2899).
#include <type_traits>

#include "pack2bit.cuh"

namespace {

using namespace repro;

constexpr int kBatch = 8;     // words in flight a thread
constexpr int kFlush = 255;   // messages a byte counter can hold

template <int kB, bool kWeighted>
__device__ __forceinline__ void load_batch(uint32_t (&word)[kB], float (&w)[kB],
                                           const uint8_t* __restrict__ p,
                                           const float* __restrict__ weights,
                                           long long stride, int i0, int m) {
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int i = i0 + b;
    word[b] = i < m ? __ldg(reinterpret_cast<const uint32_t*>(p + i * stride)) : 0u;
    if constexpr (kWeighted) w[b] = i < m ? __ldg(weights + i) : 0.0f;
  }
}

// One message's votes, four coordinates a word operation: byte e of pos[k]
// (neg[k]) counts the low (high) bits of the codes of coordinate jq + e +
// 128 k, at bit 8e + 2k (8e + 2k + 1) of the word. Every code's vote is its
// low bit minus its high bit (code 3: 1 - 1 = 0). A byte holds kFlush
// messages before it carries.
__device__ __forceinline__ void count_votes(uint32_t (&pos)[4], uint32_t (&neg)[4],
                                            uint32_t word) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pos[k] += (word >> (2 * k)) & 0x01010101u;
    neg[k] += (word >> (2 * k + 1)) & 0x01010101u;
  }
}

// a + b and a - b in each byte, mod 256, no carry or borrow between bytes
__device__ __forceinline__ uint32_t add_bytes(uint32_t a, uint32_t b) {
  return ((a & 0x7F7F7F7Fu) + (b & 0x7F7F7F7Fu)) ^ ((a ^ b) & 0x80808080u);
}
__device__ __forceinline__ uint32_t sub_bytes(uint32_t a, uint32_t b) {
  return ((a | 0x80808080u) - (b & 0x7F7F7F7Fu)) ^ ((a ^ ~b) & 0x80808080u);
}

// The integer sum: counts the M messages' votes kFlush at a time and hands
// each window's counts to flush(pos, neg); each batch's words are loaded
// before its counting.
template <typename Flush>
__device__ __forceinline__ void count_messages(const uint8_t* __restrict__ p, long long stride,
                                               int m, Flush flush) {
  static_assert(kBatch <= kFlush, "a batch must fit a byte counter");
  uint32_t word[kBatch];
  float unused[kBatch];
  load_batch<kBatch, false>(word, unused, p, nullptr, stride, 0, m);
  uint32_t pos[4] = {0u, 0u, 0u, 0u}, neg[4] = {0u, 0u, 0u, 0u};
  int held = 0;
  for (int i0 = 0;;) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i0 + b < m) count_votes(pos, neg, word[b]);
    i0 += kBatch;
    held += kBatch;
    if (i0 >= m) break;
    load_batch<kBatch, false>(word, unused, p, nullptr, stride, i0, m);
    if (held + kBatch > kFlush) {
      flush(pos, neg);
#pragma unroll
      for (int k = 0; k < 4; ++k) pos[k] = neg[k] = 0u;
      held = 0;
    }
  }
  flush(pos, neg);
}

template <typename Out, bool kAccumulate>
__device__ __forceinline__ void decode_sum(const uint8_t* __restrict__ packed,
                                           Out* __restrict__ out, int m, long long rows) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * kThreadsPerRow) return;
  const long long r = t / kThreadsPerRow;
  const int jq = static_cast<int>(t % kThreadsPerRow) * 4;
  const uint8_t* p = packed + r * kRowBytes + jq;
  Out* o = out + r * kLanes + jq;
  if constexpr (sizeof(Out) == 1) {
    // int8: the sums stay four bytes a word, added mod 256 as int8 adds
    uint32_t acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] = kAccumulate ? *reinterpret_cast<const uint32_t*>(o + k * kBlockCols) : 0u;
    count_messages(p, rows * kRowBytes, m, [&](const uint32_t (&pos)[4],
                                                const uint32_t (&neg)[4]) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = sub_bytes(add_bytes(acc[k], pos[k]), neg[k]);
    });
#pragma unroll
    for (int k = 0; k < 4; ++k) *reinterpret_cast<uint32_t*>(o + k * kBlockCols) = acc[k];
  } else {
    int acc[4][4];
    row_acc_init<kAccumulate>(acc, o);
    count_messages(p, rows * kRowBytes, m, [&](const uint32_t (&pos)[4],
                                                const uint32_t (&neg)[4]) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[k][e] += static_cast<int>(prmt(pos[k], 0u, 0x4440u | e)) -
                       static_cast<int>(prmt(neg[k], 0u, 0x4440u | e));
    });
    row_acc_store(acc, o);
  }
}

// The weighted sum: a vote's product is one of the worker's three, each
// __fmul_rn(v, w) as the plain version rounds it; the adds keep worker order.
__device__ __forceinline__ void add_weighted(float (&acc)[4][4], uint32_t word, float w) {
  const float up = __fmul_rn(1.0f, w), down = __fmul_rn(-1.0f, w), zero = __fmul_rn(0.0f, w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t c = word >> (8 * e + 2 * k);
      const float v = (c & 1u) ? ((c & 2u) ? zero : up) : ((c & 2u) ? down : zero);
      acc[k][e] = __fadd_rn(acc[k][e], v);
    }
  }
}

template <bool kAccumulate>
__device__ __forceinline__ void decode_wsum(const uint8_t* __restrict__ packed,
                                            const float* __restrict__ weights,
                                            float* __restrict__ out, int m, long long rows) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * kThreadsPerRow) return;
  const long long r = t / kThreadsPerRow;
  const int jq = static_cast<int>(t % kThreadsPerRow) * 4;
  const long long stride = rows * kRowBytes;
  const uint8_t* p = packed + r * kRowBytes + jq;
  float* o = out + r * kLanes + jq;
  uint32_t word[kBatch];
  float w[kBatch];
  load_batch<kBatch, true>(word, w, p, weights, stride, 0, m);
  float acc[4][4];
  row_acc_init<kAccumulate>(acc, o);
  for (int i0 = 0;;) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i0 + b < m) add_weighted(acc, word[b], w[b]);
    i0 += kBatch;
    if (i0 >= m) break;
    load_batch<kBatch, true>(word, w, p, weights, stride, i0, m);
  }
  row_acc_store(acc, o);
}

template <typename Out, bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
unpack2bit_sum_kernel(const uint8_t* __restrict__ packed, Out* __restrict__ out, int m,
                      long long rows) {
  decode_sum<Out, kAccumulate>(packed, out, m, rows);
}

template <bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
unpack2bit_wsum_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ weights,
                       float* __restrict__ out, int m, long long rows) {
  decode_wsum<kAccumulate>(packed, weights, out, m, rows);
}

template <typename Out>
int launch_typed(const void* packed, void* out, int m, long long rows, int accumulate,
                 cudaStream_t s) {
  if (!aligned(out, 4 * sizeof(Out))) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* p = static_cast<const uint8_t*>(packed);
  auto* o = static_cast<Out*>(out);
  if (accumulate)
    unpack2bit_sum_kernel<Out, true><<<pack_grid(rows), kThreads, 0, s>>>(p, o, m, rows);
  else
    unpack2bit_sum_kernel<Out, false><<<pack_grid(rows), kThreads, 0, s>>>(p, o, m, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: uint8[m, rows, 128]; out: int8, int16 or int32 [rows, 512], its
// element size in out_bytes; accumulate: add into out instead of writing it.
extern "C" int unpack2bit_sum_into_launch(const void* packed, void* out, int m, long long rows,
                                          int out_bytes, int accumulate, void* stream) {
  if (rows <= 0) return 0;
  if (!aligned(packed, 4)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bytes == 1) return launch_typed<int8_t>(packed, out, m, rows, accumulate, s);
  if (out_bytes == 2) return launch_typed<int16_t>(packed, out, m, rows, accumulate, s);
  if (out_bytes == 4) return launch_typed<int32_t>(packed, out, m, rows, accumulate, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// packed: uint8[m, rows, 128]; weights: float32[m]; out: float32[rows, 512].
extern "C" int unpack2bit_wsum_into_launch(const void* packed, const void* weights, void* out,
                                           int m, long long rows, int accumulate,
                                           void* stream) {
  if (rows <= 0) return 0;
  if (!aligned(packed, 4) || !aligned(out, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (accumulate)
    unpack2bit_wsum_kernel<true><<<pack_grid(rows), kThreads, 0, s>>>(p, w, o, m, rows);
  else
    unpack2bit_wsum_kernel<false><<<pack_grid(rows), kThreads, 0, s>>>(p, w, o, m, rows);
  return static_cast<int>(cudaGetLastError());
}
