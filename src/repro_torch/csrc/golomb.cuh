// Shared pieces of the Golomb/Rice wire's kernels (golomb_encode.cu,
// golomb_decode.cu): the stream layout, a two-level exclusive scan and a
// single-pass chained scan with decoupled look-back (Chain, below).
//
// Stream layout (repro.kernels.golomb.ref): a message of `rows` 128-byte rows
// is read as rows * 32 little-endian uint32 words. Words 0 and 1 are the
// header (shipped and dropped nonzeros); bit i of the body is bit (i & 31) of
// word 2 + (i >> 5). The body holds n_bits = (rows * 32 - 2) * 32 bits.
//
// The scan: scan_blocks computes, for kScanThreads elements a block, each
// element's exclusive prefix within its block and the block's total;
// scan_totals then replaces the totals by their exclusive prefixes (one
// block, each thread a run of consecutive totals). The full exclusive prefix
// of element i is op(totals[i / kScanThreads], prefix[i]). Ops need not
// commute: op(a, b) combines an earlier a with a later b.
#pragma once

#include "common.cuh"

namespace repro {
namespace golomb {

constexpr int kScanThreads = 1024;
constexpr int kHeaderWords = 2;

__device__ __forceinline__ unsigned int shfl_up(unsigned int x, int d) {
  return __shfl_up_sync(0xffffffffu, x, d);
}

// Exclusive scan over the block (blockDim.x a multiple of 32, at most 1024)
// of one element a thread; *total receives the block's inclusive total in
// every thread. Starts and ends with a barrier, so it may be called again.
template <typename T, typename Op>
__device__ T block_exclusive_scan(T v, const Op& op, T* total) {
  __shared__ T warp_sum[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up(x, d);
    if (lane >= d) x = op(y, x);
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? warp_sum[lane] : op.identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = shfl_up(w, d);
      if (lane >= d) w = op(y, w);
    }
    warp_sum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  T before = shfl_up(x, 1);
  if (lane == 0) before = op.identity();
  const T out = warp > 0 ? op(warp_sum[warp - 1], before) : before;
  *total = warp_sum[nwarps - 1];
  __syncthreads();
  return out;
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kScanThreads)
scan_blocks(const T* in, T* prefix, T* totals, long long count, Op op) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const T v = i < count ? in[i] : op.identity();
  T tot;
  const T ex = block_exclusive_scan(v, op, &tot);
  if (i < count) prefix[i] = ex;
  if (threadIdx.x == 0) totals[blockIdx.x] = tot;
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kScanThreads)
scan_totals(T* totals, long long count, Op op) {
  const long long per = (count + kScanThreads - 1) / kScanThreads;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < count ? lo + per : count;
  T run = op.identity();
  for (long long i = lo; i < hi; ++i) run = op(run, totals[i]);
  T tot;
  T ex = block_exclusive_scan(run, op, &tot);
  for (long long i = lo; i < hi; ++i) {
    const T v = totals[i];
    totals[i] = ex;
    ex = op(ex, v);
  }
}

inline long long scan_blocks_for(long long count) {
  return (count + kScanThreads - 1) / kScanThreads;
}

// in and prefix may alias; totals holds scan_blocks_for(count) elements.
template <typename T, typename Op>
cudaError_t exclusive_scan(const T* in, T* prefix, T* totals, long long count, Op op,
                           cudaStream_t stream) {
  const long long blocks = scan_blocks_for(count);
  scan_blocks<T, Op><<<static_cast<unsigned int>(blocks), kScanThreads, 0, stream>>>(
      in, prefix, totals, count, op);
  scan_totals<T, Op><<<1, kScanThreads, 0, stream>>>(totals, blocks, op);
  return cudaGetLastError();
}

template <typename T, typename Op>
__device__ __forceinline__ T scanned(const T* prefix, const T* totals, long long i,
                                     const Op& op) {
  return op(totals[i / kScanThreads], prefix[i]);
}

// A single-pass chained scan with decoupled look-back (Merrill and Garland):
// each block takes its tile from a ticket counter, so every predecessor of a
// running tile is running or done, and publishes its tile's aggregate, then
// its inclusive prefix, each a record of whole 32-bit words stored before
// its flag (0 none, 1 aggregate, 2 inclusive) with release order. The ticket
// and the flags are zeroed before the launch. Ops need not commute.
template <typename T>
struct Chain {
  unsigned int* ticket;  // [1]
  unsigned int* flag;    // [tiles]
  T* agg;                // [tiles]
  T* incl;               // [tiles]
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

template <typename T>
__device__ __forceinline__ void store_cg(T* p, const T& v) {
  static_assert(sizeof(T) % 4 == 0, "records are whole 32-bit words");
  const unsigned int* s = reinterpret_cast<const unsigned int*>(&v);
  unsigned int* d = reinterpret_cast<unsigned int*>(p);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 4); ++k) __stcg(d + k, s[k]);
}

template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  T v;
  unsigned int* d = reinterpret_cast<unsigned int*>(&v);
  const unsigned int* s = reinterpret_cast<const unsigned int*>(p);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 4); ++k) d[k] = __ldcg(s + k);
  return v;
}

template <typename T>
__device__ __forceinline__ T shfl_down_words(const T& v, int d) {
  T r;
  const unsigned int* s = reinterpret_cast<const unsigned int*>(&v);
  unsigned int* o = reinterpret_cast<unsigned int*>(&r);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 4); ++k)
    o[k] = __shfl_down_sync(0xffffffffu, s[k], d);
  return r;
}

template <typename T>
__device__ __forceinline__ T shfl_words(const T& v, int lane) {
  T r;
  const unsigned int* s = reinterpret_cast<const unsigned int*>(&v);
  unsigned int* o = reinterpret_cast<unsigned int*>(&r);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 4); ++k)
    o[k] = __shfl_sync(0xffffffffu, s[k], lane);
  return r;
}

// The block's tile: its ticket. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ long long chain_ticket(const Chain<T>& c) {
  __shared__ unsigned int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(c.ticket, 1u);
  __syncthreads();
  return ticket;
}

// Called by one whole warp with the tile's aggregate: publishes it, walks
// back over the predecessors 32 at a time (lane 0 the nearest) until one has
// its inclusive prefix, folds them in stream order, publishes the inclusive
// prefix and returns the exclusive one in every lane.
template <typename T, typename Op>
__device__ T chain_exclusive(const Chain<T>& c, long long tile, const T& agg, const Op& op) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) {
      store_cg(c.incl, agg);
      st_release(c.flag, 2u);
    }
    return op.identity();
  }
  if (lane == 0) {
    store_cg(c.agg + tile, agg);
    st_release(c.flag + tile, 1u);
  }
  T run = op.identity();
  for (long long hi = tile - 1;; hi -= 32) {
    const long long t = hi - lane;
    unsigned int f, inc, upto;
    do {  // until every lane up to the nearest inclusive prefix has a record
      f = t >= 0 ? ld_acquire(c.flag + t) : 2u;
      inc = __ballot_sync(0xffffffffu, f == 2u);
      upto = inc ? (inc & (0u - inc)) * 2u - 1u : 0xffffffffu;
    } while (__ballot_sync(0xffffffffu, f == 0u) & upto);
    T v = op.identity();
    if (t >= 0 && ((upto >> lane) & 1u)) v = load_cg((f == 2u ? c.incl : c.agg) + t);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // lane l + d is the earlier tile
      const T o = shfl_down_words(v, d);
      if (lane + d < 32) v = op(o, v);
    }
    run = op(shfl_words(v, 0), run);
    if (inc) break;
  }
  if (lane == 0) {
    store_cg(c.incl + tile, op(run, agg));
    st_release(c.flag + tile, 2u);
  }
  return run;
}

inline long long body_bits(long long rows) { return (rows * 32 - kHeaderWords) * 32; }

}  // namespace golomb
}  // namespace repro
