// golomb_encode: the Golomb/Rice entropy-coded uplink wire's encoder on Hopper,
// for two symbol sources.
//
// Replaces: src/repro/kernels/golomb/kernel.py:58 (sparsign_golomb_2d: sparsign,
// Def. 1, fused into the coded stream) and src/repro/kernels/golomb/kernel.py:88
// (golomb_pack_2d: the coded stream of an int8 ternary tensor), Pallas TPU.
//
// The stream (golomb.cuh, repro.kernels.golomb.ref): per nonzero in ascending
// coordinate order, gap = pos - prev - 1 coded as (gap >> b) one-bits, a zero
// bit, b remainder bits LSB-first and a sign bit; codes that end past the
// static capacity n_bits are dropped as a suffix. Header: shipped and dropped.
//
// Bound on an H100 (3.35 TB/s): bytes. The gradient is read once (2 B bf16,
// 4 B f32, 1 B int8 a coordinate) and the capacity buffer written once; at
// p = 0.05 that is 2.05 B a coordinate in bf16.
//
// Design: the TPU kernel is one grid cell running the vectorized emission of
// the whole message; here the code offsets, which chain through the message,
// come from a scan. A tile is 4096 consecutive coordinates, 16 a thread.
//   A  tile_stats: regenerate the tile's symbols in registers (the counter
//      hash for sparsign, or the int8 view) and reduce them to a Seg: nonzero
//      count, first and last nonzero position, and the bits of every code but
//      the first (whose gap depends on the tiles before).
//   B  an exclusive scan of the tiles' Segs (golomb.cuh; the Seg combine
//      bridges the gap between a's last nonzero and b's first), in 64 bits.
//   C  emit: regenerate the symbols again, block-scan the threads' Segs, and
//      write each code's bits. The tile's codes but the first one's unary run
//      are assembled in shared memory (at most 4096 (3 + b) bits) and stored
//      as whole words; only the two edge words take an atomicOr, as a
//      neighbouring tile may share them. The first code's unary run can span
//      any number of all-zero tiles before it (a lone nonzero at the end of a
//      leaf is n / 2^b one-bits), so the whole block writes it, as whole
//      0xFFFFFFFF words.
// Shipped and dropped counts are atomicAdds into the zeroed header. The int8
// ternary tensor never exists for the sparsign source. Every float operation
// of the draw is an _rn intrinsic, as in sparsign.cu.
#include "golomb.cuh"

namespace {

using namespace repro;
using namespace repro::golomb;

constexpr int kEncThreads = 256;
constexpr int kPer = 16;                       // coordinates a thread
constexpr int kTile = kEncThreads * kPer;      // coordinates a tile

struct Seg {
  unsigned long long inner;  // bits of every code but the first
  int first;                 // first nonzero position
  int last;                  // last nonzero position
  unsigned int cnt;          // nonzeros
  unsigned int pad;
};

__device__ __forceinline__ Seg shfl_up(const Seg& s, int d) {
  return Seg{__shfl_up_sync(0xffffffffu, s.inner, d), __shfl_up_sync(0xffffffffu, s.first, d),
             __shfl_up_sync(0xffffffffu, s.last, d), __shfl_up_sync(0xffffffffu, s.cnt, d),
             0u};
}

__device__ __forceinline__ unsigned long long code_len(long long gap, int b) {
  return static_cast<unsigned long long>(gap >> b) + 2ull + static_cast<unsigned>(b);
}

struct SegOp {
  int b;
  __device__ __forceinline__ Seg identity() const { return Seg{0ull, 0, -1, 0u, 0u}; }
  __device__ __forceinline__ Seg operator()(const Seg& a, const Seg& c) const {
    if (a.cnt == 0) return c;
    if (c.cnt == 0) return a;
    return Seg{a.inner + c.inner + code_len(static_cast<long long>(c.first) - a.last - 1, b),
               a.first, c.last, a.cnt + c.cnt, 0u};
  }
};

// The stream offset just past a prefix's codes (its first code starts at 0).
__device__ __forceinline__ unsigned long long seg_bits(const Seg& s, int b) {
  return s.cnt ? code_len(s.first, b) + s.inner : 0ull;
}

// Symbol sources: load(i) gives the nonzero and negative masks of the 16
// coordinates from i (bit k for coordinate i + k; coordinates >= n are 0).
template <typename T>
struct SparsignSrc {
  const T* g;
  const long long* seed;  // one uint32 stream seed, on the device
  const float* budget_p;  // B, on the device
  uint32_t counter_base;
  bool vec_ok;
  uint32_t seed_hash;
  float budget;

  __device__ __forceinline__ void prepare() {
    seed_hash = mix32(static_cast<uint32_t>(seed[0]) + RNG_GOLDEN);
    budget = budget_p[0];
  }

  __device__ __forceinline__ void load(long long i, long long n, uint32_t& nz,
                                       uint32_t& neg) const {
    constexpr int V = 16 / sizeof(T);
    nz = neg = 0;
#pragma unroll
    for (int k = 0; k < kPer / V; ++k) {
      const Vec<T, V> v = load_vec<T, V>(g, i + k * V, n, vec_ok);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const long long pos = i + k * V + e;
        const float x = to_f32<T>(v.v[e]);
        const float p = fminf(fmaxf(__fmul_rn(fabsf(x), budget), 0.0f), 1.0f);
        const bool hit = pos < n &&
                         uniform01(seed_hash, counter_base + static_cast<uint32_t>(pos)) < p;
        const int s = hit ? (x > 0.0f ? 1 : (x < 0.0f ? -1 : 0)) : 0;
        nz |= static_cast<uint32_t>(s != 0) << (k * V + e);
        neg |= static_cast<uint32_t>(s < 0) << (k * V + e);
      }
    }
  }
};

struct TernarySrc {
  const int8_t* t;
  bool vec_ok;

  __device__ __forceinline__ void prepare() {}

  __device__ __forceinline__ void load(long long i, long long n, uint32_t& nz,
                                       uint32_t& neg) const {
    const Vec<int8_t, kPer> v = load_vec<int8_t, kPer>(t, i, n, vec_ok);
    nz = neg = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      nz |= static_cast<uint32_t>(v.v[e] != 0) << e;
      neg |= static_cast<uint32_t>(v.v[e] < 0) << e;
    }
  }
};

__device__ __forceinline__ Seg thread_seg(uint32_t nz, long long base, int b) {
  Seg s{0ull, 0, -1, static_cast<unsigned>(__popc(nz)), 0u};
  if (!nz) return s;
  s.first = static_cast<int>(base) + __ffs(nz) - 1;
  s.last = static_cast<int>(base) + 31 - __clz(nz);
  long long prev = s.first;
  for (uint32_t m = nz & (nz - 1); m; m &= m - 1) {
    const long long pos = base + __ffs(m) - 1;
    s.inner += code_len(pos - prev - 1, b);
    prev = pos;
  }
  return s;
}

template <typename Src>
__global__ void __launch_bounds__(kEncThreads)
tile_stats(Src src, Seg* segs, long long n, int b) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kPer;
  uint32_t nz, neg;
  src.prepare();
  src.load(base, n, nz, neg);
  Seg tot;
  block_exclusive_scan(thread_seg(nz, base, b), SegOp{b}, &tot);
  if (threadIdx.x == 0) segs[blockIdx.x] = tot;
}

// OR the low len (<= 32) bits of v into the window at local bit lb.
__device__ __forceinline__ void win_or(uint32_t* win, unsigned long long lb, uint32_t v,
                                       int len) {
  if (!v) return;
  const unsigned w = static_cast<unsigned>(lb >> 5);
  const int sh = static_cast<int>(lb & 31);
  atomicOr(&win[w], v << sh);
  if (sh && sh + len > 32) atomicOr(&win[w + 1], v >> (32 - sh));
}

// Set the window's bits [lo, hi) to one; the run's whole words are its alone.
__device__ __forceinline__ void win_ones(uint32_t* win, unsigned long long lo,
                                         unsigned long long hi) {
  while (lo < hi) {
    const unsigned w = static_cast<unsigned>(lo >> 5);
    const int sh = static_cast<int>(lo & 31);
    const unsigned long long take = min(32ull - sh, hi - lo);
    if (take == 32) {
      win[w] = 0xFFFFFFFFu;
    } else {
      atomicOr(&win[w], ((1u << take) - 1u) << sh);
    }
    lo += take;
  }
}

template <typename Src>
__global__ void __launch_bounds__(kEncThreads)
emit(Src src, const Seg* seg_prefix, const Seg* seg_totals, uint32_t* out, long long n,
     unsigned long long n_bits, int b, int win_words) {
  extern __shared__ uint32_t win[];
  __shared__ unsigned long long fit_end;
  __shared__ unsigned int shipped, dropped;
  const SegOp op{b};
  const long long tile = blockIdx.x;
  const long long base = tile * kTile + threadIdx.x * kPer;
  uint32_t nz, neg;
  src.prepare();
  src.load(base, n, nz, neg);
  Seg tile_seg;
  const Seg within = block_exclusive_scan(thread_seg(nz, base, b), op, &tile_seg);
  if (tile_seg.cnt == 0) return;  // the same in every thread of the block

  uint32_t* body = out + kHeaderWords;
  const Seg before = scanned(seg_prefix, seg_totals, tile, op);
  const long long prev0 = before.cnt ? before.last : -1;
  const unsigned long long s0 = seg_bits(before, b);                    // first code's start
  const unsigned long long r = s0 + ((tile_seg.first - prev0 - 1) >> b);  // its stop bit
  if (r + 2 + b > n_bits) {  // the tile's first code does not fit, nor any after it
    if (threadIdx.x == 0) atomicAdd(&out[1], tile_seg.cnt);
    return;
  }
  const unsigned long long wb = r >> 5;  // window word 0 is body word wb
  for (int i = threadIdx.x; i < win_words; i += kEncThreads) win[i] = 0u;
  if (threadIdx.x == 0) {
    fit_end = 0ull;
    shipped = dropped = 0u;
  }
  __syncthreads();

  // the tile's first code's unary run [s0, r): whole body words before wb,
  // then the bits of word wb below r in the window
  const unsigned long long w0 = s0 >> 5;
  for (unsigned long long w = w0 + threadIdx.x; w < wb; w += kEncThreads) {
    if (w == w0 && (s0 & 31)) {
      atomicOr(&body[w], 0xFFFFFFFFu << (s0 & 31));  // shared with the tile before
    } else {
      body[w] = 0xFFFFFFFFu;
    }
  }
  if (threadIdx.x == 0) win_ones(win, (s0 > wb * 32 ? s0 : wb * 32) - wb * 32, r - wb * 32);

  // this thread's codes
  const Seg mine = op(before, within);
  long long prev = mine.cnt ? mine.last : -1;
  unsigned long long off = seg_bits(mine, b);
  const bool tile_first = within.cnt == 0;  // this thread holds the tile's first code
  unsigned my_ship = 0, my_drop = 0;
  unsigned long long my_end = 0;
  for (uint32_t m = nz; m; m &= m - 1) {
    const int k = __ffs(m) - 1;
    const long long pos = base + k;
    const long long gap = pos - prev - 1;
    const unsigned long long q = static_cast<unsigned long long>(gap >> b);
    const unsigned long long end = off + q + 2 + b;
    if (end <= n_bits) {
      ++my_ship;
      my_end = end;
      // window bits; the tile's first code's run is written above
      if (!(tile_first && off == s0)) win_ones(win, off - wb * 32, off + q - wb * 32);
      const uint32_t rem = b ? static_cast<uint32_t>(gap) & ((1u << b) - 1u) : 0u;
      const uint32_t sign = (neg >> k) & 1u;
      win_or(win, off + q + 1 - wb * 32, rem | (sign << b), b + 1);
    } else {
      ++my_drop;
    }
    prev = pos;
    off = end;
  }
  if (my_ship) {
    atomicAdd(&shipped, my_ship);
    atomicMax(&fit_end, my_end);
  }
  if (my_drop) atomicAdd(&dropped, my_drop);
  __syncthreads();

  // the window's words [wb, last]: the edge words may hold a neighbour's bits
  const unsigned long long last = (fit_end - 1) >> 5;
  const unsigned long long nw = last - wb + 1;
  for (unsigned long long i = threadIdx.x; i < nw; i += kEncThreads) {
    const uint32_t v = win[i];
    if (i == 0 || i == nw - 1) {
      if (v) atomicOr(&body[wb + i], v);
    } else {
      body[wb + i] = v;
    }
  }
  if (threadIdx.x == 0) {
    atomicAdd(&out[0], shipped);
    if (dropped) atomicAdd(&out[1], dropped);
  }
}

// Shared-memory words of the emit window: the tile's bits after the first
// code's unary run are at most kTile * (2 + b) + kTile, from an offset < 32.
inline int window_words(int b) { return (kTile * (3 + b) + 63) / 32 + 1; }

inline long long tiles_for(long long n) { return (n + kTile - 1) / kTile; }

template <typename Src>
int encode(const Src& src, void* out, void* scratch, long long n, long long rows, int b,
           cudaStream_t stream) {
  const long long tiles = tiles_for(n);
  Seg* segs = static_cast<Seg*>(scratch);
  Seg* totals = segs + tiles;
  const int win = window_words(b);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(rows) * 128, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(tiles);
  tile_stats<Src><<<grid, kEncThreads, 0, stream>>>(src, segs, n, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = exclusive_scan(segs, segs, totals, tiles, SegOp{b}, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(win) * 4;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(emit<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  emit<Src><<<grid, kEncThreads, smem, stream>>>(src, segs, totals, static_cast<uint32_t*>(out),
                                                 n, static_cast<unsigned long long>(
                                                        body_bits(rows)), b, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch bytes golomb_encode_launch needs for an n-coordinate message.
extern "C" long long golomb_encode_scratch_bytes(long long n) {
  const long long tiles = tiles_for(n);
  return static_cast<long long>(sizeof(Seg)) * (tiles + scan_blocks_for(tiles));
}

// src_kind: 0 = sparsign of float32 g, 1 = sparsign of bfloat16 g, 2 = an
// int8 ternary tensor (seed and budget unused). src: n contiguous values;
// out: rows * 128 bytes, 4-byte aligned; scratch: golomb_encode_scratch_bytes(n),
// 8-byte aligned. seed: int64[1] holding a uint32 value; budget: float32[1].
// 1 <= n < 2^31 and 0 <= b <= 31.
extern "C" int golomb_encode_launch(const void* src, void* out, const void* seed,
                                    const void* budget, void* scratch, long long n,
                                    long long rows, unsigned int counter_base, int b,
                                    int src_kind, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  if (!aligned(out, 4) || !aligned(scratch, 8)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n >= (1ll << 31) || b < 0 || b > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_kind == 2) {
    return encode(TernarySrc{static_cast<const int8_t*>(src), aligned(src, 16)}, out, scratch,
                  n, rows, b, s);
  }
  const bool vec_ok = aligned(src, 16);
  const long long* sd = static_cast<const long long*>(seed);
  const float* bd = static_cast<const float*>(budget);
  if (src_kind == 0) {
    return encode(SparsignSrc<float>{static_cast<const float*>(src), sd, bd, counter_base,
                                     vec_ok, 0u, 0.0f}, out, scratch, n, rows, b, s);
  }
  if (src_kind == 1) {
    return encode(SparsignSrc<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(src), sd, bd,
                                             counter_base, vec_ok, 0u, 0.0f},
                  out, scratch, n, rows, b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
