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
// come from a single-pass chained scan (golomb.cuh's Chain), and one launch
// does the whole message, reading each coordinate once and drawing it once.
// A tile is 16384 consecutive coordinates, 64 a thread, 256 threads:
//   - each block takes its tile from a ticket counter and regenerates the
//     tile's symbols once, into registers: the counter hash for sparsign, or
//     the int8 view; 64-bit nonzero and negative masks a thread;
//   - it block-scans the threads' Segs (nonzero count, first and last nonzero
//     position, the bits of every code but the first, whose gap depends on
//     the tiles before; the Seg combine bridges the gap between a's last
//     nonzero and b's first, in 64 bits) into the tile's Seg;
//   - warp 0 publishes that aggregate, looks back over the predecessors'
//     records for the tile's exclusive prefix and publishes the inclusive
//     one, while every other thread assembles its codes in a shared-memory
//     window whose bit 0 is the tile's first code's stop bit (at most 16384
//     (3 + b) bits): the codes' relative offsets are known from the block
//     scan alone, and only shared-memory atomics are needed;
//   - then the block writes the window, shifted to the first stop bit's
//     place, as whole words (only the two edge words take an atomicOr, as a
//     neighbouring tile may share them), with the first code's remainder and
//     sign, which depend on the previous tile's last nonzero. The first
//     code's unary run can span any number of all-zero tiles before it (a
//     lone nonzero at the end of a leaf is n / 2^b one-bits), so the whole
//     block writes it, as whole 0xFFFFFFFF words. A tile that crosses the
//     capacity counts which of its codes end by n_bits and masks the rest.
// Shipped and dropped counts are atomicAdds into the zeroed header. The int8
// ternary tensor never exists for the sparsign source. Every float operation
// of the draw is an _rn intrinsic, as in sparsign.cu.
#include "golomb.cuh"

namespace {

using namespace repro;
using namespace repro::golomb;

constexpr int kEncThreads = 256;
constexpr int kEncBlocks = 8;                  // resident a multiprocessor: <= 32 registers
constexpr int kPer = 64;                       // coordinates a thread
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

// Symbol sources: load(i) gives the nonzero and negative masks of the kPer
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

  __device__ __forceinline__ void load(long long i, long long n, uint64_t& nz,
                                       uint64_t& neg) const {
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
        nz |= static_cast<uint64_t>(s != 0) << (k * V + e);
        neg |= static_cast<uint64_t>(s < 0) << (k * V + e);
      }
    }
  }
};

struct TernarySrc {
  const int8_t* t;
  bool vec_ok;

  __device__ __forceinline__ void prepare() {}

  __device__ __forceinline__ void load(long long i, long long n, uint64_t& nz,
                                       uint64_t& neg) const {
    uint32_t z[2] = {0u, 0u}, m[2] = {0u, 0u};  // the masks' 32-bit halves
#pragma unroll
    for (int k = 0; k < kPer / 16; ++k) {
      const Vec<int8_t, 16> v = load_vec<int8_t, 16>(t, i + 16 * k, n, vec_ok);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int j = 16 * k + e;
        z[j >> 5] |= static_cast<uint32_t>(v.v[e] != 0) << (j & 31);
        m[j >> 5] |= static_cast<uint32_t>(v.v[e] < 0) << (j & 31);
      }
    }
    nz = z[0] | static_cast<uint64_t>(z[1]) << 32;
    neg = m[0] | static_cast<uint64_t>(m[1]) << 32;
  }
};

__device__ __forceinline__ Seg thread_seg(uint64_t nz, long long base, int b) {
  const unsigned int cnt = static_cast<unsigned int>(__popcll(nz));
  Seg s{0ull, 0, -1, cnt, 0u};
  if (!nz) return s;
  s.first = static_cast<int>(base) + __ffsll(nz) - 1;
  s.last = static_cast<int>(base) + 63 - __clzll(nz);
  s.inner = static_cast<unsigned long long>(cnt - 1) * (2u + static_cast<unsigned int>(b));
  if ((kPer - 2) >> b) {  // a gap inside the thread's coordinates can reach 2^b
    long long prev = s.first;
    for (uint64_t m = nz & (nz - 1); m; m &= m - 1) {
      const long long pos = base + __ffsll(m) - 1;
      s.inner += static_cast<unsigned long long>((pos - prev - 1) >> b);
      prev = pos;
    }
  }
  return s;
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
__global__ void __launch_bounds__(kEncThreads, kEncBlocks)
encode_tiles(Src src, Chain<Seg> chain, uint32_t* out, long long n, unsigned long long n_bits,
             int b, int win_words) {
  extern __shared__ uint32_t win[];  // the tile's bits from its first code's stop bit on
  __shared__ Seg before_sh;
  __shared__ unsigned long long fit_end;
  __shared__ unsigned int shipped, first_sign;
  const SegOp op{b};
  for (int i = threadIdx.x; i < win_words; i += kEncThreads) win[i] = 0u;
  const long long tile = chain_ticket(chain);
  const long long base = tile * kTile + threadIdx.x * kPer;
  uint64_t nz, neg;
  src.prepare();
  src.load(base, n, nz, neg);
  Seg tile_seg;
  const Seg within = block_exclusive_scan(thread_seg(nz, base, b), op, &tile_seg);
  if (threadIdx.x < 32) {
    const Seg before = chain_exclusive(chain, tile, tile_seg, op);
    if (threadIdx.x == 0) {
      before_sh = before;
      fit_end = 0ull;
      shipped = 0u;
    }
  }
  if (tile_seg.cnt == 0) return;  // the same in every thread of the block

  // Assemble this thread's codes in the window while warp 0 looks back. Window
  // bit 0 is the tile's first code's stop bit; that code's unary run and its
  // remainder depend on the tiles before, so they are written afterwards.
  const bool tile_first = within.cnt == 0 && nz;  // this thread holds the tile's first code
  {
    long long prev = within.cnt ? within.last : -1;
    unsigned long long off = within.cnt ? 2 + b + within.inner : 0;
    for (uint64_t m = nz; m; m &= m - 1) {
      const int k = __ffsll(m) - 1;
      const long long pos = base + k;
      if (tile_first && m == nz) {  // stop bit at window bit 0
        first_sign = (neg >> k) & 1u;
      } else {
        const long long gap = pos - prev - 1;
        const unsigned long long q = static_cast<unsigned long long>(gap >> b);
        win_ones(win, off, off + q);
        const uint32_t rem = b ? static_cast<uint32_t>(gap) & ((1u << b) - 1u) : 0u;
        win_or(win, off + q + 1, rem | (((neg >> k) & 1u) << b), b + 1);
        off += q;
      }
      off += 2 + b;
      prev = pos;
    }
  }
  __syncthreads();

  uint32_t* body = out + kHeaderWords;
  const Seg before = before_sh;
  const long long prev0 = before.cnt ? before.last : -1;
  const unsigned long long s0 = seg_bits(before, b);                    // first code's start
  const long long gap0 = tile_seg.first - prev0 - 1;
  const unsigned long long r = s0 + (gap0 >> b);                        // its stop bit
  if (r + 2 + b > n_bits) {  // the tile's first code does not fit, nor any after it
    if (threadIdx.x == 0) atomicAdd(&out[1], tile_seg.cnt);
    return;
  }
  unsigned long long end = r + 2 + b + tile_seg.inner;  // just past the tile's last code
  if (end > n_bits) {  // capacity: ship the codes that end by n_bits, drop the rest
    long long prev = within.cnt ? within.last : -1;
    unsigned long long e = r + (within.cnt ? 2 + b + within.inner : 0);
    unsigned my_ship = 0;
    unsigned long long fit = 0;
    for (uint64_t m = nz; m; m &= m - 1) {
      const long long pos = base + __ffsll(m) - 1;
      e += 2 + b + (tile_first && m == nz ? 0ull
                                          : static_cast<unsigned long long>((pos - prev - 1) >> b));
      if (e <= n_bits) {
        ++my_ship;
        fit = e;
      }
      prev = pos;
    }
    if (my_ship) {
      atomicAdd(&shipped, my_ship);
      atomicMax(&fit_end, fit);
    }
    __syncthreads();
    end = fit_end;
  } else if (threadIdx.x == 0) {
    shipped = tile_seg.cnt;
  }

  // the tile's first code's unary run [s0, r): whole body words before word
  // wb, then the bits of word wb below r
  const unsigned long long wb = r >> 5;
  const unsigned long long w0 = s0 >> 5;
  for (unsigned long long w = w0 + threadIdx.x; w < wb; w += kEncThreads) {
    if (w == w0 && (s0 & 31)) {
      atomicOr(&body[w], 0xFFFFFFFFu << (s0 & 31));  // shared with the tile before
    } else {
      body[w] = 0xFFFFFFFFu;
    }
  }
  const int sh = static_cast<int>(r & 31);
  if (threadIdx.x == 0) {
    const int lo_bit = s0 > wb * 32 ? static_cast<int>(s0 - wb * 32) : 0;
    const uint32_t run = (sh ? (0xFFFFFFFFu >> (32 - sh)) : 0u) & (0xFFFFFFFFu << lo_bit);
    if (sh > lo_bit) atomicOr(&body[wb], run);
  }

  // the window, shifted to bit r, through `end`, with the first code's
  // remainder and sign at window bit 1: the edge words may hold a
  // neighbour's bits
  const unsigned long long head =
      ((b ? static_cast<unsigned long long>(gap0) & ((1ull << b) - 1ull) : 0ull) |
       (static_cast<unsigned long long>(first_sign) << b)) << 1;
  auto word = [&](unsigned long long i) {  // window word i with the first code's bits
    return win[i] | (i < 2 ? static_cast<uint32_t>(head >> (32 * i)) : 0u);
  };
  const unsigned long long nw = ((end - 1) >> 5) - wb + 1;
  const int tail = static_cast<int>(end & 31);
  for (unsigned long long i = threadIdx.x; i < nw; i += kEncThreads) {
    const uint32_t cur = word(i);
    const uint32_t prv = i ? word(i - 1) : 0u;
    uint32_t v = sh ? (cur << sh) | (prv >> (32 - sh)) : cur;
    if (i == nw - 1 && tail) v &= 0xFFFFFFFFu >> (32 - tail);
    if (i == 0 || i == nw - 1) {
      if (v) atomicOr(&body[wb + i], v);
    } else {
      body[wb + i] = v;
    }
  }
  if (threadIdx.x == 0) {
    atomicAdd(&out[0], shipped);
    if (shipped < tile_seg.cnt) atomicAdd(&out[1], tile_seg.cnt - shipped);
  }
}

// Shared-memory words of the window: the tile's bits from its first code's
// stop bit on are at most kTile * (2 + b) + kTile.
inline int window_words(int b) { return (kTile * (3 + b) + 63) / 32 + 1; }

inline long long tiles_for(long long n) { return (n + kTile - 1) / kTile; }

inline long long round16(long long bytes) { return (bytes + 15) / 16 * 16; }

// The scratch buffer: the ticket and the tiles' flags (zeroed each launch),
// then the tiles' aggregates and inclusive prefixes.
inline long long zeroed_bytes(long long tiles) { return round16(4 * (1 + tiles)); }

inline Chain<Seg> chain_in(void* scratch, long long tiles) {
  char* p = static_cast<char*>(scratch);
  unsigned int* words = reinterpret_cast<unsigned int*>(p);
  Seg* agg = reinterpret_cast<Seg*>(p + zeroed_bytes(tiles));
  return Chain<Seg>{words, words + 1, agg, agg + tiles};
}

template <typename Src>
int encode(const Src& src, void* out, void* scratch, long long n, long long rows, int b,
           cudaStream_t stream) {
  const long long tiles = tiles_for(n);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(rows) * 128, stream);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(zeroed_bytes(tiles)), stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(window_words(b)) * 4;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(encode_tiles<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  encode_tiles<Src><<<static_cast<unsigned>(tiles), kEncThreads, smem, stream>>>(
      src, chain_in(scratch, tiles), static_cast<uint32_t*>(out), n,
      static_cast<unsigned long long>(body_bits(rows)), b, window_words(b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch bytes golomb_encode_launch needs for an n-coordinate message.
extern "C" long long golomb_encode_scratch_bytes(long long n) {
  const long long tiles = tiles_for(n);
  return zeroed_bytes(tiles) + 2 * static_cast<long long>(sizeof(Seg)) * tiles;
}

// src_kind: 0 = sparsign of float32 g, 1 = sparsign of bfloat16 g, 2 = an
// int8 ternary tensor (seed and budget unused). src: n contiguous values;
// out: rows * 128 bytes, 4-byte aligned; scratch: golomb_encode_scratch_bytes(n),
// 16-byte aligned. seed: int64[1] holding a uint32 value; budget: float32[1].
// 1 <= n < 2^31 and 0 <= b <= 31.
extern "C" int golomb_encode_launch(const void* src, void* out, const void* seed,
                                    const void* budget, void* scratch, long long n,
                                    long long rows, unsigned int counter_base, int b,
                                    int src_kind, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  if (!aligned(out, 4) || !aligned(scratch, 16)) {
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
