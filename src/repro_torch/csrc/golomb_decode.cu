// ungolomb_sum and ungolomb_wsum: the decode side of the Golomb/Rice wire on
// Hopper, fused with the sum over the gathered workers' messages.
//
// Replaces: src/repro/kernels/golomb/kernel.py:109 (ungolomb_sum) and
// src/repro/kernels/golomb/kernel.py:130 (ungolomb_wsum), Pallas TPU.
//
//   sum:  out[pos] = sum_m votes_m[pos]                                  int32
//   wsum: out[pos] = (((0 + v_0 w_0) + v_1 w_1) + ...) + v_{M-1} w_{M-1}  float32
//
// over M gathered messages of `rows` 128-byte rows (golomb.cuh's layout), each
// the header's shipped count of Rice codes; positions >= n are dropped, and
// an all-zero message (a masked worker) adds nothing.
//
// Bound on an H100 (3.35 TB/s): bytes. Each message is read once and the
// (n,) sum written once: M * rows * 128 + 4 n bytes.
//
// Design: code boundaries are unknown until the stream is read from its
// start, so each message's body is cut into segments of 512 bits, 256 a
// block, staged in shared memory with coalesced loads (a pad word every 16,
// so the threads' segments fall in distinct banks), and a segment owns the
// codes whose stop bit lies in it. A segment's entry is then one of b + 2
// classes: the first code it owns starts at most b + 1 bits past its start
// (the code before ends 2 + b bits after a stop bit that lies before), and
// a start before it (class 0) reads as one: the bits from there are the
// code's unary ones, so its stop bit is the first zero bit in the segment.
// The unary bits of a code count toward the segment they lie in, so the
// positions a segment advances depend on its class alone, and no parse
// reads past the segment but for its last code's b + 1 bits:
//   1  class_pass: each segment's transfer function, the exit class for each
//      entry class, packed 5 bits an entry (one word at b <= 4). Class 0 is
//      parsed first and its code starts marked in a bitmap; every other
//      class's parse stops where it lands on one of them (Rice codes
//      resynchronise within a few codes), so only low-entropy stretches
//      (saturated rows of gap-0 codes `0 0000 s`, the zero padding), where a
//      parse can stay misaligned for good, take b + 2 full parses. Each
//      message's first segment is entered at bit 0: its function is a constant.
//   2  an exclusive scan composes the functions (golomb.cuh's scan, one word
//      an element); each message's first one is a constant, so every prefix
//      is one, and its value is the next segment's exact class.
//   3  count_pass: each segment parses from its class, counting the codes it
//      owns and the positions it advances, and writes each code's position
//      past the segment's first, << 1 | sign, into its slot, in whole 32-byte
//      sectors (8 entries staged in shared memory). Segments whose exit class
//      is not their successor's composed class are counted (`stats`), a check
//      that the composition reproduces the parse from bit 0.
//   4  an exclusive sum scan gives each segment's first position and first
//      code index; mark_pass records them beside its class, the segment that
//      holds each message's last shipped code, and, per message and output
//      tile of 2048 coordinates, the segment holding the tile's first position.
//   5  emit_tiles: each block owns an output tile. For up to 16 messages at
//      once its threads read the slot entries of the segments that land in
//      the tile (codes with index < shipped), a thread an entry, and set bit
//      k (a +1) or 16 + k (a -1) of the coordinate's vote mask in shared
//      memory for message k (8 KB a block, so 16 blocks fit a multiprocessor);
//      each thread then folds its 16 coordinates' masks into registers, in
//      worker order, and stores them once, with 16-byte stores. The weighted
//      sum starts at +0.0 and rounds each product and sum on its own
//      (__fmul_rn, __fadd_rn): a coordinate a message does not touch would add
//      +0.0, which leaves an accumulator that is never -0.0 unchanged, so
//      skipping it is exact.
// Positions >= n fall in no tile; an all-zero message (a masked worker)
// shipped nothing and is skipped. Bits past a message's body read as 0; no
// read leaves its buffer.
#include <type_traits>

#include "golomb.cuh"

namespace {

using namespace repro;
using namespace repro::golomb;

constexpr int kDecThreads = 256;                          // segments a block
constexpr int kSegWords = 16;
constexpr unsigned long long kSegBits = 32 * kSegWords;    // 512
constexpr int kStageWords = kDecThreads * kSegWords + 2;  // + the last code's b + 1 bits
constexpr int kStagePadded = kStageWords + kStageWords / kSegWords + 1;  // a pad word every 16
constexpr int kOutTile = 2048;                            // output coordinates a block
constexpr int kEmitThreads = 128;
constexpr int kEmitBlocks = 16;                           // resident a multiprocessor
constexpr int kGroup = 16;                                // messages a pass over a tile
constexpr int kSpan = 4 * kEmitThreads;                   // a 16-byte store of every thread
constexpr int kPerThread = kOutTile / kEmitThreads;       // 16
constexpr int kFields = 6;                                // 5-bit table entries a word

struct Pair {
  unsigned long long adv;  // positions advanced
  unsigned long long cnt;  // codes owned
};

__device__ __forceinline__ Pair shfl_up(const Pair& p, int d) {
  return Pair{__shfl_up_sync(0xffffffffu, p.adv, d), __shfl_up_sync(0xffffffffu, p.cnt, d)};
}

struct SumOp {
  __device__ __forceinline__ Pair identity() const { return Pair{0ull, 0ull}; }
  __device__ __forceinline__ Pair operator()(const Pair& a, const Pair& c) const {
    return Pair{a.adv + c.adv, a.cnt + c.cnt};
  }
};

// A segment's first position and first code index within its message, and
// its entry class.
struct SegRec {
  unsigned long long adv;
  unsigned int cnt;
  unsigned short cls;
  unsigned short own;  // codes whose stop bit lies in it
};

struct AddOp {
  __device__ __forceinline__ unsigned int identity() const { return 0u; }
  __device__ __forceinline__ unsigned int operator()(unsigned int a, unsigned int c) const {
    return a + c;
  }
};

// A segment's (or a run of segments') transfer function: the exit class of
// each of the b + 2 entry classes, 5 bits each, kFields a word.
template <int W>
struct Tab {
  uint32_t w[W];
  __device__ __forceinline__ unsigned int at(int j) const {
    return (w[j / kFields] >> (5 * (j % kFields))) & 31u;
  }
  __device__ __forceinline__ void put(int j, unsigned int v) {  // into a zero field
    w[j / kFields] |= v << (5 * (j % kFields));
  }
};

template <int W>
__device__ __forceinline__ Tab<W> shfl_up(const Tab<W>& t, int d) {
  Tab<W> r;
#pragma unroll
  for (int k = 0; k < W; ++k) r.w[k] = __shfl_up_sync(0xffffffffu, t.w[k], d);
  return r;
}

template <int W>
struct TabOp {
  int classes;  // b + 2

  __device__ __forceinline__ Tab<W> identity() const {
    Tab<W> r{};
    for (int j = 0; j < classes; ++j) r.put(j, static_cast<unsigned int>(j));
    return r;
  }
  // a runs before c
  __device__ __forceinline__ Tab<W> operator()(const Tab<W>& a, const Tab<W>& c) const {
    Tab<W> r{};
    for (int j = 0; j < classes; ++j) r.put(j, c.at(static_cast<int>(a.at(j))));
    return r;
  }
};

inline int tab_words(int b) { return b + 2 <= kFields ? 1 : (b + 2 <= 2 * kFields ? 2 : 6); }

// The working arrays, carved from one scratch buffer.
struct Work {
  const uint32_t* msgs;
  long long rows;
  int m;
  long long ns;              // segments a message
  int b;
  unsigned long long nb;     // body bits a message
  long long tiles;           // output tiles
  uint32_t* tab;             // [m * ns] Tab<W>: transfer functions, then their prefixes
  uint32_t* tabt;            // the scan's block totals
  uint8_t* cls;              // [m * ns] each segment's entry class
  Pair* pair;                // [m * ns + 1] (positions, codes), then their prefixes
  Pair* pairt;
  SegRec* rec;               // [m * ns] each segment's class, first position and code index
  uint32_t* slots;           // [m * ns][slot]: each owned code's position past the segment's
                             // first, << 1 | sign
  int slot;                  // the most codes a segment can own
  unsigned int* last;        // [m] 1 + the segment holding the last shipped code
  unsigned int* first;       // [m][tiles + 1]: 1 + the segment holding each tile's first
                             // position, 0 for none
  unsigned long long* stats; // [1]: segments whose exit is not the next one's class

  __host__ __device__ __forceinline__ long long total() const { return m * ns; }
  __device__ __forceinline__ const uint32_t* header(int i) const {
    return msgs + static_cast<long long>(i) * rows * 32;
  }
  __device__ __forceinline__ unsigned long long seg_end(long long s) const {
    const unsigned long long e = (s + 1) * kSegBits;
    return e < nb ? e : nb;
  }
  __host__ __device__ __forceinline__ long long blocks_a_message() const {
    return (ns + kDecThreads - 1) / kDecThreads;
  }
};

// A message's body words in device memory; words past it read as 0.
struct Stream {
  const uint32_t* body;
  unsigned long long nwords;

  __device__ __forceinline__ uint32_t word(unsigned long long w) const {
    return w < nwords ? body[w] : 0u;
  }
};

// Bit reads from a block's staged words in shared memory, word 0 at bit
// `base`, a pad word after every 16 (a thread's segment at an odd stride).
struct Staged {
  const uint32_t* w;
  unsigned long long base;

  __device__ __forceinline__ uint32_t word(unsigned k) const { return w[k + (k >> 4)]; }
  __device__ __forceinline__ uint32_t bits(unsigned long long x, int len) const {
    if (len == 0) return 0u;
    const unsigned long long l = x - base;
    const unsigned k = static_cast<unsigned>(l >> 5);
    const int sh = static_cast<int>(l & 31);
    uint32_t v = word(k) >> sh;
    if (sh) v |= word(k + 1) << (32 - sh);
    return v & ((1u << len) - 1u);
  }
  __device__ __forceinline__ unsigned long long zero_in(unsigned long long x,
                                                        unsigned long long e) const {
    unsigned k = static_cast<unsigned>((x - base) >> 5);
    const unsigned ke = static_cast<unsigned>((e - base) >> 5);
    if (k >= ke) return e;
    uint32_t v = ~word(k) & (0xFFFFFFFFu << ((x - base) & 31));
    while (!v) {
      if (++k >= ke) return e;
      v = ~word(k);
    }
    return base + (static_cast<unsigned long long>(k) << 5) + __ffs(v) - 1;
  }
};

__device__ __forceinline__ Stream stream_of(const Work& wk, int i) {
  return Stream{wk.header(i) + kHeaderWords,
                static_cast<unsigned long long>(wk.rows) * 32 - kHeaderWords};
}

// Stages the words of the block's segments of message i, and the two after
// them, into shared memory with coalesced loads; returns their view.
__device__ __forceinline__ Staged stage(const Work& wk, int i, long long s0, uint32_t* st) {
  const Stream src = stream_of(wk, i);
  const unsigned long long w0 = static_cast<unsigned long long>(s0) * kSegWords;
  for (int k = threadIdx.x; k < kStageWords; k += kDecThreads) {
    st[k + (k >> 4)] = src.word(w0 + k);
  }
  __syncthreads();
  return Staged{st, w0 * 32};
}

template <int W>
__global__ void __launch_bounds__(kDecThreads) class_pass(Work wk) {
  __shared__ uint32_t st[kStagePadded];
  __shared__ uint32_t vis[kSegWords][kDecThreads];  // class 0's code starts, a thread a column
  const long long bpm = wk.blocks_a_message();
  const int i = static_cast<int>(blockIdx.x / bpm);
  const long long s0 = (blockIdx.x - i * bpm) * kDecThreads;
  const long long s = s0 + threadIdx.x;
  const long long g = i * wk.ns + s;
  const TabOp<W> op{wk.b + 2};
  Tab<W>* tabs = reinterpret_cast<Tab<W>*>(wk.tab);
  if (wk.header(i)[0] == 0u) {  // a message that shipped nothing is never decoded
    if (s < wk.ns) tabs[g] = op.identity();
    return;
  }
  const Staged bits = stage(wk, i, s0, st);
  if (s >= wk.ns) return;
  const unsigned long long S = s * kSegBits;
  const unsigned long long E = wk.seg_end(s);
#pragma unroll
  for (int k = 0; k < kSegWords; ++k) vis[k][threadIdx.x] = 0u;
  unsigned long long x = S;
  unsigned int e0 = 0u;
  for (;;) {
    if (x >= E) {
      e0 = static_cast<unsigned int>(x - E);
      break;
    }
    vis[(x - S) >> 5][threadIdx.x] |= 1u << ((x - S) & 31);
    const unsigned long long z = bits.zero_in(x, E);
    if (z == E) break;  // e0 = 0
    x = z + 2 + wk.b;
  }
  Tab<W> t{};
  for (int j = 0; j < op.classes; ++j) {
    unsigned int e = e0;
    if (j > 0 && s > 0) {  // a message's first segment is entered at bit 0
      // class j's parse; from a code start that class 0's parse shares, the
      // two agree
      for (x = S + j;;) {
        if (x >= E) {
          e = static_cast<unsigned int>(x - E);
          break;
        }
        if ((vis[(x - S) >> 5][threadIdx.x] >> ((x - S) & 31)) & 1u) break;
        const unsigned long long z = bits.zero_in(x, E);
        if (z == E) {
          e = 0u;
          break;
        }
        x = z + 2 + wk.b;
      }
    }
    t.put(j, e);
  }
  tabs[g] = t;
}

template <int W>
__global__ void __launch_bounds__(kDecThreads) count_pass(Work wk) {
  __shared__ uint32_t st[kStagePadded];
  __shared__ uint32_t sbuf[kDecThreads * 9];  // a thread's next 8 slot entries
  const long long bpm = wk.blocks_a_message();
  const int i = static_cast<int>(blockIdx.x / bpm);
  const long long s0 = (blockIdx.x - i * bpm) * kDecThreads;
  const long long s = s0 + threadIdx.x;
  const long long g = i * wk.ns + s;
  if (blockIdx.x == 0 && threadIdx.x == 0) wk.pair[wk.total()] = Pair{0ull, 0ull};
  if (wk.header(i)[0] == 0u) {
    if (s < wk.ns) {
      wk.pair[g] = Pair{0ull, 0ull};
      wk.cls[g] = 0;
    }
    return;
  }
  const Staged bits = stage(wk, i, s0, st);
  if (s >= wk.ns) return;
  const TabOp<W> op{wk.b + 2};
  const Tab<W>* tabs = reinterpret_cast<const Tab<W>*>(wk.tab);
  const Tab<W>* tabt = reinterpret_cast<const Tab<W>*>(wk.tabt);
  const unsigned int j = s == 0 ? 0u : scanned(tabs, tabt, g, op).at(0);
  const unsigned long long E = wk.seg_end(s);
  unsigned long long x = s * kSegBits + j;
  Pair p{0ull, 0ull};
  uint32_t* slot = wk.slots + g * wk.slot;
  uint32_t* buf = sbuf + 9 * threadIdx.x;
  // the slot is written in whole 32-byte sectors, 8 entries at a time
  auto flush = [&](unsigned long long at) {
    uint4* d = reinterpret_cast<uint4*>(slot + at);
    d[0] = make_uint4(buf[0], buf[1], buf[2], buf[3]);
    d[1] = make_uint4(buf[4], buf[5], buf[6], buf[7]);
  };
  while (x < E) {
    const unsigned long long z = bits.zero_in(x, E);
    if (z == E) {  // the unary run of a code whose stop bit is past the segment
      p.adv += (E - x) << wk.b;
      break;
    }
    const uint32_t rs = bits.bits(z + 1, wk.b + 1);  // remainder, then sign
    p.adv += ((z - x) << wk.b) + (rs & ((1u << wk.b) - 1u)) + 1;
    // the position past the segment's first; a shipped code's is < 2^31
    buf[p.cnt & 7] = static_cast<uint32_t>((p.adv - 1) << 1) | (rs >> wk.b);
    if ((++p.cnt & 7) == 0) flush(p.cnt - 8);
    x = z + 2 + wk.b;
  }
  if (p.cnt & 7) flush(p.cnt & ~7ull);
  wk.pair[g] = p;
  wk.cls[g] = static_cast<uint8_t>(j);
  if (s + 1 < wk.ns) {
    const unsigned int out_cls = x >= E ? static_cast<unsigned int>(x - E) : 0u;
    if (scanned(tabs, tabt, g + 1, op).at(0) != out_cls) atomicAdd(wk.stats, 1ull);
  }
}

__global__ void __launch_bounds__(kDecThreads) mark_pass(Work wk) {
  const long long g = static_cast<long long>(blockIdx.x) * kDecThreads + threadIdx.x;
  if (g >= wk.total()) return;
  const int i = static_cast<int>(g / wk.ns);
  if (wk.header(i)[0] == 0u) return;
  const SumOp op;
  const Pair base = scanned(wk.pair, wk.pairt, i * wk.ns, op);
  const Pair at = scanned(wk.pair, wk.pairt, g, op);
  const Pair next = scanned(wk.pair, wk.pairt, g + 1, op);
  const unsigned long long a0 = at.adv - base.adv;
  const unsigned long long a1 = next.adv - base.adv;
  const unsigned long long k0 = at.cnt - base.cnt;
  wk.rec[g] = SegRec{a0, static_cast<unsigned int>(k0), wk.cls[g],
                     static_cast<unsigned short>(next.cnt - at.cnt)};
  const unsigned long long shipped = wk.header(i)[0];
  if (k0 < shipped && shipped <= next.cnt - base.cnt) {
    wk.last[i] = static_cast<unsigned int>(g - i * wk.ns) + 1u;
  }
  // the tiles whose first coordinate lies in [a0, a1)
  const unsigned long long lim = static_cast<unsigned long long>(wk.tiles) + 1;
  unsigned long long t1 = (a1 + kOutTile - 1) / kOutTile;
  if (t1 > lim) t1 = lim;
  unsigned int* first = wk.first + i * lim;
  for (unsigned long long t = (a0 + kOutTile - 1) / kOutTile; t < t1; ++t) {
    first[t] = static_cast<unsigned int>(g - i * wk.ns) + 1u;
  }
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(kEmitThreads, kEmitBlocks)
emit_tiles(Work wk, const float* __restrict__ weights, void* __restrict__ out, long long n) {
  // each coordinate's voters among the group's messages: bit k of votes[c]
  // for message g0 + k voting +1, bit 16 + k for -1
  __shared__ __align__(16) uint32_t votes[kOutTile];
  __shared__ long long seg0[kGroup];
  __shared__ int pre[kGroup + 1];
  __shared__ unsigned int shipped[kGroup];
  __shared__ float wsh[kGroup];
  // a chunk of the tile's segments, a thread each: first position, slot,
  // message, and the first of its shipped codes in the chunk's order
  __shared__ unsigned long long it_adv[kEmitThreads], it_slot[kEmitThreads];
  __shared__ unsigned int it_pre[kEmitThreads];
  __shared__ unsigned char it_msg[kEmitThreads];
  using Acc = typename std::conditional<WEIGHTED, float, int>::type;
  const long long tile = blockIdx.x;
  const unsigned long long lo = static_cast<unsigned long long>(tile) * kOutTile;
  const unsigned long long hi = lo + kOutTile < static_cast<unsigned long long>(n)
                                    ? lo + kOutTile : static_cast<unsigned long long>(n);
  const int t = threadIdx.x;
  // this thread's coordinates: lo + q * kSpan + 4 t + e, q < 4, e < 4
  Acc acc[kPerThread];
#pragma unroll
  for (int c = 0; c < kPerThread; ++c) acc[c] = Acc(0);
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    *reinterpret_cast<uint4*>(&votes[q * kSpan + 4 * t]) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int g0 = 0; g0 < wk.m; g0 += kGroup) {
    const int group = wk.m - g0 < kGroup ? wk.m - g0 : kGroup;
    __syncthreads();  // the masks are clear
    if (t < group) {
      const int i = g0 + t;
      long long f = 0, cnt = 0;
      const unsigned int* fi = wk.first + i * (wk.tiles + 1);
      const unsigned int sent = wk.header(i)[0], a = fi[tile], z = fi[tile + 1];
      const long long end = static_cast<long long>(wk.last[i]) - 1;
      if (sent != 0u && a) {  // the tile's segments, up to the one holding the last shipped code
        f = a - 1;
        const long long l = z ? static_cast<long long>(z) - 1 : wk.ns - 1;
        cnt = (l < end ? l : end) - f + 1;
        if (cnt < 0) cnt = 0;
      }
      seg0[t] = f;
      pre[t + 1] = static_cast<int>(cnt);
      shipped[t] = sent;
      if (WEIGHTED) wsh[t] = weights[i];
    }
    __syncthreads();
    if (t == 0) {
      pre[0] = 0;
      for (int k = 1; k <= group; ++k) pre[k] += pre[k - 1];
    }
    __syncthreads();
    for (int c0 = 0; c0 < pre[group]; c0 += kEmitThreads) {
      unsigned int valid = 0;
      if (c0 + t < pre[group]) {
        int k = 0;
        while (c0 + t >= pre[k + 1]) ++k;
        const long long g = (g0 + k) * wk.ns + seg0[k] + (c0 + t - pre[k]);
        const SegRec r = wk.rec[g];
        if (r.cnt < shipped[k]) valid = min(static_cast<unsigned int>(r.own), shipped[k] - r.cnt);
        it_adv[t] = r.adv;
        it_slot[t] = static_cast<unsigned long long>(g) * wk.slot;
        it_msg[t] = static_cast<unsigned char>(k);
      }
      unsigned int codes;
      const unsigned int before = block_exclusive_scan(valid, AddOp{}, &codes);
      it_pre[t] = before;
      __syncthreads();
      const int nit = pre[group] - c0 < kEmitThreads ? pre[group] - c0 : kEmitThreads;
      for (unsigned int q = t; q < codes; q += kEmitThreads) {
        int a = 0, z = nit - 1;  // the last segment whose first code is at or before q
        while (a < z) {
          const int mid = (a + z + 1) >> 1;
          if (it_pre[mid] <= q) a = mid; else z = mid - 1;
        }
        const uint32_t v = wk.slots[it_slot[a] + (q - it_pre[a])];
        const unsigned long long pos = it_adv[a] + (v >> 1);
        if (pos >= lo && pos < hi) atomicOr(&votes[pos - lo], 1u << (it_msg[a] + 16 * (v & 1u)));
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      uint4* pv = reinterpret_cast<uint4*>(&votes[q * kSpan + 4 * t]);
      const uint4 u = *pv;
      const uint32_t us[4] = {u.x & 0xFFFFu, u.y & 0xFFFFu, u.z & 0xFFFFu, u.w & 0xFFFFu};
      const uint32_t ds[4] = {u.x >> 16, u.y >> 16, u.z >> 16, u.w >> 16};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (WEIGHTED) {  // worker order
          for (uint32_t voters = us[e] | ds[e]; voters; voters &= voters - 1) {
            const int k = __ffs(voters) - 1;
            acc[4 * q + e] = __fadd_rn(acc[4 * q + e],
                                       __fmul_rn((ds[e] >> k) & 1u ? -1.0f : 1.0f, wsh[k]));
          }
        } else {
          acc[4 * q + e] += __popc(us[e]) - __popc(ds[e]);
        }
      }
      *pv = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  Acc* o = static_cast<Acc*>(out);
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const unsigned long long c = lo + q * kSpan + 4 * t;
    if (c + 4 <= hi) {
      Vec<Acc, 4> v;
#pragma unroll
      for (int e = 0; e < 4; ++e) v.v[e] = acc[4 * q + e];
      *reinterpret_cast<Vec<Acc, 4>*>(o + c) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < hi) o[c + e] = acc[4 * q + e];
    }
  }
}

inline long long segments_for(long long rows) {
  return (body_bits(rows) + static_cast<long long>(kSegBits) - 1) /
         static_cast<long long>(kSegBits);
}

inline long long tiles_for(long long n) { return (n + kOutTile - 1) / kOutTile; }

// A segment's slot: the most codes it can own (its stop bits are at least
// b + 2 apart), in whole 32-byte sectors.
inline int slot_codes(int b) { return (static_cast<int>(kSegBits) / (b + 2) + 1 + 7) / 8 * 8; }

// Lays the scratch buffer out; returns its size in bytes. Its first `*zeroed`
// bytes (stats and the tiles' first segments) are zeroed each launch.
inline long long layout(Work* wk, void* scratch, int m, long long rows, long long n, int b,
                        long long* zeroed) {
  const long long tot = m * segments_for(rows);
  const long long tiles = tiles_for(n);
  char* p = static_cast<char*>(scratch);
  long long off = 0;
  auto take = [&](long long bytes) {
    char* q = p ? p + off : nullptr;
    off += (bytes + 31) / 32 * 32;
    return q;
  };
  wk->stats = reinterpret_cast<unsigned long long*>(take(8));
  wk->first = reinterpret_cast<unsigned int*>(take(4 * m * (tiles + 1)));
  wk->last = reinterpret_cast<unsigned int*>(take(4 * m));
  *zeroed = off;
  const int words = tab_words(b);
  wk->tab = reinterpret_cast<uint32_t*>(take(4 * words * tot));
  wk->tabt = reinterpret_cast<uint32_t*>(take(4 * words * scan_blocks_for(tot)));
  wk->cls = reinterpret_cast<uint8_t*>(take(tot));
  wk->pair = reinterpret_cast<Pair*>(take(16 * (tot + 1)));
  wk->pairt = reinterpret_cast<Pair*>(take(16 * scan_blocks_for(tot + 1)));
  wk->rec = reinterpret_cast<SegRec*>(take(16 * tot));
  wk->slot = slot_codes(b);
  wk->slots = reinterpret_cast<uint32_t*>(take(4ll * wk->slot * tot));
  return off;
}

template <int W>
cudaError_t index_passes(const Work& wk, cudaStream_t s) {
  const long long tot = wk.total();
  const unsigned grid = static_cast<unsigned>(wk.m * wk.blocks_a_message());
  Tab<W>* tab = reinterpret_cast<Tab<W>*>(wk.tab);
  class_pass<W><<<grid, kDecThreads, 0, s>>>(wk);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = exclusive_scan(tab, tab, reinterpret_cast<Tab<W>*>(wk.tabt), tot, TabOp<W>{wk.b + 2}, s);
  }
  if (err != cudaSuccess) return err;
  count_pass<W><<<grid, kDecThreads, 0, s>>>(wk);
  return cudaGetLastError();
}

}  // namespace

// Scratch bytes ungolomb_launch needs for m messages of `rows` rows summed
// into n coordinates with Rice parameter b.
extern "C" long long ungolomb_scratch_bytes(int m, long long rows, long long n, int b) {
  Work wk{};
  long long zeroed;
  return layout(&wk, nullptr, m, rows, n, b, &zeroed);
}

// gathered: uint8[m, rows, 128], 4-byte aligned; weights: float32[m] for the
// weighted sum, null for the integer one; out: int32 or float32 [n], 16-byte
// aligned; scratch: ungolomb_scratch_bytes(m, rows, n, b), 16-byte aligned;
// stats: uint64[1] (segments whose decoded exit is not the next one's entry:
// 0) or null. 0 <= b <= 30.
extern "C" int ungolomb_launch(const void* gathered, const void* weights, void* out,
                               void* scratch, void* stats, int m, long long rows, long long n,
                               int b, void* stream) {
  if (m <= 0 || rows <= 0 || n <= 0) return 0;
  if (!aligned(gathered, 4) || !aligned(out, 16) || !aligned(scratch, 16)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (b < 0 || b > 30) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Work wk{};
  wk.msgs = static_cast<const uint32_t*>(gathered);
  wk.rows = rows;
  wk.m = m;
  wk.ns = segments_for(rows);
  wk.b = b;
  wk.nb = static_cast<unsigned long long>(body_bits(rows));
  wk.tiles = tiles_for(n);
  long long zeroed;
  layout(&wk, scratch, m, rows, n, b, &zeroed);
  const long long tot = m * wk.ns;
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(zeroed), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words = tab_words(b);
  err = words == 1 ? index_passes<1>(wk, s)
                   : (words == 2 ? index_passes<2>(wk, s) : index_passes<6>(wk, s));
  if (err == cudaSuccess) err = exclusive_scan(wk.pair, wk.pair, wk.pairt, tot + 1, SumOp{}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_pass<<<static_cast<unsigned>((tot + kDecThreads - 1) / kDecThreads), kDecThreads, 0,
              s>>>(wk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (weights) {
    emit_tiles<true><<<static_cast<unsigned>(wk.tiles), kEmitThreads, 0, s>>>(
        wk, static_cast<const float*>(weights), out, n);
  } else {
    emit_tiles<false><<<static_cast<unsigned>(wk.tiles), kEmitThreads, 0, s>>>(
        wk, nullptr, out, n);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess && stats) {
    err = cudaMemcpyAsync(stats, wk.stats, 8, cudaMemcpyDeviceToDevice, s);
  }
  return static_cast<int>(err);
}
