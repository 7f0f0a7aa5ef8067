// The tile walker of the fused wire encoders, one frame for both wires:
// pack2_encode.cuh's 2-bit encoders (sparsign_pack2bit.cu, ternary.cu) and
// pack8.cu's qsgd8 encoder each supply an encoder type Enc, and this header
// walks the message's tiles for it. A second frame, at the end, walks a
// message of many rows for int8_encode.cuh's encoder (rows 1 and 4).
//
// The frame: a persistent grid (the blocks that fit on the card at once, the
// count cached per instantiation), each block walking the tiles of the
// canonical (rows, 512) view in a stride of the grid. While a thread encodes
// one tile, its 16-byte loads of its next tile are in flight, in registers.
// Only the tiles past the last whole tile of data (the one that holds
// coordinate n - 1, and the canonical pad) load element by element and test
// pos < n; when g is not 16-byte aligned every tile does. On the H100 the
// register prefetch was as fast as a ring of shared-memory stages filled by a
// producer warp with cp.async.bulk, and faster for the rules with the most
// arithmetic (PERF.md, the 2-bit encoders' findings).
//
// What an encoder Enc provides:
//   In                       the gradient's element type
//   State                    its per-message constants: trivially copyable,
//                            with static State make(uint32_t seed, float param),
//                            built once a block by thread 0 from device memory
//   Chunk                    a thread's coordinates of one tile, in registers
//   Lane, lane()             the thread's place in a tile; lane().off is the
//                            offset of its first coordinate
//   kTileRows, kTileCoords   a tile's canonical rows and coordinates
//   kMinBlocks, kOutAlign    blocks an SM (__launch_bounds__), and the output
//                            alignment its stores need
//   load_full(c, g, i)       the thread's coordinates of the whole tile whose
//                            thread offset is i, 16-byte loads
//   load_edge(c, g, tile, lane, n)
//                            the same element by element, values past n as 0
//   store<kMasked, kMap>(state, c, out, tile, lane, n, counter_base, map)
//                            encode and write the chunk's wire bytes; with a
//                            MapMode other than kNoMap, coordinate i draws
//                            counter_base + map.offset(i) (CounterMap), else
//                            counter_base + i
//
// A model rank's slice of a leaf (the *_map_launch entry points) draws the
// counters of the whole leaf's coordinates, as sparsign.cu's map does: slice
// coordinate i takes counter_base + i + (i / run) * skip. An encoder splits
// a thread's first coordinate of a tile once (one division) and steps the
// quotient to its later groups; a group of consecutive coordinates (8 or 16)
// crosses at most one run's end when run is at least 16 (kRunMap). A
// shorter run (a tiny leaf's slice) takes kShortRunMap: one division a
// coordinate. kNoMap is the contiguous walker, code for code.
#pragma once

#include "common.cuh"

namespace repro {

enum MapMode : int { kNoMap = 0, kRunMap = 1, kShortRunMap = 2 };
constexpr long long kMinRunMapRun = 16;   // kRunMap's shortest run

// The counter map of a slice: run, the slice's contiguous run, and skip, the
// leaf's run less the slice's (mod 2^32).
struct CounterMap {
  long long run;
  uint32_t skip;

  // the counter of coordinate i less counter_base (kShortRunMap's, a division)
  __device__ __forceinline__ uint32_t offset(long long i) const {
    return static_cast<uint32_t>(i) + static_cast<uint32_t>(i / run) * skip;
  }

  // coordinate i = q run + r
  __device__ __forceinline__ void split(long long i, long long& q, long long& r) const {
    q = i / run;
    r = i - q * run;
  }

  // (q, r) of coordinate i advanced by d >= 0
  __device__ __forceinline__ void advance(long long& q, long long& r, long long d) const {
    r += d;
    while (r >= run) {
      r -= run;
      ++q;
    }
  }

  // the group of consecutive coordinates from i = q run + r: a of its first
  // coordinate (its counter times RNG_GOLDEN), and the first index e of the
  // group past the run's end, where skip joins the counter
  __device__ __forceinline__ void group(uint32_t counter_base, long long i, long long q,
                                        long long r, uint32_t& a, int& cross) const {
    a = (counter_base + static_cast<uint32_t>(i) + static_cast<uint32_t>(q) * skip) *
        RNG_GOLDEN;
    const long long left = run - r;
    cross = left < 64 ? static_cast<int>(left) : 64;
  }
};

// The tiles past the last whole tile of data. (Written as a loop in
// encode_kernel's body on the kernel's own offset, the same code took 71
// registers for noisy_sign where this takes 60, and noisy_sign ran 6 % and
// stochastic_ternary 2.5 % slower on the H100: PERF.md.)
template <class Enc, int kMap>
__device__ __forceinline__ void encode_edge_tiles(const typename Enc::State& state,
                                                  const typename Enc::In* __restrict__ g,
                                                  uint8_t* __restrict__ out, long long t,
                                                  long long tiles, long long n,
                                                  uint32_t counter_base, CounterMap map) {
  const typename Enc::Lane lane = Enc::lane();
  for (; t < tiles; t += gridDim.x) {
    typename Enc::Chunk c;
    Enc::load_edge(c, g, t, lane, n);
    Enc::template store<true, kMap>(state, c, out, t, lane, n, counter_base, map);
  }
}

// Register prefetch: tile t + gridDim.x's loads are issued before tile t is
// encoded. full_tiles: the tiles wholly inside the data (0 when g is not
// 16-byte aligned), tiles: rows / Enc::kTileRows.
template <class Enc, int kMap>
__global__ void __launch_bounds__(kThreads, Enc::kMinBlocks)
encode_kernel(const typename Enc::In* __restrict__ g, uint8_t* __restrict__ out,
              const long long* __restrict__ seed, const float* __restrict__ param, long long n,
              long long tiles, long long full_tiles, uint32_t counter_base, CounterMap map) {
  __shared__ typename Enc::State shared_state;
  if (threadIdx.x == 0)
    shared_state = Enc::State::make(static_cast<uint32_t>(seed[0]), param[0]);
  __syncthreads();
  const typename Enc::State state = shared_state;
  const typename Enc::Lane lane = Enc::lane();
  long long t = blockIdx.x;
  typename Enc::Chunk next;
  if (t < full_tiles) Enc::load_full(next, g, t * Enc::kTileCoords + lane.off);
  for (; t < full_tiles; t += gridDim.x) {
    const typename Enc::Chunk cur = next;
    if (t + gridDim.x < full_tiles)
      Enc::load_full(next, g, (t + gridDim.x) * Enc::kTileCoords + lane.off);
    Enc::template store<false, kMap>(state, cur, out, t, lane, n, counter_base, map);
  }
  encode_edge_tiles<Enc, kMap>(state, g, out, t, tiles, n, counter_base, map);
}

// Launch the encoder of one message on the current stream. g: n contiguous
// values; out: the wire of rows canonical rows, rows = canonical_rows(n), a
// multiple of 32; seed: int64[1] holding a uint32 value; param: float32[1];
// with kMap, map.run >= 1 (a slice's counters, CounterMap): kRunMap from
// kMinRunMapRun on, kShortRunMap below.
// static: each library that includes this header (sparsign_pack2bit.cu,
// ternary.cu, pack8.cu) keeps its own cached grid size, where an inline
// function's static would be one GNU_UNIQUE object shared by every library
// loaded in the process (a library once launched with another's cache so).
template <class Enc, int kMap>
static int launch_mode(const void* g, void* out, const void* seed, const void* param,
                       long long n, long long rows, unsigned int counter_base,
                       cudaStream_t stream, CounterMap map) {
  if (!aligned(out, Enc::kOutAlign)) return static_cast<int>(cudaErrorMisalignedAddress);
  static int grid_cap = 0;  // blocks that fit on the card at once, per instantiation
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, encode_kernel<Enc, kMap>, kThreads,
                                                  0);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = rows / Enc::kTileRows;
  const long long full_tiles = aligned(g, 16) ? n / Enc::kTileCoords : 0;
  const unsigned int grid = static_cast<unsigned int>(tiles < grid_cap ? tiles : grid_cap);
  encode_kernel<Enc, kMap><<<grid, kThreads, 0, stream>>>(
      static_cast<const typename Enc::In*>(g), static_cast<uint8_t*>(out),
      static_cast<const long long*>(seed), static_cast<const float*>(param), n, tiles,
      full_tiles, counter_base, map);
  return static_cast<int>(cudaGetLastError());
}

template <class Enc, bool kMap = false>
static int launch_encode(const void* g, void* out, const void* seed, const void* param,
                         long long n, long long rows, unsigned int counter_base,
                         cudaStream_t stream, CounterMap map = {1, 0u}) {
  if constexpr (!kMap) {
    return launch_mode<Enc, kNoMap>(g, out, seed, param, n, rows, counter_base, stream, map);
  } else {
    if (map.run < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (map.run >= kMinRunMapRun)
      return launch_mode<Enc, kRunMap>(g, out, seed, param, n, rows, counter_base, stream, map);
    return launch_mode<Enc, kShortRunMap>(g, out, seed, param, n, rows, counter_base, stream,
                                          map);
  }
}

// ---------------------------------------------------------------------------
// The same frame for a message of many rows (int8_encode.cuh's encoder, rows
// 1 and 4): `rows` rows of n coordinates each, contiguous, row r drawing from
// seeds[r] and param[r] (or param[0]) at counters counter_base + column. The
// tiles are flat over rows * n, so every tile's 16-byte loads and stores stay
// aligned whatever n is (an FL round's n = 545,002 f32 starts every other row
// 8 bytes off a 16-byte line); a tile knows its first row and column, stepped
// from tile to tile without a division, and a thread past a row's end inside
// a tile finds its own (rare: one thread in n / 16 for n above a tile). The
// rows' states are built once per row a block meets, by as many threads, into
// shared memory (kRowSlots rows from the tile's first: every row of a tile
// when n >= kTileCoords / (kRowSlots - 1)); only a row beyond the slots, a
// tile of a tiny n, is built by the thread that needs it.

constexpr int kRowSlots = 8;

// The rows a tile meets: its first coordinate is column c0 of row r0.
template <class State>
struct TileRows {
  long long r0, c0, n, rows;
  const State* slots;   // rows r0 .. r0 + kRowSlots - 1 (those below rows)
  const long long* __restrict__ seeds;
  const float* __restrict__ param;
  int param_per_row;

  __device__ __forceinline__ State state(long long r) const {
    return r - r0 < kRowSlots
               ? slots[r - r0]
               : State::make(static_cast<uint32_t>(seeds[r]), param[param_per_row ? r : 0]);
  }
  // row r and column c of the tile's coordinate o
  __device__ __forceinline__ void locate(long long o, long long& r, long long& c) const {
    r = r0;
    c = c0 + o;
    if (c >= n) {
      const long long q = c < 2 * n ? 1 : c / n;
      r += q;
      c -= q * n;
    }
  }
};

template <class Enc, int kMap>
__global__ void __launch_bounds__(kThreads, Enc::kMinBlocks)
encode_rows_kernel(const typename Enc::In* __restrict__ g, uint8_t* __restrict__ out,
                   const long long* __restrict__ seeds, const float* __restrict__ param,
                   int param_per_row, long long n, long long rows, long long tiles,
                   long long full_tiles, uint32_t counter_base, CounterMap map) {
  using State = typename Enc::State;
  __shared__ State slots[kRowSlots];
  const typename Enc::Lane lane = Enc::lane();
  const long long total = rows * n;
  // tile t's (r0, c0), and the grid's stride of tiles as sq rows and sr columns
  long long t = blockIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * Enc::kTileCoords;
  const long long sq = stride / n, sr = stride - sq * n;
  TileRows<State> tr{0, 0, n, rows, slots, seeds, param, param_per_row};
  tr.r0 = t * Enc::kTileCoords / n;
  tr.c0 = t * Enc::kTileCoords - tr.r0 * n;
  long long built = -1;   // the first row whose state the slots hold
  auto enter = [&]() {    // block-uniform: the tile's row states in the slots
    if (tr.r0 != built) {
      __syncthreads();    // the last tile's readers are done with the slots
      const long long r = tr.r0 + threadIdx.x;
      if (threadIdx.x < kRowSlots && r < rows)
        slots[threadIdx.x] = State::make(static_cast<uint32_t>(seeds[r]),
                                         param[param_per_row ? r : 0]);
      __syncthreads();
      built = tr.r0;
    }
  };
  auto step = [&]() {
    tr.r0 += sq;
    tr.c0 += sr;
    if (tr.c0 >= n) {
      tr.c0 -= n;
      ++tr.r0;
    }
  };
  typename Enc::Chunk next;
  if (t < full_tiles) Enc::load_full(next, g, t * Enc::kTileCoords + lane.off);
  for (; t < full_tiles; t += gridDim.x) {
    const typename Enc::Chunk cur = next;
    if (t + gridDim.x < full_tiles)
      Enc::load_full(next, g, (t + gridDim.x) * Enc::kTileCoords + lane.off);
    enter();
    Enc::template store<false, kMap>(tr, cur, out, t, lane, total, counter_base, map);
    step();
  }
  for (; t < tiles; t += gridDim.x) {
    typename Enc::Chunk c;
    Enc::load_edge(c, g, t, lane, total);
    enter();
    Enc::template store<true, kMap>(tr, c, out, t, lane, total, counter_base, map);
    step();
  }
}

// Launch the encoder of `rows` rows of n contiguous values. out: rows * n
// bytes; seeds: int64[rows] holding uint32 values; param: float32[rows] when
// param_per_row, else float32[1]; map as launch_encode's.
template <class Enc, int kMap>
static int launch_rows_mode(const void* g, void* out, const void* seeds, const void* param,
                            int param_per_row, long long rows, long long n,
                            unsigned int counter_base, cudaStream_t stream, CounterMap map) {
  if (!aligned(out, Enc::kOutAlign)) return static_cast<int>(cudaErrorMisalignedAddress);
  static int grid_cap = 0;  // blocks that fit on the card at once, per instantiation
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, encode_rows_kernel<Enc, kMap>,
                                                  kThreads, 0);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long total = rows * n;
  const long long tiles = (total + Enc::kTileCoords - 1) / Enc::kTileCoords;
  const long long full_tiles = aligned(g, 16) ? total / Enc::kTileCoords : 0;
  const unsigned int grid = static_cast<unsigned int>(tiles < grid_cap ? tiles : grid_cap);
  encode_rows_kernel<Enc, kMap><<<grid, kThreads, 0, stream>>>(
      static_cast<const typename Enc::In*>(g), static_cast<uint8_t*>(out),
      static_cast<const long long*>(seeds), static_cast<const float*>(param), param_per_row, n,
      rows, tiles, full_tiles, counter_base, map);
  return static_cast<int>(cudaGetLastError());
}

template <class Enc, bool kMap = false>
static int launch_encode_rows(const void* g, void* out, const void* seeds, const void* param,
                              int param_per_row, long long rows, long long n,
                              unsigned int counter_base, cudaStream_t stream,
                              CounterMap map = {1, 0u}) {
  if constexpr (!kMap) {
    return launch_rows_mode<Enc, kNoMap>(g, out, seeds, param, param_per_row, rows, n,
                                         counter_base, stream, map);
  } else {
    if (map.run < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (map.run >= kMinRunMapRun)
      return launch_rows_mode<Enc, kRunMap>(g, out, seeds, param, param_per_row, rows, n,
                                            counter_base, stream, map);
    return launch_rows_mode<Enc, kShortRunMap>(g, out, seeds, param, param_per_row, rows, n,
                                               counter_base, stream, map);
  }
}

}  // namespace repro
