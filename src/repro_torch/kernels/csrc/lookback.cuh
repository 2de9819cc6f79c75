// One-sweep stable compaction with decoupled look-back, shared by
// hash_join.cu (probe_join), part_probe.cu and select_scan.cu
// (select_scan, select_scan_packed).
//
// The Pallas kernels these replace (src/repro/kernels/hash_join.py::
// probe_join, part_probe.py::part_probe, select_scan.py::select_scan and
// select_scan_packed) find a tile's matches, compact them and carry the
// running output offset in SMEM across a grid that runs in order.  Hopper
// blocks run in any order, so here the carried offset is a tile's
// exclusive prefix found by decoupled look-back.  One launch of resident
// blocks; each block loops (`sweep`):
//
//   1. take a tile from a ticket counter (not blockIdx: every tile a
//      block waits on then belongs to a block already running, so the
//      look-back cannot deadlock);
//   2. the stage finds the tile's matches and writes each warp's in row
//      order into its region of the block's stash (the warp's rows are
//      neighbours, so a warp's matches follow the warps' before it), and
//      the tile's count is published in its status word;
//   3. finish the block's previous tile: its prefix by look-back over the
//      status words of the tiles before it (they had this tile's time to
//      publish, so the walk seldom waits), each warp's matches copied from
//      the other stash to prefix + the counts of the warps before it +
//      rank (neighbouring threads write neighbouring places), and its
//      misses' share of the zeros past the count.
//
// Two stages: the probe (`ProbeTile`, below) and the selection
// (select_scan.cu's `SelectTile`).  The probe stage loads kProbeItems rows
// a thread (a warp holds 32 neighbouring rows a step, so loads are
// coalesced) and walks every row's probe once: the home slot of every row
// at once, then the runs past it for the rows still walking, kProbeGroup
// rows' runs at a time (hash.cuh's home_slot / load_run / read_run).  A
// hit's slot goes to the row's place in shared memory, not to a
// register; then every hit's payload and row data load at once, and the
// warp's hits go to its region in row order (a ballot a row step).
//
// A row's output place depends only on the data, so the output is stable
// and the same bits on every run, whatever order blocks run in.  The zero
// tail: the misses of the tiles before a tile (its first row - its
// prefix) fill [n - that, n) between them, so its own misses take the
// span just below, and the spans cover [count, n) once.
//
// The probe's shape (8 rows a thread, 2 rows' runs in flight, 4 blocks an
// SM at 64 registers, 32-byte runs) was chosen by timing shapes on an
// H100: more rows or runs in flight a thread cost registers, and the
// spills and the lost blocks cost more than the latency they hide.
//
// Status words: one 32-bit word a tile, 0 = not yet published; an
// aggregate is the tile's count + 1 (a tile holds far fewer than 2^31
// rows, so bit 31 is clear); an inclusive prefix is bit 31 | the prefix
// (n < 2^31, so it fits in 31 bits).  The launcher clears the words and
// the ticket behind them with one cudaMemsetAsync.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kProbeItems = 8;              // rows a thread
constexpr int kProbeGroup = 2;              // rows whose runs load at once
constexpr int kProbeBlocks = 4;             // blocks an SM (64 registers)
constexpr long long kProbeTile =
    static_cast<long long>(kSweepThreads) * kProbeItems;
constexpr unsigned kLanes = 0xffffffffu;
constexpr unsigned kPrefixFlag = 0x80000000u;   // status: inclusive prefix
static_assert(kProbeItems % kProbeGroup == 0, "whole groups of rows");
static_assert(kProbeItems <= 32, "a row's flags are the bits of a word");

// Sum of `v` over a warp, to every lane.
__device__ __forceinline__ unsigned warp_total(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kLanes, v, off);
  return v;
}

// Publishes tile `tile`'s count: an inclusive prefix for tile 0, else an
// aggregate.  One thread calls it.
__device__ __forceinline__ void publish(unsigned* status, long long tile,
                                        unsigned count) {
  reinterpret_cast<volatile unsigned*>(status)[tile] =
      tile == 0 ? kPrefixFlag | count : count + 1u;
}

// The sum of the counts of the tiles before `tile`, whose own count is
// published; publishes its inclusive prefix.  Every lane of one warp
// calls it.  The 32 lanes read the status words of the 32 nearest
// earlier tiles at once, each waiting until its word is published; the
// nearest inclusive prefix ends the walk, else the window moves 32 tiles
// back.
__device__ __forceinline__ unsigned tile_prefix(unsigned* status,
                                                long long tile,
                                                unsigned count) {
  if (tile == 0) return 0u;
  const int lane = threadIdx.x & 31;
  volatile unsigned* vs = status;
  unsigned before = 0;
  for (long long nearest = tile - 1;; nearest -= 32) {
    const long long pred = nearest - lane;
    unsigned word = kPrefixFlag;                // before tile 0: prefix 0
    if (pred >= 0) {
      do {
        word = vs[pred];
      } while (word == 0u);
    }
    const unsigned inclusive = __ballot_sync(kLanes, word & kPrefixFlag);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    const unsigned v = lane > stop ? 0u
                       : (word & kPrefixFlag) ? word & ~kPrefixFlag
                                              : word - 1u;
    before += warp_total(v);
    if (inclusive) break;
  }
  if (lane == 0) vs[tile] = kPrefixFlag | (before + count);
  return before;
}

// Slots a probe step reads (W) in a table, or a row of packed tables, of
// mask + 1 slots at `htk`: 8 (32 bytes), fewer for a smaller table, or
// while the address is not a multiple of the run's bytes.
inline int run_slots(unsigned mask, const void* htk) {
  const unsigned long long slots = mask + 1ULL;
  int w = slots < 8 ? static_cast<int>(slots) : 8;
  while (w > 1 && reinterpret_cast<std::uintptr_t>(htk) % (4u * w) != 0)
    w >>= 1;
  return w;
}

// Blocks of a sweep kernel resident on the current device: the grid, as
// every block loops over tiles.
template <typename Kernel>
int sweep_blocks(Kernel kernel, long long* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kSweepThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(cudaSuccess);
}

// The block's tile before this one, finished: each warp's matches (in
// rank order in its region of the stash, `counts` of them) to before + the
// matches of the warps before it + rank, the tile's misses' zeros, and the
// count of all the matches if it is the last tile.  `stage.put(p, v)`
// writes output place p.
template <long long Tile, typename Stage, typename V>
__device__ __forceinline__ void finish_tile(const Stage& stage, unsigned n,
                                            unsigned tiles, unsigned tile,
                                            unsigned before, const V* stash,
                                            const int* counts,
                                            long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned at = before, count = 0;
#pragma unroll
  for (int w = 0; w < kSweepWarps; ++w) {
    at += w < warp ? counts[w] : 0;
    count += counts[w];
  }
  const V* mine = stash + warp * static_cast<int>(Tile / kSweepWarps);
  for (int k = lane; k < counts[warp]; k += 32) stage.put(at + k, mine[k]);
  const unsigned first = tile * static_cast<unsigned>(Tile);
  const unsigned rows = n - first < Tile ? n - first : Tile;
  const unsigned end = n - (first - before);
  for (unsigned p = end - (rows - count) + threadIdx.x; p < end;
       p += kSweepThreads)
    stage.put(p, V{});
  if (threadIdx.x == 0 && tile == tiles - 1) *total = before + count;
}

// Sums a block's per-warp counts.
__device__ __forceinline__ unsigned warps_total(const int* counts) {
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kSweepWarps; ++w) count += counts[w];
  return count;
}

// The sweep of one block over the tiles it takes, `Tile` rows each.
// `Stage` finds a tile's matches:
//   stage(tile, mine)   writes this warp's matches of tile `tile`, in row
//                       order, to mine[0..) (Tile / kSweepWarps places)
//                       and returns how many (the same in every lane);
//                       the rows of warp w precede those of warp w + 1
//   put(p, v)           writes output place p (V{} for a zero)
// `total`: the matches of all tiles, written by the block that finishes
// the last tile.  Two stashes: a tile's matches go into one while the
// tile before is copied out of the other.
template <long long Tile, typename V, typename Stage>
__device__ __forceinline__ void sweep(const Stage& stage, unsigned n,
                                      unsigned* status, unsigned* ticket,
                                      long long* total) {
  constexpr int kRegion = static_cast<int>(Tile / kSweepWarps);
  __shared__ V stash[2][Tile];
  __shared__ int warp_counts[2][kSweepWarps];
  __shared__ unsigned s_tile, s_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned tiles = (n + Tile - 1) / Tile;
  unsigned prev = tiles;                        // none yet
  int buf = 0;                                  // the stash this tile fills
  while (true) {
    // 1. the next tile
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned tile = s_tile;
    if (tile >= tiles) break;                   // uniform over the block

    // 2. the warp's matches into its region of the stash; the tile's
    // count published
    const int matches = stage(tile, stash[buf] + warp * kRegion);
    if (lane == 0) warp_counts[buf][warp] = matches;
    __syncthreads();

    // 3. the block's previous tile finished: its prefix by look-back
    if (warp == 0) {
      if (lane == 0) publish(status, tile, warps_total(warp_counts[buf]));
      if (prev < tiles) {
        const unsigned before = tile_prefix(
            status, prev, warps_total(warp_counts[buf ^ 1]));
        if (lane == 0) s_before = before;
      }
    }
    __syncthreads();
    if (prev < tiles)
      finish_tile<Tile>(stage, n, tiles, prev, s_before, stash[buf ^ 1],
                        warp_counts[buf ^ 1], total);
    prev = tile;
    buf ^= 1;
  }
  if (prev < tiles) {                           // the last tile taken
    if (warp == 0) {
      const unsigned before = tile_prefix(status, prev,
                                          warps_total(warp_counts[buf ^ 1]));
      if (lane == 0) s_before = before;
    }
    __syncthreads();
    finish_tile<Tile>(stage, n, tiles, prev, s_before, stash[buf ^ 1],
                      warp_counts[buf ^ 1], total);
  }
}

// The probe stage of a sweep.  `Op` names the probe:
//   limit()             rows at or past it never match (read once a block)
//   load(r, &key)       load row r's key; false when the row never matches
//   keys_of(key)        the table row the key probes
//   slot_of(key, s)     slot s of that row as an index into htv (< 2^32)
//   htv, mask           the payloads, the row's slots - 1
//   fetch(r)            what a hit of row r writes besides its payload
//                       (an Op::Extra)
//   result(p, e)        a hit's two outputs: p its payload, e its fetch
//   out_a, out_b        the two output columns
// W: slots a run step reads (hash.cuh).  `limit`: op.limit() cut to
// [0, n], in shared memory.
template <int W, typename Op>
struct ProbeTile {
  const Op& op;
  const unsigned* limit;

  __device__ __forceinline__ void put(unsigned p, int2 v) const {
    op.out_a[p] = v.x;
    op.out_b[p] = v.y;
  }

  __device__ __forceinline__ int operator()(unsigned tile, int2* mine) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned mask = op.mask;
    const unsigned lim = *limit;
    const unsigned first = tile * static_cast<unsigned>(kProbeTile) +
                           warp * 32 * kProbeItems + lane;

    // every row's key, then its home slot, then the runs past it; a hit's
    // slot goes to the row's place in the stash (its payload is loaded
    // with the rest of its outputs below)
    int key[kProbeItems];
    unsigned pending = 0u;
#pragma unroll
    for (int i = 0; i < kProbeItems; ++i) {
      const unsigned r = first + i * 32;
      key[i] = 0;
      if (r < lim && op.load(r, &key[i])) pending |= 1u << i;
    }
    unsigned hit = 0u;
    {
      int at_home[kProbeItems];
#pragma unroll
      for (int i = 0; i < kProbeItems; ++i)
        if (pending & (1u << i))
          at_home[i] = __ldg(op.keys_of(key[i]) + home_slot(key[i], mask));
#pragma unroll
      for (int i = 0; i < kProbeItems; ++i) {
        if (!(pending & (1u << i))) continue;
        if (at_home[i] == key[i]) {
          hit |= 1u << i;
          mine[i * 32 + lane].x = static_cast<int>(
              op.slot_of(key[i], home_slot(key[i], mask)));
        }
        if (at_home[i] == key[i] || at_home[i] == kEmpty)
          pending &= ~(1u << i);
      }
    }
    for (unsigned step = 0; pending; ++step) {
#pragma unroll
      for (int g = 0; g < kProbeItems; g += kProbeGroup) {
        if (!(pending & (((1u << kProbeGroup) - 1u) << g))) continue;
        SlotRun<W> run[kProbeGroup];
#pragma unroll
        for (int j = 0; j < kProbeGroup; ++j)
          if (pending & (1u << (g + j)))
            run[j] = load_run<W>(op.keys_of(key[g + j]),
                                 run_base<W>(key[g + j], mask, step));
#pragma unroll
        for (int j = 0; j < kProbeGroup; ++j) {
          const int i = g + j;
          if (!(pending & (1u << i))) continue;
          unsigned slot;
          const int res = read_run<W>(run[j], key[i], mask, step, &slot);
          if (res == kWalkOn) continue;
          pending &= ~(1u << i);
          if (res == kHit) {
            hit |= 1u << i;
            mine[i * 32 + lane].x = static_cast<int>(op.slot_of(key[i], slot));
          }
        }
      }
    }

    // the warp's hits in row order into its region (a ballot a row step),
    // their payloads and row data loaded first, all in flight at once
    int payload[kProbeItems];
    typename Op::Extra extra[kProbeItems];
#pragma unroll
    for (int i = 0; i < kProbeItems; ++i) {
      if (hit & (1u << i)) {
        payload[i] = __ldg(op.htv + static_cast<unsigned>(
                                        mine[i * 32 + lane].x));
        extra[i] = op.fetch(first + i * 32);
      }
    }
    __syncwarp();                               // the slots are read
    const unsigned below = (1u << lane) - 1u;
    int rank = 0;
#pragma unroll
    for (int i = 0; i < kProbeItems; ++i) {
      const unsigned ballot = __ballot_sync(kLanes, hit & (1u << i));
      if (hit & (1u << i))
        mine[rank + __popc(ballot & below)] = op.result(payload[i], extra[i]);
      rank += __popc(ballot);
    }
    return rank;
  }
};

// The probe sweep of one block (`ProbeTile`'s Op, W).
template <int W, typename Op>
__device__ __forceinline__ void probe_sweep(const Op& op, unsigned n,
                                            unsigned* status,
                                            unsigned* ticket,
                                            long long* total) {
  __shared__ unsigned s_limit;
  if (threadIdx.x == 0) {
    const long long lim = op.limit();
    s_limit = static_cast<unsigned>(lim < 0 ? 0 : lim < n ? lim : n);
  }
  sweep<kProbeTile, int2>(ProbeTile<W, Op>{op, &s_limit}, n, status, ticket,
                          total);
}

}  // namespace
