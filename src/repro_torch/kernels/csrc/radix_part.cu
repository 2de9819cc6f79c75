// Radix partitioning for Hopper (sm_90a): per-tile bucket histograms, the
// digit counts of every pass of a sort in one read, and a one-sweep stable
// partition pass of a key and up to three payload columns (paper §4.4;
// the partitioned join's shuffle and each pass of the LSB radix sort
// behind ORDER BY).
//
// Replaces the Pallas TPU kernels src/repro/kernels/radix_part.py::
// histogram (_hist_kernel) and partition_multi (_shuffle_kernel), and so
// radix_sort's passes.  A key's bucket is bits [start_bit, start_bit + r)
// of the key read as an unsigned word (a logical shift), r <= 8, so at
// most 256 buckets.
//
//   histogram: each tile of kTile = 2048 rows writes its 2^r counts to
//              its own row of a (n_tiles, 2^r) array, the reference's
//              layout (the partitioned join reads it).  A grid of resident
//              blocks walks the tiles, 16 bytes a load, the next tile's
//              loads issued before the current tile is counted, so loads
//              stay in flight while a block counts, syncs and writes.  Each
//              warp counts into its own counters in shared memory: for r
//              <= 5 each thread adds its rows into 4-bit fields of a
//              register and the warp adds the fields (one warp reduction a
//              pair of buckets); for wider r a warp adds each bucket once
//              (peers_of finds the lanes that share it, one ballot per
//              bucket bit).  Counts do not depend on the order of the
//              adds.
//   counts:    one read of the keys gives every pass's global digit
//              counts, a (passes, 2^r) array (passes x 2^r <= 1024): a
//              grid of resident blocks strides over the keys 16 bytes a
//              thread, each warp counts into its own shared copy (one add
//              for a digit all the warp's rows share, as the high digits
//              of small keys do, found from the warp's AND and OR of its
//              keys; else an atomic a row), and each
//              block adds its sums into the array with integer atomics,
//              whose order does not change the result.
//   sweep:     one launch a pass.  A block takes a tile id from a global
//              counter (not blockIdx, so every tile it waits on belongs to
//              a block already running: the look-back cannot deadlock)
//              and loads kSweepTile = 4096 contiguous rows, each warp 512
//              of them, 32 neighbouring rows a step.  Each row's rank
//              among its warp's rows of its bucket is taken in row order
//              (peers_of, __popc, and a per-warp running count in shared
//              memory); the warps' counts of a bucket, scanned, place the
//              warps' rows after one another.  The block publishes its
//              per-bucket counts (an "aggregate") in a status word per
//              tile and bucket, then one thread a bucket walks back over
//              the tiles before it, adding aggregates until it meets an
//              "inclusive" prefix, and publishes its own (decoupled
//              look-back).  A row goes to its bucket's global base (an
//              exclusive scan of the pass's digit counts, in the block)
//              + that prefix + its place among the tile's rows of the
//              bucket.  Positions depend only on the data and each row's
//              place in the input: the pass is stable and gives the same
//              bits on every run, whatever order blocks run in.  The tile
//              is first put in bucket order in shared memory, then written
//              out slot by slot, so neighbouring threads write
//              neighbouring places of a run.
//
// Status words: 32 bits, 0 = not yet published; an aggregate is its count
// + 1 (a tile holds at most 4096 rows, so bit 31 is clear); an inclusive
// prefix is bit 31 | the prefix (n < 2^31, so it fits in 31 bits).  The
// launcher clears the (n_tiles x 2^r) words and the tile counter behind
// them with one cudaMemsetAsync before each pass.
//
// What bounds it: device-memory bytes at 3.35 TB/s.  The histogram reads
// the keys once (4 bytes a row) and writes 4 * 2^r bytes a tile; a ballot
// and a shared atomic a row per bucket bit cost about as much issue time
// as the read at 3.35 TB/s, hence count_packed.  A pass's function
// moves the key and N payload columns once each way, (1 + N) * 8 bytes a
// row a pass.  The design adds the counts' read of the keys (4 bytes a row
// for all the passes of a sort) and the status words (4 bytes per bucket
// per 4096 rows, written once or twice and read by the few tiles that look
// back over them).  What it does about the rest: one launch a pass and no
// per-tile histogram or offsets array written by one launch and read back
// by another; runs of 16 rows a bucket on average at r = 8 (4096-row
// tiles), so a run fills more of each sector it writes; and a radix sort
// skips the passes in which one bucket holds every row (radix_part.py).
//
// Rows >= n count in no bucket and move nowhere.
#include <cuda_runtime.h>

#include <cstdint>

#include "compact.cuh"

namespace {

constexpr int kMaxBits = 8;
constexpr int kMaxBuckets = 1 << kMaxBits;
constexpr int kMaxVals = 3;
constexpr int kMaxCounters = 1024;             // passes x 2^r digit counts
constexpr int kSweepItems = 16;                // rows a thread in a sweep
constexpr int kWarpRows = 32 * kSweepItems;    // a warp's rows of a tile
constexpr long long kSweepTile = static_cast<long long>(kThreads) *
                                 kSweepItems;
constexpr unsigned kNoBucket = 0xffffffffu;    // rows >= n: no bucket
constexpr unsigned kInclusive = 0x80000000u;   // status: inclusive prefix
static_assert(kMaxBuckets <= kThreads, "one bucket a thread");

__device__ __forceinline__ unsigned bucket_of(int key, int start_bit,
                                              unsigned mask) {
  return (static_cast<unsigned>(key) >> start_bit) & mask;
}

// The lanes a lane with (valid) or without a row may share a bucket with:
// the lanes on its own side.  Every lane calls it.
__device__ __forceinline__ unsigned side_of(bool valid) {
  const unsigned live = __ballot_sync(kFull, valid);
  return valid ? live : ~live;
}

// The lanes of the warp whose bucket equals this lane's, as a mask: of
// the lanes in `peers` (side_of, or every lane when the warp's 32 lanes
// all hold a row), those that agree on each bucket bit, one ballot a bit
// (a warp multisplit, cheaper than __match_any_sync for r <= 8).  Every
// lane calls it.
__device__ __forceinline__ unsigned peers_of(unsigned b, unsigned peers,
                                             int r) {
  for (int k = 0; k < r; ++k) {
    const unsigned set = __ballot_sync(kFull, (b >> k) & 1u);
    peers &= (b >> k) & 1u ? set : ~set;
  }
  return peers;
}

// A thread's 8 rows of a histogram tile: rows 4j .. 4j + 3 and 1024 + 4j
// .. + 3 of the tile for thread j, so that a warp's 32 lanes read 512
// neighbouring bytes a load.
struct TileKeys {
  int4 lo, hi;
};

__device__ __forceinline__ long long tile_row(long long first, int i) {
  return first + (i >> 2) * (kTile / 2) + (i & 3);
}

// Tile t's keys for this thread: two 16-byte loads when the tile is whole
// and the keys are 16-byte aligned (`vec`), else eight 4-byte loads of
// the same rows, 0 past n.
__device__ __forceinline__ TileKeys load_tile(const int* __restrict__ keys,
                                              long long n, long long t,
                                              bool vec) {
  const long long first = t * kTile + 4 * threadIdx.x;
  TileKeys k;
  if (vec && (t + 1) * kTile <= n) {
    k.lo = __ldg(reinterpret_cast<const int4*>(keys + first));
    k.hi = __ldg(reinterpret_cast<const int4*>(keys + first + kTile / 2));
    return k;
  }
  int v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long row = tile_row(first, i);
    v[i] = row < n ? __ldg(keys + row) : 0;
  }
  k.lo = make_int4(v[0], v[1], v[2], v[3]);
  k.hi = make_int4(v[4], v[5], v[6], v[7]);
  return k;
}

// A warp's counts of a tile's rows for r <= 5 (the partitioned join's
// widths), without a ballot or an atomic a row: each thread adds its 8
// rows into 4-bit fields of A 64-bit registers, bucket b at field b & 15
// of register b >> 4 (a field holds at most 8); then field pairs spread
// to 16 bits are added over the warp (__reduce_add_sync, one a pair of
// buckets), and lane b stores the warp's count of bucket b.  Every lane
// calls it.
template <int A>
__device__ __forceinline__ void count_packed(int* counts,
                                             const int (&key)[kItems],
                                             long long first, long long n,
                                             bool whole, int start_bit,
                                             unsigned mask) {
  const int nb = static_cast<int>(mask) + 1;
  const int lane = threadIdx.x & 31;
  unsigned long long acc[A] = {};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (!whole && tile_row(first, i) >= n) continue;
    const unsigned b = bucket_of(key[i], start_bit, mask);
    const unsigned long long one = 1ull << ((b & 15u) << 2);
#pragma unroll
    for (int a = 0; a < A; ++a) acc[a] += b >> 4 == static_cast<unsigned>(a)
                                              ? one : 0ull;
  }
  // pair q holds buckets (q & 3) + 8 * (q >> 2) and 4 more, at bits 0
  // and 16: register q >> 3, its high word when (q >> 2) is odd
  const int mine_q = (lane & 3) + 4 * (lane >> 3);
  unsigned mine = 0;
#pragma unroll
  for (int q = 0; q < 8 * A; ++q) {
    if ((q & 3) + 8 * (q >> 2) >= nb) continue;       // uniform
    const unsigned long long a = acc[q >> 3];
    const unsigned word = static_cast<unsigned>((q >> 2) & 1 ? a >> 32 : a);
    const unsigned pair = __reduce_add_sync(
        kFull, (word >> (4 * (q & 3))) & 0x000F000Fu);
    if (q == mine_q) mine = lane & 4 ? pair >> 16 : pair & 0xFFFFu;
  }
  if (lane < nb) counts[lane] = static_cast<int>(mine);
}

// Resident blocks walk the tiles t = blockIdx.x, t + gridDim.x, ...; each
// tile's 2^r counts go to its own row of a (n_tiles, 2^r) array, the
// reference's layout (the partitioned join reads it).  A block issues the
// next tile's loads before it counts the current one, so its loads stay in
// flight across the count, the sync and the row write.  Each warp counts
// into its own counters in shared memory (count_packed for r <= 5; else
// it adds each bucket once a step: peers_of finds the lanes that share
// it, one ballot per bucket bit), so warps never contend on a hot bucket,
// and none waits on another's count; after one sync thread b adds the
// warps' counts of bucket b into the tile's row and clears them.  Two sets
// of counters, alternated by tile, let the next tile's count start without
// a second sync.  Counts do not depend on the order of the adds, nor the
// rows on the order of the tiles.
__global__ void __launch_bounds__(kThreads)
radix_histogram(const int* __restrict__ keys, long long n, int start_bit,
                unsigned mask, bool vec, int* __restrict__ hist) {
  __shared__ int warp_counts[2][kWarps][kMaxBuckets];
  const int nb = static_cast<int>(mask) + 1;
  const int r = __popc(mask);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < 2 * kWarps * kMaxBuckets; c += kThreads)
    (&warp_counts[0][0][0])[c] = 0;
  __syncthreads();
  const long long tiles = (n + kTile - 1) / kTile;
  long long t = blockIdx.x;
  TileKeys cur = load_tile(keys, n, t, vec);
  for (int set = 0; t < tiles; t += gridDim.x, set ^= 1) {
    TileKeys next = cur;
    if (t + gridDim.x < tiles) next = load_tile(keys, n, t + gridDim.x, vec);
    const int key[kItems] = {cur.lo.x, cur.lo.y, cur.lo.z, cur.lo.w,
                             cur.hi.x, cur.hi.y, cur.hi.z, cur.hi.w};
    const long long first = t * kTile + 4 * threadIdx.x;
    const bool whole = (t + 1) * kTile <= n;
    int* counts = warp_counts[set][warp];
    if (r <= 4) {
      count_packed<1>(counts, key, first, n, whole, start_bit, mask);
    } else if (r == 5) {
      count_packed<2>(counts, key, first, n, whole, start_bit, mask);
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const bool valid = whole || tile_row(first, i) < n;
        const unsigned b = valid ? bucket_of(key[i], start_bit, mask)
                                 : kNoBucket;
        const unsigned peers = peers_of(b, whole ? kFull : side_of(valid),
                                        r);
        if (valid && lane == __ffs(peers) - 1)
          atomicAdd(&counts[b], __popc(peers));
      }
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sum += warp_counts[set][w][threadIdx.x];
        warp_counts[set][w][threadIdx.x] = 0;
      }
      hist[t * nb + threadIdx.x] = sum;
    }
    cur = next;
  }
}

// One row's digit in each pass, added to the warp's own counters.  Every
// lane of the warp calls it; `live` is the warp's ballot of `valid`.  The
// AND and the OR of the warp's keys show at once which digits all its
// rows share: such a digit is added once, by the first live lane, with
// the warp's row count (no 32-way conflict on one counter), every other
// digit by an atomic a row.
__device__ __forceinline__ void count_row(int* counts, int key, bool valid,
                                          unsigned live, int start_bit,
                                          int r, int passes, unsigned mask) {
  const int nb = static_cast<int>(mask) + 1;
  const unsigned k = static_cast<unsigned>(key);
  const unsigned differ = __reduce_or_sync(kFull, valid ? k : 0u) ^
                          __reduce_and_sync(kFull, valid ? k : ~0u);
  const bool leader = static_cast<int>(threadIdx.x & 31) == __ffs(live) - 1;
  for (int p = 0; p < passes; ++p) {
    const int shift = start_bit + p * r;
    const unsigned d = (k >> shift) & mask;
    if (((differ >> shift) & mask) == 0u) {     // uniform over the warp
      if (leader) atomicAdd(&counts[p * nb + d], __popc(live));
    } else if (valid) {
      atomicAdd(&counts[p * nb + d], 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
radix_counts(const int* __restrict__ keys, long long n, int start_bit,
             int r, int passes, bool vector, int* __restrict__ counts) {
  __shared__ int warp_counts[kWarps][kMaxCounters];
  const unsigned mask = (1u << r) - 1u;
  const int total = passes << r;
  for (int c = threadIdx.x; c < kWarps * kMaxCounters; c += kThreads)
    warp_counts[c / kMaxCounters][c % kMaxCounters] = 0;
  __syncthreads();
  int* mine = warp_counts[threadIdx.x >> 5];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (vector) {
    const long long n4 = n / 4;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    // the loop bound is the block's, so every lane of a warp runs each step
    for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
         base < n4; base += stride) {
      const long long i = base + threadIdx.x;
      const bool valid = i < n4;
      const int4 k = valid ? __ldg(k4 + i) : make_int4(0, 0, 0, 0);
      const unsigned live = __ballot_sync(kFull, valid);
      count_row(mine, k.x, valid, live, start_bit, r, passes, mask);
      count_row(mine, k.y, valid, live, start_bit, r, passes, mask);
      count_row(mine, k.z, valid, live, start_bit, r, passes, mask);
      count_row(mine, k.w, valid, live, start_bit, r, passes, mask);
    }
    done = 4 * n4;
  }
  for (long long base = done + static_cast<long long>(blockIdx.x) * kThreads;
       base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    count_row(mine, valid ? __ldg(keys + i) : 0, valid,
              __ballot_sync(kFull, valid), start_bit, r, passes, mask);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < total; c += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_counts[w][c];
    if (sum) atomicAdd(counts + c, sum);
  }
}

// The payload columns one pass carries, 4 bytes a row each, moved as raw
// bits; the kernel is built for each count 0..3 of them.
struct Payload {
  const unsigned* in[kMaxVals];
  unsigned* out[kMaxVals];
};

// Where a thread's payload rows are loaded: with the keys, before the
// rank, for two or three columns (their loads overlap the rank; the
// registers that hold them leave two blocks an SM), else after the rank
// (a thread holds only keys and ranks: four blocks an SM).  Each is the
// faster of the two for its payload count on an H100 (radix_sort carries
// one column, the partitioned join two).
template <int NV>
constexpr bool kEarlyPayload = NV >= 2;

template <int NV>
__global__ void __launch_bounds__(kThreads, kEarlyPayload<NV> ? 2 : 4)
radix_sweep(const int* __restrict__ keys, long long n, int start_bit,
            unsigned mask, const int* __restrict__ totals,
            unsigned* status, unsigned* ticket,
            const Payload vals, int* __restrict__ out_keys) {
  extern __shared__ unsigned staged[];         // (1 + NV) x kSweepTile
  __shared__ int warp_hist[kWarps][kMaxBuckets];
  __shared__ int start[kMaxBuckets];           // bucket's run in the tile
  __shared__ int dest[kMaxBuckets];            // output place - run start
  __shared__ int warp_sums[2][kWarps];
  __shared__ unsigned s_tile;
  const int nb = static_cast<int>(mask) + 1;
  const int r = __popc(mask);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  for (int c = threadIdx.x; c < kWarps * kMaxBuckets; c += kThreads)
    warp_hist[c / kMaxBuckets][c % kMaxBuckets] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long tile_first = tile * kSweepTile;
  const long long first = tile_first + static_cast<long long>(warp) *
                                           kWarpRows;

  int key[kSweepItems];            // every load issued before the first rank
  unsigned v[kEarlyPayload<NV> ? NV : 1][kSweepItems];
#pragma unroll
  for (int i = 0; i < kSweepItems; ++i) {
    const long long row = first + i * 32 + lane;
    key[i] = row < n ? __ldg(keys + row) : 0;
    if (kEarlyPayload<NV>) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        v[j][i] = row < n ? __ldg(vals.in[j] + row) : 0u;
    }
  }

  // 1. each row's rank among its warp's rows of its bucket, in row order
  int rank[kSweepItems];
  int* counts = warp_hist[warp];
#pragma unroll
  for (int i = 0; i < kSweepItems; ++i) {
    rank[i] = 0;
    if (first + i * 32 >= n) continue;         // uniform over the warp
    const bool valid = first + i * 32 + lane < n;
    const unsigned b = valid ? bucket_of(key[i], start_bit, mask)
                             : kNoBucket;
    const unsigned peers =
        peers_of(b, first + i * 32 + 32 <= n ? kFull : side_of(valid), r);
    const int below = __popc(peers & ((1u << lane) - 1u));
    int base = 0;
    if (valid && below == 0) {
      base = counts[b];
      counts[b] = base + __popc(peers);
    }
    rank[i] = __shfl_sync(kFull, base, __ffs(peers) - 1) + below;
    __syncwarp();
  }
  __syncthreads();

  // 2. thread b: the tile's count of bucket b, published at once; the
  // warps' counts become their bases within the tile's run of b
  int c = 0;
  if (threadIdx.x < nb) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_hist[w][threadIdx.x];
      warp_hist[w][threadIdx.x] = c;
      c += t;
    }
    const unsigned word = tile == 0 ? kInclusive | static_cast<unsigned>(c)
                                    : static_cast<unsigned>(c) + 1u;
    reinterpret_cast<volatile unsigned*>(status)[tile * nb + threadIdx.x] =
        word;
  }
  // the runs in the tile and the buckets' bases in the output: exclusive
  // scans over the buckets of the tile's counts and the pass's totals
  const int total = threadIdx.x < nb ? totals[threadIdx.x] : 0;
  const int incl_c = warp_scan(c);
  const int incl_t = warp_scan(total);
  if (lane == 31) {
    warp_sums[0][warp] = incl_c;
    warp_sums[1][warp] = incl_t;
  }
  __syncthreads();
  int before_c = 0, before_t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before_c += w < warp ? warp_sums[0][w] : 0;
    before_t += w < warp ? warp_sums[1][w] : 0;
  }
  if (threadIdx.x < nb) start[threadIdx.x] = before_c + incl_c - c;
  __syncthreads();

  // 3. the tile in bucket order in shared memory (the late payload rows
  // loaded here)
#pragma unroll
  for (int i = 0; i < kSweepItems; ++i) {
    const long long row = first + i * 32 + lane;
    if (row >= n) continue;
    const unsigned b = bucket_of(key[i], start_bit, mask);
    const int slot = start[b] + warp_hist[warp][b] + rank[i];
    staged[slot] = static_cast<unsigned>(key[i]);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      staged[(j + 1) * kSweepTile + slot] =
          kEarlyPayload<NV> ? v[kEarlyPayload<NV> ? j : 0][i]
                            : __ldg(vals.in[j] + row);
  }

  // 4. decoupled look-back: thread b adds its predecessors' counts of b
  // until the nearest inclusive prefix, waiting on a word not yet
  // published
  if (threadIdx.x < nb) {
    unsigned before = 0;
    if (tile > 0) {
      const volatile unsigned* vs = status;
      for (long long pred = tile - 1;; --pred) {
        unsigned word;
        do {
          word = vs[pred * nb + threadIdx.x];
        } while (word == 0u);
        if (word & kInclusive) {
          before += word & ~kInclusive;
          break;
        }
        before += word - 1u;
      }
      reinterpret_cast<volatile unsigned*>(status)[tile * nb + threadIdx.x] =
          kInclusive | (before + static_cast<unsigned>(c));
    }
    dest[threadIdx.x] = before_t + incl_t - total +
                        static_cast<int>(before) - start[threadIdx.x];
  }
  __syncthreads();

  // 5. the tile's runs out in order: neighbouring threads write
  // neighbouring places of one run
  const int rows = static_cast<int>(
      n - tile_first < kSweepTile ? n - tile_first : kSweepTile);
#pragma unroll 4
  for (int slot = threadIdx.x; slot < rows; slot += kThreads) {
    const int k = static_cast<int>(staged[slot]);
    const long long pos = dest[bucket_of(k, start_bit, mask)] + slot;
    if (pos < 0 || pos >= n) continue;   // only counts not of these keys
    out_keys[pos] = k;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      vals.out[j][pos] = staged[(j + 1) * kSweepTile + slot];
  }
}

bool bad_args(long long n, int start_bit, int r) {
  return n <= 0 || n > 2147483647LL || r < 1 || r > kMaxBits ||
         start_bit < 0 || start_bit > 31;
}

template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, long long* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(cudaSuccess);
}

template <int NV>
int sweep(const int* keys, long long n, int start_bit, unsigned mask,
          const int* totals, unsigned* status, unsigned* ticket,
          const Payload& vals, int* out_keys, cudaStream_t stream) {
  const int smem = static_cast<int>((1 + NV) * kSweepTile * sizeof(unsigned));
  cudaError_t err = cudaFuncSetAttribute(
      radix_sweep<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + kSweepTile - 1) / kSweepTile;
  radix_sweep<NV><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      keys, n, start_bit, mask, totals, status, ticket, vals, out_keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: (n,) int32; hist: (ceil(n / 2048), 2^r) int32, written whole.
// 0 < n < 2^31, 1 <= r <= 8, 0 <= start_bit < 32; max_grid: radix_shape's
// blocks for `which` 1.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int radix_histogram_launch(const void* keys, long long n,
                                      int start_bit, int r,
                                      long long max_grid, void* hist,
                                      void* stream) {
  if (bad_args(n, start_bit, r) || max_grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTile - 1) / kTile;
  const bool vec = (reinterpret_cast<std::uintptr_t>(keys) & 15u) == 0u;
  radix_histogram<<<static_cast<unsigned>(tiles < max_grid ? tiles
                                                           : max_grid),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n, start_bit, (1u << r) - 1u, vec,
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// Blocks resident on the current device of the counts kernel (`which` 0;
// its grid is the key vectors over kThreads, up to this) or of the
// histogram kernel (`which` 1; its grid is the tiles, up to this).
extern "C" int radix_shape(int which, long long* resident) {
  if (which == 0) return resident_blocks(radix_counts, 0, resident);
  if (which == 1) return resident_blocks(radix_histogram, 0, resident);
  return static_cast<int>(cudaErrorInvalidValue);
}

// keys: (n,) int32; counts: (passes, 2^r) int32, cleared here, then
// counts[p][d] = the rows whose bits [start_bit + p*r, + r) are d.
// passes x 2^r <= 1024, start_bit + (passes - 1) * r <= 31; max_grid:
// radix_shape's blocks.  Otherwise as radix_histogram_launch.
extern "C" int radix_counts_launch(const void* keys, long long n,
                                   int start_bit, int r, int passes,
                                   long long max_grid, void* counts,
                                   void* stream) {
  if (bad_args(n, start_bit, r) || passes < 1 ||
      start_bit + (passes - 1) * r > 31 || (passes << r) > kMaxCounters ||
      max_grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, sizeof(int) * static_cast<size_t>(passes << r), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vector = (reinterpret_cast<std::uintptr_t>(keys) & 15u) == 0u;
  long long grid = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  if (grid > max_grid) grid = max_grid;
  radix_counts<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const int*>(keys), n, start_bit, r, passes, vector,
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// keys: (n,) int32; totals: (2^r,) int32, the pass's bucket counts of these
// keys; status: radix_sweep_status_words(n, r) words of scratch, cleared
// here; v0..v2: the first n_vals of them (n,) 4-byte payload columns, o0..o2
// their outputs; out_keys: (n,) int32.  Otherwise as
// radix_histogram_launch.
extern "C" int radix_sweep_launch(const void* keys, long long n,
                                  int start_bit, int r, const void* totals,
                                  void* status, int n_vals, const void* v0,
                                  const void* v1, const void* v2, void* o0,
                                  void* o1, void* o2, void* out_keys,
                                  void* stream) {
  if (bad_args(n, start_bit, r) || n_vals < 0 || n_vals > kMaxVals)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = ((n + kSweepTile - 1) / kSweepTile << r) + 1;
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned) * static_cast<size_t>(words), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Payload vals{{static_cast<const unsigned*>(v0),
                      static_cast<const unsigned*>(v1),
                      static_cast<const unsigned*>(v2)},
                     {static_cast<unsigned*>(o0), static_cast<unsigned*>(o1),
                      static_cast<unsigned*>(o2)}};
  const int* k = static_cast<const int*>(keys);
  const int* t = static_cast<const int*>(totals);
  unsigned* st = static_cast<unsigned*>(status);
  unsigned* ticket = st + words - 1;
  int* out = static_cast<int*>(out_keys);
  const unsigned mask = (1u << r) - 1u;
  switch (n_vals) {
    case 0: return sweep<0>(k, n, start_bit, mask, t, st, ticket, vals, out, s);
    case 1: return sweep<1>(k, n, start_bit, mask, t, st, ticket, vals, out, s);
    case 2: return sweep<2>(k, n, start_bit, mask, t, st, ticket, vals, out, s);
    default:
      return sweep<3>(k, n, start_bit, mask, t, st, ticket, vals, out, s);
  }
}

// Scratch words radix_sweep_launch takes for n rows at r bits: a status
// word per bucket per tile of 4096 rows, and the tile counter.
extern "C" long long radix_sweep_status_words(long long n, int r) {
  return ((n + kSweepTile - 1) / kSweepTile << r) + 1;
}

extern "C" long long radix_tile_rows() { return kTile; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
