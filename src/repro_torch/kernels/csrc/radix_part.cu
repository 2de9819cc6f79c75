// Radix partitioning for Hopper (sm_90a): per-tile bucket histograms and
// one stable scatter pass of a key and up to three payload columns (paper
// §4.4; the partitioned join's shuffle and each pass of the LSB radix
// sort behind ORDER BY).
//
// Replaces the Pallas TPU kernels src/repro/kernels/radix_part.py::
// histogram (_hist_kernel) and partition_multi (_shuffle_kernel).  A
// key's bucket is bits [start_bit, start_bit + r) of the key read as an
// unsigned word (a logical shift), r <= 8, so at most 256 buckets.
//
//   histogram: one block per tile of kTile = 2048 rows writes the tile's
//              2^r counts to its own row of a (n_tiles, 2^r) array, the
//              reference's layout.  Counters live in shared memory; a
//              warp adds each bucket once (peers_of finds the lanes that
//              share it, one ballot per bucket bit), so a tile of one
//              bucket costs 8 shared atomics a step, not 256.  Counts do
//              not depend on the order of the adds.
//   offsets:   the bucket-major exclusive scan of the counts (the paper's
//              K2), offsets[b * n_tiles + t]: the reference writes it in
//              plain jnp outside Pallas, the wrapper in plain torch.
//   scatter:   one block per tile sends each row to offsets[b, tile] +
//              its rank among the tile's rows of bucket b.  The rank is
//              taken in row order, kThreads rows a step as in
//              compact.cuh: the lanes before it in its warp with the same
//              bucket (peers_of, __popc), plus the counts of the
//              bucket in the warps before it this step (shared memory,
//              8 warps x 256 buckets), plus the rows of the bucket in the
//              earlier steps (a running count per bucket).  No atomic
//              decides a position, so the pass is stable and the output
//              the same bits on every run, whatever order blocks run in.
//              The rows are first put in that order in shared memory,
//              each bucket's run at its start in the tile (a scan of the
//              tile's histogram row), then written out slot by slot, so
//              neighbouring threads write neighbouring places of a run.
//
// What bounds it: device-memory bytes at 3.35 TB/s.  The histogram needs
// the keys read once (4 bytes a row) and its counts written; the scatter
// the key and N payload columns read and written once ((1 + N) * 8 bytes
// a row) and the histogram and offsets read.  A tile's 2048 rows fill up
// to 2^r runs, so at r = 8 a run averages 8 rows, 32 bytes a column: the
// staging makes each run one sector write where the rows sent straight
// from registers would be 8 partial ones.
//
// Rows >= n count in no bucket and move nowhere.
#include <cuda_runtime.h>

#include "compact.cuh"

namespace {

constexpr int kMaxBits = 8;
constexpr int kMaxBuckets = 1 << kMaxBits;
constexpr int kMaxVals = 3;
constexpr unsigned kNoBucket = 0xffffffffu;   // rows >= n: no bucket
static_assert(kMaxBuckets <= kThreads, "one bucket a thread");

__device__ __forceinline__ unsigned bucket_of(int key, int start_bit,
                                              unsigned mask) {
  return (static_cast<unsigned>(key) >> start_bit) & mask;
}

// The lanes of the warp whose bucket equals this lane's, as a mask: one
// ballot per bucket bit (a warp multisplit), cheaper than
// __match_any_sync for r <= 8.  Every lane calls it; lanes with no bucket
// (valid false) match only each other.
__device__ __forceinline__ unsigned peers_of(unsigned b, bool valid,
                                             int r) {
  const unsigned live = __ballot_sync(kFull, valid);
  unsigned peers = valid ? live : ~live;
  for (int k = 0; k < r; ++k) {
    const unsigned set = __ballot_sync(kFull, (b >> k) & 1u);
    peers &= (b >> k) & 1u ? set : ~set;
  }
  return peers;
}

__global__ void __launch_bounds__(kThreads)
radix_histogram(const int* __restrict__ keys, long long n, int start_bit,
                unsigned mask, int* __restrict__ hist) {
  __shared__ int counts[kMaxBuckets];
  const int nb = static_cast<int>(mask) + 1;
  const int r = __popc(mask);
  for (int b = threadIdx.x; b < nb; b += kThreads) counts[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long first = kTile * blockIdx.x;
  unsigned b[kItems];              // every load issued before the first match
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long row = first + static_cast<long long>(i) * kThreads +
                          threadIdx.x;
    b[i] = row < n ? bucket_of(__ldg(keys + row), start_bit, mask)
                   : kNoBucket;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = b[i] != kNoBucket;
    const unsigned peers = peers_of(b[i], valid, r);
    if (valid && lane == __ffs(peers) - 1)
      atomicAdd(&counts[b[i]], __popc(peers));
  }
  __syncthreads();
  int* row = hist + static_cast<long long>(blockIdx.x) * nb;
  for (int b = threadIdx.x; b < nb; b += kThreads) row[b] = counts[b];
}

// The payload columns one scatter carries: `count` of them, 4 bytes a row
// each, moved as raw bits.
struct Payload {
  const unsigned* in[kMaxVals];
  unsigned* out[kMaxVals];
  int count;
};

__global__ void __launch_bounds__(kThreads)
radix_scatter(const int* __restrict__ keys, long long n, int start_bit,
              unsigned mask, const int* __restrict__ hist,
              const int* __restrict__ offsets, long long n_tiles,
              const Payload vals, int* __restrict__ out_keys) {
  __shared__ int s_keys[kTile];                // the tile in bucket order
  __shared__ unsigned s_vals[kMaxVals][kTile];
  __shared__ int start[kMaxBuckets];           // bucket's run in the tile
  __shared__ int dest[kMaxBuckets];            // ... and in the output
  __shared__ int next[kMaxBuckets];            // next slot of its run
  __shared__ int warp_hist[kWarps][kMaxBuckets];   // this step's counts
  __shared__ int warp_sums[kWarps];
  const int nb = static_cast<int>(mask) + 1;
  const int r = __popc(mask);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = kTile * blockIdx.x;

  // the tile's bucket runs: an exclusive scan of its histogram row, one
  // bucket a thread (nb <= kThreads)
  const int c = threadIdx.x < nb
      ? hist[static_cast<long long>(blockIdx.x) * nb + threadIdx.x] : 0;
  const int incl = warp_scan(c);
  if (lane == 31) warp_sums[warp] = incl;
  if (threadIdx.x < nb) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_hist[w][threadIdx.x] = 0;
  }
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_sums[w] : 0;
  if (threadIdx.x < nb) {
    start[threadIdx.x] = next[threadIdx.x] = before + incl - c;
    dest[threadIdx.x] =
        offsets[static_cast<long long>(threadIdx.x) * n_tiles + blockIdx.x];
  }

  int key[kItems];                 // every load issued before the first rank
  unsigned v[kItems][kMaxVals];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long row = first + static_cast<long long>(i) * kThreads +
                          threadIdx.x;
    key[i] = 0;
#pragma unroll
    for (int j = 0; j < kMaxVals; ++j) {
      v[i][j] = 0u;
      if (row < n && j < vals.count) v[i][j] = __ldg(vals.in[j] + row);
    }
    if (row < n) key[i] = __ldg(keys + row);
  }
  __syncthreads();

  // each row's slot in the tile: its bucket's run, then its rank there
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long step = first + static_cast<long long>(i) * kThreads;
    if (step >= n) continue;                     // uniform over the block
    const bool valid = step + threadIdx.x < n;
    const unsigned b = valid ? bucket_of(key[i], start_bit, mask)
                             : kNoBucket;
    const unsigned peers = peers_of(b, valid, r);
    const int below = __popc(peers & ((1u << lane) - 1u));
    if (valid && below == 0) warp_hist[warp][b] = __popc(peers);
    __syncthreads();
    if (valid) {
      int slot = next[b] + below;
      for (int w = 0; w < warp; ++w) slot += warp_hist[w][b];
      s_keys[slot] = key[i];
#pragma unroll
      for (int j = 0; j < kMaxVals; ++j)
        if (j < vals.count) s_vals[j][slot] = v[i][j];
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      int add = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        add += warp_hist[w][threadIdx.x];
        warp_hist[w][threadIdx.x] = 0;
      }
      next[threadIdx.x] += add;
    }
    __syncthreads();
  }

  // the tile's runs out in order: neighbouring threads write neighbouring
  // places of one run
  const int rows = static_cast<int>(n - first < kTile ? n - first : kTile);
  for (int slot = threadIdx.x; slot < rows; slot += kThreads) {
    const int k = s_keys[slot];
    const unsigned b = bucket_of(k, start_bit, mask);
    const int pos = dest[b] + (slot - start[b]);
    out_keys[pos] = k;
#pragma unroll
    for (int j = 0; j < kMaxVals; ++j)
      if (j < vals.count) vals.out[j][pos] = s_vals[j][slot];
  }
}

bool bad_args(long long n, int start_bit, int r) {
  return n <= 0 || n > 2147483647LL || r < 1 || r > kMaxBits ||
         start_bit < 0 || start_bit > 31;
}

}  // namespace

// keys: (n,) int32; hist: (ceil(n / 2048), 2^r) int32.  0 < n < 2^31,
// 1 <= r <= 8, 0 <= start_bit < 32.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int radix_histogram_launch(const void* keys, long long n,
                                      int start_bit, int r, void* hist,
                                      void* stream) {
  if (bad_args(n, start_bit, r))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTile - 1) / kTile;
  radix_histogram<<<static_cast<unsigned>(tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n, start_bit, (1u << r) - 1u,
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// keys: (n,) int32; hist: radix_histogram's (ceil(n / 2048), 2^r) counts
// of these keys; offsets: (2^r, ceil(n / 2048)) int32, their bucket-major
// exclusive scan; v0..v2: the
// first n_vals of them (n,) 4-byte payload columns, o0..o2 their outputs;
// out_keys: (n,) int32.  Arguments otherwise as radix_histogram_launch.
extern "C" int radix_scatter_launch(const void* keys, long long n,
                                    int start_bit, int r, const void* hist,
                                    const void* offsets, int n_vals,
                                    const void* v0, const void* v1,
                                    const void* v2, void* o0, void* o1,
                                    void* o2, void* out_keys, void* stream) {
  if (bad_args(n, start_bit, r) || n_vals < 0 || n_vals > kMaxVals)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTile - 1) / kTile;
  const Payload vals{{static_cast<const unsigned*>(v0),
                      static_cast<const unsigned*>(v1),
                      static_cast<const unsigned*>(v2)},
                     {static_cast<unsigned*>(o0), static_cast<unsigned*>(o1),
                      static_cast<unsigned*>(o2)},
                     n_vals};
  radix_scatter<<<static_cast<unsigned>(tiles), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n, start_bit, (1u << r) - 1u,
      static_cast<const int*>(hist), static_cast<const int*>(offsets), tiles,
      vals, static_cast<int*>(out_keys));
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long radix_tile_rows() { return kTile; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
