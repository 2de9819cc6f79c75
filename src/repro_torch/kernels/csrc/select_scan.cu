// Selection scan for Hopper (sm_90a): SELECT y WHERE lo <= x <= hi, stable.
//
// Replaces the Pallas TPU kernel src/repro/kernels/select_scan.py::
// select_scan (_select_kernel): BlockLoad -> BlockPred -> BlockScan ->
// BlockShuffle -> BlockStore per tile, with the running output offset
// carried across an in-order grid.  Here the order comes from the three
// phases of compact.cuh (count, scan of the tile counts, scatter), so the
// output is stable and the same on every run.
//
// What bounds it: device-memory bytes at 3.35 TB/s.  The function needs x
// read once, y read once and the count of selected entries written
// (8n + 4 count bytes).  This design reads x twice (the scatter evaluates
// the predicate again rather than storing a flag per row: a 1-byte flag
// would cost 2n bytes written and read, the second read of x costs 4n but
// is a plain stream), and reads y only where a row is selected.  A tile
// with no match skips the scatter's loads altogether.  The tile counts are
// 4 bytes per 2048 rows.
//
// x is int32 or float32 (a NaN is never selected), y any 4-byte type,
// moved as raw bits.  The caller zeroes `out`: entries past the count
// stay zero.
#include <cuda_runtime.h>

#include <cstring>

#include "compact.cuh"

namespace {

template <typename T>
__device__ __forceinline__ bool selected(const T* __restrict__ x, long long r,
                                         long long n, T lo, T hi) {
  if (r >= n) return false;
  const T v = __ldg(x + r);
  return v >= lo && v <= hi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_count(const T* __restrict__ x, long long n, T lo, T hi,
             int* __restrict__ counts) {
  __shared__ int warp_counts[kWarps];
  const long long base = kTile * blockIdx.x;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    c += selected(x, base + static_cast<long long>(i) * kThreads + threadIdx.x,
                  n, lo, hi);
  const int total = block_sum(c, warp_counts);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_scatter(const T* __restrict__ x, const unsigned* __restrict__ y,
               long long n, T lo, T hi, const int* __restrict__ counts,
               const int* __restrict__ offsets, unsigned* __restrict__ out) {
  __shared__ int warp_counts[kWarps];
  if (counts[blockIdx.x] == 0) return;           // uniform over the block
  const long long base = kTile * blockIdx.x;
  bool hit[kItems];                // every load issued before the first rank
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    hit[i] = selected(x, base + static_cast<long long>(i) * kThreads +
                             threadIdx.x, n, lo, hi);
  int pos = offsets[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int total;
    const int rank = block_rank(hit[i], warp_counts, &total);
    if (hit[i])
      out[pos + rank] = __ldg(y + base + static_cast<long long>(i) * kThreads +
                              threadIdx.x);
    pos += total;
  }
}

template <typename T>
int launch(const void* x, const void* y, long long n, T lo, T hi,
           int* counts, int* offsets, void* out, long long* count,
           cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  const T* xs = static_cast<const T*>(x);
  select_count<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      xs, n, lo, hi, counts);
  scan_tiles<<<1, kScanThreads, 0, stream>>>(counts, offsets,
                                             static_cast<int>(tiles), count);
  select_scatter<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      xs, static_cast<const unsigned*>(y), n, lo, hi, counts, offsets,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (n,) device arrays, x int32 (is_float 0) or float32 (is_float 1),
// y 4-byte; lo_bits/hi_bits: the bounds' 32-bit patterns in x's type.
// counts, offsets: (ceil(n / 2048),) int32 scratch; out: (n,) zeroed;
// count: one int64.  0 < n < 2^31.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int select_scan_launch(const void* x, const void* y, long long n,
                                  int lo_bits, int hi_bits, int is_float,
                                  void* counts, void* offsets, void* out,
                                  void* count, void* stream) {
  if (n <= 0 || n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  int* c = static_cast<int*>(counts);
  int* o = static_cast<int*>(offsets);
  long long* total = static_cast<long long*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    float lo, hi;
    memcpy(&lo, &lo_bits, 4);
    memcpy(&hi, &hi_bits, 4);
    return launch<float>(x, y, n, lo, hi, c, o, out, total, s);
  }
  return launch<int>(x, y, n, lo_bits, hi_bits, c, o, out, total, s);
}

extern "C" long long select_scan_tile_rows() { return kTile; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
