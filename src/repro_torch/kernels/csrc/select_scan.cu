// Selection scan for Hopper (sm_90a): SELECT y WHERE lo <= x <= hi, stable.
//
// Replaces the Pallas TPU kernels src/repro/kernels/select_scan.py::
// select_scan (_select_kernel) and select_scan_packed
// (_select_packed_kernel): BlockLoad -> BlockPred -> BlockScan ->
// BlockShuffle -> BlockStore per tile, with the running output offset
// carried across an in-order grid.  Here the order comes from the three
// phases of compact.cuh (count, scan of the tile counts, scatter), so the
// output is stable and the same on every run.  The two differ only in how
// a row's x is loaded: a plain int32/float32 column (PlainPred), or a
// bit-packed column decoded in registers (PackedPred, packed.cuh's
// layout; the bounds are in the encoded domain, so no reference is added).
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
// For a packed x, the function needs the words read once (phys / 8
// bytes a row) in place of 4 bytes a row; the count and scatter phases
// each read them, as they read a plain x.
//
// x is int32 or float32 (a NaN is never selected), or packed words; y any
// 4-byte type, moved as raw bits.  Rows >= n never match (a packed
// column's last word may hold padding lanes).  The caller zeroes `out`:
// entries past the count stay zero.
#include <cuda_runtime.h>

#include <cstring>

#include "compact.cuh"
#include "packed.cuh"

namespace {

template <typename T>
struct PlainPred {
  const T* x;
  long long n;
  T lo, hi;
  __device__ __forceinline__ bool operator()(long long r) const {
    if (r >= n) return false;
    const T v = __ldg(x + r);
    return v >= lo && v <= hi;
  }
};

struct PackedPred {
  const unsigned* words;
  long long n;
  int lo, hi;
  int lg, phys;
  unsigned mask;
  __device__ __forceinline__ bool operator()(long long r) const {
    if (r >= n) return false;
    const int v = static_cast<int>(packed_lane(words, r, lg, phys, mask));
    return v >= lo && v <= hi;
  }
};

template <typename Pred>
__global__ void __launch_bounds__(kThreads)
select_count(const Pred selected, int* __restrict__ counts) {
  __shared__ int warp_counts[kWarps];
  const long long base = kTile * blockIdx.x;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    c += selected(base + static_cast<long long>(i) * kThreads + threadIdx.x);
  const int total = block_sum(c, warp_counts);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <typename Pred>
__global__ void __launch_bounds__(kThreads)
select_scatter(const Pred selected, const unsigned* __restrict__ y,
               const int* __restrict__ counts,
               const int* __restrict__ offsets, unsigned* __restrict__ out) {
  __shared__ int warp_counts[kWarps];
  if (counts[blockIdx.x] == 0) return;           // uniform over the block
  const long long base = kTile * blockIdx.x;
  bool hit[kItems];                // every load issued before the first rank
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    hit[i] = selected(base + static_cast<long long>(i) * kThreads +
                      threadIdx.x);
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

template <typename Pred>
int launch(const Pred& selected, const void* y, long long n, int* counts,
           int* offsets, void* out, long long* count, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  select_count<Pred><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      selected, counts);
  scan_tiles<<<1, kScanThreads, 0, stream>>>(counts, offsets,
                                             static_cast<int>(tiles), count);
  select_scatter<Pred><<<static_cast<unsigned>(tiles), kThreads, 0,
                         stream>>>(selected, static_cast<const unsigned*>(y),
                                   counts, offsets,
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
    PlainPred<float> pred{static_cast<const float*>(x), n, 0.f, 0.f};
    memcpy(&pred.lo, &lo_bits, 4);
    memcpy(&pred.hi, &hi_bits, 4);
    return launch(pred, y, n, c, o, out, total, s);
  }
  const PlainPred<int> pred{static_cast<const int*>(x), n, lo_bits, hi_bits};
  return launch(pred, y, n, c, o, out, total, s);
}

// words: the packed predicate column, ceil(n / (32 / phys)) int32 words at
// `phys` bits (1, 2, 4, 8, 16 or 32); y: (n,) 4-byte; lo, hi: the bounds
// in the encoded domain.  Scratch, out and count as select_scan_launch.
extern "C" int select_scan_packed_launch(const void* words, const void* y,
                                         long long n, int lo, int hi,
                                         int phys, void* counts,
                                         void* offsets, void* out,
                                         void* count, void* stream) {
  const int lg = lanes_log2(phys);
  if (n <= 0 || n > 2147483647LL || lg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PackedPred pred{static_cast<const unsigned*>(words), n, lo, hi, lg,
                        phys, lane_mask(phys)};
  return launch(pred, y, n, static_cast<int*>(counts),
                static_cast<int*>(offsets), out,
                static_cast<long long*>(count),
                static_cast<cudaStream_t>(stream));
}

extern "C" long long select_scan_tile_rows() { return kTile; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
