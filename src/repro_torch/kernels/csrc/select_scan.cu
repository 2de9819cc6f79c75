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
// select_scan_sparse replaces src/repro/kernels/select_scan.py::
// select_scan_sparse (_select_sparse_kernel), the paper's selective load
// (§5.3): phase 1 reads x alone and marks the tiles that hold a match;
// phase 2 compacts only the marked tiles, so y is read only there.  The
// TPU kernel keeps all its grid steps and leaves trimming them to a
// dynamic grid bound; here phase 2 is sized by the marked tiles on the
// device, with no host round trip between the phases.  The skip unit is
// kUnit = 32 rows, one warp's ballot and one 128-byte line of y:
//
//   sparse_mark:   one block per kTile rows reads x once; each warp's
//                  ballot of its 32 rows is that unit's match mask
//                  (4 bytes per 32 rows), and the block writes its
//                  tile's matches and marked units;
//   scan_tiles:    twice, the tile offsets of the output and of the
//                  marked-unit list (its length stays on the device);
//   sparse_list:   one block of 64 threads per tile with a marked unit
//                  writes each marked unit's (id, output position);
//   sparse_gather: a fixed grid of warps strides over the list, its
//                  length read from device memory; each warp writes
//                  the set lanes of its unit's y to their positions.
//
// The positions come from the counts alone (tile offset, then the
// popcounts of the earlier units and lanes), so the output is
// select_scan's, bit for bit, in row order.  What bounds it: x read once
// (4n), y read in the marked units only, the selected entries written,
// and the masks (n / 8 bytes written, read again for marked tiles) and
// the list (8 bytes per marked unit) on top.
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

constexpr int kUnit = 32;                      // the skip unit (rows)
constexpr int kUnits = static_cast<int>(kTile / kUnit);   // 64 a tile
constexpr int kGatherBlocksPerSm = 8;

// Phase 1: each unit's match mask; the tile's matches and marked units.
template <typename Pred>
__global__ void __launch_bounds__(kThreads)
sparse_mark(const Pred selected, unsigned* __restrict__ masks,
            int* __restrict__ counts, int* __restrict__ units) {
  __shared__ int warp_counts[kWarps];
  const long long base = kTile * blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int packed = 0;                  // matches | marked units << 16
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned ballot = __ballot_sync(
        kFull, selected(base + static_cast<long long>(i) * kThreads +
                        threadIdx.x));
    if (lane == 0) {
      masks[static_cast<long long>(blockIdx.x) * kUnits + i * kWarps +
            warp] = ballot;
      packed += __popc(ballot) + (ballot != 0u ? 1 << 16 : 0);
    }
  }
  const int total = block_sum(packed, warp_counts);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = total & 0xffff;
    units[blockIdx.x] = total >> 16;
  }
}

// Phase 2a: (unit id, output position) of each marked unit, in row order.
__global__ void __launch_bounds__(kUnits)
sparse_list(const unsigned* __restrict__ masks, const int* __restrict__ units,
            const int* __restrict__ unit_offsets,
            const int* __restrict__ offsets, int2* __restrict__ list) {
  __shared__ int first_warp;
  if (units[blockIdx.x] == 0) return;            // uniform over the block
  const int unit = blockIdx.x * kUnits + threadIdx.x;
  const unsigned m = masks[unit];
  const int v = __popc(m) + (m != 0u ? 1 << 16 : 0);
  int incl = warp_scan(v);
  if (threadIdx.x == 31) first_warp = incl;
  __syncthreads();
  if (threadIdx.x >= 32) incl += first_warp;
  const int excl = incl - v;
  if (m != 0u)
    list[unit_offsets[blockIdx.x] + (excl >> 16)] =
        make_int2(unit, offsets[blockIdx.x] + (excl & 0xffff));
}

// Phase 2b: a warp per marked unit, over a list whose length is on the
// device; y is read in the unit's set lanes only.
__global__ void __launch_bounds__(kThreads)
sparse_gather(const int2* __restrict__ list,
              const long long* __restrict__ n_marked,
              const unsigned* __restrict__ masks,
              const unsigned* __restrict__ y, unsigned* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long total = *n_marked;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long e = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       e < total; e += step) {
    const int2 ent = list[e];
    const unsigned m = masks[ent.x];
    if ((m >> lane) & 1u)
      out[ent.y + __popc(m & ((1u << lane) - 1u))] =
          __ldg(y + static_cast<long long>(ent.x) * kUnit + lane);
  }
}

// The sparse scan's scratch, carved from one buffer: the list's length,
// the list, the unit masks, then four int32 arrays of one entry a tile.
struct SparseScratch {
  long long* n_marked;
  int2* list;
  unsigned* masks;
  int* counts;
  int* offsets;
  int* units;
  int* unit_offsets;
};

long long sparse_scratch_bytes(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  return 8 + tiles * kUnits * (8 + 4) + 4 * 4 * tiles;
}

SparseScratch carve(void* scratch, long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  char* p = static_cast<char*>(scratch);
  SparseScratch s;
  s.n_marked = reinterpret_cast<long long*>(p);
  p += 8;
  s.list = reinterpret_cast<int2*>(p);
  p += 8 * tiles * kUnits;
  s.masks = reinterpret_cast<unsigned*>(p);
  p += 4 * tiles * kUnits;
  s.counts = reinterpret_cast<int*>(p);
  s.offsets = s.counts + tiles;
  s.units = s.offsets + tiles;
  s.unit_offsets = s.units + tiles;
  return s;
}

template <typename Pred>
int launch_sparse(const Pred& selected, const void* y, long long n,
                  const SparseScratch& sc, void* out, long long* count,
                  cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned grid = static_cast<unsigned>(tiles);
  sparse_mark<Pred><<<grid, kThreads, 0, stream>>>(selected, sc.masks,
                                                   sc.counts, sc.units);
  scan_tiles<<<1, kScanThreads, 0, stream>>>(sc.counts, sc.offsets,
                                             static_cast<int>(tiles), count);
  scan_tiles<<<1, kScanThreads, 0, stream>>>(
      sc.units, sc.unit_offsets, static_cast<int>(tiles), sc.n_marked);
  sparse_list<<<grid, kUnits, 0, stream>>>(sc.masks, sc.units,
                                          sc.unit_offsets, sc.offsets,
                                          sc.list);
  long long gather = (tiles * kUnits + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * kGatherBlocksPerSm;
  if (gather > cap) gather = cap;
  sparse_gather<<<static_cast<unsigned>(gather), kThreads, 0, stream>>>(
      sc.list, sc.n_marked, sc.masks, static_cast<const unsigned*>(y),
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
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

// x, y: (n,) device arrays as select_scan_launch's; scratch: the bytes
// select_scan_sparse_scratch_bytes(n) gives, 8-byte aligned; out: (n,)
// zeroed; count: one int64.  0 < n < 2^31.  Launches on `stream`, does
// not synchronise, returns cudaGetLastError().
extern "C" int select_scan_sparse_launch(const void* x, const void* y,
                                         long long n, int lo_bits,
                                         int hi_bits, int is_float,
                                         void* scratch, void* out,
                                         void* count, void* stream) {
  if (n <= 0 || n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const SparseScratch sc = carve(scratch, n);
  long long* total = static_cast<long long*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    PlainPred<float> pred{static_cast<const float*>(x), n, 0.f, 0.f};
    memcpy(&pred.lo, &lo_bits, 4);
    memcpy(&pred.hi, &hi_bits, 4);
    return launch_sparse(pred, y, n, sc, out, total, s);
  }
  const PlainPred<int> pred{static_cast<const int*>(x), n, lo_bits, hi_bits};
  return launch_sparse(pred, y, n, sc, out, total, s);
}

extern "C" long long select_scan_sparse_scratch_bytes(long long n) {
  return sparse_scratch_bytes(n);
}

extern "C" long long select_scan_tile_rows() { return kTile; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
