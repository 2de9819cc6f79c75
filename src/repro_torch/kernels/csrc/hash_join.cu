// Probe-join for Hopper (sm_90a): the rows whose key is found in a
// linear-probe table, as stable compacted (payload, val) pairs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_join.py::
// probe_join (_probe_join_kernel): BlockLookup, then BlockScan and
// BlockShuffle of the found rows, with the running output offset carried
// across an in-order grid.  Here the order comes from the three phases of
// compact.cuh (count, scan of the tile counts, scatter), so the output is
// stable and the same on every run.  Probes are hash.cuh's, as in
// ssb_fused.cu.
//
// What bounds it: device-memory bytes at 3.35 TB/s.  The function needs
// the keys and vals read once, 8 bytes written per found row, and the
// table segments its probes visit.  The scatter probes again rather than
// keep each row's found flag and payload from the count phase: those
// would cost 5 bytes a row written and read again (10n), the second probe
// costs the keys read again (4n) and probes of a table that stays in the
// 50 MB L2 (an SSB dimension table at SF 20 is at most a few MB).  vals
// are read only for found rows; a tile with no match skips the scatter's
// loads altogether.  The probes, not the device-memory bytes, take the
// time: dependent 4-byte reads of L2 (PERF.md).
//
// The caller zeroes the outputs: entries past the count stay zero.
//
// probe_agg: SUM(payload + v) over the rows whose key is found (the
// paper's join microbenchmark, SELECT SUM(A.v + B.v) FROM A, B WHERE
// A.k = B.k).  Replaces src/repro/kernels/hash_join.py::probe_agg
// (_probe_agg_kernel), which adds each tile into one scalar across a grid
// that runs in order; here each block sums its rows and reduce.cuh's
// finish_sum adds the blocks' partials in a fixed order.  int32 vals: each
// payload + v and the sum wrap as the reference's int32 adds (summed in
// 64 bits, cut once); f32 vals: payload + v rounded to f32 as the
// reference's add, summed in f64, rounded once.  What bounds it: the keys
// read once and vals read per hit (8 bytes a row when all hit) and the
// table segments the probes visit; while the table fits the 50 MB L2 the
// probes are L2 reads, past it each probe is a device-memory access of its
// own.  Each thread walks four rows' probes at once.
#include <cuda_runtime.h>

#include "compact.cuh"
#include "hash.cuh"
#include "reduce.cuh"

namespace {

__device__ __forceinline__ bool found(const int* __restrict__ keys,
                                      long long r, long long n,
                                      const int* __restrict__ htk,
                                      const int* __restrict__ htv,
                                      unsigned mask, int* payload) {
  return r < n && probe(htk, htv, mask, __ldg(keys + r), payload);
}

__global__ void __launch_bounds__(kThreads)
probe_count(const int* __restrict__ keys, long long n,
            const int* __restrict__ htk, const int* __restrict__ htv,
            unsigned mask, int* __restrict__ counts) {
  __shared__ int warp_counts[kWarps];
  const long long base = kTile * blockIdx.x;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int payload;
    c += found(keys, base + static_cast<long long>(i) * kThreads + threadIdx.x,
               n, htk, htv, mask, &payload);
  }
  const int total = block_sum(c, warp_counts);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
probe_scatter(const int* __restrict__ keys, const int* __restrict__ vals,
              long long n, const int* __restrict__ htk,
              const int* __restrict__ htv, unsigned mask,
              const int* __restrict__ counts, const int* __restrict__ offsets,
              int* __restrict__ out_payload, int* __restrict__ out_vals) {
  __shared__ int warp_counts[kWarps];
  if (counts[blockIdx.x] == 0) return;           // uniform over the block
  const long long base = kTile * blockIdx.x;
  int pos = offsets[blockIdx.x];
  for (int i = 0; i < kItems; ++i) {
    const long long r = base + static_cast<long long>(i) * kThreads +
                        threadIdx.x;
    int payload = 0;
    const bool hit = found(keys, r, n, htk, htv, mask, &payload);
    int total;
    const int rank = block_rank(hit, warp_counts, &total);
    if (hit) {
      out_payload[pos + rank] = payload;
      out_vals[pos + rank] = __ldg(vals + r);
    }
    pos += total;
  }
}

constexpr int kAggItems = 4;       // rows a thread probes at once

__device__ __forceinline__ void add_hit(int payload, const int* vals,
                                        long long r, unsigned long long* s) {
  *s += static_cast<unsigned long long>(static_cast<long long>(payload) +
                                        __ldg(vals + r));
}

__device__ __forceinline__ void add_hit(int payload, const float* vals,
                                        long long r, double* s) {
  *s += static_cast<double>(__fadd_rn(__int2float_rn(payload),
                                      __ldg(vals + r)));
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kSumThreads)
probe_agg_partials(const int* __restrict__ keys, const T* __restrict__ vals,
                   long long n, const int* __restrict__ htk,
                   const int* __restrict__ htv, unsigned mask,
                   Acc* __restrict__ partials) {
  const long long tile = static_cast<long long>(kSumThreads) * kAggItems;
  const long long stride = tile * gridDim.x;
  Acc s = Acc(0);
  for (long long base = tile * blockIdx.x; base < n; base += stride) {
    int key[kAggItems];
#pragma unroll
    for (int i = 0; i < kAggItems; ++i) {
      const long long r = base + static_cast<long long>(i) * kSumThreads +
                          threadIdx.x;
      key[i] = r < n ? __ldg(keys + r) : 0;
    }
#pragma unroll
    for (int i = 0; i < kAggItems; ++i) {
      const long long r = base + static_cast<long long>(i) * kSumThreads +
                          threadIdx.x;
      int payload = 0;
      if (r < n && probe(htk, htv, mask, key[i], &payload))
        add_hit(payload, vals, r, &s);
    }
  }
  s = block_total(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

}  // namespace

// Blocks of probe_agg's partial kernel resident on the card (its grid is
// the rows over 1024, up to this).
extern "C" int probe_agg_shape(int is_float, long long* resident) {
  if (is_float)
    return resident_blocks(probe_agg_partials<float, double>, resident);
  return resident_blocks(probe_agg_partials<int, unsigned long long>,
                         resident);
}

extern "C" long long probe_agg_tile_rows() {
  return static_cast<long long>(kSumThreads) * kAggItems;
}

// keys: (n,) int32; vals: (n,) int32 (is_float 0) or f32; htk, htv:
// (mask + 1,) int32, mask + 1 a power of two; partials: `blocks` 8-byte
// scratch (int64 or f64); out: one int32 or f32.  Launches the partial
// kernel and finish_sum on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int probe_agg_launch(const void* keys, const void* vals,
                                long long n, int is_float, const void* htk,
                                const void* htv, unsigned mask,
                                long long blocks, void* partials, void* out,
                                void* stream) {
  if (n <= 0 || blocks < 1 || blocks > 2147483647LL ||
      (mask & (mask + 1u)) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int* k = static_cast<const int*>(keys);
  const int* tk = static_cast<const int*>(htk);
  const int* tv = static_cast<const int*>(htv);
  if (is_float) {
    probe_agg_partials<float, double><<<grid, kSumThreads, 0, s>>>(
        k, static_cast<const float*>(vals), n, tk, tv, mask,
        static_cast<double*>(partials));
    finish_sum<<<1, kFinishThreads, 0, s>>>(
        static_cast<const double*>(partials), static_cast<int>(blocks),
        static_cast<float*>(out));
  } else {
    probe_agg_partials<int, unsigned long long><<<grid, kSumThreads, 0, s>>>(
        k, static_cast<const int*>(vals), n, tk, tv, mask,
        static_cast<unsigned long long*>(partials));
    finish_sum<<<1, kFinishThreads, 0, s>>>(
        static_cast<const unsigned long long*>(partials),
        static_cast<int>(blocks), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// keys, vals: (n,) int32; htk, htv: (mask + 1,) int32, mask + 1 a power of
// two; counts, offsets: (ceil(n / 2048),) int32 scratch; out_payload,
// out_vals: (n,) int32, zeroed; count: one int64.  0 < n < 2^31.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int probe_join_launch(const void* keys, const void* vals,
                                 long long n, const void* htk,
                                 const void* htv, unsigned mask, void* counts,
                                 void* offsets, void* out_payload,
                                 void* out_vals, void* count, void* stream) {
  if (n <= 0 || n > 2147483647LL || (mask & (mask + 1u)) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTile - 1) / kTile;
  const int* k = static_cast<const int*>(keys);
  const int* tk = static_cast<const int*>(htk);
  const int* tv = static_cast<const int*>(htv);
  int* c = static_cast<int*>(counts);
  int* o = static_cast<int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_count<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      k, n, tk, tv, mask, c);
  scan_tiles<<<1, kScanThreads, 0, s>>>(c, o, static_cast<int>(tiles),
                                        static_cast<long long*>(count));
  probe_scatter<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      k, static_cast<const int*>(vals), n, tk, tv, mask, c, o,
      static_cast<int*>(out_payload), static_cast<int*>(out_vals));
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long probe_join_tile_rows() { return kTile; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
