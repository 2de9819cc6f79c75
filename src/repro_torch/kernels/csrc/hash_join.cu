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
#include <cuda_runtime.h>

#include "compact.cuh"
#include "hash.cuh"

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

}  // namespace

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
