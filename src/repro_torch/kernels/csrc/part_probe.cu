// Partitioned probe for Hopper (sm_90a): one launch probes every
// partition of a radix-partitioned join against its own table (paper
// §4.4, Fig. 8).
//
// Replaces the Pallas TPU kernel src/repro/kernels/part_probe.py::
// part_probe (_part_probe_kernel).  That kernel walks the partitions in
// grid order, windows partition p's row of the packed (P, S) tables into
// VMEM, and carries the output offset in SMEM from step to step.  Its
// output is the stable compaction, in flat order, of the rows i < Σcounts
// with rowid_i >= 0 whose key is found in table key_i & (P - 1): the probe
// side is partition-major, so a row's partition is the one its low bits
// name.  Here that compaction runs as compact.cuh's three phases (count,
// scan of the tile counts, scatter) with a predicate that probes row
// key & (P - 1) of the tables through hash.cuh's walk, so the output is
// the same bits on every run, whatever order blocks run in.  A match
// writes its rowid and group + payload * mult (int32, wrapping).
//
// What bounds it: device-memory bytes at 3.35 TB/s.  The function needs
// keys, rowids and groups read for the live rows (12 bytes a row), the
// table segments its probes visit, and 8 bytes written a match.  The
// tables stay in device memory and are read through L2: a partition's
// table is S * 8 bytes, which fits one block's 227 KB of shared memory
// only while S <= 28 K slots, and a block here holds rows of many
// partitions.  Staging a partition's table in shared memory (one block,
// or a cluster, per partition run) is later work.  As in hash_join.cu the
// scatter probes again rather than keep each row's result from the count
// phase.
//
// The caller zeroes the outputs: entries past the count stay zero.
#include <cuda_runtime.h>

#include "compact.cuh"
#include "hash.cuh"

namespace {

struct PartProbe {
  const int* keys;
  const int* rowids;
  long long n;
  const int* offs;            // (P,) start of each partition's run
  const int* counts;          // (P,) its length
  int last;                   // P - 1: the partition of a key is key & last
  const int* htk;             // (P, S) packed tables
  const int* htv;
  unsigned slot_mask;         // S - 1

  // Rows past the partition runs never match: the runs end at
  // offs[P - 1] + counts[P - 1], read on the device (no host round trip).
  __device__ __forceinline__ long long limit() const {
    const long long end = static_cast<long long>(__ldg(offs + last)) +
                          __ldg(counts + last);
    return end < n ? end : n;
  }

  __device__ __forceinline__ bool operator()(long long r, long long lim,
                                             int* payload) const {
    if (r >= lim || __ldg(rowids + r) < 0) return false;
    const int key = __ldg(keys + r);
    const long long row = static_cast<long long>(key & last) *
                          (static_cast<long long>(slot_mask) + 1);
    return probe(htk + row, htv + row, slot_mask, key, payload);
  }
};

__global__ void __launch_bounds__(kThreads)
part_probe_count(const PartProbe found, int* __restrict__ counts) {
  __shared__ int warp_counts[kWarps];
  const long long lim = found.limit();
  const long long first = kTile * blockIdx.x;
  int c = 0;
  if (first < lim) {                             // uniform over the block
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      int payload;
      c += found(first + static_cast<long long>(i) * kThreads + threadIdx.x,
                 lim, &payload);
    }
  }
  const int total = block_sum(c, warp_counts);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
part_probe_scatter(const PartProbe found, const int* __restrict__ groups,
                   int mult, const int* __restrict__ counts,
                   const int* __restrict__ offsets,
                   int* __restrict__ out_rowids,
                   int* __restrict__ out_groups) {
  __shared__ int warp_counts[kWarps];
  if (counts[blockIdx.x] == 0) return;           // uniform over the block
  const long long lim = found.limit();
  const long long first = kTile * blockIdx.x;
  int pos = offsets[blockIdx.x];
  for (int i = 0; i < kItems; ++i) {
    const long long r = first + static_cast<long long>(i) * kThreads +
                        threadIdx.x;
    int payload = 0;
    const bool hit = found(r, lim, &payload);
    int total;
    const int rank = block_rank(hit, warp_counts, &total);
    if (hit) {
      out_rowids[pos + rank] = __ldg(found.rowids + r);
      out_groups[pos + rank] = static_cast<int>(
          static_cast<unsigned>(__ldg(groups + r)) +
          static_cast<unsigned>(payload) * static_cast<unsigned>(mult));
    }
    pos += total;
  }
}

}  // namespace

// keys, rowids, groups: (n,) int32, partition-major; offs, counts: (P,)
// int32; htk, htv: (P, S) int32, P and S powers of two; tile_counts,
// tile_offsets: (ceil(n / 2048),) int32 scratch; out_rowids, out_groups:
// (n,) int32, zeroed; count: one int64.  0 < n < 2^31.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int part_probe_launch(const void* keys, const void* rowids,
                                 const void* groups, long long n,
                                 const void* offs, const void* counts,
                                 int n_parts, const void* htk,
                                 const void* htv, unsigned slot_mask,
                                 int mult, void* tile_counts,
                                 void* tile_offsets, void* out_rowids,
                                 void* out_groups, void* count,
                                 void* stream) {
  if (n <= 0 || n > 2147483647LL || n_parts < 1 ||
      (n_parts & (n_parts - 1)) != 0 || (slot_mask & (slot_mask + 1u)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTile - 1) / kTile;
  const PartProbe found{static_cast<const int*>(keys),
                        static_cast<const int*>(rowids), n,
                        static_cast<const int*>(offs),
                        static_cast<const int*>(counts), n_parts - 1,
                        static_cast<const int*>(htk),
                        static_cast<const int*>(htv), slot_mask};
  int* c = static_cast<int*>(tile_counts);
  int* o = static_cast<int*>(tile_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  part_probe_count<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(found,
                                                                     c);
  scan_tiles<<<1, kScanThreads, 0, s>>>(c, o, static_cast<int>(tiles),
                                        static_cast<long long*>(count));
  part_probe_scatter<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      found, static_cast<const int*>(groups), mult, c, o,
      static_cast<int*>(out_rowids), static_cast<int*>(out_groups));
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long part_probe_tile_rows() { return kTile; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
