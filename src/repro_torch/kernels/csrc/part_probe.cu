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
// name.  Here that compaction is one sweep (lookback.cuh, as probe_join's
// in hash_join.cu): a block takes tiles of 2048 rows from a ticket,
// probes each live row once in row key & (P - 1) of the tables, ranks its
// hits and finds each tile's output offset by decoupled look-back, the
// counterpart of the carried offset.  A match writes its rowid and group
// + payload * mult (int32, wrapping).  The output is the same bits on
// every run, whatever order blocks run in.
//
// What bounds it: the function needs the rowids read for the rows before
// the runs' end and the keys and groups of the live ones (12 bytes a
// row), the table segments its probes visit and 8 bytes written a match:
// at 3.35 TB/s that is the bound, but the probes take the time.  A
// partition's keys share their low bits, and so do their hashes, so only
// S / P home slots of a row are used and chains cluster (7.29 slots a hit
// on one SSB join at SF 20, against 1.01 in the whole table).  What the
// design does about it: each row is probed once; the home slots of a
// thread's rows are read at once, then the aligned 32-byte runs of 8
// slots past them (hash.cuh's load_run / read_run), so a clustered chain
// costs a read a run, not a read a slot; the runs' end is read once a
// block.  The tables are read through L1 and L2; staging a partition's
// row in shared memory is not tried (a tile holds rows of many partitions
// when P is large, and S * 4 bytes of one partition's keys outgrow a
// block's share of shared memory when P is small).  The misses of each
// tile write their share of the zeros past the count, so a call is one
// memset (the status words and the ticket) and one kernel.
#include <cuda_runtime.h>

#include "hash.cuh"
#include "lookback.cuh"

namespace {

// part_probe's rows, tables and outputs (lookback.cuh's Op).
struct PartProbe {
  const int* keys;
  const int* rowids;
  const int* groups;
  long long n;
  const int* offs;            // (P,) start of each partition's run
  const int* counts;          // (P,) its length
  int last;                   // P - 1: the partition of a key is key & last
  const int* htk;             // (P, S) packed tables
  const int* htv;
  unsigned mask;              // S - 1
  int mult;
  int* out_a;                 // rowids
  int* out_b;                 // groups + payload * mult

  using Extra = int2;                           // the row's rowid, group
  // Rows past the partition runs never match: the runs end at
  // offs[P - 1] + counts[P - 1], read on the device (no host round trip).
  __device__ __forceinline__ long long limit() const {
    const long long end = static_cast<long long>(__ldg(offs + last)) +
                          __ldg(counts + last);
    return end < n ? end : n;
  }
  __device__ __forceinline__ bool load(unsigned r, int* key) const {
    *key = __ldg(keys + r);
    return __ldg(rowids + r) >= 0;        // a dead row never matches
  }
  // Row key & (P - 1) of the tables starts at that times S; P * S <= 2^32
  // (the wrapper's check), so a slot's index into them fits 32 bits.
  __device__ __forceinline__ unsigned row_of(int key) const {
    return static_cast<unsigned>(key & last) * (mask + 1u);
  }
  __device__ __forceinline__ const int* keys_of(int key) const {
    return htk + row_of(key);
  }
  __device__ __forceinline__ unsigned slot_of(int key, unsigned s) const {
    return row_of(key) + s;
  }
  __device__ __forceinline__ Extra fetch(unsigned r) const {
    return make_int2(__ldg(rowids + r), __ldg(groups + r));
  }
  __device__ __forceinline__ int2 result(int payload, Extra row) const {
    return make_int2(row.x, static_cast<int>(
        static_cast<unsigned>(row.y) +
        static_cast<unsigned>(payload) * static_cast<unsigned>(mult)));
  }
};

template <int W>
__global__ void __launch_bounds__(kSweepThreads, kProbeBlocks)
part_probe_sweep(const PartProbe op, unsigned* status, long long* count) {
  const unsigned n = static_cast<unsigned>(op.n);
  probe_sweep<W>(op, n, status, status + (n + kProbeTile - 1) / kProbeTile,
                 count);
}

// part_probe_launch's arguments, passed by one pointer (a ctypes call
// pays for each argument it converts).
struct PartArgs {
  const int* keys;
  const int* rowids;
  const int* groups;
  long long n;
  const int* offs;
  const int* counts;
  int n_parts;
  const int* htk;
  const int* htv;
  unsigned slot_mask;
  int mult;
  int* out_rowids;
  int* out_groups;
  long long* count;
  unsigned* status;
  long long blocks;                             // resident blocks
};

}  // namespace

// Blocks of the sweep resident on the current device (`which` is 0).
extern "C" int part_probe_shape(int which, long long* resident) {
  if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sweep_blocks(part_probe_sweep<8>, resident);
}

// args: a PartArgs (void here, so the entry keeps external linkage).
// keys, rowids, groups: (n,) int32, partition-major; offs, counts: (P,)
// int32; htk, htv: (P, S) int32, P and S powers of two (slot_mask S - 1);
// out_rowids, out_groups: (n,) int32, written whole (zeros past the
// count); count: one int64; status: part_probe_status_words(n) words of
// scratch, cleared here; blocks: part_probe_shape's.  0 < n < 2^31.  Asks
// the runtime nothing but the memset and the launch.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int part_probe_launch(const void* args, void* stream) {
  const PartArgs& a = *static_cast<const PartArgs*>(args);
  if (a.n <= 0 || a.n > 2147483647LL || a.n_parts < 1 ||
      (a.n_parts & (a.n_parts - 1)) != 0 ||
      (a.slot_mask & (a.slot_mask + 1u)) != 0u || a.blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (a.n + kProbeTile - 1) / kProbeTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      a.status, 0, sizeof(unsigned) * static_cast<size_t>(tiles + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PartProbe op{a.keys,  a.rowids,    a.groups, a.n,
                     a.offs,  a.counts,    a.n_parts - 1, a.htk,
                     a.htv,   a.slot_mask, a.mult,   a.out_rowids,
                     a.out_groups};
  const unsigned grid = static_cast<unsigned>(
      tiles < a.blocks ? tiles : a.blocks);
  switch (run_slots(a.slot_mask, a.htk)) {
    case 8:
      part_probe_sweep<8><<<grid, kSweepThreads, 0, s>>>(op, a.status,
                                                          a.count);
      break;
    case 4:
      part_probe_sweep<4><<<grid, kSweepThreads, 0, s>>>(op, a.status,
                                                          a.count);
      break;
    case 2:
      part_probe_sweep<2><<<grid, kSweepThreads, 0, s>>>(op, a.status,
                                                          a.count);
      break;
    default:
      part_probe_sweep<1><<<grid, kSweepThreads, 0, s>>>(op, a.status,
                                                          a.count);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scratch words part_probe_launch takes for n rows: a status word per
// tile and the ticket.
extern "C" long long part_probe_status_words(long long n) {
  return (n + kProbeTile - 1) / kProbeTile + 1;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
