// Probe-join for Hopper (sm_90a): the rows whose key is found in a
// linear-probe table, as stable compacted (payload, val) pairs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_join.py::
// probe_join (_probe_join_kernel): BlockLookup, then BlockScan and
// BlockShuffle of the found rows, with the running output offset carried
// across an in-order grid.  Here one launch sweeps the rows once
// (lookback.cuh): a block takes tiles of 2048 rows from a ticket, probes
// each row once, ranks its hits and finds the output offset of each tile
// by decoupled look-back over the tiles before it, the counterpart of the
// carried offset.  The output is stable and the same bits on every run.
//
// What bounds it: the function needs the keys and vals read once (8n
// bytes), 8 bytes written per found row and the table segments its
// probes visit: at 3.35 TB/s that is the bound, but the probes take the
// time.  Each is a dependent read of a table that stays in L1 or the 50
// MB L2 (an SSB dimension table at SF 20 is at most a few MB), and a
// tile's rows wait on a chain of them: the keys, the home slots, the runs
// past them, the payloads.  What the design does about it: every row is
// probed once (the old count-and-scatter pair probed it twice); a
// thread's rows have their loads of each step in flight together; a run
// step reads the aligned 32-byte run of 8 slots past the home slot
// (hash.cuh), so a chain within a run costs one read; vals are read only
// for found rows; a tile's look-back waits a whole tile after its count
// is published, so it seldom spins; the output is written from shared
// memory in runs.  The misses of each tile write their share of the
// zeros past the count, so no fill runs before it and a call is one
// memset (the status words and the ticket) and one kernel.
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
//
// build: the open-addressing linear-probe table of (key, val) rows.
// Replaces src/repro/kernels/hash_join.py::build (_build_kernel), which
// inserts the rows one by one in row order across a grid that runs in
// order: each row takes the first EMPTY slot from hash(key), so the first
// row of a duplicate key is found first.  Hopper threads insert at once,
// and a plain CAS of the key would place rows in whatever order the
// threads win.  So the insert places ROW IDS by ordered linear probing:
// an int32 slot array (kNoRow where free); a thread carries a row from
// its home slot; at a free slot it CASes its row in, at a slot held by a
// higher row it CASes its row in and carries the displaced row on from
// the next slot, at a lower row it moves on.  The layout that results is
// unique, whatever order the CASes win: each row sits past its home only
// over lower rows, which is the row-order sequential table.  A second
// pass writes htk[s] = keys[row[s]] and htv[s] = vals[row[s]] (EMPTY and
// 0 where free).  What bounds it: device-memory bytes, the keys and vals
// read once and the table written once (8n + 8S); the slot array (4S,
// written and read) and the CASes, one per probe step, come on top, and
// at half fill a row's walk is short.  The wrapper raises for n > S and
// for a key equal to EMPTY, which no such table can hold.
#include <cuda_runtime.h>

#include "hash.cuh"
#include "lookback.cuh"
#include "reduce.cuh"

namespace {

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

namespace {

constexpr int kNoRow = 2147483647;             // INT32_MAX: a free slot
constexpr int kBuildThreads = 256;

__global__ void __launch_bounds__(kBuildThreads)
build_clear(int* __restrict__ rows, long long n_slots) {
  const long long stride = static_cast<long long>(gridDim.x) * kBuildThreads;
  for (long long s = static_cast<long long>(blockIdx.x) * kBuildThreads +
                     threadIdx.x;
       s < n_slots; s += stride)
    rows[s] = kNoRow;
}

__global__ void __launch_bounds__(kBuildThreads)
build_insert(const int* __restrict__ keys, long long n, unsigned mask,
             int* __restrict__ rows) {
  const long long stride = static_cast<long long>(gridDim.x) * kBuildThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kBuildThreads +
                     threadIdx.x;
       i < n; i += stride) {
    int r = static_cast<int>(i);
    unsigned s = (static_cast<unsigned>(__ldg(keys + i)) * kHashMul) & mask;
    // A filled slot is never freed, only taken by a lower row, so each
    // CAS either places r or names the row that holds the slot now.
    int expect = kNoRow;               // first guess: the slot is free
    while (true) {
      const int held = atomicCAS(rows + s, expect, r);
      if (held == expect) {            // r is in slot s
        if (held == kNoRow) break;
        r = held;                      // carry the displaced higher row on
        s = (s + 1u) & mask;
        expect = kNoRow;
      } else if (held > r) {
        expect = held;                 // displace it: CAS again at s
      } else {
        s = (s + 1u) & mask;           // a lower row holds s: move on
        expect = kNoRow;
      }
    }
  }
}

__global__ void __launch_bounds__(kBuildThreads)
build_emit(const int* __restrict__ rows, const int* __restrict__ keys,
           const int* __restrict__ vals, long long n_slots,
           int* __restrict__ htk, int* __restrict__ htv) {
  const long long stride = static_cast<long long>(gridDim.x) * kBuildThreads;
  for (long long s = static_cast<long long>(blockIdx.x) * kBuildThreads +
                     threadIdx.x;
       s < n_slots; s += stride) {
    const int r = rows[s];
    htk[s] = r == kNoRow ? kEmpty : __ldg(keys + r);
    htv[s] = r == kNoRow ? 0 : __ldg(vals + r);
  }
}

}  // namespace

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

// keys, vals: (n,) int32, no key EMPTY; rows: (mask + 1,) int32 scratch;
// htk, htv: (mask + 1,) int32 outputs, mask + 1 a power of two >= n.
// 0 <= n < 2^31.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int build_launch(const void* keys, const void* vals, long long n,
                            unsigned mask, void* rows, void* htk, void* htv,
                            void* stream) {
  const long long n_slots = static_cast<long long>(mask) + 1;
  if (n < 0 || n > n_slots || n > 2147483646LL ||
      (mask & (mask + 1u)) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* r = static_cast<int*>(rows);
  const int* k = static_cast<const int*>(keys);
  auto blocks = [](long long items) {
    const long long b = (items + kBuildThreads - 1) / kBuildThreads;
    return static_cast<unsigned>(b < 65536 ? b : 65536);
  };
  build_clear<<<blocks(n_slots), kBuildThreads, 0, s>>>(r, n_slots);
  if (n > 0)
    build_insert<<<blocks(n), kBuildThreads, 0, s>>>(k, n, mask, r);
  build_emit<<<blocks(n_slots), kBuildThreads, 0, s>>>(
      r, k, static_cast<const int*>(vals), n_slots, static_cast<int*>(htk),
      static_cast<int*>(htv));
  return static_cast<int>(cudaGetLastError());
}

namespace {

// probe_join's rows, table and outputs (lookback.cuh's Op).
struct JoinProbe {
  const int* keys;
  const int* vals;
  long long n;
  const int* htk;
  const int* htv;
  unsigned mask;
  int* out_a;                                   // payloads
  int* out_b;                                   // vals

  using Extra = int;                            // the row's val
  __device__ __forceinline__ long long limit() const { return n; }
  __device__ __forceinline__ bool load(unsigned r, int* key) const {
    *key = __ldg(keys + r);
    return true;
  }
  __device__ __forceinline__ const int* keys_of(int) const { return htk; }
  __device__ __forceinline__ unsigned slot_of(int, unsigned s) const {
    return s;
  }
  __device__ __forceinline__ Extra fetch(unsigned r) const {
    return __ldg(vals + r);
  }
  __device__ __forceinline__ int2 result(int payload, Extra val) const {
    return make_int2(payload, val);
  }
};

template <int W>
__global__ void __launch_bounds__(kSweepThreads, kProbeBlocks)
probe_join_sweep(const JoinProbe op, unsigned* status, long long* count) {
  const unsigned n = static_cast<unsigned>(op.n);
  probe_sweep<W>(op, n, status, status + (n + kProbeTile - 1) / kProbeTile,
                 count);
}

// probe_join_launch's arguments, passed by one pointer (a ctypes call
// pays for each argument it converts).
struct JoinArgs {
  const int* keys;
  const int* vals;
  long long n;
  const int* htk;
  const int* htv;
  unsigned mask;
  int* out_payload;
  int* out_vals;
  long long* count;
  unsigned* status;
  long long blocks;                             // resident blocks
};

}  // namespace

// Blocks of the sweep resident on the current device (`which` is 0).
extern "C" int probe_join_shape(int which, long long* resident) {
  if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sweep_blocks(probe_join_sweep<8>, resident);
}

// args: a JoinArgs (void here, so the entry keeps external linkage).
// keys, vals: (n,) int32; htk, htv: (mask + 1,) int32, mask + 1 a power
// of two; out_payload, out_vals: (n,) int32, written whole (zeros past the
// count); count: one int64; status: probe_join_status_words(n) words of
// scratch, cleared here; blocks: probe_join_shape's.  0 < n < 2^31.  Asks
// the runtime nothing but the memset and the launch.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int probe_join_launch(const void* args, void* stream) {
  const JoinArgs& a = *static_cast<const JoinArgs*>(args);
  if (a.n <= 0 || a.n > 2147483647LL || (a.mask & (a.mask + 1u)) != 0u ||
      a.blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (a.n + kProbeTile - 1) / kProbeTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      a.status, 0, sizeof(unsigned) * static_cast<size_t>(tiles + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const JoinProbe op{a.keys, a.vals, a.n,           a.htk,
                     a.htv,  a.mask, a.out_payload, a.out_vals};
  const unsigned grid = static_cast<unsigned>(
      tiles < a.blocks ? tiles : a.blocks);
  switch (run_slots(a.mask, a.htk)) {
    case 8:
      probe_join_sweep<8><<<grid, kSweepThreads, 0, s>>>(op, a.status,
                                                          a.count);
      break;
    case 4:
      probe_join_sweep<4><<<grid, kSweepThreads, 0, s>>>(op, a.status,
                                                          a.count);
      break;
    case 2:
      probe_join_sweep<2><<<grid, kSweepThreads, 0, s>>>(op, a.status,
                                                          a.count);
      break;
    default:
      probe_join_sweep<1><<<grid, kSweepThreads, 0, s>>>(op, a.status,
                                                          a.count);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scratch words probe_join_launch takes for n rows: a status word per
// tile and the ticket.
extern "C" long long probe_join_status_words(long long n) {
  return (n + kProbeTile - 1) / kProbeTile + 1;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
