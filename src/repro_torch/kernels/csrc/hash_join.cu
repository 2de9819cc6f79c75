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
// that runs in order; here each resident block sums its tiles and
// reduce.cuh's finish_sum adds the blocks' partials in a fixed order.
// int32 vals: each payload + v and the sum wrap as the reference's int32
// adds (summed in 64 bits, cut once); f32 vals: payload + v rounded to
// f32 as the reference's add, summed in f64, rounded once.  What bounds
// it: the keys and vals read once (8 bytes a row) and the table segments
// the probes visit; for a table past the 50 MB L2, those segments at the
// share of the table the L2 holds and a sector a probe from device memory
// at the share it cannot.  A probe
// is a chain of dependent reads: the key, its home slot, the runs past
// it, the payload.  What the design does about it: a thread's 8 rows load
// their keys and vals together, then issue every home slot's key and
// payload load at once (the payload's address does not wait on the key
// read, so a hit at home is one round trip); only the rows still walking
// go on, a 32-byte run a step (hash.cuh).  The table is first copied as
// 8-byte slots, each key beside its payload (pair_slots, one read and one
// write of the table, in the call), so that a probe reads one sector
// where the two arrays cost two: the sectors, from the L2 as much as from
// device memory, are what a probe waits on, and on an H100 the copy won
// at every table from 8 KB to 256 MB (2^28 probes).
//
// build: the open-addressing linear-probe table of (key, val) rows.
// Replaces src/repro/kernels/hash_join.py::build (_build_kernel), which
// inserts the rows one by one in row order across a grid that runs in
// order: each row takes the first EMPTY slot from hash(key), so the first
// row of a duplicate key is found first.  Hopper threads insert at once,
// and a plain CAS of the key would place rows in whatever order the
// threads win.  So the insert places ROW IDS by ordered linear probing:
// a slot array of 4-byte rows (all ones where free, above every row); a
// thread carries a row from its home slot; at a free slot it CASes its
// row in, at a slot held by a higher row it CASes its row in and carries
// the displaced row on from the next slot, at a lower row it moves on.
// The layout that results is unique, whatever order the CASes win: each
// row sits past its home only over lower rows, which is the row-order
// sequential table.  The insert also writes each row's (key, val) as one
// 8-byte word, and the emit gathers that word for every filled slot: one
// random sector a slot, where the row's key and val from their own
// arrays cost two.  A call is one cooperative launch (build_table: clear,
// insert, emit, split by grid syncs; kBuildItems rows a thread, their
// CASes in flight together) and, in the wrapper, one 4-byte read of the
// flag the insert raises for a key equal to EMPTY, which no such table
// can hold.  8-byte slots of (row, key), which spare the copy and emit
// the key from the slot, tied at 256 MB and lost at 64 MB, where their
// slot array no longer fits the 50 MB L2 (PERF.md §6).  What bounds
// it: device-memory bytes, the keys and vals read once and the table
// written once (8n + 8S); the slot array (4S, cleared, then read by the
// emit), the copy (8n, written, then gathered) and the CASes, one per
// probe step, random sectors once the slot array outgrows the L2, come on
// top.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hash.cuh"
#include "lookback.cuh"
#include "reduce.cuh"

namespace {

// probe_agg's shape: rows a thread holds (their keys, vals, home keys and
// home payloads all in flight at once), rows whose walk runs load at once,
// and the blocks an SM the kernel is built for (64 registers a thread; 48
// used, no spills).  Chosen by timing shapes on an H100: 2 rows' runs at
// once spilled, 4 or 16 rows a thread and 3 or 8 blocks an SM were no
// faster over the six tables of the join microbenchmark.
constexpr int kAggItems = 8;
constexpr int kAggGroup = 1;
constexpr int kAggBlocks = 4;
constexpr long long kAggTile =
    static_cast<long long>(kSumThreads) * kAggItems;
constexpr int kPairThreads = 256;
static_assert(kAggItems % kAggGroup == 0, "whole groups of rows");
static_assert(kAggItems <= 32, "a row's flags are the bits of a word");

__device__ __forceinline__ void add_hit(int payload, int v,
                                        unsigned long long* s) {
  *s += static_cast<unsigned long long>(static_cast<long long>(payload) + v);
}

__device__ __forceinline__ void add_hit(int payload, float v, double* s) {
  *s += static_cast<double>(__fadd_rn(__int2float_rn(payload), v));
}

// A walk step's run of W 8-byte slots, each key beside its payload (32
// bytes, one sector, for W = 4): a hit's payload is in the registers of
// the run that found it.
template <int W>
struct PairRun {
  SlotRun<W> keys;
  int vals[W];
};

template <int W>
__device__ __forceinline__ PairRun<W> load_pairs(
    const int2* __restrict__ slots, unsigned base) {
  static_assert(W == 1 || W == 2 || W == 4, "a run of 1-4 pairs");
  PairRun<W> run;
  if constexpr (W == 1) {
    const int2 p = __ldg(slots + base);
    run.keys.k[0] = p.x;
    run.vals[0] = p.y;
  } else {
#pragma unroll
    for (int h = 0; h < W; h += 2) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(slots + base + h));
      run.keys.k[h] = q.x;
      run.vals[h] = q.y;
      run.keys.k[h + 1] = q.z;
      run.vals[h + 1] = q.w;
    }
  }
  return run;
}

// The payload at the run's place `at` (slot - base), picked without
// indexing the array, which would put it in local memory.
template <int W>
__device__ __forceinline__ int run_payload(const PairRun<W>& run,
                                           unsigned at) {
  int p = 0;
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (at == static_cast<unsigned>(j)) p = run.vals[j];
  return p;
}

// One block's share of probe_agg: tiles of kAggTile rows, blockIdx.x,
// then every gridDim.x-th.  A thread's kAggItems rows (32 neighbours a
// warp a step, so loads coalesce) load their keys and vals, then the key
// and payload of every row's home slot at once; the rows whose home held
// neither their key nor EMPTY walk on a run a step (hash.cuh's run_base /
// read_run over the 8-byte slots), kAggGroup rows' runs loaded at once.
// The block's sum goes to partials[blockIdx.x] in a fixed order
// (reduce.cuh).
template <int W, typename T, typename Acc>
__global__ void __launch_bounds__(kSumThreads, kAggBlocks)
probe_agg_sweep(const int* __restrict__ keys, const T* __restrict__ vals,
                long long n, const int2* __restrict__ slots, unsigned mask,
                Acc* __restrict__ partials) {
  const long long stride = kAggTile * gridDim.x;
  Acc s = Acc(0);
  for (long long base = kAggTile * blockIdx.x; base < n; base += stride) {
    int key[kAggItems];
    T v[kAggItems];
    unsigned live = 0u;
#pragma unroll
    for (int i = 0; i < kAggItems; ++i) {
      const long long r = base + static_cast<long long>(i) * kSumThreads +
                          threadIdx.x;
      key[i] = 0;
      v[i] = T(0);
      if (r < n) {
        key[i] = __ldg(keys + r);
        v[i] = __ldg(vals + r);
        live |= 1u << i;
      }
    }
    // every home slot's key and payload at once: a hit at home is one
    // round trip
    int payload[kAggItems];
    unsigned hit = 0u, pending = 0u;
    {
      int at_home[kAggItems];
#pragma unroll
      for (int i = 0; i < kAggItems; ++i) {
        at_home[i] = kEmpty;
        payload[i] = 0;
        if (live & (1u << i)) {
          const int2 h = __ldg(slots + home_slot(key[i], mask));
          at_home[i] = h.x;
          payload[i] = h.y;
        }
      }
#pragma unroll
      for (int i = 0; i < kAggItems; ++i) {
        if (at_home[i] == key[i] && (live & (1u << i))) hit |= 1u << i;
        else if (at_home[i] != kEmpty) pending |= 1u << i;
      }
    }
    for (unsigned step = 0; pending; ++step) {
#pragma unroll
      for (int g = 0; g < kAggItems; g += kAggGroup) {
        if (!(pending & (((1u << kAggGroup) - 1u) << g))) continue;
        PairRun<W> run[kAggGroup];
#pragma unroll
        for (int j = 0; j < kAggGroup; ++j)
          if (pending & (1u << (g + j)))
            run[j] = load_pairs<W>(slots,
                                   run_base<W>(key[g + j], mask, step));
#pragma unroll
        for (int j = 0; j < kAggGroup; ++j) {
          const int i = g + j;
          if (!(pending & (1u << i))) continue;
          unsigned slot;
          const int res = read_run<W>(run[j].keys, key[i], mask, step,
                                      &slot);
          if (res == kWalkOn) continue;
          pending &= ~(1u << i);
          if (res == kHit) {
            hit |= 1u << i;
            payload[i] = run_payload<W>(
                run[j], slot - run_base<W>(key[i], mask, step));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kAggItems; ++i)
      if (hit & (1u << i)) add_hit(payload[i], v[i], &s);
  }
  s = block_total(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// The table as 8-byte slots: slots[s] = (htk[s], htv[s]).
__global__ void __launch_bounds__(kPairThreads)
pair_slots(const int* __restrict__ htk, const int* __restrict__ htv,
           long long n_slots, int2* __restrict__ slots) {
  const long long stride = static_cast<long long>(gridDim.x) * kPairThreads;
  for (long long s = static_cast<long long>(blockIdx.x) * kPairThreads +
                     threadIdx.x;
       s < n_slots; s += stride)
    slots[s] = make_int2(__ldg(htk + s), __ldg(htv + s));
}

// probe_agg_launch's arguments, passed by one pointer (a ctypes call
// pays for each argument it converts).
struct AggArgs {
  const int* keys;
  const void* vals;                             // int32, or f32 (is_float)
  long long n;
  int is_float;
  const int* htk;
  const int* htv;
  unsigned mask;
  int2* pairs;                  // (mask + 1,) 8-byte slots, filled here
  void* partials;                               // `blocks` int64 or f64
  void* out;                                    // one int32 or f32
  long long blocks;
};

template <int W, typename T, typename Acc, typename Out>
int launch_agg(const AggArgs& a, cudaStream_t s) {
  probe_agg_sweep<W, T, Acc>
      <<<static_cast<unsigned>(a.blocks), kSumThreads, 0, s>>>(
          a.keys, static_cast<const T*>(a.vals), a.n, a.pairs, a.mask,
          static_cast<Acc*>(a.partials));
  finish_sum<<<1, kFinishThreads, 0, s>>>(
      static_cast<const Acc*>(a.partials), static_cast<int>(a.blocks),
      static_cast<Out*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

// The copy, then the sweep, whose walk step reads 4 slots (32 bytes), or
// the whole of a smaller table, and the partials' sum.
template <typename T, typename Acc, typename Out>
int launch_typed(const AggArgs& a, cudaStream_t s) {
  const long long n_slots = static_cast<long long>(a.mask) + 1;
  long long grid = (n_slots + kPairThreads - 1) / kPairThreads;
  if (grid > 65536) grid = 65536;
  pair_slots<<<static_cast<unsigned>(grid), kPairThreads, 0, s>>>(
      a.htk, a.htv, n_slots, a.pairs);
  if (n_slots >= 4) return launch_agg<4, T, Acc, Out>(a, s);
  if (n_slots == 2) return launch_agg<2, T, Acc, Out>(a, s);
  return launch_agg<1, T, Acc, Out>(a, s);
}

}  // namespace

// Blocks of probe_agg's sweep resident on the card (its grid is the tiles
// up to this): which = is_float.
extern "C" int probe_agg_shape(int which, long long* resident) {
  switch (which) {
    case 0:
      return resident_blocks(probe_agg_sweep<4, int, unsigned long long>,
                             resident);
    case 1:
      return resident_blocks(probe_agg_sweep<4, float, double>, resident);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows of probe_agg's tile.
extern "C" long long probe_agg_tile_rows() { return kAggTile; }

// args: an AggArgs (void here, so the entry keeps external linkage).
// keys: (n,) int32; vals: (n,) int32 (is_float 0) or f32; htk, htv:
// (mask + 1,) int32, mask + 1 a power of two; pairs: mask + 1 8-byte
// slots of scratch, 16-byte aligned, which the call fills from htk and
// htv and probes through; partials: `blocks` 8-byte scratch (int64 or
// f64); out: one int32 or f32.  1 <= blocks < 2^31.  Launches the copy,
// the sweep and finish_sum on `stream`, asks the runtime nothing else,
// does not synchronise, returns cudaGetLastError().
extern "C" int probe_agg_launch(const void* args, void* stream) {
  const AggArgs& a = *static_cast<const AggArgs*>(args);
  if (a.n <= 0 || a.blocks < 1 || a.blocks > 2147483647LL ||
      (a.mask & (a.mask + 1u)) != 0u || a.pairs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.is_float) return launch_typed<float, double, float>(a, s);
  return launch_typed<int, unsigned long long, int>(a, s);
}

namespace {

constexpr unsigned kFreeRow = ~0u;              // above every row
constexpr int kBuildThreads = 256;
constexpr int kBuildItems = 4;          // rows a thread places at once

// Ordered linear probing of rows, kBuildItems of them in flight a thread:
// each round issues one CAS for every row still being placed, then moves
// each on.  A row at slot s: a free slot takes it; a slot held by a
// higher row takes it and the displaced row goes on from the next slot;
// a lower row's slot is passed.  A filled slot is never freed, only taken
// by a lower row, so each CAS either places the row or names the row that
// holds the slot now.  `live`: the rows still to place.
__device__ __forceinline__ void insert_rows(unsigned* slots, unsigned mask,
                                            unsigned* row, unsigned* s,
                                            unsigned live) {
  unsigned expect[kBuildItems];
#pragma unroll
  for (int i = 0; i < kBuildItems; ++i) expect[i] = kFreeRow;
  while (live != 0u) {
    unsigned held[kBuildItems];
#pragma unroll
    for (int i = 0; i < kBuildItems; ++i)
      if ((live >> i) & 1u) held[i] = atomicCAS(slots + s[i], expect[i],
                                                row[i]);
#pragma unroll
    for (int i = 0; i < kBuildItems; ++i) {
      if (!((live >> i) & 1u)) continue;
      if (held[i] == expect[i]) {
        if (held[i] == kFreeRow) {
          live &= ~(1u << i);
          continue;
        }
        row[i] = held[i];
        s[i] = (s[i] + 1u) & mask;
        expect[i] = kFreeRow;
      } else if (held[i] > row[i]) {
        expect[i] = held[i];
      } else {
        s[i] = (s[i] + 1u) & mask;
        expect[i] = kFreeRow;
      }
    }
  }
}

// A table slot from its row: the row's (key, val) (EMPTY and 0 where
// free), the one gather of the emit, read past L1 (the insert wrote it).
__device__ __forceinline__ int2 emit_slot(unsigned r,
                                          const int2* __restrict__ pairs) {
  if (r == kFreeRow) return make_int2(kEmpty, 0);
  return __ldcg(pairs + r);
}

// The whole build in one cooperative launch of at most the resident
// blocks, three phases split by grid syncs: clear (every slot free, two to an
// 8-byte store; the flag down), insert (each thread its rows, a stride of
// the grid apart, kBuildItems at once: the keys and vals loaded, the
// (key, val) words written, the CASes in flight together; a key equal to
// EMPTY raises the flag and is not placed), emit (two slots a thread
// step, the slot words read past L1, where the other SMs' CASes left
// them).  scratch: the (mask + 1) 4-byte slots, padded to 8 bytes, then
// the n (key, val) words.
__global__ void __launch_bounds__(kBuildThreads)
build_table(const int* __restrict__ keys, const int* __restrict__ vals,
            long long n, unsigned mask, unsigned long long* scratch,
            int* flag, int* __restrict__ htk, int* __restrict__ htv) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const long long n_slots = static_cast<long long>(mask) + 1;
  const long long pairs_n = n_slots / 2;
  const long long stride = static_cast<long long>(gridDim.x) * kBuildThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kBuildThreads +
                          threadIdx.x;
  unsigned* slots = reinterpret_cast<unsigned*>(scratch);
  int2* rows = reinterpret_cast<int2*>(scratch + (n_slots + 1) / 2);
  uint2* slot2 = reinterpret_cast<uint2*>(slots);
  for (long long i = first; i < pairs_n; i += stride)
    slot2[i] = make_uint2(kFreeRow, kFreeRow);
  if (first == 0) {
    if (n_slots == 1) slots[0] = kFreeRow;
    *flag = 0;
  }
  grid.sync();
  for (long long base = first; base < n; base += stride * kBuildItems) {
    unsigned row[kBuildItems], slot[kBuildItems], live = 0u;
    int k[kBuildItems], v[kBuildItems];
#pragma unroll
    for (int i = 0; i < kBuildItems; ++i) {
      const long long r = base + i * stride;
      k[i] = r < n ? __ldg(keys + r) : 0;
      v[i] = r < n ? __ldg(vals + r) : 0;
    }
#pragma unroll
    for (int i = 0; i < kBuildItems; ++i) {
      const long long r = base + i * stride;
      row[i] = static_cast<unsigned>(r);
      slot[i] = home_slot(k[i], mask);
      if (r < n) rows[r] = make_int2(k[i], v[i]);
      if (r < n && k[i] == kEmpty) *flag = 1;
      if (r < n && k[i] != kEmpty) live |= 1u << i;
    }
    insert_rows(slots, mask, row, slot, live);
  }
  grid.sync();
  int2* htk2 = reinterpret_cast<int2*>(htk);
  int2* htv2 = reinterpret_cast<int2*>(htv);
  for (long long i = first; i < pairs_n; i += stride) {
    const uint2 w = __ldcg(slot2 + i);
    const int2 a = emit_slot(w.x, rows), b = emit_slot(w.y, rows);
    htk2[i] = make_int2(a.x, b.x);
    htv2[i] = make_int2(a.y, b.y);
  }
  if (n_slots == 1 && first == 0) {
    const int2 a = emit_slot(__ldcg(slots), rows);
    htk[0] = a.x;
    htv[0] = a.y;
  }
}

}  // namespace

// Blocks of the build resident on the current device (`which` is 0): the
// most its cooperative launch takes.
extern "C" int build_shape(int which, long long* resident) {
  if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
  return resident_blocks(build_table, resident, kBuildThreads);
}

// keys, vals: (n,) int32; scratch: (mask + 2) / 2 + n + 1 8-byte words
// (the 4-byte slots, the (key, val) words, then the 4-byte flag), all
// written here (the flag is 1 after the launch when a
// key equals EMPTY, and the table is then not the rows'); htk, htv: (mask
// + 1,) int32 outputs, written whole, mask + 1 a power of two >= n,
// htv's address 8-byte aligned when mask > 0.  0 <= n < 2^31 - 1; blocks:
// 1 up to build_shape's.  One cooperative launch on `stream`, no other
// call; does not synchronise, returns the launch's error.
extern "C" int build_launch(const void* keys, const void* vals, long long n,
                            unsigned mask, long long blocks, void* scratch,
                            void* htk, void* htv, void* stream) {
  const long long n_slots = static_cast<long long>(mask) + 1;
  if (n < 0 || n > n_slots || n > 2147483646LL ||
      (mask & (mask + 1u)) != 0u || blocks < 1 || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* k = static_cast<const int*>(keys);
  const int* v = static_cast<const int*>(vals);
  unsigned long long* slots = static_cast<unsigned long long*>(scratch);
  int* flag = reinterpret_cast<int*>(slots + (n_slots + 1) / 2 + n);
  int* out_k = static_cast<int*>(htk);
  int* out_v = static_cast<int*>(htv);
  void* params[] = {&k, &v, &n, &mask, &slots, &flag, &out_k, &out_v};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(build_table),
      dim3(static_cast<unsigned>(blocks)), dim3(kBuildThreads), params, 0,
      static_cast<cudaStream_t>(stream)));
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
