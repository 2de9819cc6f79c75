// Fused select-project-join-aggregate pass for one SSB query, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssb_fused.py::spja
// (_make_kernel), for plain int32 streams and bit-packed ones.  Per fact
// row: closed-range predicates, up to kMaxJoins linear-probe lookups into
// open-addressing dimension tables (a miss filters the row), group id =
// sum of payload * mult (int32, wrapping), measure m1 / m1*m2 / m1-m2, and
// a sum per group.
//
// What bounds it: device-memory bytes at 3.35 TB/s.  A query's first
// column is read in full; a later column only in the 64-byte segments
// that still hold a live row, and a table only in the segments its
// probes visit.  At most that is every row of each column touched (q2.1:
// 4 columns x 120 M rows x 4 B = 1.92 GB at SF 20); chip_smoke.py counts
// what each query's data needs (must_move) and PERF.md holds the kernel's
// share of that bound per query.  The dimension tables are at most a few
// MB at SF 20 (the host build keeps the load at or below one half), so
// the probes stay in the 50 MB L2.
//
// Design for this card, not a copy of the Pallas grid:
//  * The TPU kernel carries one f32 accumulator through a grid that runs
//    in order.  Hopper blocks run in any order, and float atomics would
//    change the rounding from run to run.  The measures are int32
//    columns, so the sums are taken EXACTLY in int64: each block owns an
//    (n_groups,) int64 grid in dynamic shared memory (shared atomicAdd on
//    unsigned long long, two's complement), then adds each nonzero group
//    to the global int64 grid with one atomicAdd.  Integer addition is
//    associative, so the result is the same bits whatever the block
//    order, and the one int64 -> f32 cast (by the caller) equals the
//    numpy oracle's exact float64 sum cast to f32.  The reference's
//    premise that f32 partial sums of integers are exact fails at SF 20:
//    q1.1's sum is 2,246,830,080 (chip_smoke.py, seed 20), far past
//    f32's 2^24.
//  * The group grid does not set the occupancy.  n_groups 7000 (flight 2)
//    needs 56 KB of shared memory a block: at 256 threads that is 4
//    blocks, 32 warps an SM, where the registers allow 64.  So a block is
//    1024 threads, one grid a block: flight 2 runs 2 blocks, 64 warps.
//    Every plan runs such blocks: the 13 queries took 15.05 ms where
//    256-thread blocks for all but flight 2 took 16.04 (kernel_turns.py,
//    H100, in turns; flight 1, which keeps no grid, 0.82 -> 0.79).  The
//    4 + 4 and no-join instances hold 32 registers a thread
//    (__launch_bounds__), the most 64 warps an SM allow.  Flight 1 has
//    n_groups == 1: there every thread keeps its own sum in a register,
//    and one warp-shuffle reduction per warp replaces a shared atomic per
//    row.
//  * Any group count runs.  Up to kMaxSpan groups (the whole 227 KB a
//    block may have) the grid is wholly in shared memory, as every SSB
//    query's.  Past it a block keeps groups [0, kSpillSpan) in shared
//    memory and adds a row of a later group straight to the int64 output
//    in device memory (an atomicAdd that stays in the 50 MB L2), as
//    multi_fused.cu does; the spilling instance is a template of its own,
//    so a grid that fits runs the code it ran before.  kSpillSpan keeps
//    56 KB a block, flight 2's grid.  The sums stay exact int64
//    additions: the same bits in any order.
//  * The output grid may hold a caller's running sums (the morsel fold
//    passes one grid through every morsel): the kernel only adds to it.
//  * Two rows in flight a thread.  A thread takes kRows rows a step,
//    spaced the block's width apart (a warp reads 128 contiguous bytes a
//    column), and runs them through each stage together: the first
//    predicate column's loads for every row, then the compares; the next
//    column's loads for the rows still live; for each join every live
//    row's key, then every home slot (hash.cuh), then the walk past home
//    for the rows whose home slot held another key, then the payloads;
//    then the measures and the sums.  A row already filtered skips its
//    later loads and probes; each walk stops at its key or an EMPTY slot,
//    as the reference's lock-step loop does per lane.  Two rows won, held
//    to 32 registers: on the 13 queries at SF 20 (spja_ab.py, H100, in
//    turns) they took 16.4 ms, one row 22.1, four rows 23.3 (spilling at
//    32 registers; 22.1 at 64 registers and half the warps), eight 60.1
//    (28.6 at 64 registers).  A plan with no join (flight 1) runs an
//    instance with no join slots: q1.1-q1.3 0.821 / 0.438 / 0.348 ms
//    where the instance with join slots took 0.936 / 0.527 / 0.433 (there
//    four rows took 0.986 / 0.502 / 0.362, eight at 64 registers 1.372 /
//    0.721 / 0.531).  A grid-stride loop over as many blocks as fit on
//    the SMs at once; the ragged tail is masked.
//  * A live row whose group id falls outside [0, n_groups) is dropped,
//    as the reference's scatter drops it.
//  * Every stream, plain or bit-packed (src/repro_torch/sql/storage.py's
//    layout), is loaded by packed.cuh's decode: word r >> lg, lane shift
//    (r & (c-1)) * phys, mask, then the stream's reference (0 for a
//    predicate, whose bounds are already in the encoded domain).  A plain
//    int32 column is phys 32: lg 0, mask all ones, ref 0.  A warp reads
//    32 neighbouring rows, 128 * phys / 32 contiguous bytes, so a packed
//    column moves phys / 32 of a plain one's bytes.  One decode for both
//    kinds is also the faster code: with one row a thread ptxas gave the
//    4 + 4 instance 23 registers, where separate plain loads took 30,
//    and plain queries ran faster through it (PERF.md, section 6:
//    chip_smoke.py against the kernel with plain loads, in turns in one
//    call, H100).
#include <cuda_runtime.h>

#include "hash.cuh"
#include "packed.cuh"

namespace {

// A plan past these caps lowers operator-at-a-time.  The by-value
// parameter struct stays far below the 4 KB kernel-parameter limit.
constexpr int kMaxPreds = 8;
constexpr int kMaxJoins = 8;
// SSB needs at most 3 predicates and 4 joins.  The kernel unrolls its
// predicate and join slots; with plain int32 loads, 8 + 8 slots took 57
// registers a thread where 4 + 4 took 32 (ptxas): half the blocks an SM,
// and 1.45x the 13-query time (chip_smoke.py, H100).  So a plan that fits
// 4 + 4 runs an instance with 4 + 4 slots, held to 32 registers; the
// 8 + 8 instance, which serves no SSB query, takes what one block of
// 1024 threads an SM allows (64).
constexpr int kNarrow = 4;
constexpr int kBlock = 1024;                   // threads a block
constexpr int kNarrowBlocks = 2;               // an SM: 32 registers
constexpr int kRows = 2;                       // rows a thread in flight
constexpr int kMaxSpan = 232448 / 8;           // 227 KB of int64 sums
constexpr int kSpillSpan = 7168;               // 56 KB

// How one stream is stored: plain (phys 32, lg 0, mask all ones, ref 0)
// or packed; ref is added to a key's or a measure's decoded lane.
struct StreamWidth {
  int lg;
  int phys;
  unsigned mask;
  unsigned ref;
};

struct SpjaParams {
  const int* pred_cols[kMaxPreds];
  int pred_lo[kMaxPreds];
  int pred_hi[kMaxPreds];
  const int* join_keys[kMaxJoins];
  const int* ht_keys[kMaxJoins];
  const int* ht_vals[kMaxJoins];
  unsigned ht_mask[kMaxJoins];   // n_slots - 1 (n_slots a power of two)
  unsigned mults[kMaxJoins];
  const int* m1;
  const int* m2;
  StreamWidth pred_w[kMaxPreds];
  StreamWidth key_w[kMaxJoins];
  StreamWidth m_w[2];
  unsigned long long* out;       // (n_groups,) int64 sums, added to
  long long n;
  int n_preds;
  int n_joins;
  int measure_op;                // 0 first, 1 mul, 2 sub
  int n_groups;
  int span;                      // groups [0, span) summed in shared memory
};

// Row r of a stream as an int32 value.
__device__ __forceinline__ int load(const int* col, long long r,
                                    const StreamWidth& w) {
  // an unsigned add wraps as the reference's int32 add
  return static_cast<int>(packed_lane(reinterpret_cast<const unsigned*>(col),
                                      r, w.lg, w.phys, w.mask) + w.ref);
}

template <int kPreds, int kJoins, bool kSpill>
__global__ void __launch_bounds__(kBlock, kPreds == kNarrow ? kNarrowBlocks
                                                            : 1)
spja_kernel(const SpjaParams p) {
  extern __shared__ unsigned long long acc[];
  const bool scalar = p.n_groups == 1;
  if (!scalar) {
    for (int g = threadIdx.x; g < p.span; g += kBlock) acc[g] = 0ull;
  }
  __syncthreads();

  long long own = 0;               // this thread's sum when n_groups == 1
  const long long tile = static_cast<long long>(kBlock) * kRows;
  const long long stride = tile * gridDim.x;
  for (long long base = tile * blockIdx.x + threadIdx.x; base < p.n;
       base += stride) {
    unsigned live = 0u;            // bit i: row base + i * kBlock
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (base + static_cast<long long>(i) * kBlock < p.n) live |= 1u << i;
#pragma unroll
    for (int q = 0; q < kPreds; ++q) {
      if (q < p.n_preds && live) {
        int v[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if ((live >> i) & 1u)
            v[i] = load(p.pred_cols[q], base + i * kBlock, p.pred_w[q]);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (((live >> i) & 1u) &&
              (v[i] < p.pred_lo[q] || v[i] > p.pred_hi[q]))
            live &= ~(1u << i);
      }
    }
    unsigned group[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) group[i] = 0u;
#pragma unroll
    for (int j = 0; j < kJoins; ++j) {
      if (j < p.n_joins && live) {
        const int* htk = p.ht_keys[j];
        const unsigned mask = p.ht_mask[j];
        int key[kRows], home[kRows];
        unsigned slot[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if ((live >> i) & 1u)
            key[i] = load(p.join_keys[j], base + i * kBlock, p.key_w[j]);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if ((live >> i) & 1u) {
            slot[i] = home_slot(key[i], mask);
            home[i] = __ldg(htk + slot[i]);
          }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (((live >> i) & 1u) && home[i] != key[i] &&
              (home[i] == kEmpty || !walk_on(htk, mask, key[i], &slot[i])))
            live &= ~(1u << i);
        int pay[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if ((live >> i) & 1u) pay[i] = __ldg(p.ht_vals[j] + slot[i]);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if ((live >> i) & 1u)
            group[i] += static_cast<unsigned>(pay[i]) * p.mults[j];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (group[i] >= static_cast<unsigned>(p.n_groups)) live &= ~(1u << i);
    if (!live) continue;
    long long m[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if ((live >> i) & 1u) m[i] = load(p.m1, base + i * kBlock, p.m_w[0]);
    if (p.measure_op != 0) {
      int m2[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if ((live >> i) & 1u) m2[i] = load(p.m2, base + i * kBlock, p.m_w[1]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if ((live >> i) & 1u)
          m[i] = p.measure_op == 1 ? m[i] * m2[i] : m[i] - m2[i];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!((live >> i) & 1u)) continue;
      if (scalar) {
        own += m[i];
      } else if (!kSpill || group[i] < static_cast<unsigned>(p.span)) {
        atomicAdd(&acc[group[i]], static_cast<unsigned long long>(m[i]));
      } else {
        atomicAdd(p.out + group[i], static_cast<unsigned long long>(m[i]));
      }
    }
  }

  if (scalar) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      own += __shfl_down_sync(0xffffffffu, own, off);
    }
    if ((threadIdx.x & 31) == 0 && own != 0) {
      atomicAdd(p.out, static_cast<unsigned long long>(own));
    }
    return;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < p.span; g += kBlock) {
    const unsigned long long v = acc[g];
    if (v != 0ull) atomicAdd(p.out + g, v);
  }
}

// The instances, by the shape code: bit 0 the 8 + 8 slots, bit 1 the
// spilling grid; 4 no join (4 predicate slots and no join slot).
using Kernel = void (*)(SpjaParams);
constexpr int kShapes = 5;
Kernel const kInstances[kShapes] = {
    spja_kernel<kNarrow, kNarrow, false>,
    spja_kernel<kMaxPreds, kMaxJoins, false>,
    spja_kernel<kNarrow, kNarrow, true>,
    spja_kernel<kMaxPreds, kMaxJoins, true>,
    spja_kernel<kNarrow, 0, false>,
};

template <int kPreds, int kJoins, bool kSpill>
void start(const SpjaParams& p, unsigned grid, size_t smem, cudaStream_t s) {
  spja_kernel<kPreds, kJoins, kSpill><<<grid, kBlock, smem, s>>>(p);
}

// spja_launch's arguments, passed by one pointer.
// ptrs (device addresses): pred_cols[kMaxPreds], join_keys[kMaxJoins],
//   ht_keys[kMaxJoins], ht_vals[kMaxJoins], m1, m2 — unused slots null.
// ints: n_preds, n_joins, measure_op, n_groups, pred_lo[kMaxPreds],
//   pred_hi[kMaxPreds], ht_mask[kMaxJoins], mults[kMaxJoins],
//   pred_phys[kMaxPreds], key_phys[kMaxJoins], m_phys[2],
//   key_ref[kMaxJoins], m_ref[2] — phys 32 for a plain stream (its ref
//   is ignored), else the packed width; unused slots phys 32.
constexpr int kPtrs = kMaxPreds + 3 * kMaxJoins + 2;
constexpr int kInts = 8 + 3 * kMaxPreds + 4 * kMaxJoins;
struct SpjaArgs {
  const void* ptrs[kPtrs];
  int ints[kInts];
  long long n;              // fact rows (a packed stream holds
                            // ceil(n / (32 / phys)) words)
  void* out;                // (n_groups,) int64, zeroed or added to
  long long blocks;         // spja_shape's for this shape and grid
  int shape;                // the instance (kInstances' code)
};

}  // namespace

// The shape code of the instance a plan of n_preds, n_joins and n_groups
// runs, and the shared-memory bytes of its grid (0 for a scalar sum).
extern "C" int spja_grid(int n_preds, int n_joins, int n_groups,
                         int* smem) {
  const bool spill = n_groups > kMaxSpan;
  const int span = n_groups == 1 ? 0 : spill ? kSpillSpan : n_groups;
  *smem = span * static_cast<int>(sizeof(long long));
  const bool wide = n_preds > kNarrow || n_joins > kNarrow;
  if (n_joins == 0 && !wide && !spill) return 4;
  return (wide ? 1 : 0) | (spill ? 2 : 0);
}

// Blocks of instance `flag >> 20` (a shape code) resident on the current
// device at `flag & 0xfffff` bytes of dynamic shared memory a block (0
// when one does not fit); raises the instance's dynamic shared-memory cap
// to the device's most.  The wrapper asks once per device, shape and size.
extern "C" int spja_shape(int flag, long long* resident) {
  *resident = 0;
  const int shape = flag >> 20, smem = flag & 0xfffff;
  if (shape < 0 || shape >= kShapes)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaSuccess);
  err = cudaFuncSetAttribute(kInstances[shape],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kInstances[shape], kBlock, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(cudaSuccess);
}

// args: an SpjaArgs.  Any n_groups >= 1.  Asks the runtime nothing but
// the launch.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int spja_launch(const void* args, void* stream) {
  const SpjaArgs& a = *static_cast<const SpjaArgs*>(args);
  SpjaParams p;
  int k = 0;
  for (int q = 0; q < kMaxPreds; ++q)
    p.pred_cols[q] = static_cast<const int*>(a.ptrs[k++]);
  for (int j = 0; j < kMaxJoins; ++j)
    p.join_keys[j] = static_cast<const int*>(a.ptrs[k++]);
  for (int j = 0; j < kMaxJoins; ++j)
    p.ht_keys[j] = static_cast<const int*>(a.ptrs[k++]);
  for (int j = 0; j < kMaxJoins; ++j)
    p.ht_vals[j] = static_cast<const int*>(a.ptrs[k++]);
  p.m1 = static_cast<const int*>(a.ptrs[k++]);
  p.m2 = static_cast<const int*>(a.ptrs[k++]);
  const int* ints = a.ints;
  int i = 0;
  p.n_preds = ints[i++];
  p.n_joins = ints[i++];
  p.measure_op = ints[i++];
  p.n_groups = ints[i++];
  for (int q = 0; q < kMaxPreds; ++q) p.pred_lo[q] = ints[i++];
  for (int q = 0; q < kMaxPreds; ++q) p.pred_hi[q] = ints[i++];
  for (int j = 0; j < kMaxJoins; ++j)
    p.ht_mask[j] = static_cast<unsigned>(ints[i++]);
  for (int j = 0; j < kMaxJoins; ++j)
    p.mults[j] = static_cast<unsigned>(ints[i++]);
  bool bad = false;
  auto width = [&](StreamWidth* w) {
    w->phys = ints[i++];
    w->lg = lanes_log2(w->phys);
    w->mask = w->lg < 0 ? 0u : lane_mask(w->phys);
    w->ref = 0u;
    bad = bad || w->lg < 0;
  };
  for (int q = 0; q < kMaxPreds; ++q) width(&p.pred_w[q]);
  for (int j = 0; j < kMaxJoins; ++j) width(&p.key_w[j]);
  for (int m = 0; m < 2; ++m) width(&p.m_w[m]);
  for (int j = 0; j < kMaxJoins; ++j) {
    const int ref = ints[i++];
    if (p.key_w[j].phys != 32) p.key_w[j].ref = static_cast<unsigned>(ref);
  }
  for (int m = 0; m < 2; ++m) {
    const int ref = ints[i++];
    if (p.m_w[m].phys != 32) p.m_w[m].ref = static_cast<unsigned>(ref);
  }
  p.out = static_cast<unsigned long long*>(a.out);
  p.n = a.n;
  if (p.n_preds < 0 || p.n_preds > kMaxPreds || p.n_joins < 0 ||
      p.n_joins > kMaxJoins || p.measure_op < 0 || p.measure_op > 2 ||
      p.n_groups < 1 || p.n <= 0 || bad || a.blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  if (a.shape != spja_grid(p.n_preds, p.n_joins, p.n_groups, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  p.span = smem / static_cast<int>(sizeof(long long));

  const long long tile = static_cast<long long>(kBlock) * kRows;
  long long grid = (p.n + tile - 1) / tile;
  if (grid > a.blocks) grid = a.blocks;
  const unsigned blocks = static_cast<unsigned>(grid);
  const size_t bytes = static_cast<size_t>(smem);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.shape) {
    case 0: start<kNarrow, kNarrow, false>(p, blocks, bytes, s); break;
    case 1: start<kMaxPreds, kMaxJoins, false>(p, blocks, bytes, s); break;
    case 2: start<kNarrow, kNarrow, true>(p, blocks, bytes, s); break;
    case 3: start<kMaxPreds, kMaxJoins, true>(p, blocks, bytes, s); break;
    default: start<kNarrow, 0, false>(p, blocks, bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
