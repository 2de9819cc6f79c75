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
//  * n_groups up to 7000 (flight 2) needs 56 KB of shared memory, above
//    the 48 KB default; the launcher raises the limit per call.  Flight 1
//    has n_groups == 1: there every thread keeps its own sum in a
//    register, and one warp-shuffle reduction per warp replaces a shared
//    atomic per row.
//  * Any group count runs.  Up to kMaxSpan groups (the whole 227 KB a
//    block may have) the grid is wholly in shared memory, as every SSB
//    query's.  Past it a block keeps groups [0, kSpillSpan) in shared
//    memory and adds a row of a later group straight to the int64 output
//    in device memory (an atomicAdd that stays in the 50 MB L2), as
//    multi_fused.cu does; the spilling instance is a template of its own,
//    so a grid that fits runs the code it ran before.  kSpillSpan keeps
//    56 KB a block, flight 2's grid, so four blocks share an SM.  The sums
//    stay exact int64 additions: the same bits in any order.
//  * The output grid may hold a caller's running sums (the morsel fold
//    passes one grid through every morsel): the kernel only adds to it.
//  * Coalesced int32 loads: kItems rows per thread, rows of one item
//    spaced kThreads apart, so a warp reads 128 contiguous bytes per
//    column.  A grid-stride loop over a grid of as many blocks as fit on
//    the SMs at once; the ragged tail is masked.
//  * Each thread walks its own probe (hash.cuh) until its key or an EMPTY
//    slot (the reference's lock-step loop gives the same answer per
//    lane).  A row already filtered skips its later loads and probes.
//  * A live row whose group id falls outside [0, n_groups) is dropped,
//    as the reference's scatter drops it.
//  * Every stream, plain or bit-packed (src/repro_torch/sql/storage.py's
//    layout), is loaded by packed.cuh's decode: word r >> lg, lane shift
//    (r & (c-1)) * phys, mask, then the stream's reference (0 for a
//    predicate, whose bounds are already in the encoded domain).  A plain
//    int32 column is phys 32: lg 0, mask all ones, ref 0.  A warp reads
//    32 neighbouring rows, 128 * phys / 32 contiguous bytes, so a packed
//    column moves phys / 32 of a plain one's bytes.  One decode for both
//    kinds is also the faster code: ptxas gives the 4 + 4 instance 23
//    registers, where separate plain loads took 30, and plain queries run
//    faster through it (PERF.md, section 6: chip_smoke.py against the
//    kernel with plain loads, in turns in one call, H100).
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
// 4 + 4 runs an instance with 4 + 4 slots.  With the decode below every
// stream goes through, they take 28 and 23 registers, both full
// occupancy, and the 8 + 8 instance alone still ran the 13 queries 1.69x
// slower, plain and packed (spja_ab.py, H100).
constexpr int kNarrow = 4;
constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kDefaultSmem = 48 * 1024;
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
__global__ void __launch_bounds__(kThreads)
spja_kernel(const SpjaParams p) {
  extern __shared__ unsigned long long acc[];
  const bool scalar = p.n_groups == 1;
  if (!scalar) {
    for (int g = threadIdx.x; g < p.span; g += kThreads) acc[g] = 0ull;
  }
  __syncthreads();

  long long own = 0;               // this thread's sum when n_groups == 1
  const long long tile = static_cast<long long>(kThreads) * kItems;
  const long long stride = tile * gridDim.x;
  for (long long base = tile * blockIdx.x; base < p.n; base += stride) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long r = base + static_cast<long long>(i) * kThreads +
                          threadIdx.x;
      if (r >= p.n) break;
      bool live = true;
#pragma unroll
      for (int q = 0; q < kPreds; ++q) {
        if (q < p.n_preds && live) {
          const int v = load(p.pred_cols[q], r, p.pred_w[q]);
          live = v >= p.pred_lo[q] && v <= p.pred_hi[q];
        }
      }
      unsigned group = 0u;
#pragma unroll
      for (int j = 0; j < kJoins; ++j) {
        if (j < p.n_joins && live) {
          int payload = 0;
          live = probe(p.ht_keys[j], p.ht_vals[j], p.ht_mask[j],
                       load(p.join_keys[j], r, p.key_w[j]),
                       &payload);
          group += static_cast<unsigned>(payload) * p.mults[j];
        }
      }
      if (!live || group >= static_cast<unsigned>(p.n_groups)) continue;
      long long m = load(p.m1, r, p.m_w[0]);
      if (p.measure_op == 1) {
        m *= load(p.m2, r, p.m_w[1]);
      } else if (p.measure_op == 2) {
        m -= load(p.m2, r, p.m_w[1]);
      }
      if (scalar) {
        own += m;
      } else if (!kSpill || group < static_cast<unsigned>(p.span)) {
        atomicAdd(&acc[group], static_cast<unsigned long long>(m));
      } else {
        atomicAdd(p.out + group, static_cast<unsigned long long>(m));
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
  for (int g = threadIdx.x; g < p.span; g += kThreads) {
    const unsigned long long v = acc[g];
    if (v != 0ull) atomicAdd(p.out + g, v);
  }
}

// One launch of the instance with kPreds + kJoins slots: as many blocks as
// fit on the SMs at once, fewer for a small n.
template <int kPreds, int kJoins, bool kSpill>
int launch(const SpjaParams& p, size_t smem, cudaStream_t stream) {
  cudaError_t err;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    err = cudaFuncSetAttribute(spja_kernel<kPreds, kJoins, kSpill>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, spja_kernel<kPreds, kJoins, kSpill>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);

  const long long tile = static_cast<long long>(kThreads) * kItems;
  long long grid = (p.n + tile - 1) / tile;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (grid > resident) grid = resident;
  spja_kernel<kPreds, kJoins, kSpill>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs (device addresses): pred_cols[kMaxPreds], join_keys[kMaxJoins],
//   ht_keys[kMaxJoins], ht_vals[kMaxJoins], m1, m2 — unused slots null.
// ints: n_preds, n_joins, measure_op, n_groups, pred_lo[kMaxPreds],
//   pred_hi[kMaxPreds], ht_mask[kMaxJoins], mults[kMaxJoins],
//   pred_phys[kMaxPreds], key_phys[kMaxJoins], m_phys[2],
//   key_ref[kMaxJoins], m_ref[2] — phys 32 for a plain stream (its ref
//   is ignored), else the packed width; unused slots phys 32.
// n: the fact rows (a packed stream holds ceil(n / (32 / phys)) words).
// out: (n_groups,) int64, zeroed by the caller or holding sums to add to;
// any n_groups >= 1.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int spja_launch(const void* const* ptrs, const int* ints,
                           long long n, void* out, void* stream) {
  SpjaParams p;
  int k = 0;
  for (int q = 0; q < kMaxPreds; ++q)
    p.pred_cols[q] = static_cast<const int*>(ptrs[k++]);
  for (int j = 0; j < kMaxJoins; ++j)
    p.join_keys[j] = static_cast<const int*>(ptrs[k++]);
  for (int j = 0; j < kMaxJoins; ++j)
    p.ht_keys[j] = static_cast<const int*>(ptrs[k++]);
  for (int j = 0; j < kMaxJoins; ++j)
    p.ht_vals[j] = static_cast<const int*>(ptrs[k++]);
  p.m1 = static_cast<const int*>(ptrs[k++]);
  p.m2 = static_cast<const int*>(ptrs[k++]);
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
  for (int k = 0; k < 2; ++k) width(&p.m_w[k]);
  for (int j = 0; j < kMaxJoins; ++j) {
    const int ref = ints[i++];
    if (p.key_w[j].phys != 32) p.key_w[j].ref = static_cast<unsigned>(ref);
  }
  for (int k = 0; k < 2; ++k) {
    const int ref = ints[i++];
    if (p.m_w[k].phys != 32) p.m_w[k].ref = static_cast<unsigned>(ref);
  }
  p.out = static_cast<unsigned long long*>(out);
  p.n = n;
  if (p.n_preds < 0 || p.n_preds > kMaxPreds || p.n_joins < 0 ||
      p.n_joins > kMaxJoins || p.measure_op < 0 || p.measure_op > 2 ||
      p.n_groups < 1 || n <= 0 || bad)
    return static_cast<int>(cudaErrorInvalidValue);

  const bool spill = p.n_groups > kMaxSpan;
  p.span = p.n_groups == 1 ? 0 : spill ? kSpillSpan : p.n_groups;
  const size_t smem = static_cast<size_t>(p.span) * sizeof(long long);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = p.n_preds <= kNarrow && p.n_joins <= kNarrow;
  if (spill)
    return narrow ? launch<kNarrow, kNarrow, true>(p, smem, s)
                  : launch<kMaxPreds, kMaxJoins, true>(p, smem, s);
  return narrow ? launch<kNarrow, kNarrow, false>(p, smem, s)
                : launch<kMaxPreds, kMaxJoins, false>(p, smem, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
