// Shared-scan SPJA for Hopper (sm_90a): one pass over the fact table runs
// a whole wave of Q queries.
//
// Replaces the Pallas TPU kernel src/repro/kernels/multi_fused.py::
// multi_spja (_make_kernel).  The wave's streams are the union of its
// members' columns; every distinct build side is one probe stream.  Per
// fact row, each stream is loaded and each table probed at most once for
// all members, and only the predicate compares, the group ids and the sums
// fan out by member.  A member's row is live when it is a real member
// (q_valid), passes its own bounds on every predicate column, and finds
// its key in every join it uses; its group id is the sum of payload * mult
// over its joins (int32, wrapping; a miss's payload is 0), its measure
// m1, m1*m2 or m1-m2 of the measure columns its selectors name.
//
// What bounds it: device-memory bytes at 3.35 TB/s, the union's distinct
// columns read once where the solo fused kernel reads each query's own
// columns (the 13-query SSB wave at SF 20: 9 columns, 4.32 GB in full;
// chip_smoke.py's wave_need counts the 3.15 GB, 0.95 ms, its data needs,
// and PERF.md holds the kernel's share of that bound).  The probes,
// dependent reads of tables that stay in the 50 MB L2, are what no byte
// bound counts, and what takes the time.
//
// Design for this card, not a copy of the Pallas grid:
//  * Member queries are data.  The wrapper (multi_fused.py) lowers the
//    stacked parameters to one int32 word array (layout below) and the
//    stream pointers to one array, both in device memory; each block
//    stages them into shared memory.  Q, C, J and M are read at run time,
//    so one instance runs any wave: the 13-query SSB wave has 21 probe
//    streams, past the solo kernel's unrolled 8.  A by-value parameter
//    block would not hold Q = 16, J = 21 (4 KB).
//  * Each thread keeps a 64-bit live mask over the members of its row.
//    A predicate column is loaded only while a live member filters it
//    (per-column member masks), a join's key only while a live member
//    uses it or takes its payload, a measure only while a live member
//    sums it; the row stops as soon as no member is live.  A member's
//    group id walks its own joins only, the payloads kept per thread in
//    shared memory (one int32 column per join, conflict-free).
//  * Sums are taken EXACTLY in int64 with integer atomics, so the bits do
//    not depend on block order and the one int64 -> f32 cast (by the
//    caller) is the numpy oracle's exact sum rounded once.  Each member
//    has a span of groups [0, span) kept in a per-block int64 grid in
//    shared memory (the wrapper fits the spans, smallest first, in
//    multi_fused.ACC_BUDGET_BYTES); a group at or past the span is added
//    straight to the (Q, n_groups) output in device memory, which stays
//    in L2.  On the 13-query SSB wave all sums through L2 ran 1.17x
//    faster than an 8 KB grid at the same 6 blocks an SM, 1.16x faster
//    than a 24 KB grid (5 blocks) and 3.8x faster than a 160 KB one (1).
//    So only the smallest members take a grid, to spread the atomics of
//    a member whose rows meet at a few groups over the SMs instead of
//    one L2 address (9.0x faster for one that every row reaches).  At
//    the end each block adds its nonzero shared entries to the output
//    with one atomic each.
//  * The number of table reads, not their latency, sets the pace: on
//    that wave (spja_ab.py, H100), reading each probe's home payload with
//    its key (one more read a probe) ran 1.40x slower; loading the next
//    join's key before this join's probe 1.08x slower at the same 6
//    blocks an SM; issuing every key, then every home slot, of a row at
//    once with cp.async into shared memory (three words a join a thread,
//    16 warps an SM) 2.8x slower.
//  * A live row whose group id falls outside [0, n_groups) is dropped (an
//    unsigned compare), as the solo kernel drops it.
//  * Every stream, plain or bit-packed, is loaded through packed.cuh's
//    decode (a plain int32 column is phys 32); keys and measures add their
//    frame of reference, predicate bounds are already in the encoded
//    domain.  Probes are hash.cuh's.
//  * One row a thread per step of a grid-stride loop over as many blocks
//    as fit on the SMs at once; neighbouring threads read neighbouring
//    rows.
#include <cuda_runtime.h>

#include "hash.cuh"
#include "packed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 64;      // bits of the live mask
constexpr int kDefaultSmem = 48 * 1024;

// The int32 parameter words (multi_fused.py::param_words writes them):
//   header  [kHeader]: Q, C, J, M, n_groups, acc_groups, n_pairs,
//           valid_lo, valid_hi
//   columns [C][kColWords]: lg, phys, mask, filt_lo, filt_hi
//   bounds  [C][Q][2]: lo, hi (encoded domain)
//   joins   [J][kJoinWords]: lg, phys, mask, ref, ht_mask, use_lo, use_hi,
//           need_lo, need_hi
//   measures [M][kMeasWords]: lg, phys, mask, ref, need_lo, need_hi
//   members [Q][kMemberWords]: m1, m2, op, acc_off, span, pair_start,
//           pair_count
//   pairs   [n_pairs][2]: join, mult (each member's joins with mult != 0)
// A (lo, hi) pair of words is a 64-bit member mask.  The pointers:
// pred_cols[C], keys[J], ht_keys[J], ht_vals[J], measures[M].
constexpr int kHeader = 9;
constexpr int kColWords = 5;
constexpr int kJoinWords = 9;
constexpr int kMeasWords = 6;
constexpr int kMemberWords = 7;

struct Layout {
  int q, c, j, m, n_groups, acc_groups, n_pairs;
  int cols, bounds, joins, meas, members, pairs, n_words, n_ptrs;
};

__host__ __device__ inline Layout layout_of(const int* w) {
  Layout l;
  l.q = w[0];
  l.c = w[1];
  l.j = w[2];
  l.m = w[3];
  l.n_groups = w[4];
  l.acc_groups = w[5];
  l.n_pairs = w[6];
  l.cols = kHeader;
  l.bounds = l.cols + kColWords * l.c;
  l.joins = l.bounds + 2 * l.c * l.q;
  l.meas = l.joins + kJoinWords * l.j;
  l.members = l.meas + kMeasWords * l.m;
  l.pairs = l.members + kMemberWords * l.q;
  l.n_words = l.pairs + 2 * l.n_pairs;
  l.n_ptrs = l.c + 3 * l.j + l.m;
  return l;
}

// Dynamic shared memory of a block: the int64 grid, the pointers, the
// words (rounded to 8 bytes), then per thread one int32 payload per join
// and one measure value per measure column.
inline size_t smem_bytes(const Layout& l) {
  return 8 * static_cast<size_t>(l.acc_groups) + 8 * l.n_ptrs +
         4 * static_cast<size_t>((l.n_words + 1) & ~1) +
         4 * static_cast<size_t>(kThreads) * (l.j + l.m);
}

__device__ __forceinline__ unsigned long long mask64(const int* w) {
  return static_cast<unsigned>(w[0]) |
         (static_cast<unsigned long long>(static_cast<unsigned>(w[1])) << 32);
}

// Row r of a stream as an int32 value: the decoded lane plus the stream's
// reference (an unsigned add wraps as the reference's int32 add).
__device__ __forceinline__ int load(unsigned long long ptr, long long r,
                                    const int* w, int ref) {
  return static_cast<int>(
      packed_lane(reinterpret_cast<const unsigned*>(ptr), r, w[0], w[1],
                  static_cast<unsigned>(w[2])) +
      static_cast<unsigned>(ref));
}

__device__ __forceinline__ int lowest(unsigned long long m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}

__global__ void __launch_bounds__(kThreads)
multi_spja_kernel(const int* __restrict__ params,
                  const unsigned long long* __restrict__ ptrs, long long n,
                  unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const Layout l = layout_of(params);
  unsigned long long* acc = smem;
  unsigned long long* sp = acc + l.acc_groups;
  int* w = reinterpret_cast<int*>(sp + l.n_ptrs);
  int* pay = w + ((l.n_words + 1) & ~1);
  int* mval = pay + kThreads * l.j;
  const int tid = threadIdx.x;
  for (int i = tid; i < l.acc_groups; i += kThreads) acc[i] = 0ull;
  for (int i = tid; i < l.n_ptrs; i += kThreads) sp[i] = ptrs[i];
  for (int i = tid; i < l.n_words; i += kThreads) w[i] = params[i];
  __syncthreads();

  const int* cols = w + l.cols;
  const int* bounds = w + l.bounds;
  const int* joins = w + l.joins;
  const int* meas = w + l.meas;
  const int* members = w + l.members;
  const int* pairs = w + l.pairs;
  const unsigned long long* col_ptr = sp;
  const unsigned long long* key_ptr = sp + l.c;
  const unsigned long long* htk_ptr = key_ptr + l.j;
  const unsigned long long* htv_ptr = htk_ptr + l.j;
  const unsigned long long* meas_ptr = htv_ptr + l.j;
  const unsigned long long valid = mask64(w + 7);
  const unsigned n_groups = static_cast<unsigned>(l.n_groups);

  const long long stride = static_cast<long long>(kThreads) * gridDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads + tid;
       r < n; r += stride) {
    unsigned long long live = valid;
    for (int c = 0; c < l.c && live; ++c) {
      const int* cw = cols + kColWords * c;
      unsigned long long m = live & mask64(cw + 3);
      if (!m) continue;
      const int v = load(col_ptr[c], r, cw, 0);
      const int* b = bounds + 2 * l.q * c;
      do {
        const int q = lowest(m);
        m &= m - 1ull;
        if (v < b[2 * q] || v > b[2 * q + 1]) live &= ~(1ull << q);
      } while (m);
    }
    for (int j = 0; j < l.j && live; ++j) {
      const int* jw = joins + kJoinWords * j;
      if (!(live & mask64(jw + 7))) continue;
      int payload = 0;
      const bool hit = probe(
          reinterpret_cast<const int*>(htk_ptr[j]),
          reinterpret_cast<const int*>(htv_ptr[j]),
          static_cast<unsigned>(jw[4]), load(key_ptr[j], r, jw, jw[3]),
          &payload);
      pay[kThreads * j + tid] = payload;
      if (!hit) live &= ~mask64(jw + 5);
    }
    if (!live) continue;
    for (int k = 0; k < l.m; ++k) {
      const int* mw = meas + kMeasWords * k;
      if (live & mask64(mw + 4))
        mval[kThreads * k + tid] = load(meas_ptr[k], r, mw, mw[3]);
    }
    do {
      const int q = lowest(live);
      live &= live - 1ull;
      const int* mq = members + kMemberWords * q;
      unsigned g = 0u;
      for (int p = mq[5]; p < mq[5] + mq[6]; ++p)
        g += static_cast<unsigned>(pay[kThreads * pairs[2 * p] + tid]) *
             static_cast<unsigned>(pairs[2 * p + 1]);
      if (g >= n_groups) continue;
      long long v = mval[kThreads * mq[0] + tid];
      if (mq[2] == 1) {
        v *= mval[kThreads * mq[1] + tid];
      } else if (mq[2] == 2) {
        v -= mval[kThreads * mq[1] + tid];
      }
      if (g < static_cast<unsigned>(mq[4])) {
        atomicAdd(&acc[mq[3] + g], static_cast<unsigned long long>(v));
      } else {
        atomicAdd(out + static_cast<long long>(q) * l.n_groups + g,
                  static_cast<unsigned long long>(v));
      }
    } while (live);
  }

  __syncthreads();
  for (int q = 0; q < l.q; ++q) {
    const int* mq = members + kMemberWords * q;
    for (int g = tid; g < mq[4]; g += kThreads) {
      const unsigned long long v = acc[mq[3] + g];
      if (v != 0ull)
        atomicAdd(out + static_cast<long long>(q) * l.n_groups + g, v);
    }
  }
}

// The words are whole and every index in them is in range: a malformed
// array is refused before it reaches the card.
bool valid_words(const int* w, int n_words) {
  if (n_words < kHeader) return false;
  const Layout l = layout_of(w);
  if (l.q < 1 || l.q > kMaxMembers || l.c < 0 || l.j < 0 || l.m < 1 ||
      l.n_groups < 1 || l.acc_groups < 0 || l.n_pairs < 0 ||
      l.n_words != n_words)
    return false;
  auto width_ok = [](const int* sw) {
    const int lg = lanes_log2(sw[1]);
    return lg >= 0 && sw[0] == lg &&
           static_cast<unsigned>(sw[2]) == lane_mask(sw[1]);
  };
  for (int c = 0; c < l.c; ++c)
    if (!width_ok(w + l.cols + kColWords * c)) return false;
  for (int j = 0; j < l.j; ++j) {
    const int* jw = w + l.joins + kJoinWords * j;
    const unsigned slots = static_cast<unsigned>(jw[4]);
    if (!width_ok(jw) || (slots & (slots + 1u)) != 0u) return false;
  }
  for (int k = 0; k < l.m; ++k)
    if (!width_ok(w + l.meas + kMeasWords * k)) return false;
  for (int q = 0; q < l.q; ++q) {
    const int* mq = w + l.members + kMemberWords * q;
    if (mq[0] < 0 || mq[0] >= l.m || mq[1] < 0 || mq[1] >= l.m ||
        mq[2] < 0 || mq[2] > 2 || mq[3] < 0 || mq[4] < 0 ||
        mq[4] > l.n_groups ||
        static_cast<long long>(mq[3]) + mq[4] > l.acc_groups ||
        mq[5] < 0 || mq[6] < 0 ||
        static_cast<long long>(mq[5]) + mq[6] > l.n_pairs)
      return false;
  }
  for (int p = 0; p < l.n_pairs; ++p) {
    const int j = w[l.pairs + 2 * p];
    if (j < 0 || j >= l.j) return false;
  }
  return true;
}

}  // namespace

// Blocks of the kernel one SM holds at `smem` bytes of dynamic shared
// memory (0 when it does not fit one block), for the wrapper's record of
// the occupancy.  Raises the kernel's dynamic shared memory cap to `smem`.
extern "C" int multi_spja_blocks_per_sm(long long smem, int* blocks) {
  *blocks = 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem < 0 || smem > optin) return static_cast<int>(cudaSuccess);
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(multi_spja_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, multi_spja_kernel, kThreads, static_cast<size_t>(smem));
  return static_cast<int>(err);
}

// host_words: the parameter words in host memory (validated and read for
// the layout); words, ptrs: the same words and the stream pointers
// (uint64) in device memory; n: the fact rows (a packed stream holds
// ceil(n / (32 / phys)) words); out: (Q, n_groups) int64, zeroed or holding
// sums to add to (the kernel only adds).
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (cudaErrorInvalidValue for malformed words).
extern "C" int multi_spja_launch(const int* host_words, int n_words,
                                 const void* words, const void* ptrs,
                                 long long n, void* out, void* stream) {
  if (n <= 0 || !valid_words(host_words, n_words))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(layout_of(host_words));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = multi_spja_blocks_per_sm(static_cast<long long>(smem),
                                          &per_sm);
  if (rc != 0) return rc;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long grid = (n + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (grid > resident) grid = resident;
  multi_spja_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words),
      static_cast<const unsigned long long*>(ptrs), n,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
