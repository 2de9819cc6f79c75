// Shared-scan SPJA for Hopper (sm_90a): one pass over the fact table runs
// a whole wave of Q queries.
//
// Replaces the Pallas TPU kernel src/repro/kernels/multi_fused.py::
// multi_spja (_make_kernel).  The wave's streams are the union of its
// members' columns; every distinct build side is one probe stream.  A
// member's row is live when it is a real member (q_valid), passes its own
// bounds on every predicate column, and finds its key in every join it
// uses; its group id is the sum of payload * mult over its joins (int32,
// wrapping; a miss's payload is 0), its measure m1, m1*m2 or m1-m2 of the
// measure columns its selectors name.
//
// What bounds it: device-memory bytes at 3.35 TB/s, the union's distinct
// columns read once where the solo fused kernel reads each query's own
// columns (the 13-query SSB wave at SF 20: 9 columns, 4.32 GB in full;
// chip_smoke.py's wave_need counts the 3.15 GB, 0.95 ms, its data needs,
// and PERF.md holds the kernel's share of that bound).  The probes,
// dependent reads of tables that stay in the L2, are what no byte bound
// counts, and what takes the time: the number of table reads, not their
// latency, set the pace of the design before this one (spja_ab.py,
// H100: reading each probe's home payload with its key ran 1.40x slower,
// issuing every key and home slot of a row at once with cp.async 2.8x
// slower).
//
// Design for this card, not a copy of the Pallas grid:
//  * One probe per fact key column.  The wrapper lowers the streams that
//    probe one fact key column against one dimension key to a probe
//    group (sql/compile.py::probe_groups): the 13-query SSB wave's 21
//    streams are 4 groups, one per key column, where one probe a stream
//    made 11.0 probes a row.  A group of k > 1 streams probes one merged
//    table (sql/hashtable.py::build_merged): 16-byte slots of (key,
//    stream mask, entry, 0) over the union of the streams' keys, read by
//    one vector load, and a (k, E) int32 payload matrix.  A stream hits
//    when the key is found and its bit is set; a member that uses a
//    stream that missed dies.  A group of one stream probes its own
//    (htk, htv) table.  A group is probed for a row only while a live
//    member needs one of its streams, in the order the wrapper gives
//    (the lowest hit rate first), and a payload is read only when a
//    member that takes it is still live after every probe.
//  * Member queries are data.  The wrapper (multi_fused.py) lowers the
//    stacked parameters to one int32 word array (layout below) and the
//    stream pointers to one array, uploaded together; each block stages
//    them into shared memory.  Q, C, G, J and M are read at run time, so
//    one instance runs any wave.
//  * One row a thread.  Each row keeps a 64-bit live mask over the
//    members; the probe state a member's group id needs (hit mask and
//    entry, or hit and payload for a table of one stream) stays per group
//    in shared memory until the row is summed.  At 32 registers
//    (__launch_bounds__ for 8 blocks an SM) the 13-query wave took 6.70 ms
//    (spja_ab.py, H100, in turns), 7.34 at 40 registers (6 blocks), 9.17
//    at 63; two rows a thread in flight took 7.95 at 64 registers, four
//    rows 10.0 at 80 (PERF.md).
//  * Sums are taken EXACTLY in int64 with integer atomics, so the bits do
//    not depend on block order and the one int64 -> f32 cast (by the
//    caller) is the numpy oracle's exact sum rounded once.  Each member
//    has a span of groups [0, span) kept in a per-block int64 grid in
//    shared memory (the wrapper fits the spans, smallest first, in
//    multi_fused.ACC_BUDGET_BYTES); a group at or past the span is added
//    straight to the (Q, n_groups) output in device memory, which stays
//    in L2.  At the end each block adds its nonzero shared entries to the
//    output with one atomic each.
//  * A live row whose group id falls outside [0, n_groups) is dropped (an
//    unsigned compare), as the solo kernel drops it.
//  * Every stream, plain or bit-packed, is loaded through packed.cuh's
//    decode (a plain int32 column is phys 32); keys and measures add their
//    frame of reference, predicate bounds are already in the encoded
//    domain.  The walk past home is hash.cuh's.
//  * A grid-stride loop over as many blocks as fit on the SMs at once
//    (asked once per device and shared-memory size by the wrapper);
//    neighbouring threads read neighbouring rows.
#include <cuda_runtime.h>

#include "hash.cuh"
#include "packed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;        // blocks an SM: 32 registers a thread
constexpr int kMaxMembers = 64;      // bits of the live mask
constexpr int kMaxGroupStreams = 32; // bits of a merged slot's mask

// The int32 parameter words (multi_fused.py::param_words writes them):
//   header  [kHeader]: Q, C, G, J, M, n_groups, acc_groups, n_pairs,
//           valid_lo, valid_hi
//   columns [C][kColWords]: lg, phys, mask, filt_lo, filt_hi
//   bounds  [C][Q][2]: lo, hi (encoded domain)
//   groups  [G][kGroupWords]: lg, phys, mask, ref (its key stream),
//           ht_mask, first, k (its streams first .. first + k - 1),
//           entries (the payload matrix's E, or 0 for a stream's own
//           table, which only a group of one stream probes), need_lo,
//           need_hi (members that use or take one of its streams),
//           kill_lo, kill_hi (members that use one)
//   streams [J][kStreamWords]: use_lo, use_hi (in group order)
//   measures [M][kMeasWords]: lg, phys, mask, ref, need_lo, need_hi
//   members [Q][kMemberWords]: m1, m2, op, acc_off, span, pair_start,
//           pair_count
//   pairs   [n_pairs][3]: group, bit, mult (each member's streams with
//           mult != 0; bit: the stream's place in its group)
// A (lo, hi) pair of words is a 64-bit member mask.  The pointers:
// pred_cols[C], keys[G], tables[G] (htk, or the merged (S, 4) slots),
// vals[G] (htv, or the (k, E) payload matrix), measures[M].
constexpr int kHeader = 10;
constexpr int kColWords = 5;
constexpr int kGroupWords = 12;
constexpr int kStreamWords = 2;
constexpr int kMeasWords = 6;
constexpr int kMemberWords = 7;
constexpr int kPairWords = 3;

struct Layout {
  int q, c, g, j, m, n_groups, acc_groups, n_pairs;
  int cols, bounds, groups, streams, meas, members, pairs, n_words, n_ptrs;
};

__host__ __device__ inline Layout layout_of(const int* w) {
  Layout l;
  l.q = w[0];
  l.c = w[1];
  l.g = w[2];
  l.j = w[3];
  l.m = w[4];
  l.n_groups = w[5];
  l.acc_groups = w[6];
  l.n_pairs = w[7];
  l.cols = kHeader;
  l.bounds = l.cols + kColWords * l.c;
  l.groups = l.bounds + 2 * l.c * l.q;
  l.streams = l.groups + kGroupWords * l.g;
  l.meas = l.streams + kStreamWords * l.j;
  l.members = l.meas + kMeasWords * l.m;
  l.pairs = l.members + kMemberWords * l.q;
  l.n_words = l.pairs + kPairWords * l.n_pairs;
  l.n_ptrs = l.c + 3 * l.g + l.m;
  return l;
}

// Dynamic shared memory of a block: the int64 grid, the pointers, the
// words (rounded to 8 bytes), then per thread one int2 of probe state per
// group and one measure value per measure column.
inline size_t smem_bytes(const Layout& l) {
  return 8 * static_cast<size_t>(l.acc_groups) + 8 * l.n_ptrs +
         4 * static_cast<size_t>((l.n_words + 1) & ~1) +
         8 * static_cast<size_t>(kThreads) * l.g +
         4 * static_cast<size_t>(kThreads) * l.m;
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

// The rest of a merged table's walk past home (hash.cuh's walk_on over
// 16-byte slots): the hit's slot, or {kEmpty, 0, 0, 0} for a miss.
__device__ __forceinline__ int4 walk_slots(const int4* __restrict__ slots,
                                           unsigned mask, int key,
                                           unsigned s) {
  for (unsigned long long step = 1; step <= mask; ++step) {
    s = (s + 1u) & mask;
    const int4 v = __ldg(slots + s);
    if (v.x == key) return v;
    if (v.x == kEmpty) break;
  }
  return make_int4(kEmpty, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
multi_spja_kernel(const int* __restrict__ params,
                  const unsigned long long* __restrict__ ptrs, long long n,
                  unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const Layout l = layout_of(params);
  unsigned long long* acc = smem;
  unsigned long long* sp = acc + l.acc_groups;
  int* w = reinterpret_cast<int*>(sp + l.n_ptrs);
  int2* gst = reinterpret_cast<int2*>(w + ((l.n_words + 1) & ~1));
  int* mval = reinterpret_cast<int*>(gst + kThreads * l.g);
  const int tid = threadIdx.x;
  for (int i = tid; i < l.acc_groups; i += kThreads) acc[i] = 0ull;
  for (int i = tid; i < l.n_ptrs; i += kThreads) sp[i] = ptrs[i];
  for (int i = tid; i < l.n_words; i += kThreads) w[i] = params[i];
  __syncthreads();

  const int* cols = w + l.cols;
  const int* bounds = w + l.bounds;
  const int* groups = w + l.groups;
  const int* streams = w + l.streams;
  const int* meas = w + l.meas;
  const int* members = w + l.members;
  const int* pairs = w + l.pairs;
  const unsigned long long* col_ptr = sp;
  const unsigned long long* key_ptr = sp + l.c;
  const unsigned long long* tab_ptr = key_ptr + l.g;
  const unsigned long long* val_ptr = tab_ptr + l.g;
  const unsigned long long* meas_ptr = val_ptr + l.g;
  const unsigned long long valid = mask64(w + 8);
  const unsigned n_groups = static_cast<unsigned>(l.n_groups);

  const long long stride = static_cast<long long>(kThreads) * gridDim.x;
  for (long long r = static_cast<long long>(kThreads) * blockIdx.x + tid;
       r < n; r += stride) {
    unsigned long long live = valid;

    for (int c = 0; c < l.c; ++c) {
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

    for (int g = 0; g < l.g; ++g) {
      const int* gw = groups + kGroupWords * g;
      if (!(live & mask64(gw + 8))) continue;
      const unsigned ht_mask = static_cast<unsigned>(gw[4]);
      const int k = gw[6];
      const int key = load(key_ptr[g], r, gw, gw[3]);
      int2 st = make_int2(0, 0);   // (hit mask, entry) or (hit, payload)
      if (gw[7] == 0) {
        const int* htk = reinterpret_cast<const int*>(tab_ptr[g]);
        unsigned slot = home_slot(key, ht_mask);
        const int home = __ldg(htk + slot);
        if (home == key ||
            (home != kEmpty && walk_on(htk, ht_mask, key, &slot)))
          st = make_int2(1, __ldg(reinterpret_cast<const int*>(val_ptr[g]) +
                                  slot));
      } else {
        const int4* slots = reinterpret_cast<const int4*>(tab_ptr[g]);
        const unsigned home = home_slot(key, ht_mask);
        int4 at = __ldg(slots + home);
        if (at.x != key && at.x != kEmpty)
          at = walk_slots(slots, ht_mask, key, home);
        if (at.x == key) st = make_int2(at.y, at.z);
      }
      gst[g * kThreads + tid] = st;
      // members that use a stream that missed die
      const unsigned all = k == 32 ? 0xffffffffu : (1u << k) - 1u;
      unsigned missed = ~static_cast<unsigned>(st.x) & all;
      if (missed == all) {
        live &= ~mask64(gw + 10);
      } else {
        const int* su = streams + kStreamWords * gw[5];
        while (missed) {
          const int s = __ffs(missed) - 1;
          missed &= missed - 1u;
          live &= ~mask64(su + kStreamWords * s);
        }
      }
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
      unsigned gid = 0u;
      for (int p = mq[5]; p < mq[5] + mq[6]; ++p) {
        const int* pw = pairs + kPairWords * p;
        const int g = pw[0];
        const int2 st = gst[g * kThreads + tid];
        if ((static_cast<unsigned>(st.x) >> pw[1]) & 1u) {
          const int* gw = groups + kGroupWords * g;
          const int pay =
              gw[7] == 0 ? st.y
                         : __ldg(reinterpret_cast<const int*>(val_ptr[g]) +
                                 static_cast<long long>(pw[1]) * gw[7] +
                                 st.y);
          gid += static_cast<unsigned>(pay) * static_cast<unsigned>(pw[2]);
        }
      }
      if (gid >= n_groups) continue;
      long long v = mval[kThreads * mq[0] + tid];
      if (mq[2] == 1) {
        v *= mval[kThreads * mq[1] + tid];
      } else if (mq[2] == 2) {
        v -= mval[kThreads * mq[1] + tid];
      }
      if (gid < static_cast<unsigned>(mq[4])) {
        atomicAdd(&acc[mq[3] + gid], static_cast<unsigned long long>(v));
      } else {
        atomicAdd(out + static_cast<long long>(q) * l.n_groups + gid,
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
  if (l.q < 1 || l.q > kMaxMembers || l.c < 0 || l.g < 0 || l.j < l.g ||
      l.m < 1 || l.n_groups < 1 || l.acc_groups < 0 || l.n_pairs < 0 ||
      l.n_words != n_words)
    return false;
  auto width_ok = [](const int* sw) {
    const int lg = lanes_log2(sw[1]);
    return lg >= 0 && sw[0] == lg &&
           static_cast<unsigned>(sw[2]) == lane_mask(sw[1]);
  };
  for (int c = 0; c < l.c; ++c)
    if (!width_ok(w + l.cols + kColWords * c)) return false;
  int first = 0;
  for (int g = 0; g < l.g; ++g) {
    const int* gw = w + l.groups + kGroupWords * g;
    const unsigned slots = static_cast<unsigned>(gw[4]);
    if (!width_ok(gw) || (slots & (slots + 1u)) != 0u || gw[5] != first ||
        gw[6] < 1 || gw[6] > kMaxGroupStreams || gw[7] < 0 ||
        (gw[6] > 1 && gw[7] == 0))
      return false;
    first += gw[6];
  }
  if (first != l.j) return false;
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
    const int* pw = w + l.pairs + kPairWords * p;
    if (pw[0] < 0 || pw[0] >= l.g) return false;
    if (pw[1] < 0 || pw[1] >= w[l.groups + kGroupWords * pw[0] + 6])
      return false;
  }
  return true;
}

// multi_spja_launch's arguments, passed by one pointer.
struct MultiArgs {
  const int* host_words;   // the words in host memory (validated)
  long long n_words;
  const void* params;      // device: the pointers (uint64), then the words
  long long n;             // fact rows
  void* out;               // (Q, n_groups) int64, added to
  long long blocks;        // multi_spja_shape's
};

}  // namespace

// Blocks of the kernel resident on the current device at `smem` bytes of
// dynamic shared memory a block (0 when one block does not fit); raises
// the kernel's dynamic shared-memory cap to the device's most.  The
// wrapper asks once per device and byte count.
extern "C" int multi_spja_shape(int smem, long long* resident) {
  *resident = 0;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem < 0 || smem > optin) return static_cast<int>(cudaSuccess);
  err = cudaFuncSetAttribute(multi_spja_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, multi_spja_kernel, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(cudaSuccess);
}

// args: a MultiArgs.  The device parameters hold the stream pointers
// (uint64, the count the words give) and then the words; a packed stream
// holds ceil(n / (32 / phys)) words.  Asks the runtime nothing but the
// launch.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (cudaErrorInvalidValue for malformed words).
extern "C" int multi_spja_launch(const void* args, void* stream) {
  const MultiArgs& a = *static_cast<const MultiArgs*>(args);
  if (a.n <= 0 || a.blocks < 1 || a.n_words > 0x7fffffffLL ||
      !valid_words(a.host_words, static_cast<int>(a.n_words)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout_of(a.host_words);
  long long grid = (a.n + kThreads - 1) / kThreads;
  if (grid > a.blocks) grid = a.blocks;
  const auto* ptrs = static_cast<const unsigned long long*>(a.params);
  multi_spja_kernel<<<static_cast<unsigned>(grid), kThreads, smem_bytes(l),
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int*>(ptrs + l.n_ptrs), ptrs, a.n,
      static_cast<unsigned long long*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
