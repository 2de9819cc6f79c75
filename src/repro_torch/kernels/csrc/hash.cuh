// Linear-probe lookup into an open-addressing table, shared by
// ssb_fused.cu and multi_fused.cu (home_slot, walk_on: several rows'
// home slots in flight), and hash_join.cu's probe_agg and lookback.cuh's
// probe sweep (the run-wide walk below).
//
// The rule of src/repro/core/blocks.py::block_lookup per key: start at
// (uint32(key) * 2654435761) & mask and walk until the key (hit) or an
// EMPTY slot (miss).  A walk is capped at one lap of the table, so a
// malformed full table is a miss, never a hang; the step counter is 64-bit
// so that the lap of a 2^32-slot table (mask 0xffffffff) ends too.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = -2147483647 - 1;      // INT32_MIN
constexpr unsigned kHashMul = 2654435761u;

// The walk past a key's home slot, whose key was neither the key nor
// EMPTY: slots home + 1, home + 2, ... for the rest of one lap; on a hit
// *slot is the key's slot.  home_slot's load and then walk_on() are the
// walk of block_lookup's rule in two parts, so a caller can issue the
// home loads of several rows before it walks any of them.
__device__ __forceinline__ bool walk_on(const int* __restrict__ htk,
                                        unsigned mask, int key,
                                        unsigned* slot) {
  unsigned s = *slot;
  for (unsigned long long step = 1; step <= mask; ++step) {
    s = (s + 1u) & mask;
    const int k = __ldg(htk + s);
    if (k == key) {
      *slot = s;
      return true;
    }
    if (k == kEmpty) return false;
  }
  return false;
}

// The same walk a run at a time.  The home slot alone first (home_slot):
// on an SSB dimension table most walks end there.  Then the walk past it
// a run of W slots a step (W = 1, 2, 4 or 8; W * 4 bytes, one or two
// vector loads; the table row's address a multiple of W * 4 bytes and its
// slot count of W): step s reads aligned run s from the one that holds
// the home slot, wrapping at the row's end, and the first slot of the
// run, in probe order, that holds the key (hit) or EMPTY (miss) ends the
// walk, found in registers, so a step reads one run where walk_on() reads
// one slot.  The answer is walk_on()'s: step 0 reads the home run from the
// slot after home, and step S / W (the home run again) the slots before
// home, after which a walk that met neither is a miss (one lap).
__device__ __forceinline__ unsigned home_slot(int key, unsigned mask) {
  return (static_cast<unsigned>(key) * kHashMul) & mask;
}

template <int W>
struct SlotRun {
  int k[W];
};

enum : int { kWalkOn = 0, kHit = 1, kMiss = 2 };

template <int W>
__device__ __forceinline__ unsigned run_base(int key, unsigned mask,
                                             unsigned step) {
  return ((home_slot(key, mask) & ~(W - 1u)) + step * W) & mask;
}

template <int W>
__device__ __forceinline__ SlotRun<W> load_run(const int* __restrict__ htk,
                                               unsigned base) {
  static_assert(W == 1 || W == 2 || W == 4 || W == 8, "a run of 1-8 slots");
  SlotRun<W> run;
  if constexpr (W == 8 || W == 4) {
#pragma unroll
    for (int h = 0; h < W; h += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(htk + base + h));
      run.k[h] = v.x;
      run.k[h + 1] = v.y;
      run.k[h + 2] = v.z;
      run.k[h + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(htk + base));
    run.k[0] = v.x;
    run.k[1] = v.y;
  } else {
    run.k[0] = __ldg(htk + base);
  }
  return run;
}

// Reads step `step` of the walk past `key`'s home slot: kHit (its slot in
// *slot), kMiss, or kWalkOn to the next step.
template <int W>
__device__ __forceinline__ int read_run(const SlotRun<W>& run, int key,
                                        unsigned mask, unsigned step,
                                        unsigned* slot) {
  const unsigned home = home_slot(key, mask);
  const unsigned off = home & (W - 1u);
  const unsigned base = ((home - off) + step * W) & mask;
  const bool last = step != 0 && base == home - off;   // the lap's end
  const unsigned from = step == 0 ? off + 1u : 0u;
  const unsigned to = last ? off : static_cast<unsigned>(W);
  unsigned found = 0u, ends = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    found |= static_cast<unsigned>(run.k[j] == key) << j;
    ends |= static_cast<unsigned>(run.k[j] == key || run.k[j] == kEmpty) << j;
  }
  ends &= ((1u << to) - 1u) & ~((1u << from) - 1u);
  if (ends) {
    const int j = __ffs(ends) - 1;
    *slot = base + j;
    return (found >> j) & 1u ? kHit : kMiss;
  }
  return last ? kMiss : kWalkOn;
}

}  // namespace
