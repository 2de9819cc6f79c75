// Linear-probe lookup into an open-addressing table, shared by
// ssb_fused.cu and hash_join.cu.
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

__device__ __forceinline__ bool probe(const int* __restrict__ htk,
                                      const int* __restrict__ htv,
                                      unsigned mask, int key, int* payload) {
  unsigned slot = (static_cast<unsigned>(key) * kHashMul) & mask;
  for (unsigned long long step = 0; step <= mask; ++step) {
    const int k = __ldg(htk + slot);
    if (k == key) {
      *payload = __ldg(htv + slot);
      return true;
    }
    if (k == kEmpty) return false;
    slot = (slot + 1u) & mask;
  }
  return false;
}

}  // namespace
