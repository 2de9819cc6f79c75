// Block-level tiles of the radix kernels (radix_part.cu): the block
// shape and a warp scan, which select_scan.cu takes too.  A block takes a
// tile of kTile rows, kThreads at a time in row order (a warp holds 32
// neighbouring rows, so loads are coalesced).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // steps of kThreads rows
constexpr long long kTile = static_cast<long long>(kThreads) * kItems;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan of `v` over a warp.
template <typename T>
__device__ __forceinline__ T warp_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

}  // namespace
