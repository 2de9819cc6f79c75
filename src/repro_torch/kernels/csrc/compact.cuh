// Block-level tiles of the sparse selection scan (select_scan.cu's
// select_scan_sparse) and of the radix kernels (radix_part.cu): the block
// shape, warp helpers and the scan of tile counts.  The dense select scans
// and the probe compactions sweep once instead (lookback.cuh).
//
// A block takes a tile of kTile rows, kThreads at a time in row order (a
// warp holds 32 neighbouring rows, so loads are coalesced).  Where a
// compaction's tiles run as blocks in any order, their offsets come from
// a second launch: scan_tiles, one block that scans the tiles' counts into
// exclusive offsets and writes the total, so the output is stable and the
// same bits on every run.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // steps of kThreads rows
constexpr long long kTile = static_cast<long long>(kThreads) * kItems;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;                 // tile counts per thread
constexpr unsigned kFull = 0xffffffffu;

// Sum of `v` over the block, returned to every thread.
__device__ __forceinline__ int block_sum(int v, int* warp_counts) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = v;
  __syncthreads();
  int all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all += warp_counts[w];
  return all;
}

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

// A compaction's tile offsets, one block of kScanThreads: offsets[t] =
// counts[0] + ... + counts[t-1]; *count = the sum of all.  Each thread
// takes kScanItems neighbouring counts per round.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles(const int* __restrict__ counts, int* __restrict__ offsets,
           int n_tiles, long long* count) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kScanThreads * kScanItems) {
    const int first = base + threadIdx.x * kScanItems;
    int own[kScanItems];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      own[i] = first + i < n_tiles ? counts[first + i] : 0;
      sum += own[i];
    }
    const int incl = warp_scan(sum);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_scan(warp_sums[lane]);
    __syncthreads();
    int run = carry + incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (first + i < n_tiles) offsets[first + i] = run;
      run += own[i];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();               // warp_sums is rewritten next round
  }
  if (threadIdx.x == 0) *count = carry;
}

}  // namespace
