// Stable block-level compaction of the select scans (select_scan.cu);
// radix_part.cu takes its block shape and warp helpers.  The probe
// compactions sweep once instead (lookback.cuh).
//
// The Pallas kernels it replaces (src/repro/kernels/select_scan.py::
// select_scan and its packed and sparse forms) carry the running output offset
// in SMEM across a grid that runs in order, so their output is stable.
// Hopper blocks run in any order, and a global atomicAdd for each tile's
// base (Crystal's selection) would change the order from run to run.  So a
// compaction here runs in three phases, each a launch on one stream:
//
//   1. count:   one block per tile of kTile rows writes the tile's matches
//               to counts[tile];
//   2. scan:    one block scans counts into exclusive tile offsets and
//               writes the total (scan_tiles below);
//   3. scatter: one block per tile evaluates its rows again and writes
//               each match to offsets[tile] + its rank within the tile.
//
// Within a tile, rows are taken kThreads at a time in row order (a warp
// holds 32 neighbouring rows, so loads are coalesced); a row's rank is the
// matches before it in the same step (warp ballot and __popc, then the
// counts of the warps before it, from shared memory) plus the matches of
// the earlier steps.  The output is the same bits on every run.
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

// Rank of this thread's flag among the block's set flags, in thread order,
// and the block's count in *total.  Every thread of the block calls it;
// `warp_counts` is kWarps ints of shared memory.
__device__ __forceinline__ int block_rank(bool flag, int* warp_counts,
                                          int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, flag);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();                 // warp_counts is reused by the next call
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

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
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Phase 2, one block of kScanThreads: offsets[t] = counts[0] + ... +
// counts[t-1]; *count = the sum of all.  Each thread takes kScanItems
// neighbouring counts per round.
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
