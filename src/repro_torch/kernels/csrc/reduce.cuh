// Sums over many blocks that give the same bits on every run, shared by
// agg.cu (reduce_sum) and hash_join.cu (probe_agg).
//
// The Pallas kernels they replace carry one scalar accumulator through a
// grid that runs in order.  Hopper blocks run in any order, so here each
// block reduces its rows in a fixed order (each thread its own rows, a
// shuffle tree per warp, the warps in order) to one partial in device
// memory, and finish_sum, one block launched after it on the same stream,
// adds the partials in a fixed order and rounds once.  int32 data is
// summed in unsigned 64-bit (two's complement) and cut to int32 at the
// end: sums mod 2^32 do not depend on order, so the result is the
// reference's wrapping int32 sum.  f32 data is summed in f64 and rounded
// to f32 once; the order is fixed for a given grid, so two runs on one
// card agree bit for bit.  That order is not the plain version's
// (ref.reduce_sum, ref.probe_agg): the two agree bit for bit when the f64
// sum is exact (integer-valued data under 2^53), and otherwise within one
// f32 ulp of each other.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr unsigned kAllLanes = 0xffffffffu;

// Sum of v over the block in a fixed order; the total is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_total(T v) {
  __shared__ T warp_sums[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kAllLanes, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      total += warp_sums[w];
  }
  return total;
}

__device__ __forceinline__ void store_total(unsigned long long s, int* out) {
  *out = static_cast<int>(static_cast<unsigned>(s));
}

__device__ __forceinline__ void store_total(double s, float* out) {
  *out = __double2float_rn(s);
}

// One block: the n partials in a fixed order, the total rounded once.
template <typename T, typename Out>
__global__ void __launch_bounds__(kFinishThreads)
finish_sum(const T* __restrict__ partials, int n, Out* __restrict__ out) {
  T s = T(0);
  for (int i = threadIdx.x; i < n; i += kFinishThreads) s += partials[i];
  s = block_total(s);
  if (threadIdx.x == 0) store_total(s, out);
}

// Blocks of `kernel` resident on the current device at kSumThreads
// threads, for the wrapper's grid.
template <typename Kernel>
int resident_blocks(Kernel kernel, long long* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kSumThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(cudaSuccess);
}

}  // namespace
