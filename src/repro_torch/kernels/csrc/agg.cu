// Group-by sum and global sum for Hopper (sm_90a).
//
// group_sum: SUM(vals) GROUP BY dense int32 ids.  Replaces the Pallas TPU
// kernel src/repro/kernels/agg.py::group_sum
// (_group_kernel), which adds each tile into one (n_groups,) accumulator
// in VMEM across a grid that runs in order.  Hopper blocks run in any
// order, so the design depends on the values' type:
//
//  * int32 values: wrapping int32 addition is associative, so any order
//    gives the reference's bits.  Each block adds its rows into an
//    (n_groups,) uint32 grid in shared memory with shared atomics, then
//    adds each nonzero group to the zeroed output with one global atomic.
//  * f32 values: float atomics would change the rounding from run to run.
//    Each warp owns an (n_groups,) f64 grid in shared memory and walks its
//    own fixed rows 32 at a time; the lanes of one step that share a group
//    (__match_any_sync) are summed in lane order by the lowest of them,
//    which adds the sum to the warp's grid.  The warps' grids go to device
//    memory as partial grids, and a second kernel sums them in a fixed
//    order and rounds to f32 once.  The result is the same bits on every
//    run, and an integer-valued sum (every SSB measure) is exact far past
//    SF 20 (2^53 against q1.1's 2.2e9), so it equals the numpy oracle.
//
// An id outside [0, n_groups) is dropped (an unsigned compare, as in
// ssb_fused.cu).
//
// What bounds it: device-memory bytes at 3.35 TB/s: ids and vals read
// once (8n) and the grid written.  The f32 path adds the partial grids,
// 8 bytes a group for each warp in flight, written and read once.  Up to
// 8 warps a block share the 227 KB of shared memory: at 7000 groups
// (SSB flight 2) that is 4 warps, one block an SM.
//
// reduce_sum: the global sum of an int32 or f32 column.  Replaces the
// Pallas TPU kernel src/repro/kernels/agg.py::reduce_sum (_sum_kernel),
// which adds each tile into one scalar across a grid that runs in order;
// here each block sums its rows and reduce.cuh's finish_sum adds the
// blocks' partials in a fixed order: an int32 sum wraps as the
// reference's, an f32 sum is taken in f64 and rounded once (the
// reference sums in f32).  What bounds it: the column read once, 4 bytes
// a row at 3.35 TB/s; each thread reads 16 bytes a load (a 16-byte
// aligned column), four loads in flight, over a grid of as many blocks as
// fit on the SMs at once.
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;          // int32 path
constexpr int kItems = 4;
constexpr int kMaxWarps = 8;           // f32 path, warps a block
constexpr int kMinSteps = 8;           // f32 path, 32-row steps a warp
constexpr int kReduceSlices = 32;      // warps of the reduce kernel
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr int kStageBytes = kMaxWarps * 32 * 8;   // stage[][] below

__global__ void __launch_bounds__(kThreads)
group_sum_i32(const int* __restrict__ ids, const int* __restrict__ vals,
              long long n, int n_groups, unsigned* __restrict__ out) {
  extern __shared__ unsigned acc[];
  for (int g = threadIdx.x; g < n_groups; g += kThreads) acc[g] = 0u;
  __syncthreads();
  const long long tile = static_cast<long long>(kThreads) * kItems;
  const long long stride = tile * gridDim.x;
  for (long long base = tile * blockIdx.x; base < n; base += stride) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long r = base + static_cast<long long>(i) * kThreads +
                          threadIdx.x;
      if (r >= n) break;
      const unsigned g = static_cast<unsigned>(__ldg(ids + r));
      if (g < static_cast<unsigned>(n_groups))
        atomicAdd(&acc[g], static_cast<unsigned>(__ldg(vals + r)));
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    const unsigned v = acc[g];
    if (v != 0u) atomicAdd(out + g, v);
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
group_sum_f64_partials(const int* __restrict__ ids,
                       const float* __restrict__ vals, long long n,
                       int n_groups, double* __restrict__ partials) {
  extern __shared__ double grids[];            // warps x n_groups
  __shared__ double stage[kMaxWarps][32];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < warps * n_groups; i += blockDim.x)
    grids[i] = 0.0;
  __syncthreads();
  double* grid = grids + warp * n_groups;
  const long long stride = 32LL * gridDim.x * warps;
  for (long long base = 32LL * (static_cast<long long>(blockIdx.x) * warps +
                                warp);
       base < n; base += stride) {
    const long long r = base + lane;
    unsigned g = kNone;
    double v = 0.0;
    if (r < n) {
      g = static_cast<unsigned>(__ldg(ids + r));
      v = static_cast<double>(__ldg(vals + r));
      if (g >= static_cast<unsigned>(n_groups)) g = kNone;
    }
    stage[warp][lane] = v;
    const unsigned peers = __match_any_sync(kFull, g);
    __syncwarp();
    if (g != kNone && lane == __ffs(peers) - 1) {
      double s = 0.0;
      for (unsigned m = peers; m != 0u; m &= m - 1u)
        s += stage[warp][__ffs(m) - 1];
      grid[g] += s;
    }
    __syncwarp();                  // stage is rewritten by the next step
  }
  __syncthreads();
  double* mine = partials + static_cast<long long>(blockIdx.x) * warps *
                                n_groups;
  for (int i = threadIdx.x; i < warps * n_groups; i += blockDim.x)
    mine[i] = grids[i];
}

// One block per 32 groups: warp s sums partial rows s, s + 32, ... of its
// lane's group in order, then warp 0 sums the 32 slices in order.
__global__ void __launch_bounds__(kReduceSlices * 32)
reduce_partials(const double* __restrict__ partials, int rows, int n_groups,
                float* __restrict__ out) {
  __shared__ double part[kReduceSlices][33];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int g = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (g < n_groups) {
    for (int w = slice; w < rows; w += kReduceSlices)
      s += partials[static_cast<long long>(w) * n_groups + g];
  }
  part[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && g < n_groups) {
    double t = 0.0;
    for (int k = 0; k < kReduceSlices; ++k) t += part[k][lane];
    out[g] = __double2float_rn(t);
  }
}

// The dynamic shared memory a block of each path needs for n_groups.
size_t grid_bytes(int n_groups, int is_float, int warps) {
  return is_float ? static_cast<size_t>(warps) * n_groups * sizeof(double)
                  : static_cast<size_t>(n_groups) * sizeof(unsigned);
}

}  // namespace

// The launch shape for n_groups on the current device, the one place it is
// computed; the wrapper asks once per (device, n_groups, path) and keeps
// it.  shape[0]: rows a block takes per grid step (the grid is the rows
// over this, up to shape[1]); shape[1]: blocks resident on the card, 0 when
// n_groups does not fit one block's shared memory; shape[2]: partial grid
// rows a block writes (the f32 path's warps, else 0); shape[3]: the most
// groups either path takes.  Raises the kernel's dynamic shared memory cap
// to that most, so a later launch of any shape needs no further call.
extern "C" int group_sum_shape(int n_groups, int is_float, long long* shape) {
  if (n_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one warp's f64 grid beside the f32 path's static stage[][] bounds
  // both paths, as ssb_fused.py bounds the fused kernel's int64 grid
  const int cap = optin - kStageBytes;
  shape[0] = shape[1] = shape[2] = 0;
  shape[3] = cap / static_cast<int>(sizeof(double));
  if (n_groups > shape[3]) return static_cast<int>(cudaSuccess);
  const int fit = cap / (n_groups * static_cast<int>(sizeof(double)));
  const int warps = is_float ? (fit < kMaxWarps ? fit : kMaxWarps) : 0;
  const size_t smem = grid_bytes(n_groups, is_float, warps);
  if (is_float) {
    err = cudaFuncSetAttribute(group_sum_f64_partials,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, group_sum_f64_partials, warps * 32, smem);
  } else {
    err = cudaFuncSetAttribute(group_sum_i32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_sum_i32,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  shape[0] = is_float ? 32LL * kMinSteps * warps
                      : static_cast<long long>(kThreads) * kItems;
  shape[1] = static_cast<long long>(sms) * per_sm;
  shape[2] = warps;
  return static_cast<int>(cudaSuccess);
}

// ids: (n,) int32; vals: (n,) int32 (is_float 0) or f32 (is_float 1);
// out: (n_groups,) int32, zeroed, or f32; blocks and warps (the f32 path's,
// else 0) from group_sum_shape; partials: (blocks * warps, n_groups) f64
// scratch (f32 only, else null).  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int group_sum_launch(const void* ids, const void* vals,
                                long long n, int n_groups, int is_float,
                                long long blocks, int warps, void* partials,
                                void* out, void* stream) {
  if (n <= 0 || n_groups < 1 || blocks < 1 || blocks > 2147483647LL ||
      (is_float && (warps < 1 || warps > kMaxWarps || partials == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = grid_bytes(n_groups, is_float, warps);
  if (is_float) {
    group_sum_f64_partials<<<static_cast<unsigned>(blocks), warps * 32, smem,
                             s>>>(static_cast<const int*>(ids),
                                  static_cast<const float*>(vals), n,
                                  n_groups, static_cast<double*>(partials));
    reduce_partials<<<(n_groups + 31) / 32, kReduceSlices * 32, 0, s>>>(
        static_cast<const double*>(partials),
        static_cast<int>(blocks * warps), n_groups, static_cast<float*>(out));
  } else {
    group_sum_i32<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const int*>(ids), static_cast<const int*>(vals), n,
        n_groups, static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

__device__ __forceinline__ unsigned long long add4(int4 v) {
  return static_cast<unsigned long long>(static_cast<long long>(v.x) + v.y +
                                         v.z + v.w);
}

__device__ __forceinline__ double add4(float4 v) {
  return ((static_cast<double>(v.x) + v.y) + v.z) + v.w;
}

// Each block's partial sum of x: the 16-byte vectors first (`vec`: x is
// 16-byte aligned), four a thread in flight, then the ragged rows.
template <typename T, typename T4, typename Acc>
__global__ void __launch_bounds__(kSumThreads)
reduce_sum_partials(const T* __restrict__ x, long long n, int vec,
                    Acc* __restrict__ partials) {
  const long long stride = static_cast<long long>(gridDim.x) * kSumThreads;
  const long long n4 = vec ? n / 4 : 0;
  const T4* x4 = reinterpret_cast<const T4*>(x);
  Acc s = Acc(0);
  long long i = static_cast<long long>(blockIdx.x) * kSumThreads +
                threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const T4 a = __ldg(x4 + i);
    const T4 b = __ldg(x4 + i + stride);
    const T4 c = __ldg(x4 + i + 2 * stride);
    const T4 d = __ldg(x4 + i + 3 * stride);
    s += add4(a);
    s += add4(b);
    s += add4(c);
    s += add4(d);
  }
  for (; i < n4; i += stride) s += add4(__ldg(x4 + i));
  for (long long r = 4 * n4 + static_cast<long long>(blockIdx.x) *
                                  kSumThreads + threadIdx.x;
       r < n; r += stride)
    s += static_cast<Acc>(__ldg(x + r));
  s = block_total(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

}  // namespace

// Blocks of reduce_sum's partial kernel resident on the card (its grid is
// the vectors over kSumThreads, up to this).
extern "C" int reduce_sum_shape(int is_float, long long* resident) {
  if (is_float)
    return resident_blocks(reduce_sum_partials<float, float4, double>,
                           resident);
  return resident_blocks(
      reduce_sum_partials<int, int4, unsigned long long>, resident);
}

// x: (n,) int32 (is_float 0) or f32; partials: `blocks` 8-byte scratch
// (int64 or f64); out: one int32 or f32.  Launches the partial kernel and
// finish_sum on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int reduce_sum_launch(const void* x, long long n, int is_float,
                                 long long blocks, void* partials, void* out,
                                 void* stream) {
  if (n <= 0 || blocks < 1 || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = (reinterpret_cast<std::uintptr_t>(x) & 15u) == 0u;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (is_float) {
    reduce_sum_partials<float, float4, double><<<grid, kSumThreads, 0, s>>>(
        static_cast<const float*>(x), n, vec, static_cast<double*>(partials));
    finish_sum<<<1, kFinishThreads, 0, s>>>(
        static_cast<const double*>(partials), static_cast<int>(blocks),
        static_cast<float*>(out));
  } else {
    reduce_sum_partials<int, int4, unsigned long long>
        <<<grid, kSumThreads, 0, s>>>(
            static_cast<const int*>(x), n, vec,
            static_cast<unsigned long long*>(partials));
    finish_sum<<<1, kFinishThreads, 0, s>>>(
        static_cast<const unsigned long long*>(partials),
        static_cast<int>(blocks), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
