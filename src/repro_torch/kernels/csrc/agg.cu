// Group-by sum and global sum for Hopper (sm_90a).
//
// group_sum: SUM(vals) GROUP BY dense int32 ids.  Replaces the Pallas TPU
// kernel src/repro/kernels/agg.py::group_sum
// (_group_kernel), which adds each tile into one (n_groups,) accumulator
// in VMEM across a grid that runs in order.  Hopper blocks run in any
// order, so here a call is one cooperative launch of at most the resident
// blocks, in two phases split by a grid sync:
//
//  1. each block sums its rows into shared memory in a fixed order, then
//     adds its warps' grids in warp order into one partial row of
//     device memory (a block alone in its grid writes the result here and
//     stops);
//  2. after the grid sync, block b takes groups b * 32 .. b * 32 + 31,
//     then those gridDim.x * 32 on, and adds each group's partial rows in
//     block order: warp w the rows w, w + warps, ..., then the warps'
//     sums in warp order; it writes `out` (or adds into `acc`) whole.
//
// The accumulation depends on the values' type:
//
//  * int32 values: wrapping int32 addition is associative, so any order
//    gives the reference's bits.  A block of 256 threads adds its rows
//    (8 a thread in flight) into an (n_groups,) uint32 grid with shared
//    atomics.
//  * f32 values: float atomics would change the rounding from run to run.
//    While a block's values are integers of magnitude at most 2^31 (every
//    SSB measure), their sums are exact in int64 and so the same in any
//    order: the block adds them into one (n_groups,) int64 grid of two
//    32-bit words a group with shared atomics (add_exact).  A block that
//    meets any other value adds its rows again, in a fixed order: each
//    of up to 8 warps owns an (n_groups,) f64 grid in shared memory and
//    adds its share of the block's rows 32 a step; the lanes of one step
//    that share a group (__match_any_sync) are summed in lane order by
//    the lowest of them, which adds the sum to the warp's grid.  The
//    result is the same bits on every run for a given grid, and an
//    integer-valued sum is exact far past SF 20 (2^53 against q1.1's
//    2.2e9), so it equals the numpy oracle.  On SSB flight 2's 7000
//    groups the match step alone lost to the two-kernel design (PERF.md
//    §6); the exact path is what a query pays.
//
// An id outside [0, n_groups) is dropped (an unsigned compare, as in
// ssb_fused.cu).
//
// What bounds it: device-memory bytes at 3.35 TB/s, ids and vals read
// once (8n) and the grid written.  What held the two-kernel design back
// was per call, not per row: a fill of `out`, a grid of warps' partial
// grids (blocks x warps x n_groups x 8 bytes: 29.6 MB at 7000 groups,
// written and read again by a second kernel), and 224 KB of shared memory
// cleared and copied out by every block however few rows it got.  Here
// the wrapper sizes the grid by the call's rows (agg.py's group_grid: a
// call of a few thousand rows is one block, which writes no partial row;
// the partial rows stay a small share of the 8n input bytes), the partial
// rows fall to one a block and stay in L2, and nothing else runs.  The
// f32 block's f64 grids share the 227 KB of shared memory: at 7000 groups
// (SSB flight 2) 4 of its 16 warps own one, and one block fits an SM.
//
// reduce_sum: the global sum of an int32 or f32 column.  Replaces the
// Pallas TPU kernel src/repro/kernels/agg.py::reduce_sum (_sum_kernel),
// which adds each tile into one scalar across a grid that runs in order;
// here each block sums its rows and the block that finishes last adds the
// blocks' partials in a fixed order, in the same launch
// (reduce.cuh's finish_by_last_block): an int32 sum wraps as the
// reference's, an f32 sum is taken in f64 and rounded once (the
// reference sums in f32).  What bounds it: the column read once, 4 bytes
// a row at 3.35 TB/s; each thread reads 16 bytes a load (a 16-byte
// aligned column), four loads in flight, over a grid of as many blocks of
// 1,024 threads as fit on the SMs at once (2 an SM).  A call is one
// memset (the ticket) and one kernel, which writes the output whole: a
// fill of it or a second launch to finish the sum would each be a
// dependent launch, about what a 2^28-row call would lose to torch.sum.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;          // int32 path, threads a block
constexpr int kItems = 8;              // int32 path, rows a thread holds
constexpr int kMaxWarps = 8;           // f32 path, warps with an f64 grid
constexpr int kBlockWarps = 16;        // f32 path, warps a block
constexpr int kSteps = 8;              // f32 path, rows a thread a tile
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr int kStageBytes = kBlockWarps * 32 * 8;   // stage[][] below

// A group's sum into the result: rounded to f32 once, or added unrounded
// into the running f64 grid of a morsel fold.
__device__ __forceinline__ void store_group(double s, int g, float* out,
                                            double* acc) {
  if (acc != nullptr) {
    acc[g] += s;
  } else {
    out[g] = __double2float_rn(s);
  }
}

// The same for int32 sums (as uint32: wrapping), written or added.
__device__ __forceinline__ void store_group(unsigned s, int g, unsigned* out,
                                            unsigned* acc) {
  if (acc != nullptr) {
    acc[g] += s;
  } else {
    out[g] = s;
  }
}

// Phase 2, after the grid sync: each group's gridDim.x partial rows added
// in block order (warp w of the block the rows w, w + warps, ...; then
// the warps' sums in warp order, through `part`, 32 a warp) and stored.
// The rows were written by other SMs in this launch, so they are read
// past L1.
template <typename T, typename Out>
__device__ __forceinline__ void finish_groups(const T* partials,
                                              int n_groups, T* part,
                                              Out* out, T* acc) {
  const int warps = static_cast<int>(blockDim.x >> 5);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = static_cast<int>(gridDim.x);
  for (int c = blockIdx.x; c * 32 < n_groups;
       c += static_cast<int>(gridDim.x)) {
    const int g = c * 32 + lane;
    T s = T(0);
    if (g < n_groups) {
#pragma unroll 8
      for (int r = warp; r < rows; r += warps)
        s += __ldcg(partials + static_cast<long long>(r) * n_groups + g);
    }
    part[warp * 32 + lane] = s;
    __syncthreads();
    if (warp == 0 && g < n_groups) {
      T t = T(0);
      for (int w = 0; w < warps; ++w) t += part[w * 32 + lane];
      store_group(t, g, out, acc);
    }
    __syncthreads();                 // part is rewritten by the next chunk
  }
}

// Phase 1's end: the block's row of sums (`row(g)`) stored as the result
// when the block is the whole grid (true: the launch is done), else as
// the block's partial row.
template <typename T, typename Out, typename Row>
__device__ __forceinline__ bool block_row(int n_groups, Row row,
                                          T* partials, Out* out, T* acc) {
  const bool alone = gridDim.x == 1;
  T* mine = alone ? nullptr
                  : partials + static_cast<long long>(blockIdx.x) * n_groups;
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
    const T s = row(g);
    if (alone) {
      store_group(s, g, out, acc);
    } else {
      mine[g] = s;
    }
  }
  return alone;
}

__global__ void __launch_bounds__(kThreads)
group_sum_i32(const int* __restrict__ ids, const int* __restrict__ vals,
              long long n, int n_groups, unsigned* partials, unsigned* out,
              unsigned* acc) {
  extern __shared__ unsigned sums[];
  __shared__ unsigned part[kThreads];
  for (int g = threadIdx.x; g < n_groups; g += kThreads) sums[g] = 0u;
  __syncthreads();
  const unsigned groups = static_cast<unsigned>(n_groups);
  const long long tile = static_cast<long long>(kThreads) * kItems;
  const long long stride = tile * gridDim.x;
  for (long long base = tile * blockIdx.x; base < n; base += stride) {
    unsigned g[kItems], v[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long r = base + static_cast<long long>(i) * kThreads +
                          threadIdx.x;
      g[i] = kNone;
      v[i] = 0u;
      if (r < n) {
        g[i] = static_cast<unsigned>(__ldg(ids + r));
        v[i] = static_cast<unsigned>(__ldg(vals + r));
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (g[i] < groups) atomicAdd(&sums[g[i]], v[i]);
  }
  __syncthreads();
  if (block_row(n_groups, [&](int g) { return sums[g]; }, partials, out,
                acc))
    return;
  cooperative_groups::this_grid().sync();
  finish_groups(partials, n_groups, part, out, acc);
}

// A warp tile's rows, 32 a step: lane l holds row base + 32 k + l of
// step k (every load of the tile in flight at once).
__device__ __forceinline__ void load_tile(const int* __restrict__ ids,
                                          const float* __restrict__ vals,
                                          long long n, long long base,
                                          int lane, unsigned* g, float* v) {
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const long long r = base + 32LL * k + lane;
    g[k] = kNone;
    v[k] = 0.0f;
    if (r < n) {
      g[k] = static_cast<unsigned>(__ldg(ids + r));
      v[k] = __ldg(vals + r);
    }
  }
}

// One step of a warp's rows into its f64 grid: the lanes that share group
// g add their values in lane order, by the lowest of them (a lane alone
// in its group adds its own value; a step of one group, 32 values
// unrolled).  g is kNone for a dropped row.
__device__ __forceinline__ void add_step(double* grid, double* stage,
                                         int lane, unsigned g, double v) {
  stage[lane] = v;
  const unsigned peers = __match_any_sync(kFull, g);
  __syncwarp();
  if (g != kNone && lane == __ffs(peers) - 1) {
    double s = 0.0;
    if (peers == 1u << lane) {
      s = v;
    } else if (peers == kFull) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s += stage[j];
    } else {
      for (unsigned m = peers; m != 0u; m &= m - 1u)
        s += stage[__ffs(m) - 1];
    }
    grid[g] += s;
  }
  __syncwarp();                    // stage is rewritten by the next step
}

// An exact int64 sum added into a group's (lo, hi) words with two 32-bit
// shared atomics: the low word, then the high word with the carry out of
// the low one.  The words hold the group's sum mod 2^64.
__device__ __forceinline__ void add_exact(unsigned* lo, unsigned* hi,
                                          unsigned g, long long x) {
  const unsigned l = static_cast<unsigned>(x);
  const unsigned h =
      static_cast<unsigned>(static_cast<unsigned long long>(x) >> 32);
  const unsigned old = atomicAdd(lo + g, l);
  atomicAdd(hi + g, h + (old + l < old ? 1u : 0u));
}

// A block tile's rows, kSteps a thread: thread t holds rows base + k *
// blockDim.x + t (every load in flight at once; kNone past n).
__device__ __forceinline__ void load_rows(const int* __restrict__ ids,
                                          const float* __restrict__ vals,
                                          long long n, long long base,
                                          unsigned* g, float* v) {
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const long long r = base + static_cast<long long>(k) * blockDim.x +
                        threadIdx.x;
    g[k] = kNone;
    v[k] = 0.0f;
    if (r < n) {
      g[k] = static_cast<unsigned>(__ldg(ids + r));
      v[k] = __ldg(vals + r);
    }
  }
}

// f32 values.  A block takes tiles of blockDim.x * kSteps rows, a grid
// stride apart.  First the exact path: while the block's values are
// integers of magnitude at most 2^31 (every SSB measure), their sums are
// the same in any order, so each thread adds its rows (kSteps of them,
// the next tile's in flight meanwhile; a run of one group summed in a
// register) into the block's one int64 grid of (lo, hi) words with shared
// atomics.  If any of the block's values is
// not (__syncthreads_or), the block adds its rows again in lane order:
// each of `grid_warps` warps owns an f64 grid and takes its share of the
// tiles' 32 * kSteps-row parts, 32 rows a step (add_step).  Either way
// the block's row of sums is the same bits on every run.
__global__ void __launch_bounds__(kBlockWarps * 32)
group_sum_f32(const int* __restrict__ ids, const float* __restrict__ vals,
              long long n, int n_groups, int grid_warps, double* partials,
              float* out, double* acc) {
  extern __shared__ double grids[];     // grid_warps x n_groups; (lo, hi)
  __shared__ double stage[kBlockWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned groups = static_cast<unsigned>(n_groups);
  const long long tile = static_cast<long long>(blockDim.x) * kSteps;
  const long long stride = tile * gridDim.x;
  unsigned* lo = reinterpret_cast<unsigned*>(grids);
  unsigned* hi = lo + n_groups;
  for (int i = threadIdx.x; i < 2 * n_groups; i += blockDim.x) lo[i] = 0u;
  __syncthreads();
  bool inexact = false;
  unsigned run_g = kNone;
  long long run = 0;
  long long base = tile * blockIdx.x;
  unsigned g[kSteps];
  float v[kSteps];
  load_rows(ids, vals, n, base, g, v);
  while (base < n) {
    const long long next = base + stride;
    unsigned ng[kSteps];
    float nv[kSteps];
    load_rows(ids, vals, n, next, ng, nv);       // in flight meanwhile
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      if (g[k] >= groups) continue;
      if (!(v[k] == truncf(v[k]) && fabsf(v[k]) <= 2147483648.0f)) {
        inexact = true;
        continue;
      }
      if (g[k] != run_g) {
        if (run_g != kNone) add_exact(lo, hi, run_g, run);
        run_g = g[k];
        run = 0;
      }
      run += static_cast<long long>(v[k]);
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      g[k] = ng[k];
      v[k] = nv[k];
    }
    base = next;
  }
  if (run_g != kNone) add_exact(lo, hi, run_g, run);
  bool alone;
  if (!__syncthreads_or(inexact)) {
    alone = block_row(
        n_groups,
        [&](int g) {
          return static_cast<double>(static_cast<long long>(
              static_cast<unsigned long long>(hi[g]) << 32 | lo[g]));
        },
        partials, out, acc);
  } else {
    for (int i = threadIdx.x; i < grid_warps * n_groups; i += blockDim.x)
      grids[i] = 0.0;
    __syncthreads();
    if (warp < grid_warps) {
      double* grid = grids + warp * n_groups;
      const int parts = static_cast<int>(blockDim.x >> 5);
      for (long long base = tile * blockIdx.x; base < n; base += stride) {
        for (int t = warp; t < parts; t += grid_warps) {
          const long long part = base + 32LL * kSteps * t;
          if (part >= n) break;
          unsigned g[kSteps];
          float v[kSteps];
          load_tile(ids, vals, n, part, lane, g, v);
#pragma unroll
          for (int k = 0; k < kSteps; ++k) {
            if (part + 32LL * k >= n) break;
            add_step(grid, stage[warp], lane, g[k] < groups ? g[k] : kNone,
                     static_cast<double>(v[k]));
          }
        }
      }
    }
    __syncthreads();
    alone = block_row(
        n_groups,
        [&](int g) {
          double s = 0.0;
          for (int w = 0; w < grid_warps; ++w) s += grids[w * n_groups + g];
          return s;
        },
        partials, out, acc);
  }
  if (alone) return;
  cooperative_groups::this_grid().sync();
  finish_groups(partials, n_groups, &stage[0][0], out, acc);
}

// The dynamic shared memory a block of each path needs for n_groups.
size_t grid_bytes(int n_groups, int is_float, int warps) {
  return is_float ? static_cast<size_t>(warps) * n_groups * sizeof(double)
                  : static_cast<size_t>(n_groups) * sizeof(unsigned);
}

// group_sum_launch's arguments, passed by one pointer (a ctypes call pays
// for each argument it converts).
struct GroupArgs {
  const int* ids;
  const void* vals;
  long long n;
  int n_groups;
  int is_float;
  long long blocks;
  int warps;
  void* partials;
  void* out;
  void* acc;
};

}  // namespace

// The launch shape for n_groups on the current device, the one place it is
// computed; the wrapper asks once per (device, n_groups, path) and keeps
// it.  shape[0]: blocks resident on the card (the most a cooperative
// launch takes), 0 when n_groups does not fit one block's shared memory;
// shape[1]: the f32 path's warps that own an f64 grid (of its 16 a
// block), else 8; shape[2]: the most groups either path takes.
// Raises the kernel's dynamic shared memory cap to that most, so a later
// launch of any shape needs no further call.
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
  shape[0] = shape[1] = 0;
  shape[2] = cap / static_cast<int>(sizeof(double));
  if (n_groups > shape[2]) return static_cast<int>(cudaSuccess);
  const int fit = cap / (n_groups * static_cast<int>(sizeof(double)));
  const int warps = is_float ? (fit < kMaxWarps ? fit : kMaxWarps)
                             : kThreads / 32;
  const size_t smem = grid_bytes(n_groups, is_float, warps);
  if (is_float) {
    err = cudaFuncSetAttribute(group_sum_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, group_sum_f32, kBlockWarps * 32, smem);
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
  shape[0] = static_cast<long long>(sms) * per_sm;
  shape[1] = warps;
  return static_cast<int>(cudaSuccess);
}

// args: a GroupArgs (void here, so the entry keeps external linkage).
// ids: (n,) int32; vals: (n,) int32 (is_float 0) or f32 (is_float 1); n
// >= 0; blocks: 1 up to group_sum_shape's resident blocks, warps its
// warps; partials: blocks x n_groups of scratch (f64 for f32 values,
// uint32 for int32), null when blocks is 1; out: (n_groups,) of vals'
// type, written whole, or null with acc: the running (n_groups,) grid
// (f64 for f32 values, int32 for int32) the sums are added to.  One
// cooperative launch on `stream`, no other call; does not synchronise,
// returns the launch's error.
extern "C" int group_sum_launch(const void* args, void* stream) {
  const GroupArgs& a = *static_cast<const GroupArgs*>(args);
  if (a.n < 0 || a.n_groups < 1 || a.blocks < 1 ||
      a.blocks > 2147483647LL || (a.blocks > 1 && a.partials == nullptr) ||
      (a.out == nullptr) == (a.acc == nullptr) ||
      (a.is_float && (a.warps < 1 || a.warps > kMaxWarps)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = a.ids;
  long long n = a.n;
  int n_groups = a.n_groups;
  const dim3 grid(static_cast<unsigned>(a.blocks));
  const size_t smem = grid_bytes(n_groups, a.is_float, a.warps);
  if (a.is_float) {
    const float* vals = static_cast<const float*>(a.vals);
    double* partials = static_cast<double*>(a.partials);
    float* out = static_cast<float*>(a.out);
    double* acc = static_cast<double*>(a.acc);
    int grid_warps = a.warps;
    void* params[] = {&ids,        &vals,     &n,   &n_groups,
                      &grid_warps, &partials, &out, &acc};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(group_sum_f32), grid,
        dim3(kBlockWarps * 32), params, smem, s));
  }
  const int* vals = static_cast<const int*>(a.vals);
  unsigned* partials = static_cast<unsigned*>(a.partials);
  unsigned* out = static_cast<unsigned*>(a.out);
  unsigned* acc = static_cast<unsigned*>(a.acc);
  void* params[] = {&ids, &vals, &n, &n_groups, &partials, &out, &acc};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(group_sum_i32), grid, dim3(kThreads),
      params, smem, s));
}

namespace {

// reduce_sum: 16-byte loads a thread in flight, threads a block and
// blocks an SM (on an H100, 2 blocks of 1,024 threads an SM ran 1.5-2 %
// faster than 8 of 256 at 2^28 rows)
constexpr int kSumLoads = 4;
constexpr int kSumBlock = 1024;
constexpr int kSumBlocksPerSm = 2;

__device__ __forceinline__ unsigned long long add4(int4 v) {
  return static_cast<unsigned long long>(static_cast<long long>(v.x) + v.y +
                                         v.z + v.w);
}

__device__ __forceinline__ double add4(float4 v) {
  return ((static_cast<double>(v.x) + v.y) + v.z) + v.w;
}

// The whole sum of x in one launch: each block sums its rows (the 16-byte
// vectors first when `vec`, x being 16-byte aligned, kSumLoads a thread in
// flight over a grid-strided walk; then the ragged rows), and the block
// that finishes last adds the blocks' partials and writes out
// (reduce.cuh's finish_by_last_block).
template <typename T, typename T4, typename Acc, typename Out>
__global__ void __launch_bounds__(kSumBlock, kSumBlocksPerSm)
reduce_sum_kernel(const T* __restrict__ x, long long n, int vec,
                  Acc* partials, unsigned* ticket, Out* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kSumBlock;
  const long long n4 = vec ? n / 4 : 0;
  const T4* x4 = reinterpret_cast<const T4*>(x);
  Acc s = Acc(0);
  long long i = static_cast<long long>(blockIdx.x) * kSumBlock +
                threadIdx.x;
  for (; i + (kSumLoads - 1) * stride < n4; i += kSumLoads * stride) {
    T4 v[kSumLoads];
#pragma unroll
    for (int k = 0; k < kSumLoads; ++k) v[k] = __ldg(x4 + i + k * stride);
#pragma unroll
    for (int k = 0; k < kSumLoads; ++k) s += add4(v[k]);
  }
  for (; i < n4; i += stride) s += add4(__ldg(x4 + i));
  for (long long r = 4 * n4 + static_cast<long long>(blockIdx.x) *
                                  kSumBlock + threadIdx.x;
       r < n; r += stride)
    s += static_cast<Acc>(__ldg(x + r));
  finish_by_last_block(block_total(s), partials, ticket, out);
}

}  // namespace

// Blocks of reduce_sum's kernel resident on the card (its grid is the rows
// over 4 * kSumBlock, up to this).
extern "C" int reduce_sum_shape(int is_float, long long* resident) {
  if (is_float)
    return resident_blocks(reduce_sum_kernel<float, float4, double, float>,
                           resident, kSumBlock);
  return resident_blocks(
      reduce_sum_kernel<int, int4, unsigned long long, int>, resident,
      kSumBlock);
}

// x: (n,) int32 (is_float 0) or f32; scratch: blocks + 1 8-byte words,
// a partial a block (int64 or f64) and then the ticket, cleared here; out:
// one int32 or f32, written whole.  One memset and one kernel on `stream`; does not
// synchronise, returns cudaGetLastError().
extern "C" int reduce_sum_launch(const void* x, long long n, int is_float,
                                 long long blocks, void* scratch, void* out,
                                 void* stream) {
  if (n <= 0 || blocks < 1 || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ticket = reinterpret_cast<unsigned*>(
      static_cast<long long*>(scratch) + blocks);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<std::uintptr_t>(x) & 15u) == 0u;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (is_float) {
    reduce_sum_kernel<float, float4, double, float>
        <<<grid, kSumBlock, 0, s>>>(
            static_cast<const float*>(x), n, vec,
            static_cast<double*>(scratch), ticket, static_cast<float*>(out));
  } else {
    reduce_sum_kernel<int, int4, unsigned long long, int>
        <<<grid, kSumBlock, 0, s>>>(
            static_cast<const int*>(x), n, vec,
            static_cast<unsigned long long*>(scratch), ticket,
            static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
