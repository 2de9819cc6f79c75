// Bit-unpack for Hopper (sm_90a): packed int32 words at `phys` bits per
// value -> the first n int32 values, plus a frame of reference.
//
// Replaces the Pallas TPU kernel src/repro/kernels/unpack.py::unpack
// (_unpack_kernel): one grid step per tile of decoded values, decoded in
// VMEM.  The layout is packed.cuh's (src/repro_torch/sql/storage.py).
//
// What bounds it: device-memory bytes at 3.35 TB/s — the words read once
// (phys / 8 bytes a value) and the values written once (4 bytes a value).
// The shift, mask and add are 3 integer operations a value, far below
// the int32 rate.
//
// Design: one thread per word, the simplest form that reads each word
// once.  The thread writes its c = 32 / phys values to c neighbouring
// ints; a warp's stores of one step are c ints apart, and the c steps
// together fill the warp's 128 * c contiguous bytes, which the L2 merges
// before they go to device memory.  A grid-stride loop covers any n; the
// last word's padding lanes (rows >= n) are not written.
#include <cuda_runtime.h>

#include "packed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const unsigned* __restrict__ words, long long n_words,
              long long n, int phys, int lg, unsigned mask, unsigned ref,
              int* __restrict__ out) {
  const int c = 1 << lg;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       w < n_words; w += stride) {
    const unsigned word = __ldg(words + w);
    const long long base = w << lg;
    for (int k = 0; k < c && base + k < n; ++k) {
      // an unsigned add wraps as the reference's int32 add
      out[base + k] = static_cast<int>(((word >> (k * phys)) & mask) + ref);
    }
  }
}

}  // namespace

// words: (n_words,) int32 on the device; out: (n,) int32, 0 < n <=
// n_words * (32 / phys).  Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int unpack_launch(const void* words, long long n_words,
                             long long n, int phys, int ref, void* out,
                             void* stream) {
  const int lg = lanes_log2(phys);
  if (lg < 0 || n <= 0 || n > (n_words << lg))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long live_words = (n + (1LL << lg) - 1) >> lg;
  long long grid = (live_words + kThreads - 1) / kThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  unpack_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), live_words, n, phys, lg,
      lane_mask(phys), static_cast<unsigned>(ref), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
