// Projection for Hopper (sm_90a): y = a*x1 + b*x2, optionally
// sigmoid(y), in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/project.py::project
// (_project_kernel), the paper's Q1/Q2 (§4.1).
//
// What bounds it: device-memory bytes at 3.35 TB/s — two f32 reads and
// one f32 write a row (12n bytes); three flops a row (more with the
// sigmoid) are far below the card's f32 rate.  Each thread moves 16 bytes
// a load (float4) in a grid-stride loop, neighbouring threads on
// neighbouring addresses; a scalar loop takes the ragged tail, and all of
// it when a pointer is not 16-byte aligned.
//
// Rounding: nvcc would contract a*x1 + b*x2 into one FMA, one rounding
// where the plain version has three.  __fmul_rn and __fadd_rn are never
// contracted, so the kernel gives the plain version's bits.  The sigmoid
// uses expf (not __expf) and an IEEE division.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float affine(float a, float x1, float b, float x2,
                                        bool sigmoid) {
  const float y = __fadd_rn(__fmul_rn(a, x1), __fmul_rn(b, x2));
  return sigmoid ? 1.0f / (1.0f + expf(-y)) : y;
}

__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
               float* __restrict__ out, long long n, float a, float b,
               bool sigmoid, bool vector) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  long long done = 0;
  if (vector) {
    const long long n4 = n / 4;
    const float4* v1 = reinterpret_cast<const float4*>(x1);
    const float4* v2 = reinterpret_cast<const float4*>(x2);
    float4* vo = reinterpret_cast<float4*>(out);
    for (long long i = first; i < n4; i += stride) {
      const float4 p = __ldg(v1 + i);
      const float4 q = __ldg(v2 + i);
      vo[i] = make_float4(affine(a, p.x, b, q.x, sigmoid),
                          affine(a, p.y, b, q.y, sigmoid),
                          affine(a, p.z, b, q.z, sigmoid),
                          affine(a, p.w, b, q.w, sigmoid));
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = affine(a, __ldg(x1 + i), b, __ldg(x2 + i), sigmoid);
}

}  // namespace

// x1, x2, out: (n,) f32 device arrays, n > 0.  Launches on `stream`, does
// not synchronise, returns cudaGetLastError().
extern "C" int project_launch(const void* x1, const void* x2, void* out,
                              long long n, float a, float b, int sigmoid,
                              void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, project_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vector =
      ((reinterpret_cast<std::uintptr_t>(x1) |
        reinterpret_cast<std::uintptr_t>(x2) |
        reinterpret_cast<std::uintptr_t>(out)) & 15u) == 0u;
  const long long per_block = static_cast<long long>(kThreads) * 4;
  long long grid = (n + per_block - 1) / per_block;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (grid > resident) grid = resident;
  project_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<float*>(out), n, a, b, sigmoid != 0, vector);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
