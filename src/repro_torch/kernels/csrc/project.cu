// Projection for Hopper (sm_90a): y = a*x1 + b*x2, optionally
// sigmoid(y), in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/project.py::project
// (_project_kernel), the paper's Q1/Q2 (§4.1).
//
// What bounds it: device-memory bytes at 3.35 TB/s — two f32 reads and
// one f32 write a row (12n bytes); three flops a row (more with the
// sigmoid) are far below the card's f32 rate.  Each thread takes four
// neighbouring rows, one 16-byte load (float4) of each input and one
// store, and the grid covers the rows once, as torch's own elementwise
// kernels do: a grid-stride loop over the resident blocks kept fewer
// blocks in flight and ran 5 % behind torch.sub at 2^28 rows.  When a
// pointer is not 16-byte aligned, and at the ragged end, a thread takes
// its four rows one at a time.  At the opat pass's sizes (a few hundred
// thousand rows) a call is its fixed cost, so the launch asks the runtime
// nothing and takes its arguments by one pointer.
//
// Rounding: nvcc would contract a*x1 + b*x2 into one FMA, one rounding
// where the plain version has three.  __fmul_rn and __fadd_rn are never
// contracted, so the kernel gives the plain version's bits.  The sigmoid
// uses expf (not __expf) and an IEEE division.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;            // rows a thread: one float4 of each

// project_launch's arguments, passed by one pointer: a ctypes call pays
// for each argument it converts, and at the opat pass's sizes that fixed
// cost is the call's time.
struct ProjectArgs {
  const float* x1;
  const float* x2;
  float* out;
  long long n;
  float a;
  float b;
  int sigmoid;
};

__device__ __forceinline__ float affine(float a, float x1, float b, float x2,
                                        bool sigmoid) {
  const float y = __fadd_rn(__fmul_rn(a, x1), __fmul_rn(b, x2));
  return sigmoid ? 1.0f / (1.0f + expf(-y)) : y;
}

__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
               float* __restrict__ out, long long n, float a, float b,
               bool sigmoid, bool vector) {
  const long long step = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  const long long row = kRows * step;
  if (vector && row + kRows <= n) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(x1) + step);
    const float4 q = __ldg(reinterpret_cast<const float4*>(x2) + step);
    reinterpret_cast<float4*>(out)[step] =
        make_float4(affine(a, p.x, b, q.x, sigmoid),
                    affine(a, p.y, b, q.y, sigmoid),
                    affine(a, p.z, b, q.z, sigmoid),
                    affine(a, p.w, b, q.w, sigmoid));
    return;
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    if (row + k < n)
      out[row + k] = affine(a, __ldg(x1 + row + k), b, __ldg(x2 + row + k),
                            sigmoid);
}

}  // namespace

// args: a ProjectArgs (void here, so the entry keeps external linkage):
// x1, x2, out (n,) f32 device arrays, n > 0.  Asks the runtime nothing
// but the launch.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int project_launch(const void* args, void* stream) {
  const ProjectArgs& p = *static_cast<const ProjectArgs*>(args);
  if (p.n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vector =
      ((reinterpret_cast<std::uintptr_t>(p.x1) |
        reinterpret_cast<std::uintptr_t>(p.x2) |
        reinterpret_cast<std::uintptr_t>(p.out)) & 15u) == 0u;
  const long long per_block = static_cast<long long>(kThreads) * kRows;
  project_kernel<<<static_cast<unsigned>((p.n + per_block - 1) / per_block),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p.x1, p.x2, p.out, p.n, p.a, p.b, p.sigmoid != 0, vector);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
