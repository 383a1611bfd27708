// Shared helpers of the port's Hopper kernels.
//
// Every kernel source is compiled on its own into a shared library with a
// plain C interface (kernels/_build.py): each entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so
// that the Python wrapper can raise when a launch is refused.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

// Butterfly sum over the 32 lanes of a warp. IEEE addition is commutative,
// so both lanes of every exchanged pair hold the same bits after each step:
// every lane ends with the identical sum, and the order of additions
// depends only on the lane layout, never on the batch size. T is float or
// double.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

// The same butterfly within aligned groups of `width` lanes (a power of two
// up to 32): every lane ends with its group's sum. All 32 lanes must call
// it, since the shuffles name the full warp.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int offset = width / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
