// Batched search direction p = −H·g (paper Alg. 4 line 10) for a stack of
// inverse Hessians H (B, D, D) and gradients g (B, D).
//
// Replaces: src/repro/kernels/direction.py direction_pallas (:29), which
// runs the lane-tiled matvec on the TPU's matrix unit.
//
// Bound on the H100: bytes. The B·D² floats of H are read once for 2·B·D²
// flops, one flop per two bytes; a matrix unit buys nothing here.
//
// Design: one warp per row (b, i), eight rows per block. The lanes read
// H[b, i, :] with consecutive addresses (coalesced 128-byte lines), the
// lane's slice of g[b, :] comes from L1, and a butterfly shuffle reduces
// the row. It does not call cuBLAS. One template serves float32 and float64
// (direction_launch_f64); the float64 kernel moves twice the bytes.
#include "common.cuh"

namespace {

using repro::kWarp;
using repro::warp_sum;

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
direction_kernel(const T* __restrict__ H, const T* __restrict__ g, T* __restrict__ p,
                 long long rows, int D) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const long long b = row / D;
  const T* hr = H + row * D;
  const T* gb = g + b * D;
  T acc = T(0);
  for (int j = lane; j < D; j += kWarp) acc += hr[j] * gb[j];
  acc = warp_sum(acc);
  if (lane == 0) p[row] = -acc;
}

template <typename T>
int launch(const T* H, const T* g, T* p, int B, int D, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * D;
  if (rows <= 0) return 0;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  direction_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * kWarp, 0, stream>>>(
      H, g, p, rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// H (B, D, D), g (B, D) -> p (B, D); float32, contiguous.
extern "C" int direction_launch(const float* H, const float* g, float* p, int B, int D,
                                cudaStream_t stream) {
  return launch<float>(H, g, p, B, D, stream);
}

// The same in float64: a warp a row with a double accumulator.
extern "C" int direction_launch_f64(const double* H, const double* g, double* p, int B, int D,
                                    cudaStream_t stream) {
  return launch<double>(H, g, p, B, D, stream);
}
