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
// the row. It does not call cuBLAS.
#include "common.cuh"

namespace {

using repro::kWarp;
using repro::warp_sum;

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
direction_kernel(const float* __restrict__ H, const float* __restrict__ g,
                 float* __restrict__ p, long long rows, int D) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const long long b = row / D;
  const float* hr = H + row * D;
  const float* gb = g + b * D;
  float acc = 0.0f;
  for (int j = lane; j < D; j += kWarp) acc += hr[j] * gb[j];
  acc = warp_sum(acc);
  if (lane == 0) p[row] = -acc;
}

}  // namespace

// H (B, D, D), g (B, D) -> p (B, D); float32, contiguous.
extern "C" int direction_launch(const float* H, const float* g, float* p, int B, int D,
                                cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * D;
  if (rows <= 0) return 0;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  direction_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * kWarp, 0, stream>>>(
      H, g, p, rows, D);
  return static_cast<int>(cudaGetLastError());
}
