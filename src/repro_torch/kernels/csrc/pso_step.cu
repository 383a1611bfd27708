// Fused PSO velocity and position update (paper Alg. 9 lines 9-10):
//   v' = w·v + c1·r1⊙(px − x) + c2·r2⊙(gx − x),   x' = x + v'
// over an (N, D) swarm with the global best gx (D,) broadcast across rows.
//
// Replaces: src/repro/kernels/pso_step.py pso_step_pallas (:34), which
// updates 256-particle tiles in VMEM.
//
// Bound on the H100: bytes. Five (N, D) inputs are read once and two
// written once, with about ten flops per element.
//
// Design: one thread per element on a grid-stride loop, so neighbouring
// threads touch neighbouring addresses of every array; gx is indexed by
// the column and stays in L1/L2. The expression keeps the reference's
// association, and the file is built with -fmad=false, so the result
// matches the plain PyTorch version bit for bit.
#include "common.cuh"

namespace {

__global__ void pso_step_kernel(const float* __restrict__ x, const float* __restrict__ v,
                                const float* __restrict__ px, const float* __restrict__ gx,
                                const float* __restrict__ r1, const float* __restrict__ r2,
                                float w, float c1, float c2, float* __restrict__ x_out,
                                float* __restrict__ v_out, long long n, int D) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xi = x[i];
    const float vn = w * v[i] + c1 * r1[i] * (px[i] - xi) + c2 * r2[i] * (gx[i % D] - xi);
    v_out[i] = vn;
    x_out[i] = xi + vn;
  }
}

}  // namespace

// x/v/px/r1/r2 (N, D), gx (D,) -> x_out, v_out (N, D); float32, contiguous.
extern "C" int pso_step_launch(const float* x, const float* v, const float* px,
                               const float* gx, const float* r1, const float* r2, float w,
                               float c1, float c2, float* x_out, float* v_out, int N, int D,
                               cudaStream_t stream) {
  const long long n = static_cast<long long>(N) * D;
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond ~64 blocks per SM
  pso_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, v, px, gx, r1, r2, w, c1, c2, x_out, v_out, n, D);
  return static_cast<int>(cudaGetLastError());
}
