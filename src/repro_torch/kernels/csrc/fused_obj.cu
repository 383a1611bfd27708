// Fused objective value and value+gradient for sphere, rastrigin,
// rosenbrock and ackley, row-wise over an (N, D) batch.
//
// Replaces: src/repro/kernels/fused_obj.py fused_value_pallas (:119) and
// fused_value_grad_pallas (:140), which evaluate 256-row tiles in VMEM.
//
// Bound on the H100: bytes. Each row reads D floats and writes 1 (value)
// or 1 + D (value+grad); the arithmetic per element is a handful of
// multiply-adds plus at most one cosf and one sinf, far below the card's
// 67 TFLOP/s fp32 rate at 3.35 TB/s.
//
// Design: one warp per row, eight rows per block. The row value and the
// row gradient are objective.cuh's row_value and grad_row, which the sweep
// megakernel (sweep_megakernel.cu) runs too: the lanes stride over D with
// coalesced loads and a butterfly shuffle finishes the row. No shared
// memory and no cross-block state, so any N and D launch the same way.
//
// Exactness: the value-only instantiation (WITH_GRAD = false) must return
// f bitwise equal to the value+grad instantiation, because the Armijo test
// compares ladder values from one against F0 from the other. Both run the
// same row_value() code, the same reduction order, and the file is built
// with -fmad=false so the compiler cannot contract a multiply-add into an
// FMA in one instantiation and not the other.
#include "objective.cuh"

namespace {

using repro::kAckley;
using repro::kRastrigin;
using repro::kRosenbrock;
using repro::kSphere;
using repro::kWarp;

constexpr int kWarpsPerBlock = 8;

template <int OBJ, bool WITH_GRAD>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
fused_obj_kernel(const float* __restrict__ x, float* __restrict__ f,
                 float* __restrict__ g, int N, int D) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= N) return;  // whole warp leaves together: row is warp-uniform
  const float* xr = x + row * D;

  float e1 = 0.0f, s1 = 0.0f, e2 = 0.0f;
  const float fv = repro::row_value<OBJ>(xr, D, lane, &e1, &s1, &e2);
  if (lane == 0) f[row] = fv;
  if (!WITH_GRAD) return;

  repro::grad_row<OBJ>(xr, g + row * D, D, lane, kWarp, e1, s1, e2);
}

template <int OBJ>
void launch_obj(bool with_grad, const float* x, float* f, float* g, int N, int D,
                cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * kWarp);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (with_grad) {
    fused_obj_kernel<OBJ, true><<<grid, block, 0, stream>>>(x, f, g, N, D);
  } else {
    fused_obj_kernel<OBJ, false><<<grid, block, 0, stream>>>(x, f, g, N, D);
  }
}

}  // namespace

// x (N, D) -> f (N,) and, when with_grad, g (N, D); all float32, contiguous.
extern "C" int fused_obj_launch(int objective, int with_grad, const float* x,
                                float* f, float* g, int N, int D,
                                cudaStream_t stream) {
  if (N <= 0) return 0;
  switch (objective) {
    case kSphere: launch_obj<kSphere>(with_grad != 0, x, f, g, N, D, stream); break;
    case kRastrigin: launch_obj<kRastrigin>(with_grad != 0, x, f, g, N, D, stream); break;
    case kRosenbrock: launch_obj<kRosenbrock>(with_grad != 0, x, f, g, N, D, stream); break;
    case kAckley: launch_obj<kAckley>(with_grad != 0, x, f, g, N, D, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
