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
// Design: one warp per row, eight rows per block. The lanes stride over
// D with coalesced loads, each keeps a partial sum in a register, and a
// butterfly shuffle (common.cuh) finishes the row. No shared memory and
// no cross-block state, so any N and D launch the same way.
//
// Exactness: the value-only instantiation (WITH_GRAD = false) must return
// f bitwise equal to the value+grad instantiation, because the Armijo test
// compares ladder values from one against F0 from the other. Both run the
// same row_value() code, the same reduction order, and the file is built
// with -fmad=false so the compiler cannot contract a multiply-add into an
// FMA in one instantiation and not the other. The transcendentals are the
// accurate cosf/sinf/expf/sqrtf (no fast-math intrinsics). Ackley keeps
// its 0/0 = NaN gradient at the origin, as the reference does.
#include "common.cuh"

namespace {

using repro::kWarp;
using repro::warp_sum;

enum Objective : int { kSphere = 0, kRastrigin = 1, kRosenbrock = 2, kAckley = 3 };

constexpr int kWarpsPerBlock = 8;
constexpr float kTwoPi = 6.283185307179586f;  // float32(2π), as jnp rounds it
constexpr float kE = 2.718281828459045f;

// Row value. The partial sums and their reduction are the same code in both
// instantiations; the ackley path also returns the two reductions its
// gradient pass needs.
template <int OBJ>
__device__ __forceinline__ float row_value(const float* __restrict__ xr, int D,
                                           int lane, float* e1_out, float* s1_out,
                                           float* e2_out) {
  if (OBJ == kSphere) {
    float acc = 0.0f;
    for (int j = lane; j < D; j += kWarp) {
      const float xj = xr[j];
      acc += xj * xj;
    }
    return warp_sum(acc);
  } else if (OBJ == kRastrigin) {
    float acc = 0.0f;
    for (int j = lane; j < D; j += kWarp) {
      const float xj = xr[j];
      acc += xj * xj - 10.0f * cosf(kTwoPi * xj);
    }
    const float aD = static_cast<float>(10.0 * static_cast<double>(D));
    return aD + warp_sum(acc);
  } else if (OBJ == kRosenbrock) {
    float acc = 0.0f;
    for (int j = lane; j < D - 1; j += kWarp) {
      const float xi = xr[j];
      const float d = xr[j + 1] - xi * xi;
      const float t = 1.0f - xi;
      acc += t * t + 100.0f * d * d;
    }
    return warp_sum(acc);
  } else {  // kAckley
    float acc_sq = 0.0f, acc_cos = 0.0f;
    for (int j = lane; j < D; j += kWarp) {
      const float xj = xr[j];
      acc_sq += xj * xj;
      acc_cos += cosf(kTwoPi * xj);
    }
    const float fd = static_cast<float>(D);
    const float s1 = sqrtf(warp_sum(acc_sq) / fd);
    const float s2 = warp_sum(acc_cos) / fd;
    const float e1 = expf(-0.2f * s1);
    const float e2 = expf(s2);
    *e1_out = e1;
    *s1_out = s1;
    *e2_out = e2;
    return -20.0f * e1 - e2 + kE + 20.0f;
  }
}

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
  const float fv = row_value<OBJ>(xr, D, lane, &e1, &s1, &e2);
  if (lane == 0) f[row] = fv;
  if (!WITH_GRAD) return;

  float* gr = g + row * D;
  if (OBJ == kSphere) {
    for (int j = lane; j < D; j += kWarp) gr[j] = 2.0f * xr[j];
  } else if (OBJ == kRastrigin) {
    // 2πa as jnp rounds the Python constant: float32(62.83185307179586)
    const float two_pi_a = 62.83185307179586f;
    for (int j = lane; j < D; j += kWarp) {
      const float xj = xr[j];
      gr[j] = 2.0f * xj + two_pi_a * sinf(kTwoPi * xj);
    }
  } else if (OBJ == kRosenbrock) {
    // g_j = [j < D-1](-2(1 - x_j) - 400 x_j d_j) + [j > 0] 200 d_{j-1},
    // with d_j = x_{j+1} - x_j², each term added to a zero start as the
    // reference's two scatter-adds do
    for (int j = lane; j < D; j += kWarp) {
      const float xj = xr[j];
      float gj = 0.0f;
      if (j < D - 1) {
        const float d = xr[j + 1] - xj * xj;
        gj = gj + (-2.0f * (1.0f - xj) - 400.0f * xj * d);
      }
      if (j > 0) {
        const float xp = xr[j - 1];
        const float dp = xj - xp * xp;
        gj = gj + 200.0f * dp;
      }
      gr[j] = gj;
    }
  } else {  // kAckley
    const float fd = static_cast<float>(D);
    const float c1 = 4.0f * e1 / (fd * s1);  // inf at the origin: 0·inf = NaN
    const float c2 = static_cast<float>(6.283185307179586 / static_cast<double>(D));
    for (int j = lane; j < D; j += kWarp) {
      const float xj = xr[j];
      gr[j] = c1 * xj + (c2 * sinf(kTwoPi * xj)) * e2;
    }
  }
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
