// Fused mean-field PSO update (the consensus swarm of core/meanfield.py):
//   d  = x̄ − x
//   v' = w·v + λ·d + σ·s(d) ⊙ ξ,   s(d) = ‖d‖₂ per row (isotropic)
//                                   s(d) = d         (anisotropic)
//   x' = x + v'
// over an (N, D) swarm, with the consensus point x̄ (D,) broadcast across
// rows and ξ the pre-drawn standard-normal noise. x̄ itself is a
// cross-particle reduction and stays outside the kernel.
//
// Replaces: src/repro/kernels/meanfield_step.py meanfield_step_pallas
// (:51, body _meanfield_kernel :34), which updates 256-particle tiles in
// VMEM.
//
// Bound on the H100: bytes. x, v and ξ are read once and x', v' written
// once, 20 bytes an element, for about eight flops an element.
//
// Design:
//   anisotropic — one thread per element on a grid-stride loop, so
//     neighbouring threads touch neighbouring addresses of every array;
//     x̄ is indexed by the column and stays in L1/L2;
//   isotropic — a group of G lanes per row, G the smallest power of two
//     ≥ D up to a full warp, so a narrow row does not idle most of a warp.
//     The group strides over the row twice: first for Σ d², reduced by a
//     butterfly within the group, then for the outputs (x and x̄ are read
//     again from L1).
// The expressions keep the reference's association and the file is built
// with -fmad=false, so the anisotropic result matches the plain PyTorch
// version bit for bit, and the isotropic one up to the order of its row
// sum. One template serves float32 and float64 (meanfield_step_launch_f64):
// the double instantiation takes w, λ and σ as doubles and the row norm's
// square root in double (objective.cuh's Real<T>), as the reference's x64
// swarm does.
#include "objective.cuh"

namespace {

using repro::group_sum;
using repro::kWarp;

constexpr int kThreads = 256;

template <typename T>
__global__ void meanfield_anisotropic_kernel(
    const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ xbar,
    const T* __restrict__ xi, T w, T drift, T sigma, T* __restrict__ x_out,
    T* __restrict__ v_out, long long n, int D) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T xi_ = x[i];
    const T d = xbar[i % D] - xi_;
    const T vn = w * v[i] + drift * d + sigma * d * xi[i];
    v_out[i] = vn;
    x_out[i] = xi_ + vn;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) meanfield_isotropic_kernel(
    const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ xbar,
    const T* __restrict__ xi, T w, T drift, T sigma, T* __restrict__ x_out,
    T* __restrict__ v_out, long long N, int D, int G) {
  const int rows_per_block = kThreads / G;
  const int g = threadIdx.x % G;
  const long long row =
      static_cast<long long>(blockIdx.x) * rows_per_block + threadIdx.x / G;
  // rows past N still join the shuffles, with nothing to add
  const bool live = row < N;
  const long long base = row * D;
  T acc = T(0);
  if (live) {
    for (int j = g; j < D; j += G) {
      const T d = xbar[j] - x[base + j];
      acc += d * d;
    }
  }
  const T scale = sigma * repro::Real<T>::sqrt(group_sum(acc, G));
  if (!live) return;
  for (int j = g; j < D; j += G) {
    const long long i = base + j;
    const T xv = x[i];
    const T d = xbar[j] - xv;
    const T vn = w * v[i] + drift * d + scale * xi[i];
    v_out[i] = vn;
    x_out[i] = xv + vn;
  }
}

template <typename T>
int launch(const T* x, const T* v, const T* xbar, const T* xi, T w, T drift, T sigma,
           int isotropic, T* x_out, T* v_out, int N, int D, cudaStream_t stream) {
  const long long n = static_cast<long long>(N) * D;
  if (n <= 0) return 0;
  if (isotropic) {
    int G = 1;
    while (G < D && G < kWarp) G <<= 1;
    const int rows_per_block = kThreads / G;
    const long long blocks = (static_cast<long long>(N) + rows_per_block - 1) / rows_per_block;
    meanfield_isotropic_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, v, xbar, xi, w, drift, sigma, x_out, v_out, N, D, G);
  } else {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond ~64 blocks per SM
    meanfield_anisotropic_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, v, xbar, xi, w, drift, sigma, x_out, v_out, n, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/v/xi (N, D), xbar (D,) -> x_out, v_out (N, D); float32, contiguous.
// isotropic != 0 selects the row-norm envelope.
extern "C" int meanfield_step_launch(const float* x, const float* v, const float* xbar,
                                     const float* xi, float w, float drift, float sigma,
                                     int isotropic, float* x_out, float* v_out, int N,
                                     int D, cudaStream_t stream) {
  return launch<float>(x, v, xbar, xi, w, drift, sigma, isotropic, x_out, v_out, N, D,
                       stream);
}

// The same in float64, with w, drift and sigma as doubles.
extern "C" int meanfield_step_launch_f64(const double* x, const double* v,
                                         const double* xbar, const double* xi, double w,
                                         double drift, double sigma, int isotropic,
                                         double* x_out, double* v_out, int N, int D,
                                         cudaStream_t stream) {
  return launch<double>(x, v, xbar, xi, w, drift, sigma, isotropic, x_out, v_out, N, D,
                        stream);
}
