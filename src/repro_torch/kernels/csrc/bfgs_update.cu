// BFGS inverse-Hessian update in the ρ-form, per lane:
//   u = H δg,  s = δgᵀu,
//   H' = H − ρ(u δxᵀ + δx uᵀ) + (ρ²s + ρ) δx δxᵀ,
// in three instantiations of one kernel:
//   guarded    — ρ given per lane, and p' = −H' g' as well. With ρ = 0 and
//                zeroed δx, δg every update term is an exact zero, so
//                H' = H bit for bit: the batched sweep's curvature guard
//                and its frozen lanes rely on that;
//   update     — ρ = 1/(δxᵀδg) reduced inside the block, H' only;
//   update_dir — the same ρ, H' and p' = −H' g'.
// The last two divide unguarded, as the TPU kernels do: their callers feed
// them curvature-safe pairs or the engine's stand-in pair (1, …, 1).
//
// Replaces: src/repro/kernels/bfgs_update.py
// guarded_update_direction_pallas (:150), bfgs_update_pallas (:110) and
// update_direction_pallas (:127), which keep one lane's (D, D) H resident
// in VMEM for the whole update.
//
// Bound on the H100: bytes. H is read and H' written once, 8·D² bytes a
// lane, for about 12·D² flops.
//
// Design: one block per lane, eight warps, running the block-level passes
// of update.cuh (which the sweep megakernel runs too). A block cannot hold
// a large lane's H in its 227 KB of shared memory (fp32 H fits only up to
// D ≈ 220), so H streams from device memory twice:
//   read 1: each warp takes rows i of H and forms u_i = H[i, :]·δg;
//           warp 0 then forms s = δg·u (and, unguarded, warp 1 the
//           curvature δx·δg);
//   read 2: each warp re-reads row i, writes the H' row (it needs only
//           u, δx, ρ and s) and, with a direction, reduces that row's
//           p'_i = −H'[i, :]·g'.
// δx, δg, g' and u live in dynamic shared memory (16·D bytes). The block
// reads all of its lane before it writes, so the output may alias H (an
// in-place update); the wrappers allocate a fresh H' all the same.
#include "update.cuh"

namespace {

using repro::kWarp;

constexpr int kWarps = 8;

enum Mode : int { kGuarded = 0, kUpdate = 1, kUpdateDirection = 2 };

template <int MODE>
__global__ void __launch_bounds__(kWarps * kWarp)
bfgs_update_kernel(const float* H, const float* __restrict__ dx,
                   const float* __restrict__ dg, const float* __restrict__ g_new,
                   const float* __restrict__ rho_in, float* H_out,
                   float* __restrict__ p_out, int D) {
  constexpr bool kDirection = MODE != kUpdate;
  extern __shared__ float smem[];
  float* sdx = smem;
  float* sdg = sdx + D;
  float* sgn = sdg + D;
  float* su = sgn + D;
  __shared__ float s_dot;
  __shared__ float s_curv;

  const long long b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const float* Hb = H + b * D * D;

  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    sdx[j] = dx[b * D + j];
    sdg[j] = dg[b * D + j];
    if (kDirection) sgn[j] = g_new[b * D + j];
  }
  __syncthreads();

  // read 1: u = H δg
  repro::block_hdg(Hb, sdg, su, D, warp, lane, kWarps);
  __syncthreads();

  if (warp == 0) {
    const float s = repro::warp_dot(sdg, su, D, lane);
    if (lane == 0) s_dot = s;
  } else if (MODE != kGuarded && warp == 1) {
    const float c = repro::warp_dot(sdx, sdg, D, lane);
    if (lane == 0) s_curv = c;
  }
  __syncthreads();

  const float rho = MODE == kGuarded ? rho_in[b] : 1.0f / s_curv;
  const float coef = rho * rho * s_dot + rho;

  // read 2: H' rows (and p' = −H' g')
  repro::block_update_rows<kDirection>(Hb, H_out + b * D * D, su, sdx, sgn, rho, coef,
                                       kDirection ? p_out + b * D : nullptr, D, warp,
                                       lane, kWarps);
}

template <int MODE>
int launch(const float* H, const float* dx, const float* dg, const float* g_new,
           const float* rho, float* H_out, float* p_out, int B, int D,
           cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bfgs_update_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bfgs_update_kernel<MODE><<<B, kWarps * kWarp, smem, stream>>>(
      H, dx, dg, g_new, rho, H_out, p_out, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All take H (B, D, D) and dx/dg (B, D); float32, contiguous.
// Guarded: g_new (B, D), rho (B,) -> H_out (B, D, D), p_out (B, D).
extern "C" int guarded_update_direction_launch(const float* H, const float* dx,
                                               const float* dg, const float* g_new,
                                               const float* rho, float* H_out,
                                               float* p_out, int B, int D,
                                               cudaStream_t stream) {
  return launch<kGuarded>(H, dx, dg, g_new, rho, H_out, p_out, B, D, stream);
}

// Unguarded, ρ = 1/(δxᵀδg) per lane -> H_out (B, D, D).
extern "C" int bfgs_update_launch(const float* H, const float* dx, const float* dg,
                                  float* H_out, int B, int D, cudaStream_t stream) {
  return launch<kUpdate>(H, dx, dg, nullptr, nullptr, H_out, nullptr, B, D, stream);
}

// Unguarded, with g_new (B, D) -> H_out (B, D, D), p_out (B, D).
extern "C" int update_direction_launch(const float* H, const float* dx, const float* dg,
                                       const float* g_new, float* H_out, float* p_out,
                                       int B, int D, cudaStream_t stream) {
  return launch<kUpdateDirection>(H, dx, dg, g_new, nullptr, H_out, p_out, B, D,
                                  stream);
}
