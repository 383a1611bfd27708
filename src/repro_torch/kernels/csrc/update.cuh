// Block-level passes of the ρ-form BFGS update, per lane,
//   u = H δg,  s = δgᵀu,
//   H' = H − ρ(u δxᵀ + δx uᵀ) + (ρ²s + ρ) δx δxᵀ,  p' = −H' g',
// shared by the kernels that update a lane's H: bfgs_update.cu (B2, B7a,
// B7b) and sweep_megakernel.cu (B5, B5b). One block per lane; the vectors
// (δx, δg, g', u) lie in shared memory, and H streams from device memory
// twice: block_hdg reads it for u, block_update_rows again for the H' rows
// (it needs only u, δx, ρ and s). Every caller runs this one code, so two
// kernels given the same inputs write the same bits.
#pragma once

#include "common.cuh"

namespace repro {

// su[i] = H[i, :]·sdg for every row i, warp w taking rows w, w + nwarps, …
__device__ __forceinline__ void block_hdg(const float* H, const float* sdg,
                                          float* su, int D, int warp, int lane,
                                          int nwarps) {
  for (int i = warp; i < D; i += nwarps) {
    const float* hr = H + static_cast<long long>(i) * D;
    float acc = 0.0f;
    for (int j = lane; j < D; j += kWarp) acc += hr[j] * sdg[j];
    acc = warp_sum(acc);
    if (lane == 0) su[i] = acc;
  }
}

// a·b over D, by one warp; every lane returns the sum.
__device__ __forceinline__ float warp_dot(const float* a, const float* b, int D,
                                          int lane) {
  float acc = 0.0f;
  for (int j = lane; j < D; j += kWarp) acc += a[j] * b[j];
  return warp_sum(acc);
}

// The H' rows into O and, with DIRECTION, p'_i = −H'[i, :]·sgn into p_out,
// warp w taking rows w, w + nwarps, … coef is ρ²s + ρ. O may alias H: each
// row is read before it is written, by the warp that writes it.
template <bool DIRECTION>
__device__ __forceinline__ void block_update_rows(const float* H, float* O,
                                                  const float* su, const float* sdx,
                                                  const float* sgn, float rho,
                                                  float coef, float* p_out, int D,
                                                  int warp, int lane, int nwarps) {
  for (int i = warp; i < D; i += nwarps) {
    const float* hr = H + static_cast<long long>(i) * D;
    float* orow = O + static_cast<long long>(i) * D;
    const float ui = su[i];
    const float dxi = sdx[i];
    float acc = 0.0f;
    for (int j = lane; j < D; j += kWarp) {
      const float h = hr[j];
      const float hn = h - rho * (ui * sdx[j] + dxi * su[j]) + coef * (dxi * sdx[j]);
      orow[j] = hn;
      if (DIRECTION) acc += hn * sgn[j];
    }
    if (DIRECTION) {
      acc = warp_sum(acc);
      if (lane == 0) p_out[i] = -acc;
    }
  }
}

}  // namespace repro
