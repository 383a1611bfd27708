// Block-level passes of the ρ-form BFGS update, per lane,
//   u = H δg,  s = δgᵀu,
//   H' = H − ρ(u δxᵀ + δx uᵀ) + (ρ²s + ρ) δx δxᵀ,  p' = −H' g',
// shared by the kernels that update a lane's H: bfgs_update.cu (B2, B7a,
// B7b) and sweep_megakernel.cu (B5, B5b). One block per lane; the vectors
// (δx, δg, g', u) lie in shared memory. block_hdg (or block_hdg_rows, a
// range of rows at a time) takes H for u, block_update_rows takes it again
// for the H' rows (it needs only u, δx, ρ and s). The callers hand both
// passes a shared-memory copy of H where it fits, so that device memory is
// read once, and H in device memory above that, which is then read twice.
// Every pass is a template on the element type T (float or double), deduced
// from its arguments; the float instantiations are the float32 kernels'.
// bfgs_update.cu's warp-per-lane variant for small D shares updated_entry
// and the order of every row sum. Every caller runs this one code, so two
// kernels given the same inputs write the same bits.
#pragma once

#include "common.cuh"

namespace repro {

// Butterfly sums of R independent values, their shuffles interleaved; each
// value's sum is warp_sum's, bit for bit.
template <int R, typename T>
__device__ __forceinline__ void warp_sum_n(T (&v)[R]) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] += __shfl_xor_sync(kFullMask, v[r], offset);
  }
}

// su[i] = H[i, :]·sdg for the rows i in [i_begin, i_end), warp w taking
// rows i_begin + w, i_begin + w + nwarps, …, R of its rows at a time (their
// sums interleaved, each in the one-row order: lane j adds columns j,
// j + 32, …, then the butterfly).
template <int R = 1, typename T>
__device__ __forceinline__ void block_hdg_rows(const T* H, const T* sdg, T* su, int D,
                                               int i_begin, int i_end, int warp, int lane,
                                               int nwarps) {
  for (int i0 = i_begin + warp; i0 < i_end; i0 += R * nwarps) {
    const T* hr[R];
    T acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // a row past the range repeats its last, unstored
      hr[r] = H + static_cast<long long>(min(i0 + r * nwarps, i_end - 1)) * D;
      acc[r] = T(0);
    }
    for (int j = lane; j < D; j += kWarp) {
      const T d = sdg[j];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += hr[r][j] * d;
    }
    warp_sum_n<R>(acc);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r * nwarps < i_end) su[i0 + r * nwarps] = acc[r];
      }
    }
  }
}

// block_hdg_rows over every row of H.
template <int R = 1, typename T>
__device__ __forceinline__ void block_hdg(const T* H, const T* sdg, T* su, int D, int warp,
                                          int lane, int nwarps) {
  block_hdg_rows<R>(H, sdg, su, D, 0, D, warp, lane, nwarps);
}

// a·b over D, by one warp; every lane returns the sum.
template <typename T>
__device__ __forceinline__ T warp_dot(const T* a, const T* b, int D, int lane) {
  T acc = T(0);
  for (int j = lane; j < D; j += kWarp) acc += a[j] * b[j];
  return warp_sum(acc);
}

// One entry of H', (i, j): h − ρ(u_i δx_j + δx_i u_j) + coef·δx_i δx_j, in
// the order every variant of every kernel rounds it (built -fmad=false).
template <typename T>
__device__ __forceinline__ T updated_entry(T h, T ui, T dxi, T uj, T dxj, T rho, T coef) {
  return h - rho * (ui * dxj + dxi * uj) + coef * (dxi * dxj);
}

// The H' rows into O and, with DIRECTION, p'_i = −H'[i, :]·sgn into p_out,
// warp w taking rows w, w + nwarps, …, R of them at a time as block_hdg
// does. coef is ρ²s + ρ. O may alias H: each element is read before it is
// written, by the lane that writes it.
template <bool DIRECTION, int R = 1, typename T>
__device__ __forceinline__ void block_update_rows(const T* H, T* O, const T* su, const T* sdx,
                                                  const T* sgn, T rho, T coef, T* p_out,
                                                  int D, int warp, int lane, int nwarps) {
  for (int i0 = warp; i0 < D; i0 += R * nwarps) {
    const T* hr[R];
    T* orow[R];
    T ui[R], dxi[R], acc[R];
    bool store[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // a row past D repeats row D - 1, unstored
      const int i = i0 + r * nwarps;
      const int ic = min(i, D - 1);
      store[r] = i < D;
      hr[r] = H + static_cast<long long>(ic) * D;
      orow[r] = O + static_cast<long long>(ic) * D;
      ui[r] = su[ic];
      dxi[r] = sdx[ic];
      acc[r] = T(0);
    }
    for (int j = lane; j < D; j += kWarp) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T h = hr[r][j];
        const T hn = updated_entry(h, ui[r], dxi[r], su[j], sdx[j], rho, coef);
        if (store[r]) orow[r][j] = hn;
        if (DIRECTION) acc[r] += hn * sgn[j];
      }
    }
    if (DIRECTION) {
      warp_sum_n<R>(acc);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (store[r]) p_out[i0 + r * nwarps] = -acc[r];
        }
      }
    }
  }
}

}  // namespace repro
