// The sweep megakernel: one batched dense-BFGS sweep per lane in one launch.
//
// Replaces: src/repro/kernels/sweep_megakernel.py
//   sweep_megakernel_full_pallas (:188, body _full_sweep_kernel :122) — B5:
//     1. the K-rung trial fan x + α_k·p from the host ladder α (K,);
//     2. the trials' values with the fused objective's row body;
//     3. the first rung k with F_k <= rhs[k, b] against the precomputed
//        Armijo thresholds rhs (K, B), or K, with α = α_k, or the host
//        constant α_{K−1}·shrink on exhaustion;
//     4. the commit below;
//   sweep_megakernel_commit_pallas (:225, body _commit_kernel :165) — B5b:
//     4. alone, with α (B,) from the adaptive ladder: x' = x + α·p, f and
//        ∇f at x', the curvature δxᵀδg over the lane's D, the guard
//        ok = active ∧ finite ∧ > 1e-10, ρ = ok ? 1/δxᵀδg : 0 and the pairs
//        zeroed where not ok (selects, never a multiply by a mask: ackley's
//        gradient is NaN at the origin and failed lanes carry inf), then the
//        guarded ρ-form H' and p' = −H'g'.
//
// Bound on the H100: bytes. H is read and H' written once, 8·D² bytes a
// lane; the trial fan costs K·D objective terms a lane from shared memory
// and reads nothing more from device memory.
//
// Design: one block of eight warps per lane, as the update kernel has; a
// template flag leaves stages 1–3 out for B5b. The code that rounds is
// shared, not copied, so that each stage writes the bits of the staged
// kernel that it replaces:
//   - warp w takes rungs w, w + 8, …: it writes the trial row into its own
//     shared buffer, with the same two roundings as the staged ladder's
//     torch multiply and add (the file is built with -fmad=false), and runs
//     objective.cuh's row_value, the body of B1a with the same lane
//     striding, so each F_k is bitwise B1a's on the same trial row;
//   - the thresholds come in as the staged path computed them and are never
//     recomputed here, so the accept decisions are the staged ones;
//   - f' is row_value and g' grad_row at x' (B1b's bodies);
//   - the update is update.cuh's block_hdg and block_update_rows (B2's
//     passes), streaming H from device memory twice.
// The one reduction that is not the staged path's is δxᵀδg: the staged path
// takes it with torch.sum, here a warp sums it, so ρ, H' and p' may differ
// from the staged kernels' in the last bits; rung, α, x', f' and g' do not.
// Shared memory per block: x, p, g, x', g', δx, δg, u (8·D floats) and, for
// B5, eight trial rows (8·D) and the K trial values: (16·D + K)·4 bytes.
// ops.py derives the largest D that fits in the 227 KB a block may have.
#include "objective.cuh"
#include "update.cuh"

namespace {

using repro::kAckley;
using repro::kRastrigin;
using repro::kRosenbrock;
using repro::kSphere;
using repro::kWarp;

constexpr int kWarps = 8;
constexpr float kCurvEps = 1e-10f;  // engine._CURV_EPS

// One launch's arguments; the pointers of stages 1-3 (rhs, alphas,
// alpha_out, rung_out) are unused by B5b, alpha_in by B5.
struct SweepArgs {
  const float* x;
  const float* p;
  const float* g;
  const float* H;
  const unsigned char* active;
  const float* rhs;
  const float* alphas;
  float exhaust_alpha;
  const float* alpha_in;
  float* x_out;
  float* f_out;
  float* g_out;
  float* H_out;
  float* p_out;
  float* alpha_out;
  int* rung_out;
  int B, D, K;
};

template <int OBJ, bool FULL>
__global__ void __launch_bounds__(kWarps * kWarp) sweep_kernel(const SweepArgs a) {
  const int D = a.D;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sp = sx + D;
  float* sg = sp + D;
  float* sxn = sg + D;
  float* sgn = sxn + D;
  float* sdx = sgn + D;
  float* sdg = sdx + D;
  float* su = sdg + D;
  __shared__ float s_alpha, s_e1, s_s1, s_e2, s_curv, s_dot;

  const long long b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  for (int j = tid; j < D; j += nthreads) {
    sx[j] = a.x[b * D + j];
    sp[j] = a.p[b * D + j];
    sg[j] = a.g[b * D + j];
  }
  __syncthreads();

  if (FULL) {
    // stages 1-2: warp w evaluates rungs w, w + kWarps, … in its own row
    float* trial = su + D + warp * D;
    float* sF = su + D + kWarps * D;
    for (int k = warp; k < a.K; k += kWarps) {
      const float alpha_k = a.alphas[k];
      for (int j = lane; j < D; j += kWarp) trial[j] = sx[j] + alpha_k * sp[j];
      __syncwarp();
      float e1 = 0.0f, s1 = 0.0f, e2 = 0.0f;
      const float fk = repro::row_value<OBJ>(trial, D, lane, &e1, &s1, &e2);
      if (lane == 0) sF[k] = fk;
      __syncwarp();  // every lane has read the row before the next rung
    }
    __syncthreads();
    // stage 3: the first accepted rung (a NaN value or threshold accepts
    // nothing), K when none
    if (tid == 0) {
      int rung = a.K;
      for (int k = 0; k < a.K; ++k) {
        if (sF[k] <= a.rhs[static_cast<long long>(k) * a.B + b]) {
          rung = k;
          break;
        }
      }
      s_alpha = rung < a.K ? a.alphas[rung] : a.exhaust_alpha;
      a.rung_out[b] = rung;
      a.alpha_out[b] = s_alpha;
    }
    __syncthreads();
  }
  const float alpha = FULL ? s_alpha : a.alpha_in[b];

  // stage 4: x' = x + α·p, then f and ∇f there
  for (int j = tid; j < D; j += nthreads) {
    const float xn = sx[j] + alpha * sp[j];
    sxn[j] = xn;
    a.x_out[b * D + j] = xn;
  }
  __syncthreads();
  if (warp == 0) {
    float e1 = 0.0f, s1 = 0.0f, e2 = 0.0f;
    const float fv = repro::row_value<OBJ>(sxn, D, lane, &e1, &s1, &e2);
    if (lane == 0) {
      a.f_out[b] = fv;
      s_e1 = e1;
      s_s1 = s1;
      s_e2 = e2;
    }
  }
  __syncthreads();
  repro::grad_row<OBJ>(sxn, sgn, D, tid, nthreads, s_e1, s_s1, s_e2);
  __syncthreads();
  for (int j = tid; j < D; j += nthreads) {
    a.g_out[b * D + j] = sgn[j];
    sdx[j] = sxn[j] - sx[j];
    sdg[j] = sgn[j] - sg[j];
  }
  __syncthreads();

  // the curvature guard on the lane's D, then the sanitised pair
  if (warp == 0) {
    const float c = repro::warp_dot(sdx, sdg, D, lane);
    if (lane == 0) s_curv = c;
  }
  __syncthreads();
  const float curv = s_curv;
  const bool ok = a.active[b] != 0 && isfinite(curv) && curv > kCurvEps;
  const float rho = ok ? 1.0f / curv : 0.0f;
  if (!ok) {  // uniform over the block
    for (int j = tid; j < D; j += nthreads) {
      sdx[j] = 0.0f;
      sdg[j] = 0.0f;
    }
  }
  __syncthreads();

  // the guarded update: B2's two passes over H
  const float* Hb = a.H + b * D * D;
  repro::block_hdg(Hb, sdg, su, D, warp, lane, kWarps);
  __syncthreads();
  if (warp == 0) {
    const float s = repro::warp_dot(sdg, su, D, lane);
    if (lane == 0) s_dot = s;
  }
  __syncthreads();
  const float coef = rho * rho * s_dot + rho;
  repro::block_update_rows<true>(Hb, a.H_out + b * D * D, su, sdx, sgn, rho, coef,
                                 a.p_out + b * D, D, warp, lane, kWarps);
}

template <bool FULL>
int launch(int objective, const SweepArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.D <= 0) return 0;
  void (*kernel)(const SweepArgs);
  switch (objective) {
    case kSphere: kernel = sweep_kernel<kSphere, FULL>; break;
    case kRastrigin: kernel = sweep_kernel<kRastrigin, FULL>; break;
    case kRosenbrock: kernel = sweep_kernel<kRosenbrock, FULL>; break;
    case kAckley: kernel = sweep_kernel<kAckley, FULL>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t floats = FULL ? 16 * static_cast<size_t>(a.D) + a.K
                             : 8 * static_cast<size_t>(a.D);
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.B, kWarps * kWarp, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B5. x/p/g (B, D), H (B, D, D), active (B,) bool, rhs (K, B), alphas (K,)
// -> x_out/g_out/p_out (B, D), f_out/alpha_out (B,), H_out (B, D, D),
// rung_out (B,) int32. float32 and contiguous, K >= 1.
extern "C" int sweep_megakernel_full_launch(
    int objective, const float* x, const float* p, const float* g, const float* H,
    const unsigned char* active, const float* rhs, const float* alphas,
    float exhaust_alpha, float* x_out, float* f_out, float* g_out, float* H_out,
    float* p_out, float* alpha_out, int* rung_out, int B, int D, int K,
    cudaStream_t stream) {
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const SweepArgs a{x, p, g, H, active, rhs, alphas, exhaust_alpha, nullptr, x_out,
                    f_out, g_out, H_out, p_out, alpha_out, rung_out, B, D, K};
  return launch<true>(objective, a, stream);
}

// B5b. x/p/g (B, D), H (B, D, D), active (B,) bool, alpha (B,)
// -> x_out/g_out/p_out (B, D), f_out (B,), H_out (B, D, D).
extern "C" int sweep_megakernel_commit_launch(
    int objective, const float* x, const float* p, const float* g, const float* H,
    const unsigned char* active, const float* alpha, float* x_out, float* f_out,
    float* g_out, float* H_out, float* p_out, int B, int D, cudaStream_t stream) {
  const SweepArgs a{x, p, g, H, active, nullptr, nullptr, 0.0f, alpha, x_out,
                    f_out, g_out, H_out, p_out, nullptr, nullptr, B, D, 0};
  return launch<false>(objective, a, stream);
}
