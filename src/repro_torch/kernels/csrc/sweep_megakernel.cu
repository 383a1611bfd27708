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
//     objective.cuh's row_value on the whole warp, the body of B1a, whose
//     row groups of P < 32 lanes at D <= 16 give the same bits
//     (objective.cuh), so each F_k is bitwise B1a's on the same trial row;
//   - the thresholds come in as the staged path computed them and are never
//     recomputed here, so the accept decisions are the staged ones;
//   - f' is row_value and g' grad_row at x' (B1b's bodies);
//   - the update is update.cuh's block_hdg and block_update_rows (B2's
//     passes: the same row-to-warp map, lane striding and order of terms).
// The one reduction that is not the staged path's is δxᵀδg: the staged path
// takes it with torch.sum, here a warp sums it, so ρ, H' and p' may differ
// from the staged kernels' in the last bits; rung, α, x', f' and g' do not.
//
// Two variants, chosen by the lane's D alone (a choice by shape, not a
// fallback):
//   - single read, while H fits in the block's shared memory beside the
//     vectors, (D² + 16·D + K)·4 + 64 <= 232,448 bytes for B5 (D <= 233 at
//     K = 20) and (D² + 8·D)·4 + 64 <= 232,448 for B5b (D <= 237) in
//     float32; ops.megakernel_smem_dim states the same rule. The block starts
//     the copy of its lane's H (D² contiguous elements) into shared memory at
//     the top, before stages 1–3: one bulk copy on an mbarrier where the
//     lane's H is 16-byte aligned (D even and an aligned base), else
//     element-wide cp.async.
//     The trial fan and its values read only shared memory, so they hide
//     the copy; the update waits for it and runs block_hdg and
//     block_update_rows on the shared-memory H. H is read from device
//     memory once: 8·D² bytes a lane, the bound.
//   - two streaming passes above that: block_hdg and block_update_rows read
//     H from device memory, 12·D² bytes a lane.
// H' is written by coalesced warp stores (lane j of a row writes column j,
// j + 32, …), the order of update.cuh.
// Shared memory per block: the single-read variant's H (D² elements) first,
// then x, p, g, x', g', δx, δg, u (8·D) and, for B5, eight trial rows (8·D)
// and the K trial values: (16·D + K) elements beside H. ops.py derives the
// largest D that fits in the 227 KB a block may have.
//
// float64 (the `_f64` launch functions): the kernel is a template on the
// element type T, and every shared body it calls (objective.cuh's row_value
// and grad_row, update.cuh's passes) is the one the double B1a/B1b and B2
// run, so the contract holds in double as in float: rung, α, x', f' and g'
// bitwise the staged float64 path's, H' and p' B2's but through δxᵀδg.
// Every byte rule counts sizeof(T): the single read runs while
// (D² + 16·D + K)·8 + 64 <= 232,448 (D <= 162 at K = 20) for B5 and
// (D² + 8·D)·8 + 64 for B5b (D <= 166); H comes in by one bulk copy where
// the lane's H is 16-byte aligned (D even and an aligned base), else by
// 8-byte cp.async. The curvature guard compares against the double 1e-10
// in double (engine._CURV_EPS, which the staged path's torch comparison
// rounds to the tensor's type), never the float 1e-10f widened.
#include "hopper.cuh"
#include "objective.cuh"
#include "update.cuh"

namespace {

using repro::kAckley;
using repro::kRastrigin;
using repro::kRosenbrock;
using repro::kSphere;
using repro::kWarp;

constexpr int kWarps = 8;
constexpr long long kSmemPerBlock = 232448;  // the H100's opt-in shared memory a block
constexpr long long kSmemScalars = 64;       // the kernel's static __shared__ scalars

// engine._CURV_EPS in the element type: the staged path compares δxᵀδg with
// the Python constant, which torch rounds to the tensor's type
template <typename T>
struct CurvEps;
template <>
struct CurvEps<float> {
  static constexpr float value = 1e-10f;
};
template <>
struct CurvEps<double> {
  static constexpr double value = 1e-10;
};

// One launch's arguments; the pointers of stages 1-3 (rhs, alphas,
// alpha_out, rung_out) are unused by B5b, alpha_in by B5.
template <typename T>
struct SweepArgs {
  const T* x;
  const T* p;
  const T* g;
  const T* H;
  const unsigned char* active;
  const T* rhs;
  const T* alphas;
  T exhaust_alpha;
  const T* alpha_in;
  T* x_out;
  T* f_out;
  T* g_out;
  T* H_out;
  T* p_out;
  T* alpha_out;
  int* rung_out;
  int B, D, K;
  int bulk;  // single-read variant: 1 to copy H with one bulk copy, 0 with cp.async
};

// whether a lane's H fits in the block's shared memory beside the vectors,
// in elements of T (ops.megakernel_smem_dim: the largest such D)
template <typename T>
__host__ __device__ constexpr bool h_fits_smem(long long D, long long K, bool full) {
  return (D * D + (full ? 16 * D + K : 8 * D)) * static_cast<long long>(sizeof(T)) +
             kSmemScalars <=
         kSmemPerBlock;
}

template <typename T, int OBJ, bool FULL, bool SMEM_H>
__global__ void __launch_bounds__(kWarps * kWarp) sweep_kernel(const SweepArgs<T> a) {
  const int D = a.D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* sH = smem;  // the lane's H, single-read variant only
  T* sx = SMEM_H ? smem + D * D : smem;
  T* sp = sx + D;
  T* sg = sp + D;
  T* sxn = sg + D;
  T* sgn = sxn + D;
  T* sdx = sgn + D;
  T* sdg = sdx + D;
  T* su = sdg + D;
  __shared__ T s_alpha, s_e1, s_s1, s_e2, s_curv, s_dot;
  __shared__ __align__(8) uint64_t s_h_full;

  const long long b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const T* Hb = a.H + b * D * D;
  const T alpha_in = FULL ? T(0) : a.alpha_in[b];  // loads issued up front
  const bool active = a.active[b] != 0;

  if (SMEM_H) {  // start reading H now; stages 1-4 before the update hide it
    if (a.bulk) {
      if (tid == 0) {
        repro::mbar_init(&s_h_full, 1);
        repro::mbar_fence_init();
        const uint32_t bytes = static_cast<uint32_t>(D) * D * static_cast<uint32_t>(sizeof(T));
        repro::mbar_arrive_expect_tx(&s_h_full, bytes);
        repro::bulk_load(sH, Hb, bytes, &s_h_full);
      }
    } else {
      for (int j = tid; j < D * D; j += nthreads) {
        if constexpr (sizeof(T) == 8) {
          repro::cp_async_8(sH + j, Hb + j);
        } else {
          repro::cp_async_4(sH + j, Hb + j);
        }
      }
      repro::cp_async_commit();
    }
  }

  for (int j = tid; j < D; j += nthreads) {
    sx[j] = a.x[b * D + j];
    sp[j] = a.p[b * D + j];
    sg[j] = a.g[b * D + j];
  }
  __syncthreads();

  if (FULL) {
    // stages 1-2: warp w evaluates rungs w, w + kWarps, … in its own row and
    // holds each value against its threshold, loaded ahead of the row's work
    // (the same comparison in T as the staged accept); sF[k] = 1 where rung
    // k is accepted (a NaN value or threshold accepts nothing)
    T* trial = su + D + warp * D;
    T* sF = su + D + kWarps * D;
    for (int k = warp; k < a.K; k += kWarps) {
      const T alpha_k = a.alphas[k];
      const T rhs_k = a.rhs[static_cast<long long>(k) * a.B + b];
      for (int j = lane; j < D; j += kWarp) trial[j] = sx[j] + alpha_k * sp[j];
      __syncwarp();
      T e1 = T(0), s1 = T(0), e2 = T(0);
      const T fk = repro::row_value<OBJ, kWarp>(trial, D, lane, &e1, &s1, &e2);
      if (lane == 0) sF[k] = fk <= rhs_k ? T(1) : T(0);
      __syncwarp();  // every lane has read the row before the next rung
    }
    __syncthreads();
    // stage 3: the first accepted rung, K when none
    if (tid == 0) {
      int rung = a.K;
      for (int k = 0; k < a.K; ++k) {
        if (sF[k] != T(0)) {
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
  const T alpha = FULL ? s_alpha : alpha_in;

  // stage 4: x' = x + α·p, then f and ∇f there
  for (int j = tid; j < D; j += nthreads) {
    const T xn = sx[j] + alpha * sp[j];
    sxn[j] = xn;
    a.x_out[b * D + j] = xn;
  }
  __syncthreads();
  if (warp == 0) {
    T e1 = T(0), s1 = T(0), e2 = T(0);
    const T fv = repro::row_value<OBJ, kWarp>(sxn, D, lane, &e1, &s1, &e2);
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
    const T c = repro::warp_dot(sdx, sdg, D, lane);
    if (lane == 0) s_curv = c;
  }
  __syncthreads();
  const T curv = s_curv;
  const bool ok = active && isfinite(curv) && curv > CurvEps<T>::value;
  const T rho = ok ? T(1) / curv : T(0);
  if (!ok) {  // uniform over the block
    for (int j = tid; j < D; j += nthreads) {
      sdx[j] = T(0);
      sdg[j] = T(0);
    }
  }
  __syncthreads();

  // the guarded update: B2's passes, over the shared-memory copy of H or
  // streaming it from device memory twice
  const T* Hs = Hb;
  if (SMEM_H) {
    if (a.bulk) {
      repro::mbar_wait(&s_h_full, 0);
    } else {
      repro::cp_async_wait_all();
      __syncthreads();
    }
    Hs = sH;
  }
  // rows interleaved four at a time from shared memory, where the update is
  // latency-bound (each row's arithmetic is the one-row loop's)
  constexpr int kRows = SMEM_H ? 4 : 1;
  repro::block_hdg<kRows>(Hs, sdg, su, D, warp, lane, kWarps);
  __syncthreads();
  if (warp == 0) {
    const T s = repro::warp_dot(sdg, su, D, lane);
    if (lane == 0) s_dot = s;
  }
  __syncthreads();
  const T coef = rho * rho * s_dot + rho;
  repro::block_update_rows<true, kRows>(Hs, a.H_out + b * D * D, su, sdx, sgn, rho, coef,
                                        a.p_out + b * D, D, warp, lane, kWarps);
}

template <typename T, bool FULL, bool SMEM_H>
int launch_variant(int objective, const SweepArgs<T>& a, cudaStream_t stream) {
  void (*kernel)(const SweepArgs<T>);
  switch (objective) {
    case kSphere: kernel = sweep_kernel<T, kSphere, FULL, SMEM_H>; break;
    case kRastrigin: kernel = sweep_kernel<T, kRastrigin, FULL, SMEM_H>; break;
    case kRosenbrock: kernel = sweep_kernel<T, kRosenbrock, FULL, SMEM_H>; break;
    case kAckley: kernel = sweep_kernel<T, kAckley, FULL, SMEM_H>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t elems = (SMEM_H ? static_cast<size_t>(a.D) * a.D : 0) +
                       (FULL ? 16 * static_cast<size_t>(a.D) + a.K
                             : 8 * static_cast<size_t>(a.D));
  const size_t smem = elems * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.B, kWarps * kWarp, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool FULL, typename T>
int launch(int objective, SweepArgs<T> a, cudaStream_t stream) {
  if (a.B <= 0 || a.D <= 0) return 0;
  if (!h_fits_smem<T>(a.D, a.K, FULL)) {
    return launch_variant<T, FULL, false>(objective, a, stream);
  }
  // every lane's H starts on a 16-byte boundary: D²·sizeof(T) a multiple of
  // 16 (D even) and an aligned base
  a.bulk = a.D % 2 == 0 && reinterpret_cast<uintptr_t>(a.H) % 16 == 0;
  return launch_variant<T, FULL, true>(objective, a, stream);
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
  const SweepArgs<float> a{x, p, g, H, active, rhs, alphas, exhaust_alpha, nullptr, x_out,
                           f_out, g_out, H_out, p_out, alpha_out, rung_out, B, D, K, 0};
  return launch<true>(objective, a, stream);
}

// B5 in float64: every array of the float32 launch (but active and rung_out)
// in double, and exhaust_alpha a double.
extern "C" int sweep_megakernel_full_launch_f64(
    int objective, const double* x, const double* p, const double* g, const double* H,
    const unsigned char* active, const double* rhs, const double* alphas,
    double exhaust_alpha, double* x_out, double* f_out, double* g_out, double* H_out,
    double* p_out, double* alpha_out, int* rung_out, int B, int D, int K,
    cudaStream_t stream) {
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const SweepArgs<double> a{x, p, g, H, active, rhs, alphas, exhaust_alpha, nullptr, x_out,
                            f_out, g_out, H_out, p_out, alpha_out, rung_out, B, D, K, 0};
  return launch<true>(objective, a, stream);
}

// B5b. x/p/g (B, D), H (B, D, D), active (B,) bool, alpha (B,)
// -> x_out/g_out/p_out (B, D), f_out (B,), H_out (B, D, D).
extern "C" int sweep_megakernel_commit_launch(
    int objective, const float* x, const float* p, const float* g, const float* H,
    const unsigned char* active, const float* alpha, float* x_out, float* f_out,
    float* g_out, float* H_out, float* p_out, int B, int D, cudaStream_t stream) {
  const SweepArgs<float> a{x, p, g, H, active, nullptr, nullptr, 0.0f, alpha, x_out,
                           f_out, g_out, H_out, p_out, nullptr, nullptr, B, D, 0, 0};
  return launch<false>(objective, a, stream);
}

// B5b in float64.
extern "C" int sweep_megakernel_commit_launch_f64(
    int objective, const double* x, const double* p, const double* g, const double* H,
    const unsigned char* active, const double* alpha, double* x_out, double* f_out,
    double* g_out, double* H_out, double* p_out, int B, int D, cudaStream_t stream) {
  const SweepArgs<double> a{x, p, g, H, active, nullptr, nullptr, 0.0, alpha, x_out,
                            f_out, g_out, H_out, p_out, nullptr, nullptr, B, D, 0, 0};
  return launch<false>(objective, a, stream);
}
