// BFGS inverse-Hessian update in the ρ-form, per lane:
//   u = H δg,  s = δgᵀu,
//   H' = H − ρ(u δxᵀ + δx uᵀ) + (ρ²s + ρ) δx δxᵀ,
// in three modes of one kernel body:
//   guarded    — ρ given per lane, and p' = −H' g' as well. With ρ = 0 and
//                zeroed δx, δg every update term is an exact zero, so
//                H' = H bit for bit: the batched sweep's curvature guard
//                and its frozen lanes rely on that;
//   update     — ρ = 1/(δxᵀδg) reduced inside the kernel, H' only;
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
// Design: three variants, chosen by the lane's D alone (a choice by shape,
// not a fallback; ops.update_variant states the same rule):
//   small, D <= 32 (ops.update_small_dim): a warp per lane, eight lanes a
//     block. A row fits in the warp's 32 threads: groups of P threads, P
//     the power of two from 4 to 32 that covers D, take 32 / P rows at a
//     time, thread j of a group holding column j. The warp holds its lane's
//     H in registers (at most 32 floats a thread), forms u, s (and the
//     curvature) with butterflies over each group, writes u and δx to its
//     own slice of shared memory, then forms H' and p' from the registers
//     and writes H' once. A butterfly over P threads adds the same terms in
//     the same order as the 32-thread butterfly of the other variants,
//     less additions of exact zeros (columns past D), so the three variants
//     round alike;
//   single read, while D² + 4·D floats and the static scalars fit in a
//     block's 232,448 bytes of shared memory, (D² + 4·D)·4 + 128 <= 232,448
//     (D <= 239, ops.update_smem_dim): one block of eight warps per lane.
//     At the top the block copies its lane's H into shared memory in up to
//     eight row panels, each a multiple of 4 rows, each completing on its
//     own mbarrier: one bulk copy a panel where the lane's H is 16-byte
//     aligned (D even and an aligned base), else 4-byte cp.async that
//     arrives on the panel's barrier. block_hdg_rows takes panel i as soon
//     as it lands, while the later panels are in flight; block_update_rows
//     then runs over the resident copy and writes H'. Device memory is read
//     once: 8·D² bytes a lane, the bound. At D = 128 a block holds 66 KB,
//     so three blocks share an SM and one block's copy overlaps another's
//     update;
//   streaming above that: one block of eight warps per lane, block_hdg and
//     block_update_rows reading H from device memory, 12·D² bytes a lane.
// float64 (guarded_update_direction_launch_f64, B2 only): the kernel is a
// template on the element type, and the double instantiation runs the same
// three variants on doubles: the small one unchanged in threads (its
// shared arrays twice the bytes), the single read while (D² + 4·D)·8 + 128
// <= 232,448 (D <= 168, ops.update_smem_dim(float64)), with 8-byte cp.async
// where the bulk copy cannot run, and streaming above.
// The row sums and the entries of H' are update.cuh's in every variant
// (lane j of a row's threads adds columns j, j + 32, …, then a butterfly;
// updated_entry for each entry), so each lane's H' and p' do not depend on
// the variant, on the batch size or on where in the batch the lane lies.
// δx, δg, g' and u of the two block variants live in dynamic shared memory
// (16·D bytes, after H in the single-read variant). In every variant each
// element of a lane's H is read before that element of H' is written, so
// H_out may alias H; the wrappers allocate a fresh H' all the same.
#include "hopper.cuh"
#include "update.cuh"

namespace {

using repro::kWarp;

constexpr int kWarps = 8;
constexpr int kSmallMaxDim = kWarp;          // ops.update_small_dim
constexpr int kPanels = 8;                   // most row panels of a lane's H
constexpr long long kSmemPerBlock = 232448;  // the H100's opt-in shared memory a block
constexpr long long kSmemScalars = 128;      // bound on the static __shared__ scalars

enum Mode : int { kGuarded = 0, kUpdate = 1, kUpdateDirection = 2 };

// whether a lane's H fits in the block's shared memory beside the four
// vectors, in elements of T (ops.update_smem_dim: the largest such D)
template <typename T>
__host__ __device__ constexpr bool h_fits_smem(long long D) {
  return (D * D + 4 * D) * static_cast<long long>(sizeof(T)) + kSmemScalars <= kSmemPerBlock;
}

// rows of a panel: a multiple of 4, so that every panel of an even D is a
// whole number of 16-byte units, and at most kPanels panels
__host__ __device__ constexpr int panel_rows(int D) {
  return 4 * ((D + 4 * kPanels - 1) / (4 * kPanels));
}

template <typename T>
struct UpdateArgs {
  const T* H;
  const T* dx;
  const T* dg;
  const T* g_new;
  const T* rho;
  T* H_out;
  T* p_out;
  int B, D;
  int bulk;  // single-read variant: 1 to copy H with bulk copies, 0 with cp.async
};

// Small D: warp w of block k takes lane 8k + w; P threads a row.
template <typename T, int MODE, int P>
__global__ void __launch_bounds__(kWarps * kWarp) bfgs_update_small(const UpdateArgs<T> a) {
  constexpr bool kDirection = MODE != kUpdate;
  constexpr int G = kWarp / P;              // rows a warp takes at a time
  constexpr int NR = (P + G - 1) / G;       // steps of G rows to cover P rows
  __shared__ T s_u[kWarps][P];
  __shared__ T s_dx[kWarps][P];

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= a.B) return;  // uniform over the warp
  const int D = a.D;
  const int j = lane % P;   // the column this thread holds
  const int gi = lane / P;  // its row in each step of G rows
  const bool col = j < D;
  const T* Hb = a.H + b * D * D;
  const T dxj = col ? a.dx[b * D + j] : T(0);
  const T dgj = col ? a.dg[b * D + j] : T(0);
  const T gnj = kDirection && col ? a.g_new[b * D + j] : T(0);
  const T rho_in = MODE == kGuarded ? a.rho[b] : T(0);  // loads issued up front
  T h[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = r * G + gi;
    h[r] = col && i < D ? Hb[i * D + j] : T(0);
  }
  if (gi == 0) s_dx[warp][j] = dxj;

  // u_i = H[i, :]·δg, each row summed over its group
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r * G >= D) break;  // uniform over the warp
    T acc = T(0);
    acc += h[r] * dgj;
    acc = repro::group_sum(acc, P);
    const int i = r * G + gi;
    if (j == 0 && i < D) s_u[warp][i] = acc;
  }
  __syncwarp();
  const T uj = col ? s_u[warp][j] : T(0);
  T acc = T(0);
  acc += dgj * uj;
  const T s = repro::group_sum(acc, P);
  T rho = rho_in;
  if (MODE != kGuarded) {
    T c = T(0);
    c += dxj * dgj;
    rho = T(1) / repro::group_sum(c, P);
  }
  const T coef = rho * rho * s + rho;

  T* Ob = a.H_out + b * D * D;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r * G >= D) break;
    const int i = r * G + gi;
    const int ic = min(i, D - 1);
    const T hn = repro::updated_entry(h[r], s_u[warp][ic], s_dx[warp][ic], uj, dxj, rho, coef);
    if (col && i < D) Ob[i * D + j] = hn;
    if (kDirection) {
      T pacc = T(0);
      if (col) pacc += hn * gnj;
      pacc = repro::group_sum(pacc, P);
      if (j == 0 && i < D) a.p_out[b * D + i] = -pacc;
    }
  }
}

// The two block variants: one block of eight warps per lane, H from its
// shared-memory copy (SMEM_H) or streamed from device memory.
template <typename T, int MODE, bool SMEM_H>
__global__ void __launch_bounds__(kWarps * kWarp) bfgs_update_block(const UpdateArgs<T> a) {
  constexpr bool kDirection = MODE != kUpdate;
  const int D = a.D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* sH = smem;  // the lane's H, single-read variant only
  T* sdx = SMEM_H ? smem + D * D : smem;
  T* sdg = sdx + D;
  T* sgn = sdg + D;
  T* su = sgn + D;
  __shared__ T s_dot;
  __shared__ T s_curv;
  __shared__ __align__(8) uint64_t s_panel[kPanels];

  const long long b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const T* Hb = a.H + b * D * D;
  const T rho_in = MODE == kGuarded ? a.rho[b] : T(0);  // loads issued up front
  const int rows = panel_rows(D);
  const int npanels = (D + rows - 1) / rows;

  if (SMEM_H) {  // start every panel's copy now; pass 1 takes each as it lands
    if (a.bulk) {
      if (tid == 0) {
        for (int q = 0; q < npanels; ++q) repro::mbar_init(&s_panel[q], 1);
        repro::mbar_fence_init();
        for (int q = 0; q < npanels; ++q) {
          const long long off = static_cast<long long>(q) * rows * D;
          const uint32_t bytes =
              static_cast<uint32_t>(min(rows, D - q * rows)) * D * static_cast<uint32_t>(sizeof(T));
          repro::mbar_arrive_expect_tx(&s_panel[q], bytes);
          repro::bulk_load(sH + off, Hb + off, bytes, &s_panel[q]);
        }
      }
    } else {
      if (tid == 0) {
        for (int q = 0; q < npanels; ++q) repro::mbar_init(&s_panel[q], nthreads);
      }
      __syncthreads();
      for (int q = 0; q < npanels; ++q) {
        const int end = min(q * rows + rows, D) * D;
        for (int e = q * rows * D + tid; e < end; e += nthreads) {
          if constexpr (sizeof(T) == 8) {
            repro::cp_async_8(sH + e, Hb + e);
          } else {
            repro::cp_async_4(sH + e, Hb + e);
          }
        }
        repro::cp_async_mbar_arrive(&s_panel[q]);
      }
    }
  }

  for (int j = tid; j < D; j += nthreads) {
    sdx[j] = a.dx[b * D + j];
    sdg[j] = a.dg[b * D + j];
    if (kDirection) sgn[j] = a.g_new[b * D + j];
  }
  __syncthreads();

  // pass 1: u = H δg, panel by panel from shared memory, or streamed
  if (SMEM_H) {
    for (int q = 0; q < npanels; ++q) {
      repro::mbar_wait(&s_panel[q], 0);
      repro::block_hdg_rows<2>(sH, sdg, su, D, q * rows, min(q * rows + rows, D), warp,
                               lane, kWarps);
    }
  } else {
    repro::block_hdg(Hb, sdg, su, D, warp, lane, kWarps);
  }
  __syncthreads();

  if (warp == 0) {
    const T s = repro::warp_dot(sdg, su, D, lane);
    if (lane == 0) s_dot = s;
  } else if (MODE != kGuarded && warp == 1) {
    const T c = repro::warp_dot(sdx, sdg, D, lane);
    if (lane == 0) s_curv = c;
  }
  __syncthreads();

  const T rho = MODE == kGuarded ? rho_in : T(1) / s_curv;
  const T coef = rho * rho * s_dot + rho;

  // pass 2: H' rows (and p' = −H' g'); from shared memory four rows a warp
  // at a time, where the pass is latency-bound
  constexpr int kRows = SMEM_H ? 4 : 1;
  repro::block_update_rows<kDirection, kRows>(
      SMEM_H ? sH : Hb, a.H_out + b * D * D, su, sdx, sgn, rho, coef,
      kDirection ? a.p_out + b * D : nullptr, D, warp, lane, kWarps);
}

template <typename Kernel, typename T>
int launch_kernel(Kernel kernel, const UpdateArgs<T>& a, int blocks, size_t smem,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kWarps * kWarp, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename T>
int launch(UpdateArgs<T> a, cudaStream_t stream) {
  if (a.B <= 0 || a.D <= 0) return 0;
  const int D = a.D;
  if (D <= kSmallMaxDim) {
    const int blocks = (a.B + kWarps - 1) / kWarps;
    if (D <= 4) return launch_kernel(bfgs_update_small<T, MODE, 4>, a, blocks, 0, stream);
    if (D <= 8) return launch_kernel(bfgs_update_small<T, MODE, 8>, a, blocks, 0, stream);
    if (D <= 16) return launch_kernel(bfgs_update_small<T, MODE, 16>, a, blocks, 0, stream);
    return launch_kernel(bfgs_update_small<T, MODE, 32>, a, blocks, 0, stream);
  }
  const size_t vectors = 4 * static_cast<size_t>(D) * sizeof(T);
  if (h_fits_smem<T>(D)) {
    // every lane's H and every panel start on a 16-byte boundary: an even D
    // (D²·sizeof(T) a multiple of 16) and an aligned base
    a.bulk = D % 2 == 0 && reinterpret_cast<uintptr_t>(a.H) % 16 == 0;
    const size_t smem = static_cast<size_t>(D) * D * sizeof(T) + vectors;
    return launch_kernel(bfgs_update_block<T, MODE, true>, a, a.B, smem, stream);
  }
  return launch_kernel(bfgs_update_block<T, MODE, false>, a, a.B, vectors, stream);
}

}  // namespace

// All take H (B, D, D) and dx/dg (B, D); float32, contiguous.
// Guarded: g_new (B, D), rho (B,) -> H_out (B, D, D), p_out (B, D).
extern "C" int guarded_update_direction_launch(const float* H, const float* dx,
                                               const float* dg, const float* g_new,
                                               const float* rho, float* H_out,
                                               float* p_out, int B, int D,
                                               cudaStream_t stream) {
  return launch<kGuarded>(
      UpdateArgs<float>{H, dx, dg, g_new, rho, H_out, p_out, B, D, 0}, stream);
}

// The guarded update in float64 (B2's double instantiation); the unguarded
// two stay float32.
extern "C" int guarded_update_direction_launch_f64(const double* H, const double* dx,
                                                   const double* dg, const double* g_new,
                                                   const double* rho, double* H_out,
                                                   double* p_out, int B, int D,
                                                   cudaStream_t stream) {
  return launch<kGuarded>(
      UpdateArgs<double>{H, dx, dg, g_new, rho, H_out, p_out, B, D, 0}, stream);
}

// Unguarded, ρ = 1/(δxᵀδg) per lane -> H_out (B, D, D).
extern "C" int bfgs_update_launch(const float* H, const float* dx, const float* dg,
                                  float* H_out, int B, int D, cudaStream_t stream) {
  return launch<kUpdate>(
      UpdateArgs<float>{H, dx, dg, nullptr, nullptr, H_out, nullptr, B, D, 0}, stream);
}

// Unguarded, with g_new (B, D) -> H_out (B, D, D), p_out (B, D).
extern "C" int update_direction_launch(const float* H, const float* dx, const float* dg,
                                       const float* g_new, float* H_out, float* p_out,
                                       int B, int D, cudaStream_t stream) {
  return launch<kUpdateDirection>(
      UpdateArgs<float>{H, dx, dg, g_new, nullptr, H_out, p_out, B, D, 0}, stream);
}
