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
// Design: a row takes an aligned group of P threads, P the smallest power
// of two >= D and at most a warp's 32 (row_threads; ops.fused_obj_row_threads
// states the same rule), so a warp holds 32/P rows and a 256-thread block
// 256/P a pass. A whole warp on one row of D = 8 had left 24 of its 32
// lanes idle and paid a five-round butterfly for eight terms; a group of 8
// lanes takes one element each and three rounds.
//   - D <= 16 (P < 32): a block takes 2048/P consecutive rows, at most 2048
//     floats. Its threads first copy them into shared memory, eight
//     independent coalesced loads each, all in flight at once; then the
//     groups evaluate the tile's rows in eight passes of 256/P rows,
//     unrolled on a full tile so that the passes interleave; last, f
//     leaves in one coalesced store a thread. With one 4-byte load a lane
//     and a row per group, a resident wave held too few bytes in flight to
//     cover the device memory's latency.
//   - D >= 17 (P = 32): a warp a row, eight rows a block, the lanes
//     striding over D and reading the row from device memory.
// The row value and the row gradient are objective.cuh's row_value (P
// lanes) and grad_row (each lane its own columns), which the sweep
// megakernel (sweep_megakernel.cu) runs too, on a whole warp, with the same
// bits (objective.cuh). No cross-block state.
//
// Exactness: the value-only instantiation (WITH_GRAD = false) must return
// f bitwise equal to the value+grad instantiation, because the Armijo test
// compares ladder values from one against F0 from the other. Both take the
// same P for a D, run the same row_value() code in the same reduction
// order, and the file is built with -fmad=false so the compiler cannot
// contract a multiply-add into an FMA in one instantiation and not the
// other.
#include "objective.cuh"

namespace {

using repro::kAckley;
using repro::kRastrigin;
using repro::kRosenbrock;
using repro::kSphere;
using repro::kWarp;

constexpr int kThreads = 256;
// A block of the row-group kernel stages kLoads floats a thread.
constexpr int kLoads = 8;
constexpr int kTileFloats = kThreads * kLoads;

// The threads a row of D takes: the smallest power of two >= D, at most 32.
int row_threads(int D) {
  int P = 1;
  while (P < D && P < kWarp) P *= 2;
  return P;
}

// D <= 16: rows in aligned groups of P < 32 lanes, kTileFloats / P rows a
// block staged through shared memory (the design note above).
template <int OBJ, bool WITH_GRAD, int P>
__global__ void __launch_bounds__(kThreads)
fused_obj_rows_kernel(const float* __restrict__ x, float* __restrict__ f,
                      float* __restrict__ g, int N, int D) {
  constexpr int kRows = kTileFloats / P;
  constexpr int kRowsPerPass = kThreads / P;
  __shared__ float tile[kTileFloats];
  __shared__ float sf[kRows];
  const long long block_row = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = N - block_row;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  const int n = rows * D;
  const float* xb = x + block_row * D;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int k = threadIdx.x + i * kThreads;
    if (k < n) tile[k] = xb[k];
  }
  __syncthreads();

  const int lane = threadIdx.x % P;
  const int group = threadIdx.x / P;
  // one row of the tile a group: r < rows stores, a group past the last
  // row evaluates that row again (so that every lane takes part in the
  // full-warp shuffles) and stores nothing
  const auto pass = [&](int r) {
    const bool owner = r < rows;
    const float* xr = tile + (owner ? r : rows - 1) * D;
    float e1 = 0.0f, s1 = 0.0f, e2 = 0.0f;
    const float fv = repro::row_value<OBJ, P>(xr, D, lane, &e1, &s1, &e2);
    if (owner) {
      if (lane == 0) sf[r] = fv;
      if (WITH_GRAD) {
        repro::grad_row<OBJ>(xr, g + (block_row + r) * D, D, lane, P, e1, s1, e2);
      }
    }
  };
  if (rows == kRows) {
    // a full tile: the passes are independent and unrolled, so their loads,
    // transcendentals and shuffles interleave
#pragma unroll
    for (int u = 0; u < kLoads; ++u) pass(u * kRowsPerPass + group);
  } else {
    // the last tile: a warp stops at its first pass past the last row (the
    // bound is warp-uniform)
    const int warp_row = (threadIdx.x / kWarp) * (kWarp / P);
    for (int r0 = 0; r0 + warp_row < rows; r0 += kRowsPerPass) pass(r0 + group);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < rows; k += kThreads) f[block_row + k] = sf[k];
}

// D >= 17: a warp a row, eight rows a block, the lanes striding over D.
template <int OBJ, bool WITH_GRAD>
__global__ void __launch_bounds__(kThreads)
fused_obj_kernel(const float* __restrict__ x, float* __restrict__ f,
                 float* __restrict__ g, int N, int D) {
  constexpr int kWarpsPerBlock = kThreads / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= N) return;  // whole warp leaves together: row is warp-uniform
  const float* xr = x + row * D;

  float e1 = 0.0f, s1 = 0.0f, e2 = 0.0f;
  const float fv = repro::row_value<OBJ, kWarp>(xr, D, lane, &e1, &s1, &e2);
  if (lane == 0) f[row] = fv;
  if (!WITH_GRAD) return;

  repro::grad_row<OBJ>(xr, g + row * D, D, lane, kWarp, e1, s1, e2);
}

template <int OBJ, bool WITH_GRAD, int P>
void launch_rows(const float* x, float* f, float* g, int N, int D, cudaStream_t stream) {
  constexpr int kRows = P < kWarp ? kTileFloats / P : kThreads / kWarp;
  const long long blocks = (static_cast<long long>(N) + kRows - 1) / kRows;
  if constexpr (P < kWarp) {
    fused_obj_rows_kernel<OBJ, WITH_GRAD, P>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, f, g, N, D);
  } else {
    fused_obj_kernel<OBJ, WITH_GRAD>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, f, g, N, D);
  }
}

template <int OBJ, bool WITH_GRAD>
void launch_layout(const float* x, float* f, float* g, int N, int D, cudaStream_t stream) {
  switch (row_threads(D)) {
    case 1: launch_rows<OBJ, WITH_GRAD, 1>(x, f, g, N, D, stream); break;
    case 2: launch_rows<OBJ, WITH_GRAD, 2>(x, f, g, N, D, stream); break;
    case 4: launch_rows<OBJ, WITH_GRAD, 4>(x, f, g, N, D, stream); break;
    case 8: launch_rows<OBJ, WITH_GRAD, 8>(x, f, g, N, D, stream); break;
    case 16: launch_rows<OBJ, WITH_GRAD, 16>(x, f, g, N, D, stream); break;
    default: launch_rows<OBJ, WITH_GRAD, kWarp>(x, f, g, N, D, stream); break;
  }
}

template <int OBJ>
void launch_obj(bool with_grad, const float* x, float* f, float* g, int N, int D,
                cudaStream_t stream) {
  if (with_grad) {
    launch_layout<OBJ, true>(x, f, g, N, D, stream);
  } else {
    launch_layout<OBJ, false>(x, f, g, N, D, stream);
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
