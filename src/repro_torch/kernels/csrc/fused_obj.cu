// Fused objective value and value+gradient for sphere, rastrigin,
// rosenbrock and ackley, row-wise over an (N, D) batch.
//
// Replaces: src/repro/kernels/fused_obj.py fused_value_pallas (:119) and
// fused_value_grad_pallas (:140), which evaluate 256-row tiles in VMEM.
//
// Bound on the H100: bytes at D <= 16. Each row reads D floats and writes
// 1 (value) or 1 + D (value+grad); the arithmetic per element is a handful
// of multiply-adds plus at most one cosf and one sinf. From D = 17 on, with
// a warp a row, the instructions a warp issues (about 24 an element for
// rastrigin's and ackley's cosine, the butterflies, the bookkeeping of the
// ring) bind before the bytes do: chip_smoke.py counts the element loop's
// SASS and prints its issue bound beside the byte bound.
//
// Design: a row takes an aligned group of P threads, P the smallest power
// of two >= D and at most a warp's 32 (row_threads; ops.fused_obj_row_threads
// states the same rule). Three variants, chosen by D alone
// (ops.fused_obj_variant states the rule, launch_layout applies it):
//   - rows, D <= 16 (P < 32): a warp holds 32/P rows and a 256-thread block
//     256/P a pass. A block takes 2048/P consecutive rows, at most 2048
//     floats. Its threads first copy them into shared memory, eight
//     independent coalesced loads each, all in flight at once; then the
//     groups evaluate the tile's rows in eight passes of 256/P rows,
//     unrolled on a full tile so that the passes interleave; last, f
//     leaves in one coalesced store a thread. With one 4-byte load a lane
//     and a row per group, a resident wave held too few bytes in flight to
//     cover the device memory's latency.
//   - staged, 17 <= D while a ring of two stages of 16 rows fits in a
//     block's shared memory (D <= 1815): persistent blocks of eight
//     consumer warps and one producer warp walk over tiles of R whole rows
//     (R = ops.fused_obj_tile_rows(D), a multiple of 16 from 16 to 64,
//     about 16 KB a tile), block b taking tiles b, b + grid, …. The tiles
//     pass through a ring of S stages in shared memory (S =
//     ops.fused_obj_stages(D), at most 4), each with a "full" and an
//     "empty" mbarrier. One producer thread fills a stage with a single
//     cp.async.bulk of the tile's 16-byte-aligned interior; the at most
//     three floats before it (a base that is not 16-byte aligned) and three
//     after it (a last tile of rows·D·4 bytes that is no multiple of 16)
//     it loads itself before the barrier's arrival. A stage holds its tile
//     from float (x's offset from 16 bytes, in floats) on, so the copy's
//     destination is as aligned as its source. Every consumer warp takes
//     rows of every tile, in order: two consecutive rows at a time
//     (kRowsAtOnce), rows 2w, 2w + 1, 2w + 16, … of the tile for warp w.
//     So each warp waits on each tile's "full" phase in turn (a warp that
//     skipped a tile could mistake a later phase of the same parity for
//     it) and arrives once on its "empty" barrier when done with it; R >=
//     16 keeps all eight warps busy. The two rows' element loops and
//     butterflies are independent chains that the scheduler interleaves,
//     and rastrigin's and ackley's cosines take objective.cuh's
//     straight-line fast path. A warp reads its rows from shared memory in
//     the warp's lane order (lane l takes j = l, l + 32, …). Up to three
//     blocks an SM, each with a ring of up to four 16 KB stages, keep loads
//     in flight while the warps issue the arithmetic. The grid is the
//     smaller of the tile count and the blocks that fit on the card at once
//     (the SM count is read once). The value-only kernel keeps each row's
//     sums (row_sums_n) on one lane, lane i of a warp for its i-th row, and
//     finishes 32 rows at once, one a lane (row_finish): ackley's sqrtf, two
//     divisions and two expf then cost a warp instruction for 32 rows, not
//     one a row, and f leaves in one store instruction for 32 rows. The
//     value+grad kernel finishes each row on the whole warp, since every
//     lane needs ackley's reductions for the gradient, and writes g in
//     lane-strided coalesced stores from the staged row.
//   - direct, above that D: a warp a row, eight rows a block, the lanes
//     striding over D and reading the row from device memory.
// The row value and the row gradient are objective.cuh's row_sums_n and
// row_finish (together row_value; P lanes) and grad_row (each lane its own
// columns), which the sweep megakernel (sweep_megakernel.cu) runs too, on a
// whole warp, with the same bits (objective.cuh). No cross-block state.
//
// Exactness: the value-only instantiation (WITH_GRAD = false) must return
// f bitwise equal to the value+grad instantiation, because the Armijo test
// compares ladder values from one against F0 from the other. Both take the
// same variant and P for a D, run the same row_sums_n() code in the same
// reduction order and the same row_finish() on its result (on one lane or
// on all: it is elementwise), and the file is built with -fmad=false so
// the compiler cannot contract a multiply-add into an FMA in one
// instantiation and not the other.
#include "hopper.cuh"
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

// The staged ring (ops.fused_obj_tile_rows, fused_obj_stages and
// fused_obj_staged_max_dim state the same rule).
constexpr int kConsumerWarps = 8;
constexpr int kStagedThreads = (kConsumerWarps + 1) * kWarp;  // + the producer warp
constexpr int kTileBytes = 16384;  // a stage's target size
constexpr int kMaxTileRows = 64;
constexpr int kMinStages = 2;
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full[4], empty[4]
constexpr long long kSmemPerBlock = 232448;  // the H100's opt-in shared memory a block
constexpr int kSmemPerSM = 233472;           // 228 KB an SM
constexpr int kSmemReserved = 1024;          // the system's share of it a block
constexpr int kMaxBlocksPerSM = 3;
constexpr int kRowsAtOnce = 2;  // rows a consumer warp evaluates together
// a tile's rows come in steps of kRowsAtOnce rows for each consumer warp, so
// that every warp has rows in every tile and waits on every tile's barrier
constexpr int kMinTileRows = kRowsAtOnce * kConsumerWarps;

// The threads a row of D takes: the smallest power of two >= D, at most 32.
int row_threads(int D) {
  int P = 1;
  while (P < D && P < kWarp) P *= 2;
  return P;
}

// The staged variant's ring at D: R rows a tile (a multiple of 16, about
// kTileBytes a tile, 16 to 64) and S stages of R·D + 4 floats (as many as
// fit, at most 4), behind the barriers; stages < kMinStages where even the
// smallest ring does not fit, and then D takes the direct variant.
struct Ring {
  int rows;
  int stages;
  int smem;  // bytes
};

Ring ring(int D) {
  int R = kTileBytes / 4 / D / kMinTileRows * kMinTileRows;
  R = R < kMinTileRows ? kMinTileRows : (R > kMaxTileRows ? kMaxTileRows : R);
  const long long stage_bytes = (static_cast<long long>(R) * D + 4) * 4;
  const long long fit = (kSmemPerBlock - kBarrierBytes) / stage_bytes;
  const int S = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return Ring{R, S, static_cast<int>(kBarrierBytes + S * stage_bytes)};
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

// D >= 17 while the ring fits: persistent blocks, rows staged through a
// ring of shared-memory stages by bulk copies (the design note above).
template <int OBJ, bool WITH_GRAD>
__global__ void __launch_bounds__(kStagedThreads, kMaxBlocksPerSM)
fused_obj_staged_kernel(const float* __restrict__ x, float* __restrict__ f,
                        float* __restrict__ g, int N, int D, int R, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  float* stages = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
  const long long stage_floats = static_cast<long long>(R) * D + 4;
  const long long ntiles = (static_cast<long long>(N) + R - 1) / R;
  const int my_tiles = static_cast<int>((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // x's offset from the 16-byte boundary below it, in floats; every tile
  // starts at the same offset, R·D·4 being a multiple of 16
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], kConsumerWarps);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int k = 0; k < my_tiles; ++k) {
        const int s = k % S;
        const long long row0 = (blockIdx.x + static_cast<long long>(k) * gridDim.x) * R;
        const long long left = N - row0;
        const int n = static_cast<int>(left < R ? left : R) * D;
        const float* src = x + row0 * D;
        const int head = min(n, (4 - mis) & 3);
        const int body = (n - head) & ~3;
        const int tail = n - head - body;
        // the loads of the unaligned edges go out before the wait
        float hv[3], tv[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          hv[i] = i < head ? src[i] : 0.0f;
          tv[i] = i < tail ? src[head + body + i] : 0.0f;
        }
        if (k >= S) repro::mbar_wait(&empty[s], ((k / S) - 1) & 1);
        float* dst = stages + s * stage_floats + mis;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (i < head) dst[i] = hv[i];
          if (i < tail) dst[head + body + i] = tv[i];
        }
        // the arrival releases the edge stores; the phase completes when the
        // copy's bytes have landed
        repro::mbar_arrive_expect_tx(&full[s], static_cast<uint32_t>(body) * 4);
        if (body > 0) {
          repro::bulk_load(dst + head, src + head, static_cast<uint32_t>(body) * 4, &full[s]);
        }
      }
    }
    return;
  }

  // a consumer warp: every tile of the block in order, kRowsAtOnce
  // consecutive rows r, r + 1, … at a time, r = kRowsAtOnce·warp,
  // + kRowsAtOnce·8, … < R; tile k sits in stage k % S at phase parity
  // (k / S) & 1
  constexpr int kStep = kRowsAtOnce * kConsumerWarps;
  float2 kept = make_float2(0.0f, 0.0f);  // value-only: this lane's row's sums
  long long kept_row = -1;
  int batch = 0;  // rows kept so far, one a lane
  const auto finish_batch = [&]() {
    float e1, s1, e2;
    const float fv = repro::row_finish<OBJ>(kept, D, &e1, &s1, &e2);
    if (kept_row >= 0) f[kept_row] = fv;
    kept_row = -1;
    batch = 0;
  };
  const long long row_step = static_cast<long long>(gridDim.x) * R;
  long long row0 = static_cast<long long>(blockIdx.x) * R;
  int s = 0, phase = 0;
  for (int k = 0; k < my_tiles; ++k) {
    repro::mbar_wait(&full[s], phase);
    const long long left = N - row0;
    const int rows = left < R ? static_cast<int>(left) : R;
    const float* xs = stages + s * stage_floats + mis;
    for (int r = kRowsAtOnce * warp; r < rows; r += kStep) {  // warp-uniform
      // a row past a ragged last tile repeats the step's first row
      const float* xp[kRowsAtOnce];
#pragma unroll
      for (int m = 0; m < kRowsAtOnce; ++m) xp[m] = xs + (r + m < rows ? r + m : r) * D;
      float2 sums[kRowsAtOnce];
      repro::row_sums_n<OBJ, kWarp, kRowsAtOnce>(xp, D, lane, sums);
      const long long row = row0 + r;
      if (WITH_GRAD) {
        // each row finished on the whole warp: every lane needs ackley's
        // reductions for the gradient
#pragma unroll
        for (int m = 0; m < kRowsAtOnce; ++m) {
          if (r + m >= rows) break;
          float e1 = 0.0f, s1 = 0.0f, e2 = 0.0f;
          const float fv = repro::row_finish<OBJ>(sums[m], D, &e1, &s1, &e2);
          if (lane == 0) f[row + m] = fv;
          repro::grad_row<OBJ>(xp[m], g + (row + m) * D, D, lane, kWarp, e1, s1, e2);
        }
      } else {
        if (batch + kRowsAtOnce > kWarp) finish_batch();
#pragma unroll
        for (int m = 0; m < kRowsAtOnce; ++m) {
          if (r + m < rows && lane == batch + m) {
            kept = sums[m];
            kept_row = row + m;
          }
        }
        batch += rows - r < kRowsAtOnce ? rows - r : kRowsAtOnce;
      }
    }
    __syncwarp();  // the warp's reads of the tile precede its arrival
    if (lane == 0) repro::mbar_arrive(&empty[s]);
    row0 += row_step;
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
  if (!WITH_GRAD) finish_batch();
}

// Above the staged variant's D: a warp a row, eight rows a block, the lanes
// striding over D.
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

// The card's SM count, read at the first staged launch and kept (it sizes
// the grid only; any grid gives the same results).
int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      return 0;
    }
    return n;
  }();
  return count;
}

// Set once for each instantiation: the largest ring's dynamic shared memory,
// and the carveout that lets three blocks' rings share an SM.
template <int OBJ, bool WITH_GRAD>
cudaError_t staged_attributes() {
  static const cudaError_t err = [] {
    const auto kernel = fused_obj_staged_kernel<OBJ, WITH_GRAD>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemPerBlock));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return e;
  }();
  return err;
}

template <int OBJ, bool WITH_GRAD>
int launch_staged(const float* x, float* f, float* g, int N, int D, const Ring& rg,
                  cudaStream_t stream) {
  const cudaError_t err = staged_attributes<OBJ, WITH_GRAD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  int per_sm = kSmemPerSM / (rg.smem + kSmemReserved);
  per_sm = per_sm < 1 ? 1 : (per_sm > kMaxBlocksPerSM ? kMaxBlocksPerSM : per_sm);
  const long long ntiles = (static_cast<long long>(N) + rg.rows - 1) / rg.rows;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(ntiles < resident ? ntiles : resident);
  fused_obj_staged_kernel<OBJ, WITH_GRAD><<<grid, kStagedThreads, rg.smem, stream>>>(
      x, f, g, N, D, rg.rows, rg.stages);
  return static_cast<int>(cudaGetLastError());
}

template <int OBJ, bool WITH_GRAD, int P>
int launch_rows(const float* x, float* f, float* g, int N, int D, cudaStream_t stream) {
  constexpr int kRows = kTileFloats / P;
  const long long blocks = (static_cast<long long>(N) + kRows - 1) / kRows;
  fused_obj_rows_kernel<OBJ, WITH_GRAD, P>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, f, g, N, D);
  return static_cast<int>(cudaGetLastError());
}

template <int OBJ, bool WITH_GRAD>
int launch_layout(const float* x, float* f, float* g, int N, int D, cudaStream_t stream) {
  switch (row_threads(D)) {
    case 1: return launch_rows<OBJ, WITH_GRAD, 1>(x, f, g, N, D, stream);
    case 2: return launch_rows<OBJ, WITH_GRAD, 2>(x, f, g, N, D, stream);
    case 4: return launch_rows<OBJ, WITH_GRAD, 4>(x, f, g, N, D, stream);
    case 8: return launch_rows<OBJ, WITH_GRAD, 8>(x, f, g, N, D, stream);
    case 16: return launch_rows<OBJ, WITH_GRAD, 16>(x, f, g, N, D, stream);
    default: break;
  }
  const Ring rg = ring(D);
  if (rg.stages >= kMinStages) return launch_staged<OBJ, WITH_GRAD>(x, f, g, N, D, rg, stream);
  const long long blocks = (static_cast<long long>(N) + kThreads / kWarp - 1) / (kThreads / kWarp);
  fused_obj_kernel<OBJ, WITH_GRAD>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, f, g, N, D);
  return static_cast<int>(cudaGetLastError());
}

template <int OBJ>
int launch_obj(bool with_grad, const float* x, float* f, float* g, int N, int D,
               cudaStream_t stream) {
  return with_grad ? launch_layout<OBJ, true>(x, f, g, N, D, stream)
                   : launch_layout<OBJ, false>(x, f, g, N, D, stream);
}

// trig_fast_path (objective.cuh) against cosf and sinf on every float t with
// |t| < kTrigFastMax: counts[0] += the cosines that differ in any bit,
// counts[1] += the sines, counts[2] += the floats compared. A check for
// chip_smoke.py; no solve launches it.
__global__ void __launch_bounds__(kThreads)
trig_check_kernel(unsigned long long* counts, unsigned int base) {
  const unsigned int bits = base + blockIdx.x * kThreads + threadIdx.x;
  const float t = __uint_as_float(bits);
  const bool in = fabsf(t) < repro::kTrigFastMax;
  bool cos_differs = false, sin_differs = false;
  if (in) {
    cos_differs = __float_as_uint(repro::trig_fast_path<true>(t)) != __float_as_uint(cosf(t));
    sin_differs = __float_as_uint(repro::trig_fast_path<false>(t)) != __float_as_uint(sinf(t));
  }
  const unsigned int n_cos = __popc(__ballot_sync(repro::kFullMask, cos_differs));
  const unsigned int n_sin = __popc(__ballot_sync(repro::kFullMask, sin_differs));
  const unsigned int n_in = __popc(__ballot_sync(repro::kFullMask, in));
  if (threadIdx.x % kWarp == 0) {
    if (n_cos) atomicAdd(&counts[0], static_cast<unsigned long long>(n_cos));
    if (n_sin) atomicAdd(&counts[1], static_cast<unsigned long long>(n_sin));
    if (n_in) atomicAdd(&counts[2], static_cast<unsigned long long>(n_in));
  }
}

}  // namespace

// x (N, D) -> f (N,) and, when with_grad, g (N, D); all float32, contiguous
// (x at any 4-byte alignment).
extern "C" int fused_obj_launch(int objective, int with_grad, const float* x,
                                float* f, float* g, int N, int D,
                                cudaStream_t stream) {
  if (N <= 0) return 0;
  switch (objective) {
    case kSphere: return launch_obj<kSphere>(with_grad != 0, x, f, g, N, D, stream);
    case kRastrigin: return launch_obj<kRastrigin>(with_grad != 0, x, f, g, N, D, stream);
    case kRosenbrock: return launch_obj<kRosenbrock>(with_grad != 0, x, f, g, N, D, stream);
    case kAckley: return launch_obj<kAckley>(with_grad != 0, x, f, g, N, D, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// counts (3,) uint64, zeroed by the caller: the trig check over all 2^32 bit
// patterns, in four launches of 2^30.
extern "C" int fused_obj_trig_check_launch(unsigned long long* counts, cudaStream_t stream) {
  constexpr unsigned int kChunk = 1u << 30;
  for (unsigned long long base = 0; base < (1ull << 32); base += kChunk) {
    trig_check_kernel<<<kChunk / kThreads, kThreads, 0, stream>>>(
        counts, static_cast<unsigned int>(base));
  }
  return static_cast<int>(cudaGetLastError());
}
