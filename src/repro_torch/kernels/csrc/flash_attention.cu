// Causal or non-causal GQA attention with an online softmax (flash
// attention): q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> o (B, Sq, H, hd),
// q head h reading kv head h / (H / KV).
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention (:76),
// body _flash_kernel (:30-73). It computes what that kernel computes:
//   - the score q·kᵀ accumulated in fp32 and then multiplied by the scale
//     (never folded into q in bf16);
//   - the causal mask k_pos <= q_pos on absolute positions from 0, masked
//     scores at NEG_INF = -1e30;
//   - the running max m, denominator l and accumulator in fp32, l summed
//     from the fp32 probabilities;
//   - P rounded to v's dtype (bf16) before the P·V product;
//   - the output acc / max(l, 1e-30) in q's dtype;
//   - GQA: q head h reads kv head h / (H / KV);
//   - any Sq, Sk >= 1, ragged edges masked here (rows past Sq are never
//     written, columns past Sk score NEG_INF), on q, k, v in the model's
//     (B, S, H, hd) layout, for hd in 16, 32, 64, 96, 128.
// The bf16 path takes exp as exp2 (ex2.approx) with log2(e) folded into
// the fp32 scale: it scores s·scale·log2(e), keeps m in those units and
// masks at NEG_INF there too, so exp2(s' − m') = exp(s·scale − m) but for
// rounding (on unmasked tiles s·scale' − m' is one fused multiply-add);
// P and l are as above.
//
// Bound on the H100 at the LM prefill shapes: operations. One (b, h) pair
// at Sq = Sk = 2048 does 4·hd FLOPs for each of the ~S²/2 causal (q, k)
// pairs, against one read of q, k, v and one write of o.
//
// Design, bf16 (the serving dtype): wgmma fed by TMA, warp-specialised.
//   - One block per (b·h, 128-row q tile), 384 threads: warpgroup 0 is the
//     producer (one thread issues every TMA copy; setmaxnreg hands its
//     registers to the consumers), warpgroups 1 and 2 are consumers of 64 q
//     rows each. Heads go in groups of about one wave of blocks (132 / 16 =
//     8 heads at S = 2048; fewer where their K and V would pass 16 MB); a
//     group's blocks take its q tiles from the last, the longest under the
//     causal mask, to the first, every head of the group at each tile, so
//     the blocks in flight share K and V through L2 (in a head-fastest
//     order, phi3-mini's 128 heads' 100 MB of K and V stream from device
//     memory once a q tile).
//   - TMA brings Q once and 128-row K and V tiles into a ring of as many
//     stages as fit in shared memory (four at hd <= 96, three at 128), each
//     with a full/empty mbarrier pair, so the next tiles' copies are in
//     flight while the consumers compute. The
//     tensor maps are 4-D, (hd, heads, S, B), built on the host for each
//     call: a box never crosses into the next batch row, and TMA zero-fills
//     rows past S (they still get masked: a zero K row scores 0, not
//     NEG_INF). Rows are 128-byte-swizzled panels of 64 columns (hd 64,
//     128), 64-byte-swizzled panels of 32 (hd 96, 32) or one 32-byte-swizzled
//     panel (hd 16). hd = 96 takes three 32-column panels rather than two
//     64-column ones whose columns 96-127 TMA would zero-fill: the copies
//     into shared memory bound this kernel at the prefill shape, and the
//     zero-fill would add a third to them.
//   - S = Q·Kᵀ is wgmma m64n128k16 with both operands read from shared
//     memory through descriptors, fp32 accumulate. The online softmax runs
//     in registers on the accumulator layout; only tiles that cross the
//     diagonal or the end of k are masked. Tiles wholly above the diagonal
//     are never loaded.
//   - P stays in registers: the accumulator of two neighbouring 8-column
//     blocks is the A fragment of a k16 step, so P is rounded to bf16 in
//     place and fed to wgmma m64n{hd}k16 with A from registers against V in
//     shared memory as the MN-major ("transposed") B operand.
//   - Overlap: a consumer issues tile i's Q·Kᵀ and tile i − 1's P·V
//     together and runs tile i's softmax while the P·V product runs; the
//     two consumers take turns issuing (named barriers), so one's softmax
//     also overlaps the other's products.
//   - O is rounded to bf16 into the warpgroup's own Q rows (free by then) in
//     the tensor map's swizzled layout and written by a TMA store, which
//     drops rows past Sq.
// float32 (the CPU-parity dtype): one block per (b·h, 64-row q tile), four
// threads per q row, plain FMA-free fp32 arithmetic, no TF32, 64-row K and
// V tiles through shared memory, P through shared memory.
#include <cuda.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;  // the float32 path's q and kv tiles
constexpr int kBlockK = 64;

// --------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// --------------------------------------------------------------------------
constexpr int kBM = 128;  // q rows a block, 64 per consumer warpgroup
constexpr int kBN = 128;  // kv rows a tile
constexpr int kThreadsBf16 = 3 * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
// K and V bytes of the heads whose q tiles run together (L2 holds 50 MB)
constexpr long long kGroupBytes = 16ll << 20;

template <int HD>
struct Tiles {
  // columns of a TMA box: 64 (128-byte rows) where they divide hd, else 32
  static constexpr int kPanelCols = HD % 64 == 0 ? 64 : HD >= 32 ? 32 : HD;
  static constexpr int kPanels = (HD + kPanelCols - 1) / kPanelCols;
  static constexpr int kRowBytes = 2 * kPanelCols;  // 128, 64 or 32: the swizzle span
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBytes = kPanels * kBM * kRowBytes;
  static constexpr int kTileBytes = kPanels * kBN * kRowBytes;  // one K or one V tile
  // as many K/V stages as fit, up to 4, beside 1024 bytes of slack to align
  // the tiles to the swizzle's 8-row repeat, Q and 2·kStages + 1 mbarriers
  static constexpr int kStages = std::min(4, (232448 - 1024 - 128 - kQBytes) / (2 * kTileBytes));
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kTileBytes + 128;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// the 16-byte chunk that TMA's swizzle puts chunk `chunk` of row `row` in,
// for rows of kRowBytes starting on a 1024-byte boundary
template <int kRowBytes>
__device__ __forceinline__ int swizzled_chunk(int chunk, int row) {
  if (kRowBytes == 128) return chunk ^ (row & 7);
  if (kRowBytes == 64) return chunk ^ ((row >> 1) & 3);
  return chunk ^ ((row >> 2) & 1);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (HD == 16) repro::wgmma_rs_tb_n16(o, a, desc_v, 1);
  if constexpr (HD == 32) repro::wgmma_rs_tb_n32(o, a, desc_v, 1);
  if constexpr (HD == 64) repro::wgmma_rs_tb_n64(o, a, desc_v, 1);
  if constexpr (HD == 96) repro::wgmma_rs_tb_n96(o, a, desc_v, 1);
  if constexpr (HD == 128) repro::wgmma_rs_tb_n128(o, a, desc_v, 1);
}

// S = Q·Kᵀ for the warpgroup's 64 rows, issued and committed: hd / 16
// k-steps, each 32 bytes further along the swizzled rows (the next panel
// past 64 columns)
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[kBN / 2], uint32_t q_addr,
                                             uint32_t k_addr) {
  using T = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk * 16) % T::kPanelCols * 2;
    const uint32_t panel = (kk * 16) / T::kPanelCols;
    repro::wgmma_ss_n128(
        s, repro::wgmma_desc(q_addr + panel * kBM * T::kRowBytes + col, 16,
                             8 * T::kRowBytes, T::kSwizzle),
        repro::wgmma_desc(k_addr + panel * kBN * T::kRowBytes + col, 16, 8 * T::kRowBytes,
                          T::kSwizzle),
        kk > 0);
  }
  repro::wgmma_commit();
}

// O += P·V, issued and committed: kBN / 16 k-steps of 16 V rows, V the
// MN-major B operand (LBO: the next 64-column panel; SBO: the next 8 rows)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[kBN / 16][4], uint32_t v_addr) {
  using T = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    wgmma_pv<HD>(o, pa[kk],
                 repro::wgmma_desc(v_addr + kk * 16 * T::kRowBytes, kBN * T::kRowBytes,
                                   8 * T::kRowBytes, T::kSwizzle));
  }
  repro::wgmma_commit();
}

// The online softmax of one tile on the accumulator layout: scores scaled
// into log2 units, masked where `masked` (columns past Sk, or above the
// diagonal when causal), the running max m of this thread's two rows
// (shared by the quad), alpha = exp2(m_old − m_new) for the accumulator,
// l rescaled and this thread's share of the new probabilities added; s
// returns the fp32 probabilities. An unmasked tile under a positive scale
// takes the max of the raw scores (the scale keeps their order; the scaled
// max rounds to the max of the scaled scores) and forms s·scale − m in one
// fused multiply-add; any other tile is scaled and masked first. The
// branches are uniform over the tile, and the mask is a select: a branch
// per element would serialise the exponentials.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, bool masked,
                                             int k0, int Sk, int causal, int row_lo, int t) {
  const bool fused = !masked && scale_log2 > 0.0f;
  const float neg_inf = -__int_as_float(0x7f800000);
  float mx[2] = {neg_inf, neg_inf};
  if (fused) {
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  } else {  // the mask is all false on an unmasked tile
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int col = k0 + (e / 4) * 8 + 2 * t + (e & 1);
      const int row = row_lo + 8 * ((e >> 1) & 1);
      const bool out = (col >= Sk) | ((col > row) & (causal != 0));
      s[e] = out ? kNegInf : s[e] * scale_log2;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the quad shares each row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 2));
    if (fused) mx[r] *= scale_log2;
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(fminf(m[r] - m_new, 0.0f));
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];
  }
  if (fused) {
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      s[e] = ex2(__fmaf_rn(s[e], scale_log2, neg_m[(e >> 1) & 1]));
      l[(e >> 1) & 1] += s[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      s[e] = ex2(s[e] + neg_m[(e >> 1) & 1]);
      l[(e >> 1) & 1] += s[e];
    }
  }
}

// P rounded to bf16 (v's dtype): the accumulator of 8-column blocks 2kk and
// 2kk + 1 is the A fragment of k-step kk
__device__ __forceinline__ void probs_to_bf16(const float (&s)[kBN / 2],
                                              uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pa[kk][0] = round_pair(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = round_pair(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = round_pair(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = round_pair(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_o, int Sq, int Sk, int H, int KV,
                  float scale_log2, int causal, int group) {
  using T = Tiles<HD>;
  using namespace repro;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* sKV = sQ + T::kQBytes;  // stage s: K at sKV + 2s·tile, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + T::kStages * 2 * T::kTileBytes);
  uint64_t* empty = full + T::kStages;
  uint64_t* q_full = empty + T::kStages;

  // Block x -> (b·h, q tile): the heads go in groups of `group`, and a
  // group's blocks run its q tiles from the last (the longest under the
  // causal mask) to the first, every head of the group at each tile. The
  // blocks in flight then read the K and V of a few heads, which L2 holds.
  const int n_q = (Sq + kBM - 1) / kBM;
  const int n_bh = gridDim.x / n_q;
  const int gi = blockIdx.x / (group * n_q), idx = blockIdx.x % (group * n_q);
  const int heads = min(group, n_bh - gi * group);
  const int bh = gi * group + idx % heads;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (n_q - 1 - idx / heads) * kBM;
  int n_kv = (Sk + kBN - 1) / kBN;
  if (causal) n_kv = min(n_kv, (q0 + kBM - 1) / kBN + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, T::kQBytes);
      for (int p = 0; p < T::kPanels; ++p) {
        tma_load_4d(sQ + p * kBM * T::kRowBytes, &tm_q, q_full, p * T::kPanelCols, h, q0, b);
      }
      for (int i = 0; i < n_kv; ++i) {
        const int st = i % T::kStages;
        mbar_wait(&empty[st], ((i / T::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * T::kTileBytes);
        unsigned char* sK = sKV + st * 2 * T::kTileBytes;
        unsigned char* sV = sK + T::kTileBytes;
        for (int p = 0; p < T::kPanels; ++p) {
          tma_load_4d(sK + p * kBN * T::kRowBytes, &tm_k, &full[st], p * T::kPanelCols, kvh,
                      i * kBN, b);
          tma_load_4d(sV + p * kBN * T::kRowBytes, &tm_v, &full[st], p * T::kPanelCols, kvh,
                      i * kBN, b);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup cw takes q rows q0 + 64·cw … + 63
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + cw * 64 + warp * 16 + g;  // this thread's rows row_lo, row_lo + 8
  const uint32_t q_addr = smem_addr(sQ) + cw * 64 * T::kRowBytes;
  const uint32_t kv_addr = smem_addr(sKV);
  auto k_tile = [&](int st) { return kv_addr + st * 2 * T::kTileBytes; };
  auto v_tile = [&](int st) { return kv_addr + st * 2 * T::kTileBytes + T::kTileBytes; };
  auto masked = [&](int k0) { return k0 + kBN > Sk || (causal && k0 + kBN - 1 > q0 + cw * 64); };
  // The two consumers take turns on the tensor cores (named barriers 3 and
  // 4): each issues its products for a round, then hands the turn over, so
  // one's softmax runs while the other's products do. Consumer 0 starts.
  const int my_turn = 3 + cw, their_turn = 4 - cw;

  float s[kBN / 2], o[HD / 2], alpha[2];
  uint32_t pa[kBN / 16][4];
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) s[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  if (cw == 1) named_barrier_arrive(3, 256);
  mbar_wait(q_full, 0);

  // round 0: S of tile 0, its softmax
  mbar_wait(&full[0], 0);
  named_barrier(my_turn, 256);
  fence_regs(s);
  wgmma_fence();
  issue_scores<HD>(s, q_addr, k_tile(0));
  named_barrier_arrive(their_turn, 256);
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, m, l, alpha, scale_log2, masked(0), 0, Sk, causal, row_lo, t);
  probs_to_bf16(s, pa);

  // round i: S of tile i and P·V of tile i - 1 together; tile i's softmax
  // runs while the P·V product does
  for (int i = 1; i < n_kv; ++i) {
    const int st = i % T::kStages, prev = (i - 1) % T::kStages;
    mbar_wait(&full[st], (i / T::kStages) & 1);
    named_barrier(my_turn, 256);
    fence_regs(s);
    fence_regs(o);
    wgmma_fence();
    issue_scores<HD>(s, q_addr, k_tile(st));
    issue_pv<HD>(o, pa, v_tile(prev));
    named_barrier_arrive(their_turn, 256);
    wgmma_wait<1>();  // S is in
    fence_regs(s);
    softmax_tile(s, m, l, alpha, scale_log2, masked(i * kBN), i * kBN, Sk, causal, row_lo, t);
    wgmma_wait<0>();  // P·V is in: tile i - 1's stage is free, and so is pa
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
    rescale<HD>(o, alpha);
    probs_to_bf16(s, pa);
  }

  // the last round: P·V of the last tile
  const int last = (n_kv - 1) % T::kStages;
  named_barrier(my_turn, 256);
  fence_regs(o);
  wgmma_fence();
  issue_pv<HD>(o, pa, v_tile(last));
  if (cw == 0) named_barrier_arrive(their_turn, 256);
  wgmma_wait<0>();
  fence_regs(o);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[last]);

  // o / max(l, 1e-30) in bf16 into this warpgroup's Q rows, swizzled as the
  // tensor map lays them out, then one TMA store a panel
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(kFullMask, l[r], 1);
    lt += __shfl_xor_sync(kFullMask, lt, 2);
    denom[r] = fmaxf(lt, 1e-30f);
  }
  unsigned char* sO = sQ + cw * 64 * T::kRowBytes;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const int panel = col / T::kPanelCols, byte = col % T::kPanelCols * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      unsigned char* dst = sO + panel * kBM * T::kRowBytes + row * T::kRowBytes +
                           swizzled_chunk<T::kRowBytes>(byte / 16, row) * 16 + byte % 16;
      *reinterpret_cast<uint32_t*>(dst) =
          round_pair(o[4 * j + 2 * r] / denom[r], o[4 * j + 2 * r + 1] / denom[r]);
    }
  }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (tid == 0) {
    for (int p = 0; p < T::kPanels; ++p) {
      tma_store_4d(&tm_o, sO + p * kBM * T::kRowBytes, p * T::kPanelCols, h, q0 + cw * 64, b);
    }
    bulk_commit();
    bulk_wait_read();
  }
}

// --------------------------------------------------------------------------
// float32: four threads per q row, no tensor cores
// --------------------------------------------------------------------------
constexpr int kThreadsF32 = kBlockQ * 4;

template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int Sq, int Sk, int H, int KV, float scale, int causal) {
  constexpr int LDQ = HD + 1;  // odd stride: the quad's four k rows hit four banks
  constexpr int LDP = kBlockK + 1;
  constexpr int kDims = HD / 4;      // output dims per thread: t, t + 4, …
  constexpr int kCols = kBlockK / 4; // score columns per thread: t, t + 4, …
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBlockQ * LDQ;
  float* Vs = Ks + kBlockK * LDQ;
  float* Ps = Vs + kBlockK * HD;

  const int r = threadIdx.x / 4, t = threadIdx.x % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int row = q0 + r;

  auto load = [&](float* sm, int ld, const float* x, int s0, int S, int NH, int head) {
    for (int i = threadIdx.x; i < kBlockQ * HD; i += blockDim.x) {
      const int rr = i / HD, c = i % HD;
      float val = 0.0f;
      if (s0 + rr < S) val = x[((static_cast<long long>(b) * S + s0 + rr) * NH + head) * HD + c];
      sm[rr * ld + c] = val;
    }
  };
  load(Qs, LDQ, q, q0, Sq, H, h);

  float m = kNegInf, l = 0.0f, acc[kDims];
#pragma unroll
  for (int dd = 0; dd < kDims; ++dd) acc[dd] = 0.0f;

  int n_kv = (Sk + kBlockK - 1) / kBlockK;
  if (causal) n_kv = min(n_kv, (q0 + kBlockQ - 1) / kBlockK + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // done with the previous tiles (and Q is in place)
    load(Ks, LDQ, k, k0, Sk, KV, kvh);
    load(Vs, HD, v, k0, Sk, KV, kvh);
    __syncthreads();

    float sc[kCols], mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int c = t + 4 * jj;
      const float* qr = Qs + r * LDQ;
      const float* kr = Ks + c * LDQ;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
      float val = dot * scale;
      if (k0 + c >= Sk || (causal && k0 + c > row)) val = kNegInf;
      sc[jj] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(fminf(m - m_new, 0.0f));
    float rs = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const float p = expf(sc[jj] - m_new);
      Ps[r * LDP + t + 4 * jj] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(repro::kFullMask, rs, 1);
    rs += __shfl_xor_sync(repro::kFullMask, rs, 2);
    l = l * alpha + rs;
    m = m_new;
    __syncwarp();  // the quad's P row is in shared memory
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc[dd] *= alpha;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = Ps[r * LDP + c];
      const float* vr = Vs + c * HD + t;
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) acc[dd] += p * vr[4 * dd];
    }
  }
  if (row < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* out = o + ((static_cast<long long>(b) * Sq + row) * H + h) * HD + t;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) out[4 * dd] = acc[dd] / denom;
  }
}

// cuTensorMapEncodeTiled is a driver-API function and the libraries are
// linked without libcuda: take it from the runtime's entry-point table.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 4-D map (hd, NH, S, B) of x (B, S, NH, HD) bf16, boxes of one panel
// of columns × `rows` rows of one head and one batch row.
template <int HD>
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* x, int B, int S, int NH,
              int rows) {
  using T = Tiles<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * HD, 2ull * HD * NH, 2ull * HD * NH * S};  // bytes
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kPanelCols), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle swizzle = T::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int H, int KV, float scale, int causal, cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map<HD>(encode, &tm_q, q, B, Sq, H, kBM) ||
      !make_map<HD>(encode, &tm_k, k, B, Sk, KV, kBN) ||
      !make_map<HD>(encode, &tm_v, v, B, Sk, KV, kBN) ||
      !make_map<HD>(encode, &tm_o, o, B, Sq, H, kBM / 2)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Tiles<HD>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_bh = static_cast<long long>(B) * H;
  const long long n_q = (Sq + kBM - 1) / kBM;
  if (n_bh * n_q > 0x7fffffffll) return cudaErrorInvalidValue;
  // heads a group: about one wave of blocks (a block a multiprocessor), and
  // no more than whose K and V fill kGroupBytes
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long wave = std::max(1ll, sms / n_q);
  const long long fit = std::max(1ll, kGroupBytes / (4ll * Sk * HD));
  const int group = static_cast<int>(std::min({n_bh, wave, fit}));
  flash_bf16_kernel<HD><<<static_cast<unsigned>(n_bh * n_q), kThreadsBf16, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, Sq, Sk, H, KV, scale * kLog2e, causal, group);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int is_bf16, const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, int KV, float scale, int causal,
                      cudaStream_t stream) {
  if (is_bf16) return launch_bf16<HD>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, stream);
  const dim3 grid(static_cast<unsigned>(B) * H, (Sq + kBlockQ - 1) / kBlockQ);
  constexpr int smem = (2 * kBlockQ * (HD + 1) + kBlockK * HD + kBlockQ * (kBlockK + 1)) *
                       static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<HD><<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> o (B, Sq, H, hd); all bf16
// (is_bf16 = 1) or all float32, contiguous, 16-byte aligned; H % KV == 0;
// hd one of 16, 32, 64, 96, 128.
extern "C" int flash_attention_launch(int is_bf16, const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq, int Sk, int H,
                                      int KV, int hd, float scale, int causal,
                                      cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_hd<16>(is_bf16, q, k, v, o, B, Sq, Sk, H, KV, scale, causal, stream);
    case 32: return launch_hd<32>(is_bf16, q, k, v, o, B, Sq, Sk, H, KV, scale, causal, stream);
    case 64: return launch_hd<64>(is_bf16, q, k, v, o, B, Sq, Sk, H, KV, scale, causal, stream);
    case 96: return launch_hd<96>(is_bf16, q, k, v, o, B, Sq, Sk, H, KV, scale, causal, stream);
    case 128: return launch_hd<128>(is_bf16, q, k, v, o, B, Sq, Sk, H, KV, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
