// Causal or non-causal GQA attention with an online softmax (flash
// attention): q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> o (B, Sq, H, hd),
// q head h reading kv head h / (H / KV).
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention (:76),
// body _flash_kernel (:30). It computes what that kernel computes: the
// score q·kᵀ in fp32, times the scale; the causal mask k_pos <= q_pos on
// absolute indices from 0, masked scores at NEG_INF = -1e30; the running
// max m, denominator l and accumulator in fp32, l summed from the fp32
// probabilities; P cast to v's dtype before the P·V product; and the output
// acc / max(l, 1e-30) in q's dtype.
//
// Bound on the H100 at the LM prefill shapes: operations. One (b, h) pair
// at Sq = Sk = 2048 does 4·hd FLOPs for each of the ~S²/2 causal (q, k)
// pairs, against one read of q, k, v and one write of o.
//
// Design (the simple one; wgmma, TMA and warp specialisation are later
// work): one block per (b·h, 64-row q tile); the TPU's sequential KV grid
// axis becomes a loop inside the block, which stages 64-row K and V tiles
// through shared memory and carries (m, l, acc) in registers.
//   bf16: four warps, 16 q rows each, on mma.sync m16n8k16 (bf16 in, fp32
//   accumulate). The score fragments of two neighbouring n-tiles are the
//   A fragment of the P·V product, so P never leaves the registers.
//   float32 (the CPU-parity dtype): plain FMA-free fp32 arithmetic, no
//   TF32; four threads per q row, P through shared memory.
// Ragged lengths are masked here (padded q rows are never written, padded
// k columns score NEG_INF), so any Sq, Sk ≥ 1 works. With the causal mask
// the loop stops at the q tile's last row: a KV tile wholly above the
// diagonal adds exp(NEG_INF - m) = 0 and leaves m as it is. Blocks take
// the q tiles from the last, the longest, to the first.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

// --------------------------------------------------------------------------
// bf16: mma.sync tiles
// --------------------------------------------------------------------------
constexpr int kWarpsBf16 = kBlockQ / 16;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 from consecutive addresses, the lower address in the low half
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  return pack_pair(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Rows s0 … s0+63 of head `head` of x (B, S, NH, HD) into sm (64 rows of
// stride LD), 16 bytes a thread at a time; rows past S are zeros.
template <int HD, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* sm, const __nv_bfloat16* x,
                                               int b, int s0, int S, int NH, int head) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < kBlockQ * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + r < S) {
      const long long row = (static_cast<long long>(b) * S + s0 + r) * NH + head;
      val = *reinterpret_cast<const uint4*>(x + row * HD + c * 8);
    }
    *reinterpret_cast<uint4*>(sm + r * LD + c * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kWarpsBf16 * repro::kWarp)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  int Sq, int Sk, int H, int KV, float scale, int causal) {
  constexpr int LD = HD + 8;  // bf16 elements; rows stay 16-byte aligned
  constexpr int kSteps = HD / 16;
  constexpr int kScoreTiles = kBlockK / 8;
  constexpr int kOutTiles = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * LD;
  __nv_bfloat16* Vs = Ks + kBlockK * LD;

  const int warp = threadIdx.x / repro::kWarp, lane = threadIdx.x % repro::kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;

  load_tile_bf16<HD, LD>(Qs, q, b, q0, Sq, H, h);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const __nv_bfloat16* base = Qs + kk * 16 + 2 * t;
    qf[kk][0] = ld_pair(base + r0 * LD);
    qf[kk][1] = ld_pair(base + (r0 + 8) * LD);
    qf[kk][2] = ld_pair(base + r0 * LD + 8);
    qf[kk][3] = ld_pair(base + (r0 + 8) * LD + 8);
  }

  const int row[2] = {q0 + r0, q0 + r0 + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kOutTiles][4];
#pragma unroll
  for (int nd = 0; nd < kOutTiles; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;

  int n_kv = (Sk + kBlockK - 1) / kBlockK;
  if (causal) n_kv = min(n_kv, (q0 + kBlockQ - 1) / kBlockK + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile_bf16<HD, LD>(Ks, k, b, k0, Sk, KV, kvh);
    load_tile_bf16<HD, LD>(Vs, v, b, k0, Sk, KV, kvh);
    __syncthreads();

    float s[kScoreTiles][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      const __nv_bfloat16* kr = Ks + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        mma_16816(s[n], qf[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
      }
    }

    // scale, mask, running max over the quad that shares each row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        float val = s[n][e] * scale;
        if (col >= Sk || (causal && col > row[e >> 1])) val = kNegInf;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], m_new[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(repro::kFullMask, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(repro::kFullMask, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(fminf(m[i] - m_new[i], 0.0f));
    }
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_new[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(repro::kFullMask, rs[i], 1);
      rs[i] += __shfl_xor_sync(repro::kFullMask, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int nd = 0; nd < kOutTiles; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // acc += P·V, 16 kv positions a step: score tiles 2j and 2j + 1 are
    // the A fragment (P rounded to bf16, v's dtype)
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t a[4] = {round_pair(s[2 * j][0], s[2 * j][1]),
                             round_pair(s[2 * j][2], s[2 * j][3]),
                             round_pair(s[2 * j + 1][0], s[2 * j + 1][1]),
                             round_pair(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vb = Vs + (16 * j + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < kOutTiles; ++nd) {
        const __nv_bfloat16* vc = vb + nd * 8;
        mma_16816(acc[nd], a, pack_pair(vc[0], vc[LD]), pack_pair(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* out = o + ((static_cast<long long>(b) * Sq + row[i]) * H + h) * HD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kOutTiles; ++nd) {
      *reinterpret_cast<uint32_t*>(out + nd * 8) =
          round_pair(acc[nd][2 * i] / denom, acc[nd][2 * i + 1] / denom);
    }
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

template <int HD>
cudaError_t launch_hd(int is_bf16, const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, int KV, float scale, int causal,
                      cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(B) * H, (Sq + kBlockQ - 1) / kBlockQ);
  if (is_bf16) {
    constexpr int smem = 3 * kBlockQ * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16));
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bf16_kernel<HD><<<grid, kWarpsBf16 * repro::kWarp, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        Sq, Sk, H, KV, scale, causal);
  } else {
    constexpr int smem = (2 * kBlockQ * (HD + 1) + kBlockK * HD + kBlockQ * (kBlockK + 1)) *
                         static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_f32_kernel<HD><<<grid, kThreadsF32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV, scale, causal);
  }
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
