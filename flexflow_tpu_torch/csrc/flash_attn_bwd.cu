// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels flexflow_tpu/ops/pallas_kernels.py:_flash_bwd
// (body _flash_bwd_kernel, S <= 1024) and :_flash_bwd_blocked (body
// _flash_bwd_blocked_kernel, 1024 < S <= 16384) with one backward that
// takes any S. For q, k, v, dO of shape [BH, S, D], the forward's lse
// [BH, S], delta = rowsum(dO * O) [BH, S] (formed by the caller) and an
// optional upstream lse gradient g_lse [BH, S] (null = zero):
//   P  = exp(q k^T / sqrt(D) - lse)            (recomputed, never stored)
//   dV = P^T dO
//   dS = P * (dO V^T - delta + g_lse)
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)
// dq, dk, dv come out in the inputs' dtype; every sum is f32.
//
// What bounds it on an H100 SXM: at the training shape (BH = 128, S = 512,
// D = 64, bf16, non-causal) it moves 67.6 MB (q, k, v, o, dO read and dq,
// dk, dv written once each, plus lse and delta: ~20 us at 3.35 TB/s) and
// does 5 products of 2*S^2*D a head = 21.5 GFLOP (~22 us at 989 TFLOP/s
// dense bf16); at S = 2048 the FLOPs grow 4x per head and bound it. So it
// sits at the ridge or above it: the tensor cores are what it must keep
// busy. The TPU kernels held whole [S, D] panels in VMEM (one grid cell per
// batch*head) and the blocked one carried dQ across its in-order grid; a
// CTA has at most 227 KB of shared memory and CTAs run in no order, so
// neither carries over. The design here is two kernels, deterministic and
// free of atomics:
//   dK/dV kernel: one CTA per (batch*head, 64-row K/V tile); K and V stay
//     in shared memory, Q and dO stream through it tile by tile (row-major
//     and transposed copies, for the two kinds of B operand), P and dS are
//     recomputed per tile and dK, dV accumulate in registers.
//   dQ kernel: one CTA per (batch*head, 64-row Q tile); Q and dO fragments
//     stay in registers, K (row-major and transposed) and V stream through
//     shared memory, and dQ accumulates in registers.
// P is recomputed twice, once per kernel; nothing is accumulated across
// CTAs. Causal runs skip the tiles on the masked side of the diagonal and
// the ragged last tile is masked, so S has no limit.
//
// bf16: four warps, 16 rows each, on mma.sync m16n8k16 (bf16 in, f32
// accumulate). The accumulators of one product are re-packed in registers
// as the A operand of the next (P^T and dS^T in the dK/dV kernel, dS in
// the dQ kernel), so P and dS never touch shared or device memory. Shared
// rows are padded by 8 elements so fragment loads are free of bank
// conflicts. f32: simple FMA kernels, four threads per row, for
// allow_mixed_precision=False on the card.
//
// Simple and correct first: wgmma, TMA, cp.async pipelining and a fused
// single-kernel backward are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// ---- bf16 tensor-core kernels ---------------------------------------------------
constexpr int kThreads = 128;  // 4 warps
constexpr int kTileRows = 64;  // rows a CTA owns: 4 warps x 16
constexpr int kPad = 8;        // bf16 elements of padding per shared-memory row

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major) from a shared-memory tile with row stride
// `ld`: rows r and r + 8, columns c..c+1 and c+8..c+9 (r = 16-row base + g,
// c = 16-column base + 2t).
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* tile, int ld,
                                    int r, int c) {
  a[0] = ld32(tile + r * ld + c);
  a[1] = ld32(tile + (r + 8) * ld + c);
  a[2] = ld32(tile + r * ld + c + 8);
  a[3] = ld32(tile + (r + 8) * ld + c + 8);
}

// The C fragments of two adjacent 16x8 products, rounded to bf16 as the A
// fragment of a 16x16 chunk along their column axis (the layouts coincide).
__device__ __forceinline__ void repack(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [r0, r0 + ROWS) of a [S, D] panel into shared memory: row-major with
// stride D + kPad (if `rm`), and/or transposed, [D][ROWS + kPad] (if `tr`).
// Rows past S are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int r0, int S,
                                          bf16* rm, bf16* tr) {
  constexpr int kChunks = ROWS * D / 8;  // 16-byte chunks
  for (int ch = threadIdx.x; ch < kChunks; ch += kThreads) {
    const int r = ch / (D / 8), c = (ch % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    if (rm) *reinterpret_cast<uint4*>(rm + r * (D + kPad) + c) = x;
    if (tr) {
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(c + i) * (ROWS + kPad) + r] = e[i];
    }
  }
}

// lse in the log2 domain, and delta - g_lse, of row i (0 past S).
__device__ __forceinline__ float lse2_of(const float* lse, int i, int S) {
  return i < S ? lse[i] * kLog2e : 0.f;
}
__device__ __forceinline__ float dlt_of(const float* delta, const float* glse, int i,
                                        int S) {
  if (i >= S) return 0.f;
  return glse ? delta[i] - glse[i] : delta[i];
}

template <int D, int BR>
constexpr int dkdv_smem_bytes() {
  return (2 * kTileRows * (D + kPad) + 2 * BR * (D + kPad) + 2 * D * (BR + kPad)) *
             static_cast<int>(sizeof(bf16)) +
         2 * BR * static_cast<int>(sizeof(float));
}

// dK, dV of one (batch*head, 64-row K/V tile); Q/dO stream in BR-row tiles.
// Fragment layout of mma.m16n8k16 for lane = 4*g + t: see flash_attn_fwd.cu.
template <int D, int BR>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ glse, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int S, float scale, int causal) {
  constexpr int LD = D + kPad;   // row-major stride
  constexpr int LT = BR + kPad;  // transposed stride
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* vs = ks + kTileRows * LD;            // [64][LD]
  bf16* qs = vs + kTileRows * LD;            // [BR][LD]
  bf16* qt = qs + BR * LD;                   // [D][LT]
  bf16* dos = qt + D * LT;                   // dO, [BR][LD]
  bf16* dot = dos + BR * LD;                 // dO transposed, [D][LT]
  float* lse2 = reinterpret_cast<float*>(dot + D * LT);  // [BR]
  float* dlt = lse2 + BR;                                 // [BR]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * kTileRows;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* lb = lse + static_cast<size_t>(bh) * S;
  const float* db = delta + static_cast<size_t>(bh) * S;
  const float* gb = glse ? glse + static_cast<size_t>(bh) * S : nullptr;
  // this thread's two K/V rows within the tile, and their sequence index
  const int kr = warp * 16 + g;
  const int kv0 = n0 + kr, kv1 = kv0 + 8;
  const float scale_log2 = scale * kLog2e;

  load_tile<D, kTileRows>(k + base, n0, S, ks, nullptr);
  load_tile<D, kTileRows>(v + base, n0, S, vs, nullptr);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  // causal: query rows before this tile see none of its keys
  const int m_begin = causal ? (n0 / BR) * BR : 0;
  for (int m0 = m_begin; m0 < S; m0 += BR) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D, BR>(q + base, m0, S, qs, qt);
    load_tile<D, BR>(dout + base, m0, S, dos, dot);
    for (int i = tid; i < BR; i += kThreads) {
      lse2[i] = lse2_of(lb, m0 + i, S);
      dlt[i] = dlt_of(db, gb, m0 + i, S);
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 K/V rows x BR queries
    float st[BR / 8][4], dp[BR / 8][4];
#pragma unroll
    for (int nt = 0; nt < BR / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      lda(ak, ks, LD, kr, kk * 16 + 2 * t);
      lda(av, vs, LD, kr, kk * 16 + 2 * t);
#pragma unroll
      for (int nt = 0; nt < BR / 8; ++nt) {
        const bf16* qr = qs + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(st[nt], ak, ld32(qr), ld32(qr + 8));
        const bf16* dr = dos + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(dp[nt], av, ld32(dr), ld32(dr + 8));
      }
    }

    // P^T from the lse, masked
#pragma unroll
    for (int nt = 0; nt < BR / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int qi = m0 + col;
        const int kv = (e >> 1) ? kv1 : kv0;
        const bool masked = qi >= S || (causal && kv > qi);
        st[nt][e] = masked ? 0.f : exp2f(st[nt][e] * scale_log2 - lse2[col]);
      }
    }
    // dV += P^T dO, with B from the transposed dO tile
#pragma unroll
    for (int jj = 0; jj < BR / 16; ++jj) {
      uint32_t ap[4];
      repack(ap, st[2 * jj], st[2 * jj + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const bf16* dr = dot + (j * 8 + g) * LT + jj * 16 + 2 * t;
        mma_16816(dva[j], ap, ld32(dr), ld32(dr + 8));
      }
    }
    // dS^T = P^T * (dP^T - (delta - g_lse)), in place of P^T
#pragma unroll
    for (int nt = 0; nt < BR / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] *= dp[nt][e] - dlt[nt * 8 + 2 * t + (e & 1)];
    // dK += dS^T Q, with B from the transposed Q tile
#pragma unroll
    for (int jj = 0; jj < BR / 16; ++jj) {
      uint32_t as[4];
      repack(as, st[2 * jj], st[2 * jj + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const bf16* qr = qt + (j * 8 + g) * LT + jj * 16 + 2 * t;
        mma_16816(dka[j], as, ld32(qr), ld32(qr + 8));
      }
    }
  }

  bf16* dkb = dk + base;
  bf16* dvb = dv + base;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (kv0 < S) {
      *reinterpret_cast<uint32_t*>(dkb + static_cast<size_t>(kv0) * D + c) =
          pack_bf16(dka[j][0] * scale, dka[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + static_cast<size_t>(kv0) * D + c) =
          pack_bf16(dva[j][0], dva[j][1]);
    }
    if (kv1 < S) {
      *reinterpret_cast<uint32_t*>(dkb + static_cast<size_t>(kv1) * D + c) =
          pack_bf16(dka[j][2] * scale, dka[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + static_cast<size_t>(kv1) * D + c) =
          pack_bf16(dva[j][2], dva[j][3]);
    }
  }
}

// dQ of one (batch*head, 64-row Q tile); K/V stream in BC-row tiles.
template <int D, int BC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ glse, bf16* __restrict__ dq, int S,
                      float scale, int causal) {
  __shared__ __align__(16) bf16 ks[BC][D + kPad];
  __shared__ __align__(16) bf16 kt[D][BC + kPad];
  __shared__ __align__(16) bf16 vs[BC][D + kPad];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kTileRows;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const bf16* qb = q + base;
  const bf16* db = dout + base;
  const float* lb = lse + static_cast<size_t>(bh) * S;
  const float* deb = delta + static_cast<size_t>(bh) * S;
  const float* gb = glse ? glse + static_cast<size_t>(bh) * S : nullptr;
  // this thread's two query rows: r0 and r0 + 8
  const int r0 = m0 + warp * 16 + g;
  const bool row0 = r0 < S, row1 = r0 + 8 < S;
  const float scale_log2 = scale * kLog2e;

  // Q and dO fragments (A operands of Q K^T and dO V^T), held for the loop
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const size_t o0 = static_cast<size_t>(r0) * D + c, o1 = o0 + 8 * D;
    qf[kk][0] = row0 ? ld32(qb + o0) : 0u;
    qf[kk][1] = row1 ? ld32(qb + o1) : 0u;
    qf[kk][2] = row0 ? ld32(qb + o0 + 8) : 0u;
    qf[kk][3] = row1 ? ld32(qb + o1 + 8) : 0u;
    df[kk][0] = row0 ? ld32(db + o0) : 0u;
    df[kk][1] = row1 ? ld32(db + o1) : 0u;
    df[kk][2] = row0 ? ld32(db + o0 + 8) : 0u;
    df[kk][3] = row1 ? ld32(db + o1 + 8) : 0u;
  }
  const float l2[2] = {lse2_of(lb, r0, S), lse2_of(lb, r0 + 8, S)};
  const float dl[2] = {dlt_of(deb, gb, r0, S), dlt_of(deb, gb, r0 + 8, S)};

  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  // causal: key tiles past this query tile's last row are fully masked
  const int kv_end = causal ? min(S, m0 + kTileRows) : S;
  for (int n0 = 0; n0 < kv_end; n0 += BC) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, BC>(k + base, n0, S, &ks[0][0], &kt[0][0]);
    load_tile<D, BC>(v + base, n0, S, &vs[0][0], nullptr);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 query rows x BC keys
    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* kr = &ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
        const bf16* vr = &vs[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(dp[nt], df[kk], ld32(vr), ld32(vr + 8));
      }
    }
    // dS = P * (dP - (delta - g_lse)), P recomputed from the lse and masked
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int h = e >> 1;
        const int row = r0 + h * 8;
        const bool masked = col >= S || (causal && col > row);
        const float p = masked ? 0.f : exp2f(s[nt][e] * scale_log2 - l2[h]);
        s[nt][e] = p * (dp[nt][e] - dl[h]);
      }
    }
    // dQ += dS K, with B from the transposed K tile
#pragma unroll
    for (int jj = 0; jj < BC / 16; ++jj) {
      uint32_t as[4];
      repack(as, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const bf16* kr = &kt[j * 8 + g][jj * 16 + 2 * t];
        mma_16816(dqa[j], as, ld32(kr), ld32(kr + 8));
      }
    }
  }

  bf16* dqb = dq + base;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0)
      *reinterpret_cast<uint32_t*>(dqb + static_cast<size_t>(r0) * D + c) =
          pack_bf16(dqa[j][0] * scale, dqa[j][1] * scale);
    if (row1)
      *reinterpret_cast<uint32_t*>(dqb + static_cast<size_t>(r0 + 8) * D + c) =
          pack_bf16(dqa[j][2] * scale, dqa[j][3] * scale);
  }
}

// ---- f32 FMA kernels ------------------------------------------------------------
constexpr int kPartsF32 = 4;   // threads per row; element i <-> column i*4 + part
constexpr int kRowsDkdvF32 = 32;  // K/V rows per dK/dV CTA
constexpr int kRowsDqF32 = 64;    // Q rows per dQ CTA
constexpr int kTileF32 = 32;      // rows per streamed shared-memory tile
constexpr int kThreadsDkdvF32 = kRowsDkdvF32 * kPartsF32;
constexpr int kThreadsDqF32 = kRowsDqF32 * kPartsF32;

// the dot product of one row split over the 4 threads of its group
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreadsDkdvF32)
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ glse, float* __restrict__ dk,
                       float* __restrict__ dv, int S, float scale, int causal) {
  constexpr int kSlice = D / kPartsF32;
  __shared__ float qs[kTileF32][D];
  __shared__ float dos[kTileF32][D];
  __shared__ float lse2[kTileF32], dlt[kTileF32];

  const int tid = threadIdx.x;
  const int part = tid % kPartsF32;
  const int n0 = blockIdx.x * kRowsDkdvF32;
  const int kv = n0 + tid / kPartsF32;
  const bool live = kv < S;
  const int bh = blockIdx.y;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* lb = lse + static_cast<size_t>(bh) * S;
  const float* db = delta + static_cast<size_t>(bh) * S;
  const float* gb = glse ? glse + static_cast<size_t>(bh) * S : nullptr;
  const float scale_log2 = scale * kLog2e;

  float kr[kSlice], vr[kSlice], dka[kSlice], dva[kSlice];
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    const size_t off = base + static_cast<size_t>(kv) * D + i * kPartsF32 + part;
    kr[i] = live ? k[off] : 0.f;
    vr[i] = live ? v[off] : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  const int m_begin = causal ? (n0 / kTileF32) * kTileF32 : 0;
  for (int m0 = m_begin; m0 < S; m0 += kTileF32) {
    __syncthreads();
    for (int idx = tid; idx < kTileF32 * D; idx += kThreadsDkdvF32) {
      const int r = idx / D, c = idx % D;
      const bool in = m0 + r < S;
      const size_t off = base + static_cast<size_t>(m0 + r) * D + c;
      qs[r][c] = in ? q[off] : 0.f;
      dos[r][c] = in ? dout[off] : 0.f;
    }
    for (int i = tid; i < kTileF32; i += kThreadsDkdvF32) {
      lse2[i] = lse2_of(lb, m0 + i, S);
      dlt[i] = dlt_of(db, gb, m0 + i, S);
    }
    __syncthreads();
    for (int j = 0; j < kTileF32; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        s = fmaf(kr[i], qs[j][i * kPartsF32 + part], s);
        dp = fmaf(vr[i], dos[j][i * kPartsF32 + part], dp);
      }
      s = group_sum(s);
      dp = group_sum(dp);
      const int qi = m0 + j;
      const bool masked = qi >= S || (causal && kv > qi);
      const float p = masked ? 0.f : exp2f(s * scale_log2 - lse2[j]);
      const float ds = p * (dp - dlt[j]);
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        dva[i] = fmaf(p, dos[j][i * kPartsF32 + part], dva[i]);
        dka[i] = fmaf(ds, qs[j][i * kPartsF32 + part], dka[i]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const size_t off = base + static_cast<size_t>(kv) * D + i * kPartsF32 + part;
      dk[off] = dka[i] * scale;
      dv[off] = dva[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsDqF32)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ glse, float* __restrict__ dq, int S,
                     float scale, int causal) {
  constexpr int kSlice = D / kPartsF32;
  __shared__ float ks[kTileF32][D];
  __shared__ float vs[kTileF32][D];

  const int tid = threadIdx.x;
  const int part = tid % kPartsF32;
  const int m0 = blockIdx.x * kRowsDqF32;
  const int row = m0 + tid / kPartsF32;
  const bool live = row < S;
  const int bh = blockIdx.y;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* gb = glse ? glse + static_cast<size_t>(bh) * S : nullptr;
  const float l2 = lse2_of(lse + static_cast<size_t>(bh) * S, row, S);
  const float dl = dlt_of(delta + static_cast<size_t>(bh) * S, gb, row, S);
  const float scale_log2 = scale * kLog2e;

  float qr[kSlice], dr[kSlice], dqa[kSlice];
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    const size_t off = base + static_cast<size_t>(row) * D + i * kPartsF32 + part;
    qr[i] = live ? q[off] : 0.f;
    dr[i] = live ? dout[off] : 0.f;
    dqa[i] = 0.f;
  }

  const int kv_end = causal ? min(S, m0 + kRowsDqF32) : S;
  for (int n0 = 0; n0 < kv_end; n0 += kTileF32) {
    __syncthreads();
    for (int idx = tid; idx < kTileF32 * D; idx += kThreadsDqF32) {
      const int r = idx / D, c = idx % D;
      const bool in = n0 + r < S;
      const size_t off = base + static_cast<size_t>(n0 + r) * D + c;
      ks[r][c] = in ? k[off] : 0.f;
      vs[r][c] = in ? v[off] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kTileF32; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        s = fmaf(qr[i], ks[j][i * kPartsF32 + part], s);
        dp = fmaf(dr[i], vs[j][i * kPartsF32 + part], dp);
      }
      s = group_sum(s);
      dp = group_sum(dp);
      const int col = n0 + j;
      const bool masked = col >= S || (causal && col > row);
      const float p = masked ? 0.f : exp2f(s * scale_log2 - l2);
      const float ds = p * (dp - dl);
#pragma unroll
      for (int i = 0; i < kSlice; ++i) dqa[i] = fmaf(ds, ks[j][i * kPartsF32 + part], dqa[i]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kSlice; ++i)
      dq[base + static_cast<size_t>(row) * D + i * kPartsF32 + part] = dqa[i] * scale;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const float* glse, void* dq,
                   void* dk, void* dv, int bh, int s, int is_bf16, int causal,
                   cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaError_t err;
  if (is_bf16) {
    // query rows per step of the dK/dV kernel, key rows per step of the dQ
    // kernel: fewer at D = 128 to keep the accumulators in registers
    constexpr int BR = D == 64 ? 64 : 32;
    constexpr int BC = D == 64 ? 64 : 32;
    constexpr int smem = dkdv_smem_bytes<D, BR>();
    err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<D, BR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s + kTileRows - 1) / kTileRows, bh);
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
    flash_bwd_dkdv_bf16<D, BR><<<grid, kThreads, smem, stream>>>(
        qb, kb, vb, db, lse, delta, glse, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        s, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16<D, BC><<<grid, kThreads, 0, stream>>>(
        qb, kb, vb, db, lse, delta, glse, static_cast<bf16*>(dq), s, scale, causal);
  } else {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
    flash_bwd_dkdv_f32<D><<<dim3((s + kRowsDkdvF32 - 1) / kRowsDkdvF32, bh),
                            kThreadsDkdvF32, 0, stream>>>(
        qf, kf, vf, df, lse, delta, glse, static_cast<float*>(dk), static_cast<float*>(dv),
        s, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32<D><<<dim3((s + kRowsDqF32 - 1) / kRowsDqF32, bh), kThreadsDqF32, 0,
                          stream>>>(qf, kf, vf, df, lse, delta, glse,
                                    static_cast<float*>(dq), s, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [bh, s, d] contiguous, bf16 (is_bf16 = 1) or
// f32 (is_bf16 = 0); lse, delta and glse: [bh, s] f32, glse may be null
// (zero). Launches the dK/dV kernel, then the dQ kernel, on `stream` and
// returns the CUDA error code of the launches (0 = cudaSuccess); does not
// synchronise.
extern "C" int ff_flash_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* glse, void* dq, void* dk, void* dv, int bh,
                                 int s, int d, int is_bf16, int causal, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  const float* gl = static_cast<const float*>(glse);
  switch (d) {
    case 64:
      return static_cast<int>(
          launch<64>(q, k, v, dout, l, de, gl, dq, dk, dv, bh, s, is_bf16, causal, st));
    case 128:
      return static_cast<int>(
          launch<128>(q, k, v, dout, l, de, gl, dq, dk, dv, bh, s, is_bf16, causal, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
