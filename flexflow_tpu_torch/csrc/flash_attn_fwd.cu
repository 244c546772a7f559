// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_kernels.py:_flash_fwd
// (body _flash_fwd_kernel). Computes, for q, k, v of shape [BH, S, D]:
//   o   = softmax(q k^T / sqrt(D)) v          (optionally causal), in q's dtype
//   lse = logsumexp of each row of the scores, f32, shape [BH, S]
// Scores, the running max and the running sum are f32.
//
// What bounds it on an H100 SXM: at the serving shape (BH = 128, S = 512,
// D = 64, bf16, non-causal) the call moves 33.8 MB (q, k, v, o and lse
// once each: ~10 us at 3.35 TB/s) and does 4*BH*S^2*D = 8.6 GFLOP (~8.7 us
// at 989 TFLOP/s dense bf16), so it sits on the memory side of the ridge,
// close to it. The design keeps the S x S scores out of device memory
// altogether: each CTA owns one (batch*head, 64-row query tile), keeps its
// Q fragments and O accumulators in registers, and streams K/V through
// shared memory in 64-row tiles with the FlashAttention-2 online-softmax
// rescale, so device memory sees each input once per query tile and the
// sequence length is not bounded by shared memory. The TPU kernel instead
// held all of K/V resident in VMEM for each 128-row Q block; that does not
// fit the 227 KB a CTA may use and is not carried over.
//
// bf16: four warps, 16 query rows each, on mma.sync m16n8k16 (bf16 in,
// f32 accumulate). The score accumulators of Q K^T are re-packed in
// registers as the A operand of P V (their register layouts coincide), so
// P never touches shared memory. V is stored transposed in shared memory
// so that the B fragments of P V are single 32-bit loads; rows are padded
// by 8 elements so the fragment loads are free of bank conflicts.
// f32: a simple FMA kernel, four threads per query row, each owning a
// quarter of the head dimension. It serves allow_mixed_precision=False on
// the card; the serving path runs bf16.
//
// Simple and correct first: wgmma, TMA and warp specialisation are for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- bf16 tensor-core kernel ------------------------------------------------
constexpr int kBlockM = 64;  // query rows per CTA: 4 warps x 16 rows
constexpr int kBlockN = 64;  // key/value rows per shared-memory tile
constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of mma.m16n8k16 for lane = 4*g + t:
//   A (16x16, row-major): {row g, cols 2t..2t+1}, {row g+8, cols 2t..},
//                         {row g, cols 2t+8..}, {row g+8, cols 2t+8..}
//   B (16x8, k x n):      {k 2t..2t+1, col g}, {k 2t+8..2t+9, col g}
//   C (16x8):             {row g, cols 2t, 2t+1}, {row g+8, cols 2t, 2t+1}
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int S, float scale_log2, int causal) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt[D][kBlockN + kPad];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  // this thread's two query rows: r0 and r0 + 8
  const int r0 = m0 + warp * 16 + g;
  const bool row0 = r0 < S, row1 = r0 + 8 < S;

  // Q fragments (A operand of Q K^T), held in registers for the whole loop
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = row0 ? ld32(qb + static_cast<size_t>(r0) * D + c) : 0u;
    qf[kk][1] = row1 ? ld32(qb + static_cast<size_t>(r0 + 8) * D + c) : 0u;
    qf[kk][2] = row0 ? ld32(qb + static_cast<size_t>(r0) * D + c + 8) : 0u;
    qf[kk][3] = row1 ? ld32(qb + static_cast<size_t>(r0 + 8) * D + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // running max (log2 domain) and this thread's share of the running sum
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // causal: tiles past this query tile's last row are fully masked
  const int kv_end = causal ? min(S, m0 + kBlockM) : S;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kChunks = kBlockN * D / 8;  // 16-byte chunks per tile
    // K row-major: consecutive threads read consecutive chunks of a row
    for (int ch = tid; ch < kChunks; ch += kThreads) {
      const int r = ch / (D / 8), c = (ch % (D / 8)) * 8;
      uint4 k4 = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < S)
        k4 = *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(n0 + r) * D + c);
      *reinterpret_cast<uint4*>(&ks[r][c]) = k4;
    }
    // V transposed: consecutive threads take consecutive rows of one
    // 8-column chunk, so the 2-byte transposed stores are contiguous
    for (int ch = tid; ch < kChunks; ch += kThreads) {
      const int r = ch % kBlockN, c = (ch / kBlockN) * 8;
      uint4 v4 = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < S)
        v4 = *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(n0 + r) * D + c);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v4);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[c + i][r] = ve[i];
    }
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale into the log2 domain, mask, and reduce the tile's row maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int row = r0 + (e >> 1) * 8;
        float x = s[nt][e] * scale_log2;
        if (col >= S || (causal && col > row)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      // a row with no visible key yet keeps exponent base 0: exp2(-inf) = 0
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[h] - m_use[h]);
      m_run[h] = m_new;
      l_run[h] *= alpha;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * h] *= alpha;
        acc[dt][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // O += P V, with P re-packed from the score accumulators
#pragma unroll
    for (int jj = 0; jj < kBlockN / 16; ++jj) {
      const uint32_t pa[4] = {pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                              pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                              pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                              pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = &vt[dt * 8 + g][jj * 16 + 2 * t];
        mma_16816(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // the four threads of a row group hold disjoint parts of the row sums
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  __nv_bfloat16* ob = o + base;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (row0)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * D + c) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0 + 8) * D + c) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (t == 0) {
    float* lb = lse + static_cast<size_t>(bh) * S;
    if (row0) lb[r0] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (row1) lb[r0 + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

// ---- f32 FMA kernel -------------------------------------------------------------
constexpr int kRowsF32 = 64;   // query rows per CTA
constexpr int kTileF32 = 32;   // key/value rows per shared-memory tile
constexpr int kPartsF32 = 4;   // threads per query row
constexpr int kThreadsF32 = kRowsF32 * kPartsF32;

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int S, float scale_log2, int causal) {
  constexpr int kSlice = D / kPartsF32;  // element i <-> column i*4 + part
  __shared__ float ks[kTileF32][D];
  __shared__ float vs[kTileF32][D];

  const int tid = threadIdx.x;
  const int part = tid % kPartsF32;
  const int m0 = blockIdx.x * kRowsF32;
  const int row = m0 + tid / kPartsF32;
  const bool live = row < S;
  const int bh = blockIdx.y;
  const size_t base = static_cast<size_t>(bh) * S * D;

  float qr[kSlice], acc[kSlice];
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    qr[i] = live ? q[base + static_cast<size_t>(row) * D + i * kPartsF32 + part] : 0.f;
    acc[i] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  const int kv_end = causal ? min(S, m0 + kRowsF32) : S;
  for (int n0 = 0; n0 < kv_end; n0 += kTileF32) {
    __syncthreads();
    for (int idx = tid; idx < kTileF32 * D; idx += kThreadsF32) {
      const int r = idx / D, c = idx % D;
      const bool in = n0 + r < S;
      const size_t off = base + static_cast<size_t>(n0 + r) * D + c;
      ks[r][c] = in ? k[off] : 0.f;
      vs[r][c] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float s[kTileF32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) dot = fmaf(qr[i], ks[j][i * kPartsF32 + part], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int col = n0 + j;
      float x = dot * scale_log2;
      if (col >= S || (causal && col > row)) x = -INFINITY;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m_run, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_run - m_use);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      const float p = exp2f(s[j] - m_use);
      l_run += p;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) acc[i] = fmaf(p, vs[j][i * kPartsF32 + part], acc[i]);
    }
  }

  if (live) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int i = 0; i < kSlice; ++i)
      o[base + static_cast<size_t>(row) * D + i * kPartsF32 + part] = acc[i] * inv;
    if (part == 0) lse[static_cast<size_t>(bh) * S + row] = (m_run + log2f(l_run)) * kLn2;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int bh, int s, int is_bf16, int causal, cudaStream_t stream) {
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  if (is_bf16) {
    const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
    flash_fwd_bf16<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, s,
        scale_log2, causal);
  } else {
    const dim3 grid((s + kRowsF32 - 1) / kRowsF32, bh);
    flash_fwd_f32<D><<<grid, kThreadsF32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, s, scale_log2, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous, bf16 (is_bf16 = 1) or f32 (is_bf16 = 0);
// lse: [bh, s] f32. Launches on `stream` and returns the CUDA error code of
// the launch (0 = cudaSuccess); does not synchronise.
extern "C" int ff_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int bh, int s, int d, int is_bf16,
                                 int causal, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, l, bh, s, is_bf16, causal, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, l, bh, s, is_bf16, causal, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
