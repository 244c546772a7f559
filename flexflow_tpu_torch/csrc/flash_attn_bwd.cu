// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels flexflow_tpu/ops/pallas_kernels.py:_flash_bwd
// (body _flash_bwd_kernel, S <= 1024) and :_flash_bwd_blocked (body
// _flash_bwd_blocked_kernel, 1024 < S <= 16384) with one backward that
// takes any S, and forms inside it the delta = rowsum(dO * O) that the JAX
// package forms outside its pallas_call. For q, k, v, o, dO of shape
// [BH, S, D], the forward's lse [BH, S] and an optional upstream lse
// gradient g_lse [BH, S] (null = zero):
//   P  = exp(q k^T / sqrt(D) - lse)            (recomputed, never stored)
//   dV = P^T dO
//   dS = P * (dO V^T - delta + g_lse),  delta = rowsum(dO * O)
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)
// dq, dk, dv come out in the inputs' dtype; every sum is f32; no atomics,
// so every run gives the same bits.
//
// It also replaces the backward of flash_attention_lse (:307-320, the same
// pallas_calls), which ring attention runs on every block: bf16 q, k, v
// beside the f32 o the forward wrote and an f32 dO, with a nonzero g_lse
// (the merge weights are functions of each block's lse). For it (io 2)
// the entry ff_flash_attn_bwd runs flash_bwd_delta_f32 first: it rounds dO to
// bf16 into a scratch copy, because the bf16 kernels take dO as a wgmma
// operand through the byte-copying cp.async ring, which cannot convert;
// and it forms delta - g_lse in f32 from the f32 O and that rounded dO,
// the reference's delta (pallas_kernels.py:148-151) of the dO the products
// see. Then the bf16 dQ kernel (reading that delta - g_lse instead of
// forming it) and the dK/dV kernel run as below. dO's rounding to bf16 is
// the one difference from the plain version (flash_bwd_reference, f32
// throughout): the kernels compute the plain backward of the rounded dO,
// with P and dS rounded to bf16 as operands as in K2/K3. Delta from the f32
// dO instead would not match dP = dO V^T of the rounded dO, and where the
// two cancel (a row of one key: dS = P (dP - delta) = 0) the mismatch would
// be all of dS. The card's checks hold the kernels to the bf16 tolerance,
// 2e-2 of each output's max, as K2/K3.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s), bf16,
// non-causal: at the training shape (BH 128, S 512, D 64) it must move
// 67.4 MB (q, k, v, o, dO read, dq, dk, dv written, lse read once: 20.1 us)
// and do 5 products of 2*S^2*D a head (21.5 GFLOP: 21.7 us), at the
// ridge; in K3's regime (BH 32, S 2048) the same 67.4 MB and 85.9 GFLOP
// (86.9 us): the tensor cores bound it. So the design keeps the tensor
// cores fed: every product is a wgmma, every operand arrives by an
// asynchronous copy, and nothing is transposed or staged through memory.
//
// Two kernels, the dQ kernel first; each CTA is NW warpgroups of 64 rows:
//   dQ kernel: a CTA owns 64*NW query rows; Q and dO stay in shared
//     memory; K and V tiles of BC rows stream through the ring. It first
//     reads O once for its rows, forms delta - g_lse in f32 (four threads
//     a row, summed in a fixed order), writes it to a [BH, S] scratch row,
//     then: S = Q K^T, dP = dO V^T (wgmma, both operands K-major from
//     shared memory), dS = P * (dP - delta + g_lse) in registers, and
//     dQ += dS K with dS as the register A operand and K read MN-major
//     through the descriptor's transpose bit.
//   dK/dV kernel: a CTA owns 64*NW key rows; K and V stay in shared
//     memory; Q, dO tiles of BR rows and their rows' lse and delta - g_lse
//     stream through the ring. S^T = K Q^T and dP^T = V dO^T from shared
//     memory; the accumulator of S^T becomes P^T and then dS^T in
//     registers, each re-packed to bf16 as the register A operand of
//     dV += P^T dO and dK += dS^T Q, with dO and Q read through the
//     transpose bit.
// The ring: all threads issue 16-byte cp.async copies (zero-filled past S)
// into STAGES stages laid out as 128-byte swizzling lays them out, which
// the wgmma descriptors name; tile `it + STAGES - 1` is in flight while
// tile `it` is computed. cp.async needs no tensor maps (no
// cuTensorMapEncodeTiled, no host work per call) and no producer
// warpgroup, so every warp of a CTA computes; with one warpgroup a CTA,
// three CTAs share an SM at D 64 and one's score pass (exp2, masks) runs
// beside another's wgmmas. setmaxnreg has nothing to rebalance without a
// producer warpgroup: a thread may hold up to 255 registers. A tile's
// scores are checked against the causal mask and S only at the diagonal
// or the sequence's end; causal runs skip the tiles on the masked side.
// P is recomputed in both kernels (7 products where a fused kernel with
// atomic dQ needs 5), which keeps the result deterministic.
//
// Chosen on the card (chip_smoke.py's backward phase on an NVIDIA H100
// 80GB HBM3 at 700 W; the times are in PERF.md): one warpgroup a CTA, two
// stages, BC 64, BR 64 at D 64 and 32 at D 128. Two warpgroups a CTA,
// three stages, BR 32 at D 64, and a loop that keeps one tile's
// accumulating products in flight under the next tile's score products
// were slower or no faster: the last needs more registers (fewer CTAs an
// SM) and ptxas serialises its dK/dV wgmmas (C7515). nvcc -Xptxas -v: dQ
// 158 registers at D 64 and 204 at D 128, dK/dV 168 (held there for three
// CTAs an SM; 194 unbounded) and 215; no spills, no stack; dynamic shared
// memory dQ 50,176 / 99,328 bytes and dK/dV 51,200 / 67,072 bytes at
// D 64 / 128 (1 KB of it alignment slack).
//
// f32 inputs (allow_mixed_precision=False): simple FMA kernels, four
// threads a row, behind the small kernel that forms delta - g_lse.

#include "hopper_wgmma.cuh"

namespace {

// ---- bf16 kernels: cp.async ring + wgmma ------------------------------------------
// Each CTA has NW consumer warpgroups of 64 rows; all NW * 128 threads issue
// the ring's copies, so no warpgroup is set aside as a producer.

// dS = P * (dP - (delta - g_lse)) in place of the dQ kernel's scores S
// (64 rows x BC keys): P = exp2(S scale log2(e) - lse log2(e)), one FMA and
// one ex2 a score. This thread holds rows r0 and r0 + 8 (lse and delta in
// l2, dl) and key columns col0 + 8j + {0, 1}. MASK: the tile crosses the
// causal diagonal or the end of the sequence, so each score is checked.
template <bool MASK, int BC>
__device__ __forceinline__ void dq_scores(float (&s)[BC / 2], const float (&dp)[BC / 2],
                                          const float (&l2)[2], const float (&dl)[2], int r0,
                                          int col0, int S, int causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) {
    const int h = (i >> 1) & 1;
    float p = fast_exp2(fmaf(s[i], scale_log2, -l2[h]));
    if (MASK) {
      const int col = col0 + 8 * (i >> 2) + (i & 1);
      if (col >= S || (causal && col > r0 + 8 * h)) p = 0.f;
    }
    s[i] = p * (dp[i] - dl[h]);
  }
}

// P^T in place of the dK/dV kernel's transposed scores S^T (64 keys x BR
// queries) and dS^T = P^T * (dP^T - (delta - g_lse)) in place of dP^T. This
// thread holds key rows kr0 and kr0 + 8 and query columns q0 + 8j + {0, 1},
// whose lse and delta - g_lse it reads from the tile's rows in shared
// memory. MASK as for dq_scores.
template <bool MASK, int BR>
__device__ __forceinline__ void dkdv_scores(float (&pt)[BR / 2], float (&dpt)[BR / 2],
                                            const float* lse_t, const float* dl_t, int t,
                                            int q0, int kr0, int S, int causal,
                                            float scale_log2) {
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(dl_t + 8 * j + 2 * t);
    const float l2[2] = {l.x * kLog2e, l.y * kLog2e}, dl[2] = {d.x, d.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = fast_exp2(fmaf(pt[i], scale_log2, -l2[e & 1]));
      if (MASK) {
        const int qi = q0 + 8 * j + 2 * t + (e & 1), kv = kr0 + 8 * (e >> 1);
        if (qi >= S || (causal && kv > qi)) p = 0.f;
      }
      pt[i] = p;
      dpt[i] = p * (dpt[i] - dl[e & 1]);
    }
  }
}

template <int D, int BC, int NW, int STAGES>
constexpr int dq_smem_bytes() {
  // alignment slack, Q and dO of the CTA's rows, STAGES x {K, V} tiles
  return 1024 + 2 * (64 * NW) * D * 2 + STAGES * 2 * BC * D * 2;
}

// dQ of one (batch*head, 64*NW-row Q tile), launched before the dK/dV
// kernel. It first forms delta - g_lse of its rows, uses it, and writes it
// to `dlt` for the dK/dV kernel; with DLT_IN (flash_attention_lse's
// backward) it reads them from `dlt` instead, and `o` and `glse` are
// unused. Q and dO of the rows stay in shared memory; K and V stream
// through a ring of STAGES tiles of BC rows.
template <int D, int BC, int NW, int STAGES, bool DLT_IN>
__global__ void __launch_bounds__(NW * 128, 1)
    flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ glse, float* __restrict__ dlt,
                      bf16* __restrict__ dq, int S, float scale, int causal) {
  constexpr int NT = NW * 128;
  constexpr int kRows = 64 * NW;
  constexpr uint32_t kPanel = kRows * D * 2;  // Q or dO of the CTA's rows
  constexpr uint32_t kTile = BC * D * 2;      // one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t q_s = smem_u32(sm), do_s = q_s + kPanel, ring = do_s + kPanel;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  // causal: the last tiles have the longest rows; they start first
  const int m0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const size_t pan = static_cast<size_t>(bh) * S * D;
  const size_t rw = static_cast<size_t>(bh) * S;
  const int lr = 64 * wg + 16 * warp + g;  // this thread's rows in the tile: lr, lr + 8
  const int r0 = m0 + lr;
  const float scale_log2 = scale * kLog2e;

  // causal: key tiles past the CTA's last row are wholly masked
  const int kv_end = causal ? min(S, m0 + kRows) : S;
  const int n_tiles = (kv_end + BC - 1) / BC;
  auto load_kv = [&](int it) {
    const uint32_t st = ring + (it % STAGES) * 2 * kTile;
    load_tile<D, BC, NT>(st, k + pan, it * BC, S);
    load_tile<D, BC, NT>(st + kTile, v + pan, it * BC, S);
  };
  load_tile<D, kRows, NT>(q_s, q + pan, m0, S);
  load_tile<D, kRows, NT>(do_s, dout + pan, m0, S);
  cp_async_commit();
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i);
    cp_async_commit();
  }

  float l2[2], dl[2];  // lse (log2 domain) and delta - g_lse of the two rows
  if constexpr (DLT_IN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const bool in = row < S;
      dl[h] = in ? dlt[rw + row] : 0.f;
      l2[h] = in ? lse[rw + row] * kLog2e : 0.f;
    }
  } else {
    // delta - g_lse of rows r0 and r0 + 8: rowsum(dO * O) in f32, each of a
    // quad's four threads over D/4 columns (O from device memory, dO from
    // the tile), then summed across the quad in a fixed order
    constexpr int kQ = D / 32;  // 16-byte chunks a thread reads of a row
    uint4 ov[2][kQ];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        ov[h][j] = r0 + 8 * h < S ? *reinterpret_cast<const uint4*>(
                                        o + pan + static_cast<size_t>(r0 + 8 * h) * D +
                                        (t * kQ + j) * 8)
                                  : make_uint4(0u, 0u, 0u, 0u);
    cp_async_wait<STAGES - 1>();  // Q and dO have landed
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const uint4 dv = *reinterpret_cast<const uint4*>(sm + kPanel +
                                                         swz(kRows, lr + 8 * h, t * kQ + j));
        const bf16* a = reinterpret_cast<const bf16*>(&ov[h][j]);
        const bf16* b = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(a[e]), __bfloat162float(b[e]), acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const int row = r0 + 8 * h;
      const bool in = row < S;
      dl[h] = in ? (glse ? acc - glse[rw + row] : acc) : 0.f;
      l2[h] = in ? lse[rw + row] * kLog2e : 0.f;
      if (t == 0 && in) dlt[rw + row] = dl[h];
    }
  }

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  const int w_last = m0 + 64 * wg + 63;  // this warpgroup's last row
  for (int it = 0; it < n_tiles; ++it) {
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // key tile `it` has landed
    fence_proxy_async();
    __syncthreads();
    const int n0 = it * BC;
    const uint32_t ks = ring + (it % STAGES) * 2 * kTile, vs = ks + kTile;
    // causal: skip a key tile wholly above this warpgroup's rows
    if (!causal || n0 <= w_last) {
      // S = Q K^T and dP = dO V^T: 64 rows x BC keys
      float s[BC / 2], dp[BC / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_kmajor(q_s, kRows, 64 * wg, kk), desc_kmajor(ks, BC, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_kmajor(do_s, kRows, 64 * wg, kk), desc_kmajor(vs, BC, 0, kk), kk);
      wg_commit();
      wg_wait_all();
      reg_fence(s);
      reg_fence(dp);
      // dS = P * (dP - (delta - g_lse)), P recomputed from the lse; only a
      // tile at the diagonal or the sequence's end checks each score
      if (n0 + BC > S || (causal && n0 + BC - 1 > m0 + 64 * wg))
        dq_scores<true, BC>(s, dp, l2, dl, r0, n0 + 2 * t, S, causal, scale_log2);
      else
        dq_scores<false, BC>(s, dp, l2, dl, r0, n0 + 2 * t, S, causal, scale_log2);
      // dQ += dS K: dS from registers, K read through the transpose bit
      uint32_t a[BC / 16][4];
      acc_to_a<BC>(a, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) wgmma_rs_tb(dqa, a[kk], desc_mnmajor(ks, BC, kk));
      wg_commit();
      wg_wait_all();
      reg_fence(dqa);
      reg_fence(a);
    }
    __syncthreads();  // every warpgroup is done with the stage before it is refilled
  }
  cp_async_wait<0>();

  bf16* dqb = dq + pan;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dqb + static_cast<size_t>(r0) * D + c) =
          pack_bf16(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(dqb + static_cast<size_t>(r0 + 8) * D + c) =
          pack_bf16(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
  }
}

template <int D, int BR, int NW, int STAGES>
constexpr int dkdv_smem_bytes() {
  // alignment slack, K and V of the CTA's rows, STAGES x {Q, dO} tiles,
  // STAGES x {lse, delta - g_lse} of a tile's rows
  return 1024 + 2 * (64 * NW) * D * 2 + STAGES * 2 * BR * D * 2 + STAGES * 2 * BR * 4;
}

// dK, dV of one (batch*head, 64*NW-row K/V tile). K and V of the rows stay
// in shared memory; Q, dO and the lse and delta - g_lse of their rows (the
// dQ kernel's `dlt`) stream through a ring of STAGES tiles of BR rows. At
// D 64 the launch bound holds it to 168 registers, so three CTAs share an
// SM (ptxas spills nothing there).
template <int D, int BR, int NW, int STAGES>
__global__ void __launch_bounds__(NW * 128, D == 64 ? 3 : 1)
    flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dlt,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
                        int causal) {
  constexpr int NT = NW * 128;
  constexpr int kRows = 64 * NW;
  constexpr uint32_t kPanel = kRows * D * 2;  // K or V of the CTA's rows
  constexpr uint32_t kTile = BR * D * 2;      // one Q or dO tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t k_s = smem_u32(sm), v_s = k_s + kPanel, ring = v_s + kPanel;
  const uint32_t rows_s = ring + STAGES * 2 * kTile;  // [STAGES][lse, dlt][BR] f32
  const float* rows_f = reinterpret_cast<const float*>(sm + 2 * kPanel + STAGES * 2 * kTile);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * kRows;  // causal: the first tiles do the most work
  const size_t pan = static_cast<size_t>(bh) * S * D;
  const size_t rw = static_cast<size_t>(bh) * S;
  const int w_first = n0 + 64 * wg;               // this warpgroup's first key row
  const int kr0 = w_first + 16 * warp + g;        // this thread's key rows: kr0, kr0 + 8
  const float scale_log2 = scale * kLog2e;

  // causal: query rows before the CTA's first key see none of its keys
  const int m_begin = causal ? (n0 / BR) * BR : 0;
  const int n_tiles = (S - m_begin + BR - 1) / BR;
  auto load_qdo = [&](int it) {
    const int st = it % STAGES, m = m_begin + it * BR;
    load_tile<D, BR, NT>(ring + st * 2 * kTile, q + pan, m, S);
    load_tile<D, BR, NT>(ring + st * 2 * kTile + kTile, dout + pan, m, S);
    load_rows<BR, NT>(rows_s + st * 2 * BR * 4, lse + rw, m, S);
    load_rows<BR, NT>(rows_s + st * 2 * BR * 4 + BR * 4, dlt + rw, m, S);
  };
  load_tile<D, kRows, NT>(k_s, k + pan, n0, S);
  load_tile<D, kRows, NT>(v_s, v + pan, n0, S);
  cp_async_commit();
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_qdo(i);
    cp_async_commit();
  }

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + STAGES - 1 < n_tiles) load_qdo(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // K, V and query tile `it` have landed
    fence_proxy_async();
    __syncthreads();
    const int m0 = m_begin + it * BR, st = it % STAGES;
    const uint32_t qs = ring + st * 2 * kTile, dos = qs + kTile;
    const float* lse_t = rows_f + st * 2 * BR;
    const float* dl_t = lse_t + BR;
    // causal: skip a query tile wholly before this warpgroup's keys
    if (!causal || m0 + BR - 1 >= w_first) {
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BR queries
      float pt[BR / 2], dpt[BR / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(pt, desc_kmajor(k_s, kRows, 64 * wg, kk), desc_kmajor(qs, BR, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, desc_kmajor(v_s, kRows, 64 * wg, kk), desc_kmajor(dos, BR, 0, kk), kk);
      wg_commit();
      wg_wait_all();
      reg_fence(pt);
      reg_fence(dpt);
      // P^T from the lse, dS^T = P^T * (dP^T - (delta - g_lse)); only a
      // tile at the diagonal or the sequence's end checks each score
      if (m0 + BR > S || (causal && w_first + 63 > m0))
        dkdv_scores<true, BR>(pt, dpt, lse_t, dl_t, t, m0, kr0, S, causal, scale_log2);
      else
        dkdv_scores<false, BR>(pt, dpt, lse_t, dl_t, t, m0, kr0, S, causal, scale_log2);
      // dV += P^T dO and dK += dS^T Q: P^T, dS^T from registers, dO and Q
      // read through the transpose bit
      uint32_t ap[BR / 16][4], as[BR / 16][4];
      acc_to_a<BR>(ap, pt);
      acc_to_a<BR>(as, dpt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk) wgmma_rs_tb(dva, ap[kk], desc_mnmajor(dos, BR, kk));
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk) wgmma_rs_tb(dka, as[kk], desc_mnmajor(qs, BR, kk));
      wg_commit();
      wg_wait_all();
      reg_fence(dva);
      reg_fence(dka);
      reg_fence(ap);
      reg_fence(as);
    }
    __syncthreads();  // every warpgroup is done with the stage before it is refilled
  }
  cp_async_wait<0>();

  bf16* dkb = dk + pan;
  bf16* dvb = dv + pan;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = kr0 + 8 * h;
      if (row < S) {
        *reinterpret_cast<uint32_t*>(dkb + static_cast<size_t>(row) * D + c) =
            pack_bf16(dka[4 * j + 2 * h] * scale, dka[4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + static_cast<size_t>(row) * D + c) =
            pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---- f32 FMA kernels, for allow_mixed_precision=False -----------------------------
// They take delta - g_lse (`dlt`) from flash_bwd_delta_f32.

// lse in the log2 domain, and delta - g_lse, of row i (0 past S).
__device__ __forceinline__ float lse2_of(const float* lse, int i, int S) {
  return i < S ? lse[i] * kLog2e : 0.f;
}
__device__ __forceinline__ float dlt_of(const float* dlt, int i, int S) {
  return i < S ? dlt[i] : 0.f;
}

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
                       float* __restrict__ dk, float* __restrict__ dv, int S, float scale,
                       int causal) {
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
      dlt[i] = dlt_of(db, m0 + i, S);
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
                     float* __restrict__ dq, int S, float scale, int causal) {
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
  const float l2 = lse2_of(lse + static_cast<size_t>(bh) * S, row, S);
  const float dl = dlt_of(delta + static_cast<size_t>(bh) * S, row, S);
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

// The two bf16 values packed in u (pack_bf16's layout) as floats.
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// delta - g_lse of every one of `rows` rows from f32 O and dO (for the f32
// kernels, and for flash_attention_lse's backward): rowsum(dO * O), four
// threads a row, each over four columns in every 16 (16-byte loads, a
// warp's neighbouring threads on neighbouring addresses), summed across
// them in a fixed order. With `do16` (flash_attention_lse's backward) it
// writes dO rounded to bf16 there, the operand the bf16 kernels read, and
// forms delta from that rounded dO.
constexpr int kThreadsDeltaF32 = 128;

template <int D>
__global__ void __launch_bounds__(kThreadsDeltaF32)
    flash_bwd_delta_f32(const float* __restrict__ o, const float* __restrict__ dout,
                        const float* __restrict__ glse, float* __restrict__ dlt,
                        bf16* __restrict__ do16, int rows) {
  const int row = blockIdx.x * (kThreadsDeltaF32 / kPartsF32) + threadIdx.x / kPartsF32;
  const int part = threadIdx.x % kPartsF32;
  float acc = 0.f;
  if (row < rows) {
    const size_t base = static_cast<size_t>(row) * D;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const size_t c = base + 16 * i + 4 * part;
      const float4 a = *reinterpret_cast<const float4*>(o + c);
      float4 b = *reinterpret_cast<const float4*>(dout + c);
      if (do16) {
        const uint2 r = make_uint2(pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
        *reinterpret_cast<uint2*>(do16 + c) = r;
        const float2 lo = unpack_bf16(r.x), hi = unpack_bf16(r.y);
        b = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  }
  acc = group_sum(acc);
  if (part == 0 && row < rows) dlt[row] = glse ? acc - glse[row] : acc;
}

// The bf16 kernels' tiles and CTA shape for head dim D: BC key rows a ring
// stage of the dQ kernel, BR query rows a ring stage of the dK/dV kernel,
// NW consumer warpgroups (64 rows each) a CTA, STAGES ring stages.
template <int D>
struct Bf16Config;
template <>
struct Bf16Config<64> {
  static constexpr int BC = 64, BR = 64, NW = 1, STAGES = 2;
};
template <>
struct Bf16Config<128> {
  static constexpr int BC = 64, BR = 32, NW = 1, STAGES = 2;
};

// The bf16 kernels: dQ (forming delta - g_lse into dlt, or with DLT_IN
// reading it from there), then dK/dV.
template <int D, bool DLT_IN>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const void* o, const float* lse, const float* glse, float* dlt,
                        void* dq, void* dk, void* dv, int bh, int s, int causal,
                        cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  typedef Bf16Config<D> C;
  const auto dq_kernel = flash_bwd_dq_bf16<D, C::BC, C::NW, C::STAGES, DLT_IN>;
  const auto dkdv_kernel = flash_bwd_dkdv_bf16<D, C::BR, C::NW, C::STAGES>;
  constexpr int dq_smem = dq_smem_bytes<D, C::BC, C::NW, C::STAGES>();
  constexpr int dkdv_smem = dkdv_smem_bytes<D, C::BR, C::NW, C::STAGES>();
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + 64 * C::NW - 1) / (64 * C::NW), bh);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  // the dQ kernel first: it writes the delta - g_lse that dK/dV reads
  dq_kernel<<<grid, 128 * C::NW, dq_smem, stream>>>(
      qb, kb, vb, static_cast<const bf16*>(o), db, lse, glse, dlt, static_cast<bf16*>(dq),
      s, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, 128 * C::NW, dkdv_smem, stream>>>(
      qb, kb, vb, db, lse, dlt, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, scale,
      causal);
  return cudaGetLastError();
}

// delta - g_lse (and, with do16, dO in bf16) of every row from f32 O and dO
template <int D>
cudaError_t launch_delta(const void* o, const void* dout, const float* glse, float* dlt,
                         void* do16, int rows, cudaStream_t stream) {
  const int rows_per_cta = kThreadsDeltaF32 / kPartsF32;
  flash_bwd_delta_f32<D><<<(rows + rows_per_cta - 1) / rows_per_cta, kThreadsDeltaF32, 0,
                           stream>>>(static_cast<const float*>(o),
                                     static_cast<const float*>(dout), glse, dlt,
                                     static_cast<bf16*>(do16), rows);
  return cudaGetLastError();
}

// io: 0 all f32, 1 all bf16, 2 flash_attention_lse's mix (bf16 q, k, v,
// dq, dk, dv beside f32 O and dO: delta - g_lse and dO in bf16 from the
// f32 O and dO, then the bf16 kernels on that copy of dO)
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* o, const float* lse, const float* glse, float* dlt,
                   void* do16, void* dq, void* dk, void* dv, int bh, int s, int io,
                   int causal, cudaStream_t stream) {
  if (io == 1)
    return launch_bf16<D, false>(q, k, v, dout, o, lse, glse, dlt, dq, dk, dv, bh, s, causal,
                                 stream);
  cudaError_t err = launch_delta<D>(o, dout, glse, dlt, do16, bh * s, stream);
  if (err != cudaSuccess) return err;
  if (io == 2)
    return launch_bf16<D, true>(q, k, v, do16, nullptr, lse, nullptr, dlt, dq, dk, dv, bh, s,
                                causal, stream);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  flash_bwd_dkdv_f32<D><<<dim3((s + kRowsDkdvF32 - 1) / kRowsDkdvF32, bh),
                          kThreadsDkdvF32, 0, stream>>>(
      qf, kf, vf, df, lse, dlt, static_cast<float*>(dk), static_cast<float*>(dv), s,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<D><<<dim3((s + kRowsDqF32 - 1) / kRowsDqF32, bh), kThreadsDqF32, 0,
                        stream>>>(qf, kf, vf, df, lse, dlt, static_cast<float*>(dq), s,
                                  scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dq, dk, dv: [bh, s, d] contiguous, f32 (io 0) or bf16 (io 1,
// 2); dout and o: the same, in q's dtype (io 0, 1) or f32 (io 2,
// flash_attention_lse's backward); lse and glse: [bh, s] f32, glse may be
// null (zero); dlt: [bh, s] f32 scratch, written with delta - g_lse; do16:
// a [bh, s, d] bf16 scratch for io 2, written with dout rounded to bf16,
// and null otherwise. Launches the backward's kernels on `stream` (bf16:
// dQ, then dK/dV; f32: delta, dK/dV, dQ; io 2: delta, dQ, dK/dV) and
// returns the CUDA error code of the launches (0 = cudaSuccess); does not
// synchronise.
extern "C" int ff_flash_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* o,
                                 const void* glse, void* dlt, void* do16, void* dq, void* dk,
                                 void* dv, int bh, int s, int d, int io, int causal,
                                 void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || io < 0 || io > 2 || (io == 2) != (do16 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* gl = static_cast<const float*>(glse);
  float* dl = static_cast<float*>(dlt);
  switch (d) {
    case 64:
      return static_cast<int>(
          launch<64>(q, k, v, dout, o, l, gl, dl, do16, dq, dk, dv, bh, s, io, causal, st));
    case 128:
      return static_cast<int>(
          launch<128>(q, k, v, dout, o, l, gl, dl, do16, dq, dk, dv, bh, s, io, causal, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
