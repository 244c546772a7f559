// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_kernels.py:_flash_fwd
// (launcher at :70, body _flash_fwd_kernel at :46, pallas_call at :77),
// and the forward of flash_attention_lse (:290, the same pallas_call with
// out_dtype=f32), which ring attention merges block by block. Computes, for
// q, k, v of shape [BH, S, D]:
//   o   = softmax(q k^T / sqrt(D)) v          (optionally causal), in q's dtype,
//         or in f32 from bf16 inputs (flash_attention_lse)
//   lse = logsumexp of each row of the scores, f32, shape [BH, S]
// Scores, the running max and the running sum are f32; the f32 output is
// the same accumulator, normalised and stored without rounding to bf16.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): at the
// serving shape (BH 128, S 512, D 64, bf16, non-causal) the call must move
// 33.8 MB (q, k, v read and o, lse written once: 10.1 us) and do
// 4 BH S^2 D = 8.6 GFLOP (8.7 us on the tensor cores), at the ridge; its
// BH S^2 = 33.6 M exponentials take as long again on the special-function
// units (16 a clock an SM, about 3.9 T/s: 8.6 us). So the design keeps the
// S x S scores out of memory and the tensor cores and the exponentials
// fed: a CTA owns one (batch*head, 64-row query tile) and one warpgroup;
// Q stays in shared memory; K and V tiles arrive through a two-stage
// cp.async ring (the backward's, hopper_wgmma.cuh: no tensor maps to encode
// on the host each call as TMA needs, and no warp set aside to produce)
// into 128-byte-swizzled tiles that wgmma reads directly; S = Q K^T is a
// wgmma with both operands K-major from shared memory; each score costs
// one FFMA and one ex2 (masks only on a tile at the diagonal or the
// sequence's end); P is re-packed from the score accumulators as the
// register A operand of O += P V, and V is read MN-major through the
// descriptor's transpose bit, so nothing is transposed or staged. Causal
// runs skip the masked tiles and start the longest rows first.
//
// Chosen on the card (an NVIDIA H100 80GB HBM3 at 700 W; the runs and
// times are in PERF.md): D 64 takes 128-key tiles, two stages and three
// CTAs an SM ("Wide64"), or 64-key tiles at four CTAs an SM ("Narrow64")
// for a grid that four CTAs an SM finish in one wave and three do not (of
// the main paths' shapes, BH 64 at S 512, serving bucket 4: 0.0149 against
// 0.0170 ms); D 128 takes 64-key tiles and two stages. Slower or no faster
// at the main paths' shapes: two or four warpgroups a CTA (with or without
// a ping-pong turn for Q K^T), two 64-row blocks a warpgroup, persistent
// CTAs, a third stage, 32-key tiles, P V issued in parts, and the next
// tile's Q K^T issued before this tile's P V (254 registers at 128-key
// tiles: fewer CTAs an SM). Timing ablations (one part of the loop taken
// out at a time) show no one part dominating: each CTA's serial chain (load, Q K^T, softmax, P V) is long
// against the little work of a 512-key row, and the CTAs on an SM overlap
// it only in part. nvcc -Xptxas -v: Wide64 166 registers, Narrow64 113,
// D 128 165; no spills, no stack; dynamic shared memory 74,752 / 41,984 /
// 82,944 bytes (1 KB of it alignment slack).
//
// f32 o from bf16 inputs (flash_attention_lse): the same kernel with an
// epilogue that stores f32 pairs. At ring attention's step shape (BH 512,
// S 128, D 64) it must move 42.2 MB (q, k, v bf16, o f32, lse: 12.6 us at
// 3.35 TB/s) against 2.1 GFLOP (2.2 us): the bytes bound it, and the f32
// o is 40% of them.
//
// f32 inputs (allow_mixed_precision=False): a simple FMA kernel, four
// threads per query row, each owning a quarter of the head dimension.

#include "hopper_wgmma.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// ---- bf16 kernel: cp.async ring + wgmma -------------------------------------------
// One warpgroup a CTA; its 128 threads also issue the ring's copies, so no
// warp is set aside as a producer.

template <int D, int BN, int STAGES>
constexpr int fwd_smem_bytes() {
  // alignment slack, Q of the CTA's 64 rows, STAGES x {K, V} tiles
  return 1024 + 64 * D * 2 + STAGES * 2 * BN * D * 2;
}

// The running max of one key tile for this thread's rows r0 and r0 + 8. s
// holds the tile's raw scores q.k (64 rows x BN keys; this thread's columns
// col0 + 8j + {0, 1}). MASK: the tile crosses the causal diagonal or the
// end of the sequence, so each score is checked and a masked one set to
// -inf. Updates m (the running max of the raw scores) and gives ms = m
// scale_log2 (0 while a row has seen no key) and alpha, the factor by which
// the row's sum l (rescaled here) and O must be rescaled.
template <bool MASK, int BN>
__device__ __forceinline__ void tile_max(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                         float (&ms)[2], float (&alpha)[2], int r0, int col0,
                                         int S, int causal, float scale_log2) {
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};  // two chains a row
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = (i >> 1) & 1;
    if (MASK) {
      const int col = col0 + 8 * (i >> 2) + (i & 1);
      if (col >= S || (causal && col > r0 + 8 * h)) s[i] = -INFINITY;
    }
    mx[h][i & 1] = fmaxf(mx[h][i & 1], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = fmaxf(mx[h][0], mx[h][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[h], x);
    ms[h] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    alpha[h] = fast_exp2(fmaf(m[h], scale_log2, -ms[h]));
    m[h] = m_new;
    l[h] *= alpha[h];
  }
}

// P = exp2(s scale_log2 - ms) in place of the scores, one FFMA and one ex2
// a score; their sums are added to l.
template <int BN>
__device__ __forceinline__ void tile_exp(float (&s)[BN / 2], const float (&ms)[2],
                                         float (&l)[2], float scale_log2) {
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two partial sums a row
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = fast_exp2(fmaf(s[i], scale_log2, -ms[h]));
    sum[h][i & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] += sum[h][0] + sum[h][1];
}

// Two adjacent output columns of a row, in o's dtype.
__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// o (OutT: bf16, or f32 for flash_attention_lse) and lse of one
// (batch*head, 64-row query tile). Q of the rows stays in
// shared memory; K and V stream through a ring of STAGES stages, each a K
// and a V tile of BN rows. Per key tile: S = Q K^T (wgmma, both operands
// K-major from shared memory), the online softmax in registers, then
// O += P V with P re-packed from the score accumulators as the register A
// operand and V read MN-major through the descriptor's transpose bit.
template <int D, int BN, int STAGES, int MINB, class OutT>
__global__ void __launch_bounds__(128, MINB)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, OutT* __restrict__ o, float* __restrict__ lse,
                   int S, float scale_log2, int causal) {
  constexpr uint32_t kTile = BN * D * 2;  // one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t q_s = smem_u32(sm), ring = q_s + 64 * D * 2;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  // causal: the last tiles have the longest rows; they start first
  const int m0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * 64;
  const size_t pan = static_cast<size_t>(bh) * S * D;
  const int r0 = m0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8

  // causal: key tiles past the CTA's last row are wholly masked
  const int n_tiles = ((causal ? min(S, m0 + 64) : S) + BN - 1) / BN;
  // K and V tiles of key tile `it` in the ring
  auto k_at = [&](int it) { return ring + (it % STAGES) * 2 * kTile; };
  auto v_at = [&](int it) { return k_at(it) + kTile; };
  // copy group i: key tile i's K and V (none past the last); group 0 also
  // holds Q
  auto load_group = [&](int i) {
    if (i < n_tiles) {
      load_tile<D, BN, 128>(k_at(i), k + pan, i * BN, S);
      load_tile<D, BN, 128>(v_at(i), v + pan, i * BN, S);
    }
    cp_async_commit();
  };
  load_tile<D, 64, 128>(q_s, q + pan, m0, S);
  for (int i = 0; i < STAGES - 1; ++i) load_group(i);

  float oa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oa[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    load_group(it + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // copy group `it` has landed
    fence_proxy_async();
    __syncthreads();
    const int n0 = it * BN;
    float s[BN / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_kmajor(q_s, 64, 0, kk), desc_kmajor(k_at(it), BN, 0, kk), kk);
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    float ms[2], alpha[2];
    // only a tile at the diagonal or the sequence's end checks each score
    if (n0 + BN > S || (causal && n0 + BN - 1 > m0))
      tile_max<true, BN>(s, m, l, ms, alpha, r0, n0 + 2 * t, S, causal, scale_log2);
    else
      tile_max<false, BN>(s, m, l, ms, alpha, r0, n0 + 2 * t, S, causal, scale_log2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oa[i] *= alpha[(i >> 1) & 1];
    tile_exp<BN>(s, ms, l, scale_log2);
    uint32_t a[BN / 16][4];
    acc_to_a<BN>(a, s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tb(oa, a[kk], desc_mnmajor(v_at(it), BN, kk));
    wg_commit();
    wg_wait_all();
    reg_fence(oa);
    reg_fence(a);
    __syncthreads();  // every warp is done with the stage before it is refilled
  }
  cp_async_wait<0>();

  OutT* ob = o + pan;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the four threads of a row group hold disjoint parts of the row sums
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = r0 + 8 * h;
    if (row >= S) continue;
    const float inv = 1.f / lt;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(ob + static_cast<size_t>(row) * D + 8 * j + 2 * t, oa[4 * j + 2 * h] * inv,
                 oa[4 * j + 2 * h + 1] * inv);
    if (t == 0) lse[static_cast<size_t>(bh) * S + row] = (m[h] * scale_log2 + log2f(lt)) * kLn2;
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

// The bf16 kernel's configs: BN key rows a ring stage, STAGES ring stages,
// MINB the CTAs an SM that the launch bound asks ptxas to fit (and that the
// shared memory holds). D 64 has two: Wide (128-key tiles, 3 CTAs an SM)
// and Narrow (64-key tiles, 4 CTAs an SM); launch takes Narrow only for a
// grid that 4 CTAs an SM finish in one wave and 3 do not. D 128 has one.
template <int BN_, int STAGES_, int MINB_>
struct FwdConfig {
  static constexpr int BN = BN_, STAGES = STAGES_, MINB = MINB_;
};
typedef FwdConfig<128, 2, 3> Wide64;
typedef FwdConfig<64, 2, 4> Narrow64;
typedef FwdConfig<64, 2, 1> Config128;

template <int D, class C, class OutT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int s, int causal, cudaStream_t stream) {
  const auto kernel = flash_fwd_bf16<D, C::BN, C::STAGES, C::MINB, OutT>;
  constexpr int smem = fwd_smem_bytes<D, C::BN, C::STAGES>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + 63) / 64, bh);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<OutT*>(o), lse, s, kLog2e / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

// The SM count of the device current at the first bf16 D-64 launch, read
// once (the port's nodes hold one kind of card); 0 if the query failed,
// which leaves every grid to Wide64.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

template <int D, class OutT>
cudaError_t launch_bf16_for(const void* q, const void* k, const void* v, void* o, float* lse,
                            int bh, int s, int causal, cudaStream_t stream) {
  if constexpr (D != 64) {
    return launch_bf16<D, Config128, OutT>(q, k, v, o, lse, bh, s, causal, stream);
  } else {
    const long sms = sm_count();
    const long ctas = static_cast<long>(bh) * ((s + 63) / 64);
    if (ctas > Wide64::MINB * sms && ctas <= Narrow64::MINB * sms)
      return launch_bf16<D, Narrow64, OutT>(q, k, v, o, lse, bh, s, causal, stream);
    return launch_bf16<D, Wide64, OutT>(q, k, v, o, lse, bh, s, causal, stream);
  }
}

// io: 0 f32 in and out, 1 bf16 in and out, 2 bf16 in and f32 out
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int bh, int s, int io, int causal, cudaStream_t stream) {
  if (io == 1) return launch_bf16_for<D, bf16>(q, k, v, o, lse, bh, s, causal, stream);
  if (io == 2) return launch_bf16_for<D, float>(q, k, v, o, lse, bh, s, causal, stream);
  const dim3 grid((s + kRowsF32 - 1) / kRowsF32, bh);
  flash_fwd_f32<D><<<grid, kThreadsF32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, s, kLog2e / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous; io names their dtypes: 0 all f32,
// 1 all bf16, 2 q, k, v bf16 and o f32 (flash_attention_lse); lse: [bh, s]
// f32. Launches on `stream` and returns the CUDA error code of the launch
// (0 = cudaSuccess); does not synchronise.
extern "C" int ff_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int bh, int s, int d, int io, int causal,
                                 void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || io < 0 || io > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, l, bh, s, io, causal, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, l, bh, s, io, causal, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
