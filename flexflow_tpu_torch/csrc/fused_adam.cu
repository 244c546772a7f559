// Fused multi-tensor Adam update for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/ops/fused_update.py:fused_adam_leaf
// (body _adam_kernel). For every leaf of a list, in place:
//   g' = g + wd * p
//   m' = beta1 * m + (1 - beta1) * g'
//   v' = beta2 * v + (1 - beta2) * g' * g'
//   p' = p - alpha_t * m' / (sqrt(v') + eps)
// with p f32, g f32 or bf16, m and v stored f32 or bf16 and the math in
// f32. The expression, its operand order and every rounding are those of
// the port's plain `_adam_math` (= the JAX package's): each operation is
// an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), so nvcc cannot contract a product into an FMA, and the
// stores round to nearest even. The kernel is bit-equal to the plain
// version on the card.
//
// What bounds it on an H100 SXM: it does ~12 operations per element and
// moves 18 bytes per element (p f32 read and written, g, m, v bf16 read,
// m, v bf16 written): far below the ridge, so device-memory bytes bound
// it. At the BERT-proxy's fused leaves (100.77 M elements) that is
// 1.814 GB, 0.541 ms at 3.35 TB/s. The TPU version launched one
// pallas_call per leaf on a [rows, 128] view that had to be lane-aligned;
// here one launch covers every leaf of the step: a device-side table
// holds each leaf's pointers, size and first chunk, each CTA takes one
// 1024-element chunk of one leaf (found by binary search over the
// table), and any leaf size works (the ragged chunk is masked).
// alpha_t is read from device memory, so the step never syncs the host.
//
// Simple and correct first: vector loads and a persistent grid are for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // elements per CTA
constexpr int kCols = 6;  // table row: p, g, m, v, numel, first chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename G, typename St>
__global__ void __launch_bounds__(kThreads)
    fused_adam(const int64_t* __restrict__ table, int n_leaves,
               const float* __restrict__ alpha_t, float beta1, float one_minus_beta1,
               float beta2, float one_minus_beta2, float eps, float wd) {
  const int64_t chunk = blockIdx.x;
  // the last leaf whose first chunk is at or before this one
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * kCols + 5] <= chunk)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int64_t* row = table + lo * kCols;
  float* p = reinterpret_cast<float*>(row[0]);
  const G* g = reinterpret_cast<const G*>(row[1]);
  St* m = reinterpret_cast<St*>(row[2]);
  St* v = reinterpret_cast<St*>(row[3]);
  const int64_t n = row[4];
  const int64_t start = (chunk - row[5]) * kChunk;
  const float a = *alpha_t;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int64_t idx = start + i * kThreads + threadIdx.x;
    if (idx < n) {
      const float pf = p[idx];
      // _adam_math, operation for operation
      const float gf = __fadd_rn(to_f32(g[idx]), __fmul_rn(wd, pf));
      const float mn =
          __fadd_rn(__fmul_rn(beta1, to_f32(m[idx])), __fmul_rn(one_minus_beta1, gf));
      const float vn = __fadd_rn(__fmul_rn(beta2, to_f32(v[idx])),
                                 __fmul_rn(__fmul_rn(one_minus_beta2, gf), gf));
      p[idx] = __fsub_rn(pf, __fdiv_rn(__fmul_rn(a, mn), __fadd_rn(__fsqrt_rn(vn), eps)));
      m[idx] = from_f32<St>(mn);
      v[idx] = from_f32<St>(vn);
    }
  }
}

template <typename G, typename St>
cudaError_t launch(const int64_t* table, int n_leaves, int64_t n_chunks,
                   const float* alpha_t, float beta1, float one_minus_beta1, float beta2,
                   float one_minus_beta2, float eps, float wd, cudaStream_t stream) {
  fused_adam<G, St><<<static_cast<unsigned>(n_chunks), kThreads, 0, stream>>>(
      table, n_leaves, alpha_t, beta1, one_minus_beta1, beta2, one_minus_beta2, eps, wd);
  return cudaGetLastError();
}

}  // namespace

// Elements per CTA chunk: the caller's table counts chunks in this unit.
extern "C" int ff_fused_adam_chunk() { return kChunk; }

// table: device int64 [n_leaves][6] = (p, g, m, v pointers, numel, first
// chunk), leaves of numel > 0 in order of first chunk; n_chunks: the sum
// of ceil(numel / chunk). alpha_t: a device f32 scalar. p is f32; g is
// bf16 (g_is_bf16 = 1) or f32; m and v are bf16 (state_is_bf16 = 1) or
// f32. Updates p, m, v in place on `stream`; returns the CUDA error code
// of the launch (0 = cudaSuccess); does not synchronise.
extern "C" int ff_fused_adam(const void* table, int n_leaves, long long n_chunks,
                             const void* alpha_t, float beta1, float one_minus_beta1,
                             float beta2, float one_minus_beta2, float eps, float wd,
                             int g_is_bf16, int state_is_bf16, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* t = static_cast<const int64_t*>(table);
  const float* a = static_cast<const float*>(alpha_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (g_is_bf16 && state_is_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(t, n_leaves, n_chunks, a, beta1,
                                               one_minus_beta1, beta2, one_minus_beta2, eps,
                                               wd, st);
  else if (g_is_bf16)
    err = launch<__nv_bfloat16, float>(t, n_leaves, n_chunks, a, beta1, one_minus_beta1,
                                       beta2, one_minus_beta2, eps, wd, st);
  else if (state_is_bf16)
    err = launch<float, __nv_bfloat16>(t, n_leaves, n_chunks, a, beta1, one_minus_beta1,
                                       beta2, one_minus_beta2, eps, wd, st);
  else
    err = launch<float, float>(t, n_leaves, n_chunks, a, beta1, one_minus_beta1, beta2,
                               one_minus_beta2, eps, wd, st);
  return static_cast<int>(err);
}
