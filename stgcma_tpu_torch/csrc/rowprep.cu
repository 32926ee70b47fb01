// Row prologues of K1-K3 and K7, and the LayerNorm K9: LayerNorm and per-row
// int8 activation quantization.
//
// Replaces, in stgcma_tpu/ops/pallas_attn.py:
//   - K9, the row LayerNorm _ln_kernel (:755) with fp32 statistics and bf16
//     in and out: ln_bf16_kernel computes exactly its function (at Swin's
//     patch-embed, merge and final norms, C = 128..2048, up to 250880 rows);
//   - LN cast to x.dtype before the bf16 qkv product (_win_block_kernel :394-400)
//     and before fc1 (_ffn_kernel :679-684),
//   - LN kept in fp32, then _quant_rows (:1335) before an int8 product
//     (_win_block_q_core :1434-1440, _ffn_q_kernel :1620-1626),
//   - _quant_rows of the bf16 attention output (:1457) and of the fp32 FFN
//     hidden (:1632).
// Bound on the H100: bytes (a row is read a few times from L1 and written
// once; ~1 flop per byte). Design: one warp per row, the row re-read from
// L1/L2 for each pass instead of staged, so any row length is taken.
// Numerics follow the JAX kernels: fp32 mean and centred variance, the
// products and sums rounded one by one (__fmul_rn/__fadd_rn, no contraction),
// scale = max(|x|, 1e-30) * (1/127), q = rint(x * (1/scale)) clamped to +-127
// with a correctly rounded reciprocal and round-half-even (rintf).
#include "common.cuh"

namespace {

__device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load(const float* p) { return *p; }

template <typename T>
struct RowLN {
  const T* x;
  const bf16* g;
  const bf16* b;
  float mean, rstd;

  __device__ __forceinline__ float operator()(int k) const {
    float t = load(x + k);
    if (g == nullptr) return t;
    t = __fmul_rn(__fsub_rn(t, mean), rstd);
    return __fadd_rn(__fmul_rn(t, __bfloat162float(g[k])), __bfloat162float(b[k]));
  }
};

template <typename T>
__device__ __forceinline__ RowLN<T> row_stats(const T* xr, const bf16* g, const bf16* b,
                                              int K, float eps, int lane) {
  RowLN<T> r{xr, g, b, 0.f, 1.f};
  if (g == nullptr) return r;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += load(xr + k);
  r.mean = warp_sum(s) / static_cast<float>(K);
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    float d = __fsub_rn(load(xr + k), r.mean);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  r.rstd = rsqrtf(warp_sum(v) / static_cast<float>(K) + eps);
  return r;
}

__global__ void __launch_bounds__(256) ln_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g, const bf16* __restrict__ b,
    bf16* __restrict__ y, int M, int K, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = static_cast<size_t>(row) * K;
  RowLN<bf16> f = row_stats(x + off, g, b, K, eps, lane);
  for (int k = lane; k < K; k += 32) y[off + k] = __float2bfloat16_rn(f(k));
}

template <typename T>
__global__ void __launch_bounds__(256) quant_rows_kernel(
    const T* __restrict__ x, const bf16* __restrict__ g, const bf16* __restrict__ b,
    int8_t* __restrict__ q, float* __restrict__ sx, int M, int K, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = static_cast<size_t>(row) * K;
  RowLN<T> f = row_stats(x + off, g, b, K, eps, lane);
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(f(k)));
  amax = warp_max(amax);
  const float s = __fmul_rn(fmaxf(amax, 1e-30f), 1.0f / 127.0f);
  const float inv = __frcp_rn(s);
  for (int k = lane; k < K; k += 32) {
    float t = rintf(__fmul_rn(f(k), inv));
    t = fminf(fmaxf(t, -127.f), 127.f);
    q[off + k] = static_cast<int8_t>(__float2int_rn(t));
  }
  if (lane == 0) sx[row] = s;
}

constexpr int kRowsPerBlock = 8;   // 8 warps of 32 threads, one row each

}  // namespace

STG_API int stg_ln_bf16(const void* x, const void* g, const void* b, void* y,
                        int M, int K, float eps, cudaStream_t stream) {
  ln_bf16_kernel<<<ceil_div(M, kRowsPerBlock), 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), M, K, eps);
  return static_cast<int>(cudaGetLastError());
}

STG_API int stg_quant_rows(const void* x, int x_is_f32, const void* g, const void* b,
                           void* q, void* sx, int M, int K, float eps,
                           cudaStream_t stream) {
  const dim3 grid(ceil_div(M, kRowsPerBlock)), block(32 * kRowsPerBlock);
  if (x_is_f32) {
    quant_rows_kernel<float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(b), static_cast<int8_t*>(q),
        static_cast<float*>(sx), M, K, eps);
  } else {
    quant_rows_kernel<bf16><<<grid, block, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(b), static_cast<int8_t*>(q),
        static_cast<float*>(sx), M, K, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
