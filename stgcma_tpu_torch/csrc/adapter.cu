// K4's adapter products, the two streams of each pair in one launch:
//   hidden: h_s = bf16(gelu(bf16(x_s . W1_s^T + b1_s)))                 (stg_adapter_hidden_pair)
//   output: y_s = bf16(bf16(r1_s + r2_s) + bf16(f_s . W2_s^T + b2_s))   (stg_adapter_out_pair)
// for s = 0 (the video stream, its S_Adapter or S_Adapter2 weights) and s = 1
// (the audio stream, its own adapter), erf-GELU in fp32.
//
// Replaces, inside stgcma_tpu/ops/pallas_swin_block.py _swin_block_kernel
// (:245), the adapter hidden `_ad_h` (:346, :410: acc + bias rounded to bf16
// before the erf-GELU and again after it) and the adapter output added to two
// residuals in JAX's order (:394, :421), the products gemm.cu ran one stream a
// launch before (EPI_BF16_RGELU, EPI_BF16_RES2: same roundings).
// Bound on the H100: bytes. The hidden reads x (M rows of C = 512..1536 a
// stream) for D = 32..96 outputs a row (~2D flops a byte); the output reads the
// D-wide f and both C-wide residuals and writes y (~D / 3 flops a byte).
// Design: a block owns 128 rows (8 warps of 16) of one stream (blockIdx.z) and
// BN columns: the whole width D of the hidden (one column tile), 64 columns of
// the output. A and W come into shared memory 32 deep through a ring of three
// 16-byte cp.async stages (rows padded to 40 bf16, so every ldmatrix is free of
// bank conflicts; K past its end, rows past M and columns past N zero-filled),
// the products on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with ldmatrix
// fragments. The products are thin (k or n = D), so no wgmma tile of 64 x 256
// would fill; what counts is that x and the residuals stream through once.
// The epilogue stages the tile's values in shared memory (over the ring), then
// reads the residuals and writes the output 16 bytes a thread along the rows,
// where the mma fragments would give 4 bytes a thread on 8 rows an instruction.
#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int BM = 16 * kWarps;   // rows a block
constexpr int BKK = 32;           // k a stage
constexpr int LDS = BKK + 8;      // shared row stride (bf16)
constexpr int kStages = 3;
constexpr int kOutCols = 64;      // BN of the output product

enum Epi { EPI_RGELU = 0, EPI_RES2 = 1 };

struct Side {
  const bf16* a;      // (M, K)
  const bf16* w;      // (N, K)
  const bf16* bias;   // (N,)
  const bf16* r1;     // (M, N): EPI_RES2's residuals
  const bf16* r2;
  bf16* out;          // (M, N)
};

__device__ __forceinline__ float erf_gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int BN, int EPI>
__global__ void __launch_bounds__(kWarps * 32) pair_kernel(Side s0, Side s1, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);   // kStages x BM x LDS
  bf16* ws = as + kStages * BM * LDS;             // kStages x BN x LDS
  const bool z = blockIdx.z != 0;
  const bf16* A = z ? s1.a : s0.a;
  const bf16* W = z ? s1.w : s0.w;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int nk = ceil_div(K, BKK);
  auto load = [&](int kc, int stage) {
    const int k0 = kc * BKK;
    bf16* ad = as + stage * BM * LDS;
    bf16* wd = ws + stage * BN * LDS;
    for (int i = threadIdx.x; i < (BM + BN) * (BKK / 8); i += blockDim.x) {
      const int r = i / (BKK / 8), c = (i % (BKK / 8)) * 8;
      if (r < BM) {
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16(ad + r * LDS + c, ok ? A + static_cast<size_t>(m0 + r) * K + k0 + c : A, ok);
      } else {
        const int n = r - BM;
        const bool ok = n0 + n < N && k0 + c < K;
        cp_async16(wd + n * LDS + c, ok ? W + static_cast<size_t>(n0 + n) * K + k0 + c : W, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  float acc[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // matrix l / 8 of an A load: rows + 8 * ((l / 8) & 1), k + 8 * (l / 16): a0..a3;
  // of a W load: rows of n-tile nt + l / 16, k + 8 * ((l / 8) & 1): b0, b1 of two n-tiles
  const int arow = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
  const int wrow = ((lane >> 4) * 8 + (lane & 7)) * LDS + ((lane >> 3) & 1) * 8;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < nk) load(kc + kStages - 1, (kc + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* at = as + (kc % kStages) * BM * LDS;
    const bf16* wt = ws + (kc % kStages) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BKK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, at + arow + kk * 16);
#pragma unroll
      for (int nt = 0; nt < BN / 8; nt += 2) {
        uint32_t b[4];
        ldsm_x4(b, wt + wrow + nt * 8 * LDS + kk * 16);
        mma_bf16(acc[nt], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma_bf16(acc[nt + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                       // every warp is done with the stages

  // the tile's values before the residuals, bf16(acc + b) (RES2) or
  // bf16(gelu(bf16(acc + b))) (RGELU), into shared memory over the stages
  constexpr int LDO = BN + 8;
  bf16* ot = reinterpret_cast<bf16*>(smem_raw);   // BM x LDO
  const bf16* bias = z ? s1.bias : s0.bias;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    const float2 b2 = n0 + c < N
        ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n0 + c))
        : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = __fadd_rn(acc[nt][2 * h], b2.x), v1 = __fadd_rn(acc[nt][2 * h + 1], b2.y);
      if constexpr (EPI == EPI_RGELU) {
        v0 = erf_gelu(bf16_round(v0));
        v1 = erf_gelu(bf16_round(v1));
      }
      *reinterpret_cast<__nv_bfloat162*>(ot + (warp * 16 + g + 8 * h) * LDO + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();

  // the tile's rows, 16 bytes a thread, consecutive threads on consecutive bytes:
  // y = bf16(bf16(r1 + r2) + tile) (RES2), or the tile (RGELU)
  bf16* out = z ? s1.out : s0.out;
  const bf16* r1 = z ? s1.r1 : s0.r1;
  const bf16* r2 = z ? s1.r2 : s0.r2;
  for (int i = threadIdx.x; i < BM * (BN / 8); i += blockDim.x) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;      // N is a multiple of 8: a chunk is in or out
    uint4 y = *reinterpret_cast<const uint4*>(ot + r * LDO + c);
    const size_t off = static_cast<size_t>(m) * N + n;
    if constexpr (EPI == EPI_RES2) {
      const uint4 x1 = __ldg(reinterpret_cast<const uint4*>(r1 + off));
      const uint4 x2 = __ldg(reinterpret_cast<const uint4*>(r2 + off));
      __nv_bfloat162* yh = reinterpret_cast<__nv_bfloat162*>(&y);
      const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&x1);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&x2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(h1[e]), b = __bfloat1622float2(h2[e]);
        const float2 u = __bfloat1622float2(yh[e]);
        yh[e] = __floats2bfloat162_rn(__fadd_rn(bf16_round(__fadd_rn(a.x, b.x)), u.x),
                                      __fadd_rn(bf16_round(__fadd_rn(a.y, b.y)), u.y));
      }
    }
    *reinterpret_cast<uint4*>(out + off) = y;
  }
}

template <int BN, int EPI>
int launch(const Side& s0, const Side& s1, int M, int N, int K, cudaStream_t stream) {
  const int smem = kStages * (BM + BN) * LDS * static_cast<int>(sizeof(bf16));
  auto kernel = pair_kernel<BN, EPI>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(M, BM), ceil_div(N, BN), 2);
  kernel<<<grid, kWarps * 32, smem, stream>>>(s0, s1, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool bad_operands(const Side& s, int M, int N, int K, bool res) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  return M < 1 || K < 8 || K % 8 || N < 8 || N % 8 || misaligned(s.a) || misaligned(s.w) ||
         misaligned(s.out) || s.bias == nullptr ||
         (res && (s.r1 == nullptr || s.r2 == nullptr));
}

}  // namespace

// h_s (M, D) = bf16(gelu(bf16(a_s (M, K) . w_s (D, K)^T + b_s))) for s = 0, 1; all bf16,
// contiguous, 16-byte aligned; K a multiple of 8; D in {16, 32, 48, 64, 96}
STG_API int stg_adapter_hidden_pair(const void* a0, const void* w0, const void* b0, void* h0,
                                    const void* a1, const void* w1, const void* b1, void* h1,
                                    int M, int D, int K, cudaStream_t stream) {
  const Side s0{static_cast<const bf16*>(a0), static_cast<const bf16*>(w0),
                static_cast<const bf16*>(b0), nullptr, nullptr, static_cast<bf16*>(h0)};
  const Side s1{static_cast<const bf16*>(a1), static_cast<const bf16*>(w1),
                static_cast<const bf16*>(b1), nullptr, nullptr, static_cast<bf16*>(h1)};
  if (bad_operands(s0, M, D, K, false) || bad_operands(s1, M, D, K, false))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 16) return launch<16, EPI_RGELU>(s0, s1, M, D, K, stream);
  if (D == 32) return launch<32, EPI_RGELU>(s0, s1, M, D, K, stream);
  if (D == 48) return launch<48, EPI_RGELU>(s0, s1, M, D, K, stream);
  if (D == 64) return launch<64, EPI_RGELU>(s0, s1, M, D, K, stream);
  if (D == 96) return launch<96, EPI_RGELU>(s0, s1, M, D, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y_s (M, N) = bf16(bf16(r1_s + r2_s) + bf16(a_s (M, K) . w_s (N, K)^T + b_s)) for
// s = 0, 1; all bf16, contiguous, 16-byte aligned; K and N multiples of 8
STG_API int stg_adapter_out_pair(const void* a0, const void* w0, const void* b0, const void* r10,
                                 const void* r20, void* y0, const void* a1, const void* w1,
                                 const void* b1, const void* r11, const void* r21, void* y1,
                                 int M, int N, int K, cudaStream_t stream) {
  const Side s0{static_cast<const bf16*>(a0), static_cast<const bf16*>(w0),
                static_cast<const bf16*>(b0), static_cast<const bf16*>(r10),
                static_cast<const bf16*>(r20), static_cast<bf16*>(y0)};
  const Side s1{static_cast<const bf16*>(a1), static_cast<const bf16*>(w1),
                static_cast<const bf16*>(b1), static_cast<const bf16*>(r11),
                static_cast<const bf16*>(r21), static_cast<bf16*>(y1)};
  if (bad_operands(s0, M, N, K, true) || bad_operands(s1, M, N, K, true))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kOutCols, EPI_RES2>(s0, s1, M, N, K, stream);
}
