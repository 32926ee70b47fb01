// Tensor-core GEMM shared by K1-K3 and K7: C[m, n] = sum_k A[m, k] * W[n, k] + epilogue.
//
// Replaces the MXU products inside stgcma_tpu/ops/pallas_attn.py:
//   - bf16: the qkv and proj dots of _win_block_kernel (:401, :421) and the
//     fc2 dot of _ffn_kernel (:694), fp32 accumulation, + bias in fp32, cast
//     to bf16;
//   - bf16 with erf-GELU: the fc1 dot of _ffn_kernel (:685-693), acc + bias
//     in fp32, then 0.5 h (1 + erf(h / sqrt 2)) in fp32 (erff; the TPU
//     kernel's A&S 7.1.26 polynomial differs from it by < 2e-7), rounded to
//     a bf16 hidden;
//   - bf16 for the whole Swin block K4 (stgcma_tpu/ops/pallas_swin_block.py
//     _swin_block_kernel :245): its adapter hidden and FFN fc1 round acc +
//     bias to bf16 BEFORE the erf-GELU and again after it (_ad_h :346, :410),
//     EPI_BF16_RGELU; its adapter output is rounded after its bias and added
//     to two bf16 residuals in JAX's order, bf16(bf16(r1 + r2) + out) (:394,
//     :421), EPI_BF16_RES2 through stg_gemm_bf16_res2;
//   - bf16 for the CLIP fusion block K12 and its temporal stage K13
//     (stgcma_tpu/ops/pallas_clip_block.py _fusion_block_kernel :168,
//     _tadapt_kernel :350): the float fc1 takes acc + bias and QuickGELU
//     h * sigmoid(1.702 h) in fp32 and rounds once to a bf16 hidden
//     (:208-211), EPI_BF16_QUICKGELU; K13's adapter output is rounded after
//     its bias and added to the one residual, bf16(x + bf16(acc + b2))
//     (:388-389), EPI_BF16_RES1 through stg_gemm_bf16_res. Their
//     adapter products run at N = 48 and K = 48 (CLIP-B/16's adapter width):
//     K = 48 is one and a half k-tiles, the second half zero-filled;
//   - bf16 for the transpose-free temporal stage K14 (pallas_attn.py
//     _tblock_v2_kernel :1757): its adapter hidden takes acc + bias and
//     erf-GELU in fp32 and rounds once (:1827-1830, EPI_BF16_GELU), and its
//     output adds the fp32 adapter term to the fp32 residual and rounds once,
//     bf16(x + (acc + b2)) (:1831-1835), EPI_BF16_RESF through
//     stg_gemm_bf16_res (K13's EPI_BF16_RES1 rounds the term first);
//   - int8: _dotq (:1356) in _win_block_q_core (:1440, :1457) and
//     _ffn_q_kernel (:1626, :1632): int8 x int8 -> int32, then
//     float(acc) * sx[m] * ws[n] + b[n] in fp32, then either a bf16 store or
//     QuickGELU / erf-GELU into an fp32 hidden.
// Bound on the H100: at the main path's shapes (M = 15760 or 3920 rows,
// K = 768 or 3072, N = 768..3072) the bf16 products do 380-560 flops per byte
// they must move, above the card's bf16 ridge of ~295: operations bound them.
// The int8 fc1 product writes an fp32 hidden and does ~360 ops per byte,
// below the int8 ridge of ~590: bytes bound it. At the Swin FFN shapes of K7
// (M = 250880 or 62720 rows, C = 128 or 256, hidden 4C) each product alone
// does ~200-400 flops per byte, and the bf16 hidden goes through device
// memory between fc1 and fc2 (2 x 257 MB at stage 0, ~0.15 ms at 3.35 TB/s,
// about twice K7's op bound of 0.067 ms): the later design keeps it on chip
// (fc1 chunk -> GELU -> fc2 accumulate), as the TPU kernel does in VMEM. At
// K = 128 the 4-stage ring sees only 4 k-tiles. Design (first version,
// simple and right): 128x128 block tiles, 64-byte deep k-tiles in a 4-stage
// cp.async ring in shared memory (three tiles in flight while one is
// multiplied), 8 warps of 64x32 each issuing mma.sync (m16n8k16 bf16 or
// m16n8k32 s8). Both operands are K-contiguous ("row.col"), which is why the
// port keeps linear weights in torch's (out, in) layout. Rows are padded to
// 80 bytes in shared memory so the fragment loads are free of bank
// conflicts; fragments come in through ldmatrix. Not yet used: TMA, wgmma.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128;
constexpr int BKB = 64;   // tile depth in bytes: 32 bf16 or 64 int8
constexpr int LDS = 80;   // shared-memory row stride in bytes
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;   // 80 KB: dynamic shared memory

// 16-byte global -> shared copy in flight; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// four 8x8 matrices of 16-byte rows (b16 elements; the int8 tiles use the
// same byte layout) into the mma fragment registers
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint8_t* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

enum Epi {
  EPI_BF16 = 0, EPI_Q_BF16 = 1, EPI_Q_QUICKGELU_F32 = 2, EPI_Q_GELU_F32 = 3, EPI_BF16_GELU = 4,
  EPI_BF16_RGELU = 5, EPI_BF16_RES2 = 6, EPI_BF16_QUICKGELU = 7, EPI_BF16_RES1 = 8,
  EPI_BF16_RESF = 9
};

__device__ __forceinline__ float quick_gelu(float v) {
  return v * (1.0f / (1.0f + expf(-1.702f * v)));
}

__device__ __forceinline__ float erf_gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct EpiArgs {
  const float* sa;   // (M,) per-row activation scales (int8 only)
  const bf16* ws;    // (N,) per-column weight scales (int8 only)
  const bf16* bias;  // (N,)
  void* out;         // (M, N) bf16 or fp32
  const bf16* r1;    // (M, N) residuals (EPI_BF16_RES2: both; EPI_BF16_RES1, _RESF: r1)
  const bf16* r2;
};

template <int EPI, typename Acc>
__device__ __forceinline__ void store(const EpiArgs& e, int N, int m, int n, Acc acc) {
  float v;
  if constexpr (EPI == EPI_BF16 || EPI == EPI_BF16_GELU || EPI == EPI_BF16_RGELU ||
                EPI == EPI_BF16_RES2 || EPI == EPI_BF16_QUICKGELU || EPI == EPI_BF16_RES1 ||
                EPI == EPI_BF16_RESF) {
    v = acc;
  } else {
    v = __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(acc)), e.sa[m]),
                  __bfloat162float(e.ws[n]));
  }
  v = __fadd_rn(v, __bfloat162float(e.bias[n]));
  const size_t i = static_cast<size_t>(m) * N + n;
  if constexpr (EPI == EPI_BF16 || EPI == EPI_Q_BF16) {
    static_cast<bf16*>(e.out)[i] = __float2bfloat16_rn(v);
  } else if constexpr (EPI == EPI_BF16_GELU) {
    static_cast<bf16*>(e.out)[i] = __float2bfloat16_rn(erf_gelu(v));
  } else if constexpr (EPI == EPI_BF16_RGELU) {
    static_cast<bf16*>(e.out)[i] =
        __float2bfloat16_rn(erf_gelu(__bfloat162float(__float2bfloat16_rn(v))));
  } else if constexpr (EPI == EPI_BF16_RES2) {
    const float r = __bfloat162float(
        __float2bfloat16_rn(__fadd_rn(__bfloat162float(e.r1[i]), __bfloat162float(e.r2[i]))));
    static_cast<bf16*>(e.out)[i] =
        __float2bfloat16_rn(__fadd_rn(r, __bfloat162float(__float2bfloat16_rn(v))));
  } else if constexpr (EPI == EPI_BF16_RES1) {
    static_cast<bf16*>(e.out)[i] = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(e.r1[i]), __bfloat162float(__float2bfloat16_rn(v))));
  } else if constexpr (EPI == EPI_BF16_RESF) {
    static_cast<bf16*>(e.out)[i] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(e.r1[i]), v));
  } else if constexpr (EPI == EPI_BF16_QUICKGELU) {
    static_cast<bf16*>(e.out)[i] = __float2bfloat16_rn(quick_gelu(v));
  } else if constexpr (EPI == EPI_Q_QUICKGELU_F32) {
    static_cast<float*>(e.out)[i] = quick_gelu(v);
  } else {
    static_cast<float*>(e.out)[i] = erf_gelu(v);
  }
}

// A: (M, K) and W: (N, K), both row-major with K contiguous; kbytes = K * element size.
template <typename Acc, int EPI>
__global__ void __launch_bounds__(256) gemm_kernel(
    const uint8_t* __restrict__ A, const uint8_t* __restrict__ W, int M, int N, int kbytes,
    EpiArgs e) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // 2 x 4 warps
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row addresses: lane l feeds row l % 8 of 8x8 matrix l / 8
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // tile kt -> stage kt % STAGES: 128 rows x 64 bytes per operand = 512
  // chunks of 16 bytes, 2 per thread; rows past M/N and bytes past K are zeros
  auto load_tile = [&](int kt) {
    uint8_t* sA = smem + (kt % STAGES) * STAGE_BYTES;
    uint8_t* sB = sA + BM * LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;
      const int r = c >> 2, cb = (c & 3) * 16;
      const int gk = kt * BKB + cb;
      const bool ka = gk < kbytes;
      const bool va = ka && m0 + r < M, vb = ka && n0 + r < N;
      cp_async16(sA + r * LDS + cb, va ? A + static_cast<size_t>(m0 + r) * kbytes + gk : A, va);
      cp_async16(sB + r * LDS + cb, vb ? W + static_cast<size_t>(n0 + r) * kbytes + gk : W, vb);
    }
  };

  const int ktiles = (kbytes + BKB - 1) / BKB;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();               // ... for every thread; stage kt-1 is free
    if (kt + STAGES - 1 < ktiles) load_tile(kt + STAGES - 1);
    cp_async_commit();
    const uint8_t* sA = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* sB = sA + BM * LDS;
#pragma unroll
    for (int s = 0; s < 2; ++s) {   // two 32-byte mma k-steps per tile
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)   // 16 rows x 32 bytes: a0..a3
        ldmatrix_x4(af[mi], sA + (wm + mi * 16 + a_row) * LDS + s * 32 + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // 16 columns x 32 bytes: b0, b1 of two n-tiles
        uint32_t r[4];
        ldmatrix_x4(r, sB + (wn + np * 16 + b_row) * LDS + s * 32 + b_col);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + h * 8;
        const int n = n0 + wn + ni * 8 + t * 2;
        if (m < M) {
          if (n < N) store<EPI>(e, N, m, n, acc[mi][ni][2 * h]);
          if (n + 1 < N) store<EPI>(e, N, m, n + 1, acc[mi][ni][2 * h + 1]);
        }
      }
}

template <typename Acc, int EPI>
int launch(const uint8_t* A, const uint8_t* W, int M, int N, int kbytes, const EpiArgs& e,
           cudaStream_t stream) {
  auto kernel = gemm_kernel<Acc, EPI>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(N, BN), ceil_div(M, BM));
  kernel<<<grid, 256, SMEM_BYTES, stream>>>(A, W, M, N, kbytes, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

STG_API int stg_gemm_bf16(const void* A, const void* W, const void* bias, void* C,
                          int M, int N, int K, int epilogue, cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C, nullptr, nullptr};
  const uint8_t* a = static_cast<const uint8_t*>(A);
  const uint8_t* w = static_cast<const uint8_t*>(W);
  switch (epilogue) {
    case EPI_BF16: return launch<float, EPI_BF16>(a, w, M, N, 2 * K, e, stream);
    case EPI_BF16_GELU: return launch<float, EPI_BF16_GELU>(a, w, M, N, 2 * K, e, stream);
    case EPI_BF16_RGELU: return launch<float, EPI_BF16_RGELU>(a, w, M, N, 2 * K, e, stream);
    case EPI_BF16_QUICKGELU:
      return launch<float, EPI_BF16_QUICKGELU>(a, w, M, N, 2 * K, e, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C = bf16(bf16(R1 + R2) + bf16(A . W^T + bias)); R1, R2, C: (M, N) bf16
STG_API int stg_gemm_bf16_res2(const void* A, const void* W, const void* bias, const void* R1,
                               const void* R2, void* C, int M, int N, int K,
                               cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C,
            static_cast<const bf16*>(R1), static_cast<const bf16*>(R2)};
  const uint8_t* a = static_cast<const uint8_t*>(A);
  const uint8_t* w = static_cast<const uint8_t*>(W);
  return launch<float, EPI_BF16_RES2>(a, w, M, N, 2 * K, e, stream);
}

// C = epilogue(R, A . W^T + bias), R and C (M, N) bf16: EPI_BF16_RESF bf16(R + (acc + b))
// (K14), or EPI_BF16_RES1 bf16(R + bf16(acc + b)) (K13)
STG_API int stg_gemm_bf16_res(const void* A, const void* W, const void* bias, const void* R,
                              void* C, int M, int N, int K, int epilogue, cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C, static_cast<const bf16*>(R),
            nullptr};
  const uint8_t* a = static_cast<const uint8_t*>(A);
  const uint8_t* w = static_cast<const uint8_t*>(W);
  switch (epilogue) {
    case EPI_BF16_RESF: return launch<float, EPI_BF16_RESF>(a, w, M, N, 2 * K, e, stream);
    case EPI_BF16_RES1: return launch<float, EPI_BF16_RES1>(a, w, M, N, 2 * K, e, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

STG_API int stg_gemm_s8(const void* A, const void* sa, const void* W, const void* ws,
                        const void* bias, void* C, int M, int N, int K, int epilogue,
                        cudaStream_t stream) {
  EpiArgs e{static_cast<const float*>(sa), static_cast<const bf16*>(ws),
            static_cast<const bf16*>(bias), C, nullptr, nullptr};
  const uint8_t* a = static_cast<const uint8_t*>(A);
  const uint8_t* w = static_cast<const uint8_t*>(W);
  switch (epilogue) {
    case EPI_Q_BF16: return launch<int, EPI_Q_BF16>(a, w, M, N, K, e, stream);
    case EPI_Q_QUICKGELU_F32: return launch<int, EPI_Q_QUICKGELU_F32>(a, w, M, N, K, e, stream);
    case EPI_Q_GELU_F32: return launch<int, EPI_Q_GELU_F32>(a, w, M, N, K, e, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
