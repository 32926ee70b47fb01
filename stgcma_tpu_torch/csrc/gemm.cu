// Tensor-core GEMM shared by K1-K4, K7 and K11-K14: C[m, n] = sum_k A[m, k] * W[n, k] + epilogue.
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
// The adapter products (N = 48 or K = 48 at CLIP-B/16) move ~20 flops a byte:
// bytes bound them. The int8 fc1 product writes an fp32 hidden and does ~360
// ops per byte, below the int8 ridge of ~590: bytes bound it. At the Swin FFN
// shapes of K7 (M = 250880 or 62720 rows, C = 128 or 256, hidden 4C) each
// product alone does ~200-400 flops per byte, and the bf16 hidden goes
// through device memory between fc1 and fc2 (2 x 257 MB at stage 0, ~0.15 ms
// at 3.35 TB/s, about twice K7's op bound of 0.067 ms): a later design keeps
// it on chip (fc1 chunk -> GELU -> fc2 accumulate), as the TPU kernel does in
// VMEM.
// Design, bf16 (gemm_wgmma_kernel): Hopper's warpgroup products fed by TMA.
// A block is two consumer warpgroups and one producer warp (288 threads) and
// is persistent: the grid is at most one or two blocks an SM, and a block
// walks the output tiles tile += gridDim.x, N fastest, so the blocks in
// flight share A's rows and W in L2. One thread of the producer issues the
// TMA loads of A (128 rows x 64 k) and W (TN rows x 64 k), 128-byte swizzled,
// into a ring of 3 stages (TN = 128, two blocks an SM) or 8 (TN = 64, one
// block an SM) with a full and an empty mbarrier each; it runs ahead into the next tile while the consumers store
// the last one. Each consumer warpgroup owns 64 rows of the 128 x TN block
// tile and issues wgmma.mma_async m64nTNk16 (bf16 in, fp32 accumulate) on
// the stage, keeping one k-tile of products in flight while it releases the
// stage before. Two blocks share an SM, so while one stores, the other can
// multiply. The epilogue forms every value of 32 columns first (`epi_value`,
// the roundings of `store<EPI>`, all loads of bias and residuals ahead of any
// store; residual rows are prefetched into L2 while the tile multiplies) and
// then stores two columns at a time. No setmaxnreg: ptxas gives every thread
// of a kernel the same registers within the launch bounds (96 at two blocks
// of 288 threads), whatever setmaxnreg later moves, and with a producer
// warpgroup the bounds would allow 85, too few for the 64 accumulators of
// m64n128 (ptxas asks for 90). TN is 128, or 64 where N <= 64 (the adapter
// hiddens at D = 16..64).
// TMA zero-fills K and the rows of A and W past their ends, which serves the
// adapter products at K or N = 16..96 and K = 128 with no second path; the
// epilogue masks rows and columns past M and N. TMA needs K a multiple of 8
// and 16-byte aligned bases (ops/fused_attn.py check_gemm_operands raises
// otherwise). The tensor maps are encoded on the host for every call by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no link
// against libcuda), and passed as __grid_constant__ parameters.
// Design, int8 (gemm_kernel, first version): 128x128 block tiles, 64-byte
// deep k-tiles in a 4-stage cp.async ring in shared memory (three tiles in
// flight while one is multiplied), 8 warps of 64x32 each issuing mma.sync
// m16n8k32 s8. Both operands are K-contiguous ("row.col"), which is why the
// port keeps linear weights in torch's (out, in) layout. Rows are padded to
// 80 bytes in shared memory so the fragment loads are free of bank
// conflicts; fragments come in through ldmatrix.
#include <cuda.h>

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

// The value the epilogue stores at C[m, n], with every rounding it makes: bf16
// for the bf16 epilogues and EPI_Q_BF16, fp32 for the int8 GELU hiddens.
template <int EPI, typename Acc>
__device__ __forceinline__ auto epi_value(const EpiArgs& e, int N, int m, int n, Acc acc) {
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
    return __float2bfloat16_rn(v);
  } else if constexpr (EPI == EPI_BF16_GELU) {
    return __float2bfloat16_rn(erf_gelu(v));
  } else if constexpr (EPI == EPI_BF16_RGELU) {
    return __float2bfloat16_rn(erf_gelu(__bfloat162float(__float2bfloat16_rn(v))));
  } else if constexpr (EPI == EPI_BF16_RES2) {
    const float r = __bfloat162float(
        __float2bfloat16_rn(__fadd_rn(__bfloat162float(e.r1[i]), __bfloat162float(e.r2[i]))));
    return __float2bfloat16_rn(__fadd_rn(r, __bfloat162float(__float2bfloat16_rn(v))));
  } else if constexpr (EPI == EPI_BF16_RES1) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(e.r1[i]), __bfloat162float(__float2bfloat16_rn(v))));
  } else if constexpr (EPI == EPI_BF16_RESF) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(e.r1[i]), v));
  } else if constexpr (EPI == EPI_BF16_QUICKGELU) {
    return __float2bfloat16_rn(quick_gelu(v));
  } else if constexpr (EPI == EPI_Q_QUICKGELU_F32) {
    return quick_gelu(v);
  } else {
    return erf_gelu(v);
  }
}

template <int EPI, typename Acc>
__device__ __forceinline__ void store(const EpiArgs& e, int N, int m, int n, Acc acc) {
  using T = decltype(epi_value<EPI>(e, N, m, n, acc));
  static_cast<T*>(e.out)[static_cast<size_t>(m) * N + n] = epi_value<EPI>(e, N, m, n, acc);
}

// int8: A (M, K) and W (N, K), both row-major with K contiguous; kbytes = K.
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

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialized and persistent
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;                // block tile rows: two consumer warpgroups of 64
constexpr int WG_BK = 64;                 // k-tile: 64 bf16 = 128 bytes, one swizzle row
constexpr int WG_THREADS = 288;           // two consumer warpgroups + one producer warp

template <int TN>
struct WgTile {
  // TN = 128: two blocks an SM, so one block's epilogue runs under the other's
  // products, 3 stages (96 KB) each. TN = 64 (N <= 64, the adapter hiddens: a tile or
  // two a block): one block an SM and 8 stages (192 KB), so more of A is in flight
  static constexpr int BLOCKS_PER_SM = TN == 128 ? 2 : 1;
  static constexpr int STAGES = TN == 128 ? 3 : 8;
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + TN * WG_BK * 2;
  // the ring, its 2 * STAGES mbarriers, and room to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// until the phase of the given parity has completed (a fresh barrier: parity 1 passes)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// the box at (k0, row0) of a 2-D tensor map into shared memory, reported to bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k0, int row0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0),
         "r"(smem_u32(bar)) : "memory");
}

// wgmma operand descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// start address / 16, leading offset 1 (unused), stride 1024 bytes between 8-row
// groups, layout 1 (SWIZZLE_128B). A k16 step adds 32 bytes (2) to the start.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// keep the compiler from moving reads of an accumulator across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (m64 x n64 fp32, 32 a thread) += A (64 x 16, descriptor da) . B (n64 x 16, db)^T
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// d (m64 x n128 fp32, 64 a thread) += A (64 x 16, descriptor da) . B (n128 x 16, db)^T
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

template <int TN>
__device__ __forceinline__ void wgmma_tile(float (&d)[TN / 2], uint64_t da, uint64_t db) {
  if constexpr (TN == 128) wgmma_n128(d, da, db);
  else wgmma_n64(d, da, db);
}

// C[m, n] = epilogue(sum_k A[m, k] W[n, k]); tm_a: A (M, K), tm_w: W (N, K), bf16,
// K contiguous, boxes of 64 k by 128 (A) or TN (W) rows. The epilogue's pointers
// come in as __restrict__ parameters (out overlaps no operand).
template <int TN, int EPI>
__global__ void __launch_bounds__(WG_THREADS, WgTile<TN>::BLOCKS_PER_SM) gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, int M,
    int N, int K, const bf16* __restrict__ bias, void* __restrict__ out,
    const bf16* __restrict__ r1, const bf16* __restrict__ r2) {
  using L = WgTile<TN>;
  const EpiArgs e{nullptr, nullptr, bias, out, r1, r2};
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::STAGES * L::STAGE_BYTES);
  uint64_t* empty = full + L::STAGES;
  const int n_tiles = ceil_div(N, TN);
  const int tiles = ceil_div(M, WG_BM) * n_tiles;
  const int ktiles = ceil_div(K, WG_BK);
  const int wg = threadIdx.x / 128;        // 0, 1: consumers; 2: the producer warp

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);             // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 8);            // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {                          // producer: one thread issues every load
    if (threadIdx.x == 256) {
      int it = 0;                         // k-tiles issued by this block, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * WG_BM, n0 = (tile % n_tiles) * TN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % L::STAGES;
          mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::STAGE_BYTES);   // boxes count whole, zero fill included
          uint8_t* st = smem + s * L::STAGE_BYTES;
          tma_load(st, &tm_a, kt * WG_BK, m0, &full[s]);
          tma_load(st + L::A_BYTES, &tm_w, kt * WG_BK, n0, &full[s]);
        }
      }
    }
  } else {                                // consumers: rows 64 * c .. 64 * c + 63 of a tile
    const int c = wg;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    float acc[TN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * WG_BM, n0 = (tile % n_tiles) * TN;
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      if constexpr (EPI == EPI_BF16_RES2 || EPI == EPI_BF16_RES1 || EPI == EPI_BF16_RESF) {
        // the residual rows this warp's epilogue reads, into L2 while the tile
        // multiplies: lane l fetches the 128-byte line l % 2 of row l / 2
        const int prow = m0 + c * 64 + warp * 16 + (lane >> 1);
        const int pcol = n0 + (lane & 1) * 64;
        if (prow < M && pcol < N) {
          prefetch_l2(e.r1 + static_cast<size_t>(prow) * N + pcol);
          if constexpr (EPI == EPI_BF16_RES2) prefetch_l2(e.r2 + static_cast<size_t>(prow) * N + pcol);
        }
      }
      int prev = -1;                      // the stage whose products may still be running
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % L::STAGES;
        mbar_wait(&full[s], (it / L::STAGES) & 1);
        const uint8_t* st = smem + s * L::STAGE_BYTES;
        const uint64_t da = smem_desc(st + c * 64 * WG_BK * 2);
        const uint64_t db = smem_desc(st + L::A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < WG_BK / 16; ++k) wgmma_tile<TN>(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        wgmma_wait<1>();                  // the k-tile before this one is done: release it
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      // accumulator j * 4 + 2 * h + i: row warp * 16 + lane / 4 + 8 * h, column
      // j * 8 + 2 * (lane % 4) + i of the warpgroup's 64 x TN tile. A tile wholly
      // inside C takes no bounds checks; an edge tile stores element by element.
      const int row = m0 + c * 64 + warp * 16 + (lane >> 2);
      const int col = n0 + 2 * (lane & 3);
      if (m0 + WG_BM <= M && n0 + TN <= N) {
        // 32 columns at a time: every value first (the loads of bias and
        // residuals all ahead of any store), two columns a register, then the
        // stores, 4 bytes each
        bf16* c_out = static_cast<bf16*>(out);
#pragma unroll
        for (int j0 = 0; j0 < TN / 8; j0 += 4) {
          uint32_t packed[8];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int a = (j0 + j) * 4 + 2 * h, n = col + (j0 + j) * 8;
              __nv_bfloat162 v2;
              v2.x = epi_value<EPI>(e, N, row + 8 * h, n, acc[a]);
              v2.y = epi_value<EPI>(e, N, row + 8 * h, n + 1, acc[a + 1]);
              packed[j * 2 + h] = *reinterpret_cast<uint32_t*>(&v2);
            }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint32_t*>(c_out + static_cast<size_t>(row + 8 * h) * N + col +
                                           (j0 + j) * 8) = packed[j * 2 + h];
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int n = col + j * 8;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = row + 8 * h;
            if (m < M) {
              if (n < N) store<EPI>(e, N, m, n, acc[j * 4 + 2 * h]);
              if (n + 1 < N) store<EPI>(e, N, m, n + 1, acc[j * 4 + 2 * h + 1]);
            }
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (nullptr if it has none)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, K) bf16 row-major tensor in boxes of 64 k by box_rows rows, 128-byte
// swizzled; reads past its edges are zeros
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {WG_BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int TN, int EPI>
int launch_wgmma(const void* A, const void* W, int M, int N, int K, const EpiArgs& e,
                 cudaStream_t stream) {
  // once a process (the port runs on one card): the SM count and the kernel's
  // shared-memory limit
  static int sms = 0;
  auto kernel = gemm_wgmma_kernel<TN, EPI>;
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 WgTile<TN>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms = n;
  }
  CUtensorMap tm_a, tm_w;
  int terr = tensor_map(&tm_a, A, M, K, WG_BM);
  if (terr == 0) terr = tensor_map(&tm_w, W, N, K, TN);
  if (terr != 0) return terr;
  const int tiles = ceil_div(M, WG_BM) * ceil_div(N, TN);
  const int slots = WgTile<TN>::BLOCKS_PER_SM * sms;
  const int grid = tiles < slots ? tiles : slots;
  kernel<<<grid, WG_THREADS, WgTile<TN>::SMEM, stream>>>(
      tm_a, tm_w, M, N, K, e.bias, e.out, e.r1, e.r2);
  return static_cast<int>(cudaGetLastError());
}

// TMA: K a multiple of 8 (16-byte row strides), A and W 16-byte aligned. Tiles of
// 128 x 128, or 128 x 64 where N <= 64 (the adapter hiddens).
template <int EPI>
int launch_bf16(const void* A, const void* W, int M, int N, int K, const EpiArgs& e,
                cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 8 || K % 8 || reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(W) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 64) return launch_wgmma<64, EPI>(A, W, M, N, K, e, stream);
  return launch_wgmma<128, EPI>(A, W, M, N, K, e, stream);
}

}  // namespace

STG_API int stg_gemm_bf16(const void* A, const void* W, const void* bias, void* C,
                          int M, int N, int K, int epilogue, cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C, nullptr, nullptr};
  switch (epilogue) {
    case EPI_BF16: return launch_bf16<EPI_BF16>(A, W, M, N, K, e, stream);
    case EPI_BF16_GELU: return launch_bf16<EPI_BF16_GELU>(A, W, M, N, K, e, stream);
    case EPI_BF16_RGELU: return launch_bf16<EPI_BF16_RGELU>(A, W, M, N, K, e, stream);
    case EPI_BF16_QUICKGELU: return launch_bf16<EPI_BF16_QUICKGELU>(A, W, M, N, K, e, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C = bf16(bf16(R1 + R2) + bf16(A . W^T + bias)); R1, R2, C: (M, N) bf16
STG_API int stg_gemm_bf16_res2(const void* A, const void* W, const void* bias, const void* R1,
                               const void* R2, void* C, int M, int N, int K,
                               cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C,
            static_cast<const bf16*>(R1), static_cast<const bf16*>(R2)};
  return launch_bf16<EPI_BF16_RES2>(A, W, M, N, K, e, stream);
}

// C = epilogue(R, A . W^T + bias), R and C (M, N) bf16: EPI_BF16_RESF bf16(R + (acc + b))
// (K14), or EPI_BF16_RES1 bf16(R + bf16(acc + b)) (K13)
STG_API int stg_gemm_bf16_res(const void* A, const void* W, const void* bias, const void* R,
                              void* C, int M, int N, int K, int epilogue, cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C, static_cast<const bf16*>(R),
            nullptr};
  switch (epilogue) {
    case EPI_BF16_RESF: return launch_bf16<EPI_BF16_RESF>(A, W, M, N, K, e, stream);
    case EPI_BF16_RES1: return launch_bf16<EPI_BF16_RES1>(A, W, M, N, K, e, stream);
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
