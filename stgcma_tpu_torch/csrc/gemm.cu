// Tensor-core GEMM shared by K1-K4, K7 (C >= 512) and K11-K14: C[m, n] = sum_k A[m, k] * W[n, k] + epilogue.
//
// Replaces the MXU products inside stgcma_tpu/ops/pallas_attn.py:
//   - bf16: the qkv and proj dots of _win_block_kernel (:401, :421) and the
//     fc2 dot of _ffn_kernel (:694) at C = 512 and up, fp32 accumulation, +
//     bias in fp32, cast to bf16;
//   - bf16 with erf-GELU: an adapter's down product (K11's composition
//     where rowadapt.cu does not take its width, `_adapter_down` :1472), and
//     K7's fc1 (_ffn_kernel :685-693, with its fc2 above) at the FFN widths
//     csrc/ffn.cu does not instantiate (C = 512 and up), acc + bias in fp32,
//     then 0.5 h (1 + erf(h / sqrt 2)) in fp32 (erff; the TPU kernel's A&S
//     7.1.26 polynomial differs from it by < 2e-7), rounded to a bf16 hidden;
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
//     QuickGELU / erf-GELU into an fp32 hidden, with each hidden row's max |h|
//     for the row quantization that reads it (_quant_rows :1632).
// Bound on the H100: at the main path's shapes (M = 15760 or 3920 rows,
// K = 768 or 3072, N = 768..3072) the bf16 products do 380-560 flops per byte
// they must move, above the card's bf16 ridge of ~295: operations bound them.
// The adapter products (N = 48 or K = 48 at CLIP-B/16) move ~20 flops a byte:
// bytes bound them. The int8 fc1 product writes an fp32 hidden and does ~360
// ops per byte, below the int8 ridge of ~590: bytes bound it.
// Design (gemm_wgmma_kernel, one main loop for both operand types): Hopper's
// warpgroup products fed by TMA.
// A block is two consumer warpgroups and one producer warp (288 threads) and
// is persistent: the grid is at most one or two blocks an SM, and a block
// walks the output tiles tile += gridDim.x, N fastest, so the blocks in
// flight share A's rows and W in L2. One thread of the producer issues the
// TMA loads of A (128 rows) and W (TN rows), each a k-tile of 128 bytes deep
// (64 bf16 or 128 int8: one 128-byte swizzle row), into a ring of 3 stages
// (TN = 128, two blocks an SM) or 8 (TN = 64, one block an SM) with a full and
// an empty mbarrier each; it runs ahead into the next tile while the consumers
// store the last one. Each consumer warpgroup owns 64 rows of the 128 x TN block
// tile and issues wgmma.mma_async on the stage, four 32-byte k-steps a k-tile
// (m64nTNk16 bf16 -> fp32, or m64n128k32 s8 -> s32), keeping one k-tile of
// products in flight while it releases the stage before. Both operands are
// K-major, the only layout 8-bit wgmma takes, which is why the port keeps
// linear weights in torch's (out, in) layout; the shared-memory layout and the
// descriptors are the same bytes for both types. int32 sums are exact in any
// order, so the int8 product's output does not depend on the loop's order.
// Two blocks share an SM, so while one stores, the other can multiply. The
// epilogue forms every value of 32 columns first (`epi_value`, every rounding
// of the epilogue, all loads of bias and residuals ahead of any store; residual
// rows are prefetched into L2 while the tile multiplies) and then stores two
// columns at a time (4 bytes of bf16, 8 of fp32). The fp32 hiddens of the int8
// FFNs also leave each row's max |h| over the tile's columns in an (M,) buffer
// (atomicMax on the bits: non-negative floats order as their int bits), so the
// hidden's row quantization reads the hidden once. No setmaxnreg: ptxas gives
// every thread of a kernel the same registers within the launch bounds (96 at
// two blocks of 288 threads), whatever setmaxnreg later moves, and with a
// producer warpgroup the bounds would allow 85, too few for the 64 accumulators
// of m64n128 (ptxas asks for 90). TN is 128, or 64 where a bf16 N <= 64 (the
// adapter hiddens at D = 16..64).
// TMA zero-fills K and the rows of A and W past their ends, which serves the
// adapter products at K or N = 16..96 and K = 128 with no second path; the
// epilogue masks rows and columns past M and N. TMA needs rows of a multiple of
// TMA_ROW_ALIGN bytes (K a multiple of 8 bf16 or 16 int8) and 16-byte aligned
// bases (ops/fused_attn.py check_gemm_operands and check_gemm_s8_operands raise
// otherwise; the launchers refuse). The tensor maps are encoded on the host for
// every call by cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
// (no link against libcuda), and passed as __grid_constant__ parameters.
#include "wgmma.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// TMA + wgmma, warp-specialized and persistent, bf16 or int8 operands
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;                // block tile rows: two consumer warpgroups of 64
constexpr int WG_THREADS = 288;           // two consumer warpgroups + one producer warp

template <int TN>
struct WgTile {
  // TN = 128: two blocks an SM, so one block's epilogue runs under the other's
  // products, 3 stages (96 KB) each. TN = 64 (N <= 64, the adapter hiddens: a tile or
  // two a block): one block an SM and 8 stages (192 KB), so more of A is in flight
  static constexpr int BLOCKS_PER_SM = TN == 128 ? 2 : 1;
  static constexpr int STAGES = TN == 128 ? 3 : 8;
  static constexpr int A_BYTES = WG_BM * WG_BK_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + TN * WG_BK_BYTES;
  // the ring, its 2 * STAGES mbarriers, and room to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

template <int EPI>
constexpr bool f32_out = EPI == EPI_Q_QUICKGELU_F32 || EPI == EPI_Q_GELU_F32;

// C[m, n] = epilogue(sum_k A[m, k] W[n, k]); tm_a: A (M, K), tm_w: W (N, K), Op (bf16
// or int8), K contiguous, boxes of 128 bytes of k by 128 (A) or TN (W) rows. The
// epilogue's pointers come in as __restrict__ parameters (out overlaps no operand);
// amax (fp32 epilogues, nullable): (M,) zeros that take each row's max |C[m, :]|.
template <typename Op, int TN, int EPI>
__global__ void __launch_bounds__(WG_THREADS, WgTile<TN>::BLOCKS_PER_SM) gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, int M,
    int N, int K, const float* __restrict__ sa, const bf16* __restrict__ ws,
    const bf16* __restrict__ bias, void* __restrict__ out, const bf16* __restrict__ r1,
    const bf16* __restrict__ r2, float* __restrict__ amax) {
  using L = WgTile<TN>;
  using Acc = typename OpType<Op>::Acc;
  constexpr int BK = WG_BK_BYTES / static_cast<int>(sizeof(Op));   // k-tile in elements
  const EpiArgs e{sa, ws, bias, out, r1, r2};
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::STAGES * L::STAGE_BYTES);
  uint64_t* empty = full + L::STAGES;
  const int n_tiles = ceil_div(N, TN);
  const int tiles = ceil_div(M, WG_BM) * n_tiles;
  const int ktiles = ceil_div(K, BK);
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
          tma_load(st, &tm_a, kt * BK, m0, &full[s]);
          tma_load(st + L::A_BYTES, &tm_w, kt * BK, n0, &full[s]);
        }
      }
    }
  } else {                                // consumers: rows 64 * c .. 64 * c + 63 of a tile
    const int c = wg;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    Acc acc[TN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * WG_BM, n0 = (tile % n_tiles) * TN;
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
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
        const uint64_t da = smem_desc(st + c * 64 * WG_BK_BYTES);
        const uint64_t db = smem_desc(st + L::A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < WG_BK_BYTES / WG_KSTEP_BYTES; ++k)   // +32 bytes: +2 in a descriptor
          wgmma_step(acc, da + 2 * k, db + 2 * k);
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
      float rmax[2] = {0.f, 0.f};         // fp32 epilogues: max |C| of rows row, row + 8
      if (m0 + WG_BM <= M && n0 + TN <= N) {
        // 32 columns at a time: every value first (the loads of bias and
        // residuals all ahead of any store), two columns a register (bf16) or a
        // register pair (fp32), then the stores
#pragma unroll
        for (int j0 = 0; j0 < TN / 8; j0 += 4) {
          if constexpr (f32_out<EPI>) {
            // 16 columns at a time: an fp32 pair takes two registers
            float* c_out = static_cast<float*>(out);
#pragma unroll
            for (int j1 = j0; j1 < j0 + 4; j1 += 2) {
              float2 vals[4];
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int a = (j1 + j) * 4 + 2 * h, n = col + (j1 + j) * 8;
                  const float2 v2 = make_float2(
                      epi_value<EPI>(e, N, row + 8 * h, n, acc[a]),
                      epi_value<EPI>(e, N, row + 8 * h, n + 1, acc[a + 1]));
                  rmax[h] = fmaxf(rmax[h], fmaxf(fabsf(v2.x), fabsf(v2.y)));
                  vals[j * 2 + h] = v2;
                }
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  *reinterpret_cast<float2*>(c_out + static_cast<size_t>(row + 8 * h) * N + col +
                                             (j1 + j) * 8) = vals[j * 2 + h];
            }
          } else {
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
            bf16* c_out = static_cast<bf16*>(out);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                *reinterpret_cast<uint32_t*>(c_out + static_cast<size_t>(row + 8 * h) * N + col +
                                             (j0 + j) * 8) = packed[j * 2 + h];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int n = col + j * 8;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // two stores under one row test: a loop over the pair with one test each
            // made ptxas spill 176 bytes in EPI_BF16_RES2 (+11% at K = 48)
            const int m = row + 8 * h;
            auto put = [&](int nn, Acc x) {
              auto v = epi_value<EPI>(e, N, m, nn, x);
              static_cast<decltype(v)*>(out)[static_cast<size_t>(m) * N + nn] = v;
              if constexpr (f32_out<EPI>) rmax[h] = fmaxf(rmax[h], fabsf(v));
            };
            if (m < M) {
              if (n < N) put(n, acc[j * 4 + 2 * h]);
              if (n + 1 < N) put(n + 1, acc[j * 4 + 2 * h + 1]);
            }
          }
        }
      }
      if constexpr (f32_out<EPI>) {
        // the four lanes of a row hold its 128 columns of this tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float r = rmax[h];
          r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
          r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
          if (amax != nullptr && (lane & 3) == 0 && row + 8 * h < M)
            atomicMax(reinterpret_cast<int*>(amax) + row + 8 * h, __float_as_int(r));
        }
      }
    }
  }
}

template <typename Op, int TN, int EPI>
int launch_wgmma(const void* A, const void* W, int M, int N, int K, const EpiArgs& e,
                 float* amax, cudaStream_t stream) {
  // once a process (the port runs on one card): the SM count and the kernel's
  // shared-memory limit
  static int sms = 0;
  auto kernel = gemm_wgmma_kernel<Op, TN, EPI>;
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
  int terr = tensor_map<Op>(&tm_a, A, M, K, WG_BM);
  if (terr == 0) terr = tensor_map<Op>(&tm_w, W, N, K, TN);
  if (terr != 0) return terr;
  const int tiles = ceil_div(M, WG_BM) * ceil_div(N, TN);
  const int slots = WgTile<TN>::BLOCKS_PER_SM * sms;
  const int grid = tiles < slots ? tiles : slots;
  kernel<<<grid, WG_THREADS, WgTile<TN>::SMEM, stream>>>(
      tm_a, tm_w, M, N, K, e.sa, e.ws, e.bias, e.out, e.r1, e.r2, amax);
  return static_cast<int>(cudaGetLastError());
}

// TMA: rows of a multiple of TMA_ROW_ALIGN bytes (K a multiple of 8 bf16 or 16
// int8), A and W 16-byte aligned. Tiles of 128 x 128, or 128 x 64 where a bf16 N
// <= 64 (the adapter hiddens).
template <typename Op, int EPI>
int launch(const void* A, const void* W, int M, int N, int K, const EpiArgs& e,
           cudaStream_t stream, float* amax = nullptr) {
  if (M < 1 || N < 1 || K < 1 || (K * sizeof(Op)) % TMA_ROW_ALIGN ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(W) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(Op) == 2) {
    if (N <= 64) return launch_wgmma<Op, 64, EPI>(A, W, M, N, K, e, amax, stream);
  }
  return launch_wgmma<Op, 128, EPI>(A, W, M, N, K, e, amax, stream);
}

}  // namespace

STG_API int stg_gemm_bf16(const void* A, const void* W, const void* bias, void* C,
                          int M, int N, int K, int epilogue, cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C, nullptr, nullptr};
  switch (epilogue) {
    case EPI_BF16: return launch<bf16, EPI_BF16>(A, W, M, N, K, e, stream);
    case EPI_BF16_GELU: return launch<bf16, EPI_BF16_GELU>(A, W, M, N, K, e, stream);
    case EPI_BF16_RGELU: return launch<bf16, EPI_BF16_RGELU>(A, W, M, N, K, e, stream);
    case EPI_BF16_QUICKGELU: return launch<bf16, EPI_BF16_QUICKGELU>(A, W, M, N, K, e, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C = bf16(bf16(R1 + R2) + bf16(A . W^T + bias)); R1, R2, C: (M, N) bf16
STG_API int stg_gemm_bf16_res2(const void* A, const void* W, const void* bias, const void* R1,
                               const void* R2, void* C, int M, int N, int K,
                               cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C,
            static_cast<const bf16*>(R1), static_cast<const bf16*>(R2)};
  return launch<bf16, EPI_BF16_RES2>(A, W, M, N, K, e, stream);
}

// C = epilogue(R, A . W^T + bias), R and C (M, N) bf16: EPI_BF16_RESF bf16(R + (acc + b))
// (K14), or EPI_BF16_RES1 bf16(R + bf16(acc + b)) (K13)
STG_API int stg_gemm_bf16_res(const void* A, const void* W, const void* bias, const void* R,
                              void* C, int M, int N, int K, int epilogue, cudaStream_t stream) {
  EpiArgs e{nullptr, nullptr, static_cast<const bf16*>(bias), C, static_cast<const bf16*>(R),
            nullptr};
  switch (epilogue) {
    case EPI_BF16_RESF: return launch<bf16, EPI_BF16_RESF>(A, W, M, N, K, e, stream);
    case EPI_BF16_RES1: return launch<bf16, EPI_BF16_RES1>(A, W, M, N, K, e, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C = epilogue(float(A . W^T) * sa[m] * ws[n] + bias[n]), A (M, K) and W (N, K) int8:
// EPI_Q_BF16 rounds to bf16; the fp32 GELU hiddens also take each row's max |C| into
// amax ((M,) zeros, nullable)
STG_API int stg_gemm_s8(const void* A, const void* sa, const void* W, const void* ws,
                        const void* bias, void* C, void* amax, int M, int N, int K,
                        int epilogue, cudaStream_t stream) {
  EpiArgs e{static_cast<const float*>(sa), static_cast<const bf16*>(ws),
            static_cast<const bf16*>(bias), C, nullptr, nullptr};
  float* mx = static_cast<float*>(amax);
  switch (epilogue) {
    case EPI_Q_BF16: return launch<int8_t, EPI_Q_BF16>(A, W, M, N, K, e, stream);
    case EPI_Q_QUICKGELU_F32:
      return launch<int8_t, EPI_Q_QUICKGELU_F32>(A, W, M, N, K, e, stream, mx);
    case EPI_Q_GELU_F32: return launch<int8_t, EPI_Q_GELU_F32>(A, W, M, N, K, e, stream, mx);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
