// The temporal product T: the qkv product of K13 and of K11's temporal site
// with every sequence's attention over its T <= 16 frames in the product's
// epilogue, o = merged heads of softmax(q . k^T) . v, from bf16 rows or from
// int8 row codes with their scales. The (M, 3C) qkv slab never reaches
// device memory.
//
// Replaces, inside stgcma_tpu/ops/pallas_clip_block.py _tadapt_kernel (:350)
// and stgcma_tpu/ops/pallas_attn.py _win_block_qd_kernel (:1486), the qkv
// dot and the per-sequence core that the port ran as two launches (gemm.cu,
// then attn.cu's small kernel over 16-row mma tiles for 10 rows), with the
// slab written and read back between them (145 MB at CLIP-B/16's video rows,
// M = 15760). Rounding points are K13's and K2's: qkv + bias rounded to bf16
// (int8: float(acc) * sa[m] * ws[n] + bias first), q times bf16(dh^-1/2)
// rounded again, fp32 logits, exact softmax (expf, a correctly rounded
// division), p rounded to bf16, p . v summed in fp32 and rounded.
// Bound on the H100: the product's operations (2 M C 3C) against x read and o
// written once; the grams are T / (3C) of them.
// Design: a block is two consumer warpgroups and one producer warp (288
// threads), persistent, one an SM. Its tile is 128 rows by one head's q, k and
// v columns: three TMA boxes of dh rows of W_qkv (rows h dh, C + h dh, 2C + h
// dh; no permuted copy of the weights) land side by side as one 3 dh-row
// operand, and each warpgroup runs wgmma m64 x n(3 dh) on the TMA ring of
// gemm.cu (bf16 k16 or s8 k32). The row tile holds whole sequences: it steps
// by floor(128 / T) T rows, and the rows past its last whole sequence are
// loaded but masked. The epilogue stages the tile's q (scaled), k and v in
// bf16 in shared memory (rows at stride 3 dh + 8, ldmatrix without bank
// conflicts), then each warp takes a band of 16 query rows and runs their
// sequences' grams on mma.sync: the keys of a row's sequence lie within the
// 48 rows from 16 before its band (three 16-key tiles, T <= 16), the logits
// outside its own sequence are masked, and p . v takes P from the logits'
// registers. The producer runs ahead into the next tile while the epilogue
// runs. Longer sequences (up to the 128 rows of a tile) take all eight key
// tiles: not on the port's route, which sends T <= TATTN_MAX_FRAMES here.
#include <math.h>

#include <type_traits>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TATTN_BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int TATTN_MAX_FRAMES = 16;   // frames a sequence on the port's route: three key tiles
constexpr int TATTN_STAGES = 4;
constexpr int TATTN_THREADS = 288;     // two consumer warpgroups + one producer warp
constexpr int kConsumers = 256;

template <int DH>
struct TTile {
  static constexpr int N = 3 * DH;                        // one head's q, k and v columns
  static constexpr int A_BYTES = TATTN_BM * WG_BK_BYTES;
  static constexpr int SLAB_BYTES = DH * WG_BK_BYTES;     // one TMA box of W_qkv
  static constexpr int STAGE_BYTES = A_BYTES + 3 * SLAB_BYTES;
  static constexpr int LDQ = N + 8;                       // staged row stride (bf16)
  static constexpr int STAGED = TATTN_BM * LDQ * 2;
  // the ring, the staged tile, the 2 * STAGES mbarriers and room to align the ring
  static constexpr int SMEM = TATTN_STAGES * STAGE_BYTES + STAGED + 2 * TATTN_STAGES * 8 + 1024;
};

// the qkv value of accumulator `acc` at column gcol of W_qkv, rounded to bf16
template <typename Acc>
__device__ __forceinline__ float qkv_value(Acc acc, float sa, const bf16* ws, const bf16* bias,
                                           int gcol) {
  float v;
  if constexpr (std::is_integral<Acc>::value) {     // int8 operands
    v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), __bfloat162float(ws[gcol]));
  } else {
    v = acc;
  }
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(v, __bfloat162float(bias[gcol]))));
}

// KT: key tiles of 16 rows a query band reads, 3 (T <= TATTN_MAX_FRAMES: from 16 rows
// before the band) or 8 (the whole tile)
template <typename Op, int DH, int KT>
__global__ void __launch_bounds__(TATTN_THREADS, 1) tattn_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, int M,
    int C, int T, int heads, float scale, const float* __restrict__ sa,
    const bf16* __restrict__ ws, const bf16* __restrict__ bias, bf16* __restrict__ o) {
  using L = TTile<DH>;
  using Acc = typename OpType<Op>::Acc;
  constexpr int BK = WG_BK_BYTES / static_cast<int>(sizeof(Op));
  constexpr int N = L::N, LDQ = L::LDQ;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* staged = reinterpret_cast<bf16*>(smem + TATTN_STAGES * L::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TATTN_STAGES * L::STAGE_BYTES + L::STAGED);
  uint64_t* empty = full + TATTN_STAGES;
  const int step = (TATTN_BM / T) * T;      // rows a tile advances: whole sequences
  const int tiles = ceil_div(M, step) * heads;
  const int ktiles = ceil_div(C, BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TATTN_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);              // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {                            // producer: one thread issues every load
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / heads) * step, h = tile % heads;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % TATTN_STAGES;
          mbar_wait(&empty[s], ((it / TATTN_STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::STAGE_BYTES);
          uint8_t* st = smem + s * L::STAGE_BYTES;
          tma_load(st, &tm_a, kt * BK, m0, &full[s]);
#pragma unroll
          for (int j = 0; j < 3; ++j)       // the q, k and v slabs of head h
            tma_load(st + L::A_BYTES + j * L::SLAB_BYTES, &tm_w, kt * BK, j * C + h * DH,
                     &full[s]);
        }
      }
    }
    return;
  }

  const int c = wg;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int band = (c * 4 + warp) * 16;     // this warp's 16 query rows of the tile
  Acc acc[N / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / heads) * step, h = tile % heads;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % TATTN_STAGES;
      mbar_wait(&full[s], (it / TATTN_STAGES) & 1);
      const uint8_t* st = smem + s * L::STAGE_BYTES;
      const uint64_t da = smem_desc(st + c * 64 * WG_BK_BYTES);
      const uint64_t db = smem_desc(st + L::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < WG_BK_BYTES / WG_KSTEP_BYTES; ++k)   // +32 bytes: +2 in a descriptor
        wgmma_step(acc, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // qkv + bias rounded to bf16, q scaled and rounded again, into the staged tile;
    // accumulator j * 4 + 2 * hh + i: row band + g + 8 hh, column j * 8 + 2 t + i
    bar_sync(1, kConsumers);                // every warp is done with the last tile's rows
    const int valid = min(step, M - m0);    // rows of the tile's whole sequences
    float sr[2] = {0.f, 0.f};
    if constexpr (sizeof(Op) == 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (band + g + 8 * hh < valid) sr[hh] = sa[m0 + band + g + 8 * hh];
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int slab = (j * 8) / DH;        // 0: q, 1: k, 2: v
      const int n = j * 8 + 2 * t;
      const int gcol = slab * C + h * DH + (n - slab * DH);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v0 = qkv_value(acc[j * 4 + 2 * hh], sr[hh], ws, bias, gcol);
        float v1 = qkv_value(acc[j * 4 + 2 * hh + 1], sr[hh], ws, bias, gcol + 1);
        if (slab == 0) {
          v0 = __fmul_rn(v0, scale);
          v1 = __fmul_rn(v1, scale);
        }
        *reinterpret_cast<uint32_t*>(staged + (band + g + 8 * hh) * LDQ + n) = pack_bf16x2(v0, v1);
      }
    }
    bar_sync(1, kConsumers);
    if (band >= valid) continue;

    // the band's grams over the key tiles [kbase, kbase + 16 KT) of the staged tile:
    // s[2 kt + nt] holds keys kbase + 16 kt + 8 nt + 2 t (+1) of rows r0 (elements 0,
    // 1) and r1 (2, 3); tiles wholly outside [0, valid) are skipped (warp-uniform)
    const int kbase = KT == 3 ? band - 16 : 0;
    const int r0 = band + g, r1 = r0 + 8;
    uint32_t qa[DH / 16][4];
    const bf16* qrow = staged + (band + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) ldsm_x4(qa[kk], qrow + kk * 16);
    float sc[2 * KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int kb = kbase + 16 * kt;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        sc[2 * kt + nt][0] = sc[2 * kt + nt][1] = sc[2 * kt + nt][2] = sc[2 * kt + nt][3] = 0.f;
      if (kb < 0 || kb >= valid) continue;
      const bf16* krow = staged + (kb + (lane >> 4) * 8 + (lane & 7)) * LDQ + DH +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, krow + kk * 16);
        mma_bf16(sc[2 * kt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bk[0], bk[1]);
        mma_bf16(sc[2 * kt + 1], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bk[2], bk[3]);
      }
    }
    // each row's keys: its own sequence [lo, hi), cut at the tile's valid rows
    const int lo0 = (r0 / T) * T, lo1 = (r1 / T) * T;
    const int hi0 = min(lo0 + T, valid), hi1 = min(lo1 + T, valid);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kbase + 16 * kt + 8 * nt + 2 * t + (e & 1);
          const bool in = e < 2 ? (key >= lo0 && key < hi0) : (key >= lo1 && key < hi1);
          if (!in) sc[2 * kt + nt][e] = -INFINITY;
          if (e < 2) mx0 = fmaxf(mx0, sc[2 * kt + nt][e]);
          else mx1 = fmaxf(mx1, sc[2 * kt + nt][e]);
        }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    if (mx0 == -INFINITY) mx0 = 0.f;        // a row past the tile's sequences: p = 0
    if (mx1 == -INFINITY) mx1 = 0.f;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * KT; ++i) {
      sc[i][0] = expf(__fsub_rn(sc[i][0], mx0));
      sc[i][1] = expf(__fsub_rn(sc[i][1], mx0));
      sc[i][2] = expf(__fsub_rn(sc[i][2], mx1));
      sc[i][3] = expf(__fsub_rn(sc[i][3], mx1));
      l0 += sc[i][0] + sc[i][1];
      l1 += sc[i][2] + sc[i][3];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    l0 = l0 > 0.f ? l0 : 1.f;
    l1 = l1 > 0.f ? l1 : 1.f;

    // p . v: two logit tiles make one A fragment, p rounded to bf16 after the
    // division; V's b0, b1 of two dim tiles a .trans load
    float od[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) od[nd][0] = od[nd][1] = od[nd][2] = od[nd][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int kb = kbase + 16 * kt;
      if (kb < 0 || kb >= valid) continue;
      const uint32_t a0 =
          pack_bf16x2(__fdiv_rn(sc[2 * kt][0], l0), __fdiv_rn(sc[2 * kt][1], l0));
      const uint32_t a1 =
          pack_bf16x2(__fdiv_rn(sc[2 * kt][2], l1), __fdiv_rn(sc[2 * kt][3], l1));
      const uint32_t a2 =
          pack_bf16x2(__fdiv_rn(sc[2 * kt + 1][0], l0), __fdiv_rn(sc[2 * kt + 1][1], l0));
      const uint32_t a3 =
          pack_bf16x2(__fdiv_rn(sc[2 * kt + 1][2], l1), __fdiv_rn(sc[2 * kt + 1][3], l1));
      const bf16* vrow = staged + (kb + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + 2 * DH +
                         (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < DH / 8; nd += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vrow + nd * 8);
        mma_bf16(od[nd], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16(od[nd + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
    // the head's output columns of the merged heads (M, C), rounded to bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh == 0 ? r0 : r1;
      if (r >= valid) continue;
      bf16* orow = o + static_cast<size_t>(m0 + r) * C + h * DH + 2 * t;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
        *reinterpret_cast<uint32_t*>(orow + nd * 8) =
            pack_bf16x2(od[nd][2 * hh], od[nd][2 * hh + 1]);
    }
  }
}

template <typename Op, int DH, int KT>
int launch_kt(const CUtensorMap& tm_a, const CUtensorMap& tm_w, int M, int C, int T, int heads,
              float scale, const float* sa, const bf16* ws, const bf16* bias, bf16* o,
              cudaStream_t stream) {
  // once a process (the port runs on one card): the SM count and the shared-memory limit
  static int sms = 0;
  auto kernel = tattn_kernel<Op, DH, KT>;
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TTile<DH>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms = n;
  }
  const int step = (TATTN_BM / T) * T;
  const long long tiles = static_cast<long long>(ceil_div(M, step)) * heads;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  kernel<<<grid, TATTN_THREADS, TTile<DH>::SMEM, stream>>>(tm_a, tm_w, M, C, T, heads, scale, sa,
                                                           ws, bias, o);
  return static_cast<int>(cudaGetLastError());
}

// A (M, C) and W (3C, C) of Op, K-major; T frames a sequence (M a multiple of T on
// the port's route; a ragged last sequence is cut), 1 <= T <= TATTN_BM
template <typename Op, int DH>
int launch(const void* A, const void* W, const float* sa, const bf16* ws, const bf16* bias,
           bf16* o, int M, int C, int T, int heads, float scale, cudaStream_t stream) {
  CUtensorMap tm_a, tm_w;
  int err = tensor_map<Op>(&tm_a, A, M, C, TATTN_BM);
  if (err == 0) err = tensor_map<Op>(&tm_w, W, 3 * C, C, DH);
  if (err != 0) return err;
  if (T <= TATTN_MAX_FRAMES)
    return launch_kt<Op, DH, 3>(tm_a, tm_w, M, C, T, heads, scale, sa, ws, bias, o, stream);
  return launch_kt<Op, DH, 8>(tm_a, tm_w, M, C, T, heads, scale, sa, ws, bias, o, stream);
}

template <typename Op>
int dispatch(const void* A, const void* W, const float* sa, const bf16* ws, const void* bias,
             void* O, int M, int C, int T, int heads, float scale, cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 1 || T < 1 || T > TATTN_BM || heads < 1 || C % heads ||
      (C * static_cast<int>(sizeof(Op))) % TMA_ROW_ALIGN || misaligned(A) || misaligned(W) ||
      misaligned(O) || bias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* b = static_cast<const bf16*>(bias);
  bf16* o = static_cast<bf16*>(O);
  if (C / heads == 64) return launch<Op, 64>(A, W, sa, ws, b, o, M, C, T, heads, scale, stream);
  if (C / heads == 32) return launch<Op, 32>(A, W, sa, ws, b, o, M, C, T, heads, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// O (M, C) bf16 = merged heads of each sequence's attention over its T frames, from
// qkv = A (M, C) . W (3C, C)^T + bias; all bf16, contiguous, 16-byte aligned; C a
// multiple of 8, C / heads in {32, 64}; scale = bf16(dh^-1/2)
STG_API int stg_tattn_bf16(const void* A, const void* W, const void* bias, void* O, int M, int C,
                           int T, int heads, float scale, cudaStream_t stream) {
  return dispatch<bf16>(A, W, nullptr, nullptr, bias, O, M, C, T, heads, scale, stream);
}

// the same from int8 row codes A (M, C) with scales sa (M,) fp32 and int8 W (3C, C)
// with scales ws (3C,) bf16: qkv = float(A . W^T) * sa[m] * ws[n] + bias[n]; C a
// multiple of 16
STG_API int stg_tattn_s8(const void* A, const void* sa, const void* W, const void* ws,
                         const void* bias, void* O, int M, int C, int T, int heads, float scale,
                         cudaStream_t stream) {
  if (sa == nullptr || ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t>(A, W, static_cast<const float*>(sa), static_cast<const bf16*>(ws),
                          bias, O, M, C, T, heads, scale, stream);
}
