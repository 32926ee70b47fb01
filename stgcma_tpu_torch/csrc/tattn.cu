// The temporal product T: the qkv product of K13 and of K11's temporal site
// with every sequence's attention over its T <= 16 frames in the product's
// epilogue, o = merged heads of softmax(q . k^T) . v, from bf16 rows or from
// int8 row codes with their scales. The (M, 3C) qkv slab never reaches
// device memory.
//
// Replaces, inside stgcma_tpu/ops/pallas_clip_block.py _tadapt_kernel (:350),
// stgcma_tpu/ops/pallas_attn.py _win_block_qd_kernel (:1486) and
// _tblock_v2_kernel (:1757), the qkv dot and the per-sequence core that the
// port ran as two launches (gemm.cu, then attn.cu's small kernel over 16-row
// mma tiles for 10 rows, or K14's core reading each token's frames N rows
// apart), with the slab written and read back between them (145 MB at
// CLIP-B/16's video rows, M = 15760). Rounding points are K13's and K2's (and
// K14's: the same): qkv + bias rounded to bf16 (int8: float(acc) * sa[m] *
// ws[n] + bias first), q times bf16(dh^-1/2)
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
// Frame-strided sequences (K14: rows (b T + t) N + n of the tower's (B T, N, C)
// layout, token n of clip b at frame t): a tile is ntok tokens by the T
// frames of one clip, loaded as one 3-D TMA box over A viewed as (B T, N, C)
// (ntok = ceil(N / ceil(N / floor(128 / T))): tiles of a clip balanced, tokens
// past N zero-filled). The box lands frame-major, row t ntok + j; the epilogue
// stages accumulator row t ntok + j at row j T + t, so that the staged tile
// holds whole sequences one after another as K13's does and the bands, masks
// and grams are K13's; the row scales sa and the output rows are addressed
// through the same map. The rows of the ring past a box's ntok T stay zeros
// (set once), so that every staged row is finite. A 4-D box that lands
// token-major needs non-monotonic strides; the 3-D box and the permutation in
// the staging, which writes every row once anyway, need nothing new.
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
// before the band) or 8 (the whole tile). FS: frame-strided sequences, N tokens a
// frame, ntok a tile (tm_a a 3-D map); else contiguous ones (N, ntok unused)
template <typename Op, int DH, int KT, bool FS>
__global__ void __launch_bounds__(TATTN_THREADS, 1) tattn_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, int M,
    int C, int T, int heads, int N, int ntok, float scale, const float* __restrict__ sa,
    const bf16* __restrict__ ws, const bf16* __restrict__ bias, bf16* __restrict__ o) {
  using L = TTile<DH>;
  using Acc = typename OpType<Op>::Acc;
  constexpr int BK = WG_BK_BYTES / static_cast<int>(sizeof(Op));
  constexpr int NQ = L::N, LDQ = L::LDQ;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* staged = reinterpret_cast<bf16*>(smem + TATTN_STAGES * L::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TATTN_STAGES * L::STAGE_BYTES + L::STAGED);
  uint64_t* empty = full + TATTN_STAGES;
  const int step = (TATTN_BM / T) * T;      // contiguous: rows a tile advances, whole sequences
  const int span = FS ? ntok * T : step;    // rows a tile's box loads
  const int tpc = FS ? ceil_div(N, ntok) : 1;   // frame-strided: tiles a clip
  const int tiles = (FS ? M / (T * N) * tpc : ceil_div(M, step)) * heads;
  const int ktiles = ceil_div(C, BK);
  const int wg = threadIdx.x / 128;
  const int a_bytes = FS ? span * WG_BK_BYTES : L::A_BYTES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TATTN_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);              // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (FS) {                       // the ring's rows that no box reaches: zeros
    const int n16 = (L::A_BYTES - a_bytes) / 16;
    for (int i = threadIdx.x; i < TATTN_STAGES * n16; i += TATTN_THREADS)
      reinterpret_cast<uint4*>(smem + (i / n16) * L::STAGE_BYTES + a_bytes)[i % n16] =
          make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == 2) {                            // producer: one thread issues every load
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int bi = tile / heads, h = tile % heads;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % TATTN_STAGES;
          mbar_wait(&empty[s], ((it / TATTN_STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], a_bytes + 3 * L::SLAB_BYTES);   // boxes past N count whole
          uint8_t* st = smem + s * L::STAGE_BYTES;
          if constexpr (FS)                 // tokens (bi % tpc) ntok.. of clip bi / tpc, T frames
            tma_load_3d(st, &tm_a, kt * BK, (bi % tpc) * ntok, (bi / tpc) * T, &full[s]);
          else
            tma_load(st, &tm_a, kt * BK, bi * step, &full[s]);
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
  Acc acc[NQ / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bi = tile / heads, h = tile % heads;
    // the tile's rows: contiguous from m0, or tokens n0.. of clip b (rows (b T + t) N + n)
    const int m0 = bi * step, b = FS ? bi / tpc : 0, n0 = FS ? (bi % tpc) * ntok : 0;
    // rows of the tile's whole sequences, in the staged (sequence-major) order
    const int valid = FS ? min(ntok, N - n0) * T : min(step, M - m0);
    // the staged row of accumulator row r (frame-strided: t ntok + j -> j T + t) and
    // the row of A and O of staged row r
    const auto staged_row = [&](int r) { return FS && r < span ? (r % ntok) * T + r / ntok : r; };
    const auto global_row = [&](int r) {
      return FS ? static_cast<size_t>(b * T + r % T) * N + n0 + r / T
                : static_cast<size_t>(m0 + r);
    };
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) acc[i] = 0;
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
    const int rs[2] = {staged_row(band + g), staged_row(band + g + 8)};
    float sr[2] = {0.f, 0.f};
    if constexpr (sizeof(Op) == 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (rs[hh] < valid) sr[hh] = sa[global_row(rs[hh])];
    }
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
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
        *reinterpret_cast<uint32_t*>(staged + rs[hh] * LDQ + n) = pack_bf16x2(v0, v1);
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
      bf16* orow = o + global_row(r) * C + h * DH + 2 * t;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
        *reinterpret_cast<uint32_t*>(orow + nd * 8) =
            pack_bf16x2(od[nd][2 * hh], od[nd][2 * hh + 1]);
    }
  }
}

template <typename Op, int DH, int KT, bool FS>
int launch_kt(const CUtensorMap& tm_a, const CUtensorMap& tm_w, int M, int C, int T, int heads,
              int N, int ntok, float scale, const float* sa, const bf16* ws, const bf16* bias,
              bf16* o, cudaStream_t stream) {
  // once a process (the port runs on one card): the SM count and the shared-memory limit
  static int sms = 0;
  auto kernel = tattn_kernel<Op, DH, KT, FS>;
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
  const long long tiles =
      (FS ? static_cast<long long>(M / (T * N)) * ceil_div(N, ntok)
          : static_cast<long long>(ceil_div(M, (TATTN_BM / T) * T))) * heads;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  kernel<<<grid, TATTN_THREADS, TTile<DH>::SMEM, stream>>>(tm_a, tm_w, M, C, T, heads, N, ntok,
                                                           scale, sa, ws, bias, o);
  return static_cast<int>(cudaGetLastError());
}

// A (M, C) and W (3C, C) of Op, K-major. N == 0: T frames a contiguous sequence (M a
// multiple of T on the port's route; a ragged last sequence is cut), 1 <= T <=
// TATTN_BM. N > 0: A is the (M / (T N), T, N, C) layout, the sequence of token n of
// clip b its T frames N rows apart, T <= TATTN_MAX_FRAMES
template <typename Op, int DH>
int launch(const void* A, const void* W, const float* sa, const bf16* ws, const bf16* bias,
           bf16* o, int M, int C, int T, int heads, int N, float scale, cudaStream_t stream) {
  CUtensorMap tm_a, tm_w;
  int err = tensor_map<Op>(&tm_w, W, 3 * C, C, DH);
  if (err != 0) return err;
  if (N > 0) {
    const int tpc = ceil_div(N, TATTN_BM / T);     // tiles a clip
    const int ntok = ceil_div(N, tpc);             // tokens a tile, balanced over the clip
    err = tensor_map_3d<Op>(&tm_a, A, M / N, N, C, T, ntok);
    if (err != 0) return err;
    return launch_kt<Op, DH, 3, true>(tm_a, tm_w, M, C, T, heads, N, ntok, scale, sa, ws, bias, o,
                                      stream);
  }
  err = tensor_map<Op>(&tm_a, A, M, C, TATTN_BM);
  if (err != 0) return err;
  if (T <= TATTN_MAX_FRAMES)
    return launch_kt<Op, DH, 3, false>(tm_a, tm_w, M, C, T, heads, 0, 0, scale, sa, ws, bias, o,
                                       stream);
  return launch_kt<Op, DH, 8, false>(tm_a, tm_w, M, C, T, heads, 0, 0, scale, sa, ws, bias, o,
                                     stream);
}

template <typename Op>
int dispatch(const void* A, const void* W, const float* sa, const bf16* ws, const void* bias,
             void* O, int M, int C, int T, int heads, int N, float scale, cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 1 || T < 1 || T > TATTN_BM || heads < 1 || C % heads || N < 0 ||
      (N > 0 && (T > TATTN_MAX_FRAMES || M % (T * N))) ||
      (C * static_cast<int>(sizeof(Op))) % TMA_ROW_ALIGN || misaligned(A) || misaligned(W) ||
      misaligned(O) || bias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* b = static_cast<const bf16*>(bias);
  bf16* o = static_cast<bf16*>(O);
  if (C / heads == 64) return launch<Op, 64>(A, W, sa, ws, b, o, M, C, T, heads, N, scale, stream);
  if (C / heads == 32) return launch<Op, 32>(A, W, sa, ws, b, o, M, C, T, heads, N, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// O (M, C) bf16 = merged heads of each sequence's attention over its T frames, from
// qkv = A (M, C) . W (3C, C)^T + bias; all bf16, contiguous, 16-byte aligned; C a
// multiple of 8, C / heads in {32, 64}; scale = bf16(dh^-1/2). N = 0: a sequence is
// T consecutive rows; N > 0: A and O are (M / (T N), T, N, C), a sequence the T
// frames of one token, N rows apart (T <= 16, M a multiple of T N)
STG_API int stg_tattn_bf16(const void* A, const void* W, const void* bias, void* O, int M, int C,
                           int T, int heads, int N, float scale, cudaStream_t stream) {
  return dispatch<bf16>(A, W, nullptr, nullptr, bias, O, M, C, T, heads, N, scale, stream);
}

// the same from int8 row codes A (M, C) with scales sa (M,) fp32 and int8 W (3C, C)
// with scales ws (3C,) bf16: qkv = float(A . W^T) * sa[m] * ws[n] + bias[n]; C a
// multiple of 16
STG_API int stg_tattn_s8(const void* A, const void* sa, const void* W, const void* ws,
                         const void* bias, void* O, int M, int C, int T, int heads, int N,
                         float scale, cudaStream_t stream) {
  if (sa == nullptr || ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t>(A, W, static_cast<const float*>(sa), static_cast<const bf16*>(ws),
                          bias, O, M, C, T, heads, N, scale, stream);
}
