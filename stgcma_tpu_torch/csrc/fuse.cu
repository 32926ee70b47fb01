// Bidirectional gated cross-modal fusion (the STG-CMA exchange) of K4, K5, K6 and K12:
//   vo = vh + bf16(gv * softmax(vh . ah^T + mask) . ah)
//   ao = ah + bf16(ga * softmax(ah . vh^T + mask^T) . vh)
// per sequence b, with unscaled fp32 logits and an optional additive mask (Nv, Na).
//
// Replaces, in stgcma_tpu/ops/pallas_attn.py, K5 _win_fuse_kernel (:1222: one
// window per row, N = 49 at Swin stages 0-1), K6 _bidir_fuse_full_kernel
// (:1103) and _bidir_fuse_kernel (:1051: the full stage grid, N = 3136 or 784),
// and the two _fuse calls inside K4 _swin_block_kernel
// (stgcma_tpu/ops/pallas_swin_block.py:354: the masked one per window, through
// stg_fuse_bidir_win below, the unmasked one over the grid), and the two _xfuse
// calls inside K12 _fusion_block_kernel (stgcma_tpu/ops/pallas_clip_block.py:141:
// Nv = 197 video against Na = 49 audio tokens, D = 48, unmasked, without its pad
// to multiples of 16 and the pad keys' mask).
// The TPU kernels hold the whole (Nv, Na) fp32 gram on chip (39 MB at stage 0).
// An H100 block has at most 227 KB of shared memory, so this kernel tiles both
// directions flash-style: a block owns 128 query rows of one direction (8
// warps of 16 rows; 64 rows and 4 warps where neither direction has more than
// 64 query rows, as K5's and K4's 49-token windows, or where 128-row blocks
// would not fill two rounds of every SM), walks the other stream in
// tiles of 64 keys with a running max, sum and fp32 accumulator per row, and
// ends in the gated residual. The gram is computed once per direction.
// Bound on the H100: at D >= 48 the tensor cores (Swin-Large stage 0, D = 96:
// 0.458 ms for the gram and both probability products), at D = 16 the exps
// on the special function units (two a logit, one per direction: 0.376 ms at
// Swin-Base stage 0), at K5's windows the bytes of vh and ah.
// Design:
//   - One key tile serves both products. In the fusion the keys are the values,
//     so a tile lands once, keys-major (row stride D + 8 bf16, so that every
//     ldmatrix is free of bank conflicts): the gram's B fragments come through
//     ldmatrix, the p.v product's through ldmatrix.trans of the same rows, two
//     n-tiles of 8 dims a load (D / 8 is even at every width, D = 48 included).
//     Nothing is transposed element by element. K10 loads its value tile
//     beside the key tile in the same layout.
//   - The key tiles come through a ring of kStages = 3 stages by 16-byte
//     cp.async, two tiles in flight while the current one's grams, exps and
//     p.v run; one __syncthreads a tile. Keys past Nk are zero-filled. The
//     ring holds as many stages as the longest key stream has tiles, up to
//     three (one for the 49-token windows), so short streams keep their
//     shared memory small.
//   - mma.sync m16n8k16 (bf16 in, fp32 accumulate) for both products, the
//     probabilities' accumulator fragments reused as the A operand of p.v.
//     wgmma was not taken: its m64 tiles want 64 query rows a warpgroup with
//     the logits' softmax between the two products, i.e. P staged through
//     registers in wgmma's own fragment layout and a second warpgroup
//     ping-ponging to hide it (FlashAttention-3's design); at these widths
//     (k = 16..96 for the gram) each wgmma is a few instructions' work, and the
//     mma.sync loop keeps the softmax and both products in one warp's
//     registers with no cross-warp hand-off. PERF.md holds the measured times
//     against the tensor bound.
//   - Registers: a thread holds the accumulator (D / 2), one chunk of logits
//     (KC / 2: KC = 64 keys, 32 at D = 16) and, below D = 64, its q fragments
//     (D / 4); at D >= 64 the block's query rows wait in shared memory and
//     come by ldmatrix a chunk (Q_SMEM), so that two blocks of 8 warps share
//     an SM at 128 registers a thread (four at D = 16, 64 a thread). With q in
//     registers at D = 96 a thread took 230 registers, one block an SM, and
//     (80, 3136, 96) 2.88 ms on the H100 (tools/bench_parts.py), against 2.41
//     with q in shared memory. The ptxas counts of each build are in
//     build/kernels/<hash>/fuse.cu.log.
//   - Rows a block: 128 (8 warps) where a direction is longer than 64 rows and
//     such blocks give every SM two rounds of them; else 64 (4 warps), so a
//     short grid (K10 at 441 tokens: 320 blocks of 128) still fills the card.
//   - Exps: one ex2.approx a logit and direction, log2 e folded into one FMA,
//     p = ex2(s log2e - m log2e) (a few ulp of p, far below its bf16
//     rounding); where a mask is given, ex2((s - m) log2e), because a row
//     whose first keys are all masked has m ~ -1e30, where the folded form's
//     rounding of m log2e (~1e22) would not cancel. The running sum stays
//     per thread and is reduced over the quad once, at the end.
// Two TPU devices are left out on purpose: the single-exp column trick
// (exp(m_i - M), pallas_attn.py:1105-1116, :1137-1142), which is the non-exact
// softmax path, and the tiled exact form of _bidir_fuse_kernel (:1051), which
// carries column accumulators across a sequential grid that blocks on 132 SMs
// cannot share.
// Numerics: logits fp32 from bf16 operands; the unnormalized probabilities
// are rounded to bf16 for the p.v product (the plain version rounds the
// normalized ones: both are one bf16 rounding of each probability), the sum
// divides at the end exactly, gate * a2v is rounded to bf16 and added to the
// query stream, rounded again. Keys past the stream's end are -inf. A key
// chunk that is fully masked (-1e30) for a row gives exp(0) = 1 for each of
// its keys until a chunk with a real key arrives, whose max then wipes them
// (factor exp(-1e30 - m) = 0); every row of the port's masks has a real key,
// so the result is the masked softmax.
// D in {16, 32, 48, 64, 96}; any Nv, Na >= 1; sequences either contiguous
// (b * N + i) or, for K4's per-window fusion, windows read through a token
// table (stg_fuse_bidir_win: the masked full-grid fusion's cross-window
// entries are -1e30, whose exp is exactly 0 in fp32, so the per-window
// softmax is the same function, only the order of the non-zero fp32 terms
// differs).
//
// K10, unscaled attention o = softmax(q . k^T) . v (stg_unscaled_attn), is one
// direction of the same loop without gate and residual: keys k and values v
// are separate streams, o = bf16(acc / l) in the inputs' dtype. It replaces
// pallas_attn.py _attn_kernel (:137), which cross_modal_fuse_flash (:1039-1044)
// calls twice as K6's fallback (a2v = K10(vh, ah, ah), v2a = K10(ah, vh, vh))
// where a stage grid of >= 120 tokens is not a multiple of 16. The TPU pads Nk
// to 128 and masks the pad keys (nk_real); here keys past Nk are -inf in the
// ragged last tile, as above. Its probabilities are rounded to bf16 before
// the division, as above; _attn_kernel rounds them after it: one bf16 rounding
// of each either way. Bound: the exps on the special function units, one per
// logit (Nq * Nk a row). D = DV in {16, 32, 48, 64, 96}; any Nq, Nk >= 1.
#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kMaxWarps = 8;      // warps of a block, 16 query rows each
constexpr int kSmallRows = 64;    // directions of at most this many rows: blocks of 4 warps
constexpr int BK = 64;            // keys per tile
constexpr int kStages = 3;        // key tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int LD = D + 8;               // row stride (bf16): 48..208 bytes
  static constexpr int KC = D == 16 ? 32 : 64;   // keys per chunk of logits held in registers
  static constexpr int BYTES = BK * LD * 2;      // one key (or value) tile
  // blocks an SM the registers are held to: 4 (64 registers a thread) at D = 16, 2 (128)
  // above; at D >= 64 the q fragments stay in shared memory (Q_SMEM), read by ldmatrix
  // a chunk, so that the accumulator (D / 2 registers) and a chunk of logits fit
  static constexpr int MIN_BLOCKS = D == 16 ? 4 : 2;
  static constexpr bool Q_SMEM = D >= 64;
};

struct Dir {
  const bf16* q;      // (B, Nq, D): the query stream, also the residual
  const bf16* k;      // (B, Nk, D): keys (and values, where GATED)
  const bf16* v;      // (B, Nk, D): values (!GATED)
  const bf16* gate;   // (1,); null where !GATED
  bf16* out;          // (B, Nq, D)
  int Nq, Nk;
  int mrs, mcs;       // element (i, j) of this direction's mask at i * mrs + j * mcs
  int blocks;         // blocks of this direction (set by the launcher)
};

// Where row i of sequence b lies: b * N + i, or, with a token table (K4's
// windows), sequence b is window b % nW of batch row b / nW and its row i is
// token tab[(b % nW) * N + i] of that batch row's ntok
struct Seqs {
  const int* tab;
  int nW, ntok;
};

__device__ __forceinline__ size_t seq_row(const Seqs& s, int b, int N, int i) {
  if (s.tab == nullptr) return static_cast<size_t>(b) * N + i;
  return static_cast<size_t>(b / s.nW) * s.ntok + __ldg(s.tab + (b % s.nW) * N + i);
}

__device__ __forceinline__ uint32_t load2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// GATED: the fusion (both directions, keys = values, gated residual); else K10
// (one direction, separate values, o = a2v). Blocks [0, d0.blocks) take
// direction 0, the rest direction 1.
// ring: the key tiles the ring holds, min(kStages, the longest key stream's tiles)
template <int D, bool GATED>
__global__ void __launch_bounds__(kMaxWarps * 32, Tile<D>::MIN_BLOCKS) fuse_kernel(
    Dir d0, Dir d1, const float* mask, Seqs seqs, int ring) {
  constexpr int LD = Tile<D>::LD, KC = Tile<D>::KC;
  constexpr bool QS = Tile<D>::Q_SMEM;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int rows = static_cast<int>(blockDim.x) / 2;   // 16 query rows a warp
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // QS: the block's query rows
  bf16* ks = qs + (QS ? rows * LD : 0);           // the ring's key tiles
  bf16* vs = ks + ring * BK * LD;                 // K10: as many value tiles

  // each field selected on its own: a reference to one of the two parameter
  // structs would copy it to local memory
  const bool z = static_cast<int>(blockIdx.x) >= d0.blocks;
  const int blk = static_cast<int>(blockIdx.x) - (z ? d0.blocks : 0);
  const int Nq = z ? d1.Nq : d0.Nq, Nk = z ? d1.Nk : d0.Nk;
  const int mrs = z ? d1.mrs : d0.mrs, mcs = z ? d1.mcs : d0.mcs;
  const bf16* qg = z ? d1.q : d0.q;
  const bf16* kg = z ? d1.k : d0.k;
  const bf16* vg = GATED ? kg : d0.v;
  const int qtiles = ceil_div(Nq, rows);
  const int b = blk / qtiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (blk % qtiles) * rows;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's two query rows
  const size_t qo0 = r0 < Nq ? seq_row(seqs, b, Nq, r0) * D : 0;
  const size_t qo1 = r1 < Nq ? seq_row(seqs, b, Nq, r1) * D : 0;

  // one tile of 64 keys (and K10's values) into ring stage `stage`, 16 bytes a copy
  const int ntiles = ceil_div(Nk, BK);
  auto load_tile = [&](int tile, int stage) {
    bf16* kd = ks + stage * BK * LD;
    bf16* vd = vs + stage * BK * LD;
    for (int i = threadIdx.x; i < BK * (D / 8); i += blockDim.x) {
      const int j = i / (D / 8), c = (i % (D / 8)) * 8;
      const int key = tile * BK + j;
      const bool valid = key < Nk;
      const size_t off = valid ? seq_row(seqs, b, Nk, key) * D + c : 0;
      cp_async16(kd + j * LD + c, kg + off, valid);
      if constexpr (!GATED) cp_async16(vd + j * LD + c, vg + off, valid);
    }
  };
  if constexpr (QS) {                    // the query rows, in the first tile's group
    for (int i = threadIdx.x; i < rows * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool valid = q0 + r < Nq;
      const size_t off = valid ? seq_row(seqs, b, Nq, q0 + r) * D + c : 0;
      cp_async16(qs + r * LD + c, qg + off, valid);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }

  // the A fragments of q . k^T: held in registers, or (QS) read from shared memory
  // by ldmatrix (matrix l / 8: rows + 8 * ((l / 8) & 1), dims + 8 * (l / 16))
  uint32_t qa[QS ? 1 : D / 16][4];
  if constexpr (!QS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      qa[kk][0] = r0 < Nq ? load2(qg + qo0 + c0) : 0u;
      qa[kk][1] = r1 < Nq ? load2(qg + qo1 + c0) : 0u;
      qa[kk][2] = r0 < Nq ? load2(qg + qo0 + c0 + 8) : 0u;
      qa[kk][3] = r1 < Nq ? load2(qg + qo1 + c0 + 8) : 0u;
    }
  }
  const bf16* qrow = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // l: this thread's keys only

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();        // tile `it` has landed
    __syncthreads();                     // ... for every thread; the stage refilled below is free
    if (it + kStages - 1 < ntiles) load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* kt = ks + (it % kStages) * BK * LD;
    const bf16* vt = GATED ? kt : vs + (it % kStages) * BK * LD;

#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += KC) {
      const int j0 = it * BK + c0;
      if (j0 >= Nk) break;               // a chunk wholly past the keys (KC = 32)
      // logits: s[nt] holds keys j0 + nt*8 + 2t (+1) of rows r0 (elements 0, 1) and r1 (2, 3);
      // matrix l / 8 of a load: key rows of n-tile nt + l / 16, dims + 8 * ((l / 8) & 1)
      float s[KC / 8][4];
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = kt + (c0 + (lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        if constexpr (QS) {
          ldsm_x4(a, qrow + kk * 16);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        }
#pragma unroll
        for (int nt = 0; nt < KC / 8; nt += 2) {
          uint32_t bk[4];
          ldsm_x4(bk, krow + nt * 8 * LD + kk * 16);
          mma_bf16(s[nt], a[0], a[1], a[2], a[3], bk[0], bk[1]);
          mma_bf16(s[nt + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
        }
      }
      if (mask != nullptr || j0 + KC > Nk) {   // masked or ragged chunk
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + nt * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            if (key >= Nk) {
              s[nt][e] = -INFINITY;
            } else if (mask != nullptr && row < Nq) {
              s[nt][e] = __fadd_rn(s[nt][e], mask[static_cast<size_t>(row) * mrs +
                                                  static_cast<size_t>(key) * mcs]);
            }
          }
        }
      }
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) {
        tm0 = fmaxf(tm0, fmaxf(s[nt][0], s[nt][1]));
        tm1 = fmaxf(tm1, fmaxf(s[nt][2], s[nt][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(tm0)), mn1 = fmaxf(m1, quad_max(tm1));
      // exp(m_old - m_new): 0 on the first chunk (m_old = -inf)
      const float f0 = ex2(__fmul_rn(__fsub_rn(m0, mn0), kLog2e));
      const float f1 = ex2(__fmul_rn(__fsub_rn(m1, mn1), kLog2e));
      m0 = mn0;
      m1 = mn1;
      if (mask == nullptr) {
        const float ms0 = __fmul_rn(m0, kLog2e), ms1 = __fmul_rn(m1, kLog2e);
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt) {
          s[nt][0] = ex2(__fmaf_rn(s[nt][0], kLog2e, -ms0));
          s[nt][1] = ex2(__fmaf_rn(s[nt][1], kLog2e, -ms0));
          s[nt][2] = ex2(__fmaf_rn(s[nt][2], kLog2e, -ms1));
          s[nt][3] = ex2(__fmaf_rn(s[nt][3], kLog2e, -ms1));
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt) {
          s[nt][0] = ex2(__fmul_rn(__fsub_rn(s[nt][0], m0), kLog2e));
          s[nt][1] = ex2(__fmul_rn(__fsub_rn(s[nt][1], m0), kLog2e));
          s[nt][2] = ex2(__fmul_rn(__fsub_rn(s[nt][2], m1), kLog2e));
          s[nt][3] = ex2(__fmul_rn(__fsub_rn(s[nt][3], m1), kLog2e));
        }
      }
      float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) {
        ts0 += s[nt][0] + s[nt][1];
        ts1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * f0 + ts0;
      l1 = l1 * f1 + ts1;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        acc[nd][0] *= f0;
        acc[nd][1] *= f0;
        acc[nd][2] *= f1;
        acc[nd][3] *= f1;
      }
      // p.v: two logit tiles make one A fragment; matrix l / 8 of a .trans load:
      // keys + 8 * ((l / 8) & 1), dims of n-tile nd + l / 16: the b0, b1 of two n-tiles
      const bf16* vrow = vt + (c0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < KC / 16; ++kc) {
        const uint32_t a0 = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
        const uint32_t a1 = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
        const uint32_t a2 = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        const uint32_t a3 = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int nd = 0; nd < D / 8; nd += 2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vrow + kc * 16 * LD + nd * 8);
          mma_bf16(acc[nd], a0, a1, a2, a3, bv[0], bv[1]);
          mma_bf16(acc[nd + 1], a0, a1, a2, a3, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();                    // no copy outlives the block
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // out = q + bf16(gate * a2v), rounded to bf16; K10: out = bf16(a2v)
  const float gate = GATED ? __bfloat162float(*(z ? d1.gate : d0.gate)) : 0.f;
  bf16* ob = z ? d1.out : d0.out;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if ((h == 0 ? r0 : r1) >= Nq) continue;
      const float l = h == 0 ? l0 : l1;
      const size_t i = (h == 0 ? qo0 : qo1) + col;
      if constexpr (!GATED) {
        *reinterpret_cast<__nv_bfloat162*>(ob + i) =
            __floats2bfloat162_rn(__fdiv_rn(acc[nd][2 * h], l), __fdiv_rn(acc[nd][2 * h + 1], l));
        continue;
      }
      const float2 q2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qg + i));
      const float u0 = __bfloat162float(__float2bfloat16_rn(
          __fmul_rn(gate, __fdiv_rn(acc[nd][2 * h], l))));
      const float u1 = __bfloat162float(__float2bfloat16_rn(
          __fmul_rn(gate, __fdiv_rn(acc[nd][2 * h + 1], l))));
      *reinterpret_cast<__nv_bfloat162*>(ob + i) =
          __floats2bfloat162_rn(__fadd_rn(q2.x, u0), __fadd_rn(q2.y, u1));
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// blocks of both directions at `rows` query rows a block, B sequences each
long long blocks_at(const Dir& d0, const Dir& d1, bool gated, int B, int rows) {
  return static_cast<long long>(B) * (ceil_div(d0.Nq, rows) + (gated ? ceil_div(d1.Nq, rows) : 0));
}

// B sequences a direction; blocks of 8 warps (128 query rows), or of 4 where no
// direction has more than kSmallRows rows or where 128-row blocks would not give
// every SM two rounds of blocks (K10 at 441 tokens: 320 blocks)
template <int D, bool GATED>
int launch(Dir d0, Dir d1, const float* mask, const Seqs& seqs, int B, cudaStream_t stream) {
  const int nmax = GATED && d1.Nq > d0.Nq ? d1.Nq : d0.Nq;
  const bool wide = nmax > kSmallRows && blocks_at(d0, d1, GATED, B, 16 * kMaxWarps) >=
                                             2LL * Tile<D>::MIN_BLOCKS * sm_count();
  const int warps = wide ? kMaxWarps : kMaxWarps / 2;
  const int rows = 16 * warps;
  const int nk = GATED && d1.Nk > d0.Nk ? d1.Nk : d0.Nk;
  const int ring = ceil_div(nk, BK) < kStages ? ceil_div(nk, BK) : kStages;
  const long long b0 = static_cast<long long>(B) * ceil_div(d0.Nq, rows);
  const long long b1 = GATED ? static_cast<long long>(B) * ceil_div(d1.Nq, rows) : 0;
  if (b0 + b1 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  d0.blocks = static_cast<int>(b0);
  d1.blocks = static_cast<int>(b1);
  const int smem = (Tile<D>::Q_SMEM ? rows * Tile<D>::LD * 2 : 0) +
                   ring * Tile<D>::BYTES * (GATED ? 1 : 2);
  auto kernel = fuse_kernel<D, GATED>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(b0 + b1), warps * 32, smem, stream>>>(d0, d1, mask, seqs, ring);
  return static_cast<int>(cudaGetLastError());
}

template <bool GATED>
int launch_d(const Dir& d0, const Dir& d1, const float* mask, const Seqs& seqs, int B, int D,
             cudaStream_t stream) {
  if (D == 16) return launch<16, GATED>(d0, d1, mask, seqs, B, stream);
  if (D == 32) return launch<32, GATED>(d0, d1, mask, seqs, B, stream);
  if (D == 48) return launch<48, GATED>(d0, d1, mask, seqs, B, stream);
  if (D == 64) return launch<64, GATED>(d0, d1, mask, seqs, B, stream);
  if (D == 96) return launch<96, GATED>(d0, d1, mask, seqs, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// vh (B, Nv, D), ah (B, Na, D), vo/ao likewise, all bf16 and contiguous; gv, ga: (1,)
// bf16; mask: nullable (Nv, Na) fp32, added to the (Nv, Na) gram in both directions.
// D in {16, 32, 48, 64, 96}; any B whose blocks fit a 1-D grid (the launcher's guard).
STG_API int stg_fuse_bidir(const void* vh, const void* ah, const void* gv, const void* ga,
                           const void* mask, void* vo, void* ao, int B, int Nv, int Na, int D,
                           cudaStream_t stream) {
  if (B < 1 || Nv < 1 || Na < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* v = static_cast<const bf16*>(vh);
  const bf16* a = static_cast<const bf16*>(ah);
  const Dir d0{v, a, a, static_cast<const bf16*>(gv), static_cast<bf16*>(vo), Nv, Na, Na, 1, 0};
  const Dir d1{a, v, v, static_cast<const bf16*>(ga), static_cast<bf16*>(ao), Na, Nv, 1, Na, 0};
  return launch_d<true>(d0, d1, static_cast<const float*>(mask), Seqs{nullptr, 1, 0}, B, D,
                        stream);
}

// K4's masked fusion per window: vh, ah, vo, ao (B, ntok, D) bf16, contiguous; tab
// (nW * N,) int32, the tokens of window w at tab[w * N .. w * N + N - 1], every token
// of [0, ntok) once (nW * N = ntok); each of the B * nW windows fuses its N tokens of
// vh with its N tokens of ah, unmasked, and writes them back at their own rows.
// D in {16, 32, 48, 64, 96}; B * nW windows, at most 2^31 - 1.
STG_API int stg_fuse_bidir_win(const void* vh, const void* ah, const void* gv, const void* ga,
                               const void* tab, int nW, void* vo, void* ao, int B, int ntok,
                               int N, int D, cudaStream_t stream) {
  const long long windows = static_cast<long long>(B) * nW;
  if (B < 1 || nW < 1 || N < 1 || static_cast<long long>(nW) * N != ntok ||
      windows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* v = static_cast<const bf16*>(vh);
  const bf16* a = static_cast<const bf16*>(ah);
  const Dir d0{v, a, a, static_cast<const bf16*>(gv), static_cast<bf16*>(vo), N, N, 0, 0, 0};
  const Dir d1{a, v, v, static_cast<const bf16*>(ga), static_cast<bf16*>(ao), N, N, 0, 0, 0};
  return launch_d<true>(d0, d1, nullptr, Seqs{static_cast<const int*>(tab), nW, ntok},
                        static_cast<int>(windows), D, stream);
}

// K10: q (B, Nq, D), k and v (B, Nk, D), o (B, Nq, D), all bf16 and contiguous:
// o = softmax(q . k^T) . v, unscaled. D in {16, 32, 48, 64, 96}; any B whose blocks fit a
// 1-D grid.
STG_API int stg_unscaled_attn(const void* q, const void* k, const void* v, void* o, int B,
                              int Nq, int Nk, int D, cudaStream_t stream) {
  if (B < 1 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Dir d{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), nullptr, static_cast<bf16*>(o), Nq, Nk, 0, 0, 0};
  return launch_d<false>(d, d, nullptr, Seqs{nullptr, 1, 0}, B, D, stream);
}
