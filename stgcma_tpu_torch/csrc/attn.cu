// Attention core of K1/K2 and K8: o = softmax(q * scale . k^T + bm) . v per row and head.
//
// Replaces the per-head loop of stgcma_tpu/ops/pallas_attn.py
// _win_block_kernel (:406-420) and _win_block_q_core (:1445-1455, default
// bf16 grams), and the W-MSA core K8, _wmsa_kernel_small_bias (:230) and
// _wmsa_kernel_blocked_bias (:247): q is scaled and rounded to bf16 (K8 gets
// q scaled already and passes scale 1, which is exact), logits are fp32
// (+ the optional bias bm, of shape (nWb, heads, N, N), row b taking
// bm[b % nWb]), the max is subtracted, exp'd, divided exactly by the row sum,
// the probabilities are rounded to bf16, and p.v is summed in fp32 and
// rounded to bf16. Heads stay merged in the output, (B_, N, heads * dh).
// Three entry points read the same core:
//   - stg_attn_core (K1/K2, and K8 at its Swin sites, `wmsa_qkv`): q, k, v
//     are column blocks of one packed (B_, N, 3 * heads * dh) qkv; K8's
//     (P, N, N) bias, row b head h taking bias[(b heads + h) % P], is this
//     entry's (nWb = P / heads, heads, N, N) bias, so the site reads the
//     qkv product's output as it lies and writes merged heads;
//   - stg_attn_core_t (K14, the transpose-free temporal stage of
//     _tblock_v2_kernel :1757): the same packed qkv of (B, T, Ns, 3C)
//     tokens, where sequence g = (b, n) is token n of the T frames of batch
//     element b: its row t lies at (b * T * Ns + n) + t * Ns. The TPU kernel
//     permutes (T, Ns) -> (Ns, T) in VMEM, pads T to 16 and packs 8 tokens
//     into one 128-wide gram; here the permute is the core's addressing
//     (sequences interleaved n_in = Ns apart), and neither pad nor packing is
//     needed. Output o in the same (B, T, Ns, C) layout;
//   - stg_attn_core_win (K4 over its windows): the packed qkv of the full
//     Swin grid, each window's tokens read through a token table (window-major,
//     ws^2 to a window), the full grid's (1, heads, N, N) bias read at the
//     tokens' own entries, o written back at each token's row, on the
//     resident kernel below (one block a (row, window, head), K and V of the
//     window's 49 tokens by 16-byte cp.async). The full-grid core with the
//     -1e30 cross-window mask in the bias computes the same function
//     (exp(-1e30 - m) is exactly 0 in fp32) on four times the logits at Swin
//     stage 2 (4 windows of 49 of 196 tokens): the TPU kernel's window-major
//     layout (pallas_swin_block.py:255-256, :448) comes back here without a
//     permute of the rows;
//   - stg_attn_qkv (K8's counterpart of the Pallas kernel, `wmsa`, on no
//     path): separate q, k, v of shape (R, N, dh) and a bias
//     (P, N, N) whose row r takes bm[r % P] (one head per row, heads = 1).
//     One kernel takes any period P, so it covers both Pallas bodies: the
//     small bias (P <= 128, held whole) and the blocked bias (P a multiple
//     of 128, tiled along the rows).
// Differences from the TPU layout, on purpose: no 8-row block-diagonal
// packing of the T = 10 temporal site, no 197 -> 208 resident pad, no
// 257 -> 272 pad of CLIP ViT-L/14's spatial site and no 49 -> 64 window pad;
// each row attends over its own N tokens (exp(-1e30 - m) was exactly 0
// there, so the math is the same).
// Bound on the H100: operations at the CLIP spatial sites (N = 197: ~9.5
// GFLOP a B = 8 call), bytes at the temporal and window sites (N = 10 or
// 49: the q, k, v reads dominate).
// Three kernels, one per range of N (ATTN_SMALL_MAX_TOKENS and
// ATTN_RESIDENT_MAX_TOKENS in ops/fused_attn.py mirror the dispatch):
// N <= 64 (attn_small_kernel: the T = 10 temporal sites, the 49-token windows,
// K8): both products on tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate). A block of four warps walks groups of (row, head) pairs (four
// pairs at N <= 16, two at N <= 32, one at N <= 64: a 16-query tile a warp),
// as many blocks as the card holds at once, with two stages in shared memory:
// the next group's Q, K and V land keys-major by 16-byte cp.async, rows
// padded to dh + 8 (zeros past N), while this group computes. q's fragments
// come by ldmatrix and are scaled in registers; all N <= 64 logits of a
// 16-query tile are one chunk, kept in registers from the max through the sum
// to p, so q.k^T is formed once; V's fragments come by ldmatrix.trans; each
// warp stages its output tile over its own rows of Q and stores it 16 bytes a
// lane.
// 64 < N <= 768 (attn_resident_kernel: CLIP's 197 and 257 tokens; K4's windows
// of 49 through their token table, TAB):
// one block owns one (row, head); K and V come into shared memory once,
// keys-major, by 16-byte cp.async (V in a second group that lands while pass
// 1 runs), rows padded to dh + 8 elements so every ldmatrix is free of bank
// conflicts; V's fragments for p.v come through ldmatrix.trans, so nothing is
// transposed element by element. Each warp owns one 16-query tile at a time
// and walks the resident keys in chunks of 64 twice: pass 1 keeps a running
// row max m and sum l (rescaled by exp(m_old - m_new) when the max grows);
// pass 2 recomputes the logits and forms p = exp(s - m) / l, rounded to bf16
// after the correctly rounded division (JAX `_pnorm`; `div_rn`: a reciprocal
// a row and an fma correction, no slow-path branch), for p.v accumulated in
// fp32. exp is the special function unit's (__expf: ex2.approx of x log2 e,
// relative error below 2^-19 at the |s - m| < 20 that carry weight, far below
// the bf16 rounding of p, 2^-9, that follows). Only one chunk of logits
// (s[8][4]) is live, so a thread fits in 128 registers and two blocks share
// an SM; the warps of a block are chosen so the query tiles split into even
// rounds (N = 197: 13 tiles, 7 warps x 2 rounds; N = 257: 17 tiles, 6 warps x
// 3). Chunks wholly below N run with no branch (the 8 key tiles' products
// interleave); in the last one, key tiles of 8 (logits) or 16 (p.v) past N
// are skipped. A bias is read at clamped indices, branch-free, in a variant
// of its own (K4); the CLIP sites have none. Shared memory: 2 * ceil16(N) *
// (dh + 8) * 2 bytes, at most 221,184 at 768 tokens and dh 64 (of the
// 232,448 a block may have).
// N > 768 (attn_stream_kernel; no preset reaches it): K and V are streamed
// through shared memory in tiles of 64 keys and a block owns 64 query rows
// of one (row, head), with the same two passes. The key-tile loop puts no
// limit on N; the grid does: blockIdx.y walks the query tiles, at most 65535
// of them (ATTN_MAX_TOKENS in ops/fused_attn.py).
// A window of K4 (TAB) of one chunk (49 tokens) forms its logits once and keeps
// them in registers from pass 1 to pass 2.
// Two passes, not the one-pass online softmax of fuse.cu: the probabilities
// are rounded to bf16 after the division, in every kernel here, as the TPU
// kernel does, so all three round at the same point; the price is q.k^T
// computed twice.
#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;

// p[0:2] * scale, rounded to bf16 and packed
__device__ __forceinline__ uint32_t scaled_q2(const bf16* p, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16x2(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
}

// q[row, col:col+2] * scale, rounded to bf16 and packed; 0 past the last row
__device__ __forceinline__ uint32_t load_q2(const bf16* base, int row, int col, int N, int ld,
                                            float scale) {
  return row < N ? scaled_q2(base + static_cast<size_t>(row) * ld + col, scale) : 0u;
}

// x / l, correctly rounded, from r = 1/l correctly rounded (__frcp_rn): q = x * r
// is within an ulp, and one fma correction (Markstein) rounds it correctly for
// every quotient above ~2^-120 (x = exp(s - m) in (0, 1], l in [1, N]); below it
// the term is < 2^-100 of the row's largest and adds nothing to p.v in fp32.
// Three instructions and no branch where __fdiv_rn takes a slow-path check.
__device__ __forceinline__ float div_rn(float x, float l, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, l, x), r, q);
}

// Sequences come in runs of n_in interleaved ones: token j of sequence b is
// row seq_row(b) + j * n_in of q/k/v (stride ld) and of o (stride C). n_in = 1
// gives the contiguous (B_, N) layout of K1/K2/K8.
__device__ __forceinline__ size_t seq_row(int b, int N, int n_in) {
  return static_cast<size_t>(b / n_in) * N * n_in + b % n_in;
}

// ---------------------------------------------------------------------------
// N <= 64: every key of a (row, head) in one chunk, its logits in registers
// ---------------------------------------------------------------------------

constexpr int kSmallMaxTokens = 64;       // attn_small_kernel up to KT = 4
constexpr int kSmallStages = 2;           // groups of pairs in shared memory: one computes, one loads

// A group is the (row, head) pairs a block computes at once: 4 / KT of them, so that the
// four warps have a 16-query tile each (N <= 16: four pairs of one tile; N <= 32: two of
// two; N <= 64: one of up to four). A stage holds Q, K and V of the group's pairs,
// keys-major, NK rows of stride LD each: 192 LD bf16 whatever KT is.
template <int DH, int KT>
struct Small {
  static constexpr int PAIRS = kWarps / KT;
  static constexpr int NK = 16 * KT;      // rows a matrix holds, past N zero-filled
  static constexpr int LD = DH + 8;       // row stride (bf16): 80 or 144 bytes, ldmatrix
                                          // free of bank conflicts
  static constexpr int MAT = NK * LD;
  static constexpr int STAGE = PAIRS * 3 * MAT;
  static constexpr int SMEM = kSmallStages * STAGE * static_cast<int>(sizeof(bf16));
};

// Token j of head h of sequence b is at q/k/v + (seq_row(b) + j * n_in) * ld + h * DH. The
// block walks the groups grp = blockIdx.x, + gridDim.x, ... (the grid is what the card
// holds at once), loading the next group's Q, K and V by 16-byte cp.async while it
// computes this one's. A warp owns one 16-query tile of one pair: q's fragments by
// ldmatrix, scaled and rounded to bf16 in registers; the 16 x NK logits (+ the bias,
// read at clamped indices with no branch) stay in registers from the max through the
// sum to p; V's fragments by ldmatrix.trans; the output tile is staged over the warp's
// own rows of Q and stored 16 bytes a lane.
template <int DH, int KT>
__global__ void __launch_bounds__(kWarps * 32, 4) attn_small_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, int ld,
    int n_in, const float* __restrict__ bm, int nWb, bf16* __restrict__ o, int BH, int N,
    int heads, float scale) {
  using L = Small<DH, KT>;
  constexpr int CPR = DH / 8;             // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int C = heads * DH;
  const int groups = ceil_div(BH, L::PAIRS);
  const int q_tiles = ceil_div(N, 16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // Q, K and V of group grp into stage st, chunk by chunk (a row's chunks on neighbouring
  // threads); rows past N and pairs past BH are zeros (a V row of garbage times p = 0 can
  // be NaN)
  auto load = [&](int grp, int st) {
    bf16* dst = smem + st * L::STAGE;
    for (int i = threadIdx.x; i < L::PAIRS * 3 * L::NK * CPR; i += kWarps * 32) {
      const int c = i % CPR, j = i / CPR % L::NK, m = i / (CPR * L::NK) % 3;
      const int l = i / (CPR * L::NK * 3);
      const int bh = grp * L::PAIRS + l;
      const bool ok = bh < BH && j < N;
      const bf16* src = m == 0 ? q : m == 1 ? k : v;
      const size_t off = ok ? (seq_row(bh / heads, N, n_in) + static_cast<size_t>(j) * n_in) * ld +
                                  (bh % heads) * DH + c * 8
                            : 0;
      cp_async16(dst + (l * 3 + m) * L::MAT + j * L::LD + c * 8, src + off, ok);
    }
    cp_async_commit();
  };

  int st = 0;
  if (static_cast<int>(blockIdx.x) < groups) load(blockIdx.x, 0);
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x, st ^= 1) {
    if (grp + static_cast<int>(gridDim.x) < groups) load(grp + gridDim.x, st ^ 1);
    else cp_async_commit();               // an empty group: the wait below counts the same
    cp_async_wait<1>();                   // this group's copies have landed
    __syncthreads();

    for (int task = warp; task < L::PAIRS * q_tiles; task += kWarps) {
      const int l = task / q_tiles, qt = task % q_tiles;
      const int bh = grp * L::PAIRS + l;
      if (bh >= BH) break;                // later tasks are past BH too
      const int b = bh / heads, h = bh % heads;
      bf16* qs = smem + st * L::STAGE + l * 3 * L::MAT;
      const bf16* ks = qs + L::MAT;
      const bf16* vs = ks + L::MAT;

      // q of rows qt*16 .. +15: matrix l / 8 of a load is rows 8 ((l / 8) & 1), dims
      // 8 (l / 16) of a k-step, the a0..a3 of mma's A; scaled and rounded to bf16
      uint32_t qa[DH / 16][4];
      const bf16* qrow = qs + (qt * 16 + (lane & 15)) * L::LD + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        ldsm_x4(qa[kk], qrow + kk * 16);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][r]));
          qa[kk][r] = pack_bf16x2(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
        }
      }

      // logits: s[nt] holds keys nt*8 + 2t (+1) of rows r0 (elements 0, 1) and r1 (2, 3);
      // key tiles wholly past N are not multiplied
      const int r0 = qt * 16 + g, r1 = r0 + 8;
      float s[2 * KT][4];
      const bf16* krow = ks + (lane & 7) * L::LD + (lane >> 3) * 8;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        if (nt * 8 < N) {
#pragma unroll
          for (int kk = 0; kk < DH / 16; kk += 2) {
            uint32_t kb[4];
            ldsm_x4(kb, krow + nt * 8 * L::LD + kk * 16);
            mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], kb[0], kb[1]);
            mma_bf16(s[nt], qa[kk + 1][0], qa[kk + 1][1], qa[kk + 1][2], qa[kk + 1][3], kb[2],
                     kb[3]);
          }
        }
      }
      if (bm != nullptr) {               // rows and keys past N read entry N - 1, never used
        const float* bias = bm + (static_cast<size_t>(b % nWb) * heads + h) * N * N;
        const float* b0 = bias + static_cast<size_t>(min(r0, N - 1)) * N;
        const float* b1 = bias + static_cast<size_t>(min(r1, N - 1)) * N;
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = min(nt * 8 + 2 * t + (e & 1), N - 1);
            s[nt][e] = __fadd_rn(s[nt][e], __ldg((e < 2 ? b0 : b1) + key));
          }
      }
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + 2 * t + (e & 1) >= N) s[nt][e] = -INFINITY;
        m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
        m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        s[nt][0] = __expf(__fsub_rn(s[nt][0], m0));
        s[nt][1] = __expf(__fsub_rn(s[nt][1], m0));
        s[nt][2] = __expf(__fsub_rn(s[nt][2], m1));
        s[nt][3] = __expf(__fsub_rn(s[nt][3], m1));
        l0 += s[nt][0] + s[nt][1];
        l1 += s[nt][2] + s[nt][3];
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);

      // p = e / l rounded to bf16, two logit tiles one A fragment of p.v; V's b0, b1 of
      // two n-tiles a .trans load (matrix l / 8: keys kc*16 + 8 ((l / 8) & 1), dims of
      // n-tile nd + l / 16)
      float acc[DH / 8][4];
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
      const bf16* vrow = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::LD + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < KT; ++kc) {
        if (kc * 16 >= N) break;
        const uint32_t a0 = pack_bf16x2(div_rn(s[2 * kc][0], l0, rl0), div_rn(s[2 * kc][1], l0, rl0));
        const uint32_t a1 = pack_bf16x2(div_rn(s[2 * kc][2], l1, rl1), div_rn(s[2 * kc][3], l1, rl1));
        const uint32_t a2 =
            pack_bf16x2(div_rn(s[2 * kc + 1][0], l0, rl0), div_rn(s[2 * kc + 1][1], l0, rl0));
        const uint32_t a3 =
            pack_bf16x2(div_rn(s[2 * kc + 1][2], l1, rl1), div_rn(s[2 * kc + 1][3], l1, rl1));
#pragma unroll
        for (int nd = 0; nd < DH / 8; nd += 2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vrow + kc * 16 * L::LD + nd * 8);
          mma_bf16(acc[nd], a0, a1, a2, a3, bv[0], bv[1]);
          mma_bf16(acc[nd + 1], a0, a1, a2, a3, bv[2], bv[3]);
        }
      }

      // the tile's output over its own rows of Q (read by this warp alone), then 16 bytes
      // a lane along the rows of o
      bf16* os = qs + qt * 16 * L::LD;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const int col = nd * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(os + g * L::LD + col) =
            __floats2bfloat162_rn(acc[nd][0], acc[nd][1]);
        *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * L::LD + col) =
            __floats2bfloat162_rn(acc[nd][2], acc[nd][3]);
      }
      __syncwarp();
      const size_t row0 = seq_row(b, N, n_in);
#pragma unroll
      for (int i = lane; i < 16 * CPR; i += 32) {
        const int r = i / CPR, c = i % CPR;
        if (qt * 16 + r < N)
          *reinterpret_cast<uint4*>(o + (row0 + static_cast<size_t>(qt * 16 + r) * n_in) * C +
                                    h * DH + c * 8) =
              *reinterpret_cast<const uint4*>(os + r * L::LD + c * 8);
      }
    }
    __syncthreads();                      // stage st is read: the next-but-one group loads into it
  }
}

// ---------------------------------------------------------------------------
// N > 768: keys streamed through shared memory, two passes
// ---------------------------------------------------------------------------

constexpr int kStreamRows = 16 * kWarps;   // query rows of one (row, head) per block
constexpr int kStreamKeys = 64;            // keys per shared-memory tile
constexpr int kMaxQueryTiles = 65535;      // gridDim.y

// s[nt] = q . k^T of keys j0 + nt*8 + 2t (+1) for rows r0 (elements 0, 1) and
// r1 (2, 3), + bias; keys past N are -inf
template <int DH, int LDK>
__device__ __forceinline__ void tile_logits(float (&s)[kStreamKeys / 8][4],
                                            const uint32_t (&qa)[DH / 16][4], const bf16* ks,
                                            const float* bias, int j0, int r0, int r1, int N,
                                            int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kStreamKeys / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* krow = ks + (nt * 8 + g) * LDK + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
               *reinterpret_cast<const uint32_t*>(krow + kk * 16),
               *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j0 + nt * 8 + 2 * t + (e & 1);
      const int row = e < 2 ? r0 : r1;
      if (key >= N) {
        s[nt][e] = -INFINITY;
      } else if (bias != nullptr && row < N) {
        s[nt][e] = __fadd_rn(s[nt][e], bias[static_cast<size_t>(row) * N + key]);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32) attn_stream_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, int ld,
    int n_in, const float* __restrict__ bm, int nWb, bf16* __restrict__ o, int N, int heads,
    float scale) {
  constexpr int LDK = DH + 8;            // K row stride (bf16)
  constexpr int LDV = kStreamKeys + 8;   // V^T row stride (bf16)
  __shared__ __align__(16) bf16 ks[kStreamKeys * LDK];
  __shared__ __align__(16) bf16 vt[DH * LDV];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int C = heads * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = static_cast<int>(blockIdx.y) * kStreamRows + warp * 16 + g, r1 = r0 + 8;
  const int tld = ld * n_in;             // between consecutive tokens of a sequence
  const size_t row0 = seq_row(b, N, n_in);
  const size_t base = row0 * ld + static_cast<size_t>(h) * DH;
  const float* bias = bm == nullptr ? nullptr
      : bm + (static_cast<size_t>(b % nWb) * heads + h) * static_cast<size_t>(N) * N;

  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    qa[kk][0] = load_q2(q + base, r0, c0, N, tld, scale);
    qa[kk][1] = load_q2(q + base, r1, c0, N, tld, scale);
    qa[kk][2] = load_q2(q + base, r0, c0 + 8, N, tld, scale);
    qa[kk][3] = load_q2(q + base, r1, c0 + 8, N, tld, scale);
  }

  // K (and in pass 2 V^T) of keys j0 .. j0 + 63 into shared memory, zeros past N
  auto load_tile = [&](int j0, bool with_v) {
    __syncthreads();                       // the previous tile is consumed
    for (int i = threadIdx.x; i < kStreamKeys * (DH / 2); i += blockDim.x) {
      const int j = i / (DH / 2), w = i % (DH / 2);
      uint32_t kw = 0u, vw = 0u;
      if (j0 + j < N) {
        const size_t off = base + static_cast<size_t>(j0 + j) * tld;
        kw = reinterpret_cast<const uint32_t*>(k + off)[w];
        if (with_v) vw = reinterpret_cast<const uint32_t*>(v + off)[w];
      }
      *reinterpret_cast<uint32_t*>(ks + j * LDK + 2 * w) = kw;
      if (with_v) {
        const __nv_bfloat162 v2 = *reinterpret_cast<__nv_bfloat162*>(&vw);
        vt[(2 * w) * LDV + j] = v2.x;
        vt[(2 * w + 1) * LDV + j] = v2.y;
      }
    }
    __syncthreads();
  };

  // pass 1: the row max m and the row sum l = sum exp(s - m)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[kStreamKeys / 8][4];
  for (int j0 = 0; j0 < N; j0 += kStreamKeys) {
    load_tile(j0, false);
    tile_logits<DH, LDK>(s, qa, ks, bias, j0, r0, r1, N, g, t);
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kStreamKeys / 8; ++nt) {
      tm0 = fmaxf(tm0, fmaxf(s[nt][0], s[nt][1]));
      tm1 = fmaxf(tm1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(tm0)), mn1 = fmaxf(m1, quad_max(tm1));
    float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kStreamKeys / 8; ++nt) {
      ts0 += expf(__fsub_rn(s[nt][0], mn0)) + expf(__fsub_rn(s[nt][1], mn0));
      ts1 += expf(__fsub_rn(s[nt][2], mn1)) + expf(__fsub_rn(s[nt][3], mn1));
    }
    // exp(-inf - m) = 0 on the first tile, whose l is still 0
    l0 = l0 * expf(m0 - mn0) + quad_sum(ts0);
    l1 = l1 * expf(m1 - mn1) + quad_sum(ts1);
    m0 = mn0;
    m1 = mn1;
  }

  // pass 2: p = exp(s - m) / l rounded to bf16, p.v summed in fp32
  float acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  for (int j0 = 0; j0 < N; j0 += kStreamKeys) {
    load_tile(j0, true);
    tile_logits<DH, LDK>(s, qa, ks, bias, j0, r0, r1, N, g, t);
#pragma unroll
    for (int kc = 0; kc < kStreamKeys / 16; ++kc) {
      const float* p0 = s[2 * kc];
      const float* p1 = s[2 * kc + 1];
      const uint32_t a0 = pack_bf16x2(__fdiv_rn(expf(__fsub_rn(p0[0], m0)), l0),
                                      __fdiv_rn(expf(__fsub_rn(p0[1], m0)), l0));
      const uint32_t a1 = pack_bf16x2(__fdiv_rn(expf(__fsub_rn(p0[2], m1)), l1),
                                      __fdiv_rn(expf(__fsub_rn(p0[3], m1)), l1));
      const uint32_t a2 = pack_bf16x2(__fdiv_rn(expf(__fsub_rn(p1[0], m0)), l0),
                                      __fdiv_rn(expf(__fsub_rn(p1[1], m0)), l0));
      const uint32_t a3 = pack_bf16x2(__fdiv_rn(expf(__fsub_rn(p1[2], m1)), l1),
                                      __fdiv_rn(expf(__fsub_rn(p1[3], m1)), l1));
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const bf16* vrow = vt + (nd * 8 + g) * LDV + kc * 16 + 2 * t;
        mma_bf16(acc[nd], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int col = h * DH + nd * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + (row0 + static_cast<size_t>(r0) * n_in) * C +
                                         col) = __floats2bfloat162_rn(acc[nd][0], acc[nd][1]);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + (row0 + static_cast<size_t>(r1) * n_in) * C +
                                         col) = __floats2bfloat162_rn(acc[nd][2], acc[nd][3]);
  }
}

// ---------------------------------------------------------------------------
// 64 < N <= 768: K and V resident in shared memory, two passes per query tile
// ---------------------------------------------------------------------------

constexpr int kResidentMaxTokens = 768;   // attn_resident_kernel; attn_stream_kernel past it
constexpr int kResidentMaxWarps = 8;
constexpr int kChunk = 64;                // keys per chunk of the two passes

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

template <int DH>
struct Resident {
  static constexpr int LD = DH + 8;       // K and V row stride (bf16): 144 or 80 bytes
  static size_t smem_bytes(int N) { return 2u * round16(N) * LD * sizeof(bf16); }
};

// K4's windows: sequence b is window b % nW of batch row b / nW, and its token j
// is row (b / nW) * ntok + tab[(b % nW) * N + j] of qkv and o; the bias is the
// full grid's (heads, ntok, ntok), read at the tokens' own (row, key) entries
// (the resident kernel's TAB; elsewhere tab is null).
struct Win {
  const int* tab;
  int nW, ntok;
};

// the row of q/k/v (stride ld) and of o (stride C) that holds token j of sequence b,
// whose first token is row row0 (seq_row) where !TAB
template <bool TAB>
__device__ __forceinline__ size_t tok_row(const Win& w, size_t row0, int b, int N, int n_in,
                                          int j) {
  if constexpr (TAB)
    return static_cast<size_t>(b / w.nW) * w.ntok + __ldg(w.tab + b % w.nW * N + j);
  return row0 + static_cast<size_t>(j) * n_in;
}

// where a (row, head)'s bias lies: entry (i, j) at p[at(i) * nb + at(j)], at the
// identity, or (TAB) the tokens of the window's table tab, nb = the grid's tokens
struct BiasAt {
  const float* p;
  const int* tab;
  int nb;
};

// s[nt] = q . k^T of keys j0 + nt*8 + 2t (+1) for rows r0 (elements 0, 1) and
// r1 (2, 3), + bias; keys past N are -inf. ks: the resident K, keys-major with
// row stride LD. FULL: the chunk lies wholly below N, and the code has no
// branch, so the 8 key tiles' products interleave; else 8-key tiles wholly past
// N are not multiplied. The bias is read at clamped indices with no branch (rows
// past N read row N - 1 and are never stored), so its loads go out together.
template <int DH, bool FULL, bool BIAS, bool TAB>
__device__ __forceinline__ void chunk_logits(float (&s)[kChunk / 8][4],
                                             const uint32_t (&qa)[DH / 16][4], const bf16* ks,
                                             const BiasAt& bias, int j0, int r0, int r1, int N,
                                             int lane) {
  constexpr int LD = Resident<DH>::LD;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (FULL || j0 + nt * 8 < N) {
      // matrix l / 8 of a load: dims kk*16 + 8 * (l / 8), key row l % 8: the b0, b1 of
      // two k-steps
      const bf16* krow = ks + (j0 + nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < DH / 16; kk += 2) {
        uint32_t b[4];
        ldsm_x4(b, krow + kk * 16);
        mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b[0], b[1]);
        mma_bf16(s[nt], qa[kk + 1][0], qa[kk + 1][1], qa[kk + 1][2], qa[kk + 1][3], b[2], b[3]);
      }
    }
  }
  if constexpr (BIAS) {
    const int i0 = min(r0, N - 1), i1 = min(r1, N - 1);
    const float* b0 = bias.p + static_cast<size_t>(TAB ? __ldg(bias.tab + i0) : i0) * bias.nb;
    const float* b1 = bias.p + static_cast<size_t>(TAB ? __ldg(bias.tab + i1) : i1) * bias.nb;
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = min(j0 + nt * 8 + 2 * t + (e & 1), N - 1);
        const int at = TAB ? __ldg(bias.tab + key) : key;
        s[nt][e] = __fadd_rn(s[nt][e], __ldg((e < 2 ? b0 : b1) + at));
      }
  }
  if (!FULL) {
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + nt * 8 + 2 * t + (e & 1) >= N) s[nt][e] = -INFINITY;
  }
}

// the running row max m and sum l = sum exp(s - m) updated with one chunk's logits s
__device__ __forceinline__ void stats_of(const float (&s)[kChunk / 8][4], float& m0, float& m1,
                                         float& l0, float& l1) {
  float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    tm0 = fmaxf(tm0, fmaxf(s[nt][0], s[nt][1]));
    tm1 = fmaxf(tm1, fmaxf(s[nt][2], s[nt][3]));
  }
  const float mn0 = fmaxf(m0, quad_max(tm0)), mn1 = fmaxf(m1, quad_max(tm1));
  float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    ts0 += __expf(__fsub_rn(s[nt][0], mn0)) + __expf(__fsub_rn(s[nt][1], mn0));
    ts1 += __expf(__fsub_rn(s[nt][2], mn1)) + __expf(__fsub_rn(s[nt][3], mn1));
  }
  // exp(-inf - m) = 0 on the first chunk, whose l is still 0
  l0 = l0 * __expf(m0 - mn0) + quad_sum(ts0);
  l1 = l1 * __expf(m1 - mn1) + quad_sum(ts1);
  m0 = mn0;
  m1 = mn1;
}

// acc += p . v of one chunk's logits s: p = exp(s - m) / l rounded to bf16
template <int DH, bool FULL>
__device__ __forceinline__ void pv_of(const float (&s)[kChunk / 8][4], float (&acc)[DH / 8][4],
                                      float m0, float m1, float l0, float l1, float rl0, float rl1,
                                      const bf16* vs, int j0, int N, int lane) {
  constexpr int LD = Resident<DH>::LD;
#pragma unroll
  for (int kc = 0; kc < kChunk / 16; ++kc) {
    if (!FULL && j0 + kc * 16 >= N) break;
    const float* p0 = s[2 * kc];
    const float* p1 = s[2 * kc + 1];
    const uint32_t a0 = pack_bf16x2(div_rn(__expf(__fsub_rn(p0[0], m0)), l0, rl0),
                                    div_rn(__expf(__fsub_rn(p0[1], m0)), l0, rl0));
    const uint32_t a1 = pack_bf16x2(div_rn(__expf(__fsub_rn(p0[2], m1)), l1, rl1),
                                    div_rn(__expf(__fsub_rn(p0[3], m1)), l1, rl1));
    const uint32_t a2 = pack_bf16x2(div_rn(__expf(__fsub_rn(p1[0], m0)), l0, rl0),
                                    div_rn(__expf(__fsub_rn(p1[1], m0)), l0, rl0));
    const uint32_t a3 = pack_bf16x2(div_rn(__expf(__fsub_rn(p1[2], m1)), l1, rl1),
                                    div_rn(__expf(__fsub_rn(p1[3], m1)), l1, rl1));
    // matrix l / 8 of a .trans load: keys kc*16 + 8 * ((l / 8) & 1), dims of n-tile
    // nd + l / 16: the b0, b1 of two n-tiles
    const bf16* vrow = vs + (j0 + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       (lane >> 4) * 8;
#pragma unroll
    for (int nd = 0; nd < DH / 8; nd += 2) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vrow + nd * 8);
      mma_bf16(acc[nd], a0, a1, a2, a3, bv[0], bv[1]);
      mma_bf16(acc[nd + 1], a0, a1, a2, a3, bv[2], bv[3]);
    }
  }
}

// pass 1 over one chunk: the running row max m and sum l = sum exp(s - m)
template <int DH, bool FULL, bool BIAS, bool TAB>
__device__ __forceinline__ void chunk_stats(float& m0, float& m1, float& l0, float& l1,
                                            const uint32_t (&qa)[DH / 16][4], const bf16* ks,
                                            const BiasAt& bias, int j0, int r0, int r1, int N,
                                            int lane) {
  float s[kChunk / 8][4];
  chunk_logits<DH, FULL, BIAS, TAB>(s, qa, ks, bias, j0, r0, r1, N, lane);
  stats_of(s, m0, m1, l0, l1);
}

// pass 2 over one chunk: p = exp(s - m) / l rounded to bf16, acc += p . v
template <int DH, bool FULL, bool BIAS, bool TAB>
__device__ __forceinline__ void chunk_pv(float (&acc)[DH / 8][4], float m0, float m1, float l0,
                                         float l1, float rl0, float rl1,
                                         const uint32_t (&qa)[DH / 16][4], const bf16* ks,
                                         const bf16* vs, const BiasAt& bias, int j0, int r0,
                                         int r1, int N, int lane) {
  float s[kChunk / 8][4];
  chunk_logits<DH, FULL, BIAS, TAB>(s, qa, ks, bias, j0, r0, r1, N, lane);
  pv_of<DH, FULL>(s, acc, m0, m1, l0, l1, rl0, rl1, vs, j0, N, lane);
}

// BIAS: bm is given (K4's shift mask and relative positions); the CLIP sites have none.
// TAB: K4's windows, each read through its token table (win)
template <int DH, bool BIAS, bool TAB>
__global__ void __launch_bounds__(kResidentMaxWarps * 32, 2) attn_resident_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, int ld,
    int n_in, const float* __restrict__ bm, int nWb, bf16* __restrict__ o, int N, int heads,
    float scale, Win win) {
  constexpr int LD = Resident<DH>::LD;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + round16(N) * LD;

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int C = heads * DH;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const int tld = ld * n_in;             // between consecutive tokens of a sequence
  const size_t row0 = TAB ? 0 : seq_row(b, N, n_in);
  const size_t base = row0 * ld + hoff;
  const int nb = TAB ? win.ntok : N;     // the bias's row length
  const BiasAt bias{BIAS ? bm + (static_cast<size_t>(b % nWb) * heads + h) * nb * nb : nullptr,
                    TAB ? win.tab + (b % win.nW) * N : nullptr, nb};

  // K, then V, of this (row, head): 16 bytes a copy, rows N .. ceil16(N) zero
  const int nk = round16(N);
  for (int i = threadIdx.x; i < nk * (DH / 8); i += blockDim.x) {
    const int j = i / (DH / 8), c = (i % (DH / 8)) * 8;
    const size_t off = j >= N ? 0
                       : TAB ? tok_row<TAB>(win, row0, b, N, n_in, j) * ld + hoff + c
                             : base + static_cast<size_t>(j) * tld + c;
    cp_async16(ks + j * LD + c, k + off, j < N);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < nk * (DH / 8); i += blockDim.x) {
    const int j = i / (DH / 8), c = (i % (DH / 8)) * 8;
    const size_t off = j >= N ? 0
                       : TAB ? tok_row<TAB>(win, row0, b, N, n_in, j) * ld + hoff + c
                             : base + static_cast<size_t>(j) * tld + c;
    cp_async16(vs + j * LD + c, v + off, j < N);
  }
  cp_async_commit();
  cp_async_wait<1>();                    // K has landed (V may still be in flight)
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_tiles = ceil_div(N, 16);
  const int rounds = ceil_div(q_tiles, warps);
  for (int round = 0; round < rounds; ++round) {
    const int qt = round * warps + warp;
    const bool busy = qt < q_tiles;
    const int r0 = qt * 16 + g, r1 = r0 + 8;   // this thread's two query rows

    uint32_t qa[DH / 16][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const int full_end = N / kChunk * kChunk;   // chunks below it lie wholly below N
    // TAB, a window of one chunk (K4's 49 tokens): its logits, formed once and
    // kept from pass 1 to pass 2 (the same values the two passes would form)
    const bool one = TAB && N <= kChunk;
    float s1[TAB ? kChunk / 8 : 1][4];
    if (busy) {
      // the rows of q that hold r0, r1 (clamped; TAB: through the window's table)
      const bf16* q0 = TAB ? q + tok_row<TAB>(win, 0, b, N, 1, min(r0, N - 1)) * ld + hoff : q;
      const bf16* q1 = TAB ? q + tok_row<TAB>(win, 0, b, N, 1, min(r1, N - 1)) * ld + hoff : q;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c0 = kk * 16 + 2 * t;
        if constexpr (TAB) {
          qa[kk][0] = r0 < N ? scaled_q2(q0 + c0, scale) : 0u;
          qa[kk][1] = r1 < N ? scaled_q2(q1 + c0, scale) : 0u;
          qa[kk][2] = r0 < N ? scaled_q2(q0 + c0 + 8, scale) : 0u;
          qa[kk][3] = r1 < N ? scaled_q2(q1 + c0 + 8, scale) : 0u;
        } else {
          qa[kk][0] = load_q2(q + base, r0, c0, N, tld, scale);
          qa[kk][1] = load_q2(q + base, r1, c0, N, tld, scale);
          qa[kk][2] = load_q2(q + base, r0, c0 + 8, N, tld, scale);
          qa[kk][3] = load_q2(q + base, r1, c0 + 8, N, tld, scale);
        }
      }
      // pass 1: the row max m and the row sum l = sum exp(s - m)
      if constexpr (TAB) {
        if (one) {
          chunk_logits<DH, false, BIAS, TAB>(s1, qa, ks, bias, 0, r0, r1, N, lane);
          stats_of(s1, m0, m1, l0, l1);
        }
      }
      for (int j0 = 0; !one && j0 < full_end; j0 += kChunk)
        chunk_stats<DH, true, BIAS, TAB>(m0, m1, l0, l1, qa, ks, bias, j0, r0, r1, N, lane);
      if (!one && full_end < N)
        chunk_stats<DH, false, BIAS, TAB>(m0, m1, l0, l1, qa, ks, bias, full_end, r0, r1, N, lane);
    }
    if (round == 0) {                    // every warp is busy in the first round
      cp_async_wait<0>();                // V has landed
      __syncthreads();
    }
    if (!busy) continue;

    // pass 2: p = exp(s - m) / l rounded to bf16, p.v summed in fp32
    const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);
    float acc[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
    if constexpr (TAB) {
      if (one) pv_of<DH, false>(s1, acc, m0, m1, l0, l1, rl0, rl1, vs, 0, N, lane);
    }
    for (int j0 = 0; !one && j0 < full_end; j0 += kChunk)
      chunk_pv<DH, true, BIAS, TAB>(acc, m0, m1, l0, l1, rl0, rl1, qa, ks, vs, bias, j0, r0, r1,
                                    N, lane);
    if (!one && full_end < N)
      chunk_pv<DH, false, BIAS, TAB>(acc, m0, m1, l0, l1, rl0, rl1, qa, ks, vs, bias, full_end,
                                     r0, r1, N, lane);

    // the rows of o that hold r0, r1 (clamped: rows past N are never stored)
    const size_t o0 = tok_row<TAB>(win, row0, b, N, n_in, min(r0, N - 1));
    const size_t o1 = tok_row<TAB>(win, row0, b, N, n_in, min(r1, N - 1));
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int col = h * DH + nd * 8 + 2 * t;
      if (r0 < N)
        *reinterpret_cast<__nv_bfloat162*>(o + o0 * C + col) =
            __floats2bfloat162_rn(acc[nd][0], acc[nd][1]);
      if (r1 < N)
        *reinterpret_cast<__nv_bfloat162*>(o + o1 * C + col) =
            __floats2bfloat162_rn(acc[nd][2], acc[nd][3]);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  int ld;               // elements between consecutive rows of q, k and v
  int n_in;             // sequences interleaved row by row (seq_row); 1: contiguous
  const void* bm;       // nullable
  int nWb;
  void* o;
  int BH, N, heads;
  float scale;
  Win win;              // K4's windows (stg_attn_core_win); tab null elsewhere
};

// the grid: every group of pairs, or as many blocks as the card holds at once (read
// once a process and kernel), each then walking several groups
template <int DH, int KT>
int launch_small(const Args& a, cudaStream_t stream) {
  using L = Small<DH, KT>;
  static int resident = 0;
  auto kernel = attn_small_kernel<DH, KT>;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int groups = ceil_div(a.BH, L::PAIRS);
  kernel<<<groups < resident ? groups : resident, kWarps * 32, L::SMEM, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.ld, a.n_in, static_cast<const float*>(a.bm), a.nWb,
      static_cast<bf16*>(a.o), a.BH, a.N, a.heads, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_stream(const Args& a, cudaStream_t stream) {
  const int q_tiles = ceil_div(a.N, kStreamRows);
  if (q_tiles > kMaxQueryTiles) return static_cast<int>(cudaErrorInvalidValue);
  attn_stream_kernel<DH><<<dim3(a.BH, q_tiles), kWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.ld, a.n_in, static_cast<const float*>(a.bm), a.nWb,
      static_cast<bf16*>(a.o), a.N, a.heads, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_resident(const Args& a, cudaStream_t stream) {
  // warps: the query tiles in even rounds of at most kResidentMaxWarps
  const int q_tiles = ceil_div(a.N, 16);
  const int warps = ceil_div(q_tiles, ceil_div(q_tiles, kResidentMaxWarps));
  const size_t smem = Resident<DH>::smem_bytes(a.N);
  auto kernel = a.win.tab != nullptr ? attn_resident_kernel<DH, true, true>
                : a.bm != nullptr      ? attn_resident_kernel<DH, true, false>
                                       : attn_resident_kernel<DH, false, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.BH, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.ld, a.n_in, static_cast<const float*>(a.bm), a.nWb,
      static_cast<bf16*>(a.o), a.N, a.heads, a.scale, a.win);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const Args& a, cudaStream_t stream) {
  const int kt = ceil_div(a.N, 16);
  if (a.N <= kSmallMaxTokens) {
    if (kt <= 1) return launch_small<DH, 1>(a, stream);
    if (kt <= 2) return launch_small<DH, 2>(a, stream);
    return launch_small<DH, 4>(a, stream);
  }
  if (a.N <= kResidentMaxTokens) return launch_resident<DH>(a, stream);
  return launch_stream<DH>(a, stream);
}

int launch_any(const Args& a, int dh, cudaStream_t stream) {
  if (dh == 64) return launch_dh<64>(a, stream);
  if (dh == 32) return launch_dh<32>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_win(const Args& a, int dh, cudaStream_t stream) {
  if (dh == 64) return launch_resident<64>(a, stream);
  if (dh == 32) return launch_resident<32>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1/K2: qkv (B_, N, 3 * heads * dh) bf16; o: (B_, N, heads * dh) bf16; N up to
// 65535 * 64 (keys resident in shared memory up to 768, streamed past it), dh in {32, 64}
STG_API int stg_attn_core(const void* qkv, const void* bm, int nWb, void* o, int B, int N,
                          int heads, int dh, float scale, cudaStream_t stream) {
  const int C = heads * dh;
  const bf16* base = static_cast<const bf16*>(qkv);
  const Args a{base, base + C, base + 2 * C, 3 * C, 1, bm, nWb, o, B * heads, N, heads, scale};
  return launch_any(a, dh, stream);
}

// K14: qkv (B, T, Ns, 3 * heads * dh) bf16, attention over the T frames of each
// of the B * Ns tokens; bm: nullable (heads, T, T) fp32; o: (B, T, Ns, heads * dh)
// bf16; dh in {32, 64}
STG_API int stg_attn_core_t(const void* qkv, const void* bm, void* o, int B, int T, int Ns,
                            int heads, int dh, float scale, cudaStream_t stream) {
  const int C = heads * dh;
  const bf16* base = static_cast<const bf16*>(qkv);
  const Args a{base, base + C, base + 2 * C, 3 * C, Ns, bm, 1, o, B * Ns * heads, T, heads,
               scale};
  return launch_any(a, dh, stream);
}

// K8: q (pre-scaled), k, v, o (R, N, dh) bf16; bm (P, N, N) fp32, row r taking bm[r % P];
// N up to 65535 * 64, dh in {32, 64}
STG_API int stg_attn_qkv(const void* q, const void* k, const void* v, const void* bm, int P,
                         void* o, int R, int N, int dh, cudaStream_t stream) {
  const Args a{q, k, v, dh, 1, bm, P, o, R, N, 1, 1.0f};
  return launch_any(a, dh, stream);
}

// K4 over its windows: qkv (B, ntok, 3 * heads * dh) bf16; tab (nW * N,) int32, the
// tokens of window w at tab[w * N .. w * N + N - 1], every token once (nW * N = ntok);
// bm (1, heads, ntok, ntok) fp32, the full grid's bias, read at each window's own
// (token, token) entries; o (B, ntok, heads * dh) bf16, each token at its own row.
// N <= 768 (the resident kernel), dh in {32, 64}
STG_API int stg_attn_core_win(const void* qkv, const void* bm, const void* tab, int nW, void* o,
                              int B, int ntok, int N, int heads, int dh, float scale,
                              cudaStream_t stream) {
  if (bm == nullptr || tab == nullptr || N < 1 || N > kResidentMaxTokens || nW < 1 ||
      nW * N != ntok)
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = heads * dh;
  const bf16* base = static_cast<const bf16*>(qkv);
  const Args a{base, base + C, base + 2 * C, 3 * C, 1, bm, 1, o, B * nW * heads, N, heads,
               scale, Win{static_cast<const int*>(tab), nW, ntok}};
  return launch_win(a, dh, stream);
}
