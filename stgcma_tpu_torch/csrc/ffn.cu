// K7, the Swin FFN in one launch: out = bf16(h . W2^T + b2), h = bf16(gelu(xn . W1^T
// + b1)) in fp32 with the erf, xn = bf16(LayerNorm(x)); no residual (the caller adds
// it). The (M, 4C) hidden never reaches device memory.
//
// Replaces stgcma_tpu/ops/pallas_attn.py _ffn_kernel (:676, call :706), which keeps
// the hidden in VMEM: LN with fp32 statistics cast to x's dtype (:679-684), fc1 +
// b1 and the erf-GELU in fp32, the hidden rounded to x's dtype (:685-693), fc2 + b2
// in fp32, rounded (:694). Here the LN is rowprep.cu's ln_rows_kernel (K9) lane for
// lane, so xn is the one K9 writes, the products run over the same k order as
// gemm.cu's (64 columns of C, then of the hidden, in turn), and the erf is the TPU
// kernel's own A&S 7.1.26 polynomial (`erf_gelu`; gemm.cu's EPI_BF16_GELU takes erff,
// within 2e-7 of it): the result is the one K9 + gemm.cu's fc1 + fc2 gave, up to the
// order of the tensor cores' sums and a hidden value rounded the other way where the
// two erfs straddle a bf16 boundary.
// Bound on the H100: at Swin-Base stage 0 (250880 rows, C = 128) the products are
// 0.0665 ms of bf16 tensor time, x and out 0.038 ms of HBM, and the erf-GELU of 128
// M hidden values (their instructions, bench_parts.py GELU_INSTRUCTIONS, counted by
// tools/gelu_sass.py: erff's took 32, more than the products' time) about as much
// (chip_smoke.py `ffn_bf16_bound`); the earlier composition moved the bf16 hidden
// through HBM twice (2 x 257 MB). What costs here beyond the bound: every block reads all of W1 and W2 from L2
// (4 C 4C bytes: 256 KB a 128-row block at C = 128, 1 MB at 256, 576 KB at 192;
// 2.36 MB a 64-row block at 384), 0.50 GB a stage at C = 128 (1960 blocks), 0.49
// GB at 256, 1.1 GB at 192 and 2.3 GB at 384 (Swin-Large), against 128-384 MB of x
// and out through HBM.
// Design: a persistent block an SM (a producer warpgroup and two consumer warpgroups,
// 384 threads; setmaxnreg gives the producer's registers to the consumers, 232 a thread,
// so that an m64 x n256 accumulator does not spill) walks row blocks blk = blockIdx.x,
// + gridDim.x, ... One thread of the producer issues TMA loads of W1's and W2's
// 64-column chunks (a step of the hidden: W1's 64 rows of C, W2's C rows of 64), each
// one item of a ring of 128 C bytes a stage (8 stages at C = 128, 6 at 192, 4 at 256,
// 3 at 384), with a full and an empty mbarrier each; it runs ahead across row blocks. A
// team is the threads that own a set of 64 rows: below C = 384 each warpgroup is a team
// of its own (128-row blocks), at C = 384 the two warpgroups are one team of a 64-row
// block that split the columns (fc1's 32 of each step, fc2's 192 of the output: the
// m64n384 accumulator of one warpgroup, 192 registers a thread, does not fit). Per row
// block a team
//   1. normalizes its rows (16-byte loads; lanes a row and chunks a lane as K9's
//      kernel; the next block's rows are prefetched into L2) into xn, 128-byte
//      swizzled in shared memory as fc1's A operand;
//   2. walks the hidden in steps of 64 by wgmma: fc1 of step j + 1 (xn . W1_{j+1}^T, m64
//      x n64, its first k-step not reading the accumulator), then fc2 of step j (acc +=
//      h_j . W2_j^T, m64 x n C, A the step's hidden tile in shared memory); once fc1 is
//      done, + b1, the erf-GELU in fp32 and the bf16 rounding of step j + 1 go into the
//      other of two hidden tiles under fc2 of step j, then a named barrier of the team (a
//      second one before the writes: fc2 of step j - 1 read that tile). At C = 384 fc2
//      of step j and fc1 of step j + 1 go out together and the GELU follows both (the
//      ring has room for three items, the overlap takes four). The other warpgroup's
//      products run under this one's GELU;
//   3. stages bf16(acc + b2) over its xn tile and stores it 16 bytes a thread.
// A row block past M is read as zeros and not stored (Swin-Base at 168^2: 141,120
// rows). Shared memory: the ring, xn (128 C bytes a 64-row team), two 8 KB hidden
// tiles a team: 197,760 bytes at C = 128, 230,496 at 192, 230,464 at 256, 214,064 at
// 384. ops/fused_attn.py `ffn_route` / `check_ffn` mirror the widths (C in 128, 192,
// 256, 384, hidden 4C) and the operands the launcher takes; K7 at the wider widths
// of stages 2-3, which the route reaches at larger batches, runs as K9 + gemm.cu's
// fc1 and fc2 (`ffn_composed_route`).
#include <math.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int HC = 64;               // hidden columns a step: one 128-byte k-tile of fc2
constexpr int FFN_THREADS = 384;     // two consumer warpgroups + a producer warpgroup
// registers a thread after setmaxnreg: the producer's warpgroup gives its share to the
// consumers' (128 x 40 + 256 x 232 <= 65,536), whose m64 x n C accumulator takes up to 128
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int TEAM_ROWS = 64;        // rows a team owns: the m64 of one wgmma
constexpr int TILE_BYTES = TEAM_ROWS * 128;   // 64 rows of one 128-byte k-tile

template <int C>
struct Ffn {
  static constexpr bool SPLIT = C >= 384;        // the warpgroups split the output columns
  // fc1 of step j + 1 goes out before fc2 of step j, so that the hidden's GELU runs under
  // the warpgroup's own fc2: four ring items in use at once (C = 384 has room for three)
  static constexpr bool OVERLAP = !SPLIT;
  static constexpr int TEAMS = SPLIT ? 1 : 2;
  static constexpr int BM = TEAMS * TEAM_ROWS;   // rows a block
  static constexpr int TEAM_THREADS = SPLIT ? 256 : 128;
  static constexpr int N1 = SPLIT ? HC / 2 : HC;  // fc1 columns a warpgroup forms a step
  static constexpr int N2 = SPLIT ? C / 2 : C;    // output columns a warpgroup accumulates
  static constexpr int H = 4 * C;
  static constexpr int STEPS = H / HC;
  static constexpr int KT1 = C / 64;              // fc1's k-tiles
  static constexpr int ITEM = HC * C * 2;         // W1's chunk (64 rows of C), or W2's (C of 64)
  static constexpr int STAGES = C == 128 ? 8 : C == 192 ? 6 : C == 256 ? 4 : 3;
  static constexpr int W2_BOX = C <= 256 ? C : C / 2;   // a TMA box takes at most 256 rows
  static constexpr int XN_TEAM = KT1 * TILE_BYTES;      // a team's xn, then its output
  static constexpr int XN_OFF = STAGES * ITEM;
  static constexpr int H_OFF = XN_OFF + TEAMS * XN_TEAM;
  static constexpr int BAR_OFF = H_OFF + TEAMS * 2 * TILE_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;   // + room to align to 1024
  // the LayerNorm's lanes a row and 16-byte chunks a lane, as ln_rows_kernel's (rowprep.cu)
  static constexpr int N16 = C / 8;
  static constexpr int LPR = N16 % 32 == 0 ? 32 : N16 % 16 == 0 ? 16 : 8;
  static constexpr int CH = N16 / LPR;
  static constexpr int RP = TEAM_THREADS / LPR;   // rows a pass of the team
  static constexpr int PASSES = TEAM_ROWS / RP;
};

// byte offset of 16-byte chunk cc of row r in a tile of 128-byte rows, 128-byte
// swizzled (TMA's SWIZZLE_128B, wgmma's layout 1): the chunk index XORed with r % 8
__device__ __forceinline__ int swz(int r, int cc) { return r * 128 + ((cc ^ (r & 7)) << 4); }

// byte offset of element k (even) of row r in a team tile of C columns: C / 64 tiles
__device__ __forceinline__ int tile_at(int r, int k) {
  return (k >> 6) * TILE_BYTES + swz(r, (k >> 3) & 7) + (k & 7) * 2;
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// d = A (64 x k16 bf16) . B (n x k16)^T, the accumulator's old values not read (scale-d
// 0): the first k-step of fc1, m64 x n32 or n64
__device__ __forceinline__ void wgmma_first(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_REGS16 "}, %16, %17, p, 1, 1, "
      "0, 0;\n}\n"
      : WG_ACC16("=f") : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32 "}, %32, %33, p, 1, 1, "
      "0, 0;\n}\n"
      : WG_ACC32("=f") : "l"(da), "l"(db));
}

// 0.5 v (1 + erf(v / sqrt 2)) with the Abramowitz-Stegun 7.1.26 erf the TPU kernel uses
// (pallas_clip_block.py `_erf`: |error| <= 1.5e-7, here with the special function unit's
// reciprocal and exp, each within 2 ulp): ~half of erff's instructions (tools/gelu_sass.py),
// which set K7's time at C = 128; the hidden's bf16 rounding (2^-9) dwarfs the difference
__device__ __forceinline__ float erf_gelu(float v) {
  const float x = v * 0.70710678118654752f;
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, ax, 1.0f));
  const float y = fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t, 1.421413741f), t,
                            -0.284496736f), t, 0.254829592f) * t;
  const float erf = copysignf(1.0f - y * __expf(-ax * ax), x);
  return 0.5f * v * (1.0f + erf);
}

// 8 bf16 of a 16-byte chunk as floats
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// The team's 64 rows from row0 normalized into xn (bf16, swizzled), as ln_rows_kernel
// does it: LPR lanes a row (sub = tt % LPR), the lane's chunk c holding elements (c LPR
// + sub) 8 .. + 7, the row's sum and centred sum of squares over a lane's chunks in
// order, then a butterfly over its lanes; every load of the team's rows first. Rows
// past M are zeros.
template <int C>
__device__ __forceinline__ void layer_norm(const bf16* __restrict__ x,
                                           const bf16* __restrict__ gamma,
                                           const bf16* __restrict__ beta, uint8_t* xn, int row0,
                                           int M, float eps, int tt) {
  using L = Ffn<C>;
  const int sub = tt % L::LPR, rr = tt / L::LPR;
  uint4 held[L::PASSES][L::CH];
#pragma unroll
  for (int p = 0; p < L::PASSES; ++p) {
    const int r = row0 + p * L::RP + rr;
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(r < M ? r : 0) * C);
#pragma unroll
    for (int c = 0; c < L::CH; ++c)
      held[p][c] = r < M ? __ldg(xr + c * L::LPR + sub) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int p = 0; p < L::PASSES; ++p) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < L::CH; ++c) {
      float f[8];
      unpack8(held[p][c], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[e];
    }
#pragma unroll
    for (int o = L::LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / static_cast<float>(C);
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < L::CH; ++c) {
      float f[8];
      unpack8(held[p][c], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __fsub_rn(f[e], mean);
        v = __fadd_rn(v, __fmul_rn(d, d));
      }
    }
#pragma unroll
    for (int o = L::LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float rstd = rsqrtf(v / static_cast<float>(C) + eps);
    const int r = p * L::RP + rr;
#pragma unroll
    for (int c = 0; c < L::CH; ++c) {
      const int i = c * L::LPR + sub;
      float f[8], gf[8], bf[8];
      unpack8(held[p][c], f);
      unpack8(__ldg(reinterpret_cast<const uint4*>(gamma) + i), gf);
      unpack8(__ldg(reinterpret_cast<const uint4*>(beta) + i), bf);
      uint4 y;
      uint32_t* yw = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
      for (int e = 0; e < 8; e += 2)
        yw[e / 2] = pack_bf16x2(
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e], mean), rstd), gf[e]), bf[e]),
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e + 1], mean), rstd), gf[e + 1]), bf[e + 1]));
      *reinterpret_cast<uint4*>(xn + (i >> 3) * TILE_BYTES + swz(r, i & 7)) = y;
    }
  }
}

// tm_w1: W1 (4C, C) in boxes of 64 columns by 64 rows; tm_w2: W2 (C, 4C) in boxes of 64
// columns by W2_BOX rows; x, out (M, C); gamma, beta, b2 (C,); b1 (4C,); all bf16
template <int C>
__global__ void __launch_bounds__(FFN_THREADS, 1) ffn_kernel(
    const __grid_constant__ CUtensorMap tm_w1, const __grid_constant__ CUtensorMap tm_w2,
    const bf16* __restrict__ x, const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
    const bf16* __restrict__ b1, const bf16* __restrict__ b2, bf16* __restrict__ out, int M,
    float eps) {
  using L = Ffn<C>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  const int blocks = ceil_div(M, L::BM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);             // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 8);            // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {               // producer: W1's chunk j, then W2's, step by step
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x)
        for (int j = 0; j < L::STEPS; ++j)
          for (int w = 0; w < 2; ++w, ++it) {
            const int s = it % L::STAGES;
            mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], L::ITEM);
            uint8_t* st = smem + s * L::ITEM;
            if (w == 0) {
              for (int kt = 0; kt < L::KT1; ++kt)
                tma_load(st + kt * TILE_BYTES, &tm_w1, kt * 64, j * HC, &full[s]);
            } else {
              for (int b = 0; b < C / L::W2_BOX; ++b)
                tma_load(st + b * L::W2_BOX * 128, &tm_w2, j * HC, b * L::W2_BOX, &full[s]);
            }
          }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128;
  const int team = L::SPLIT ? 0 : wg;
  const int tt = L::SPLIT ? threadIdx.x : threadIdx.x % 128;    // the thread in its team
  const int bar_id = 1 + team;            // named barrier of the team (0 is __syncthreads)
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int rw = warp * 16 + (lane >> 2), t = lane & 3;   // accumulator rows rw, rw + 8
  uint8_t* xn = smem + L::XN_OFF + team * L::XN_TEAM;
  uint8_t* hs = smem + L::H_OFF + team * 2 * TILE_BYTES;
  const int n1_off = L::SPLIT ? wg * L::N1 : 0;   // this warpgroup's columns of a step
  const int n2_off = L::SPLIT ? wg * L::N2 : 0;   // and of the output
  float acc1[L::N1 / 2];
  float acc2[L::N2 / 2];

  // fc1 of one step into acc1: xn (m64 x k C) . W1's chunk^T, over C / 64 k-tiles
  auto fc1 = [&](int s) {
    wgmma_fence();
    const uint8_t* w1s = smem + s * L::ITEM + n1_off * 128;
#pragma unroll
    for (int kt = 0; kt < L::KT1; ++kt) {
      const uint64_t da = smem_desc(xn + kt * TILE_BYTES);
      const uint64_t db = smem_desc(w1s + kt * TILE_BYTES);
#pragma unroll
      for (int k = 0; k < WG_BK_BYTES / WG_KSTEP_BYTES; ++k) {
        if (kt == 0 && k == 0) wgmma_first(acc1, da, db);
        else wgmma_step(acc1, da + 2 * k, db + 2 * k);
      }
    }
    wgmma_commit();
  };
  // fc2 of one step into acc2: the step's hidden tile (m64 x k64) . W2's chunk^T
  auto fc2 = [&](int s, int hb) {
    wgmma_fence();
    const uint64_t da = smem_desc(hs + hb * TILE_BYTES);
    const uint64_t db = smem_desc(smem + s * L::ITEM + n2_off * 128);
#pragma unroll
    for (int k = 0; k < WG_BK_BYTES / WG_KSTEP_BYTES; ++k) wgmma_step(acc2, da + 2 * k, db + 2 * k);
    wgmma_commit();
  };
  // the hidden of step j: bf16(gelu(acc1 + b1)) into hidden tile hb (accumulator jn * 4 +
  // 2 i + e: row rw + 8 i, column n1_off + jn * 8 + 2 t + e), then the team's barrier
  auto gelu_step = [&](int j, int hb) {
    uint8_t* h = hs + hb * TILE_BYTES;
    if (L::OVERLAP && j > 0) bar_sync(bar_id, L::TEAM_THREADS);   // fc2 of step j - 2 read it
#pragma unroll
    for (int jn = 0; jn < L::N1 / 8; ++jn) {
      const int col = n1_off + jn * 8 + 2 * t;
      const float2 b =
          __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(b1 + j * HC + col)));
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(h + swz(rw + 8 * i, col >> 3) + (col & 7) * 2) =
            pack_bf16x2(erf_gelu(__fadd_rn(acc1[jn * 4 + 2 * i], b.x)),
                        erf_gelu(__fadd_rn(acc1[jn * 4 + 2 * i + 1], b.y)));
    }
    fence_proxy_async();                  // the tile's writes before the async proxy reads it
    bar_sync(bar_id, L::TEAM_THREADS);
  };

  int it = 0;                             // ring items consumed, over all row blocks
  for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int row0 = blk * L::BM + team * TEAM_ROWS;
    const int next0 = (blk + gridDim.x) * L::BM + team * TEAM_ROWS;
    if (blk + static_cast<int>(gridDim.x) < blocks) {   // the next block's rows into L2
      for (int q = tt; q < TEAM_ROWS * (C / 64); q += L::TEAM_THREADS) {
        const int r = next0 + q / (C / 64);
        if (r < M) prefetch_l2(x + static_cast<size_t>(r) * C + (q % (C / 64)) * 64);
      }
    }
    layer_norm<C>(x, gamma, beta, xn, row0, M, eps, tt);
    fence_proxy_async();
    bar_sync(bar_id, L::TEAM_THREADS);

    {                                     // step 0's fc1 and hidden
      const int s = it % L::STAGES;
      mbar_wait(&full[s], (it / L::STAGES) & 1);
      fc1(s);
      wgmma_wait<0>();
      fence_acc(acc1);
      if (lane == 0) mbar_arrive(&empty[s]);
      ++it;
      gelu_step(0, 0);
    }
#pragma unroll
    for (int i = 0; i < L::N2 / 2; ++i) acc2[i] = 0.f;
    if constexpr (L::OVERLAP) {
      // fc1 of step j + 1, then fc2 of step j; once fc1 is done (and with it fc2 of step
      // j - 1), step j + 1's GELU into the tile fc2 of step j - 1 read, under fc2 of step j;
      // the last step's fc2 alone
      int s2_prev = 0;
      for (int j = 0; j + 1 < L::STEPS; ++j) {
        const int s2 = it % L::STAGES, s1 = (it + 1) % L::STAGES;
        mbar_wait(&full[s1], ((it + 1) / L::STAGES) & 1);
        fc1(s1);
        mbar_wait(&full[s2], (it / L::STAGES) & 1);
        fc2(s2, j & 1);
        wgmma_wait<1>();
        fence_acc(acc1);
        if (lane == 0) {
          mbar_arrive(&empty[s1]);
          if (j > 0) mbar_arrive(&empty[s2_prev]);
        }
        s2_prev = s2;
        it += 2;
        gelu_step(j + 1, (j + 1) & 1);
      }
      const int s2 = it % L::STAGES;
      mbar_wait(&full[s2], (it / L::STAGES) & 1);
      fc2(s2, (L::STEPS - 1) & 1);
      wgmma_wait<0>();
      fence_acc(acc2);
      if (lane == 0) {
        mbar_arrive(&empty[s2_prev]);
        mbar_arrive(&empty[s2]);
      }
      ++it;
    } else {
      for (int j = 0; j < L::STEPS; ++j) {
        const bool more = j + 1 < L::STEPS;
        const int s2 = it % L::STAGES;    // W2's chunk j
        mbar_wait(&full[s2], (it / L::STAGES) & 1);
        fc2(s2, j & 1);
        const int s1 = (it + 1) % L::STAGES;   // W1's chunk j + 1
        if (more) {
          mbar_wait(&full[s1], ((it + 1) / L::STAGES) & 1);
          fc1(s1);
        }
        wgmma_wait<0>();
        fence_acc(acc1);
        fence_acc(acc2);
        if (lane == 0) {
          mbar_arrive(&empty[s2]);
          if (more) mbar_arrive(&empty[s1]);
        }
        it += more ? 2 : 1;
        // the other tile: fc2 of step j - 1 read it, done on every thread of the team
        // before the barrier of step j
        if (more) gelu_step(j + 1, (j + 1) & 1);
      }
    }

    // bf16(acc2 + b2) staged over xn (every fc1 of the team ran before the last step's
    // barrier), then 16 bytes a thread along the team's rows
#pragma unroll
    for (int jn = 0; jn < L::N2 / 8; ++jn) {
      const int col = n2_off + jn * 8 + 2 * t;
      const float2 b = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(b2 + col)));
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(xn + tile_at(rw + 8 * i, col)) =
            pack_bf16x2(__fadd_rn(acc2[jn * 4 + 2 * i], b.x),
                        __fadd_rn(acc2[jn * 4 + 2 * i + 1], b.y));
    }
    bar_sync(bar_id, L::TEAM_THREADS);
    for (int q = tt; q < TEAM_ROWS * L::N16; q += L::TEAM_THREADS) {
      const int r = q / L::N16, i = q % L::N16;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * C + i * 8) =
            *reinterpret_cast<const uint4*>(xn + tile_at(r, i * 8));
    }
    bar_sync(bar_id, L::TEAM_THREADS);    // the staged rows are read: the next LN may write
  }
}

template <int C>
int launch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int M, float eps, cudaStream_t stream) {
  using L = Ffn<C>;
  static int sms = 0;                     // once a process: the SM count and the smem limit
  auto kernel = ffn_kernel<C>;
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms = n;
  }
  CUtensorMap tm_w1, tm_w2;
  int err = tensor_map<bf16>(&tm_w1, w1, L::H, C, HC);
  if (err == 0) err = tensor_map<bf16>(&tm_w2, w2, C, L::H, L::W2_BOX);
  if (err != 0) return err;
  const int blocks = ceil_div(M, L::BM);
  kernel<<<blocks < sms ? blocks : sms, FFN_THREADS, L::SMEM, stream>>>(
      tm_w1, tm_w2, static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), M, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, C) = bf16(bf16(gelu(bf16(LN(x)) . w1^T + b1)) . w2^T + b2): x, out (M, C); gamma,
// beta, b2 (C,); w1 (4C, C); b1 (4C,); w2 (C, 4C); all bf16, contiguous, 16-byte aligned;
// C in {128, 192, 256, 384}
STG_API int stg_ffn_bf16(const void* x, const void* gamma, const void* beta, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out, int M, int C,
                         float eps, cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 1 || misaligned(x) || misaligned(gamma) || misaligned(beta) || misaligned(w1) ||
      misaligned(b1) || misaligned(w2) || misaligned(b2) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 128: return launch<128>(x, gamma, beta, w1, b1, w2, b2, out, M, eps, stream);
    case 192: return launch<192>(x, gamma, beta, w1, b1, w2, b2, out, M, eps, stream);
    case 256: return launch<256>(x, gamma, beta, w1, b1, w2, b2, out, M, eps, stream);
    case 384: return launch<384>(x, gamma, beta, w1, b1, w2, b2, out, M, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
