// The row-owning product R with the adapter on chip: a tower product whose
// block owns whole output rows, o = bf16(A . W^T + bias) (bf16 operands, or
// int8 row codes with their scales: bf16(float(acc) * sa[m] * ws[n] + bias[n])),
// then on those rows the adapter's down product h = epi(o . wd^T + bd) and,
// where the caller gives its up weights, y = bf16(x + bf16(h . w2^T + b2)) (K13's
// rounding) or bf16(x + (h . w2^T + b2)), rounded once (K14's).
// o reaches device memory only where the caller wants it, h only where it
// wants the hidden; y is written where there is an up product.
//
// Replaces, in stgcma_tpu/ops/pallas_clip_block.py _tadapt_kernel (:350), the
// proj dot and the T_Adapter (fc1, erf-GELU, fc2, the residual: `_adapter_h`
// :131 rounds acc + b1 before the GELU and after it, `_adapter_o` :136 rounds
// acc + b2 before the add, DOWN_RGELU, UP_RES1), in stgcma_tpu/ops/pallas_attn.py
// _tblock_v2_kernel (:1757) the same tail at its own rounding points (:1815-1837:
// the hidden rounded once after the GELU, DOWN_GELU, and acc + b2 added to x in
// fp32, UP_RESF), and in stgcma_tpu/ops/pallas_attn.py
// _win_block_qd_kernel (:1486), _win_block_qh_kernel (:1503) and
// _ffn_qh_kernel (:1674) the last int8 product with `_adapter_down` (:1472:
// o in bf16, acc + bd, erf-GELU, rounded once, DOWN_GELU): the products that
// gemm.cu ran as two or three launches, with o and the hidden through device
// memory between them.
// Bound on the H100: the tower product's operations (2 M N K) against A read,
// y (and o, h where wanted) written and x read once; the adapter products are
// 2 D / K of the tower's.
// Design: a block is one producer warp and one consumer warpgroup of 64 rows
// (the m64 of one wgmma; 160 threads, two blocks an SM), or two warpgroups of
// 64 rows that share each chunk of W (288 threads, one block an SM), where
// ceil(M / 128) blocks still give 3/4 of the SMs one: W is then read once for
// every 128 rows (bench_parts.py's K13 row of R at M = 15760 on an H100: 0.086
// -> 0.079 ms), where smaller M keeps more SMs busy in 64-row blocks. The producer's
// TMA ring (gemm.cu's loop, bf16 k16 or s8 k32, 3-6 stages) carries A's rows and
// a 128-column chunk of W a k-tile; each warpgroup forms o chunk by chunk,
// rounds it to bf16 in registers (and stores it where o is wanted), then feeds
// it, k16 by k16, as the A fragments of mma.sync m16n8k16 straight from the
// accumulator layout into the down product's fp32 sums. The chunk's columns of
// wd, bias and weight scales come into shared memory by cp.async while the
// chunk multiplies (read from L2 in the epilogue, they left it waiting on each
// load). After the last chunk each warp applies bd and the caller's epilogue
// to its 16 rows and stages the bf16 hidden over the free ring; the up product
// stages w2 there too (padded rows, ldmatrix) and takes the hidden's A
// fragments from it; it stages each 64-column block of h . w2^T + b2 (in bf16 for
// UP_RES1, which rounds it; in fp32 for UP_RESF, which adds it to x unrounded:
// staging fp32 for both left K13's R 5% slower on an H100) so that x is read and y
// written 16 bytes a thread along the rows, x's chunks
// loaded before the block's products (and its rows prefetched into L2 while
// the tower product runs): loads in the mma fragments' layout, 4 bytes on 8
// rows, left the block waiting on each.
#include <math.h>

#include <type_traits>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int RA_BM = 64;          // rows a consumer warpgroup owns
constexpr int RA_CHUNK = 128;      // output columns the warpgroup forms at a time
constexpr int RA_ALIGN = 32;       // N in multiples of 32: whole k16 steps of the down product,
                                   // whole pairs of n8 tiles of the up product
constexpr int RA_YB = 64;          // columns of y a step of the up product stages

// the adapter hidden's epilogue, by gemm.cu's numbers: bf16(acc + bd), bf16(gelu(acc +
// bd)) (K11, K14), bf16(gelu(bf16(acc + bd))) (K13)
enum DownEpi { DOWN_BF16 = 0, DOWN_GELU = 4, DOWN_RGELU = 5 };
// the up product's epilogue, by gemm.cu's numbers: bf16(x + bf16(acc + b2)) (K13),
// bf16(x + (acc + b2)) (K14)
enum UpEpi { UP_RES1 = 8, UP_RESF = 9 };

// WGS consumer warpgroups of RA_BM rows each share every chunk of W: a block owns BM =
// 64 WGS rows; one warpgroup: two blocks an SM, two: one
template <int D, int WGS>
struct RTile {
  static constexpr int BM = RA_BM * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int BLOCKS_PER_SM = WGS == 1 ? 2 : 1;
  // the ring's stages: as many as the blocks an SM leave room for beside the staged wd
  // chunk (one warpgroup: 4 to D = 48, 3 past it; two: 6)
  static constexpr int STAGES = WGS == 2 ? 6 : D <= 48 ? 4 : 3;
  static constexpr int A_BYTES = BM * WG_BK_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + RA_CHUNK * WG_BK_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int LDW = RA_CHUNK + 8;    // staged wd chunk row stride (bf16)
  static constexpr int WD_BYTES = D * LDW * 2;
  static constexpr int VEC_BYTES = 2 * RA_CHUNK * 2;   // the chunk's bias and weight scales
  static constexpr int LDH = D + 8;           // staged hidden and w2 row stride (bf16)
  // once the tower product is done, the ring, the wd chunk and the vectors hold the
  // hidden, then w2's rows, then the up product's output block of RA_YB columns
  static constexpr int FREE_BYTES = RING_BYTES + WD_BYTES + VEC_BYTES;
  static constexpr int HID_BYTES = BM * LDH * 2;
  static constexpr int YS_BYTES = BM * (RA_YB + 8) * 4;    // room for fp32
  // rows of w2 a pass of the up product stages: a multiple of RA_ALIGN
  static constexpr int W2_ROWS =
      (FREE_BYTES - HID_BYTES - YS_BYTES) / (LDH * 2) / RA_ALIGN * RA_ALIGN;
  // the ring, the wd chunk, the vectors, the mbarriers, room to align the ring
  static constexpr int SMEM = FREE_BYTES + 2 * STAGES * 8 + 1024;
};

struct Args {
  const float* sa;    // (M,) row scales of int8 A
  const bf16* ws;     // (N,) weight scales of int8 W
  const bf16* bias;   // (N,)
  bf16* o;            // (M, N) or nullptr
  const bf16* wd;     // (D, N) the adapter's down weights
  const bf16* bd;     // (D,)
  bf16* h;            // (M, D) or nullptr
  int down_epi;
  int up_epi;
  const bf16* w2;     // (N, D) the up weights, or nullptr: no up product
  const bf16* b2;     // (N,)
  const bf16* x;      // (M, N) the residual
  bf16* y;            // (M, N)
};

__device__ __forceinline__ float erf_gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// o's value at the chunk's column n, rounded to bf16 (gemm.cu's EPI_BF16 and
// EPI_Q_BF16); vec: the chunk's bias, then its weight scales
template <typename Acc>
__device__ __forceinline__ float out_value(Acc acc, float sa, const bf16* vec, int n) {
  float v;
  if constexpr (std::is_integral<Acc>::value) {
    v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), __bfloat162float(vec[RA_CHUNK + n]));
  } else {
    v = acc;
  }
  return bf16_round(__fadd_rn(v, __bfloat162float(vec[n])));
}

__device__ __forceinline__ float down_value(float v, int epi) {
  if (epi == DOWN_GELU) return erf_gelu(v);
  if (epi == DOWN_RGELU) return erf_gelu(bf16_round(v));
  return v;
}

template <typename Op, int D, int WGS>
__global__ void __launch_bounds__(RTile<D, WGS>::THREADS, RTile<D, WGS>::BLOCKS_PER_SM)
    rowadapt_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_w, int M, int N, int K, const Args p) {
  using L = RTile<D, WGS>;
  constexpr int kConsumers = L::CONSUMERS;
  constexpr int LDW = L::LDW;
  using Acc = typename OpType<Op>::Acc;
  constexpr int BK = WG_BK_BYTES / static_cast<int>(sizeof(Op));
  constexpr int LDH = L::LDH;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* wds = reinterpret_cast<bf16*>(smem + L::RING_BYTES);             // wd's chunk, (D, 128)
  bf16* vec = reinterpret_cast<bf16*>(smem + L::RING_BYTES + L::WD_BYTES);  // bias, then ws
  bf16* hs = reinterpret_cast<bf16*>(smem);   // after the tower product
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::FREE_BYTES);
  uint64_t* empty = full + L::STAGES;
  const int m0 = blockIdx.x * L::BM;
  const int chunks = ceil_div(N, RA_CHUNK);
  const int ktiles = ceil_div(K, BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);        // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {         // producer: one thread issues every load
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int ch = 0; ch < chunks; ++ch)
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % L::STAGES;
          mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::STAGE_BYTES);   // a box past N counts whole, zero-filled
          uint8_t* st = smem + s * L::STAGE_BYTES;
          tma_load(st, &tm_a, kt * BK, m0, &full[s]);
          tma_load(st + L::A_BYTES, &tm_w, kt * BK, ch * RA_CHUNK, &full[s]);
        }
    }
    return;
  }

  const int c = threadIdx.x / 128;          // this warpgroup's rows: 64 c .. 64 c + 63
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;   // 0 .. 4 WGS - 1
  const int g = lane >> 2, t = lane & 3;
  const int rl = warp * 16 + g;             // this thread's rows of the block: rl, rl + 8
  const int rows[2] = {m0 + rl, m0 + rl + 8};
  if (p.w2 != nullptr) {                    // x's rows into L2 while the tower product runs
    const int lines = ceil_div(N * 2, 128);
    for (int i = threadIdx.x; i < L::BM * lines; i += kConsumers) {
      const int r = m0 + i / lines;
      if (r < M) prefetch_l2(p.x + static_cast<size_t>(r) * N + (i % lines) * 64);
    }
  }
  float sr[2] = {0.f, 0.f};
  if constexpr (sizeof(Op) == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sr[hh] = rows[hh] < M ? p.sa[rows[hh]] : 0.f;
  }

  float hacc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) hacc[nt][0] = hacc[nt][1] = hacc[nt][2] = hacc[nt][3] = 0.f;
  Acc acc[RA_CHUNK / 2];
  int it = 0;
  for (int ch = 0; ch < chunks; ++ch) {
    const int n0 = ch * RA_CHUNK;
    // the chunk's columns of wd, bias and ws into shared memory while it multiplies
    // (16 bytes a copy; past N zero-filled), once every warp is done with the last
    bar_sync(1, kConsumers);
    for (int i = threadIdx.x; i < (D + 2) * (RA_CHUNK / 8); i += kConsumers) {
      const int r = i / (RA_CHUNK / 8), cc = (i % (RA_CHUNK / 8)) * 8;
      const bool in = n0 + cc < N;
      if (r < D) {
        cp_async16(wds + r * LDW + cc, in ? p.wd + static_cast<size_t>(r) * N + n0 + cc : p.wd,
                   in);
      } else {
        const bf16* v = r == D ? p.bias : p.ws;
        if (v != nullptr) cp_async16(vec + (r - D) * RA_CHUNK + cc, in ? v + n0 + cc : v, in);
      }
    }
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < RA_CHUNK / 2; ++i) acc[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % L::STAGES;
      mbar_wait(&full[s], (it / L::STAGES) & 1);
      const uint8_t* st = smem + s * L::STAGE_BYTES;
      const uint64_t da = smem_desc(st + c * RA_BM * WG_BK_BYTES);
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
    cp_async_wait<0>();
    bar_sync(1, kConsumers);                // every thread's copies of the chunk have landed

    // o in bf16, k16 by k16 (accumulator j * 4 + 2 hh + i: row rl + 8 hh, column
    // n0 + j * 8 + 2 t + i): a[2 jj + hh] is the mma A fragment of rows rl + 8 hh,
    // columns nb + 8 jj + 2 t, fed to the down product with wd's B fragments from
    // the staged chunk (rows d, two n8 tiles a load)
    const bf16* wdrow = wds + ((lane >> 4) * 8 + (lane & 7)) * LDW + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int s16 = 0; s16 < RA_CHUNK / 16; ++s16) {
      const int nb = n0 + 16 * s16;
      if (nb >= N) break;
      uint32_t a[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = 2 * s16 + jj, n = 16 * s16 + 8 * jj + 2 * t;
          a[2 * jj + hh] = pack_bf16x2(out_value(acc[j * 4 + 2 * hh], sr[hh], vec, n),
                                       out_value(acc[j * 4 + 2 * hh + 1], sr[hh], vec, n + 1));
        }
      if (p.o != nullptr) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (rows[hh] < M)
              *reinterpret_cast<uint32_t*>(p.o + static_cast<size_t>(rows[hh]) * N + nb + 8 * jj +
                                           2 * t) = a[2 * jj + hh];
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
        uint32_t b[4];
        ldsm_x4(b, wdrow + nt * 8 * LDW + 16 * s16);
        mma_bf16(hacc[nt], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma_bf16(hacc[nt + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
    }
  }

  // the hidden: + bd, the caller's epilogue, rounded to bf16 (columns nt * 8 + 2 t + i
  // of rows rl + 8 hh), staged for the up product over the ring, once every warp is
  // done with the last chunk's wd; each warp reads back its own rows
  bar_sync(1, kConsumers);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bd + col));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t hv =
          pack_bf16x2(down_value(__fadd_rn(hacc[nt][2 * hh], b.x), p.down_epi),
                      down_value(__fadd_rn(hacc[nt][2 * hh + 1], b.y), p.down_epi));
      *reinterpret_cast<uint32_t*>(hs + (rl + 8 * hh) * LDH + col) = hv;
      if (p.h != nullptr && rows[hh] < M)
        *reinterpret_cast<uint32_t*>(p.h + static_cast<size_t>(rows[hh]) * D + col) = hv;
    }
  }
  if (p.w2 == nullptr) return;
  __syncwarp();

  // y = bf16(x + u), u = bf16(h . w2^T + b2) (UP_RES1) or h . w2^T + b2 (UP_RESF): w2
  // staged over the ring in passes of W2_ROWS rows (16 bytes a copy, two n8 tiles a
  // ldmatrix); in steps of RA_YB columns each warp forms u of its 16 rows into a staged
  // block (bf16 for UP_RES1, fp32 for UP_RESF), then every thread adds 16-byte chunks
  // of x, loaded before the products, and stores y
  uint32_t ha[D / 16][4];
  const bf16* hrow = hs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(ha[kk], hrow + kk * 16);
  constexpr int LDY = RA_YB + 8;                        // elements a staged row
  constexpr int XCH = L::BM * RA_YB / 8 / kConsumers;   // x chunks a thread a step
  bf16* w2s = hs + L::BM * LDH;
  float* ys = reinterpret_cast<float*>(smem + L::FREE_BYTES - L::YS_BYTES);
  bf16* ysh = reinterpret_cast<bf16*>(ys);
  const bool round_u = p.up_epi == UP_RES1;             // warp-uniform
  const bf16* wrow = w2s + ((lane >> 4) * 8 + (lane & 7)) * LDH + ((lane >> 3) & 1) * 8;
  for (int nb0 = 0; nb0 < N; nb0 += L::W2_ROWS) {
    const int nrows = min(L::W2_ROWS, N - nb0);
    bar_sync(1, kConsumers);                // the last pass's reads are done
    for (int i = threadIdx.x; i < nrows * (D / 8); i += kConsumers) {
      const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
      cp_async16(w2s + r * LDH + cc, p.w2 + static_cast<size_t>(nb0 + r) * D + cc, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    bar_sync(1, kConsumers);
    for (int cb = 0; cb < nrows; cb += RA_YB) {
      const int cols = min(RA_YB, nrows - cb);   // a multiple of RA_ALIGN
      const int n0 = nb0 + cb;
      uint4 xr[XCH];
#pragma unroll
      for (int q = 0; q < XCH; ++q) {
        const int i = threadIdx.x + q * kConsumers;
        const int r = i / (RA_YB / 8), c8 = (i % (RA_YB / 8)) * 8;
        if (c8 < cols && m0 + r < M)
          xr[q] = __ldg(reinterpret_cast<const uint4*>(p.x + static_cast<size_t>(m0 + r) * N +
                                                       n0 + c8));
      }
#pragma unroll
      for (int pp = 0; pp < RA_YB; pp += 16) {
        if (pp >= cols) break;
        float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t bw[4];
          ldsm_x4(bw, wrow + (cb + pp) * LDH + kk * 16);
          mma_bf16(u[0], ha[kk][0], ha[kk][1], ha[kk][2], ha[kk][3], bw[0], bw[1]);
          mma_bf16(u[1], ha[kk][0], ha[kk][1], ha[kk][2], ha[kk][3], bw[2], bw[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = pp + 8 * nt + 2 * t;
          const float2 b =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b2 + n0 + col));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float v0 = __fadd_rn(u[nt][2 * hh], b.x), v1 = __fadd_rn(u[nt][2 * hh + 1], b.y);
            if (round_u)
              *reinterpret_cast<uint32_t*>(ysh + (rl + 8 * hh) * LDY + col) = pack_bf16x2(v0, v1);
            else
              *reinterpret_cast<float2*>(ys + (rl + 8 * hh) * LDY + col) = make_float2(v0, v1);
          }
        }
      }
      bar_sync(1, kConsumers);
#pragma unroll
      for (int q = 0; q < XCH; ++q) {
        const int i = threadIdx.x + q * kConsumers;
        const int r = i / (RA_YB / 8), c8 = (i % (RA_YB / 8)) * 8;
        if (c8 >= cols || m0 + r >= M) continue;
        float uf[8];
        if (round_u) {
          const uint4 uv = *reinterpret_cast<const uint4*>(ysh + r * LDY + c8);
          const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(&uv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 t = __bfloat1622float2(u2[e]);
            uf[2 * e] = t.x;
            uf[2 * e + 1] = t.y;
          }
        } else {
          const float4 ua = *reinterpret_cast<const float4*>(ys + r * LDY + c8);
          const float4 ub = *reinterpret_cast<const float4*>(ys + r * LDY + c8 + 4);
          uf[0] = ua.x; uf[1] = ua.y; uf[2] = ua.z; uf[3] = ua.w;
          uf[4] = ub.x; uf[5] = ub.y; uf[6] = ub.z; uf[7] = ub.w;
        }
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xr[q]);
        uint4 yv;
        __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(&yv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(x2[e]);
          y2[e] = __floats2bfloat162_rn(__fadd_rn(xf.x, uf[2 * e]),
                                        __fadd_rn(xf.y, uf[2 * e + 1]));
        }
        *reinterpret_cast<uint4*>(p.y + static_cast<size_t>(m0 + r) * N + n0 + c8) = yv;
      }
      bar_sync(1, kConsumers);              // the staged block is read
    }
  }
}

template <typename Op, int D, int WGS>
int launch(const void* A, const void* W, int M, int N, int K, const Args& p,
           cudaStream_t stream) {
  using L = RTile<D, WGS>;
  static bool ready = false;                // once a process: the shared-memory limit
  auto kernel = rowadapt_kernel<Op, D, WGS>;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  CUtensorMap tm_a, tm_w;
  int err = tensor_map<Op>(&tm_a, A, M, K, L::BM);
  if (err == 0) err = tensor_map<Op>(&tm_w, W, N, K, RA_CHUNK);
  if (err != 0) return err;
  kernel<<<ceil_div(M, L::BM), L::THREADS, L::SMEM, stream>>>(tm_a, tm_w, M, N, K, p);
  return static_cast<int>(cudaGetLastError());
}

// rows a block owns: 128 (two warpgroups share each chunk of W, read then once a 128
// rows) where that still gives every SM a block, else 64 (two blocks an SM)
int rows_per_block(int M) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return ceil_div(M, 2 * RA_BM) >= sms * 3 / 4 ? 2 * RA_BM : RA_BM;
}

template <typename Op, int D>
int launch_d(const void* A, const void* W, int M, int N, int K, const Args& p,
             cudaStream_t stream) {
  if (rows_per_block(M) == 2 * RA_BM) return launch<Op, D, 2>(A, W, M, N, K, p, stream);
  return launch<Op, D, 1>(A, W, M, N, K, p, stream);
}

template <typename Op>
int dispatch(const void* A, const void* W, int M, int N, int K, int D, const Args& p,
             cudaStream_t stream) {
  const auto misaligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 != 0; };
  const bool up = p.w2 != nullptr;
  if (M < 1 || N < RA_ALIGN || N % RA_ALIGN || K < 1 ||
      (K * static_cast<int>(sizeof(Op))) % TMA_ROW_ALIGN || misaligned(A) || misaligned(W) ||
      misaligned(p.o) || misaligned(p.h) || misaligned(p.wd) || misaligned(p.bias) ||
      misaligned(p.ws) || p.bias == nullptr ||
      p.wd == nullptr || p.bd == nullptr ||
      (p.down_epi != DOWN_BF16 && p.down_epi != DOWN_GELU && p.down_epi != DOWN_RGELU) ||
      (up && (p.b2 == nullptr || p.x == nullptr || p.y == nullptr || misaligned(p.w2) ||
              misaligned(p.x) || misaligned(p.y) ||
              (p.up_epi != UP_RES1 && p.up_epi != UP_RESF))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 16) return launch_d<Op, 16>(A, W, M, N, K, p, stream);
  if (D == 32) return launch_d<Op, 32>(A, W, M, N, K, p, stream);
  if (D == 48) return launch_d<Op, 48>(A, W, M, N, K, p, stream);
  if (D == 64) return launch_d<Op, 64>(A, W, M, N, K, p, stream);
  if (D == 96) return launch_d<Op, 96>(A, W, M, N, K, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* sa, const void* ws, const void* bias, void* O, const void* wd,
               const void* bd, void* H, int down_epi, int up_epi, const void* w2,
               const void* b2, const void* X, void* Y) {
  return Args{static_cast<const float*>(sa), static_cast<const bf16*>(ws),
              static_cast<const bf16*>(bias), static_cast<bf16*>(O),
              static_cast<const bf16*>(wd), static_cast<const bf16*>(bd), static_cast<bf16*>(H),
              down_epi, up_epi, static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
              static_cast<const bf16*>(X), static_cast<bf16*>(Y)};
}

}  // namespace

// A (M, K) . W (N, K)^T + bias -> O (M, N) bf16 (nullable: not stored); H (M, D) =
// epi(O . wd (D, N)^T + bd) (nullable: not stored), epi 0: bf16(acc + bd), 4: bf16(gelu(
// acc + bd)), 5: bf16(gelu(bf16(acc + bd))); with w2 (N, D) (nullable: no up product) Y
// = bf16(X + bf16(H . w2^T + b2)) (up_epi 8) or bf16(X + (H . w2^T + b2)) (9). All
// bf16, contiguous, 16-byte aligned; N a multiple of 32, K of 8; D in {16, 32, 48, 64,
// 96}
STG_API int stg_rowadapt_bf16(const void* A, const void* W, const void* bias, void* O,
                              const void* wd, const void* bd, void* H, const void* w2,
                              const void* b2, const void* X, void* Y, int M, int N, int K, int D,
                              int down_epi, int up_epi, cudaStream_t stream) {
  return dispatch<bf16>(
      A, W, M, N, K, D,
      make_args(nullptr, nullptr, bias, O, wd, bd, H, down_epi, up_epi, w2, b2, X, Y), stream);
}

// the same from int8 row codes A (M, K) with scales sa (M,) fp32 and int8 W (N, K) with
// scales ws (N,) bf16: O = bf16(float(A . W^T) * sa[m] * ws[n] + bias[n]); K a multiple
// of 16
STG_API int stg_rowadapt_s8(const void* A, const void* sa, const void* W, const void* ws,
                            const void* bias, void* O, const void* wd, const void* bd, void* H,
                            const void* w2, const void* b2, const void* X, void* Y, int M, int N,
                            int K, int D, int down_epi, int up_epi, cudaStream_t stream) {
  if (sa == nullptr || ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t>(
      A, W, M, N, K, D, make_args(sa, ws, bias, O, wd, bd, H, down_epi, up_epi, w2, b2, X, Y),
      stream);
}
