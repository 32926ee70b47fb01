// Bidirectional gated cross-modal fusion (the STG-CMA exchange) of K4, K5, K6 and K12:
//   vo = vh + bf16(gv * softmax(vh . ah^T + mask) . ah)
//   ao = ah + bf16(ga * softmax(ah . vh^T + mask^T) . vh)
// per batch row b, with unscaled fp32 logits and an optional additive mask (Nv, Na).
//
// Replaces, in stgcma_tpu/ops/pallas_attn.py, K5 _win_fuse_kernel (:1222: one
// window per row, N = 49 at Swin stages 0-1), K6 _bidir_fuse_full_kernel
// (:1103) and _bidir_fuse_kernel (:1051: the full stage grid, N = 3136 or 784),
// and the two _fuse calls inside K4 _swin_block_kernel
// (stgcma_tpu/ops/pallas_swin_block.py:354: N = 196 with the -1e30 per-window
// fuse mask, N = 49 unmasked), and the two _xfuse calls inside K12
// _fusion_block_kernel (stgcma_tpu/ops/pallas_clip_block.py:141: Nv = 197
// video against Na = 49 audio tokens, D = 48, unmasked, without its pad to
// multiples of 16 and the pad keys' mask).
// The TPU kernels hold the whole (Nv, Na) fp32 gram on chip (39 MB at stage 0).
// An H100 block has at most 227 KB of shared memory, so this kernel tiles
// both directions flash-style: a block owns 64 query rows of one direction
// (blockIdx.z: 0 = rows of vh against ah, 1 = rows of ah against vh), walks
// the other stream in tiles of 64 keys with a running max, sum and fp32
// accumulator per row, and ends in the gated residual. The gram is computed
// twice (once per direction); the TPU's single-exp column trick
// (exp(m_i - M), :1137) is a later optimisation.
// Numerics: logits fp32 from bf16 operands; exp(l - m_running) (__expf,
// the SFU's ex2 of a product with log2 e, a few ulp); the
// unnormalized probabilities are rounded to bf16 for the p.v product (the
// plain version rounds the normalized ones: both are one bf16 rounding of
// each probability), the sum divides at the end exactly, gate * a2v is
// rounded to bf16 and added to the query stream, rounded again. Keys past
// the stream's end are -inf. A key tile that is fully masked (-1e30) for a
// row gives exp(0) = 1 for each of its keys until a tile with a real key
// arrives, whose max then wipes them (factor exp(-1e30 - m) = 0); every row
// of the port's masks has a real key, so the result is the masked softmax.
// Bound on the H100: the exps on the SFU at K6's full-grid shapes (at least
// one per gram entry; this kernel takes one per entry and direction); the
// bytes of vh and ah at K5's 49-token windows. Design: mma.sync m16n8k16 (bf16 in, fp32 accumulate) for both
// products, as attn.cu; one warp owns 16 query rows, 4 warps a block; the
// key tile sits in shared memory as K (keys x D) and V^T (D x keys), the
// probabilities' accumulator fragments are reused as the A operand of p.v.
// D in {16, 32, 48, 64, 96} (96: Swin-Large's adapter width at every stage, six
// k16 steps; its static shared memory is 64 * 104 * 2 + 96 * 72 * 2 bytes,
// ~27 KB); any Nv, Na >= 1.
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

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int BQ = 16 * kWarps;   // query rows per block
constexpr int BK = 64;            // keys per tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t load2(const bf16* base, int row, int col, int n, int D) {
  if (row >= n) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(row) * D + col);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Dir {
  const bf16* q;      // (B, Nq, D): the query stream, also the residual
  const bf16* k;      // (B, Nk, D): keys (and values, where GATED)
  const bf16* v;      // (B, Nk, D): values (!GATED)
  const bf16* gate;   // (1,); null where !GATED
  bf16* out;          // (B, Nq, D)
  int Nq, Nk;
  int mrs, mcs;       // element (i, j) of this direction's mask at i * mrs + j * mcs
};

// GATED: the fusion (both directions, keys = values, gated residual); else K10
// (blockIdx.z = 0 only, separate values, o = a2v)
template <int D, bool GATED>
__global__ void __launch_bounds__(kWarps * 32) fuse_kernel(Dir d0, Dir d1, const float* mask) {
  constexpr int LDK = D + 8;      // K row stride (bf16), conflict-free fragment loads
  constexpr int LDV = BK + 8;     // V^T row stride (bf16)
  __shared__ __align__(16) bf16 ks[BK * LDK];
  __shared__ __align__(16) bf16 vt[D * LDV];

  // each field selected on its own: a reference to one of the two parameter
  // structs would copy it to local memory
  const bool z = blockIdx.z != 0;
  const int Nq = z ? d1.Nq : d0.Nq, Nk = z ? d1.Nk : d0.Nk;
  const int mrs = z ? d1.mrs : d0.mrs, mcs = z ? d1.mcs : d0.mcs;
  const int q0 = static_cast<int>(blockIdx.x) * BQ;
  if (q0 >= Nq) return;                          // the shorter direction's spare blocks
  const int b = blockIdx.y;
  const bf16* qb = (z ? d1.q : d0.q) + static_cast<size_t>(b) * Nq * D;
  const bf16* kb = (z ? d1.k : d0.k) + static_cast<size_t>(b) * Nk * D;
  const bf16* vb = GATED ? kb : d0.v + static_cast<size_t>(b) * Nk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's two query rows

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    qa[kk][0] = load2(qb, r0, c0, Nq, D);
    qa[kk][1] = load2(qb, r1, c0, Nq, D);
    qa[kk][2] = load2(qb, r0, c0 + 8, Nq, D);
    qa[kk][3] = load2(qb, r1, c0 + 8, Nq, D);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j0 = 0; j0 < Nk; j0 += BK) {
    __syncthreads();                             // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * (D / 2); i += blockDim.x) {
      const int j = i / (D / 2), w = i % (D / 2);
      uint32_t kw = 0u, vw = 0u;
      if (j0 + j < Nk) {
        kw = reinterpret_cast<const uint32_t*>(kb + static_cast<size_t>(j0 + j) * D)[w];
        vw = GATED ? kw
                   : reinterpret_cast<const uint32_t*>(vb + static_cast<size_t>(j0 + j) * D)[w];
      }
      *reinterpret_cast<uint32_t*>(ks + j * LDK + 2 * w) = kw;
      const __nv_bfloat162 v2 = *reinterpret_cast<__nv_bfloat162*>(&vw);
      vt[(2 * w) * LDV + j] = v2.x;
      vt[(2 * w + 1) * LDV + j] = v2.y;
    }
    __syncthreads();

    // logits: s[nt] holds keys j0 + nt*8 + 2t (+1) of rows r0 (elements 0, 1) and r1 (2, 3)
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = ks + (nt * 8 + g) * LDK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                 *reinterpret_cast<const uint32_t*>(krow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
      }
    }
    if (mask != nullptr || j0 + BK > Nk) {       // masked or ragged tile
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
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
    for (int nt = 0; nt < BK / 8; ++nt) {
      tm0 = fmaxf(tm0, fmaxf(s[nt][0], s[nt][1]));
      tm1 = fmaxf(tm1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(tm0)), mn1 = fmaxf(m1, quad_max(tm1));
    const float f0 = __expf(m0 - mn0), f1 = __expf(m1 - mn1);   // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = __expf(__fsub_rn(s[nt][0], m0));
      s[nt][1] = __expf(__fsub_rn(s[nt][1], m0));
      s[nt][2] = __expf(__fsub_rn(s[nt][2], m1));
      s[nt][3] = __expf(__fsub_rn(s[nt][3], m1));
      ts0 += s[nt][0] + s[nt][1];
      ts1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * f0 + quad_sum(ts0);
    l1 = l1 * f1 + quad_sum(ts1);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= f0;
      acc[nd][1] *= f0;
      acc[nd][2] *= f1;
      acc[nd][3] *= f1;
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a0 = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const bf16* vrow = vt + (nd * 8 + g) * LDV + kc * 16 + 2 * t;
        mma_bf16(acc[nd], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 8));
      }
    }
  }

  // out = q + bf16(gate * a2v), rounded to bf16; K10: out = bf16(a2v)
  const float gate = GATED ? __bfloat162float(*(z ? d1.gate : d0.gate)) : 0.f;
  bf16* ob = (z ? d1.out : d0.out) + static_cast<size_t>(b) * Nq * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h == 0 ? r0 : r1;
      if (row >= Nq) continue;
      const float l = h == 0 ? l0 : l1;
      const size_t i = static_cast<size_t>(row) * D + col;
      if constexpr (!GATED) {
        *reinterpret_cast<__nv_bfloat162*>(ob + i) =
            __floats2bfloat162_rn(__fdiv_rn(acc[nd][2 * h], l), __fdiv_rn(acc[nd][2 * h + 1], l));
        continue;
      }
      const float2 q2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qb + i));
      const float u0 = __bfloat162float(__float2bfloat16_rn(
          __fmul_rn(gate, __fdiv_rn(acc[nd][2 * h], l))));
      const float u1 = __bfloat162float(__float2bfloat16_rn(
          __fmul_rn(gate, __fdiv_rn(acc[nd][2 * h + 1], l))));
      *reinterpret_cast<__nv_bfloat162*>(ob + i) =
          __floats2bfloat162_rn(__fadd_rn(q2.x, u0), __fadd_rn(q2.y, u1));
    }
  }
}

template <int D, bool GATED>
int launch(const Dir& d0, const Dir& d1, const float* mask, int B, cudaStream_t stream) {
  const int nmax = d0.Nq > d1.Nq ? d0.Nq : d1.Nq;
  const dim3 grid(ceil_div(nmax, BQ), B, GATED ? 2 : 1);
  fuse_kernel<D, GATED><<<grid, kWarps * 32, 0, stream>>>(d0, d1, mask);
  return static_cast<int>(cudaGetLastError());
}

template <bool GATED>
int launch_d(const Dir& d0, const Dir& d1, const float* mask, int B, int D,
             cudaStream_t stream) {
  if (D == 16) return launch<16, GATED>(d0, d1, mask, B, stream);
  if (D == 32) return launch<32, GATED>(d0, d1, mask, B, stream);
  if (D == 48) return launch<48, GATED>(d0, d1, mask, B, stream);
  if (D == 64) return launch<64, GATED>(d0, d1, mask, B, stream);
  if (D == 96) return launch<96, GATED>(d0, d1, mask, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// vh (B, Nv, D), ah (B, Na, D), vo/ao likewise, all bf16 and contiguous; gv, ga: (1,)
// bf16; mask: nullable (Nv, Na) fp32, added to the (Nv, Na) gram in both directions.
// D in {16, 32, 48, 64, 96}; B <= 65535.
STG_API int stg_fuse_bidir(const void* vh, const void* ah, const void* gv, const void* ga,
                           const void* mask, void* vo, void* ao, int B, int Nv, int Na, int D,
                           cudaStream_t stream) {
  if (B > 65535 || Nv < 1 || Na < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* v = static_cast<const bf16*>(vh);
  const bf16* a = static_cast<const bf16*>(ah);
  const Dir d0{v, a, a, static_cast<const bf16*>(gv), static_cast<bf16*>(vo), Nv, Na, Na, 1};
  const Dir d1{a, v, v, static_cast<const bf16*>(ga), static_cast<bf16*>(ao), Na, Nv, 1, Na};
  return launch_d<true>(d0, d1, static_cast<const float*>(mask), B, D, stream);
}

// K10: q (B, Nq, D), k and v (B, Nk, D), o (B, Nq, D), all bf16 and contiguous:
// o = softmax(q . k^T) . v, unscaled. D in {16, 32, 48, 64, 96}; B <= 65535.
STG_API int stg_unscaled_attn(const void* q, const void* k, const void* v, void* o, int B,
                              int Nq, int Nk, int D, cudaStream_t stream) {
  if (B > 65535 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Dir d{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), nullptr, static_cast<bf16*>(o), Nq, Nk, 0, 0};
  return launch_d<false>(d, d, nullptr, B, D, stream);
}
