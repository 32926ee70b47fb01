// Row prologues of K1-K3 and K7 (C >= 512), and the LayerNorm K9: LayerNorm and per-row
// int8 activation quantization.
//
// Replaces, in stgcma_tpu/ops/pallas_attn.py:
//   - K9, the row LayerNorm _ln_kernel (:755) with fp32 statistics and bf16
//     in and out: ln_rows_kernel computes exactly its function (at Swin's
//     patch-embed, merge and final norms, C = 128..3072, up to 250880 rows);
//   - LN cast to x.dtype before the bf16 qkv product (_win_block_kernel :394-400)
//     and before fc1 (_ffn_kernel :679-684) at the FFN widths csrc/ffn.cu
//     does not instantiate (ffn.cu repeats ln_rows_kernel's lane order in
//     its own prologue),
//   - LN kept in fp32, then _quant_rows (:1335) before an int8 product
//     (_win_block_q_core :1434-1440, _ffn_q_kernel :1620-1626),
//   - _quant_rows of the bf16 attention output (:1457) and of the fp32 FFN
//     hidden (:1632);
// and, in stgcma_tpu/ops/pallas_swin_block.py _swin_block_kernel (:245), K4's
// LN1 of both streams in one launch (the rows of v, then of a: stg_ln_bf16_pair)
// and its int8 variant's LN1 and LN2 rounded to bf16, then quantized
// (:279-338; stg_ln_quant_rows_bf16, the two streams' LN1 in one launch).
// Bound on the H100: bytes (~1 flop per byte). Both kernels read each row from
// device memory once, with 16-byte loads (8 bf16 or 4 fp32 a lane a load), and
// hold it in registers while they form its statistics from it.
// LayerNorm (K9 and every LN prologue of bf16 rows, ln_rows_kernel): LPR lanes a
// row, 32 / LPR rows a warp (16 lanes at C = 128, 8 at C = 192, so that no lane
// idles where a row is shorter than a warp's 32 chunks), up to kLnMaxChunks
// chunks a lane (rows up to 4096 values: Swin-Large's 3072-wide merge norm
// included); the output is written 16 bytes a lane. (Two rows a lane group, all
// their loads issued first, ran 1-3% slower on an H100 at C = 128-512.)
// Row quantization writes its int8 codes 8 or 4 at a time: one warp per row, the
// row held in registers (up to kMaxHeldChunks 16-byte chunks a lane: 2048 bf16
// or 1024 fp32 values) while the LN statistics, the max |x| and the codes are
// formed from it; wider rows are staged in shared memory instead. Given each
// row's max |x| (the fp32 FFN hiddens, whose producing product's epilogue takes
// it: csrc/gemm.cu), it only quantizes, in one streaming pass.
// Numerics follow the JAX kernels: fp32 mean and centred variance, the
// products and sums rounded one by one (__fmul_rn/__fadd_rn, no contraction),
// scale = max(|x|, 1e-30) * (1/127), q = rint(x * (1/scale)) clamped to +-127
// with a correctly rounded reciprocal and round-half-even (rintf). The LN sums
// run over a lane's chunks in their order, then across the row's lanes (a
// butterfly): another order than the JAX kernel's, so a statistic may differ in
// its last bit.
#include "common.cuh"

namespace {

// Rows [0, m_lo) of the input are those of x, rows [m_lo, M) those of x_hi (K4's
// two streams in one launch; x_hi = x and m_lo = M elsewhere)
template <typename T>
__device__ __forceinline__ const T* in_row(const T* x, const T* x_hi, int m_lo, int row, int K) {
  return row < m_lo ? x + static_cast<size_t>(row) * K
                    : x_hi + static_cast<size_t>(row - m_lo) * K;
}

// 16 bytes of a row as floats: 8 bf16 or 4 fp32
template <typename T> struct Chunk;
template <> struct Chunk<bf16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};
template <> struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

// E bf16 LN parameters from p (16- or 8-byte aligned) as floats
template <int E>
__device__ __forceinline__ void load_params(const bf16* p, float (&f)[E]) {
  if constexpr (E == 8) {
    Chunk<bf16>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = lo.x;
    f[1] = lo.y;
    f[2] = hi.x;
    f[3] = hi.y;
  }
}

// the E codes of f at scale 1 / inv, into q (E-byte aligned)
template <int E>
__device__ __forceinline__ void store_codes(int8_t* q, const float (&f)[E], float inv) {
  uint32_t w[E / 4];
#pragma unroll
  for (int i = 0; i < E / 4; ++i) w[i] = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float t = rintf(__fmul_rn(f[e], inv));
    t = fminf(fmaxf(t, -127.f), 127.f);
    w[e / 4] |= (static_cast<uint32_t>(__float2int_rn(t)) & 0xffu) << (8 * (e % 4));
  }
  if constexpr (E == 8) *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  else *reinterpret_cast<uint32_t*>(q) = w[0];
}

constexpr int kMaxHeldChunks = 8;  // 16-byte chunks a lane holds in registers

// f(c) for each chunk c = 0 .. n - 1 of a lane, unrolled where n = CH is known
template <int CH, typename F>
__device__ __forceinline__ void each_chunk(int n, F f) {
  if constexpr (CH > 0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) f(c);
  } else {
    for (int c = 0; c < n; ++c) f(c);
  }
}

constexpr int kLnMaxChunks = 16;   // 16-byte chunks a lane of ln_rows_kernel holds

// the sum of v over the LPR lanes of a row (aligned groups of a warp)
template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of bf16 rows into y (M, K) bf16, each row read once: LPR lanes a row, the
// lane's chunk c holding elements (c LPR + sub) 8 .. + 7 (sub = lane % LPR; chunks
// past the row's K / 8 are zeros and not stored); every lane of a warp runs the
// shuffles, those of rows past M on zeros
template <int LPR, int CH>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ x_hi, int m_lo,
    const bf16* __restrict__ g, const bf16* __restrict__ b, bf16* __restrict__ y, int M, int K,
    float eps) {
  const int sub = threadIdx.x % LPR;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / LPR;
  const int n16 = K / 8;
  const bool live = row < M;
  const uint4* xr = reinterpret_cast<const uint4*>(in_row(x, x_hi, m_lo, live ? row : 0, K));
  uint4 held[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {                 // the one read of the row
    const int i = c * LPR + sub;
    held[c] = live && i < n16 ? __ldg(xr + i) : make_uint4(0, 0, 0, 0);
  }
  float s = 0.f;                                 // zeros add nothing
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float f[8];
    Chunk<bf16>::unpack(held[c], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e];
  }
  const float mean = group_sum<LPR>(s) / static_cast<float>(K);
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c * LPR + sub >= n16) continue;
    float f[8];
    Chunk<bf16>::unpack(held[c], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = __fsub_rn(f[e], mean);
      v = __fadd_rn(v, __fmul_rn(d, d));
    }
  }
  const float rstd = rsqrtf(group_sum<LPR>(v) / static_cast<float>(K) + eps);
  if (!live) return;
  uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * K);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = c * LPR + sub;
    if (i >= n16) continue;
    float f[8], gf[8], bf[8];
    Chunk<bf16>::unpack(held[c], f);
    load_params<8>(g + i * 8, gf);
    load_params<8>(b + i * 8, bf);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const float lo = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e], mean), rstd), gf[e]), bf[e]);
      const float hi =
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e + 1], mean), rstd), gf[e + 1]), bf[e + 1]);
      const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
      o[e / 2] = *reinterpret_cast<const uint32_t*>(&h);
    }
    yr[i] = out;
  }
}

// One warp per row; the lane's chunk c holds elements (32 c + lane) E .. + E - 1.
// CH > 0: a lane's chunks in registers (rows up to 512 CH bytes); CH == 0: the
// warp's row staged in shared memory, or (amax_in given) no row kept at all.
// ROUND: the LayerNorm is rounded to bf16 before its max and its codes (K4q).
template <typename T, int CH, bool ROUND>
__global__ void __launch_bounds__(256) quant_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ x_hi, int m_lo, const bf16* __restrict__ g,
    const bf16* __restrict__ b, const float* __restrict__ amax_in, int8_t* __restrict__ q,
    float* __restrict__ sx, int M, int K, float eps) {
  using V = Chunk<T>;
  constexpr int E = V::E;
  extern __shared__ uint4 staged[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= M) return;
  const int n16 = K / E;                         // 16-byte chunks of the row
  const uint4* xr = reinterpret_cast<const uint4*>(in_row(x, x_hi, m_lo, row, K));
  int8_t* qr = q + static_cast<size_t>(row) * K;

  if (amax_in != nullptr) {                      // scale given: one streaming pass
    const float s = __fmul_rn(fmaxf(amax_in[row], 1e-30f), 1.0f / 127.0f);
    const float inv = __frcp_rn(s);
#pragma unroll 4
    for (int i = lane; i < n16; i += 32) {
      float f[E];
      V::unpack(__ldg(xr + i), f);
      store_codes<E>(qr + i * E, f, inv);
    }
    if (lane == 0) sx[row] = s;
    return;
  }

  const int nch = ceil_div(n16, 32);             // chunks of a lane (CH == 0)
  uint4 held[CH > 0 ? CH : 1];
  uint4* srow = staged + static_cast<size_t>(warp) * n16;
  each_chunk<CH>(nch, [&](int c) {               // the one read of the row
    const int i = c * 32 + lane;
    if constexpr (CH > 0) {
      held[c] = i < n16 ? __ldg(xr + i) : make_uint4(0, 0, 0, 0);
    } else if (i < n16) {
      srow[i] = __ldg(xr + i);
    }
  });
  auto raw = [&](int c, float (&f)[E]) {
    if constexpr (CH > 0) V::unpack(held[c], f);
    else V::unpack(srow[c * 32 + lane], f);
  };

  float mean = 0.f, rstd = 1.f;
  if (g != nullptr) {
    float s = 0.f;
    each_chunk<CH>(nch, [&](int c) {
      if (c * 32 + lane >= n16) return;
      float f[E];
      raw(c, f);
#pragma unroll
      for (int e = 0; e < E; ++e) s += f[e];
    });
    mean = warp_sum(s) / static_cast<float>(K);
    float v = 0.f;
    each_chunk<CH>(nch, [&](int c) {
      if (c * 32 + lane >= n16) return;
      float f[E];
      raw(c, f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = __fsub_rn(f[e], mean);
        v = __fadd_rn(v, __fmul_rn(d, d));
      }
    });
    rstd = rsqrtf(warp_sum(v) / static_cast<float>(K) + eps);
  }
  // the values quantized: the row, or its LayerNorm in fp32
  auto value = [&](int c, float (&f)[E]) {
    raw(c, f);
    if (g == nullptr) return;
    float gf[E], bf[E];
    const int k0 = (c * 32 + lane) * E;
    load_params<E>(g + k0, gf);
    load_params<E>(b + k0, bf);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      f[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e], mean), rstd), gf[e]), bf[e]);
      if constexpr (ROUND) f[e] = __bfloat162float(__float2bfloat16_rn(f[e]));
    }
  };
  float amax = 0.f;
  each_chunk<CH>(nch, [&](int c) {
    if (c * 32 + lane >= n16) return;
    float f[E];
    value(c, f);
#pragma unroll
    for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(f[e]));
  });
  amax = warp_max(amax);
  const float s = __fmul_rn(fmaxf(amax, 1e-30f), 1.0f / 127.0f);
  const float inv = __frcp_rn(s);
  each_chunk<CH>(nch, [&](int c) {
    const int i = c * 32 + lane;
    if (i >= n16) return;
    float f[E];
    value(c, f);
    store_codes<E>(qr + i * E, f, inv);
  });
  if (lane == 0) sx[row] = s;
}

constexpr int kRowsPerBlock = 8;   // 8 warps of 32 threads, one row each
constexpr int kMaxStagedBytes = 232448;   // shared memory of one block on the H100

struct Src {                // rows [0, m_lo) from x, [m_lo, M) from x_hi
  const void* x;
  const void* x_hi;
  int m_lo;
};

template <typename T, int CH, bool ROUND>
int launch_quant(const Src& src, const bf16* g, const bf16* b, const float* amax, int8_t* q,
                 float* sx, int M, int K, float eps, int rows, int smem, cudaStream_t stream) {
  auto kernel = quant_rows_kernel<T, CH, ROUND>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<ceil_div(M, rows), 32 * rows, smem, stream>>>(
      static_cast<const T*>(src.x), static_cast<const T*>(src.x_hi), src.m_lo, g, b, amax, q, sx,
      M, K, eps);
  return static_cast<int>(cudaGetLastError());
}

// K a multiple of 16 (16-byte rows of int8 codes), x, q, g and b 16-byte aligned;
// amax (nullable) only without LN
template <typename T, bool ROUND = false>
int quant_rows(const Src& x, const bf16* g, const bf16* b, const float* amax, int8_t* q,
               float* sx, int M, int K, float eps, cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 1 || K < 16 || K % 16 || misaligned(x.x) || misaligned(x.x_hi) || misaligned(q) ||
      (g != nullptr && (misaligned(g) || b == nullptr || misaligned(b) || amax != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = ceil_div(K * static_cast<int>(sizeof(T)) / 16, 32);   // a lane's
  const int R = kRowsPerBlock;
  if (amax != nullptr)
    return launch_quant<T, 0, ROUND>(x, g, b, amax, q, sx, M, K, eps, R, 0, stream);
  switch (chunks) {
    case 1: return launch_quant<T, 1, ROUND>(x, g, b, amax, q, sx, M, K, eps, R, 0, stream);
    case 2: return launch_quant<T, 2, ROUND>(x, g, b, amax, q, sx, M, K, eps, R, 0, stream);
    case 3: return launch_quant<T, 3, ROUND>(x, g, b, amax, q, sx, M, K, eps, R, 0, stream);
    case 4: return launch_quant<T, 4, ROUND>(x, g, b, amax, q, sx, M, K, eps, R, 0, stream);
    default:
      if (chunks <= kMaxHeldChunks)
        return launch_quant<T, kMaxHeldChunks, ROUND>(x, g, b, amax, q, sx, M, K, eps, R, 0,
                                                      stream);
  }
  // wider rows: staged in shared memory, as many rows a block as fit 64 KB (at least one)
  const int row_bytes = K * static_cast<int>(sizeof(T));
  if (row_bytes > kMaxStagedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = (64 * 1024) / row_bytes;
  const int rows = fit < 1 ? 1 : fit < R ? fit : R;
  return launch_quant<T, 0, ROUND>(x, g, b, amax, q, sx, M, K, eps, rows, rows * row_bytes,
                                   stream);
}

template <int LPR, int CH>
int launch_ln(const Src& src, const bf16* g, const bf16* b, bf16* y, int M, int K, float eps,
              cudaStream_t stream) {
  ln_rows_kernel<LPR, CH><<<ceil_div(M, 256 / LPR), 256, 0, stream>>>(
      static_cast<const bf16*>(src.x), static_cast<const bf16*>(src.x_hi), src.m_lo, g, b, y, M,
      K, eps);
  return static_cast<int>(cudaGetLastError());
}

// a lane's chunks rounded up to the held counts instantiated
template <int LPR>
int launch_ln_ch(int chunks, const Src& src, const bf16* g, const bf16* b, bf16* y, int M, int K,
                 float eps, cudaStream_t stream) {
  if (chunks <= 1) return launch_ln<LPR, 1>(src, g, b, y, M, K, eps, stream);
  if (chunks <= 2) return launch_ln<LPR, 2>(src, g, b, y, M, K, eps, stream);
  if (chunks <= 3) return launch_ln<LPR, 3>(src, g, b, y, M, K, eps, stream);
  if (chunks <= 4) return launch_ln<LPR, 4>(src, g, b, y, M, K, eps, stream);
  if (chunks <= 6) return launch_ln<LPR, 6>(src, g, b, y, M, K, eps, stream);
  if (chunks <= 8) return launch_ln<LPR, 8>(src, g, b, y, M, K, eps, stream);
  if (chunks <= 12) return launch_ln<LPR, 12>(src, g, b, y, M, K, eps, stream);
  return launch_ln<LPR, 16>(src, g, b, y, M, K, eps, stream);
}

// K a multiple of 8 up to 32 kLnMaxChunks 8 = 4096; every pointer 16-byte aligned. Lanes a
// row: 32 or 16 where they divide the row's K / 8 chunks, else 8 (some idle where 8 does
// not divide them either), or 32 where 8 would hold more than kLnMaxChunks
int ln_rows(const Src& src, const bf16* g, const bf16* b, bf16* y, int M, int K, float eps,
            cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const int n16 = K / 8;
  if (M < 1 || K < 8 || K % 8 || n16 > 32 * kLnMaxChunks || g == nullptr || b == nullptr ||
      misaligned(src.x) || misaligned(src.x_hi) || misaligned(g) || misaligned(b) ||
      misaligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n16 % 32 == 0) return launch_ln_ch<32>(n16 / 32, src, g, b, y, M, K, eps, stream);
  if (n16 % 16 == 0) return launch_ln_ch<16>(n16 / 16, src, g, b, y, M, K, eps, stream);
  if (n16 <= 8 * kLnMaxChunks)
    return launch_ln_ch<8>(ceil_div(n16, 8), src, g, b, y, M, K, eps, stream);
  return launch_ln_ch<32>(ceil_div(n16, 32), src, g, b, y, M, K, eps, stream);
}

}  // namespace

// LayerNorm of bf16 rows into y (M, K) bf16: rows [0, M0) of x0, then [M0, M) of x1; K
// a multiple of 8 up to 4096, every pointer 16-byte aligned
STG_API int stg_ln_bf16_pair(const void* x0, const void* x1, int M0, const void* g, const void* b,
                             void* y, int M, int K, float eps, cudaStream_t stream) {
  return ln_rows(Src{x0, x1, M0}, static_cast<const bf16*>(g), static_cast<const bf16*>(b),
                 static_cast<bf16*>(y), M, K, eps, stream);
}

STG_API int stg_ln_bf16(const void* x, const void* g, const void* b, void* y,
                        int M, int K, float eps, cudaStream_t stream) {
  return stg_ln_bf16_pair(x, x, M, g, b, y, M, K, eps, stream);
}

// int8 row quantization of x (M, K), bf16 or fp32, after a LayerNorm when g and b are
// given, or from the given per-row max |x| amax ((M,) fp32, nullable; no LN): codes q
// (M, K) int8 and scales sx (M,) fp32
STG_API int stg_quant_rows(const void* x, int x_is_f32, const void* g, const void* b,
                           const void* amax, void* q, void* sx, int M, int K, float eps,
                           cudaStream_t stream) {
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* bb = static_cast<const bf16*>(b);
  const float* mx = static_cast<const float*>(amax);
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = static_cast<float*>(sx);
  const Src src{x, x, M};
  if (x_is_f32) return quant_rows<float>(src, gb, bb, mx, qq, ss, M, K, eps, stream);
  return quant_rows<bf16>(src, gb, bb, mx, qq, ss, M, K, eps, stream);
}

// K4q's LN1 and LN2: the LayerNorm of bf16 rows (rows [0, M0) of x0, then [M0, M) of
// x1), rounded to bf16, int8-quantized per row: codes q (M, K) int8, scales sx (M,) fp32
STG_API int stg_ln_quant_rows_bf16(const void* x0, const void* x1, int M0, const void* g,
                                   const void* b, void* q, void* sx, int M, int K, float eps,
                                   cudaStream_t stream) {
  if (g == nullptr || b == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return quant_rows<bf16, true>(Src{x0, x1, M0}, static_cast<const bf16*>(g),
                                static_cast<const bf16*>(b), nullptr, static_cast<int8_t*>(q),
                                static_cast<float*>(sx), M, K, eps, stream);
}
