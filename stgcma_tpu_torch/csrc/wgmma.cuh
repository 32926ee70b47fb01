// Hopper's TMA + wgmma building blocks, shared by csrc/gemm.cu (the tower
// products), csrc/ffn.cu (K7's FFN), csrc/tattn.cu (the temporal qkv product with its attention
// epilogue) and csrc/rowadapt.cu (the row-owning product with the adapter):
// the k-tile and alignment constants, mbarriers, 2-D and 3-D TMA loads of
// 128-byte swizzled boxes, wgmma descriptors and the warpgroup products at the widths
// the kernels take (m64 x n{32, 64, 96, 128, 192, 256}, bf16 k16 or s8 k32), and the
// tensor maps, encoded by cuTensorMapEncodeTiled from the driver the runtime
// has loaded (no link against libcuda).
#pragma once

#include <cuda.h>

#include "common.cuh"

constexpr int WG_BK_BYTES = 128;          // k-tile depth: 64 bf16 or 128 int8, one swizzle row
constexpr int WG_KSTEP_BYTES = 32;        // one wgmma: k16 bf16 or k32 int8
constexpr int TMA_ROW_ALIGN = 16;         // bytes: K * sizeof(operand) and every base

// bf16 operands accumulate in fp32, int8 ones in int32
template <typename Op> struct OpType;
template <> struct OpType<bf16> {
  using Acc = float;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct OpType<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
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

// the box at (k0, r1, r2) of a 3-D tensor map (K the innermost dimension), likewise
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int k0, int r1,
                                            int r2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(r1), "r"(r2),
         "r"(smem_u32(bar)) : "memory");
}

// wgmma operand descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// start address / 16, leading offset 1 (unused), stride 1024 bytes between 8-row
// groups, layout 1 (SWIZZLE_128B). A 32-byte k-step (k16 bf16 or k32 int8) adds 2
// to the start: the bytes are laid out alike for both types.
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

// order this thread's generic-proxy writes to shared memory before the async proxy's
// reads of it (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving reads of an accumulator across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// the accumulator operands of one wgmma: 8 at a time, with constraint c ("+f" or "+r")
#define WG_ACC8(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), \
    c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define WG_ACC32(c) WG_ACC8(c, 0), WG_ACC8(c, 8), WG_ACC8(c, 16), WG_ACC8(c, 24)
#define WG_ACC64(c) WG_ACC32(c), WG_ACC8(c, 32), WG_ACC8(c, 40), WG_ACC8(c, 48), WG_ACC8(c, 56)
#define WG_REGS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS64 WG_REGS32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (m64 x n64 fp32, 32 a thread) += A (64 x k16 bf16, descriptor da) . B (n64 x k16, db)^T
__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32 "}, %32, %33, p, 1, 1, "
      "0, 0;\n}\n"
      : WG_ACC32("+f") : "l"(da), "l"(db));
}

// d (m64 x n128 fp32, 64 a thread) += A (64 x k16 bf16) . B (n128 x k16)^T
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS64 "}, %64, %65, p, 1, 1, "
      "0, 0;\n}\n"
      : WG_ACC64("+f") : "l"(da), "l"(db));
}

// d (m64 x n128 s32, 64 a thread) += A (64 x k32 s8) . B (n128 x k32 s8)^T; 8-bit
// wgmma takes K-major operands only and has no scale or transpose immediates
__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WG_REGS64 "}, %64, %65, p;\n}\n"
      : WG_ACC64("+r") : "l"(da), "l"(db));
}

// named barrier `id` over the first `threads` threads of the block (the
// consumer warpgroups; the producer warp never waits on it)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// the widths of one head's q, k and v slabs side by side (N = 3 dh): 96 and 192
#define WG_ACC48(c) WG_ACC32(c), WG_ACC8(c, 32), WG_ACC8(c, 40)
#define WG_ACC96(c) WG_ACC64(c), WG_ACC8(c, 64), WG_ACC8(c, 72), WG_ACC8(c, 80), WG_ACC8(c, 88)
#define WG_REGS48 WG_REGS32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_REGS96 WG_REGS64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"

// d (m64 x n96 fp32, 48 a thread) += A (64 x k16 bf16) . B (n96 x k16)^T
__device__ __forceinline__ void wgmma_step(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" WG_REGS48 "}, %48, %49, p, 1, 1, "
      "0, 0;\n}\n"
      : WG_ACC48("+f") : "l"(da), "l"(db));
}

// d (m64 x n192 fp32, 96 a thread) += A (64 x k16 bf16) . B (n192 x k16)^T
__device__ __forceinline__ void wgmma_step(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" WG_REGS96 "}, %96, %97, p, 1, "
      "1, 0, 0;\n}\n"
      : WG_ACC96("+f") : "l"(da), "l"(db));
}

// d (m64 x n96 s32) += A (64 x k32 s8) . B (n96 x k32 s8)^T
__device__ __forceinline__ void wgmma_step(int (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {" WG_REGS48 "}, %48, %49, p;\n}\n"
      : WG_ACC48("+r") : "l"(da), "l"(db));
}

// d (m64 x n192 s32) += A (64 x k32 s8) . B (n192 x k32 s8)^T
__device__ __forceinline__ void wgmma_step(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {" WG_REGS96 "}, %96, %97, p;\n}\n"
      : WG_ACC96("+r") : "l"(da), "l"(db));
}

// csrc/ffn.cu's widths: fc1 of half a 64-column step (n32) and fc2 over C = 256 (n256)
#define WG_ACC16(c) WG_ACC8(c, 0), WG_ACC8(c, 8)
#define WG_ACC128(c) WG_ACC64(c), WG_ACC8(c, 64), WG_ACC8(c, 72), WG_ACC8(c, 80), \
    WG_ACC8(c, 88), WG_ACC8(c, 96), WG_ACC8(c, 104), WG_ACC8(c, 112), WG_ACC8(c, 120)
#define WG_REGS16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_REGS128 WG_REGS64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d (m64 x n32 fp32, 16 a thread) += A (64 x k16 bf16) . B (n32 x k16)^T
__device__ __forceinline__ void wgmma_step(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_REGS16 "}, %16, %17, p, 1, 1, "
      "0, 0;\n}\n"
      : WG_ACC16("+f") : "l"(da), "l"(db));
}

// d (m64 x n256 fp32, 128 a thread) += A (64 x k16 bf16) . B (n256 x k16)^T
__device__ __forceinline__ void wgmma_step(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS128 "}, %128, %129, p, 1, "
      "1, 0, 0;\n}\n"
      : WG_ACC128("+f") : "l"(da), "l"(db));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (nullptr if it has none)
inline EncodeTiled encode_tiled() {
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

// a (rows, K) row-major tensor of Op in boxes of 128 bytes of k by box_rows rows,
// 128-byte swizzled; reads past its edges are zeros
template <typename Op>
inline int tensor_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(Op)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(WG_BK_BYTES / sizeof(Op)),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, OpType<Op>::TMA, 2, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a (d2, d1, K) row-major tensor of Op in boxes of 128 bytes of k by b1 by b2, 128-byte
// swizzled: a box lands as b2 * b1 rows of 128 bytes, index i2 * b1 + i1, as a 2-D box
// of that many rows would; reads past its edges are zeros
template <typename Op>
inline int tensor_map_3d(CUtensorMap* map, const void* ptr, int d2, int d1, int K, int b2,
                         int b1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K) * sizeof(Op),
                                 static_cast<cuuint64_t>(K) * d1 * sizeof(Op)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(WG_BK_BYTES / sizeof(Op)),
                             static_cast<cuuint32_t>(b1), static_cast<cuuint32_t>(b2)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, OpType<Op>::TMA, 3, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
