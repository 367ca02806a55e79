// Hopper (sm_90a) building blocks of the attention and 3x3 conv kernels:
// mbarriers, TMA tensor loads and stores, wgmma (warpgroup MMA) with
// shared-memory descriptors, named barriers, register reallocation between
// warpgroups, and the host-side encoding of TMA tensor maps. The encoder is reached through
// cudaGetDriverEntryPoint, so nothing links against libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_utils.cuh"

namespace gf {
namespace sm90 {

// ---------------------------------------------------------------------------
// mbarriers (shared-memory addresses from smem_u32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` from asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the phase of parity `parity` has completed. A wait of more
// than 2^34 clocks (about 9 s) can only be a protocol fault: it traps, so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a box of a 4-D tensor into shared memory; the
// barrier counts the bytes (the whole box, zero-filled past the tensor's end)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA store: one thread copies a box out of shared memory; the parts of the
// box past the tensor's end are not written. Completion is tracked by bulk
// groups: commit after the stores, then wait until the source may be reused.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the committed stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before later TMA reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// named barriers (id 0 is __syncthreads), register reallocation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of the layout TMA wrote (128 or
// 64 bytes). K-major swizzled operands ignore the leading offset; the
// stride offset steps from one group of 8 rows to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma and the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x n128, f32) = A (smem, K-major) * B (smem, K-major) [+ d]
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n192, f32) = A (smem, K-major) * B (smem, MN-major) [+ d if kAcc].
// Without kAcc the old d is not read: the compiler may treat it as dead.
template <bool kAcc>
__device__ __forceinline__ void wgmma_m64n192k16_ss_tb(float (&d)[96], uint64_t da, uint64_t db) {
#define GF_WGMMA_M64N192K16_SS_TB(MODE) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, " \
      "%96, %97, p, 1, 1, 0, 1;\n}\n" \
      : MODE(d[0]), MODE(d[1]), MODE(d[2]), MODE(d[3]), MODE(d[4]), MODE(d[5]), MODE(d[6]), MODE(d[7]), \
        MODE(d[8]), MODE(d[9]), MODE(d[10]), MODE(d[11]), MODE(d[12]), MODE(d[13]), MODE(d[14]), MODE(d[15]), \
        MODE(d[16]), MODE(d[17]), MODE(d[18]), MODE(d[19]), MODE(d[20]), MODE(d[21]), MODE(d[22]), MODE(d[23]), \
        MODE(d[24]), MODE(d[25]), MODE(d[26]), MODE(d[27]), MODE(d[28]), MODE(d[29]), MODE(d[30]), MODE(d[31]), \
        MODE(d[32]), MODE(d[33]), MODE(d[34]), MODE(d[35]), MODE(d[36]), MODE(d[37]), MODE(d[38]), MODE(d[39]), \
        MODE(d[40]), MODE(d[41]), MODE(d[42]), MODE(d[43]), MODE(d[44]), MODE(d[45]), MODE(d[46]), MODE(d[47]), \
        MODE(d[48]), MODE(d[49]), MODE(d[50]), MODE(d[51]), MODE(d[52]), MODE(d[53]), MODE(d[54]), MODE(d[55]), \
        MODE(d[56]), MODE(d[57]), MODE(d[58]), MODE(d[59]), MODE(d[60]), MODE(d[61]), MODE(d[62]), MODE(d[63]), \
        MODE(d[64]), MODE(d[65]), MODE(d[66]), MODE(d[67]), MODE(d[68]), MODE(d[69]), MODE(d[70]), MODE(d[71]), \
        MODE(d[72]), MODE(d[73]), MODE(d[74]), MODE(d[75]), MODE(d[76]), MODE(d[77]), MODE(d[78]), MODE(d[79]), \
        MODE(d[80]), MODE(d[81]), MODE(d[82]), MODE(d[83]), MODE(d[84]), MODE(d[85]), MODE(d[86]), MODE(d[87]), \
        MODE(d[88]), MODE(d[89]), MODE(d[90]), MODE(d[91]), MODE(d[92]), MODE(d[93]), MODE(d[94]), MODE(d[95]) \
      : "l"(da), "l"(db), "r"(int(kAcc)))
  if constexpr (kAcc)
    GF_WGMMA_M64N192K16_SS_TB("+f");
  else
    GF_WGMMA_M64N192K16_SS_TB("=f");
#undef GF_WGMMA_M64N192K16_SS_TB
}

// d (m64 x n64, f32) = A (smem, K-major) * B (smem, MN-major) [+ d if kAcc].
// Without kAcc the old d is not read: the compiler may treat it as dead.
template <bool kAcc>
__device__ __forceinline__ void wgmma_m64n64k16_ss_tb(float (&d)[32], uint64_t da, uint64_t db) {
#define GF_WGMMA_M64N64K16_SS_TB(MODE) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 1;\n}\n" \
      : MODE(d[0]), MODE(d[1]), MODE(d[2]), MODE(d[3]), MODE(d[4]), MODE(d[5]), MODE(d[6]), MODE(d[7]), \
        MODE(d[8]), MODE(d[9]), MODE(d[10]), MODE(d[11]), MODE(d[12]), MODE(d[13]), MODE(d[14]), MODE(d[15]), \
        MODE(d[16]), MODE(d[17]), MODE(d[18]), MODE(d[19]), MODE(d[20]), MODE(d[21]), MODE(d[22]), MODE(d[23]), \
        MODE(d[24]), MODE(d[25]), MODE(d[26]), MODE(d[27]), MODE(d[28]), MODE(d[29]), MODE(d[30]), MODE(d[31]) \
      : "l"(da), "l"(db), "r"(int(kAcc)))
  if constexpr (kAcc)
    GF_WGMMA_M64N64K16_SS_TB("+f");
  else
    GF_WGMMA_M64N64K16_SS_TB("=f");
#undef GF_WGMMA_M64N64K16_SS_TB
}

// d (m64 x n64, f32) = A (registers, 64 x 16 bf16) * B (smem, MN-major)
// [+ d if kAcc]
template <bool kAcc = true>
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t db) {
#define GF_WGMMA_M64N64K16_RS_TB(MODE) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : MODE(d[0]), MODE(d[1]), MODE(d[2]), MODE(d[3]), MODE(d[4]), MODE(d[5]), MODE(d[6]), MODE(d[7]), \
        MODE(d[8]), MODE(d[9]), MODE(d[10]), MODE(d[11]), MODE(d[12]), MODE(d[13]), MODE(d[14]), MODE(d[15]), \
        MODE(d[16]), MODE(d[17]), MODE(d[18]), MODE(d[19]), MODE(d[20]), MODE(d[21]), MODE(d[22]), MODE(d[23]), \
        MODE(d[24]), MODE(d[25]), MODE(d[26]), MODE(d[27]), MODE(d[28]), MODE(d[29]), MODE(d[30]), MODE(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(int(kAcc)))
  if constexpr (kAcc)
    GF_WGMMA_M64N64K16_RS_TB("+f");
  else
    GF_WGMMA_M64N64K16_RS_TB("=f");
#undef GF_WGMMA_M64N64K16_RS_TB
}

// d (m64 x n32, f32) += A (registers, 64 x 16 bf16) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor of (batch, heads, tokens, D) with element strides sb, sh, sn
// (the feature dimension contiguous) as a 4-D map over (D, tokens, heads,
// batch), read in boxes of `box_rows` tokens of one head. Rows of 128 bytes
// (D = 64) get the 128-byte swizzle, rows of 64 bytes (D = 32) the 64-byte
// one: the layouts wgmma reads. The caller guarantees a 16-byte aligned
// base and strides that are positive multiples of 16 bytes.
inline cudaError_t encode_rows(CUtensorMap* map, const void* base, int D, int tokens, int heads,
                               int batch, long long sn, long long sh, long long sb, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(tokens), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(sn) * 2, cuuint64_t(sh) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(D), cuuint32_t(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      D * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous bf16 tensor of 4 dimensions, innermost first, read or written
// in boxes whose innermost extent is 64 elements (128 bytes, the 128-byte
// swizzle that wgmma reads). Parts of a box outside the tensor load as zeros
// (negative coordinates included) and are not stored.
inline cudaError_t encode_128b(CUtensorMap* map, const void* base, const long long (&dims)[4],
                               const cuuint32_t (&box)[4]) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t d[4], strides[3];
  cuuint64_t stride = 2;
  for (int i = 0; i < 4; ++i) {
    d[i] = cuuint64_t(dims[i]);
    if (i > 0) strides[i - 1] = stride;
    stride *= d[i];
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// NHWC activations (B, H, W, C) as (C, W, H, B), in boxes of 64 channels x
// `box_w` pixels of one row of one image.
inline cudaError_t encode_nhwc(CUtensorMap* map, const void* base, int B, int H, int W, int C,
                               int box_w) {
  return encode_128b(map, base, {C, W, H, B}, {64, cuuint32_t(box_w), 1, 1});
}

// HWIO 3x3 weights (3, 3, Ci, Co) as (Co, Ci, 3 dx, 3 dy), in boxes of 64
// output channels x 64 input channels x the 3 dx taps of one dy: 192 rows
// (dx, ci) of 128 bytes, output channels contiguous (an MN-major B operand).
inline cudaError_t encode_hwio3x3(CUtensorMap* map, const void* base, int Ci, int Co) {
  return encode_128b(map, base, {Co, Ci, 3, 3}, {64, 64, 3, 1});
}

}  // namespace sm90
}  // namespace gf
