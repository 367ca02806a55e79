// Helpers shared by the port's kernels: f32 <-> storage conversion, shared
// addresses, bf16 packing, and the host's shared-memory set-up.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gf {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// relu of two f32 as a bf16 pair, lo in the low half: one conversion (rounding
// and relu commute, both being monotonic with relu(0) = 0)
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// lane-wise max of two bf16 pairs
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Host side: lets `Kernel` take `bytes` of dynamic shared memory on the
// current device. cudaFuncSetAttribute runs only when the kernel needs more
// than it was allowed so far on that device, not on every launch. `static`:
// each library keeps its own record. Two libraries built from one header
// hold two distinct kernels of the same name, and an inline template's
// static would be one object shared by both (a unique symbol of the
// process), so the second library would skip its own attribute call.
template <auto Kernel>
static inline cudaError_t allow_shared_memory(int bytes) {
  constexpr int kMaxDevices = 64;
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

}  // namespace gf
