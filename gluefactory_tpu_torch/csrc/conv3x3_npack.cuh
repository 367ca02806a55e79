// The N-packed consumer body of the 3x3 conv kernels (conv3x3_npack.cu and
// vgg_block.cu), on the skeleton of conv3x3_tile.cuh; its formulation and
// design are described at the head of conv3x3_npack.cu.

#pragma once

#include "conv3x3_tile.cuh"

namespace gf {
namespace conv {

struct NpackBody {
  static constexpr bool kStoreUnderProducts = true;
  float p[96];      // P of the current input row: [dy0 | dy1 | dy2] x 64 channels
  float part0[32];  // P[r - 1][0:64]
  float part1[32];  // P[r - 2][0:64] + P[r - 1][64:128]
  float out_[32];   // output row r - 2 until it is stored

  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int j = 0; j < 32; ++j) part0[j] = part1[j] = 0.f;
  }

  // the products of one K atom of input row r; the first of atom 0 starts P
  template <bool kFirst>
  __device__ __forceinline__ void issue(uint32_t x_addr, uint32_t w_addr) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A: 64 pixels x 16 channels of slab dx (K-major, 32 B steps in a row)
        const uint64_t da = a_desc(x_addr, dx) + 2 * kk;
        // B: rows dx * 64 + 16 kk .. of the three dy boxes (MN-major, the
        // dy boxes kDyBytes apart)
        const uint64_t db =
            sm90::smem_desc(w_addr + dx * kDxBytes + kk * 2048, kDyBytes, 1024, 128);
        if (kFirst && dx == 0 && kk == 0)
          sm90::wgmma_m64n192k16_ss_tb<false>(p, da, db);
        else
          sm90::wgmma_m64n192k16_ss_tb<true>(p, da, db);
      }
  }

  __device__ __forceinline__ void fence() { sm90::fence_regs(p); }

  __device__ __forceinline__ void empty_row() {
#pragma unroll
    for (int j = 0; j < 96; ++j) p[j] = 0.f;
  }

  // output row r - 1 into out_; P is free for the next row after this
  __device__ __forceinline__ void finish_row() {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      out_[j] = part1[j] + p[64 + j];
      part1[j] = part0[j] + p[32 + j];
      part0[j] = p[j];
    }
  }

  __device__ __forceinline__ float out(int j) const { return out_[j]; }

  __device__ __forceinline__ void advance() {}
};

}  // namespace conv
}  // namespace gf
