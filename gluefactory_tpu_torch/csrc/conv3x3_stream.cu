// stream_conv3x3: out = conv3x3(x, w), NHWC x, HWIO w, SAME zero padding,
// no bias, no ReLU; products summed in f32, the output rounded once to bf16.
// Replaces the streaming Pallas prototype `stream_conv` / `kernel` of
// scripts_dev/profile_stream_conv.py (nine per-tap products of the shifted
// input rows with w[dy, dx], summed, no scratch). Plain C interface, loaded
// with ctypes by gluefactory_tpu_torch/ops/cuda_conv3x3.py.
//
// Design (the skeleton, producer, stages and epilogue: conv3x3_tile.cuh):
// every output row takes its nine tap products, 9 x C_in / 16 wgmma
// m64n64k16 (M = 64 pixels, N = 64 output channels), with A a dx-shifted
// window of an input row as TMA wrote it and B the tap's 64 x 64 weights
// read MN-major from the resident HWIO boxes. The products are issued as
// the input rows arrive: input row v adds its dy = 2, 1 and 0 taps to the
// accumulators of output rows v - 1, v and v + 1 (3 x 32 f32 registers a
// thread), so each input row is held in one stage only and output row v - 1
// leaves after row v. The two halo rows of a strip issue all their taps too,
// into rows that are never stored (1,054 input rows per 1,024 output rows at
// conv1b, 2.9% more work, as the N-packed kernel): skipping them is a
// branch around wgmma, which ptxas answers by serialising every wgmma of
// the kernel (warning C7520).
//
// Layout (a) of the two: C_out = 64 as N, the products as they are, with A
// in registers. Each (dx, 16-channel) A fragment serves the three dy taps,
// so it is read from shared memory once (plain 32-bit loads from the
// swizzled box, conflict-free) instead of once per wgmma. Per row that is
// 24 KB of A and 72 KB of B: 768 clocks at the 128 B a clock shared memory
// delivers, under the 1,152 clocks of the row's products at the tensor
// cores' peak; A read by descriptor makes it 144 KB, 1,152 clocks, with
// TMA's writes on top. Register A was 12-13% faster
// than A from shared memory (0.981-0.983 ms against 1.119-1.136, both timed
// in one call by scripts_dev/profile_stream_conv.py on an H100 80GB HBM3 at
// 700 W). The transposed product (C_out as M,
// 128-256 pixels as N) would read less per product too, but needs a
// transposing epilogue and another stage shape than the N-packed kernel's;
// (a) shares everything with it, so the two formulations differ in their
// products alone.
//
// Bound at the conv1b shape (8 x 1024^2 x 64 -> 64): bytes 0.641 ms,
// operations 0.625 ms (0.644 ms of the kernel's own work).

#include "conv3x3_tile.cuh"

namespace {

using gf::conv::kDyBytes;
using gf::conv::kDxBytes;

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

struct StreamBody {
  static constexpr bool kStoreUnderProducts = false;
  float acc[3][32];  // output rows v - 1, v, v + 1 while input row v is taken
  uint32_t a_row;    // byte offset of this thread's A row 16 warp + g in a tap
  uint32_t g, q4;    // its row in the accumulator layout, its channel pair's bytes

  __device__ __forceinline__ StreamBody() {
    const int t = threadIdx.x % 128, lane = t % 32;
    g = lane / 4;
    q4 = 4 * (lane % 4);
    a_row = (16 * (t / 32) + g) * 128;
  }

  __device__ __forceinline__ void begin() {}

  // the nine taps of one K atom of input row v: dy feeds output row
  // v + 1 - dy; the first product of atom 0 starts output row v + 1. A is
  // read from shared memory into registers once and serves all three dy.
  template <bool kFirst>
  __device__ __forceinline__ void issue(uint32_t x_addr, uint32_t w_addr) {
    uint32_t a[3][4][4];  // [dx][kk]: the register A fragments of 64 pixels x 16 channels
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // pixels 16 warp + g (+ 8) of the tap, rows dx + 16 warp + g (+ 8)
        // of the box; channels 16 kk + 2q (+ 8), in the 128-byte swizzle TMA
        // wrote (16-byte chunk c of box row r at c ^ (r % 8))
        const uint32_t row = x_addr + dx * 128 + a_row;
        const uint32_t key = (g + dx) & 7;
        const uint32_t c0 = ((2 * kk) ^ key) << 4, c1 = ((2 * kk + 1) ^ key) << 4;
        a[dx][kk][0] = lds32(row + c0 + q4);
        a[dx][kk][1] = lds32(row + 1024 + c0 + q4);
        a[dx][kk][2] = lds32(row + c1 + q4);
        a[dx][kk][3] = lds32(row + 1024 + c1 + q4);
      }
    gf::sm90::wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint64_t db = gf::sm90::smem_desc(
              w_addr + dy * kDyBytes + dx * kDxBytes + kk * 2048, kDyBytes, 1024, 128);
          if (kFirst && dy == 0 && dx == 0 && kk == 0)
            gf::sm90::wgmma_m64n64k16_rs_tb<false>(acc[2], a[dx][kk], db);
          else
            gf::sm90::wgmma_m64n64k16_rs_tb<true>(acc[2 - dy], a[dx][kk], db);
        }
  }

  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int r = 0; r < 3; ++r) gf::sm90::fence_regs(acc[r]);
  }

  __device__ __forceinline__ void empty_row() {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[2][j] = 0.f;
  }

  __device__ __forceinline__ void finish_row() {}

  __device__ __forceinline__ float out(int j) const { return acc[0][j]; }

  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[0][j] = acc[1][j];
      acc[1][j] = acc[2][j];
    }
  }
};

}  // namespace

// x (B, H, W, Ci) NHWC bf16, w (3, 3, Ci, Co) HWIO bf16, out (B, H, W, Co)
// bf16, all contiguous and 16-byte aligned; Ci and Co positive multiples of
// 64. Returns a cudaError_t (0 = launched).
extern "C" int gf_stream_conv3x3(const void* x, const void* w, void* out, int B, int H, int W,
                                 int Ci, int Co, void* stream) {
  return static_cast<int>(gf::conv::launch<StreamBody>(x, w, out, B, H, W, Ci, Co,
                                                       static_cast<cudaStream_t>(stream)));
}
