// stream_conv3x3: out = conv3x3(x, w), NHWC x, HWIO w, SAME zero padding,
// no bias, no ReLU; products summed in f32, the output rounded once to bf16.
// Replaces the streaming Pallas prototype `stream_conv` / `kernel` of
// scripts_dev/profile_stream_conv.py (nine per-tap rank-3 dots of the
// shifted input rows with w[dy, dx], summed, no scratch). Plain C interface,
// loaded with ctypes by gluefactory_tpu_torch/ops/cuda_conv3x3.py.
//
// Design: the body of vgg_block.cu's conv3x3_relu_mma_kernel without bias,
// ReLU or pool, reading HWIO weights as they are. An implicit GEMM on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulated in registers):
// a block computes 16 x 16 output pixels x 64 output channels with 8 warps,
// two pixel rows each. Input channels stream through shared memory 32 at a
// time with cp.async: the 18 x 18 pixel patch with its zero ring, and the
// 3 x 3 x 32 x 64 weights with C_out contiguous. Each of the 9 taps reads its
// A fragments with ldmatrix straight out of the patch, shifted by (dy, dx),
// so there is no im2col buffer and no scratch; the B fragments come from the
// weights with ldmatrix.trans. Padded rows keep both reads free of bank
// conflicts. The output is rounded to bf16 on the store.
//
// Bound at the conv1b shape (8 x 1024^2 x 64 -> 64, bf16): 2.15 GB of input
// and output at 3.35 TB/s, 0.641 ms, just above the 618 GFLOP at 989
// TFLOP/s, 0.625 ms; mma.sync reaches about two thirds of that rate at best,
// so the body is bound by the tensor cores before the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_utils.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;             // 8 warps, two pixel rows each
constexpr int kTile = 16;                 // 16 x 16 output pixels per block
constexpr int kPatch = kTile + 2;         // 18: the tile and its ring
constexpr int kCinChunk = 32;             // input channels per shared-memory stage
constexpr int kChans = 64;                // output channels per block
constexpr int kPatchLd = kCinChunk + 8;   // bf16 per patch pixel (80 B)
constexpr int kWLd = kChans + 8;          // bf16 per weight row (144 B)
constexpr size_t kSmem =
    static_cast<size_t>(kPatch * kPatch * kPatchLd + 9 * kCinChunk * kWLd) * sizeof(bf16);

// x (B, H, W, Ci), w (3, 3, Ci, Co), out (B, H, W, Co); Ci % 32 == 0,
// Co % 64 == 0. Grid (ceil(W / 16), ceil(H / 16), B * Co / 64).
__global__ void __launch_bounds__(kThreads)
    stream_conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          bf16* __restrict__ out, int H, int W, int Ci, int Co) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* patch = reinterpret_cast<bf16*>(smem_raw);   // [18 * 18][kPatchLd]
  bf16* wsm = patch + kPatch * kPatch * kPatchLd;     // [9 * 32][kWLd], rows (tap, ci)

  const int cblocks = Co / kChans;
  const int b = blockIdx.z / cblocks;
  const int co0 = (blockIdx.z % cblocks) * kChans;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;  // mma fragment row group / column pair
  const bf16* xb = x + static_cast<long long>(b) * H * W * Ci;

  float acc[2][8][4];  // [pixel row of the warp][8-channel tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += kCinChunk) {
    __syncthreads();  // the previous stage is consumed
    for (int e = threadIdx.x; e < kPatch * kPatch * (kCinChunk / 8); e += kThreads) {
      const int pix = e / (kCinChunk / 8), q = e % (kCinChunk / 8);
      const int y = y0 - 1 + pix / kPatch, xx = x0 - 1 + pix % kPatch;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
      const bf16* src = xb + (in ? (static_cast<long long>(y) * W + xx) * Ci : 0) + c0 + q * 8;
      gf::cp_async_16(patch + pix * kPatchLd + q * 8, src, in);
    }
    for (int e = threadIdx.x; e < 9 * kCinChunk * (kChans / 8); e += kThreads) {
      const int r = e / (kChans / 8), q = e % (kChans / 8);  // r = tap * 32 + ci
      const bf16* src =
          w + (static_cast<long long>(r / kCinChunk) * Ci + c0 + r % kCinChunk) * Co + co0 + q * 8;
      gf::cp_async_16(wsm + r * kWLd + q * 8, src, true);
    }
    gf::cp_async_commit();
    gf::cp_async_wait_0();
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kCinChunk / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int pix = (2 * warp + mt + dy) * kPatch + lane % 16 + dx;
          gf::ldmatrix_x4(a[mt], patch + pix * kPatchLd + kk * 16 + (lane / 16) * 8);
        }
        const int ci = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {  // two channel tiles per ldmatrix
          uint32_t bw[4];
          gf::ldmatrix_x4_trans(bw, wsm + (tap * kCinChunk + ci) * kWLd + nt * 8 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            gf::mma_bf16(acc[mt][nt], a[mt], bw[0], bw[1]);
            gf::mma_bf16(acc[mt][nt + 1], a[mt], bw[2], bw[3]);
          }
        }
      }
    }
  }

  // fragment e holds pixel g + 8 * (e / 2), channel 2 * tq + e % 2
  const int y = y0 + 2 * warp;  // the warp's first pixel row
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int yy = y + mt, xx = x0 + g + 8 * half;
      if (yy >= H || xx >= W) continue;
      bf16* o = out + ((static_cast<long long>(b) * H + yy) * W + xx) * Co + co0 + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<uint32_t*>(o + nt * 8) =
            gf::pack_bf16(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
}

}  // namespace

// x (B, H, W, Ci) NHWC bf16, w (3, 3, Ci, Co) HWIO bf16, out (B, H, W, Co)
// bf16, all contiguous and 16-byte aligned; Ci % 32 == 0, Co % 64 == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int gf_stream_conv3x3(const void* x, const void* w, void* out, int B, int H, int W,
                                 int Ci, int Co, void* stream) {
  if (Ci % kCinChunk != 0 || Co % kChans != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = gf::allow_shared_memory<stream_conv3x3_kernel>(static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B * (Co / kChans));
  stream_conv3x3_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), H, W, Ci,
      Co);
  return static_cast<int>(cudaGetLastError());
}
