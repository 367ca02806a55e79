// fused_vgg_block: one SuperPoint VGG block, NHWC,
//   maxpool2x2(relu(conv3x3_b(relu(conv3x3_a(x)))))
// with the single-conv and no-pool variants (replaces `fused_vgg_block` /
// `_vgg_kernel` of gluefactory_tpu/ops/pallas_conv.py). Plain C interface,
// loaded with ctypes by gluefactory_tpu_torch/ops/cuda_conv.py.
//
// Semantics of the TPU kernel: every 3x3 conv sums in f32, adds the bias in
// f32, then ReLU; between the two convs the activation is rounded to x's
// dtype; conv_b's SAME padding reads zeros beyond the image (never conv_a
// values); the 2x2/2 max-pool follows the last ReLU; the output is rounded
// to x's dtype.
//
// Two bodies, one kernel launch per conv:
//   - bf16 (the path C shapes: C_in % 32 == 0, C_out % 64 == 0),
//     `conv3x3_relu_mma_kernel`: an implicit GEMM on the tensor cores
//     (mma.sync m16n8k16, bf16 in, f32 accumulate). A block computes 16 x 16
//     output pixels x 64 output channels with 8 warps, two pixel rows each.
//     Input channels stream through shared memory 32 at a time with
//     cp.async: an 18 x 18 pixel patch with its zero ring and the 3 x 3 x 64
//     x 32 weights, both with a padded row so ldmatrix reads are free of bank
//     conflicts. Each of the 9 taps reads its A fragments straight out of the
//     patch, shifted by (dy, dx), so no im2col buffer exists. The 2x2 pool is
//     done in registers: the two pixel rows of a warp are its two m-tiles and
//     the pixel pairs sit in lanes 4 apart (one shuffle).
//   - any other shape, and f32, `conv3x3_relu_kernel`: a direct convolution
//     on the CUDA cores; a block computes 16 x 16 pixels x 64 channels, each
//     thread 2 x 2 pixels x 16 channels (64 f32 sums, so the pool stays in
//     its registers); input channels stream through shared memory 8 at a
//     time as f32.
// The two-conv variant runs the conv twice from the C entry point: conv_a
// writes its ReLU'd activation, rounded to x's dtype, to a scratch image in
// device memory, which conv_b reads with its own zero ring, so the SAME
// padding of conv_b is zeros by construction. The TPU kernel keeps that
// activation in VMEM; keeping it on chip, double-buffered stages and wgmma
// are the next steps.
//
// Bound at the main path's shapes (8 images, bf16): 618 GFLOP for conv1b +
// pool at 1024^2 x 64, 309 / 232 / 77 GFLOP for blocks 2-4: bound by
// operations (0.63 / 0.31 / 0.23 / 0.08 ms at 989 TFLOP/s on the bf16
// tensor cores; mma.sync reaches about two thirds of that rate at best).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_utils.cuh"

namespace {

using gf::from_f32;
using gf::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kQuadRows = 8, kQuadCols = 8;  // 2x2 pixel quads per block
constexpr int kPixRows = 2 * kQuadRows, kPixCols = 2 * kQuadCols;
constexpr int kChanPerThread = 16;
constexpr int kChanGroups = 4;
constexpr int kBlockChans = kChanPerThread * kChanGroups;  // 64
constexpr int kThreads = kQuadRows * kQuadCols * kChanGroups;  // 256
constexpr int kCinChunk = 8;
constexpr int kPatchRows = kPixRows + 2, kPatchCols = kPixCols + 2;

// out = relu(conv3x3(x, w) + bias) [-> maxpool 2x2/2], NHWC, SAME zero pad.
// x (B, H, W, Ci), w (3, 3, Co, Ci), bias (Co), out (B, H', W', Co).
// Ci % 8 == 0, Co % 16 == 0.
template <typename T, bool kPool>
__global__ void __launch_bounds__(kThreads)
    conv3x3_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ out, int H, int W, int Ci,
                        int Co) {
  __shared__ float patch[kCinChunk][kPatchRows][kPatchCols + 1];
  __shared__ __align__(16) float wsm[9][kCinChunk][kBlockChans];

  const int cblocks = (Co + kBlockChans - 1) / kBlockChans;
  const int b = blockIdx.z / cblocks;
  const int co0 = (blockIdx.z % cblocks) * kBlockChans;
  const int y0 = blockIdx.y * kPixRows, x0 = blockIdx.x * kPixCols;
  const int t = threadIdx.x;
  const int cg = t % kChanGroups, quad = t / kChanGroups;
  const int qr = quad / kQuadCols, qc = quad % kQuadCols;
  const int cbase = co0 + cg * kChanPerThread;  // this thread's first channel
  const bool active = cbase < Co;
  const T* xb = x + static_cast<long long>(b) * H * W * Ci;

  float acc[2][2][kChanPerThread];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < kChanPerThread; ++k) acc[i][j][k] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += kCinChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = t; e < kPatchRows * kPatchCols * kCinChunk; e += kThreads) {
      const int c = e % kCinChunk, p = e / kCinChunk;
      const int py = p / kPatchCols, px = p % kPatchCols;
      const int y = y0 - 1 + py, xx = x0 - 1 + px;
      patch[c][py][px] = (y >= 0 && y < H && xx >= 0 && xx < W)
                             ? to_f32(xb[(static_cast<long long>(y) * W + xx) * Ci + c0 + c])
                             : 0.f;
    }
    for (int e = t; e < 9 * kCinChunk * kBlockChans; e += kThreads) {
      const int co = e % kBlockChans, rest = e / kBlockChans;
      const int c = rest % kCinChunk, tap = rest / kCinChunk;
      wsm[tap][c][co] =
          co0 + co < Co ? to_f32(w[(static_cast<long long>(tap) * Co + co0 + co) * Ci + c0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kCinChunk; ++c) {
      float in[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) in[i][j] = patch[c][2 * qr + i][2 * qc + j];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        float wv[kChanPerThread];
        const float4* wp = reinterpret_cast<const float4*>(&wsm[tap][c][cg * kChanPerThread]);
#pragma unroll
        for (int q = 0; q < kChanPerThread / 4; ++q) {
          const float4 f = wp[q];
          wv[4 * q] = f.x, wv[4 * q + 1] = f.y, wv[4 * q + 2] = f.z, wv[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int py = 0; py < 2; ++py)
#pragma unroll
          for (int px = 0; px < 2; ++px) {
            const float xin = in[py + dy][px + dx];
#pragma unroll
            for (int k = 0; k < kChanPerThread; ++k) acc[py][px][k] = fmaf(xin, wv[k], acc[py][px][k]);
          }
      }
    }
  }
  if (!active) return;

  float bv[kChanPerThread];
#pragma unroll
  for (int k = 0; k < kChanPerThread; ++k) bv[k] = to_f32(bias[cbase + k]);
#pragma unroll
  for (int py = 0; py < 2; ++py)
#pragma unroll
    for (int px = 0; px < 2; ++px)
#pragma unroll
      for (int k = 0; k < kChanPerThread; ++k) acc[py][px][k] = fmaxf(acc[py][px][k] + bv[k], 0.f);

  const int gy = y0 + 2 * qr, gx = x0 + 2 * qc;  // top-left pixel of the quad
  if (kPool) {
    const int Ho = H / 2, Wo = W / 2, oy = gy / 2, ox = gx / 2;
    if (oy >= Ho || ox >= Wo) return;
    T* o = out + ((static_cast<long long>(b) * Ho + oy) * Wo + ox) * Co + cbase;
#pragma unroll
    for (int k = 0; k < kChanPerThread; ++k) {
      const float m = fmaxf(fmaxf(acc[0][0][k], acc[0][1][k]), fmaxf(acc[1][0][k], acc[1][1][k]));
      o[k] = from_f32<T>(m);
    }
  } else {
#pragma unroll
    for (int py = 0; py < 2; ++py)
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        const int y = gy + py, xx = gx + px;
        if (y >= H || xx >= W) continue;
        T* o = out + ((static_cast<long long>(b) * H + y) * W + xx) * Co + cbase;
#pragma unroll
        for (int k = 0; k < kChanPerThread; ++k) o[k] = from_f32<T>(acc[py][px][k]);
      }
  }
}

constexpr int kMmaThreads = 256;  // 8 warps, two pixel rows each
constexpr int kMmaCinChunk = 32;  // input channels per shared-memory stage
constexpr int kMmaLd = kMmaCinChunk + 8;  // bf16 per patch pixel / weight row
constexpr int kMmaChans = 64;     // output channels per block
constexpr int kMmaPatch = kPixRows + 2;  // 18: the 16 x 16 tile and its ring
constexpr size_t kMmaSmem =
    static_cast<size_t>(kMmaPatch * kMmaPatch + 9 * kMmaChans) * kMmaLd * sizeof(bf16);

// bf16, Ci % 32 == 0, Co % 64 == 0; same contract as conv3x3_relu_kernel
template <bool kPool>
__global__ void __launch_bounds__(kMmaThreads)
    conv3x3_relu_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                            const bf16* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                            int Ci, int Co) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* patch = reinterpret_cast<bf16*>(smem_raw);        // [18 * 18][kMmaLd]
  bf16* wsm = patch + kMmaPatch * kMmaPatch * kMmaLd;     // [9 * 64][kMmaLd], rows (tap, co)

  const int cblocks = Co / kMmaChans;
  const int b = blockIdx.z / cblocks;
  const int co0 = (blockIdx.z % cblocks) * kMmaChans;
  const int y0 = blockIdx.y * kPixRows, x0 = blockIdx.x * kPixCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;  // mma fragment row group / column pair
  const bf16* xb = x + static_cast<long long>(b) * H * W * Ci;

  float acc[2][8][4];  // [pixel row of the warp][8-channel tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += kMmaCinChunk) {
    __syncthreads();  // the previous stage is consumed
    for (int e = threadIdx.x; e < kMmaPatch * kMmaPatch * 4; e += kMmaThreads) {
      const int pix = e / 4, q = e % 4;
      const int y = y0 - 1 + pix / kMmaPatch, xx = x0 - 1 + pix % kMmaPatch;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
      const bf16* src = xb + (in ? (static_cast<long long>(y) * W + xx) * Ci : 0) + c0 + q * 8;
      gf::cp_async_16(patch + pix * kMmaLd + q * 8, src, in);
    }
    for (int e = threadIdx.x; e < 9 * kMmaChans * 4; e += kMmaThreads) {
      const int r = e / 4, q = e % 4;  // r = tap * 64 + co
      const bf16* src =
          w + (static_cast<long long>(r / kMmaChans) * Co + co0 + r % kMmaChans) * Ci + c0 + q * 8;
      gf::cp_async_16(wsm + r * kMmaLd + q * 8, src, true);
    }
    gf::cp_async_commit();
    gf::cp_async_wait_0();
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kMmaCinChunk / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int pix = (2 * warp + mt + dy) * kMmaPatch + lane % 16 + dx;
          gf::ldmatrix_x4(a[mt], patch + pix * kMmaLd + kk * 16 + (lane / 16) * 8);
        }
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {  // two channel tiles per ldmatrix
          uint32_t bw[4];
          const int co = nt * 8 + (lane / 16) * 8 + lane % 8;
          gf::ldmatrix_x4(bw, wsm + (tap * kMmaChans + co) * kMmaLd + kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            gf::mma_bf16(acc[mt][nt], a[mt], bw[0], bw[1]);
            gf::mma_bf16(acc[mt][nt + 1], a[mt], bw[2], bw[3]);
          }
        }
      }
    }
  }

  // bias (f32) and ReLU; fragment e holds pixel g + 8 * (e / 2), channel 2 * tq + e % 2
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float b0 = to_f32(bias[co0 + nt * 8 + 2 * tq]);
    const float b1 = to_f32(bias[co0 + nt * 8 + 2 * tq + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][nt][0] = fmaxf(acc[mt][nt][0] + b0, 0.f);
      acc[mt][nt][1] = fmaxf(acc[mt][nt][1] + b1, 0.f);
      acc[mt][nt][2] = fmaxf(acc[mt][nt][2] + b0, 0.f);
      acc[mt][nt][3] = fmaxf(acc[mt][nt][3] + b1, 0.f);
    }
  }
  const int y = y0 + 2 * warp;  // the warp's first pixel row
  if (kPool) {
    // rows y, y + 1 are the two m-tiles; pixels g, g ^ 1 are lanes 4 apart
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = fmaxf(acc[0][nt][e], acc[1][nt][e]);
        acc[0][nt][e] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      }
    const int Ho = H / 2, Wo = W / 2, oy = y / 2;
    if (g % 2 != 0 || oy >= Ho) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = (x0 + g + 8 * half) / 2;
      if (ox >= Wo) continue;
      bf16* o = out + ((static_cast<long long>(b) * Ho + oy) * Wo + ox) * Co + co0 + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<uint32_t*>(o + nt * 8) =
            gf::pack_bf16(acc[0][nt][2 * half], acc[0][nt][2 * half + 1]);
    }
  } else {
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
}

template <bool kPool>
cudaError_t launch_mma(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int H,
                       int W, int Ci, int Co, cudaStream_t stream) {
  const cudaError_t err =
      gf::allow_shared_memory<conv3x3_relu_mma_kernel<kPool>>(static_cast<int>(kMmaSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kPixCols - 1) / kPixCols, (H + kPixRows - 1) / kPixRows,
                  B * (Co / kMmaChans));
  conv3x3_relu_mma_kernel<kPool><<<grid, kMmaThreads, kMmaSmem, stream>>>(x, w, bias, out, H, W,
                                                                         Ci, Co);
  return cudaGetLastError();
}

template <typename T>
cudaError_t conv(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                 int Ci, int Co, bool pool, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (Ci % kMmaCinChunk == 0 && Co % kMmaChans == 0) {
      const bf16* xt = static_cast<const bf16*>(x);
      const bf16* wt = static_cast<const bf16*>(w);
      const bf16* bt = static_cast<const bf16*>(bias);
      bf16* ot = static_cast<bf16*>(out);
      return pool ? launch_mma<true>(xt, wt, bt, ot, B, H, W, Ci, Co, stream)
                  : launch_mma<false>(xt, wt, bt, ot, B, H, W, Ci, Co, stream);
    }
  }
  const dim3 grid((W + kPixCols - 1) / kPixCols, (H + kPixRows - 1) / kPixRows,
                  B * ((Co + kBlockChans - 1) / kBlockChans));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (pool) {
    conv3x3_relu_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, wt, bt, ot, H, W, Ci, Co);
  } else {
    conv3x3_relu_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, wt, bt, ot, H, W, Ci, Co);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t block(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
                  void* mid, void* out, int B, int H, int W, int Ci, int Cm, int Co, bool two,
                  bool pool, cudaStream_t stream) {
  if (!two) return conv<T>(x, wa, ba, out, B, H, W, Ci, Cm, pool, stream);
  const cudaError_t err = conv<T>(x, wa, ba, mid, B, H, W, Ci, Cm, false, stream);
  if (err != cudaSuccess) return err;
  return conv<T>(mid, wb, bb, out, B, H, W, Cm, Co, pool, stream);
}

}  // namespace

// x (B, H, W, Ci) NHWC contiguous; wa (3, 3, Cm, Ci), ba (Cm); wb (3, 3, Co,
// Cm), bb (Co) when two != 0 (else Co == Cm and wb, bb, mid are unused);
// mid (B, H, W, Cm) scratch; out (B, H/2, W/2, Co) when pool != 0, else
// (B, H, W, Co). All of x's dtype: 0 = f32, 1 = bf16. Ci and Cm are
// multiples of 8 (16 for Cm), Co of 16. Returns a cudaError_t (0 = launched).
extern "C" int gf_fused_vgg_block(const void* x, const void* wa, const void* ba, const void* wb,
                                  const void* bb, void* mid, void* out, int B, int H, int W,
                                  int Ci, int Cm, int Co, int two, int pool, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? block<bf16>(x, wa, ba, wb, bb, mid, out, B, H, W, Ci, Cm, Co, two != 0,
                                        pool != 0, s)
                 : block<float>(x, wa, ba, wb, bb, mid, out, B, H, W, Ci, Cm, Co, two != 0,
                                pool != 0, s);
  return static_cast<int>(err);
}
