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
//   - bf16 with C_in and C_out multiples of 64 (all four of SuperPoint's
//     blocks): the N-packed wgmma body of the conv-study kernel
//     (conv3x3_npack.cuh on the skeleton of conv3x3_tile.cuh: persistent
//     blocks, TMA loads whose zero fill is the SAME padding, the block's
//     weights resident, two producer warps feeding two consumer
//     warpgroups, the row-shifted sum in registers), with bias and ReLU in
//     f32 in its epilogue before the rounding to bf16 and, for the pooled
//     conv, the 2x2/2 max-pool there too (Epilogue::kBiasReluPool: the
//     even row waits as bf16 in the staging tile, the odd row maxes into
//     it, one TMA store of 32 pooled pixels). The strip height is chosen
//     per shape by the caller (ops/cuda_conv.py::strip_rows), so that a
//     small image still gives every SM its units.
//   - f32, and every other bf16 shape, `conv3x3_relu_kernel`: a direct
//     convolution on the CUDA cores; a block computes 16 x 16 pixels x 64
//     channels, each thread 2 x 2 pixels x 16 channels (64 f32 sums, so the
//     pool stays in its registers); input channels stream through shared
//     memory 8 at a time as f32.
// The two-conv variant runs the conv twice from the C entry point: conv_a
// writes its ReLU'd activation, rounded to x's dtype, to a scratch image in
// device memory, which conv_b reads with its own zero padding, so the SAME
// padding of conv_b is zeros by construction. The TPU kernel keeps that
// activation in VMEM (with halo rows recomputed).
//
// Bound at the main path's shapes (8 images, bf16): 618 GFLOP for conv1b +
// pool at 1024^2 x 64, 309 / 232 / 77 GFLOP for blocks 2-4: bound by
// operations (0.63 / 0.31 / 0.23 / 0.08 ms at 989 TFLOP/s on the bf16
// tensor cores). The N-packed body does (S + 2) / S of that work for a strip
// of S rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv3x3_npack.cuh"
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
// x (B, H, W, Ci), w (3, 3, Ci, Co) HWIO, bias (Co), out (B, H', W', Co).
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
          co0 + co < Co ? to_f32(w[(static_cast<long long>(tap) * Ci + c0 + c) * Co + co0 + co]) : 0.f;
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

template <typename T>
cudaError_t conv_cuda_cores(const void* x, const void* w, const void* bias, void* out, int B,
                            int H, int W, int Ci, int Co, bool pool, cudaStream_t stream) {
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

// one conv of the block: the wgmma body for bf16 at multiples of 64, the
// CUDA-core body otherwise
template <typename T>
cudaError_t conv(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                 int Ci, int Co, bool pool, int strip, cudaStream_t stream) {
  using gf::conv::Epilogue;
  using gf::conv::NpackBody;
  if constexpr (std::is_same_v<T, bf16>) {
    if (Ci % gf::conv::kChans == 0 && Co % gf::conv::kChans == 0) {
      return pool ? gf::conv::launch<NpackBody, Epilogue::kBiasReluPool>(x, w, out, B, H, W, Ci,
                                                                         Co, stream, strip, bias)
                  : gf::conv::launch<NpackBody, Epilogue::kBiasRelu>(x, w, out, B, H, W, Ci, Co,
                                                                     stream, strip, bias);
    }
  }
  return conv_cuda_cores<T>(x, w, bias, out, B, H, W, Ci, Co, pool, stream);
}

template <typename T>
cudaError_t block(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
                  void* mid, void* out, int B, int H, int W, int Ci, int Cm, int Co, bool two,
                  bool pool, int strip_a, int strip_b, cudaStream_t stream) {
  if (!two) return conv<T>(x, wa, ba, out, B, H, W, Ci, Cm, pool, strip_a, stream);
  const cudaError_t err = conv<T>(x, wa, ba, mid, B, H, W, Ci, Cm, false, strip_a, stream);
  if (err != cudaSuccess) return err;
  return conv<T>(mid, wb, bb, out, B, H, W, Cm, Co, pool, strip_b, stream);
}

}  // namespace

// x (B, H, W, Ci) NHWC contiguous; wa (3, 3, Ci, Cm) HWIO, ba (Cm); wb (3,
// 3, Cm, Co), bb (Co) when two != 0 (else Co == Cm and wb, bb, mid are
// unused); mid (B, H, W, Cm) scratch; out (B, H/2, W/2, Co) when pool != 0,
// else (B, H, W, Co). All of x's dtype (0 = f32, 1 = bf16); x, weights, mid
// and out 16-byte aligned. Ci and Cm are multiples of 8 (16 for Cm),
// Co of 16. strip_a, strip_b: output rows per unit of the wgmma body for
// conv_a and conv_b (even where that conv pools). Returns a cudaError_t (0 =
// launched).
extern "C" int gf_fused_vgg_block(const void* x, const void* wa, const void* ba, const void* wb,
                                  const void* bb, void* mid, void* out, int B, int H, int W,
                                  int Ci, int Cm, int Co, int two, int pool, int dtype,
                                  int strip_a, int strip_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? block<bf16>(x, wa, ba, wb, bb, mid, out, B, H, W, Ci, Cm, Co, two != 0,
                               pool != 0, strip_a, strip_b, s)
                 : block<float>(x, wa, ba, wb, bb, mid, out, B, H, W, Ci, Cm, Co, two != 0,
                                pool != 0, strip_a, strip_b, s);
  return static_cast<int>(err);
}
