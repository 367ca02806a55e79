// npack_conv3x3: out = conv3x3(x, w), NHWC x, HWIO w, SAME zero padding,
// no bias, no ReLU; products summed in f32, the output rounded once to bf16,
// in the N-packed formulation of the Pallas prototype `npack_conv` /
// `kernel` of scripts_dev/profile_npack.py, which this replaces. Plain C
// interface, loaded with ctypes by gluefactory_tpu_torch/ops/cuda_conv3x3.py.
//
// Formulation: with wpack (3 C_in, 192) = [w[0] | w[1] | w[2]], each w[dy]
// read as (3 C_in, 64) (K = the dx taps folded with the input channels, N =
// the three dy taps of 64 output channels side by side), P = cat @ wpack
// over the strip's rows plus two, and out[i] = P[i, 0:64] + P[i+1, 64:128] +
// P[i+2, 128:192]. Its work is (S + 2) / S of the function's multiply-adds
// for a strip of S rows: 1.03x at S = 64 (the TPU kernel's 4-row tiles
// did 1.5x).
//
// Design (the skeleton, producer, stages and epilogue: conv3x3_tile.cuh):
// for each input row r of its strip, a consumer warpgroup computes P[r] (64
// pixels x 192) with 3 x C_in / 16 wgmma m64n192k16: A is a dx-shifted
// window of the row's box as TMA wrote it, B the resident packed weights
// read MN-major from the three dy boxes. The row-shifted sum needs no
// scratch: in the wgmma accumulator layout, columns c, c + 64 and c + 128 of
// a pixel lie in the same thread, so after P[r]
//   out[r - 1] = part1 + P[r][128:192],
//   part1      = part0 + P[r][64:128],
//   part0      = P[r][0:64],
// and out[r - 1] is stored while P[r + 1]'s products run. That is 96 + 64
// f32 registers a thread, and 32 for the output row: 192 of the consumers'
// 232, no spills. The first product of a row writes P without reading it,
// so the old P is dead there: with a run-time accumulate flag instead,
// ptxas kept it alive and spilled. Storing under the products was 8%
// faster than storing after them (0.810-0.811 ms against 0.882-0.884,
// both timed in one call by scripts_dev/profile_npack.py on an H100 80GB
// HBM3 at 700 W).
//
// Bound at the conv1b shape (8 x 1024^2 x 64 -> 64): bytes 0.641 ms,
// operations 0.625 ms (0.644 ms of the kernel's own work at S = 64: 1,054
// input rows per 1,024 output rows). Per wgmma m64n192k16 (96 clocks of the
// SM's tensor cores at their peak) it reads 2 KB of A and 6 KB of B from
// shared memory: 85 B a clock of the 128 that shared memory delivers, so
// the tensor cores, not shared memory, are its limit.

#include "conv3x3_npack.cuh"

// x (B, H, W, Ci) NHWC bf16, w (3, 3, Ci, Co) HWIO bf16, out (B, H, W, Co)
// bf16, all contiguous and 16-byte aligned; Ci and Co positive multiples of
// 64. Returns a cudaError_t (0 = launched).
extern "C" int gf_npack_conv3x3(const void* x, const void* w, void* out, int B, int H, int W,
                                int Ci, int Co, void* stream) {
  return static_cast<int>(gf::conv::launch<gf::conv::NpackBody>(
      x, w, out, B, H, W, Ci, Co, static_cast<cudaStream_t>(stream)));
}
