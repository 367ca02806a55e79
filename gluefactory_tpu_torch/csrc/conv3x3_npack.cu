// npack_conv3x3: out = conv3x3(x, w), NHWC x, HWIO w, SAME zero padding,
// no bias, no ReLU; products summed in f32, the output rounded once to bf16,
// in the N-packed formulation of the Pallas prototype `npack_conv` /
// `kernel` of scripts_dev/profile_npack.py, which this replaces. Plain C
// interface, loaded with ctypes by gluefactory_tpu_torch/ops/cuda_conv3x3.py.
//
// Formulation: with wpack (3 C_in, 192) = [w[0] | w[1] | w[2]], each w[dy]
// read as (3 C_in, 64) (K = the dx taps folded with the input channels, N =
// the three dy taps of 64 output channels side by side), P = cat @ wpack over
// ROWS + 2 input rows, and out[i] = P[i, :, 0:64] + P[i+1, :, 64:128] +
// P[i+2, :, 128:192]. At ROWS = 4 that is (ROWS + 2) / ROWS = 1.5x the
// multiply-adds of the streaming kernel: the cost of the formulation, which
// is what the tool studies.
//
// Design: a block owns a 16-pixel column strip of one image and one group of
// 64 output channels, and walks down the strip ROWS = 4 output rows at a
// time (up to 16 such tiles), so the packed weights are loaded into shared
// memory once per block, not once per tile. For each tile, 12 warps compute
// P (96 pixels x 192) with mma.sync m16n8k16 (bf16 in, f32 accumulated in
// registers); a warp owns two patch rows (one m16 tile each) and 48 of the
// 192 columns. K = 3 C_in is folded from three dx-shifted ldmatrix reads of
// the same (ROWS + 2) x 18 pixel patch, so the cat copy the TPU needed does
// not exist. P goes to an f32 scratch in shared memory; after a barrier a
// second loop in the same block sums the row-shifted slices and stores bf16.
// The next tile's patch loads with cp.async while this one computes (two
// patch buffers). Shared memory at C_in = 64: 2 x 15,552 B of patch, 76,800
// B of packed weights, 76,800 B of scratch, 184,704 B of the 227 KiB a block
// may have, so one block per SM.
//
// Bound at the conv1b shape (8 x 1024^2 x 64 -> 64, bf16): the function's
// 2.15 GB of input and output at 3.35 TB/s, 0.641 ms. Its own work is 1.5x
// the function's 618 GFLOP plus the scratch round trip through shared
// memory, so it is bound by the tensor cores and the shared-memory traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_utils.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 4;                  // output rows per tile (the TPU kernel's ROWS)
constexpr int kPRows = kRows + 2;         // rows of P and of the patch
constexpr int kStrip = 16;                // output columns per block: one m16 tile per row
constexpr int kPatchCols = kStrip + 2;
constexpr int kChans = 64;                // output channels per block
constexpr int kN = 3 * kChans;            // 192: [dy0 | dy1 | dy2] x 64
constexpr int kTilesPerBlock = 16;        // tiles a block walks down its strip
constexpr int kThreads = 384;             // 12 warps: 3 row pairs x 4 column quarters
constexpr int kWarpCols = kN / 4;         // 48 columns of P per warp
constexpr int kWLd = kN + 8;              // bf16 per packed weight row (400 B)
constexpr int kPLd = kN + 8;              // f32 per scratch row (800 B)
constexpr int kScratchBytes = kPRows * kStrip * kPLd * 4;

__host__ __device__ constexpr int patch_ld(int ci) { return ci + 8; }  // bf16 per patch pixel
__host__ __device__ constexpr int patch_elems(int ci) { return kPRows * kPatchCols * patch_ld(ci); }

// bytes of dynamic shared memory (ops/cuda_conv3x3.py::npack_shared_bytes)
constexpr size_t smem_bytes(int ci) {
  return static_cast<size_t>(2 * patch_elems(ci) + 3 * ci * kWLd) * sizeof(bf16) + kScratchBytes;
}

// the patch of the tile whose first output row is y0: input rows y0 - 1 ..
// y0 + ROWS, columns x0 - 1 .. x0 + 16, zeros outside the image
__device__ __forceinline__ void load_patch(bf16* patch, const bf16* xb, int y0, int x0, int H,
                                           int W, int Ci) {
  const int chunks = Ci / 8;
  const int ld = patch_ld(Ci);
  for (int e = threadIdx.x; e < kPRows * kPatchCols * chunks; e += kThreads) {
    const int pix = e / chunks, q = e % chunks;
    const int y = y0 - 1 + pix / kPatchCols, xx = x0 - 1 + pix % kPatchCols;
    const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
    const bf16* src = xb + (in ? (static_cast<long long>(y) * W + xx) * Ci : 0) + q * 8;
    gf::cp_async_16(patch + pix * ld + q * 8, src, in);
  }
}

// x (B, H, W, Ci), w (3, 3, Ci, Co), out (B, H, W, Co); Ci % 64 == 0,
// Co % 64 == 0. Grid (ceil(W / 16), ceil(H / (4 * 16)), B * Co / 64).
__global__ void __launch_bounds__(kThreads, 1)
    npack_conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         bf16* __restrict__ out, int H, int W, int Ci, int Co) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pld = patch_ld(Ci);
  bf16* patches = reinterpret_cast<bf16*>(smem_raw);         // 2 x [6 * 18][Ci + 8]
  bf16* wsm = patches + 2 * patch_elems(Ci);                  // [3 Ci][kWLd], rows dx * Ci + ci
  float* scratch = reinterpret_cast<float*>(wsm + 3 * Ci * kWLd);  // [6 * 16][kPLd]

  const int cblocks = Co / kChans;
  const int b = blockIdx.z / cblocks;
  const int co0 = (blockIdx.z % cblocks) * kChans;
  const int x0 = blockIdx.x * kStrip;
  const int ybase = blockIdx.y * kRows * kTilesPerBlock;
  const int tiles = min(kTilesPerBlock, (H - ybase + kRows - 1) / kRows);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;   // mma fragment row group / column pair
  const int wm = warp / 4, wn = warp % 4;  // patch rows 2 wm, 2 wm + 1; columns wn * 48 ..
  const bf16* xb = x + static_cast<long long>(b) * H * W * Ci;

  // the packed weights: row dx * Ci + ci, column dy * 64 + co <- w[dy][dx][ci][co0 + co]
  for (int e = threadIdx.x; e < 3 * Ci * (kN / 8); e += kThreads) {
    const int r = e / (kN / 8), q = e % (kN / 8);
    const int dx = r / Ci, ci = r % Ci, dy = q / (kChans / 8), co = (q % (kChans / 8)) * 8;
    const bf16* src = w + (static_cast<long long>(dy * 3 + dx) * Ci + ci) * Co + co0 + co;
    gf::cp_async_16(wsm + r * kWLd + q * 8, src, true);
  }
  load_patch(patches, xb, ybase, x0, H, W, Ci);
  gf::cp_async_commit();

  for (int t = 0; t < tiles; ++t) {
    const int y0 = ybase + t * kRows;
    if (t + 1 < tiles) {  // prefetch the next tile's patch into the other buffer
      load_patch(patches + ((t + 1) % 2) * patch_elems(Ci), xb, y0 + kRows, x0, H, W, Ci);
      gf::cp_async_commit();
      gf::cp_async_wait_1();
    } else {
      gf::cp_async_wait_0();
    }
    __syncthreads();  // this tile's patch (and the weights) are in; the last sum pass is done
    const bf16* patch = patches + (t % 2) * patch_elems(Ci);

    // P = cat @ wpack for patch rows 2 wm, 2 wm + 1 and columns wn * 48 ..
    float acc[2][6][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll 4
      for (int c = 0; c < Ci; c += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int pix = (2 * wm + mt) * kPatchCols + lane % 16 + dx;
          gf::ldmatrix_x4(a[mt], patch + pix * pld + c + (lane / 16) * 8);
        }
        const int k = dx * Ci + c + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
        for (int nt = 0; nt < 6; nt += 2) {  // two column tiles per ldmatrix
          uint32_t bw[4];
          gf::ldmatrix_x4_trans(bw, wsm + k * kWLd + wn * kWarpCols + nt * 8 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            gf::mma_bf16(acc[mt][nt], a[mt], bw[0], bw[1]);
            gf::mma_bf16(acc[mt][nt + 1], a[mt], bw[2], bw[3]);
          }
        }
      }
    }
    // fragment e holds pixel g + 8 * (e / 2), column 2 * tq + e % 2 of its tile
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        float* p = scratch + ((2 * wm + mt) * kStrip + g) * kPLd + wn * kWarpCols + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(p + 8 * kPLd) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncthreads();  // P is complete; the patch buffer of this tile is free

    // out[i] = P[i, 0:64] + P[i + 1, 64:128] + P[i + 2, 128:192], two channels a thread
    for (int e = threadIdx.x; e < kRows * kStrip * (kChans / 2); e += kThreads) {
      const int c2 = e % (kChans / 2), px = (e / (kChans / 2)) % kStrip, i = e / (kStrip * kChans / 2);
      const int y = y0 + i, xx = x0 + px;
      if (y >= H || xx >= W) continue;
      const float* p = scratch + (i * kStrip + px) * kPLd + 2 * c2;
      const float2 p0 = *reinterpret_cast<const float2*>(p);
      const float2 p1 = *reinterpret_cast<const float2*>(p + kStrip * kPLd + kChans);
      const float2 p2 = *reinterpret_cast<const float2*>(p + 2 * kStrip * kPLd + 2 * kChans);
      bf16* o = out + ((static_cast<long long>(b) * H + y) * W + xx) * Co + co0 + 2 * c2;
      *reinterpret_cast<uint32_t*>(o) = gf::pack_bf16(p0.x + p1.x + p2.x, p0.y + p1.y + p2.y);
    }
  }
}

}  // namespace

// x (B, H, W, Ci) NHWC bf16, w (3, 3, Ci, Co) HWIO bf16, out (B, H, W, Co)
// bf16, all contiguous and 16-byte aligned; Ci % 64 == 0 with the shared
// memory of smem_bytes(Ci) within the card's limit, Co % 64 == 0. Returns a
// cudaError_t (0 = launched).
extern "C" int gf_npack_conv3x3(const void* x, const void* w, void* out, int B, int H, int W,
                                int Ci, int Co, void* stream) {
  if (Ci % kChans != 0 || Co % kChans != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      gf::allow_shared_memory<npack_conv3x3_kernel>(static_cast<int>(smem_bytes(Ci)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kStrip - 1) / kStrip, (H + kRows * kTilesPerBlock - 1) / (kRows * kTilesPerBlock),
                  B * (Co / kChans));
  npack_conv3x3_kernel<<<grid, kThreads, smem_bytes(Ci), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), H, W, Ci,
      Co);
  return static_cast<int>(cudaGetLastError());
}
