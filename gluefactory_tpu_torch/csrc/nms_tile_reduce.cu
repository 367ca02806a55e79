// fused_nms_tile_reduce: SuperPoint's keypoint decode up to the top-k, in
// one pass: iterated NMS, border removal, the true-image-area mask, and the
// max and argmax of every tile x tile tile (replaces `fused_nms_tile_reduce`
// / `_detect_kernel` of gluefactory_tpu/ops/pallas_detect.py). Plain C
// interface, loaded with ctypes by gluefactory_tpu_torch/ops/cuda_detect.py.
//
// A block owns an output region of 32 x 64 pixels and loads it with a halo
// of (2 * iters + 1) * radius rows and columns into shared memory, as f32,
// with -inf outside the image: iterated NMS depends on nothing farther
// away (one max-pool of radius r for the first mask, two per iteration).
// Every max-pool runs over the whole haloed region with its window clipped
// to the region; wrong values near the region's edge move inward by r per
// pool and never reach the centre. A max-pool is separable (rows, then
// columns), and each thread slides its window over a run of 8 outputs held
// in registers, so a pass reads 8 + 2r values per 8 outputs instead of
// 8 (2r + 1). The radius is a template parameter, compiled for 0-6: the
// haloed region takes 17 bytes of shared memory per pixel, and at the
// default 2 iterations radius 7 would need 234 KB, over the 227 KiB a block
// may have on the H100. The region's row stride is odd, so threads on
// neighbouring rows hit different banks. The TPU kernel's cyclic shifts and
// 128-lane column halo are its layout and have no counterpart here.
//
// Semantics (`ops/nms.py` simple_nms with -inf outside the image):
// -inf entries are re-imposed after each suppression, as on the TPU
// (`pallas_detect.py:96-112`); then border and area masks zero the rest.
// Tie rule of the TPU kernel: within a tile, the smallest dx among maximal
// columns, then the smallest dy in that column (a column-major scan with a
// strict >). All comparisons are exact, so the kernel and its plain version
// agree bit for bit.
//
// Bound at the main path's shape (8 x 1024 x 1024 bf16 in, 8 x 256 x 256 f32
// and i32 out): 16.8 MB in, 4.2 MB out, about 6 us of device memory time.
// This design makes 10 max-pool passes (5 pools) and a few elementwise
// passes over the haloed region in shared memory, with a 3-4x halo
// overhead at radius 3-4: bound by shared-memory traffic and the block's
// barriers, far from the byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_utils.cuh"

namespace {

using gf::to_f32;

constexpr int kRegionRows = 32;  // output pixels per block
constexpr int kRegionCols = 64;
constexpr int kThreads = 512;
constexpr int kRun = 8;           // outputs per thread in a max-pool pass
constexpr int kFloatBuffers = 4;  // S, T, P, MM
constexpr size_t kMaxSharedBytes = 232448;  // opt-in shared memory per block on sm_90

// Region geometry: RH x RW pixels stored with row stride LD (odd)
struct Region {
  int RH, RW, LD;
};

// every (y, x) of the region, spread over the block's threads
#define FOR_REGION(g, ROW, COL)                                           \
  for (int i_ = threadIdx.x; i_ < (g).RH * (g).RW; i_ += kThreads)        \
    if (const int ROW = i_ / (g).RW, COL = i_ % (g).RW; true)

// dst = max over the (2R+1)^2 window of load(e), clipped to the region:
// rows into tmp, then columns. A thread slides over kRun outputs: along a
// row for the row pass (threads on consecutive rows), down a column for the
// column pass (threads on consecutive columns).
template <int R, typename Load>
__device__ void max_pool(const Region g, Load load, float* dst, float* tmp) {
  const int runs_x = (g.RW + kRun - 1) / kRun;
  for (int i = threadIdx.x; i < g.RH * runs_x; i += kThreads) {
    const int y = i % g.RH, x0 = (i / g.RH) * kRun;
    float v[kRun + 2 * R];
#pragma unroll
    for (int k = 0; k < kRun + 2 * R; ++k) {
      const int x = x0 - R + k;
      v[k] = (x >= 0 && x < g.RW) ? load(y * g.LD + x) : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      float m = v[k];
#pragma unroll
      for (int d = 1; d <= 2 * R; ++d) m = fmaxf(m, v[k + d]);
      if (x0 + k < g.RW) tmp[y * g.LD + x0 + k] = m;
    }
  }
  __syncthreads();
  const int runs_y = (g.RH + kRun - 1) / kRun;
  for (int i = threadIdx.x; i < g.RW * runs_y; i += kThreads) {
    const int x = i % g.RW, y0 = (i / g.RW) * kRun;
    float v[kRun + 2 * R];
#pragma unroll
    for (int k = 0; k < kRun + 2 * R; ++k) {
      const int y = y0 - R + k;
      v[k] = (y >= 0 && y < g.RH) ? tmp[y * g.LD + x] : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      float m = v[k];
#pragma unroll
      for (int d = 1; d <= 2 * R; ++d) m = fmaxf(m, v[k + d]);
      if (y0 + k < g.RH) dst[(y0 + k) * g.LD + x] = m;
    }
  }
  __syncthreads();
}

template <int R, typename T>
__global__ void __launch_bounds__(kThreads)
    nms_tile_kernel(const T* __restrict__ scores, const float* __restrict__ true_size,
                    float* __restrict__ tile_max, int* __restrict__ tile_arg, int H, int W,
                    int iters, int border, int tile, Region g) {
  extern __shared__ float smem[];
  const int n = g.RH * g.LD;
  float* S = smem;      // scores, -inf outside the image
  float* Tb = S + n;    // row-pass scratch of max_pool
  float* P = Tb + n;    // pooled
  float* MM = P + n;    // max mask, 0 / 1
  uint8_t* SU = reinterpret_cast<uint8_t*>(MM + n);  // suppression mask
  const int halo = (g.RH - kRegionRows) / 2;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kRegionRows - halo, x0 = blockIdx.x * kRegionCols - halo;
  const T* s = scores + static_cast<long long>(b) * H * W;
  FOR_REGION(g, ry, rx) {
    const int y = y0 + ry, x = x0 + rx;
    S[ry * g.LD + rx] = (y >= 0 && y < H && x >= 0 && x < W)
                            ? to_f32(s[static_cast<long long>(y) * W + x])
                            : -INFINITY;
  }
  __syncthreads();
  const auto scores_at = [&](int e) { return S[e]; };
  const auto mask_at = [&](int e) { return MM[e]; };
  // ss = supp ? 0 : s, with -inf (outside the image) kept
  const auto suppressed_at = [&](int e) { return (SU[e] && S[e] != -INFINITY) ? 0.f : S[e]; };

  // max_mask = scores == max_pool(scores)
  max_pool<R>(g, scores_at, P, Tb);
  FOR_REGION(g, y, x) MM[y * g.LD + x] = S[y * g.LD + x] == P[y * g.LD + x] ? 1.f : 0.f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    // supp = max_pool(max_mask) > 0
    max_pool<R>(g, mask_at, P, Tb);
    FOR_REGION(g, y, x) SU[y * g.LD + x] = P[y * g.LD + x] > 0.f;
    __syncthreads();
    // max_mask |= (ss == max_pool(ss)) & ~supp
    max_pool<R>(g, suppressed_at, P, Tb);
    FOR_REGION(g, y, x) {
      const int e = y * g.LD + x;
      if (suppressed_at(e) == P[e] && !SU[e]) MM[e] = 1.f;
    }
    __syncthreads();
  }

  // tile max / argmax over the centre, one thread per tile
  const float w_true = true_size[2 * b], h_true = true_size[2 * b + 1];
  const float bf = static_cast<float>(border);
  const int tiles_x = kRegionCols / tile, tiles_y = kRegionRows / tile;
  const int Ht = H / tile, Wt = W / tile;
  for (int t = threadIdx.x; t < tiles_x * tiles_y; t += kThreads) {
    const int gty = blockIdx.y * tiles_y + t / tiles_x;
    const int gtx = blockIdx.x * tiles_x + t % tiles_x;
    if (gty >= Ht || gtx >= Wt) continue;
    float best = 0.f;
    int arg = 0;
    for (int dx = 0; dx < tile; ++dx) {
      for (int dy = 0; dy < tile; ++dy) {
        const int y = gty * tile + dy, x = gtx * tile + dx;
        const int e = (y - y0) * g.LD + (x - x0);
        float val = MM[e] != 0.f ? S[e] : 0.f;
        const bool keep = y >= border && x >= border && y < H - border && x < W - border &&
                          static_cast<float>(x) < w_true - bf &&
                          static_cast<float>(y) < h_true - bf;
        if (!keep) val = 0.f;
        if ((dx == 0 && dy == 0) || val > best) {
          best = val;
          arg = dy * tile + dx;
        }
      }
    }
    const long long o = (static_cast<long long>(b) * Ht + gty) * Wt + gtx;
    tile_max[o] = best;
    tile_arg[o] = arg;
  }
}

template <int R, typename T>
cudaError_t launch_radius(const void* scores, const float* true_size, float* tile_max,
                          int* tile_arg, int B, int H, int W, int iters, int border, int tile,
                          cudaStream_t stream) {
  const int halo = (2 * iters + 1) * R;
  Region g;
  g.RH = kRegionRows + 2 * halo;
  g.RW = kRegionCols + 2 * halo;
  g.LD = g.RW | 1;
  const size_t smem = static_cast<size_t>(g.RH) * g.LD * (kFloatBuffers * sizeof(float) + 1);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const cudaError_t err = gf::allow_shared_memory<nms_tile_kernel<R, T>>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kRegionCols - 1) / kRegionCols, (H + kRegionRows - 1) / kRegionRows, B);
  nms_tile_kernel<R, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(scores), true_size, tile_max, tile_arg, H, W, iters, border, tile, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* scores, const float* true_size, float* tile_max, int* tile_arg,
                   int B, int H, int W, int radius, int iters, int border, int tile,
                   cudaStream_t stream) {
  switch (radius) {
#define GF_RADIUS(R) \
  case R:            \
    return launch_radius<R, T>(scores, true_size, tile_max, tile_arg, B, H, W, iters, border, tile, stream);
    GF_RADIUS(0)
    GF_RADIUS(1)
    GF_RADIUS(2)
    GF_RADIUS(3)
    GF_RADIUS(4)
    GF_RADIUS(5)
    GF_RADIUS(6)
#undef GF_RADIUS
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// scores (B, H, W) contiguous, dtype 0 = f32, 1 = bf16; true_size (B, 2) f32
// [w, h]; tile_max (B, H/tile, W/tile) f32 and tile_arg i32 (dy * tile + dx).
// H and W are multiples of tile, tile divides 32, radius is 0-6. Returns a
// cudaError_t (0 = launched; cudaErrorInvalidValue for a radius above 6 or a
// haloed region that does not fit in shared memory; the Python wrapper
// checks both first).
extern "C" int gf_fused_nms_tile_reduce(const void* scores, const void* true_size,
                                        void* tile_max, void* tile_arg, int B, int H, int W,
                                        int radius, int iters, int border, int tile, int dtype,
                                        void* stream) {
  const float* ts = static_cast<const float*>(true_size);
  float* tm = static_cast<float*>(tile_max);
  int* ta = static_cast<int*>(tile_arg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(scores, ts, tm, ta, B, H, W, radius, iters, border, tile, s)
                 : launch<float>(scores, ts, tm, ta, B, H, W, radius, iters, border, tile, s);
  return static_cast<int>(err);
}
