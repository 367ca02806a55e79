// fused_nms_tile_reduce: SuperPoint's keypoint decode up to the top-k, in
// one pass: iterated NMS, border removal, the true-image-area mask, and the
// max and argmax of every tile x tile tile (replaces `fused_nms_tile_reduce`
// / `_detect_kernel` of gluefactory_tpu/ops/pallas_detect.py). Plain C
// interface, loaded with ctypes by gluefactory_tpu_torch/ops/cuda_detect.py.
//
// A block owns an output region of 64 x 64 pixels and loads it with a halo
// of 5r rows and columns into shared memory as f32, with -inf outside the
// image: iterated NMS at up to 2 iterations depends on nothing farther away
// (one max-pool of radius r for the first mask, two per iteration). Every
// pool runs over the whole haloed region with its window clipped to the
// region; wrong values near the region's edge move inward by r per pool and
// never reach the centre. The radius is a template parameter, compiled for
// 0-8; the region's geometry follows from it at compile time.
//
// Hopper design (the footprint sets the occupancy, shared-memory traffic and
// barriers the time):
// - Masks as bits. The max mask MM and the suppression mask SU hold one
//   uint32 per 32 columns of a row. Dilating MM by r (the mask pool) ORs the
//   word with its funnel shifts by 1..r across the neighbouring words, over
//   2r + 1 rows, a word at a time: two of the five pools leave the float path.
// - The compare folded into the pool. A float pool is a row pass into the
//   scratch T (a thread a run of kRun outputs along a row), then a column
//   pass whose lanes sit on 32 consecutive columns of one row: `s ==
//   pool(s)`, or `!supp && ss == pool(ss)`, is one __ballot_sync a word,
//   written straight into MM. The suppressed map ss = supp ? 0 : s (-inf
//   kept) is read on the fly from S and SU. No pooled buffer, no
//   elementwise passes: 9 barriers a block at 2 iterations.
// - 8.3 bytes a pixel: S and T in f32, two bit planes. At r <= 5 a block of
//   the 104 x 104 region (r = 4) takes 91.5 KB, so two blocks (32 warps) fit
//   on an SM; the halo costs 2.64x the outputs at r = 4.
// - Window maxima by van Herk / Gil-Werman: segments of 2r + 1 inputs, a
//   prefix and a suffix max, about three fmaxf an output at any radius.
// - The load: 16-byte vectors, a warp on 64 (bf16) or 128 (f32) contiguous
//   bytes of each of 8 or 4 rows, every load of a thread issued before its
//   first store to shared memory; a scalar load where the rows are not
//   16-byte aligned.
// - The tile reduction: a warp a row of tiles over 32 columns, a lane a
//   column (conflict-free reads of S), a shuffle reduction across the tile's
//   lanes.
//
// Semantics (`ops/nms.py` simple_nms with -inf outside the image): -inf
// entries are re-imposed after each suppression, as on the TPU
// (`pallas_detect.py:96-112`); then border and area masks zero the rest.
// Tie rule of the TPU kernel: within a tile, the smallest dx among maximal
// columns, then the smallest dy in that column (a column-major scan with a
// strict >). All comparisons are exact, so the kernel and its plain version
// agree bit for bit.
//
// Bound at the main path's shape (8 x 1024 x 1024 bf16 in, 8 x 256 x 256 f32
// and i32 out): 16.8 MB in, 4.2 MB out, about 6 us of device memory time;
// the f32 max and compare operations of the five pools, about 25 a pixel,
// take about 10 us at the CUDA-core compare rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_utils.cuh"

namespace {

constexpr int kOutRows = 64;  // output pixels per block
constexpr int kOutCols = 64;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;        // outputs per thread (row pass) or lane (column pass)
constexpr int kMaxIters = 2;   // the halo covers up to 2 iterations
constexpr int kMaxRadius = 8;
constexpr int kLoadBatch = 8;  // 16-byte loads a thread holds before storing
constexpr int kSharedPerSm = 233472;  // shared memory of an SM (228 KiB)
constexpr int kReservedPerBlock = 1024;

template <int R>
struct Geometry {
  static constexpr int kHalo = (2 * kMaxIters + 1) * R;
  static constexpr int RH = kOutRows + 2 * kHalo;  // region rows
  static constexpr int RW = kOutCols + 2 * kHalo;  // region columns
  static constexpr int LD = RW | 1;                // f32 row stride, odd: no bank conflicts
  static constexpr int NW = (RW + 31) / 32;        // mask words a row
  static constexpr int NWP = NW | 1;               // mask row stride, odd
  static constexpr int kSharedBytes = (2 * RH * LD + 2 * RH * NWP) * 4;
  static constexpr int kMinBlocks =
      2 * (kSharedBytes + kReservedPerBlock) <= kSharedPerSm ? 2 : 1;
};

// out[k] = max(v[k .. k + 2R]) for k < K: van Herk / Gil-Werman, segments of
// 2R + 1 inputs ending at indices = 2R (mod 2R + 1). Fully unrolled on
// registers; what no output needs is dead code.
template <int R, int K>
__device__ __forceinline__ void window_max(const float (&v)[K + 2 * R], float (&out)[K]) {
  constexpr int W = 2 * R + 1, N = K + 2 * R;
  float pre[N], suf[N];
  pre[0] = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) pre[j] = (j % W == W - 1) ? v[j] : fmaxf(pre[j - 1], v[j]);
  suf[N - 1] = v[N - 1];
#pragma unroll
  for (int j = N - 2; j >= 0; --j) suf[j] = ((j + 1) % W == W - 1) ? v[j] : fmaxf(suf[j + 1], v[j]);
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = (k % W == W - 1) ? pre[k + W - 1] : fmaxf(suf[k], pre[k + W - 1]);
}

// row of mask words dilated by R columns: bit i of word w is set if any bit
// within R columns of column 32 w + i is
template <int R>
__device__ __forceinline__ uint32_t dilate_row(uint32_t prev, uint32_t cur, uint32_t next) {
  uint32_t out = cur;
#pragma unroll
  for (int d = 1; d <= R; ++d) out |= __funnelshift_r(cur, next, d) | __funnelshift_l(prev, cur, d);
  return out;
}

struct Planes {
  float* S;     // scores, -inf outside the image
  float* T;     // row-pass scratch
  uint32_t* MM;  // max mask
  uint32_t* SU;  // suppression mask
};

// SU = MM dilated by R in both directions, clipped to the region
template <int R>
__device__ void dilate(const Planes p) {
  using G = Geometry<R>;
  for (int i = threadIdx.x; i < G::RH * G::NW; i += kThreads) {
    const int y = i / G::NW, w = i % G::NW;
    uint32_t acc = 0;
#pragma unroll
    for (int dy = -R; dy <= R; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= G::RH) continue;
      const uint32_t* row = p.MM + yy * G::NWP;
      acc |= dilate_row<R>(w > 0 ? row[w - 1] : 0u, row[w], w + 1 < G::NW ? row[w + 1] : 0u);
    }
    p.SU[y * G::NWP + w] = acc;
  }
}

// row pass of a float pool: T = max over columns x - R .. x + R of the
// source (S, or ss = supp ? 0 : S with -inf kept), clipped to the region.
// Threads on consecutive rows (odd stride: no bank conflicts).
template <int R, bool kSuppressed>
__device__ void pool_rows(const Planes p) {
  using G = Geometry<R>;
  constexpr int N = kRun + 2 * R, kRuns = (G::RW + kRun - 1) / kRun;
  for (int i = threadIdx.x; i < G::RH * kRuns; i += kThreads) {
    const int y = i % G::RH, x0 = (i / G::RH) * kRun;
    const float* s = p.S + y * G::LD;
    uint64_t bits = 0;  // bit off + j: SU of column x0 - R + j
    int off = 0;
    if (kSuppressed) {
      const int base = x0 - R + 32;  // >= 0: R <= 32
      const int w = (base >> 5) - 1;
      off = base & 31;
      const uint32_t* su = p.SU + y * G::NWP;
      const uint32_t lo = w >= 0 ? su[w] : 0u;
      const uint32_t hi = w + 1 < G::NW ? su[w + 1] : 0u;
      bits = (static_cast<uint64_t>(hi) << 32) | lo;
    }
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int x = x0 - R + j;
      float e = -INFINITY;
      if (x >= 0 && x < G::RW) {
        e = s[x];
        if (kSuppressed && ((bits >> (off + j)) & 1u) && e != -INFINITY) e = 0.f;
      }
      v[j] = e;
    }
    float m[kRun];
    window_max<R, kRun>(v, m);
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (x0 + k < G::RW) p.T[y * G::LD + x0 + k] = m[k];
  }
}

// column pass of a float pool with the compare folded in: a warp on the 32
// columns of mask word w and a run of kRun rows, a lane a column.
// First pool: MM = (S == pool(S)). Suppressed pool: MM |= !SU && (S ==
// pool(ss)) (where SU is clear, ss is S).
template <int R, bool kSuppressed>
__device__ void pool_columns_compare(const Planes p) {
  using G = Geometry<R>;
  constexpr int N = kRun + 2 * R, kRuns = (G::RH + kRun - 1) / kRun;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < G::NW * kRuns; t += kWarps) {
    const int w = t % G::NW, y0 = (t / G::NW) * kRun;
    const int x = 32 * w + lane;
    const bool active = x < G::RW;
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int y = y0 - R + j;
      v[j] = (active && y >= 0 && y < G::RH) ? p.T[y * G::LD + x] : -INFINITY;
    }
    float m[kRun];
    window_max<R, kRun>(v, m);
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int y = y0 + k;
      if (y >= G::RH) break;  // warp-uniform
      bool pred = active && p.S[y * G::LD + x] == m[k];
      if (kSuppressed) pred = pred && !((p.SU[y * G::NWP + w] >> lane) & 1u);
      const uint32_t word = __ballot_sync(0xffffffffu, pred);
      if (lane == 0) {
        if (kSuppressed)
          p.MM[y * G::NWP + w] |= word;
        else
          p.MM[y * G::NWP + w] = word;
      }
    }
  }
}

__device__ __forceinline__ float element(const uint4& q, int e, float) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
  return __uint_as_float(u[e]);
}
__device__ __forceinline__ float element(const uint4& q, int e, __nv_bfloat16) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
  const uint32_t h = (e & 1) ? (u[e >> 1] >> 16) : (u[e >> 1] & 0xffffu);
  return __uint_as_float(h << 16);
}

// S = the region's scores as f32, -inf outside the image
template <int R, typename T>
__device__ void load_region(const T* __restrict__ s, float* S, int H, int W, int ry0, int rx0) {
  using G = Geometry<R>;
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (W % VEC == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    // a warp: kGroup consecutive vectors of each of 32 / kGroup rows
    constexpr int kGroup = sizeof(T) == 4 ? 8 : 4;
    constexpr int kRows = 32 / kGroup;
    constexpr int NV = (G::RW + VEC - 1) / VEC + 1;  // vectors a row, with the alignment offset
    constexpr int kGroups = (NV + kGroup - 1) / kGroup;
    constexpr int kBands = (G::RH + kRows - 1) / kRows;
    constexpr int kTasks = (kBands * kGroups + kWarps - 1) / kWarps;
    const int off = ((rx0 % VEC) + VEC) % VEC;
    const int xa = rx0 - off;
#pragma unroll
    for (int b0 = 0; b0 < kTasks; b0 += kLoadBatch) {
      uint4 q[kLoadBatch];
      bool in_image[kLoadBatch];
#pragma unroll
      for (int i = 0; i < kLoadBatch && b0 + i < kTasks; ++i) {
        const int t = warp + (b0 + i) * kWarps;
        const int row = (t / kGroups) * kRows + lane / kGroup;
        const int vi = (t % kGroups) * kGroup + lane % kGroup;
        const int gy = ry0 + row, gx = xa + vi * VEC;
        in_image[i] = t < kBands * kGroups && row < G::RH && vi < NV && gy >= 0 && gy < H &&
                      gx >= 0 && gx < W;
        if (in_image[i])
          q[i] = __ldg(reinterpret_cast<const uint4*>(s + static_cast<long long>(gy) * W + gx));
      }
#pragma unroll
      for (int i = 0; i < kLoadBatch && b0 + i < kTasks; ++i) {
        const int t = warp + (b0 + i) * kWarps;
        const int row = (t / kGroups) * kRows + lane / kGroup;
        const int vi = (t % kGroups) * kGroup + lane % kGroup;
        if (t >= kBands * kGroups || row >= G::RH || vi >= NV) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int rc = vi * VEC + e - off;
          if (rc >= 0 && rc < G::RW)
            S[row * G::LD + rc] = in_image[i] ? element(q[i], e, T()) : -INFINITY;
        }
      }
    }
  } else {
    // rows not 16-byte aligned: a warp a row, a lane a column
    for (int row = warp; row < G::RH; row += kWarps) {
      const int gy = ry0 + row;
      for (int rc = lane; rc < G::RW; rc += 32) {
        const int gx = rx0 + rc;
        S[row * G::LD + rc] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                                  ? gf::to_f32(s[static_cast<long long>(gy) * W + gx])
                                  : -INFINITY;
      }
    }
  }
}

template <int R, typename T>
__global__ void __launch_bounds__(kThreads, Geometry<R>::kMinBlocks)
    nms_tile_kernel(const T* __restrict__ scores, const float* __restrict__ true_size,
                    float* __restrict__ tile_max, int* __restrict__ tile_arg, int H, int W,
                    int iters, int border, int tile) {
  using G = Geometry<R>;
  extern __shared__ float smem[];
  Planes p;
  p.S = smem;
  p.T = p.S + G::RH * G::LD;
  p.MM = reinterpret_cast<uint32_t*>(p.T + G::RH * G::LD);
  p.SU = p.MM + G::RH * G::NWP;

  const int b = blockIdx.z;
  const int oy = blockIdx.y * kOutRows, ox = blockIdx.x * kOutCols;
  load_region<R, T>(scores + static_cast<long long>(b) * H * W, p.S, H, W, oy - G::kHalo,
                    ox - G::kHalo);
  __syncthreads();
  // max_mask = scores == max_pool(scores)
  pool_rows<R, false>(p);
  __syncthreads();
  pool_columns_compare<R, false>(p);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    // supp = max_pool(max_mask) > 0
    dilate<R>(p);
    __syncthreads();
    // max_mask |= (ss == max_pool(ss)) & ~supp
    pool_rows<R, true>(p);
    __syncthreads();
    pool_columns_compare<R, true>(p);
    __syncthreads();
  }

  // tile max / argmax: a warp a row of tiles over 32 columns, a lane a column
  const float w_true = true_size[2 * b], h_true = true_size[2 * b + 1];
  const float bf = static_cast<float>(border);
  const int lane = threadIdx.x & 31;
  const int halves = kOutCols / 32, Ht = H / tile, Wt = W / tile;
  for (int t = threadIdx.x >> 5; t < (kOutRows / tile) * halves; t += kWarps) {
    const int ty = t / halves, cx = (t % halves) * 32 + lane;
    const int gy0 = oy + ty * tile, x = ox + cx;
    if (gy0 >= H) continue;  // warp-uniform
    const int rx = G::kHalo + cx;
    float best = 0.f;
    int bdy = 0;
    for (int dy = 0; dy < tile; ++dy) {
      const int y = gy0 + dy, ry = G::kHalo + ty * tile + dy;
      const bool max_bit = (p.MM[ry * G::NWP + (rx >> 5)] >> (rx & 31)) & 1u;
      float val = max_bit ? p.S[ry * G::LD + rx] : 0.f;
      const bool keep = y >= border && x >= border && y < H - border && x < W - border &&
                        static_cast<float>(x) < w_true - bf && static_cast<float>(y) < h_true - bf;
      if (!keep) val = 0.f;
      if (dy == 0 || val > best) {
        best = val;
        bdy = dy;
      }
    }
    // across the tile's lanes: the higher dx wins only if strictly greater
    int bdx = lane & (tile - 1);
    for (int sh = 1; sh < tile; sh <<= 1) {
      const float pv = __shfl_xor_sync(0xffffffffu, best, sh);
      const int pdy = __shfl_xor_sync(0xffffffffu, bdy, sh);
      const int pdx = __shfl_xor_sync(0xffffffffu, bdx, sh);
      const bool partner_higher = (lane & sh) == 0;
      if (partner_higher ? pv > best : !(best > pv)) {
        best = pv;
        bdy = pdy;
        bdx = pdx;
      }
    }
    if ((lane & (tile - 1)) == 0 && x < W) {
      const long long o = (static_cast<long long>(b) * Ht + gy0 / tile) * Wt + x / tile;
      tile_max[o] = best;
      tile_arg[o] = bdy * tile + bdx;
    }
  }
}

template <int R, typename T>
cudaError_t launch_radius(const void* scores, const float* true_size, float* tile_max,
                          int* tile_arg, int B, int H, int W, int iters, int border, int tile,
                          cudaStream_t stream) {
  constexpr int smem = Geometry<R>::kSharedBytes;
  static_assert(smem <= 232448, "the haloed region must fit a block's shared memory");
  const cudaError_t err = gf::allow_shared_memory<nms_tile_kernel<R, T>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kOutCols - 1) / kOutCols, (H + kOutRows - 1) / kOutRows, B);
  nms_tile_kernel<R, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(scores), true_size, tile_max, tile_arg, H, W, iters, border, tile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* scores, const float* true_size, float* tile_max, int* tile_arg,
                   int B, int H, int W, int radius, int iters, int border, int tile,
                   cudaStream_t stream) {
  static_assert(kMaxRadius == 8, "one case per radius below");
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
    GF_RADIUS(7)
    GF_RADIUS(8)
#undef GF_RADIUS
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// scores (B, H, W) contiguous, dtype 0 = f32, 1 = bf16; true_size (B, 2) f32
// [w, h]; tile_max (B, H/tile, W/tile) f32 and tile_arg i32 (dy * tile + dx).
// tile is a power of two up to 32 that divides H and W, radius is 0-8,
// iters 0-2. Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for
// arguments out of range, which the Python wrapper checks first).
extern "C" int gf_fused_nms_tile_reduce(const void* scores, const void* true_size,
                                        void* tile_max, void* tile_arg, int B, int H, int W,
                                        int radius, int iters, int border, int tile, int dtype,
                                        void* stream) {
  if (iters < 0 || iters > kMaxIters || tile < 1 || tile > 32 || (tile & (tile - 1)) ||
      H % tile || W % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ts = static_cast<const float*>(true_size);
  float* tm = static_cast<float*>(tile_max);
  int* ta = static_cast<int*>(tile_arg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(scores, ts, tm, ta, B, H, W, radius, iters, border, tile, s)
                 : launch<float>(scores, ts, tm, ta, B, H, W, radius, iters, border, tile, s);
  return static_cast<int>(err);
}
