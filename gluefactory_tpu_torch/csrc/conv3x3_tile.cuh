// The skeleton shared by the 3x3 conv kernels on wgmma: the two conv-study
// kernels, conv3x3_stream.cu and conv3x3_npack.cu (out = conv3x3(x, w), no
// bias, no ReLU; they replace the Pallas prototypes `stream_conv` /
// `npack_conv` of scripts_dev/profile_stream_conv.py and
// scripts_dev/profile_npack.py), and the bf16 body of SuperPoint's VGG block,
// vgg_block.cu (bias and ReLU, and the 2x2/2 max-pool, in the epilogue).
// NHWC x, HWIO w, SAME zero padding, bf16 in, products summed in f32, the
// output rounded once to bf16. This header holds the producer, the tensor
// maps, the stage ring and the epilogues; each kernel source brings its
// consumer body (its products and how a finished output row comes out of
// its registers) and picks an epilogue (`Epilogue`).
//
// Bound on an H100 SXM at the conv1b shape (8 x 1024^2 x 64 -> 64): 2.15 GB
// of input and output at 3.35 TB/s, 0.641 ms, just above the 618 GFLOP at
// 989 TFLOP/s, 0.625 ms. So loads, products and stores must all overlap.
//
// Design:
//   - Work: a unit is a strip of `strip` output rows (kStripRows for the
//     conv-study kernels; per shape for the VGG block,
//     ops/cuda_conv.py::strip_rows) x 64 pixels of one image and one group
//     of 64 output channels. Blocks are persistent, one per SM; each block
//     keeps one channel group, so its weights load once.
//   - 384 threads: consumer warpgroups 0 and 1 and a producer warpgroup 2
//     (setmaxnreg: 232 registers for consumers, 40 for the producer). Each
//     consumer warpgroup runs its own pipeline: its own ring of stages, fed
//     by its own producer warp (warp 8 + w), walking its own units. The two
//     pipelines share the weights, and one's epilogue runs under the other's
//     products.
//   - Input by TMA, the padding free: a 4-D map over NHWC as (C, W, H, B),
//     boxes of 64 channels x 66 pixels, 128-byte swizzle. A stage is one
//     input row (one 64-channel K atom of it) as one box from x0 - 1: box
//     rows dx .. dx + 63 are the A operand of tap dx (`a_desc`). TMA fills
//     whatever lies outside the image with zeros, so the zero ring and the
//     ragged right and bottom edges cost no predicate. Input rows above and
//     below the image are not loaded at all: their products are zero.
//   - The dx shift: one 66-pixel box, not three 64-pixel boxes at x0 - 1,
//     x0 and x0 + 1. Both were built and timed in one call by the
//     conv-study tools (scripts_dev/profile_{npack,stream_conv}.py, H100
//     80GB HBM3 at 700 W): the same speed for the N-packed kernel
//     (0.906-0.923 ms against 0.924-0.926) and 1-2% faster for streaming
//     (1.111 against 1.119-1.136). It is kept because it reads each input
//     byte from L2 once, not three times (1.1 GB per call at conv1b against
//     3.2), and takes 9 KB of shared memory a stage, not 24: 6 stages a
//     pipeline, not 2.
//   - Weights by TMA: a map over HWIO as (Co, Ci, 3 dx, 3 dy), boxes of (64
//     co, 64 ci, 3 dx, 1 dy): one dy's 192 x 64 slab, output channels
//     contiguous, the MN-major B operand. Three boxes are pack_row_taps(w)'s
//     192 x 192 for one K atom and one channel group. Resident (loaded once
//     per block) while they fit beside the stages; at C_in >= 192 each stage
//     carries its K atom's weights instead (`ConvPlan`).
//   - The walk: a consumer takes the strip's input rows v = y0 - 1 ..
//     y0 + S top to bottom. Input row v feeds output rows v + 1 (dy 0), v
//     (dy 1) and v - 1 (dy 2), so after row v the output row v - 1 is
//     complete: the body hands it over as 64 x 64 f32 in registers. Each
//     input row is loaded once per strip; 2 halo rows are re-read per strip.
//   - Epilogue: [add the bias in f32,] round to bf16 [with ReLU in the same
//     conversion], write into a 128-byte swizzled staging tile
//     (conflict-free), and store with TMA, which clips at the image's edges.
//     With the pool, strips start on even rows; an even output row is
//     pooled along x as bf16 pairs (the two pixels of a pair lie in lanes 4
//     apart of the wgmma accumulator layout: one shuffle; rounding to bf16
//     is monotonic, so it commutes with max) and left in the staging tile;
//     the odd row below it, pooled along x, takes the max with it there and
//     the 32 pooled pixels go out in one TMA store. An even last row of an
//     odd height is never stored (the pool floors). The epilogue runs while
//     the next row's products are in flight, but its ALU work is not hidden
//     under them: it is kept to a bias add, a conversion, a shuffle and a
//     max per channel pair.
//     The N-packed body moves output row v - 1 into 32 registers of its own
//     and stores it while input row v + 1's products run; the streaming
//     body stores it right after row v's products (its register A operands
//     in flight across the store made ptxas serialise every wgmma, warning
//     C7518). The TMA store runs on; only the next use of the staging tile
//     waits for it to have been read.
//   - Shared memory at C_in = 64: 73,728 B of weights, 2 pipelines x 6
//     stages x 9,216 B, 2 x 8,192 B of staging, barriers: 201,928 B with
//     the alignment slack.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_utils.cuh"
#include "hopper.cuh"

namespace gf {
namespace conv {

constexpr int kStripRows = 64;     // the conv-study kernels' strip (ops/cuda_conv3x3.py: STRIP_ROWS)
constexpr int kCols = 64;          // pixels per unit and per wgmma M (STRIP_COLS)
constexpr int kChans = 64;         // channels per K atom and per output group
constexpr int kThreads = 384;
constexpr int kMaxStages = 6;      // per pipeline
constexpr int kBoxCols = kCols + 2;              // an input box: pixels x0 - 1 .. x0 + 64
constexpr int kRowTx = kBoxCols * kChans * 2;    // its bytes: 66 rows of 128 B
constexpr int kRowBytes = 9 * 1024;              // a stage's input row, 1024-byte aligned
constexpr int kDxBytes = kChans * kChans * 2;   // one tap's weights: 64 ci x 64 co
constexpr int kDyBytes = 3 * kDxBytes;          // one weight box: 3 dx x 64 ci x 64 co
constexpr int kAtomWBytes = 3 * kDyBytes;        // the 3 dy boxes of one K atom
constexpr int kStageOutBytes = kCols * kChans * 2;
constexpr int kBarBytes = 8 * (4 * kMaxStages + 1);
constexpr int kMaxSmem = 232448;   // opt-in shared memory per block on the H100

// Shared-memory plan for C_in (host and device): resident weights and as
// many stages per pipeline as fit, else weights carried by each stage.
struct ConvPlan {
  int resident, stages, stage_bytes, w_bytes, bytes;
};

__host__ __device__ inline ConvPlan make_plan(int ci) {
  const int atoms = ci / kChans;
  const int fixed = 2 * kStageOutBytes + kBarBytes + 1024;  // staging, barriers, slack
  ConvPlan p;
  p.resident = atoms * kAtomWBytes + fixed + 2 * kRowBytes <= kMaxSmem;
  p.w_bytes = p.resident ? atoms * kAtomWBytes : 0;
  p.stage_bytes = p.resident ? kRowBytes : kRowBytes + kAtomWBytes;
  p.stages = (kMaxSmem - fixed - p.w_bytes) / (2 * p.stage_bytes);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.bytes = p.w_bytes + 2 * p.stages * p.stage_bytes + fixed;
  return p;
}

// What a consumer does with a finished output row
enum class Epilogue {
  kStore,         // round to bf16 and store (the conv-study kernels)
  kBiasRelu,      // relu(row + bias) in f32, round, store
  kBiasReluPool,  // relu(row + bias), 2x2/2 max-pool with the row below, round, store
};

struct ConvParams {
  CUtensorMap x, w, out;  // out: pooled (boxes of 32 pixels) under kBiasReluPool
  const __nv_bfloat16* bias;  // (Co), for kBiasRelu and kBiasReluPool
  int B, H, W, Ci, Co;
  int strip;                  // output rows per unit (even with the pool)
  int ncols, nstrips, units;  // units per output-channel group
  int groups;                 // Co / 64; block b keeps group b % groups
  ConvPlan plan;
};

// A operand of tap dx: 64 pixels x 64 channels (K-major), the rows dx ..
// dx + 63 of the stage's 66-pixel box, 128 dx bytes into its first 1024-byte
// swizzle atom. The 128-byte swizzle is a function of the shared-memory
// address, the same for TMA's writes and wgmma's reads, so a descriptor that
// starts there reads the box as written, with the base offset (bits 49-51)
// left 0. (Setting it to dx gave wrong products on the H100.)
__device__ __forceinline__ uint64_t a_desc(uint32_t x_addr, int dx) {
  return sm90::smem_desc(x_addr + dx * 128, 16, 1024, 128);
}

// 128-byte swizzled (pixel, channel pair) offset of the staging tile
__device__ __forceinline__ uint32_t staging_offset(int row, int i, int q) {
  return row * 128 + ((i ^ (row & 7)) << 4) + 4 * q;
}

// Body (the consumer's products and registers), one object per consumer
// thread:
//   begin()                         a new strip
//   issue<kFirst>(x_addr, w_addr)  the wgmmas of one K atom of input row v
//                                   (x_addr: the row's 66-pixel box; w_addr:
//                                   the atom's three dy boxes); kFirst: atom 0
//   fence()                         after the wgmmas have completed
//   empty_row()                     input row v lies outside the image
//   finish_row()                    after row v: output row v - 1 complete
//   out(j)                          its register j (the wgmma m64n64
//                                   accumulator layout)
//   advance()                       after its store: on to row v + 1
//   kStoreUnderProducts             store it while row v + 1's wgmmas run
//                                   (out() must then outlive advance()), or
//                                   right away
template <class Body, Epilogue kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const __grid_constant__ ConvParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const ConvPlan& pl = p.plan;
  const uint32_t stage0 = base + pl.w_bytes;
  const uint32_t staging0 = stage0 + 2 * pl.stages * pl.stage_bytes;
  const uint32_t bars = staging0 + 2 * kStageOutBytes;
  auto stage = [&](int ring, int s) { return stage0 + (ring * pl.stages + s) * pl.stage_bytes; };
  auto full = [&](int ring, int s) { return bars + 8 * (ring * kMaxStages + s); };
  auto empty = [&](int ring, int s) { return bars + 8 * ((2 + ring) * kMaxStages + s); };
  const uint32_t wfull = bars + 8 * 4 * kMaxStages;

  if (threadIdx.x == 0) {
    for (int ring = 0; ring < 2; ++ring)
      for (int s = 0; s < pl.stages; ++s) {
        sm90::mbar_init(full(ring, s), 1);
        sm90::mbar_init(empty(ring, s), 4);  // one arrival per consumer warp
      }
    sm90::mbar_init(wfull, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int group = blockIdx.x % p.groups;
  const int nb = gridDim.x / p.groups;
  const int first_unit = 2 * (blockIdx.x / p.groups);
  const int atoms = p.Ci / kChans;
  struct Unit {
    int b, y0, yend, x0;
  };
  auto decode = [&](int j) {
    const int col = j % p.ncols, rest = j / p.ncols;
    const int y0 = (rest % p.nstrips) * p.strip;
    return Unit{rest / p.nstrips, y0, min(y0 + p.strip, p.H), col * kCols};
  };

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------ producers -----------------------------
    sm90::reg_dealloc<40>();
    const int ring = threadIdx.x / 32 - 8;
    if (ring < 2 && threadIdx.x % 32 == 0) {
      if (ring == 0 && pl.resident) {
        sm90::mbar_expect_tx(wfull, atoms * kAtomWBytes);
        for (int a = 0; a < atoms; ++a)
          for (int dy = 0; dy < 3; ++dy)
            sm90::tma_load_4d(base + a * kAtomWBytes + dy * kDyBytes, &p.w, wfull,
                              group * kChans, a * kChans, 0, dy);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int j = first_unit + ring; j < p.units; j += 2 * nb) {
        const Unit u = decode(j);
        const int v_end = min(u.y0 + p.strip, p.H - 1);
        for (int v = max(u.y0 - 1, 0); v <= v_end; ++v)
          for (int a = 0; a < atoms; ++a) {
            sm90::mbar_wait(empty(ring, s), phase ^ 1);
            const uint32_t dst = stage(ring, s);
            sm90::mbar_expect_tx(full(ring, s), pl.resident ? kRowTx : kRowTx + kAtomWBytes);
            sm90::tma_load_4d(dst, &p.x, full(ring, s), a * kChans, u.x0 - 1, v, u.b);
            if (!pl.resident)
              for (int dy = 0; dy < 3; ++dy)
                sm90::tma_load_4d(dst + kRowBytes + dy * kDyBytes, &p.w, full(ring, s),
                                  group * kChans, a * kChans, 0, dy);
            if (++s == pl.stages) {
              s = 0;
              phase ^= 1;
            }
          }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    sm90::reg_alloc<232>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, q = lane % 4;
    const uint32_t staging = staging0 + wg * kStageOutBytes;
    uint8_t* staging_ptr = smem_raw + (staging - raw);
    if (pl.resident) sm90::mbar_wait(wfull, 0);
    Body body;
    int s = 0;
    uint32_t phase = 0;
    // register j of the body's out row: pixel 16 warp + g + 8 ((j / 2) % 2),
    // channel 8 (j / 4) + 2 q + j % 2 of the group. A thread's 16 channels
    // stay the same: their bias is loaded once, into registers (in the
    // pooled epilogue ptxas then spills 32 bytes, and it is still faster
    // than reading the bias from shared memory on each row:
    // scripts_dev/kernel_variants.py no_bias against the kernel, both ways).
    float bias[16];
    if constexpr (kEpi != Epilogue::kStore) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bias[2 * i + e] = __bfloat162float(p.bias[group * kChans + 8 * i + 2 * q + e]);
    }
    // registers 4 i + 2 h and 4 i + 2 h + 1 as a bf16 pair; with the bias,
    // relu inside the conversion (an epilogue's ALU work is not hidden under
    // the products: each instruction saved counts)
    auto packed = [&](int i, int h) {
      const float lo = body.out(4 * i + 2 * h), hi = body.out(4 * i + 2 * h + 1);
      if constexpr (kEpi == Epilogue::kStore) {
        return pack_bf16(lo, hi);
      } else {
        return pack_bf16_relu(lo + bias[2 * i], hi + bias[2 * i + 1]);
      }
    };
    // epilogue: output row y (the body's out registers) as bf16 through the
    // staging tile to a TMA store
    auto store_row = [&](const Unit& u, int y) {
      if constexpr (kEpi == Epilogue::kBiasReluPool) {
        const bool odd = y % 2 != 0;  // strips start on even rows
        if (!odd) {
          if (t == 0) sm90::bulk_wait_read();  // the previous store has read the tile
          sm90::bar_sync(1 + wg, 128);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // pixels 2 c and 2 c + 1 of the row: lanes g and g + 1, 4 apart;
            // max of bf16 values = bf16 of the max (rounding is monotonic)
            uint32_t v = packed(i, h);
            v = max_bf16x2(v, __shfl_xor_sync(0xffffffffu, v, 4));
            if (g % 2 == 0) {
              // pooled pixel (16 warp + g + 8 h) / 2; the odd row meets the
              // even row's values, written by this same thread
              uint32_t* dst = reinterpret_cast<uint32_t*>(
                  staging_ptr + staging_offset(8 * warp + g / 2 + 4 * h, i, q));
              *dst = odd ? max_bf16x2(v, *dst) : v;
            }
          }
        if (odd) {
          sm90::fence_proxy_async();
          sm90::bar_sync(1 + wg, 128);
          if (t == 0) {
            sm90::tma_store_4d(&p.out, staging, group * kChans, u.x0 / 2, y / 2, u.b);
            sm90::bulk_commit();
          }
        }
      } else {
        if (t == 0) sm90::bulk_wait_read();  // the previous store has read the tile
        sm90::bar_sync(1 + wg, 128);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * warp + g + 8 * h;
            *reinterpret_cast<uint32_t*>(staging_ptr + staging_offset(row, i, q)) = packed(i, h);
          }
        sm90::fence_proxy_async();
        sm90::bar_sync(1 + wg, 128);
        if (t == 0) {
          sm90::tma_store_4d(&p.out, staging, group * kChans, u.x0, y, u.b);
          sm90::bulk_commit();
        }
      }
    };
    for (int j = first_unit + wg; j < p.units; j += 2 * nb) {
      const Unit u = decode(j);
      body.begin();
      int pending = -1;  // the output row in body.out(), not yet stored
      auto store_pending = [&] {
        if (pending >= 0) store_row(u, pending);
      };
      for (int v = u.y0 - 1; v <= u.yend; ++v) {
        if (v >= 0 && v < p.H) {
          // one K atom: wait for its stage, issue its products, wait, hand
          // the stage back; atom 0 stores the pending row under its products
          auto take = [&](int a, auto first) {
            sm90::mbar_wait(full(wg, s), phase);
            const uint32_t x_addr = stage(wg, s);
            const uint32_t w_addr = pl.resident ? base + a * kAtomWBytes : x_addr + kRowBytes;
            sm90::wgmma_fence();
            body.template issue<decltype(first)::value>(x_addr, w_addr);
            sm90::wgmma_commit();
            if constexpr (decltype(first)::value && Body::kStoreUnderProducts) store_pending();
            sm90::wgmma_wait<0>();
            body.fence();
            if (lane == 0) sm90::mbar_arrive(empty(wg, s));
            if (++s == pl.stages) {
              s = 0;
              phase ^= 1;
            }
          };
          take(0, std::true_type{});
          for (int a = 1; a < atoms; ++a) take(a, std::false_type{});
        } else {
          body.empty_row();
          if constexpr (Body::kStoreUnderProducts) store_pending();
        }
        body.finish_row();
        const int y = v - 1 >= u.y0 ? v - 1 : -1;
        if constexpr (Body::kStoreUnderProducts) {
          pending = y;  // stored with row v + 1
        } else if (y >= 0) {
          store_row(u, y);
        }
        body.advance();
      }
      if constexpr (Body::kStoreUnderProducts) store_pending();
    }
    if (t == 0) sm90::bulk_wait();
  }
}

// x (B, H, W, Ci) NHWC, w (3, 3, Ci, Co) HWIO, out (B, H, W, Co) (B, H / 2,
// W / 2, Co under kBiasReluPool), bf16, contiguous, 16-byte aligned; Ci and
// Co positive multiples of 64; bias (Co) bf16 unless kStore; strip > 0, even
// under kBiasReluPool.
template <class Body, Epilogue kEpi = Epilogue::kStore>
cudaError_t launch(const void* x, const void* w, void* out, int B, int H, int W, int Ci, int Co,
                   cudaStream_t stream, int strip = kStripRows, const void* bias = nullptr) {
  constexpr bool kPool = kEpi == Epilogue::kBiasReluPool;
  if (Ci <= 0 || Co <= 0 || Ci % kChans != 0 || Co % kChans != 0) return cudaErrorInvalidValue;
  if (strip <= 0 || (kPool && strip % 2 != 0)) return cudaErrorInvalidValue;
  if (kEpi != Epilogue::kStore && bias == nullptr) return cudaErrorInvalidValue;
  ConvParams p;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.B = B, p.H = H, p.W = W, p.Ci = Ci, p.Co = Co;
  p.strip = strip;
  p.ncols = (W + kCols - 1) / kCols;
  p.nstrips = (H + strip - 1) / strip;
  p.units = B * p.nstrips * p.ncols;
  p.groups = Co / kChans;
  p.plan = make_plan(Ci);
  if (p.plan.stages < 1) return cudaErrorInvalidValue;
  cudaError_t err = sm90::encode_nhwc(&p.x, x, B, H, W, Ci, kBoxCols);
  if (err == cudaSuccess) err = sm90::encode_hwio3x3(&p.w, w, Ci, Co);
  if (err == cudaSuccess)
    err = kPool ? sm90::encode_nhwc(&p.out, out, B, H / 2, W / 2, Co, kCols / 2)
                : sm90::encode_nhwc(&p.out, out, B, H, W, Co, kCols);
  if (err == cudaSuccess) err = allow_shared_memory<conv3x3_kernel<Body, kEpi>>(p.plan.bytes);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // blocks per channel group: one per SM at most, two units each at least
  int nb = sms / p.groups;
  const int pairs = (p.units + 1) / 2;
  if (nb > pairs) nb = pairs;
  if (nb < 1) nb = 1;
  conv3x3_kernel<Body, kEpi><<<nb * p.groups, kThreads, p.plan.bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace gf
