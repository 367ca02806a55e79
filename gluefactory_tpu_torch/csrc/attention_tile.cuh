// Masked softmax attention, the kernel bodies shared by fused_attention.cu
// and fused_bidirectional_attention.cu. One launch runs one or two
// "directions" (queries, keys, values, masks, output), so the
// cross-attention's two directions share a launch.
//
// Replaces the TPU kernels `_attn_kernel` / `_bidir_kernel` of
// gluefactory_tpu/ops/pallas_attention.py. The TPU kernel keeps all of K and
// V resident in VMEM and forms a (512, N) logit block; here a block owns a
// tile of query rows, streams K/V through shared memory in tiles, and keeps
// an online softmax (running max m, running sum l) in registers, so no logit
// ever reaches device memory.
//
// Precision mirrors the TPU kernel: logits and all sums in f32; each
// probability is rounded to V's dtype before the PV product while l sums
// the unrounded values; the output is normalised after PV. Masked keys
// contribute exactly 0 (the TPU's exp(-1e9 - m) underflows to 0 whenever a
// valid key exists); a query whose key set is fully masked gets l == 0 and
// returns zeros (the TPU's any_valid / NEG_INF guard); rows whose query mask
// is 0 are written as zeros. A key tile with no valid key is skipped whole,
// so a fully masked key set never feeds exp(0) = 1 into l.
//
// Bound on an H100 SXM at the LightGlue shapes (B*H = 32, M = N = 2048,
// D = 64, bf16): 4*B*H*M*N*D = 34.4 GFLOP, 0.035 ms on the tensor cores at
// 989 TFLOP/s, against 34 MB of inputs and outputs (0.010 ms). The
// B*H*M*N = 134M exponentials take 0.032 ms on the special-function units
// (16 per SM per clock x 132 SMs x 1.98 GHz): as long as the products. So
// the softmax has to run while the tensor cores work, or the two add up.
//
// Two bodies:
//   - bf16 (the inference paths), `attention_wgmma_kernel`, written for Hopper:
//       * 384 threads: consumer warpgroups 0 and 1 own 64 query rows each
//         (128 per work item); warpgroup 2 is the producer. Its first warp
//         issues every copy; the warpgroup gives its registers up
//         (setmaxnreg 40) to the consumers (232).
//       * Persistent blocks, one per SM (193 KB of shared memory at D = 64):
//         a block walks over work items (direction, batch x head, 128-row
//         query tile), query tiles fastest so one wave's blocks share K and
//         V in L2. The query tile is double-buffered: the producer loads the
//         next item's while the consumers finish this one, so a block's
//         start-up and epilogue overlap the next item's loads.
//       * TMA: the producer loads an item's 128 x D query tile once, then K
//         and V tiles of 128 keys into a ring of 5 stages, each with a full
//         and an empty mbarrier. A consumer holds two stages at once (PV of
//         tile j - 1 runs while S of tile j is formed), so 5 stages keep
//         three tiles in flight ahead of it. Tensor maps are 4-D over (D,
//         tokens, heads, batch) with the tensors' own strides, so
//         LightGlue's (B, N, H, D)-ordered views are read as they are;
//         tokens past the end arrive as zeros. 128-byte swizzle for D = 64,
//         64-byte for D = 32: the layouts wgmma reads without bank
//         conflicts.
//       * Key masks: the producer reads a tile's 128 mask bytes once
//         (coalesced, one tile ahead, one ballot per 32 keys), skips a tile
//         with no valid key before loading it, and hands the consumers the
//         tile's index and a 128-bit validity mask in shared memory beside
//         K and V. A sentinel index ends each work item. The skip is uniform
//         over the block by construction; a tile whose keys are all valid
//         skips the masking pass.
//       * S = Q K^T: wgmma m64n128k16, Q and K from shared memory, f32
//         accumulators. Softmax in registers, in the log2 domain.
//       * PV: P rounded to bf16 in registers is the A operand of wgmma
//         m64n{D}k16; V is read from shared memory as an MN-major
//         (transposed) B operand, straight from the TMA layout.
//       * Overlap: intra-warpgroup pipelining plus ping-pong. Each
//         iteration issues S(j) and PV(j-1) back to back, waits for S(j)
//         only, and computes softmax(j) while PV(j-1) still runs. Named
//         barriers (1 and 2) make the two consumer warpgroups take turns at
//         issuing their products, so one warpgroup's softmax also runs
//         under the other's products. Chosen because the exponentials cost
//         as much as the products at D = 64: pipelining alone hides
//         softmax(j) under PV(j-1), half of one warpgroup's products;
//         the turns add the other warpgroup's S and PV.
//   - f32 (path E: training with TF32 off), `attention_f32_kernel`, exact
//     f32 FMAs on the CUDA cores, laid out as an f32 SIMT GEMM does:
//       * 256 threads own 128 query rows; K and V stream through shared
//         memory in tiles of 64 keys; blockIdx.z picks the direction. The
//         work is 2*D FMAs a logit, so the f32 pipes bound it: at path E's
//         self-attention (B*H = 256, M = N = 512, D = 64) 17.2 GFLOP, 0.256
//         ms at 67 TFLOP/s, against 0.016 ms of exponentials and 0.027 ms
//         of bytes. The body must issue FMAs, not shared-memory loads.
//       * S = Q K^T: each thread holds an 8 x 4 microtile (rows r0 + 8i,
//         keys kg + 16j; kg = lane % 16, and the two half-warps take
//         neighbouring r0). Q (loaded once) and K are row-major tiles read
//         as float4 along the features: 12 loads for 128 FMAs, none of them
//         conflicting (the 16-byte chunks of a row are XOR-swizzled by the
//         row's low 3 bits, which are the same for a thread's 8 rows, so
//         one swizzle a chunk serves them all).
//       * Online softmax in the log2 domain with exp2: a row's 16 threads
//         are 16 lanes of one warp, so the row max is 4 shuffles; the
//         running max is kept in shared memory (one float a row), each
//         thread keeps its own share of the row sum and rescales it, and the
//         shares are summed once at the end.
//       * P goes through shared memory (128 x 64, swizzled as Q); O += P V
//         with each thread owning 8 rows x D/16 feature columns: again 12
//         loads a 128 FMAs at D = 64.
//       * Staging: cp.async (16-byte, .cg, zero fill past the tokens). K is
//         double-buffered and tile j + 1 loads during all of tile j; V has
//         one buffer and loads during S and the softmax. Two barriers a
//         tile. A tile with no valid key is skipped whole (one barrier
//         vote, uniform over the block).
//       * 112 KB of shared memory at D = 64 and at most 128 registers a
//         thread: two blocks (16 warps) an SM, so one block's barriers hide
//         under the other's FMAs.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_utils.cuh"
#include "hopper.cuh"

namespace gf {

// One direction of attention. Strides are in elements; the last (feature)
// dimension is contiguous.
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kmask;  // (B, N), nonzero = valid; null = all valid
  const uint8_t* qmask;  // (B, M), nonzero = valid; null = all valid
  void* out;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  long long kmask_sb, qmask_sb;
  int H, M, N;
  float scale;
};

// Up to two directions of one launch, picked by blockIdx.z.
struct AttnDirs {
  AttnArgs d[2];
};

// ---------------------------------------------------------------------------
// f32 body: register microtiles on the CUDA cores, cp.async staging
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 128;     // query rows per block
constexpr int kF32Keys = 64;      // keys per K/V tile
constexpr int kF32Threads = 256;  // 8 warps: 16 query rows each

// Shared memory in floats: Q (128 x D) and two K stages (64 x D), swizzled;
// V (64 x D) plain; P (128 x 64) swizzled.
template <int D>
struct F32Smem {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kF32Rows * D;
  static constexpr int kV = kK + 2 * kF32Keys * D;
  static constexpr int kP = kV + kF32Keys * D;
  static constexpr int kBytes = (kP + kF32Rows * kF32Keys) * 4;
};

// Offset in floats of 16-byte chunk c of row r in a row-major tile of W
// floats a row, the chunks XOR-swizzled by the row's low three bits: eight
// consecutive rows read at one chunk hit eight distinct bank quads.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + ((c ^ (r & 7)) << 2);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) of a (tokens x D) f32 matrix with token stride sn
// into shared memory at dst: swizzled, or plain row-major. Tokens at or past
// n arrive as zeros.
template <int D, int R, bool kSwizzled>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long sn, int row0,
                                           int n) {
  constexpr int kChunks = D / 4;
  static_assert(R * kChunks % kF32Threads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < R * kChunks / kF32Threads; ++it) {
    const int e = threadIdx.x + it * kF32Threads;
    const int r = e / kChunks, c = e % kChunks, row = row0 + r;
    const bool in = row < n;
    const float* g = src + (in ? row * sn + 4 * c : 0);
    float* s = dst + (kSwizzled ? swz<D>(r, c) : r * D + 4 * c);
    cp_async16(smem_u32(s), g, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
    attention_f32_kernel(const __grid_constant__ AttnDirs dirs) {
  constexpr int kC = D / 16;  // feature columns a thread owns in O
  constexpr float kLog2e = 1.4426950408889634f;
  using L = F32Smem<D>;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t key_bits[2];  // the tile's valid keys, 2 x 32
  __shared__ float row_max[kF32Rows];  // each row's running max, in log2 units

  const AttnArgs& a = dirs.d[blockIdx.z];
  const int row0 = blockIdx.x * kF32Rows;
  if (row0 >= a.M) return;  // the shorter direction's grid ends earlier
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int kg = lane % 16;
  // this thread's rows: r0 + 8i, i < 8; r0 & 7 is the same for all of them,
  // so one swizzle a chunk serves the eight rows (and kg & 7 the four keys)
  const int r0 = (w / 4) * 64 + (w % 4) * 2 + lane / 16;
  const int xq = r0 & 7, xk = kg & 7;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  float* out = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh;
  const uint8_t* kmask = a.kmask == nullptr ? nullptr : a.kmask + b * a.kmask_sb;
  float* sq = smem + L::kQ;
  float* sv = smem + L::kV;
  float* sp = smem + L::kP;
  const float* qrow = sq + r0 * D;
  float* prow = sp + r0 * kF32Keys;
  const float sl2 = a.scale * kLog2e;

  stage_rows<D, kF32Rows, true>(sq, q, a.q_sn, row0, a.M);
  stage_rows<D, kF32Keys, true>(smem + L::kK, k, a.k_sn, 0, a.N);
  cp_async_commit();

  // the running max lives in shared memory: 8 registers fewer in S = QK^T
  float o[8][kC], l[8];
  if (t < kF32Rows) row_max[t] = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[i][c] = 0.f;
  }

  const int n_tiles = (a.N + kF32Keys - 1) / kF32Keys;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kF32Keys;
    const float* sk = smem + L::kK + (jt & 1) * kF32Keys * D;
    float* sk_next = smem + L::kK + ((jt + 1) & 1) * kF32Keys * D;
    bool valid = false;
    if (t < kF32Keys) {
      const int key = j0 + t;
      valid = key < a.N && (kmask == nullptr || kmask[key] != 0);
      const uint32_t bits = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) key_bits[w] = bits;
    }
    cp_async_wait<0>();  // K(j) (and Q) landed
    // K(j) visible, every thread done with V, P and the other K stage
    if (!__syncthreads_or(valid)) {  // no valid key: skip the tile
      if (jt + 1 < n_tiles) stage_rows<D, kF32Keys, true>(sk_next, k, a.k_sn, j0 + kF32Keys, a.N);
      cp_async_commit();
      continue;
    }
    stage_rows<D, kF32Keys, false>(sv, v, a.v_sn, j0, a.N);
    cp_async_commit();
    if (jt + 1 < n_tiles) stage_rows<D, kF32Keys, true>(sk_next, k, a.k_sn, j0 + kF32Keys, a.N);
    cp_async_commit();

    // S = Q K^T: rows r0 + 8i, keys kg + 16j
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* krow = sk + kg * D;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const int cq = (c ^ xq) * 4, ck = (c ^ xk) * 4;
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(krow + 16 * j * D + ck);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(qrow + 8 * i * D + cq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    // online softmax in the log2 domain; P to shared memory
    const uint64_t kbits = (static_cast<uint64_t>(key_bits[1]) << 32) | key_bits[0];
    if (kbits != ~0ull) {  // uniform per tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = (kbits >> (kg + 16 * j)) & 1ull;
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][j] = ok ? s[i][j] : -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float m_old = row_max[r0 + 8 * i];  // read before the shuffles
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float ms = fmaxf(m_old, mx * sl2);  // finite: the tile has a valid key
      const float alpha = sm90::ex2(m_old - ms);  // 0 on the first tile
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kC; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sm90::ex2(fmaf(s[i][j], sl2, -ms));  // masked: exp2(-inf) = 0
        l[i] += p;
        // key kg + 16j: chunk kg / 4 + 4j, swizzled by r0's low bits
        prow[8 * i * kF32Keys + (((kg / 4 + 4 * j) ^ xq) * 4) + kg % 4] = p;
      }
      __syncwarp();  // the row's 16 lanes have read row_max
      if (kg == 0) row_max[r0 + 8 * i] = ms;
    }
    cp_async_wait<1>();  // V(j) landed; K(j + 1) may still be in flight
    __syncthreads();     // P and V(j) visible

    // O += P V: rows as S, feature columns kC*kg ..
#pragma unroll 4
    for (int c = 0; c < kF32Keys / 4; ++c) {
      const int cp = (c ^ xq) * 4;
      float vf[4][kC];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* src = sv + (4 * c + e) * D + kC * kg;
        if constexpr (kC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vf[e][0] = x.x, vf[e][1] = x.y, vf[e][2] = x.z, vf[e][3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vf[e][0] = x.x, vf[e][1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 pf = *reinterpret_cast<const float4*>(prow + 8 * i * kF32Keys + cp);
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          o[i][cc] = fmaf(pf.x, vf[0][cc], o[i][cc]);
          o[i][cc] = fmaf(pf.y, vf[1][cc], o[i][cc]);
          o[i][cc] = fmaf(pf.z, vf[2][cc], o[i][cc]);
          o[i][cc] = fmaf(pf.w, vf[3][cc], o[i][cc]);
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit

  // the row sums' 16 shares, then the normalised rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off *= 2) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = row0 + r0 + 8 * i;
    if (row >= a.M) continue;
    const bool row_ok = a.qmask == nullptr || a.qmask[b * a.qmask_sb + row] != 0;
    const float inv = row_ok && l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* dst = out + row * a.o_sn + kC * kg;
    if constexpr (kC == 4)
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(o[i][0] * inv, o[i][1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 body for Hopper: TMA producer warp, two wgmma consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kQRows = 128;   // query rows per block: 64 per consumer warpgroup
constexpr int kKeys = 128;    // keys per K/V tile
constexpr int kStages = 5;    // K/V ring depth (160 KB of shared memory at D = 64)
constexpr int kWgmmaThreads = 384;

// Tensor maps and directions of one launch (kernel parameter space).
struct WgmmaParams {
  CUtensorMap q[2], k[2], v[2];
  AttnDirs dirs;
  int n_dirs, bh, q_tiles;  // work items: n_dirs x bh x q_tiles
};

// Shared memory, as offsets from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 1024 bytes).
template <int D>
struct WgmmaSmem {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kQ = 0;                                     // two query tiles
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr int kKV = 2 * kQRows * kRowBytes;               // K(s), then V(s)
  static constexpr int kBars = kKV + kStages * 2 * kTileBytes;     // q_full[2], q_empty[2],
                                                                   // full[], empty[]
  static constexpr int kTileIdx = kBars + 8 * (4 + 2 * kStages);   // int per stage
  static constexpr int kMask = kTileIdx + 4 * kStages;             // 4 x u32 per stage
  static constexpr int kBytes = kMask + 16 * kStages + 1024;       // + alignment slack
};

// S = Q K^T over one tile: 64 query rows x kKeys keys, D / 16 steps of 16
// features (32 bytes of a swizzled row); one commit.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t dq, uint32_t k_addr) {
  const uint64_t dk = sm90::smem_desc(k_addr, 16, 8 * D * 2, D * 2);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
  sm90::wgmma_commit();
}

__device__ __forceinline__ void load_mask(uint32_t (&kbits)[4], const uint32_t* src) {
#pragma unroll
  for (int w = 0; w < 4; ++w) kbits[w] = src[w];
}

// Online softmax of one S tile in place, in the log2 domain. This thread
// holds columns 8i + 2qd + {0, 1} of rows g (s[4i], s[4i + 1]) and g + 8
// (s[4i + 2], s[4i + 3]); kbits marks the tile's valid keys. Masked keys
// become exactly 0. Updates the running max m (raw logit units) and returns
// the rescale factor alpha of the previous sums and this thread's share rs
// of the new row sums (unrounded probabilities).
__device__ __forceinline__ void softmax_tile(float (&s)[64], const uint32_t (&kbits)[4], int qd,
                                             float sl2, float (&m)[2], float (&alpha)[2],
                                             float (&rs)[2]) {
  if ((kbits[0] & kbits[1] & kbits[2] & kbits[3]) != 0xffffffffu) {  // uniform per tile
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = (kbits[i / 4] >> (8 * (i % 4) + 2 * qd + (e & 1))) & 1u;
        s[4 * i + e] = valid ? s[4 * i + e] : -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // 4 threads share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);       // finite: the tile has a valid key
    alpha[r] = sm90::ex2((m[r] - m_new) * sl2);  // 0 on the first tile
    m[r] = m_new;
    ms[r] = m_new * sl2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) rs[r] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = sm90::ex2(fmaf(s[i], sl2, -ms[(i / 2) % 2]));  // masked: exp2(-inf) = 0
    s[i] = p;
    rs[(i / 2) % 2] += p;
  }
}

// P rounded to bf16, laid out as the A fragments of PV: the S accumulator
// layout is the register-A layout of wgmma, pair by pair.
__device__ __forceinline__ void pack_probabilities(uint32_t (&pa)[32], const float (&s)[64]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

// O += P V over one tile of kKeys keys: P (bf16, registers) as the A
// operand, V (keys x D, TMA layout) as an MN-major B operand; one commit.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[32],
                                         uint32_t v_addr) {
  constexpr int kRowBytes = D * 2;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t ak[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    const uint64_t dv = sm90::smem_desc(v_addr + kk * 16 * kRowBytes, kKeys * kRowBytes,
                                        8 * kRowBytes, kRowBytes);
    if constexpr (D == 64)
      sm90::wgmma_m64n64k16_rs_tb(o, ak, dv);
    else
      sm90::wgmma_m64n32k16_rs_tb(o, ak, dv);
  }
  sm90::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    attention_wgmma_kernel(const __grid_constant__ WgmmaParams p) {
  using L = WgmmaSmem<D>;
  constexpr int kNO = D / 2;  // O accumulators per thread
  extern __shared__ uint8_t smem_raw[];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  auto q_tile = [&](int qb) { return base + L::kQ + qb * kQRows * L::kRowBytes; };
  auto k_tile = [&](int s) { return base + L::kKV + s * 2 * L::kTileBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + L::kTileBytes; };
  auto q_full = [&](int qb) { return base + L::kBars + 8 * qb; };
  auto q_empty = [&](int qb) { return base + L::kBars + 8 * (2 + qb); };
  auto full = [&](int s) { return base + L::kBars + 8 * (4 + s); };
  auto empty = [&](int s) { return base + L::kBars + 8 * (4 + kStages + s); };
  int* tile_of = reinterpret_cast<int*>(base_ptr + L::kTileIdx);
  uint32_t* mask_of = reinterpret_cast<uint32_t*>(base_ptr + L::kMask);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      sm90::mbar_init(q_full(qb), 1);
      sm90::mbar_init(q_empty(qb), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Persistent blocks: item i -> direction z, batch*head bh, query tile qt
  // (query tiles fastest, so the blocks of one wave share K and V in L2).
  // Items past the shorter direction's queries are skipped by every role.
  const int n_items = p.n_dirs * p.bh * p.q_tiles;
  struct Item {
    int z, b, h, row0;
  };
  auto decode = [&](int i) {
    const int qt = i % p.q_tiles, rest = i / p.q_tiles;
    const int bh = rest % p.bh, z = rest / p.bh;
    const int H = p.dirs.d[z].H;
    return Item{z, bh / H, bh % H, qt * kQRows};
  };

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    sm90::reg_dealloc<40>();
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      int stage = 0, it = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item w = decode(i);
        const AttnArgs& a = p.dirs.d[w.z];
        if (w.row0 >= a.M) continue;
        const int qb = it & 1;
        if (lane == 0) {  // the query tile, once the buffer's last reader is done
          sm90::mbar_wait(q_empty(qb), ((it >> 1) & 1) ^ 1);
          sm90::mbar_expect_tx(q_full(qb), kQRows * L::kRowBytes);
          sm90::tma_load_4d(q_tile(qb), &p.q[w.z], q_full(qb), 0, w.row0, w.h, w.b);
        }
        ++it;
        const uint8_t* kmask = a.kmask == nullptr ? nullptr : a.kmask + w.b * a.kmask_sb;
        const int n_tiles = (a.N + kKeys - 1) / kKeys;
        // key validity, one tile ahead: tile t + 1's mask bytes load while
        // tile t waits for its stage
        auto load_valid = [&](int t, uint32_t(&v)[4]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = t * kKeys + 32 * j + lane;
            v[j] = key < a.N && (kmask == nullptr || kmask[key] != 0);
          }
        };
        uint32_t next[4];
        load_valid(0, next);
        for (int t = 0; t < n_tiles; ++t) {
          uint32_t bits[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bits[j] = next[j];
          if (t + 1 < n_tiles) load_valid(t + 1, next);
#pragma unroll
          for (int j = 0; j < 4; ++j) bits[j] = __ballot_sync(0xffffffffu, bits[j] != 0);
          if ((bits[0] | bits[1] | bits[2] | bits[3]) == 0) continue;  // no valid key: skip
          if (lane == 0) {
            sm90::mbar_wait(empty(stage), phase ^ 1);
            tile_of[stage] = t;
#pragma unroll
            for (int j = 0; j < 4; ++j) mask_of[4 * stage + j] = bits[j];
            sm90::mbar_expect_tx(full(stage), 2 * L::kTileBytes);
            sm90::tma_load_4d(k_tile(stage), &p.k[w.z], full(stage), 0, t * kKeys, w.h, w.b);
            sm90::tma_load_4d(v_tile(stage), &p.v[w.z], full(stage), 0, t * kKeys, w.h, w.b);
          }
          __syncwarp();
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (lane == 0) {  // the item's sentinel: no more tiles
          sm90::mbar_wait(empty(stage), phase ^ 1);
          tile_of[stage] = -1;
          sm90::mbar_arrive(full(stage));
        }
        __syncwarp();
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    sm90::reg_alloc<232>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, qd = lane % 4;  // accumulator row group / column pair

    float s[64];      // S: 64 rows x 128 keys over the warpgroup
    float o[kNO];     // O: 64 rows x D
    uint32_t pa[32];  // P in bf16, the A operand of PV
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    int stage = 0, it = 0;
    uint32_t phase = 0;
    auto advance = [&] {
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    if (wg == 1) sm90::bar_arrive(1, 256);  // warpgroup 0 takes the first turn
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item w = decode(i);
      const AttnArgs& a = p.dirs.d[w.z];
      if (w.row0 >= a.M) continue;
      const float sl2 = a.scale * 1.4426950408889634f;
      const int qb = it & 1;
      const uint64_t dq =
          sm90::smem_desc(q_tile(qb) + wg * 64 * L::kRowBytes, 16, 8 * L::kRowBytes, 2 * D);
#pragma unroll
      for (int j = 0; j < kNO; ++j) o[j] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 (raw logit units)
      float l[2] = {0.f, 0.f};              // this thread's columns; reduced at the end
      sm90::mbar_wait(q_full(qb), (it >> 1) & 1);
      ++it;

      // Every wgmma is waited for inside the branch or iteration that
      // issued it, so the compiler can see which accumulators are in flight.
      sm90::mbar_wait(full(stage), phase);
      if (tile_of[stage] >= 0) {
        // the first tile: S alone, no PV to overlap
        uint32_t kbits[4];
        load_mask(kbits, mask_of + 4 * stage);
        sm90::bar_sync(1 + wg, 256);  // this warpgroup's turn at the tensor cores
        sm90::wgmma_fence();
        issue_s<D>(s, dq, k_tile(stage));
        sm90::bar_arrive(2 - wg, 256);  // the other warpgroup's turn
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        float alpha[2], rs[2];
        softmax_tile(s, kbits, qd, sl2, m, alpha, rs);  // alpha = 0: O and l are 0
        l[0] = rs[0];
        l[1] = rs[1];
        pack_probabilities(pa, s);
        int prev = stage;  // the stage whose PV is still to be issued
        advance();
        while (true) {
          sm90::mbar_wait(full(stage), phase);
          if (tile_of[stage] < 0) break;
          load_mask(kbits, mask_of + 4 * stage);
          sm90::bar_sync(1 + wg, 256);
          sm90::wgmma_fence();
          issue_s<D>(s, dq, k_tile(stage));
          issue_pv<D>(o, pa, v_tile(prev));
          sm90::bar_arrive(2 - wg, 256);
          sm90::wgmma_wait<1>();  // S(j) is done; PV(j-1) may still run
          sm90::fence_regs(s);
          softmax_tile(s, kbits, qd, sl2, m, alpha, rs);  // under PV(j-1)
          sm90::wgmma_wait<0>();  // PV(j-1) is done: V(j-1) and P(j-1) are free
          sm90::fence_regs(o);
          if (lane == 0) sm90::mbar_arrive(empty(prev));
#pragma unroll
          for (int j = 0; j < kNO; ++j) o[j] *= alpha[(j / 2) % 2];
#pragma unroll
          for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
          pack_probabilities(pa, s);
          prev = stage;
          advance();
        }
        if (lane == 0) sm90::mbar_arrive(q_empty(qb));  // every S is done
        sm90::wgmma_fence();
        issue_pv<D>(o, pa, v_tile(prev));
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        if (lane == 0) sm90::mbar_arrive(empty(prev));
      } else if (lane == 0) {
        sm90::mbar_arrive(q_empty(qb));
      }
      if (lane == 0) sm90::mbar_arrive(empty(stage));  // the sentinel's stage
      advance();

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      auto* out = static_cast<__nv_bfloat16*>(a.out) + w.b * a.o_sb + w.h * a.o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w.row0 + wg * 64 + warp * 16 + g + 8 * r;
        if (row >= a.M) continue;
        const bool row_ok = a.qmask == nullptr || a.qmask[w.b * a.qmask_sb + row] != 0;
        const bool keep = row_ok && l[r] > 0.f;
        const float inv = keep ? 1.f / l[r] : 0.f;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const __nv_bfloat162 val =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
          *reinterpret_cast<__nv_bfloat162*>(out + row * a.o_sn + j * 8 + 2 * qd) = val;
        }
      }
    }
    if (wg == 0) sm90::bar_sync(1, 256);  // warpgroup 1's last hand-over
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

inline int max_rows(const AttnDirs& dirs, int n_dirs) {
  return n_dirs == 2 && dirs.d[1].M > dirs.d[0].M ? dirs.d[1].M : dirs.d[0].M;
}

template <int D>
cudaError_t launch_f32(const AttnDirs& dirs, int n_dirs, int BH, cudaStream_t stream) {
  constexpr int kSmem = F32Smem<D>::kBytes;
  cudaError_t err = allow_shared_memory<attention_f32_kernel<D>>(kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((max_rows(dirs, n_dirs) + kF32Rows - 1) / kF32Rows, BH, n_dirs);
  attention_f32_kernel<D><<<grid, kF32Threads, kSmem, stream>>>(dirs);
  return cudaGetLastError();
}

// Blocks of the f32 body resident on one SM at head dim D (0 if D is not
// taken): the occupancy its shared memory and registers allow.
inline int f32_blocks_per_sm(int D) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32 && (err = allow_shared_memory<attention_f32_kernel<32>>(F32Smem<32>::kBytes)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attention_f32_kernel<32>, kF32Threads,
                                                        F32Smem<32>::kBytes);
  if (D == 64 && (err = allow_shared_memory<attention_f32_kernel<64>>(F32Smem<64>::kBytes)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attention_f32_kernel<64>, kF32Threads,
                                                        F32Smem<64>::kBytes);
  return err == cudaSuccess ? n : 0;
}

template <int D>
cudaError_t launch_wgmma(const AttnDirs& dirs, int n_dirs, int B, cudaStream_t stream) {
  WgmmaParams p;
  p.dirs = dirs;
  p.n_dirs = n_dirs;
  p.bh = B * dirs.d[0].H;
  p.q_tiles = (max_rows(dirs, n_dirs) + kQRows - 1) / kQRows;
  for (int z = 0; z < n_dirs; ++z) {
    const AttnArgs& a = dirs.d[z];
    cudaError_t err =
        sm90::encode_rows(&p.q[z], a.q, D, a.M, a.H, B, a.q_sn, a.q_sh, a.q_sb, kQRows);
    if (err == cudaSuccess)
      err = sm90::encode_rows(&p.k[z], a.k, D, a.N, a.H, B, a.k_sn, a.k_sh, a.k_sb, kKeys);
    if (err == cudaSuccess)
      err = sm90::encode_rows(&p.v[z], a.v, D, a.N, a.H, B, a.v_sn, a.v_sh, a.v_sb, kKeys);
    if (err != cudaSuccess) return err;
  }
  constexpr int kSmem = WgmmaSmem<D>::kBytes;
  cudaError_t err = allow_shared_memory<attention_wgmma_kernel<D>>(kSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_items = n_dirs * p.bh * p.q_tiles;  // one persistent block per SM at most
  attention_wgmma_kernel<D><<<n_items < sms ? n_items : sms, kWgmmaThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// One launch over `n_dirs` (1 or 2) directions of a batch of B. dtype: 0 =
// float32, 1 = bfloat16. Head dims other than 32 and 64 are refused (the
// wrappers check first). The bf16 body reads by TMA and the f32 body by
// 16-byte cp.async: both need 16-byte aligned base pointers and strides that
// are positive multiples of 16 bytes (the wrappers make such copies when
// needed).
inline cudaError_t launch_attention(const AttnDirs& dirs, int n_dirs, int B, int D, int dtype,
                                    cudaStream_t stream) {
  const int BH = B * dirs.d[0].H;
  if (dtype == 0 && D == 32) return launch_f32<32>(dirs, n_dirs, BH, stream);
  if (dtype == 0 && D == 64) return launch_f32<64>(dirs, n_dirs, BH, stream);
  if (dtype == 1 && D == 32) return launch_wgmma<32>(dirs, n_dirs, B, stream);
  if (dtype == 1 && D == 64) return launch_wgmma<64>(dirs, n_dirs, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace gf
