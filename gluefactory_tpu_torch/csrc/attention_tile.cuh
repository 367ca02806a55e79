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
//   - bf16 (every path), `attention_wgmma_kernel`, written for Hopper:
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
//   - f32, `attention_kernel`: one thread per query row, f32 FMAs on the
//     CUDA cores, K/V tiles of 32 keys in shared memory; blockIdx.z picks
//     the direction. Exact f32 arithmetic; on no path.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_utils.cuh"
#include "hopper.cuh"

namespace gf {

constexpr int kRowsPerBlock = 64;  // f32 body: query rows per block
constexpr int kKeysPerTile = 32;   // f32 body: keys staged per step

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
// f32 body: one thread per query row
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kRowsPerBlock)
    attention_kernel(const __grid_constant__ AttnDirs dirs) {
  constexpr int BQ = kRowsPerBlock;
  constexpr int BK = kKeysPerTile;
  __shared__ __align__(16) float tile_q[BQ][D + 1];  // +1: conflict-free row reads
  __shared__ __align__(16) float tile_k[BK][D];
  __shared__ __align__(16) float tile_v[BK][D];
  __shared__ float key_ok[BK];

  const AttnArgs& a = dirs.d[blockIdx.z];
  const int row0 = blockIdx.x * BQ;
  if (row0 >= a.M) return;  // the shorter direction's grid ends earlier
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int t = threadIdx.x;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;

  // coalesced load of the query tile, then one row into each thread
  for (int e = t; e < BQ * D; e += BQ) {
    const int r = e / D, d = e % D, row = row0 + r;
    tile_q[r][d] = row < a.M ? to_f32(q[row * a.q_sn + d]) : 0.f;
  }
  __syncthreads();
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = tile_q[t][d];
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < a.N; j0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = t; e < BK * D; e += BQ) {
      const int r = e / D, d = e % D, key = j0 + r;
      const bool in = key < a.N;
      tile_k[r][d] = in ? to_f32(k[key * a.k_sn + d]) : 0.f;
      tile_v[r][d] = in ? to_f32(v[key * a.v_sn + d]) : 0.f;
    }
    bool ok = false;
    if (t < BK) {
      const int key = j0 + t;
      ok = key < a.N && (a.kmask == nullptr || a.kmask[b * a.kmask_sb + key] != 0);
      key_ok[t] = ok ? 1.f : 0.f;
    }
    // barrier, and skip a tile whose keys are all masked (uniform per block)
    if (!__syncthreads_or(ok)) continue;

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], tile_k[j][d], dot);
      s[j] = key_ok[j] != 0.f ? dot * a.scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile with a valid key
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);  // masked key: exp(-inf) = 0
      l += p;
      const float pv = to_f32(from_f32<T>(p));  // probability in V's dtype
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pv, tile_v[j][d], acc[d]);
    }
    m = m_new;
  }

  const int row = row0 + t;
  const bool row_ok =
      row < a.M && (a.qmask == nullptr || a.qmask[b * a.qmask_sb + row] != 0);
  const bool keep = row_ok && l > 0.f;
  const float den = fmaxf(l, 1e-30f);
  __syncthreads();  // every thread has read its query row out of tile_q
#pragma unroll
  for (int d = 0; d < D; ++d) tile_q[t][d] = keep ? acc[d] / den : 0.f;
  __syncthreads();
  for (int e = t; e < BQ * D; e += BQ) {
    const int r = e / D, d = e % D, orow = row0 + r;
    if (orow < a.M) out[orow * a.o_sn + d] = from_f32<T>(tile_q[r][d]);
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

template <typename T, int D>
cudaError_t launch_f32(const AttnDirs& dirs, int n_dirs, int BH, cudaStream_t stream) {
  const dim3 grid((max_rows(dirs, n_dirs) + kRowsPerBlock - 1) / kRowsPerBlock, BH, n_dirs);
  attention_kernel<T, D><<<grid, kRowsPerBlock, 0, stream>>>(dirs);
  return cudaGetLastError();
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
// wrappers check first). The bf16 body reads by TMA: 16-byte aligned base
// pointers and strides that are positive multiples of 16 bytes (the
// wrappers make such copies when needed).
inline cudaError_t launch_attention(const AttnDirs& dirs, int n_dirs, int B, int D, int dtype,
                                    cudaStream_t stream) {
  const int BH = B * dirs.d[0].H;
  if (dtype == 0 && D == 32) return launch_f32<float, 32>(dirs, n_dirs, BH, stream);
  if (dtype == 0 && D == 64) return launch_f32<float, 64>(dirs, n_dirs, BH, stream);
  if (dtype == 1 && D == 32) return launch_wgmma<32>(dirs, n_dirs, B, stream);
  if (dtype == 1 && D == 64) return launch_wgmma<64>(dirs, n_dirs, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace gf
