// Masked softmax attention over one (batch*head, 64-row query tile) per
// thread block: the kernel bodies shared by fused_attention.cu and
// fused_bidirectional_attention.cu.
//
// Replaces the TPU kernels `_attn_kernel` / `_bidir_kernel` of
// gluefactory_tpu/ops/pallas_attention.py. The TPU kernel keeps all of K and
// V resident in VMEM and forms a (512, N) logit block; here a block owns 64
// query rows, streams K/V through shared memory in tiles, and keeps an
// online softmax (running max m, running sum l) in registers, so no logit
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
// Bound on an H100 at the LightGlue shapes (B*H = 32, M = N = 2048, D = 64,
// bf16): 4*B*H*M*N*D = 34 GFLOP against 34 MB of inputs and outputs, so the
// work is bound by operations (tensor cores: 0.035 ms at 989 TFLOP/s).
//
// Two bodies:
//   - bf16 (the main path), `attention_mma_kernel`: 4 warps, 16 query rows
//     each; QK^T and PV on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     f32 accumulate); K/V tiles of 64 keys double-buffered in shared memory
//     with cp.async; the S accumulators turn into the PV A-operand in
//     registers, rounded to bf16 there.
//   - f32, `attention_kernel`: one thread per query row, f32 FMAs on the
//     CUDA cores, K/V tiles of 32 keys in shared memory. Exact f32
//     arithmetic; not on the main path.
// wgmma/TMA and warp specialisation are the known next steps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_utils.cuh"

namespace gf {

constexpr int kRowsPerBlock = 64;  // query rows per block
constexpr int kKeysPerTile = 32;   // f32 body: keys staged per step

// Strides are in elements; the last (feature) dimension is contiguous.
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

// ---------------------------------------------------------------------------
// f32 body: one thread per query row
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kRowsPerBlock) attention_kernel(AttnArgs a) {
  constexpr int BQ = kRowsPerBlock;
  constexpr int BK = kKeysPerTile;
  __shared__ __align__(16) float tile_q[BQ][D + 1];  // +1: conflict-free row reads
  __shared__ __align__(16) float tile_k[BK][D];
  __shared__ __align__(16) float tile_v[BK][D];
  __shared__ float key_ok[BK];

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int row0 = blockIdx.x * BQ;
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
// bf16 body: tensor cores (mma.sync m16n8k16), cp.async double buffering
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;                 // 16 query rows per warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaKeys = 64;                 // keys per K/V tile
constexpr int kPad = 8;                      // bf16 of row padding: conflict-free ldmatrix

// Rows of `rows` x D bf16 from global (row stride `sn` elements) into shared
// memory with row stride D + kPad; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long sn, int row0, int rows, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = row0 + r;
    const bool in = row < limit;
    cp_async_16(dst + r * (D + kPad) + col, src + (in ? row : 0) * sn + col, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) attention_mma_kernel(AttnArgs a) {
  constexpr int BQ = kRowsPerBlock;
  constexpr int BK = kMmaKeys;
  constexpr int LD = D + kPad;
  constexpr int KD = D / 16;   // k-steps of QK^T over the head dim
  constexpr int NS = BK / 8;   // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;    // n-tiles of O (8 dims each)
  __shared__ __align__(16) __nv_bfloat16 sq[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 sk[2][BK * LD];
  __shared__ __align__(16) __nv_bfloat16 sv[2][BK * LD];

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int row0 = blockIdx.x * BQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;  // mma fragment row group / column pair
  const auto* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const auto* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const auto* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  auto* out = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
  const uint8_t* kmask = a.kmask == nullptr ? nullptr : a.kmask + b * a.kmask_sb;
  const int n_tiles = (a.N + BK - 1) / BK;

  load_rows_async<D>(sq, q, a.q_sn, row0, BQ, a.M);
  load_rows_async<D>(sk[0], k, a.k_sn, 0, BK, a.N);
  load_rows_async<D>(sv[0], v, a.v_sn, 0, BK, a.N);
  cp_async_commit();

  uint32_t qf[KD][4];  // this warp's 16 query rows as A fragments
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's columns; reduced at the end
  const float scale_log2 = a.scale * 1.4426950408889634f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_rows_async<D>(sk[buf ^ 1], k, a.k_sn, (t + 1) * BK, BK, a.N);
      load_rows_async<D>(sv[buf ^ 1], v, a.v_sn, (t + 1) * BK, BK, a.N);
    }
    cp_async_commit();  // possibly empty: keeps one group per step
    cp_async_wait_1();  // tile t (and on t == 0 the query tile) has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], sq + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }

    // validity of this thread's 16 key columns: 8*j + 2*tq + {0, 1}
    const int key0 = t * BK;
    uint32_t ok = 0;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * tq + e;
        const bool valid = key < a.N && (kmask == nullptr || kmask[key] != 0);
        ok |= uint32_t(valid) << (2 * j + e);
      }
    // every warp covers all 64 keys: the skip is warp-uniform
    if (__any_sync(0xffffffffu, ok != 0)) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kt = sk[buf];
#pragma unroll
      for (int jj = 0; jj < NS; jj += 2) {  // two n-tiles of keys per ldmatrix
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t kb[4];
          const int key = jj * 8 + (lane / 16) * 8 + lane % 8;
          const int col = kk * 16 + ((lane / 8) % 2) * 8;
          ldmatrix_x4(kb, kt + key * LD + col);
          mma_bf16(s[jj], qf[kk], kb[0], kb[1]);
          mma_bf16(s[jj + 1], qf[kk], kb[2], kb[3]);
        }
      }
      // scale, mask, running max per row (4 threads share a row)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = (ok >> (2 * j + (e & 1))) & 1u;
          s[j][e] = valid ? s[j][e] * scale_log2 : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile has a valid key
        alpha[r] = exp2f(m[r] - m_new);           // 0 on the first valid tile
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // probabilities: l sums them unrounded, PV takes them rounded to bf16
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
        const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        // S n-tiles 2kk and 2kk+1 form the A fragment of PV k-step kk
        pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      const __nv_bfloat16* vt = sv[buf];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < NO; jj += 2) {  // two n-tiles of dims per ldmatrix
          uint32_t vb[4];
          const int key = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
          const int col = jj * 8 + (lane / 16) * 8;
          ldmatrix_x4_trans(vb, vt + key * LD + col);
          mma_bf16(o[jj], pf[kk], vb[0], vb[1]);
          mma_bf16(o[jj + 1], pf[kk], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // buffer `buf` is free for the load of tile t + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= a.M) continue;
    const bool row_ok = a.qmask == nullptr || a.qmask[b * a.qmask_sb + row] != 0;
    const bool keep = row_ok && l[r] > 0.f;
    const float inv = keep ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const __nv_bfloat162 val =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(out + row * a.o_sn + j * 8 + 2 * tq) = val;
    }
  }
}

template <typename T, int D>
cudaError_t launch_typed(const AttnArgs& a, int BH, cudaStream_t stream) {
  const dim3 grid((a.M + kRowsPerBlock - 1) / kRowsPerBlock, BH);
  attention_kernel<T, D><<<grid, kRowsPerBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const AttnArgs& a, int BH, cudaStream_t stream) {
  const dim3 grid((a.M + kRowsPerBlock - 1) / kRowsPerBlock, BH);
  attention_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Head dims other than 32 and 64 are
// refused (the wrappers check first). The bf16 body needs 16-byte aligned
// rows: base pointers and token strides that are multiples of 8 elements
// (the wrappers make such copies when needed).
inline cudaError_t launch_attention(const AttnArgs& a, int BH, int D, int dtype,
                                    cudaStream_t stream) {
  if (dtype == 0 && D == 32) return launch_typed<float, 32>(a, BH, stream);
  if (dtype == 0 && D == 64) return launch_typed<float, 64>(a, BH, stream);
  if (dtype == 1 && D == 32) return launch_mma<32>(a, BH, stream);
  if (dtype == 1 && D == 64) return launch_mma<64>(a, BH, stream);
  return cudaErrorInvalidValue;
}

}  // namespace gf
