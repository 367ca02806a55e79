// log_sinkhorn: `iters` rounds of log-domain Sinkhorn normalisation of a
// batch of coupling matrices, returning Z + u + v in f32 (replaces
// `log_sinkhorn_pallas` / `_sinkhorn_kernel` of
// gluefactory_tpu/ops/pallas_sinkhorn.py). Plain C interface, loaded with
// ctypes by gluefactory_tpu_torch/ops/cuda_sinkhorn.py.
//
//   u = log_mu - LSE_rows(Z + v),  v = log_nu - LSE_cols(Z + u),  u0 = v0 = 0.
//
// Bound at SuperGlue's shapes (B = 4, M = N = 2049, 50 iterations): the
// 2 * 50 * 4 * 2049^2 = 1.68e9 exponentials on the special-function units
// (0.40 ms on an H100 SXM), not the 134 MB of Z read and written once
// (0.04 ms). The TPU kernel holds one (M, N) matrix in VMEM for the whole
// loop. A first design here re-read Z from device memory on every row and
// column pass (101 launches, 6.7 GB per call at these shapes).
//
// Design: one persistent cooperative launch, one block per SM, Z on chip.
//   - The grid's shared memory holds about 30 MB, one item's Z 16.8 MB. A
//     block owns `rows` whole rows of an item and loads the first
//     `resident` of them into its shared memory once; they stay there for
//     every iteration, and the block writes its rows of Z + u + v at the
//     end. Rows beyond `resident` (an item larger than the grid's shared
//     memory, above about 2700^2) are read from device memory on each pass.
//     The grid takes `groups` items at once (several when they are small),
//     the rest one round after another. The host computes this plan
//     (ops/cuda_sinkhorn.py::sinkhorn_plan) and passes it in.
//   - Row step, local: u_i = log_mu_i - LSE_j(Z_ij + v_j) over the block's
//     own rows, with v (8 KB) staged in shared memory. One warp a row, one
//     exponential per element: ex2.approx of (x - shift) * log2(e). From
//     the second iteration on, the shift is last iteration's LSE of the row
//     plus the largest rise of any v_j, an upper bound of this iteration's
//     max, so one pass of exponentials suffices; where that bound is too
//     loose (a sum below 2^-50, or a shift that is not finite) the row takes
//     the exact two passes, a max then the exponentials. Rows in shared
//     memory are padded to a multiple of 4 floats (-inf in Z, 0 in v) and
//     read as float4, four independent sums a lane.
//   - Column step, two grid barriers: each block writes a (shift, sum)
//     partial per column over its own rows (a thread a column, the rows
//     unrolled so their loads are in flight together; the shift the
//     column's partial LSE of last iteration plus the largest rise of any
//     u_i, with the same exact fallback); barrier; each block merges the
//     partials of its own slice of columns, reading each block's partials
//     of 16 columns as one contiguous run (a lane a column, strided by N,
//     would cost an L2 sector a load), and writes v; barrier. So an
//     iteration costs two barriers, not two launches, and Z never leaves
//     the chip.
//   - The barrier is a hand-written arrive counter: a release add, then
//     acquire spins of one thread a block, as CUTLASS's generic barrier.
//     cooperative_groups' grid sync was slower
//     (scripts_dev/kernel_variants.py, variant grid_sync), and so was a
//     flag per block that every block polled whole. Data that crosses
//     blocks goes through L2 (ld.cg / st.cg), never a stale L1 line.
// The result keeps the TPU kernel's guard max(m, -1e30)
// (`pallas_sinkhorn.py:30`): a row or column whose entries are all -inf
// gives an LSE of -inf, never exp(-inf - -inf). A NaN entry is not skipped:
// it makes its sum NaN, as in torch.logsumexp.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 256;  // blocks an item (8 partials a thread in the merge)
constexpr int kMergeCols = 16;   // columns a merge pass takes
constexpr float kMaxFloor = -1e30f;
constexpr float kMinSum = 8.8817842e-16f;  // 2^-50: a shifted sum below it is recomputed exactly
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* Z;       // (B, M, N)
  const float* log_mu;  // (B, M)
  const float* log_nu;  // (B, N)
  float* v;             // (B, N), zeros on entry
  float* pm;            // (grid, N) partial maxima (floored at -1e30)
  float* ps;            // (grid, N) partial sums of exp(x - max)
  unsigned* counter;    // zero on entry
  float* out;           // (B, M, N)
  int B, M, N, ldz;     // ldz: a row's stride in shared memory (N rounded up to 4)
  int iters;
  int groups, blocks, rows, resident;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// (m, s) := the log-sum-exp merge of (m, s) with the lane `off` away, for a
// sum s of exp(x - m) and m >= -1e30 (so m - max is never NaN)
__device__ __forceinline__ void lse_merge_shfl(float& m, float& s, int off) {
  const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
  const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
  const float mm = fmaxf(m, m2);
  s = s * ex2((m - mm) * kLog2e) + s2 * ex2((m2 - mm) * kLog2e);
  m = mm;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// All blocks of the grid have arrived here; their writes before it are seen
// after it. Barrier k (counted in `target`) completes when the counter
// reaches k x the grid; a wait of more than 2^34 clocks (about 9 s) can only
// be a protocol fault and traps, so the launch fails instead of hanging the
// card.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
    unsigned seen;
    long long start = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > (1ll << 34)) {
        __trap();
      }
    }
  }
  __syncthreads();
}

// kVShared: v is staged in shared memory for the row step (it fits there
// unless N is very large); otherwise the row step reads it through L2 and
// every step takes its exact two passes.
template <bool kVShared>
__global__ void __launch_bounds__(kThreads, 1) sinkhorn_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = p.M, N = p.N, ldz = p.ldz;
  const int group = blockIdx.x / p.blocks, k = blockIdx.x % p.blocks;
  const int r0 = k * p.rows;
  const int nrows = max(0, min(p.rows, M - r0));
  const int nres = min(nrows, p.resident);
  float* zs = smem;                                             // resident rows x ldz
  float* vs = zs + static_cast<long long>(p.resident) * ldz;    // v: ldz, if kVShared
  float* cs = vs + (kVShared ? ldz : 0);                        // column LSEs: ldz, if kVShared
  float* us = cs + (kVShared ? ldz : 0);                        // u: rows
  float* dus = us + p.rows;                                     // u's last change: rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __shared__ float red_m[kWarps * kMergeCols], red_s[kWarps * kMergeCols];
  __shared__ float red_v[kWarps];
  const int cpb = (N + p.blocks - 1) / p.blocks;                // merged columns per block
  const int c0 = min(N, k * cpb), c1 = min(N, c0 + cpb);
  const long long part0 = static_cast<long long>(group) * p.blocks * N;
  unsigned target = 0;
  const int rounds = (p.B + p.groups - 1) / p.groups;

  for (int round = 0; round < rounds; ++round) {
    const int item = round * p.groups + group;
    const bool active = item < p.B;  // every block takes every barrier
    const float* zg = p.Z + (static_cast<long long>(item) * M + r0) * N;  // own rows
    float* vg = p.v + static_cast<long long>(item) * N;
    if (active) {
      for (int i = 0; i < nres; ++i) {
        const float* zr = zg + static_cast<long long>(i) * N;
        float* zd = zs + static_cast<long long>(i) * ldz;
        for (int j = tid; j < ldz; j += kThreads) zd[j] = j < N ? __ldg(zr + j) : -INFINITY;
      }
      for (int i = tid; i < nrows; i += kThreads) us[i] = 0.f;
    }
    __syncthreads();

    for (int it = 0; it < p.iters; ++it) {
      // ---- row step: u_i = log_mu_i - LSE_j(Z_ij + v_j), a warp a row
      if (active) {
        float dv_max = -INFINITY;  // max_j of v's last change
        if constexpr (kVShared) {
          float d = -INFINITY;
          for (int j = tid; j < ldz; j += kThreads) {
            const float v = j < N ? __ldcg(vg + j) : 0.f;
            if (j < N) d = fmaxf(d, v - vs[j]);
            vs[j] = v;
          }
          d = warp_max(d);
          if (lane == 0) red_v[warp] = d;
          __syncthreads();
#pragma unroll
          for (int w = 0; w < kWarps; ++w) dv_max = fmaxf(dv_max, red_v[w]);
        }
        for (int i = warp; i < nrows; i += kWarps) {
          // issued first, so that its latency hides under the passes
          const float mu = __ldg(p.log_mu + static_cast<long long>(item) * M + r0 + i);
          const float u_old = us[i];
          float mg = 0.f, s = 0.f;
          bool done = false;
          if (kVShared && i < nres) {
            const float4* z4 = reinterpret_cast<const float4*>(zs + static_cast<long long>(i) * ldz);
            const float4* v4 = reinterpret_cast<const float4*>(vs);
            const int n4 = ldz / 4;
            // one pass, shifted by last iteration's LSE plus v's largest
            // rise: no term exceeds 1; too loose a shift (a sum below
            // kMinSum) falls back to the exact two passes
            const float shift = (mu - u_old) + dv_max;
            if (it > 0 && shift > kMaxFloor && shift < INFINITY) {
              float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
              for (int c = lane; c < n4; c += 32) {
                const float4 a = z4[c], b = v4[c];
                s0 += ex2((a.x + b.x - shift) * kLog2e), s1 += ex2((a.y + b.y - shift) * kLog2e);
                s2 += ex2((a.z + b.z - shift) * kLog2e), s3 += ex2((a.w + b.w - shift) * kLog2e);
              }
              s = warp_sum((s0 + s1) + (s2 + s3));  // the same in every lane
              mg = shift;
              done = s >= kMinSum && s < INFINITY;
            }
            if (!done) {
              float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
#pragma unroll 4
              for (int c = lane; c < n4; c += 32) {
                const float4 a = z4[c], b = v4[c];
                m0 = fmaxf(m0, a.x + b.x), m1 = fmaxf(m1, a.y + b.y);
                m2 = fmaxf(m2, a.z + b.z), m3 = fmaxf(m3, a.w + b.w);
              }
              mg = fmaxf(warp_max(fmaxf(fmaxf(m0, m1), fmaxf(m2, m3))), kMaxFloor);
              float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
              for (int c = lane; c < n4; c += 32) {
                const float4 a = z4[c], b = v4[c];
                s0 += ex2((a.x + b.x - mg) * kLog2e), s1 += ex2((a.y + b.y - mg) * kLog2e);
                s2 += ex2((a.z + b.z - mg) * kLog2e), s3 += ex2((a.w + b.w - mg) * kLog2e);
              }
              s = warp_sum((s0 + s1) + (s2 + s3));
            }
          } else {
            // a row read from device memory on each pass, or v read through
            // L2: the same shifted pass when v is staged, else two passes
            const float* z = i < nres ? zs + static_cast<long long>(i) * ldz
                                      : zg + static_cast<long long>(i) * N;
            auto vj = [&](int j) {
              if constexpr (kVShared) return vs[j];
              else return __ldcg(vg + j);
            };
            const float shift = (mu - u_old) + dv_max;
            if (kVShared && it > 0 && shift > kMaxFloor && shift < INFINITY) {
#pragma unroll 4
              for (int j = lane; j < N; j += 32) s += ex2((z[j] + vj(j) - shift) * kLog2e);
              s = warp_sum(s);
              mg = shift;
              done = s >= kMinSum && s < INFINITY;
            }
            if (!done) {
              float m = -INFINITY;
#pragma unroll 4
              for (int j = lane; j < N; j += 32) m = fmaxf(m, z[j] + vj(j));
              mg = fmaxf(warp_max(m), kMaxFloor);
              s = 0.f;
#pragma unroll 4
              for (int j = lane; j < N; j += 32) s += ex2((z[j] + vj(j) - mg) * kLog2e);
              s = warp_sum(s);
            }
          }
          if (lane == 0) {
            const float u = mu - (mg + logf(s));
            us[i] = u;
            dus[i] = u - u_old;
          }
        }
      }
      __syncthreads();
      // ---- column partials over the block's rows: (max, sum of exp(x - max)),
      // or (shift, sum of exp(x - shift)) with the shift last iteration's
      // partial LSE plus u's largest rise, as in the row step; a thread a
      // column
      if (active) {
        float du_max = -INFINITY;
        for (int i = 0; i < nrows; ++i) du_max = fmaxf(du_max, dus[i]);
        auto zsh = [&](int i, int j) { return zs[static_cast<long long>(i) * ldz + j]; };
        auto zgl = [&](int i, int j) { return __ldg(zg + static_cast<long long>(i) * N + j); };
        // the exact two passes for column j
        auto exact = [&](int j, float& mg, float& s) {
          float m = -INFINITY;
          int i = 0;
#pragma unroll 8
          for (; i < nres; ++i) m = fmaxf(m, zsh(i, j) + us[i]);
#pragma unroll 4
          for (; i < nrows; ++i) m = fmaxf(m, zgl(i, j) + us[i]);
          mg = fmaxf(m, kMaxFloor);
          s = 0.f;
#pragma unroll 8
          for (i = 0; i < nres; ++i) s += ex2((zsh(i, j) + us[i] - mg) * kLog2e);
#pragma unroll 4
          for (; i < nrows; ++i) s += ex2((zgl(i, j) + us[i] - mg) * kLog2e);
        };
        for (int j = tid; j < N; j += kThreads) {
          float mg = 0.f, s = 0.f;
          bool done = false;
          if constexpr (kVShared) {
            mg = cs[j] + du_max;
            if (it > 0 && mg > kMaxFloor && mg < INFINITY) {
              int i = 0;
#pragma unroll 8
              for (; i < nres; ++i) s += ex2((zsh(i, j) + us[i] - mg) * kLog2e);
#pragma unroll 4
              for (; i < nrows; ++i) s += ex2((zgl(i, j) + us[i] - mg) * kLog2e);
              done = s >= kMinSum && s < INFINITY;
            }
          }
          if (!done) exact(j, mg, s);
          if constexpr (kVShared) cs[j] = mg + logf(s);
          __stcg(p.pm + static_cast<long long>(blockIdx.x) * N + j, mg);
          __stcg(p.ps + static_cast<long long>(blockIdx.x) * N + j, s);
        }
      }
      grid_barrier(p.counter, target);
      // ---- merge the partials of the block's columns: v_j = log_nu_j - LSE.
      // A pass takes 16 columns: thread t reads the partials of column t % 16
      // from blocks t / 16, t / 16 + 32, ... (16 threads read 64 contiguous
      // bytes of a block's partials), merges them, and the 32 threads of a
      // column combine through a shuffle and shared memory.
      if (active) {
        const int col = tid % kMergeCols, bgrp = tid / kMergeCols;
        for (int cc = c0; cc < c1; cc += kMergeCols) {
          const int j = cc + col;
          const bool last = tid < kMergeCols && j < c1;  // the thread that writes v_j
          const float nu = last ? __ldg(p.log_nu + static_cast<long long>(item) * N + j) : 0.f;
          float m = kMaxFloor, s = 0.f, pmv[kMaxBlocks / 32], psv[kMaxBlocks / 32];
#pragma unroll
          for (int q = 0; q < kMaxBlocks / 32; ++q) {
            const int b = bgrp + 32 * q;
            const bool ok = j < c1 && b < p.blocks;
            const long long at = part0 + static_cast<long long>(b) * N + j;
            pmv[q] = ok ? __ldcg(p.pm + at) : kMaxFloor;
            psv[q] = ok ? __ldcg(p.ps + at) : 0.f;
            m = fmaxf(m, pmv[q]);
          }
#pragma unroll
          for (int q = 0; q < kMaxBlocks / 32; ++q) s += psv[q] * ex2((pmv[q] - m) * kLog2e);
          lse_merge_shfl(m, s, kMergeCols);  // the two block groups of a warp
          if (lane < kMergeCols) {
            red_m[warp * kMergeCols + col] = m;
            red_s[warp * kMergeCols + col] = s;
          }
          __syncthreads();
          if (last) {
            for (int w = 1; w < kWarps; ++w) {
              const float m2 = red_m[w * kMergeCols + col], mm = fmaxf(m, m2);
              s = s * ex2((m - mm) * kLog2e) + red_s[w * kMergeCols + col] * ex2((m2 - mm) * kLog2e);
              m = mm;
            }
            __stcg(vg + j, nu - (m + logf(s)));
          }
          __syncthreads();
        }
      }
      grid_barrier(p.counter, target);
    }

    // ---- out = Z + u + v over the block's rows (v is zero without iterations)
    if (active) {
      if constexpr (kVShared) {
        for (int j = tid; j < N; j += kThreads) vs[j] = __ldcg(vg + j);
        __syncthreads();
      }
      for (int i = 0; i < nrows; ++i) {
        const float* z = i < nres ? zs + static_cast<long long>(i) * ldz
                                  : zg + static_cast<long long>(i) * N;
        float* o = p.out + (static_cast<long long>(item) * M + r0 + i) * N;
        const float ui = us[i];
        for (int j = tid; j < N; j += kThreads) {
          float v;
          if constexpr (kVShared) v = vs[j];
          else v = __ldcg(vg + j);
          o[j] = z[j] + ui + v;
        }
      }
    }
    __syncthreads();  // before the next round overwrites the rows
  }
}

template <bool kVShared>
cudaError_t launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  auto kernel = sinkhorn_kernel<kVShared>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Params arg = p;
  void* args[] = {&arg};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(kThreads),
                                     args, static_cast<size_t>(smem), stream);
}

}  // namespace

// Z (B, M, N), log_mu (B, M), log_nu (B, N), out (B, M, N): contiguous f32.
// Scratch: v (B, N) and the counter zeroed, pm and ps (groups * blocks, N).
// The plan (ops/cuda_sinkhorn.py::sinkhorn_plan): `groups` items at once,
// `blocks` (at most 256) blocks an item, `rows` rows a block, the first
// `resident` of them in shared memory (rows padded to a multiple of 4
// floats); v_shared: v and the column LSEs in shared memory; smem: the
// dynamic shared memory of a block. One cooperative launch on `stream`.
// Returns a cudaError_t (0 = launched).
extern "C" int gf_log_sinkhorn(const void* Z, const void* log_mu, const void* log_nu, void* v,
                               void* pm, void* ps, void* counter, void* out, int B, int M, int N,
                               int iters, int groups, int blocks, int rows, int resident,
                               int v_shared, int smem, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || iters < 0 || groups <= 0 || blocks <= 0 ||
      blocks > kMaxBlocks || rows <= 0 || resident < 0 || resident > rows ||
      static_cast<long long>(blocks) * rows < M)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(Z), static_cast<const float*>(log_mu),
           static_cast<const float*>(log_nu), static_cast<float*>(v), static_cast<float*>(pm),
           static_cast<float*>(ps), static_cast<unsigned*>(counter), static_cast<float*>(out),
           B, M, N, (N + 3) / 4 * 4, iters, groups, blocks, rows, resident};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = groups * blocks;
  const cudaError_t err = v_shared ? launch<true>(p, grid, smem, s) : launch<false>(p, grid, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
