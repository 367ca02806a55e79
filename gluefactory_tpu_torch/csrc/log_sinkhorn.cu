// log_sinkhorn: `iters` rounds of log-domain Sinkhorn normalisation of a
// batch of coupling matrices, returning Z + u + v in f32 (replaces
// `log_sinkhorn_pallas` / `_sinkhorn_kernel` of
// gluefactory_tpu/ops/pallas_sinkhorn.py). Plain C interface, loaded with
// ctypes by gluefactory_tpu_torch/ops/cuda_sinkhorn.py.
//
//   u = log_mu - LSE_rows(Z + v),  v = log_nu - LSE_cols(Z + u),  u0 = v0 = 0.
//
// The TPU kernel holds one (M, N) matrix in VMEM for the whole loop and
// takes the column pass as lse_rows(Z^T, u). Blocks on the H100 share no
// state within a launch, so each iteration is two launches on the stream,
// with u and v in a small global scratch:
//   - row pass: one warp per row, lanes stride the row (coalesced);
//   - column pass: a block owns a strip of 32 columns, its warps walk the
//     rows (each a row-major 128-byte read) with a running max and sum, and
//     the block merges the warps' partial sums in shared memory;
// and one final pass writes Z + u + v. Each lane keeps an online
// log-sum-exp (running max m, sum s of exp(x - m)), one exponential per
// element. The result keeps the TPU kernel's guard max(m, -1e30)
// (`pallas_sinkhorn.py:30`): a row whose entries are all -inf gives -inf
// and never exp(-inf - -inf).
//
// Bound at SuperGlue's shapes (B = 4, M = N = 2049, 50 iterations): the
// 2 * 50 * 4 * 2049^2 = 1.68e9 exponentials (special-function units), not
// the 134 MB of Z read and written once. This design re-reads Z from device
// memory on each pass (Z is 67 MB, more than the 50 MB L2): 100 passes of
// 67 MB, so it is bound by bytes in practice; keeping Z on chip across
// passes is the next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRowWarps = 8;   // rows per block in the row pass
constexpr int kColWarps = 16;  // row walkers per block in the column pass
constexpr float kMaxFloor = -1e30f;

struct Lse {
  float m;  // running max
  float s;  // sum of exp(x - m)
};

__device__ __forceinline__ void lse_push(Lse& a, float x) {
  if (x > a.m) {
    a.s = a.s * expf(a.m - x) + 1.f;
    a.m = x;
  } else if (x > -INFINITY) {
    a.s += expf(x - a.m);
  }
}

__device__ __forceinline__ Lse lse_merge(Lse a, Lse b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, 0.f};
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// log(sum exp(x)), written as the TPU kernel's mg + log(sum exp(x - mg))
// with mg = max(m, -1e30)
__device__ __forceinline__ float lse_value(Lse a) {
  const float mg = fmaxf(a.m, kMaxFloor);
  return mg + logf(a.s * expf(a.m - mg));
}

__device__ __forceinline__ Lse warp_merge(Lse a) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    Lse o{__shfl_xor_sync(0xffffffffu, a.m, off), __shfl_xor_sync(0xffffffffu, a.s, off)};
    a = lse_merge(a, o);
  }
  return a;
}

// u[b, i] = log_mu[b, i] - LSE_j(Z[b, i, j] + v[b, j]); one warp per row
__global__ void __launch_bounds__(kRowWarps * 32)
    sinkhorn_row_pass(const float* __restrict__ Z, const float* __restrict__ v,
                      const float* __restrict__ log_mu, float* __restrict__ u, int B, int M,
                      int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + warp;  // b * M + i
  if (row >= static_cast<long long>(B) * M) return;
  const float* z = Z + row * N;
  const float* vb = v + (row / M) * N;
  Lse a{-INFINITY, 0.f};
  int j = lane;
  for (; j + 96 < N; j += 128) {
    const float x0 = z[j] + vb[j], x1 = z[j + 32] + vb[j + 32];
    const float x2 = z[j + 64] + vb[j + 64], x3 = z[j + 96] + vb[j + 96];
    lse_push(a, x0);
    lse_push(a, x1);
    lse_push(a, x2);
    lse_push(a, x3);
  }
  for (; j < N; j += 32) lse_push(a, z[j] + vb[j]);
  a = warp_merge(a);
  if (lane == 0) u[row] = log_mu[row] - lse_value(a);
}

// v[b, j] = log_nu[b, j] - LSE_i(Z[b, i, j] + u[b, i]); a block owns 32
// columns, warp w walks rows w, w + kColWarps, ...
__global__ void __launch_bounds__(kColWarps * 32)
    sinkhorn_col_pass(const float* __restrict__ Z, const float* __restrict__ u,
                      const float* __restrict__ log_nu, float* __restrict__ v, int M, int N) {
  __shared__ float part_m[kColWarps][32];
  __shared__ float part_s[kColWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int col = blockIdx.x * 32 + lane;
  const float* z = Z + static_cast<long long>(b) * M * N + col;
  const float* ub = u + static_cast<long long>(b) * M;
  Lse a{-INFINITY, 0.f};
  if (col < N) {
    int i = warp;
    constexpr int S = kColWarps;
    for (; i + 3 * S < M; i += 4 * S) {
      const float x0 = z[static_cast<long long>(i) * N] + ub[i];
      const float x1 = z[static_cast<long long>(i + S) * N] + ub[i + S];
      const float x2 = z[static_cast<long long>(i + 2 * S) * N] + ub[i + 2 * S];
      const float x3 = z[static_cast<long long>(i + 3 * S) * N] + ub[i + 3 * S];
      lse_push(a, x0);
      lse_push(a, x1);
      lse_push(a, x2);
      lse_push(a, x3);
    }
    for (; i < M; i += S) lse_push(a, z[static_cast<long long>(i) * N] + ub[i]);
  }
  part_m[warp][lane] = a.m;
  part_s[warp][lane] = a.s;
  __syncthreads();
  if (warp != 0 || col >= N) return;
  for (int w = 1; w < kColWarps; ++w) a = lse_merge(a, {part_m[w][lane], part_s[w][lane]});
  const long long k = static_cast<long long>(b) * N + col;
  v[k] = log_nu[k] - lse_value(a);
}

// out = Z + u[:, :, None] + v[:, None, :]
__global__ void sinkhorn_finish(const float* __restrict__ Z, const float* __restrict__ u,
                                const float* __restrict__ v, float* __restrict__ out, int M,
                                int N, long long total) {
  const long long MN = static_cast<long long>(M) * N;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = e / MN;
    const long long i = (e / N) % M;
    const long long j = e % N;
    out[e] = Z[e] + u[b * M + i] + v[b * N + j];
  }
}

}  // namespace

// Z (B, M, N), log_mu (B, M), log_nu (B, N), out (B, M, N): contiguous f32.
// u (B, M) and v (B, N) are scratch that holds zeros on entry. Launches
// 2 * iters + 1 kernels on `stream`. Returns a cudaError_t (0 = launched).
extern "C" int gf_log_sinkhorn(const void* Z, const void* log_mu, const void* log_nu, void* u,
                               void* v, void* out, int B, int M, int N, int iters,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* z = static_cast<const float*>(Z);
  float* uf = static_cast<float*>(u);
  float* vf = static_cast<float*>(v);
  const float* mu = static_cast<const float*>(log_mu);
  const float* nu = static_cast<const float*>(log_nu);
  const long long rows = static_cast<long long>(B) * M;
  const dim3 row_grid(static_cast<unsigned>((rows + kRowWarps - 1) / kRowWarps));
  const dim3 col_grid((N + 31) / 32, B);
  for (int it = 0; it < iters; ++it) {
    sinkhorn_row_pass<<<row_grid, kRowWarps * 32, 0, s>>>(z, vf, mu, uf, B, M, N);
    sinkhorn_col_pass<<<col_grid, kColWarps * 32, 0, s>>>(z, uf, nu, vf, M, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = rows * N;
  const long long blocks = (total + 255) / 256;
  sinkhorn_finish<<<static_cast<unsigned>(blocks < 65535 * 16 ? blocks : 65535 * 16), 256, 0, s>>>(
      z, uf, vf, static_cast<float*>(out), M, N, total);
  return static_cast<int>(cudaGetLastError());
}
