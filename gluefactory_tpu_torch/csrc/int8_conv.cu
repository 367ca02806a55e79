// int8_conv / int8_bmm: s8 x s8 -> s32 products on the tensor cores, for
// SuperPoint's `quantize: int8` dense pass and LightGlue's
// `int8_similarity` (the counterparts of gluefactory_tpu/ops/int8_conv.py::
// int8_conv and of the int8 einsum in gluefactory_tpu/models/matchers/
// lightglue.py::MatchAssignment). Plain C interface, loaded with ctypes by
// gluefactory_tpu_torch/ops/int8_conv.py.
//
// No TPU kernel is replaced: the JAX package leaves both products to XLA,
// which lowers int8 operands with an int32 result onto the TPU's matrix
// unit. PyTorch has no CUDA int8 convolution, so the port brings its own.
//
// Bound at bench's shapes (8 images of 1024^2, channels 64/64/128/128,
// heads 256): ~1.42 T int8 operations a dense pass, 0.72 ms at the H100's
// 1979 dense TOPS; the bytes of int8 in and out once a layer are fewer
// (ops/int8_conv.py::dense_pass_work counts both). This first kernel is
// simple and exact, not fast:
//
//   - One core for both entry points: an implicit GEMM, `mma.sync.aligned.
//     m16n8k32.row.col.s32.s8.s8.s32`, 256 threads a block, a 128 x 64
//     output tile (8 warps of 32 x 32), K in steps of 64 bytes through two
//     shared-memory stages filled by 16-byte cp.async with zero fill (the
//     image border, K past its end, rows past M or N). Rows are padded to 80
//     bytes, so the fragment reads hit 32 distinct banks.
//   - int8_conv: A is the NHWC int8 activation gathered as im2col rows on
//     the fly (K ordered (ky, kx, cin), SAME padding, stride 1); B is the
//     weight quantized per output channel and packed (Cout, Kp), Kp = K
//     rounded up to 64 with zeros. A block's 128 rows are 2 image rows x 64
//     columns, so a 2x2 pool lies inside one block. cin a multiple of 16
//     loads 16 bytes at once; any other cin (conv1a: cin = 1, K = 9) is
//     gathered byte by byte. The epilogue is JAX's, rounded as it is and
//     never contracted into an FMA:
//         y = (f32(acc) * (s_x * s_w[c])) + b[c],  then ReLU,
//     written f32 through a shared-memory tile, max-pooled 2x2 there where
//     the layer is followed by a pool, and folded into one global max|y| by
//     an atomic max on the float's bits (|y| >= 0 orders as its bits), one
//     atomic a block. The max covers every pixel, also a row or column the
//     VALID pool drops, as JAX's per-tensor scale does.
//   - The global max over the batch needs the whole tensor, so a second
//     launch (`requant_kernel`) quantizes: s = max(absmax, 1e-12) * (1/127)
//     (XLA rewrites JAX's division by the constant 127 into this product),
//     q = clip(round_half_even(y / s), -127, 127). Pooling before the
//     rounding is exact: rounding is monotone, so max(q(a), q(b)) =
//     q(max(a, b)). With requant off the second launch writes y as bf16.
//   - int8_bmm: A = q0 (B, M, D), B = q1 (B, N, D), both row-major (D a
//     multiple of 16); the epilogue dequantizes with the outer product of
//     the row scales in JAX's order: f32(acc) * ((s0[m] * s1[n]) * c).
// A debug output (`acc`) writes the raw int32 accumulators of a conv,
// which the checks hold to the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output rows (pixels or tokens) a block
constexpr int kBN = 64;       // output columns (channels or tokens) a block
constexpr int kBK = 64;       // K bytes a stage
constexpr int kLd = kBK + 16; // shared row stride in bytes
constexpr int kThreads = 256;
constexpr int kTileCols = 64; // a conv block's pixels: 2 rows x 64 columns
constexpr int kYLd = kBN + 4; // epilogue tile stride in floats
constexpr int kStageBytes = (kBM + kBN) * kLd;
constexpr int kSmemBytes = (2 * kStageBytes > kBM * kYLd * 4) ? 2 * kStageBytes : kBM * kYLd * 4;
constexpr float kInv127 = 1.0f / 127.0f;

enum Gather { kConvVec = 0, kConvByte = 1, kRows = 2 };

struct Params {
  const int8_t* a;      // conv: x8 (B, H, W, cin); bmm: q0 (B, M, D)
  const int8_t* b;      // conv: w8 packed (cout, kp); bmm: q1 (B, N, D)
  int batch, H, W, cin, ksize, pad;
  int M, N, K;          // bmm: M, N, D; conv: N = cout, K = kp
  int kvalid;           // conv: ksize^2 * cin; bmm: D
  int tiles_w, tiles_h; // conv: blocks along W and H
  // conv epilogue
  const float* s_x;     // device scalar
  const float* s_w;     // (cout)
  const float* bias;    // (cout) or null
  int relu, pool;
  float* y;             // (B, H, W, cout) or pooled (B, H/2, W/2, cout)
  unsigned* absmax;     // max |y| as float bits, or null
  int32_t* acc;         // raw accumulators (B, H, W, cout), or null
  // bmm epilogue
  const float* s0;
  const float* s1;
  float c;
  float* sim;           // (B, M, N)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row r (0..127) of a block's tile: its pixel (b, y, x), or its token.
struct RowPos {
  int b, y, x;
  bool valid;
};

__device__ __forceinline__ RowPos conv_row(const Params& p, int r) {
  const int tx = blockIdx.x % p.tiles_w;
  const int rest = blockIdx.x / p.tiles_w;
  const int ty = rest % p.tiles_h;
  RowPos pos;
  pos.b = rest / p.tiles_h;
  pos.y = ty * 2 + r / kTileCols;
  pos.x = tx * kTileCols + r % kTileCols;
  pos.valid = pos.y < p.H && pos.x < p.W;
  return pos;
}

// One A chunk of 16 bytes: row r, K bytes [k0, k0 + 16), into `dst`.
template <int G>
__device__ __forceinline__ void load_a(const Params& p, const RowPos& pos, int row_token, int k0,
                                       uint8_t* dst) {
  if (G == kRows) {
    const bool ok = row_token < p.M && k0 < p.K;
    const int8_t* src = ok ? p.a + ((static_cast<long long>(blockIdx.z) * p.M + row_token) * p.K + k0) : p.a;
    cp_async16(smem_u32(dst), src, ok);
  } else if (G == kConvVec) {
    bool ok = pos.valid && k0 < p.kvalid;
    const int8_t* src = p.a;
    if (ok) {
      const int tap = k0 / p.cin;
      const int c0 = k0 - tap * p.cin;
      const int iy = pos.y + tap / p.ksize - p.pad;
      const int ix = pos.x + tap % p.ksize - p.pad;
      ok = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      if (ok) src = p.a + ((static_cast<long long>(pos.b) * p.H + iy) * p.W + ix) * p.cin + c0;
    }
    cp_async16(smem_u32(dst), src, ok);
  } else {  // byte gather: any cin
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (pos.valid) {
      for (int e = 0; e < 16; ++e) {
        const int k = k0 + e;
        if (k >= p.kvalid) break;
        const int tap = k / p.cin;
        const int c = k - tap * p.cin;
        const int iy = pos.y + tap / p.ksize - p.pad;
        const int ix = pos.x + tap % p.ksize - p.pad;
        if (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) continue;
        const uint32_t v = static_cast<uint8_t>(
            p.a[((static_cast<long long>(pos.b) * p.H + iy) * p.W + ix) * p.cin + c]);
        w[e >> 2] |= v << (8 * (e & 3));
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) igemm_kernel(const Params p) {
  __shared__ __align__(16) uint8_t smem[kSmemBytes];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int n0 = blockIdx.y * kBN;
  const int m0 = (G == kRows) ? blockIdx.x * kBM : 0;

  // this thread's loads: A rows ra and ra + 64, chunk ja; B row rb, chunk jb
  const int ra = tid >> 2, ja = tid & 3;
  RowPos pa[2];
  for (int i = 0; i < 2; ++i) {
    if (G == kRows) {
      pa[i] = RowPos{0, 0, 0, true};
    } else {
      pa[i] = conv_row(p, ra + 64 * i);
    }
  }
  const int rb = tid >> 2, jb = tid & 3;
  const int nb = n0 + rb;
  const long long b_row = (G == kRows) ? (static_cast<long long>(blockIdx.z) * p.N + nb) : nb;
  const int ldb = p.K;  // packed weights: kp bytes a row; bmm: D

  auto stage_a = [&](int s) { return smem + s * kStageBytes; };
  auto stage_b = [&](int s) { return smem + s * kStageBytes + kBM * kLd; };

  auto load_stage = [&](int s, int kt) {
    const int kbase = kt * kBK;
    for (int i = 0; i < 2; ++i) {
      const int r = ra + 64 * i;
      load_a<G>(p, pa[i], m0 + r, kbase + 16 * ja, stage_a(s) + r * kLd + 16 * ja);
    }
    const int kb = kbase + 16 * jb;
    const bool ok = nb < p.N && kb < p.K;
    const int8_t* src = ok ? p.b + b_row * ldb + kb : p.b;
    cp_async16(smem_u32(stage_b(s) + rb * kLd + 16 * jb), src, ok);
  };

  int32_t acc[2][4][4];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j)
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (p.K + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* As = stage_a(kt & 1);
    const uint8_t* Bs = stage_b(kt & 1);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* base = As + (32 * wm + 16 * mi + g) * kLd + 32 * ks + 4 * t;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* base = Bs + (32 * wn + 8 * ni + g) * kLd + 32 * ks + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if (G == kRows) {
    // dequantized similarity, straight from the fragments
    const long long zb = blockIdx.z;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 32 * wm + 16 * mi + g + 8 * (e >> 1);
          const int n = n0 + 32 * wn + 8 * ni + 2 * t + (e & 1);
          if (m < p.M && n < p.N) {
            const float sc = __fmul_rn(__fmul_rn(p.s0[zb * p.M + m], p.s1[zb * p.N + n]), p.c);
            p.sim[(zb * p.M + m) * p.N + n] = __fmul_rn(static_cast<float>(acc[mi][ni][e]), sc);
          }
        }
    return;
  }

  // conv epilogue: y (or the raw accumulators) into the shared tile
  float* Ys = reinterpret_cast<float*>(smem);
  const float s_x = p.acc == nullptr ? *p.s_x : 0.0f;
  float amax = 0.0f;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nl = 32 * wn + 8 * ni + 2 * t + h;
      const int n = n0 + nl;
      const bool nok = n < p.N;
      float sxw = 0.0f, bias = 0.0f;
      if (nok && p.acc == nullptr) {
        sxw = __fmul_rn(s_x, p.s_w[n]);
        bias = p.bias != nullptr ? p.bias[n] : 0.0f;
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = 32 * wm + 16 * mi + g + 8 * v;
          const int32_t a = acc[mi][ni][2 * v + h];
          if (p.acc != nullptr) {
            Ys[r * kYLd + nl] = __int_as_float(a);
            continue;
          }
          float y = __fmul_rn(static_cast<float>(a), sxw);
          if (p.bias != nullptr) y = __fadd_rn(y, bias);
          if (p.relu) y = fmaxf(y, 0.0f);
          Ys[r * kYLd + nl] = y;
          const RowPos pos = conv_row(p, r);
          if (nok && pos.valid) amax = fmaxf(amax, fabsf(y));
        }
    }
  if (p.absmax != nullptr) {
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  __syncthreads();  // the tile is whole (and the fragments' stage reads are over)
  __shared__ float warp_max[kThreads / 32];
  if (p.absmax != nullptr) {
    if (lane == 0) warp_max[warp] = amax;
  }

  const int cout = p.N;
  if (!p.pool) {
    for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
      const int r = idx / kBN, nl = idx % kBN;
      const int n = n0 + nl;
      const RowPos pos = conv_row(p, r);
      if (n >= cout || !pos.valid) continue;
      const long long o = ((static_cast<long long>(pos.b) * p.H + pos.y) * p.W + pos.x) * cout + n;
      if (p.acc != nullptr) {
        p.acc[o] = __float_as_int(Ys[r * kYLd + nl]);
      } else {
        p.y[o] = Ys[r * kYLd + nl];
      }
    }
  } else {
    const int Hp = p.H / 2, Wp = p.W / 2;
    for (int idx = tid; idx < (kTileCols / 2) * kBN; idx += kThreads) {
      const int pc = idx / kBN, nl = idx % kBN;
      const int n = n0 + nl;
      const RowPos pos = conv_row(p, 2 * pc);  // the window's top-left pixel
      const int py = pos.y / 2, px = pos.x / 2;
      if (n >= cout || py >= Hp || px >= Wp) continue;
      const float* row0 = Ys + (2 * pc) * kYLd + nl;
      const float* row1 = Ys + (kTileCols + 2 * pc) * kYLd + nl;
      const float v = fmaxf(fmaxf(row0[0], row0[kYLd]), fmaxf(row1[0], row1[kYLd]));
      p.y[((static_cast<long long>(pos.b) * Hp + py) * Wp + px) * cout + n] = v;
    }
  }
  if (p.absmax != nullptr) {
    __syncthreads();
    if (tid == 0) {
      float m = warp_max[0];
      for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
      atomicMax(p.absmax, __float_as_uint(m));
    }
  }
}

// The second pass: y (n f32) -> int8 codes with the scale of the global
// max, and that scale; or y -> bf16 when `q` is null.
__global__ void __launch_bounds__(256)
    requant_kernel(const float* y, long long n, const unsigned* absmax, int8_t* q, float* s_out,
                   __nv_bfloat16* out) {
  float s = 0.0f;
  if (q != nullptr) {
    s = __fmul_rn(fmaxf(__uint_as_float(*absmax), 1e-12f), kInv127);
    if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = n / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(y)[i];
    if (q != nullptr) {
      const float vals[4] = {v.x, v.y, v.z, v.w};
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(vals[e], s)), -127.0f), 127.0f);
        packed |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xffu) << (8 * e);
      }
      reinterpret_cast<uint32_t*>(q)[i] = packed;
    } else {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
  // the tail past the last group of 4
  const long long i = 4 * n4 + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    if (q != nullptr) {
      q[i] = static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(y[i], s)), -127.0f), 127.0f));
    } else {
      out[i] = __float2bfloat16_rn(y[i]);
    }
  }
}

template <int G>
cudaError_t launch_igemm(const Params& p, dim3 grid, cudaStream_t stream) {
  igemm_kernel<G><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Conv + epilogue, one launch. x8 (B, H, W, cin) int8 NHWC; w8 (cout, kp)
// int8, K ordered (ky, kx, cin), zero past ksize^2 * cin; s_x a device
// scalar; s_w, bias (cout) f32 (bias may be null). Writes y f32 (B, H, W,
// cout), or (B, H/2, W/2, cout) with `pool`, and folds max|y| into *absmax
// (zeroed by the caller; null: not needed); or, with `acc` not null, the
// raw int32 accumulators (B, H, W, cout) and nothing else.
extern "C" int gf_int8_conv(const void* x8, const void* w8, const void* s_x, const void* s_w,
                            const void* bias, void* y, void* absmax, void* acc, int B, int H, int W,
                            int cin, int ksize, int cout, int kp, int relu, int pool,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || ksize <= 0 || ksize % 2 == 0 ||
      kp % kBK != 0 || kp < ksize * ksize * cin || (acc != nullptr && pool))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.a = static_cast<const int8_t*>(x8);
  p.b = static_cast<const int8_t*>(w8);
  p.batch = B;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.ksize = ksize;
  p.pad = ksize / 2;
  p.N = cout;
  p.K = kp;
  p.kvalid = ksize * ksize * cin;
  p.tiles_w = (W + kTileCols - 1) / kTileCols;
  p.tiles_h = (H + 1) / 2;
  p.s_x = static_cast<const float*>(s_x);
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.relu = relu;
  p.pool = pool;
  p.y = static_cast<float*>(y);
  p.absmax = static_cast<unsigned*>(absmax);
  p.acc = static_cast<int32_t*>(acc);
  const long long tiles = static_cast<long long>(B) * p.tiles_h * p.tiles_w;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), (cout + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cin % 16 == 0 ? launch_igemm<kConvVec>(p, grid, s)
                                        : launch_igemm<kConvByte>(p, grid, s));
}

// The second launch: with q not null, q = int8 codes of y (n f32) at the
// scale of *absmax, and that scale into *s_out; else out = bf16(y).
extern "C" int gf_int8_requant(const void* y, long long n, const void* absmax, void* q, void* s_out,
                               void* out, void* stream) {
  if (n < 0 || (q != nullptr && (absmax == nullptr || s_out == nullptr)) || (q == nullptr && out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && q == nullptr) return static_cast<int>(cudaSuccess);
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  requant_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), n, static_cast<const unsigned*>(absmax), static_cast<int8_t*>(q),
      static_cast<float*>(s_out), static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// sim (B, M, N) f32 = f32(q0 @ q1^T) * ((s0[m] * s1[n]) * c); q0 (B, M, D),
// q1 (B, N, D) int8 row-major, D a multiple of 16; s0 (B, M), s1 (B, N).
extern "C" int gf_int8_bmm(const void* q0, const void* q1, const void* s0, const void* s1, float c,
                           void* sim, int B, int M, int N, int D, void* stream) {
  if (B <= 0 || M < 0 || N < 0 || D <= 0 || D % 16 != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  Params p{};
  p.a = static_cast<const int8_t*>(q0);
  p.b = static_cast<const int8_t*>(q1);
  p.M = M;
  p.N = N;
  p.K = D;
  p.kvalid = D;
  p.s0 = static_cast<const float*>(s0);
  p.s1 = static_cast<const float*>(s1);
  p.c = c;
  p.sim = static_cast<float*>(sim);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_igemm<kRows>(p, grid, static_cast<cudaStream_t>(stream)));
}
