// fused_attention: masked softmax(q k^T / sqrt(D)) v for LightGlue's
// self-attention and SuperGlue's attention (replaces `fused_attention` /
// `_attn_kernel` of gluefactory_tpu/ops/pallas_attention.py). Kernel
// bodies, design and bound: attention_tile.cuh (one direction per launch).
// Plain C interface, loaded with ctypes by
// gluefactory_tpu_torch/ops/cuda_attention.py.

#include "attention_tile.cuh"

// q (B,H,M,D), k/v (B,H,N,D), out (B,H,M,D) with element strides
// strides[0..11] = q, k, v, out as (batch, head, token); strides[12..13] =
// kmask, qmask batch strides. Returns a cudaError_t (0 = launched).
extern "C" int gf_fused_attention(const void* q, const void* k, const void* v,
                                  const void* kmask, const void* qmask, void* out,
                                  const long long* strides, int B, int H, int M,
                                  int N, int D, float scale, int dtype,
                                  void* stream) {
  gf::AttnDirs dirs;
  gf::AttnArgs& a = dirs.d[0];
  a.q = q;
  a.k = k;
  a.v = v;
  a.kmask = static_cast<const uint8_t*>(kmask);
  a.qmask = static_cast<const uint8_t*>(qmask);
  a.out = out;
  a.q_sb = strides[0], a.q_sh = strides[1], a.q_sn = strides[2];
  a.k_sb = strides[3], a.k_sh = strides[4], a.k_sn = strides[5];
  a.v_sb = strides[6], a.v_sh = strides[7], a.v_sn = strides[8];
  a.o_sb = strides[9], a.o_sh = strides[10], a.o_sn = strides[11];
  a.kmask_sb = strides[12];
  a.qmask_sb = strides[13];
  a.H = H;
  a.M = M;
  a.N = N;
  a.scale = scale;
  return static_cast<int>(gf::launch_attention(dirs, 1, B, D, dtype,
                                               static_cast<cudaStream_t>(stream)));
}

// Blocks of the f32 body resident on one SM at head dim D (0 if D is not
// taken), by the occupancy calculator.
extern "C" int gf_fused_attention_f32_blocks_per_sm(int D) { return gf::f32_blocks_per_sm(D); }
