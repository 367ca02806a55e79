// fused_bidirectional_attention: LightGlue's shared-QK cross-attention in
// both directions, in one launch (replaces `fused_bidirectional_attention`
// / `_bidir_kernel` of gluefactory_tpu/ops/pallas_attention.py):
//   m0 = rowsoftmax(sim, columns masked by mask1) v1,
//   m1 = colsoftmax(sim, rows masked by mask0)^T v0,   sim = qk0 qk1^T / sqrt(D),
// with masked query rows zeroed and fully masked opposite sets giving 0.
//
// Bound on an H100 SXM at LightGlue's shapes (B*H = 16, M = N = 2048,
// D = 64, bf16): the function needs three matmuls, 25.8 GFLOP (0.026 ms at
// 989 TFLOP/s), and two softmaxes of B*H*M*N = 67M exponentials each: 134M,
// 0.032 ms on the special-function units (16 per SM per clock x 132 SMs x
// 1.98 GHz). The exponentials, not the products, set the bound. This
// kernel's four matmuls (34.4 GFLOP, 0.035 ms) run beside them.
//
// Design: the Hopper attention body of attention_tile.cuh (TMA producer
// warp, two wgmma consumer warpgroups, softmax under the products by
// pipelining and ping-pong, persistent blocks) with the direction as one
// more coordinate of its work items:
//   z = 0: queries qk0, keys qk1, values v1, key mask mask1, query mask
//          mask0 -> out0 (rows of sim);
//   z = 1: queries qk1, keys qk0, values v0, key mask mask0, query mask
//          mask1 -> out1 (rows of sim^T = qk1 qk0^T are the columns of sim).
// Items span the longer side; those past the shorter side's rows are
// skipped. (The f32 body: a third grid axis, blocks past the rows exit.)
//
// Four matmuls, not the TPU's three: the TPU forms sim once and carries the
// column softmax across its in-order grid. Blocks on this card run in no
// order, so a column softmax over row tiles would need an N x D f32 partial
// per 128-row tile through device memory (about 134 MB at these shapes,
// ~0.08 ms to write and read) to save one 8.6 GFLOP matmul (~0.009 ms).
// Recomputing sim^T in the second direction is the cheaper choice.

#include "attention_tile.cuh"

// qk0/v0/out0 (B,H,M,D), qk1/v1/out1 (B,H,N,D) with element strides
// strides[0..17] = qk0, qk1, v0, v1, out0, out1 as (batch, head, token);
// strides[18..19] = mask0, mask1 batch strides. Returns a cudaError_t.
extern "C" int gf_fused_bidirectional_attention(
    const void* qk0, const void* qk1, const void* v0, const void* v1,
    const void* mask0, const void* mask1, void* out0, void* out1,
    const long long* strides, int B, int H, int M, int N, int D, float scale,
    int dtype, void* stream) {
  gf::AttnDirs dirs;
  gf::AttnArgs& rows = dirs.d[0];  // m0: queries qk0, keys qk1, values v1
  rows.q = qk0;
  rows.k = qk1;
  rows.v = v1;
  rows.kmask = static_cast<const uint8_t*>(mask1);
  rows.qmask = static_cast<const uint8_t*>(mask0);
  rows.out = out0;
  rows.q_sb = strides[0], rows.q_sh = strides[1], rows.q_sn = strides[2];
  rows.k_sb = strides[3], rows.k_sh = strides[4], rows.k_sn = strides[5];
  rows.v_sb = strides[9], rows.v_sh = strides[10], rows.v_sn = strides[11];
  rows.o_sb = strides[12], rows.o_sh = strides[13], rows.o_sn = strides[14];
  rows.kmask_sb = strides[19];
  rows.qmask_sb = strides[18];
  rows.H = H;
  rows.M = M;
  rows.N = N;
  rows.scale = scale;

  gf::AttnArgs& cols = dirs.d[1];  // m1: queries qk1, keys qk0, values v0
  cols.q = qk1;
  cols.k = qk0;
  cols.v = v0;
  cols.kmask = static_cast<const uint8_t*>(mask0);
  cols.qmask = static_cast<const uint8_t*>(mask1);
  cols.out = out1;
  cols.q_sb = strides[3], cols.q_sh = strides[4], cols.q_sn = strides[5];
  cols.k_sb = strides[0], cols.k_sh = strides[1], cols.k_sn = strides[2];
  cols.v_sb = strides[6], cols.v_sh = strides[7], cols.v_sn = strides[8];
  cols.o_sb = strides[15], cols.o_sh = strides[16], cols.o_sn = strides[17];
  cols.kmask_sb = strides[18];
  cols.qmask_sb = strides[19];
  cols.H = H;
  cols.M = N;
  cols.N = M;
  cols.scale = scale;
  return static_cast<int>(gf::launch_attention(dirs, 2, B, D, dtype,
                                               static_cast<cudaStream_t>(stream)));
}
