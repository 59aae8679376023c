// K1: fused world->local transform + cutoff positional encoding + NeRF MLP
// forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel anerf_tpu/kernels/fused_render.py:
// fused_encode_mlp_pts (kernel body _render_kernel_pts, _transform_tile,
// _forward_trace). Python side: anerf_torch/kernels/fused_render.py, whose
// fused_encode_mlp_pts_ref is the plain PyTorch version of this function.
//
// What bounds it on an H100: operations. At the flagship width (8x256
// trunk with one 688-wide skip layer, 256 feature, 928->128 view layer)
// the MLP is about 864k multiply-adds = 1.728 MFLOP per point, i.e.
// 0.453 TFLOP for a 4096-ray bucket at S=64 and 0.566 TFLOP at S=80,
// about 1.03 ms per bucket at the 989 TFLOP/s bf16 dense peak. Device
// memory traffic is about 28 B per point (12 B of points in, 16 B of raw
// out) plus per-ray operands and ~1.8 MB of weights that stay in L2.
//
// Design (simple first; wgmma, TMA and persistent CTAs come later):
//  * One CTA of 8 warps per tile of TM = 64 points of the flattened
//    (R*S) axis. A point finds its ray as p / S and reads the per-ray
//    rotation columns and aux row directly (no per-ray expansion tricks).
//  * Phase A, CUDA cores, fp32: transform into the 24 joint frames,
//    distances v, unit bone directions r, the window
//    w = 1 - sigmoid(tau (v - cut)) = 1 / (1 + exp(tau (v - cut))), the
//    windowed kp bands and the windowed view bands (accurate sincosf and
//    expf; never the fast intrinsics, whose error grows outside
//    [-pi, pi]), cast to bf16 into shared memory in embed() row order.
//  * Phase B, tensor cores: every MMA layer runs mma.sync.m16n8k16 with
//    bf16 operands and fp32 accumulators; activations stay in shared
//    memory as bf16 and reach the MMAs through ldmatrix. Each warp owns
//    W/8 output columns of all 64 rows, so each weight element is read
//    once per CTA, straight from global memory (L2). The weight fetch is
//    what limits this design: the wrapper packs every weight block in
//    MMA fragment order (see load_b), so a warp takes a k-step of its
//    fragments with one coalesced 16-byte load per lane and pair of
//    n-tiles, PF k-steps ahead in a register ring.
//  * The 3-wide rgb and 1-wide alpha heads are fp32 dot products.
// Shared memory: 64 x (440 + 680 + 2 x 264) bf16 + 64 x 24 fp32 windows =
// 217 KB at the flagship sizes, so one CTA per SM, opted in with
// cudaFuncSetAttribute. Row strides are odd multiples of 16 bytes, which
// makes the ldmatrix row reads bank-conflict free.
// The device code is in fused_render_common.cuh, which K2 shares.

#include "fused_render_common.cuh"

extern "C" {

// Launch K1 on `stream`. Returns a cudaError_t code (0 on success).
int anerf_fused_encode_mlp_pts(const float* pts, const float* m_all,
                               const float* aux, const void* wts,
                               const float* bias, const float* w_rgb,
                               const float* w_alpha, const float* b_out,
                               const float* cut, float* out, int P, int S,
                               int depth, int skip_mask, int nfk, int nfv,
                               float tau, void* stream) {
  const Dims d = make_dims(nfk, nfv);
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      fused_encode_mlp_pts_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (P + TM - 1) / TM;
  fused_encode_mlp_pts_kernel<false><<<grid, NTHREADS, smem,
                                       (cudaStream_t)stream>>>(
      pts, m_all, aux, reinterpret_cast<const bf16*>(wts), bias, w_rgb,
      w_alpha, b_out, cut, out, P, S, depth, skip_mask, nfk, nfv, tau,
      nullptr);
  return (int)cudaGetLastError();
}

const char* anerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
