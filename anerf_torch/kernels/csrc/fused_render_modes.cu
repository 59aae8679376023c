// K3-v1 and K4-v1: the other input modes of K1-v1's kernel body
// (fused_render_common.cuh), for Hopper (sm_90a): K3's and K4's first
// kernels. K3 and K4 themselves are now K1's sm90 kernel in these modes
// (fused_render_sm90.cu); these stay as the comparison that chip_smoke.py
// measures them against, and no path of the port calls them. K1-v1's
// library (fused_render.cu) stays a library of its own.
//
// K3 replaces the Pallas TPU kernel anerf_tpu/kernels/fused_render.py:
// fused_encode_mlp (kernel body _render_kernel): the cutoff PE and the MLP
// from pre-transformed per-point inputs [v | r | d | fc]. The TPU layout
// is a (P, 512) f32 row of four 128-lane segments; here a point's row is
// its 184 live floats (anerf_torch/kernels/fused_render.py:
// build_raw_inputs). Python side: fused_encode_mlp_v1 /
// fused_encode_mlp_ref.
//
// K4 replaces anerf_tpu/kernels/fused_mlp.py:fused_mlp_apply (_kernel_entry,
// _mlp_chain): the MLP alone on embedded inputs, bf16 rows of any widths
// k0 and kv. Python side: anerf_torch/kernels/fused_mlp.py
// (fused_mlp_apply_v1).
//
// What bounds them on an H100: K3 and K4 do K1's MLP, so operations (about
// 1.03 ms of bf16 tensor-core work per 4096-ray bucket at S = 64 + 80);
// K3 moves 752 B and K4 2,208 B a point, inputs and output (0.13 and 0.39
// ms of HBM time per bucket), below that.
//
// Design: the same CTA, tile, shared-memory layout and phase B as K1-v1. K3
// replaces the transform with loads of v, r, d and fc from the point's row
// (each load of a view channel is per point, as the TPU kernel had no ray
// structure either). K4's phase A is a copy of the bf16 rows.

#include "fused_render_common.cuh"

namespace {

template <int MODE>
int launch(const float* a, const float* m_all, const float* b,
           const void* wts, const float* bias, const float* w_rgb,
           const float* w_alpha, const float* b_out, const float* cut,
           float* out, int P, int S, int depth, int skip_mask, int nfk,
           int nfv, float tau, void* stream) {
  const Dims d = body_dims<MODE>(nfk, nfv);
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      fused_encode_mlp_pts_kernel<false, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_encode_mlp_pts_kernel<false, MODE>
      <<<(P + TM - 1) / TM, NTHREADS, smem, (cudaStream_t)stream>>>(
          a, m_all, b, reinterpret_cast<const bf16*>(wts), bias, w_rgb,
          w_alpha, b_out, cut, out, P, S, depth, skip_mask, nfk, nfv, tau,
          nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 on `stream`: x (P, 184) f32 rows [v | r | d | fc] -> out (P, 4).
// Returns a cudaError_t code (0 on success).
int anerf_fused_encode_mlp_raw(const float* x, const void* wts,
                               const float* bias, const float* w_rgb,
                               const float* w_alpha, const float* b_out,
                               const float* cut, float* out, int P,
                               int depth, int skip_mask, int nfk, int nfv,
                               float tau, void* stream) {
  return launch<IN_RAW>(x, nullptr, nullptr, wts, bias, w_rgb, w_alpha,
                        b_out, cut, out, P, 1, depth, skip_mask, nfk, nfv,
                        tau, stream);
}

// K4 on `stream`: x0 (P, k0) and xv (P, kv) bf16 -> out (P, 4).
int anerf_fused_mlp(const void* x0, const void* xv, const void* wts,
                    const float* bias, const float* w_rgb,
                    const float* w_alpha, const float* b_out, float* out,
                    int P, int depth, int skip_mask, int k0, int kv,
                    void* stream) {
  return launch<IN_EMBEDDED>(
      reinterpret_cast<const float*>(x0), nullptr,
      reinterpret_cast<const float*>(xv), wts, bias, w_rgb, w_alpha, b_out,
      nullptr, out, P, 1, depth, skip_mask, k0, kv, 0.f, stream);
}

const char* anerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
