// K2-v1: the first version of K2, the backward of K1 with f32 cotangent
// products, for Hopper (sm_90a): the comparison chip_smoke.py measures K2
// (fused_render_bwd_sm90.cu) against. No path of the port calls it.
//
// Replaces the Pallas TPU kernel anerf_tpu/kernels/fused_render.py:
// _fused_bwd_impl (kernel body _render_kernel_pts_bwd), the bwd_f32=True
// flavour. Python side: anerf_torch/kernels/fused_render.py:fused_bwd_v1,
// whose fused_bwd_ref is the plain PyTorch version of this function.
//
// What bounds it on an H100: operations. Per point it recomputes the
// forward (about 864k bf16 multiply-adds, tensor cores) and does about
// 1.73M f32 multiply-adds of cotangent products (dX = dY W and
// dW = X^T dY for every layer, layer 0's input gradient included: the
// pose path needs it), here on the CUDA cores: 1.02 TFLOP of f32 at
// N_rand = 2048 (S = 64 + 80), 15.2 ms at the 67 TFLOP/s fp32 peak.
//
// Design (a few simple kernels, each with a plain counterpart, all
// deterministic; no float atomics):
//  1. K1-v1's kernel body with SAVE = true (fused_render_common.cuh)
//     recomputes the forward exactly as K1-v1 does and writes every bf16
//     MLP input and activation: 2 * (k0p + kvp + (depth + 1) W + W/2)
//     bytes per point, 7,072 B at the flagship.
//  2. gemm_f32_kernel: a plain fp32 FMA GEMM tiled through shared memory
//     (128 x 128 tiles, 8 deep, 8 x 8 outputs a thread). As dX = dY W it
//     fuses the ReLU mask (from the saved bf16 activation, as the TPU
//     kernel's relu_mask(hb)) and an optional accumulate. As dW = X^T dY
//     it splits the point axis into chunks of `chunk` points and writes
//     one partial (K + 1) x N block per chunk (the extra row, a column of
//     ones in X, is the bias gradient); reduce_chunks_kernel then sums
//     the chunks in a fixed order.
//  3. pe_transform_bwd_kernel (fused_render_bwd_common.cuh, shared with
//     K2): one CTA per ray, the backward of the cutoff PE and of the
//     world->local transform in exact fp32 FMAs, then the per-ray sums.
// Every result is a function of the inputs alone: two calls give the
// same bits.

#include "fused_render_bwd_common.cuh"

namespace {

constexpr int GBM = 128, GBN = 128, GBK = 8, GTHREADS = 256;

struct GemmArgs {
  const void* A;     // dX: dY (M x K, row-major); dW: X (K x a_rows)
  long long lda;
  const float* B;    // K x N, row-major
  long long ldb;
  float* C;          // M x N (row stride ldc), one block per chunk
  long long ldc;
  int M, N, K;       // C is M x N; the reduction runs over K
  int kchunk;        // reduction rows per blockIdx.y (dW chunks)
  long long cstride; // elements between two chunks' C blocks
  int a_rows;        // dW: rows of C read from X; row a_rows may be ones
  int ones_row;      // dW: the bias row (A = 1 there), or -1
  const bf16* mask;  // dX: C = 0 where mask <= 0 (a saved activation)
  long long ldm;
  int accumulate;    // dX: C = (C + product), before the mask
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// C = A B in fp32. A_KMAJOR: A(m, k) = A[k * lda + m] (the saved bf16
// activations of dW = X^T dY); else A(m, k) = A[m * lda + k] (the f32
// cotangent of dX = dY W). B(k, n) = B[k * ldb + n].
template <typename TA, bool A_KMAJOR>
__global__ void __launch_bounds__(GTHREADS)
gemm_f32_kernel(GemmArgs a) {
  __shared__ __align__(16) float As[GBK][GBM];
  __shared__ __align__(16) float Bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int tiles_n = (a.N + GBN - 1) / GBN;
  const int m0 = (blockIdx.x / tiles_n) * GBM;
  const int n0 = (blockIdx.x % tiles_n) * GBN;
  const int kbeg = blockIdx.y * a.kchunk;
  const int kend = min(a.K, kbeg + a.kchunk);
  float* C = a.C + (long long)blockIdx.y * a.cstride;
  const TA* A = reinterpret_cast<const TA*>(a.A);
  const int tx = tid & 15, ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += GBK) {
    if constexpr (A_KMAJOR) {
      const int kk = tid >> 5, mm = (tid & 31) * 4, k = k0 + kk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mm + e;
        float v = 0.f;
        if (k < kend) {
          if (m < a.a_rows) v = to_f32(A[(long long)k * a.lda + m]);
          else if (m == a.ones_row) v = 1.f;
        }
        As[kk][mm + e] = v;
      }
    } else {
      const int mm = tid >> 1, kk = (tid & 1) * 4, m = m0 + mm;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + kk + e;
        As[kk + e][mm] = (m < a.M && k < kend)
                             ? to_f32(A[(long long)m * a.lda + k]) : 0.f;
      }
    }
    {
      const int kk = tid >> 5, nn = (tid & 31) * 4, k = k0 + kk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + nn + e;
        Bs[kk][nn + e] = (k < kend && n < a.N)
                             ? a.B[(long long)k * a.ldb + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= a.N) continue;
      float* c = C + (long long)m * a.ldc + n;
      float v = acc[i][j];
      if (a.accumulate) v += *c;
      if (a.mask != nullptr &&
          !(__bfloat162float(a.mask[(long long)m * a.ldm + n]) > 0.f))
        v = 0.f;
      *c = v;
    }
  }
}

// The launches of one backward, in order; each checks its launch.
struct Launcher {
  cudaStream_t stream;
  int P, chunk, n_chunk;
  float* partial;     // n_chunk x total
  long long total;
  cudaError_t err = cudaSuccess;

  // C (P x N) (+)= dY (P x K) B (K x N), then the ReLU mask.
  void dx(const float* dy, long long ldy, int K, const float* B,
          long long ldb, int N, float* C, long long ldc, const bf16* mask,
          long long ldm, bool accumulate) {
    if (err != cudaSuccess) return;
    GemmArgs a{dy, ldy, B, ldb, C, ldc, P, N, K, K, 0, 0, -1, mask, ldm,
               accumulate ? 1 : 0};
    const int tiles = ((P + GBM - 1) / GBM) * ((N + GBN - 1) / GBN);
    gemm_f32_kernel<float, false><<<tiles, GTHREADS, 0, stream>>>(a);
    err = cudaGetLastError();
  }

  // Rows [row0, row0 + rows (+ 1 bias row)) of the dW block at `off` in
  // every chunk's partial: X (P x rows, bf16, row stride ldx)^T dY.
  void dw(const bf16* X, long long ldx, int rows, bool bias, const float* dy,
          long long ldy, int N, long long off, int row0) {
    if (err != cudaSuccess) return;
    const int M = rows + (bias ? 1 : 0);
    GemmArgs a{X, ldx, dy, ldy, partial + off + (long long)row0 * N, N,
               M, N, P, chunk, total, rows, bias ? rows : -1, nullptr, 0, 0};
    const int tiles = ((M + GBM - 1) / GBM) * ((N + GBN - 1) / GBN);
    gemm_f32_kernel<bf16, true><<<dim3(tiles, n_chunk), GTHREADS, 0,
                                  stream>>>(a);
    err = cudaGetLastError();
  }
};

// The backward sequence.
int run_bwd(const float* pts, const float* m_all,
            const float* aux, const void* wts, const float* bias,
            const float* w_rgb, const float* w_alpha, const float* b_out,
            const float* cut, const float* w32, const float* g, void* act_v,
            float* raw, float* dhv, float* dview, float* dh_a, float* dh_b,
            float* dx0, float* partial, float* dW, float* dpts, float* dm,
            float* daux, int P, int S, int depth, int skip_mask, int nfk,
            int nfv, int chunk, float tau, void* stream_v) {
  cudaStream_t stream = (cudaStream_t)stream_v;
  const Dims d = make_dims(nfk, nfv);
  const ActLayout al = make_act_layout(d, depth);
  bf16* act = reinterpret_cast<bf16*>(act_v);
  const long long aw = al.width;

  // 1. recompute the forward, saving the bf16 activations
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      fused_encode_mlp_pts_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_encode_mlp_pts_kernel<true><<<(P + TM - 1) / TM, NTHREADS, smem,
                                      stream>>>(
      pts, m_all, aux, reinterpret_cast<const bf16*>(wts), bias, w_rgb,
      w_alpha, b_out, cut, raw, P, S, depth, skip_mask, nfk, nfv, tau, act);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // offsets of the dW blocks (rows K + 1, cols N) and of the f32 weights
  // (N x K) of every MMA layer, trunk first
  long long goff[34], woff[33];
  int kin[33];
  long long go = 0, wo = 0;
  for (int i = 0; i < depth + 2; ++i) {
    int K, N = W;
    if (i == 0) K = d.k0p;
    else if (i < depth && ((skip_mask >> (i - 1)) & 1)) K = d.k0p + W;
    else if (i <= depth) K = W;
    else { K = W + d.kvp; N = WV; }
    kin[i] = K;
    goff[i] = go;
    woff[i] = wo;
    go += (long long)(K + 1) * N;
    wo += (long long)N * K;
  }
  const long long g_rgb = go, g_alpha = go + (WV + 1) * 3;
  const long long total = g_alpha + (W + 1);
  const int n_chunk = (P + chunk - 1) / chunk;
  Launcher L{stream, P, chunk, n_chunk, partial, total};
  const bf16* h_last = act + al.h + (depth - 1) * W;
  const int iF = depth, iV = depth + 1;
  const long long ldv = W + d.kvp;

  // 2. heads and view layer
  L.dw(act + al.hv, aw, WV, true, g, 4, 3, g_rgb, 0);
  L.dw(h_last, aw, W, true, g + 3, 4, 1, g_alpha, 0);
  L.dx(g, 4, 3, w_rgb, WV, WV, dhv, WV, act + al.hv, aw, false);
  L.dw(act + al.feat, aw, W, false, dhv, WV, WV, goff[iV], 0);
  L.dw(act + al.xv, aw, d.kvp, true, dhv, WV, WV, goff[iV], W);
  L.dx(dhv, WV, WV, w32 + woff[iV], ldv, (int)ldv, dview, ldv, nullptr, 0,
       false);
  // 3. feature layer (no activation) and the alpha head's input cotangent
  L.dw(h_last, aw, W, true, dview, ldv, W, goff[iF], 0);
  L.dx(g + 3, 4, 1, w_alpha, W, W, dh_a, W, nullptr, 0, false);
  L.dx(dview, ldv, W, w32 + woff[iF], W, W, dh_a, W, h_last, aw, true);
  // 4. trunk, last layer first
  float* cur = dh_a;
  float* nxt = dh_b;
  bool dx0_set = false;
  for (int i = depth - 1; i >= 1; --i) {
    const bf16* h_prev = act + al.h + (i - 1) * W;
    const float* wi = w32 + woff[i];
    if ((skip_mask >> (i - 1)) & 1) {
      L.dw(act + al.x0, aw, d.k0p, false, cur, W, W, goff[i], 0);
      L.dw(h_prev, aw, W, true, cur, W, W, goff[i], d.k0p);
      L.dx(cur, W, W, wi, kin[i], d.k0p, dx0, d.k0p, nullptr, 0, dx0_set);
      dx0_set = true;
      L.dx(cur, W, W, wi + d.k0p, kin[i], W, nxt, W, h_prev, aw, false);
    } else {
      L.dw(h_prev, aw, W, true, cur, W, W, goff[i], 0);
      L.dx(cur, W, W, wi, kin[i], W, nxt, W, h_prev, aw, false);
    }
    float* t = cur; cur = nxt; nxt = t;
  }
  L.dw(act + al.x0, aw, d.k0p, true, cur, W, W, goff[0], 0);
  L.dx(cur, W, W, w32 + woff[0], kin[0], d.k0p, dx0, d.k0p, nullptr, 0,
       dx0_set);
  if (L.err != cudaSuccess) return (int)L.err;

  // 5. fixed-order sum of the dW partials
  reduce_chunks_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, dW, total, n_chunk, nullptr, nullptr, 0, 0, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 6. PE and transform backward, per-ray sums
  const int R = P / S;
  const size_t smem_pe = (size_t)(2 * S + 2 * nfv) * C72 * sizeof(float);
  auto pe_kernel = pe_transform_bwd_kernel<false>;
  e = cudaFuncSetAttribute(pe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_pe);
  if (e != cudaSuccess) return (int)e;
  pe_kernel<<<R, NTHREADS, smem_pe, stream>>>(
      pts, m_all, aux, cut, dx0, d.k0p, dview + W, (int)ldv, S, nfk, nfv,
      tau, dpts, dm, daux, FC);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Run K2-v1 on `stream`: dW (flat, blocks in the Python grad_blocks order),
// dpts, dm_all, daux for the cotangent g of K1's output. The scratch
// buffers come from the caller. Returns a cudaError_t code (0 on success).
int anerf_fused_bwd(const float* pts, const float* m_all, const float* aux,
                    const void* wts, const float* bias, const float* w_rgb,
                    const float* w_alpha, const float* b_out,
                    const float* cut, const float* w32, const float* g,
                    void* act_v, float* raw, float* dhv, float* dview,
                    float* dh_a, float* dh_b, float* dx0, float* partial,
                    float* dW, float* dpts, float* dm, float* daux, int P,
                    int S, int depth, int skip_mask, int nfk, int nfv,
                    int chunk, float tau, void* stream_v) {
  return run_bwd(pts, m_all, aux, wts, bias, w_rgb, w_alpha, b_out, cut,
                 w32, g, act_v, raw, dhv, dview, dh_a, dh_b, dx0, partial,
                 dW, dpts, dm, daux, P, S, depth, skip_mask, nfk, nfv, chunk,
                 tau, stream_v);
}

// K2-v1's f32 FMA GEMM alone, for the split products' accuracy check:
// kind 0: out (P x N) = dy (P x K, row stride ldy) b (K x N f32); kind 1:
// out ((K + 1) x N) = X^T dy and the column sums of dy, for b = X (P x K
// bf16) and dy (P x N), through `partial` (ceil(P / chunk) x (K + 1) N).
int anerf_fma_gemm_probe(int kind, const float* dy, int ldy, const void* b,
                         int K, int N, float* out, float* partial, int P,
                         int chunk, void* stream_v) {
  cudaStream_t stream = (cudaStream_t)stream_v;
  const int n_chunk = (P + chunk - 1) / chunk;
  const long long total = (long long)(K + 1) * N;
  Launcher L{stream, P, chunk, n_chunk, partial, total};
  if (kind == 0) {
    L.dx(dy, ldy, K, reinterpret_cast<const float*>(b), N, N, out, N,
         nullptr, 0, false);
    return (int)L.err;
  }
  L.dw(reinterpret_cast<const bf16*>(b), K, K, true, dy, ldy, N, 0, 0);
  if (L.err != cudaSuccess) return (int)L.err;
  reduce_chunks_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, out, total, n_chunk, nullptr, nullptr, 0, 0, 0);
  return (int)cudaGetLastError();
}

const char* anerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
