// K2: the backward of K1 (fused transform + cutoff PE + NeRF MLP) with f32
// cotangent products, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel anerf_tpu/kernels/fused_render.py:
// _fused_bwd_impl (kernel body _render_kernel_pts_bwd), the bwd_f32=True
// flavour. Python side: anerf_torch/kernels/fused_render.py:fused_bwd,
// whose fused_bwd_ref is the plain PyTorch version of this function.
//
// What bounds it on an H100: operations. Per point it recomputes the
// forward (about 864k bf16 multiply-adds, tensor cores) and does about
// 1.73M f32 multiply-adds of cotangent products (dX = dY W and
// dW = X^T dY for every layer, layer 0's input gradient included: the
// pose path needs it). At N_rand = 2048 (S = 64 + 80, 294,912 points a
// step) that is 0.51 TFLOP of bf16 (0.52 ms at 989 TFLOP/s) and 1.02
// TFLOP of f32 (15.2 ms at the 67 TFLOP/s fp32 non-tensor peak).
//
// Design (B in the port's plan: a few simple kernels, each with a plain
// counterpart, all deterministic; no float atomics):
//  1. K1's kernel body with SAVE = true (fused_render_common.cuh)
//     recomputes the forward exactly as K1 does and writes every bf16 MLP
//     input and activation: 2 * (k0p + kvp + (depth + 1) W + W/2) bytes
//     per point, 7,072 B at the flagship (1.16 GB at R = 2048, S = 80).
//  2. gemm_f32_kernel: a plain fp32 FMA GEMM tiled through shared memory
//     (128 x 128 tiles, 8 deep, 8 x 8 outputs a thread). As dX = dY W it
//     fuses the ReLU mask (from the saved bf16 activation, as the TPU
//     kernel's relu_mask(hb)) and an optional accumulate. As dW = X^T dY
//     it splits the point axis into chunks of `chunk` points and writes
//     one partial (K + 1) x N block per chunk (the extra row, a column of
//     ones in X, is the bias gradient); reduce_chunks_kernel then sums
//     the chunks in a fixed order. The partials take n_chunk x 3.5 MB
//     (280 MB at 163,840 points in chunks of 2,048).
//  3. pe_transform_bwd_kernel: one CTA per ray. The backward of the
//     cutoff PE (window derivative from the overflow-safe window K1 uses)
//     and of the world->local transform in exact fp32 FMAs (the
//     pose-refinement path), then the per-ray sums for dm_all and daux
//     over the ray's samples in a fixed order.
// Every result is a function of the inputs alone: two calls give the
// same bits.
//
// K2-d (anerf_fused_bwd_staged) replaces tools/kernel_bench.py:
// decompose_bwd (the stage= exits of _render_kernel_pts_bwd): the same
// sequence stopped after the recompute (1), after the MLP backward (1-5),
// or after the PE backward (step 6 with its transform backward cut out,
// which writes a digest to dpts). Python side:
// anerf_torch/kernels/stages.py:decompose_bwd.

#include "fused_render_common.cuh"

namespace {

// Stages of the backward sequence (K2-d); BWD_FULL is production.
constexpr int BWD_FULL = 0, BWD_RECOMPUTE = 1, BWD_MLP = 2, BWD_PE = 3;

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

// out[i] = sum over chunks c = 0, 1, .. of partial[c * total + i].
__global__ void reduce_chunks_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out,
                                     long long total, int n_chunk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int c = 0; c < n_chunk; ++c) s += partial[(long long)c * total + i];
  out[i] = s;
}

// One CTA per ray: the cutoff-PE and transform backward of its S points,
// from the cotangents of the MLP inputs dx0 (P x k0p, row stride ldx0)
// and dxv (P x kvp, row stride ldxv). Shared memory: dpts_t and dd of
// every sample (2 x S x 72 f32) and the ray's view-band sin / cos
// (2 x nfv x 72 f32). PE_ONLY (K2-d's pe stage) stops before the
// transform backward and writes dpts[p] = (sum_j dv_j, sum_c dd_c,
// sum_c dr_c): dv is the distances' cotangent with the window derivative,
// dd the view directions', dr the unit bone directions' (read from dx0).
template <bool PE_ONLY>
__global__ void __launch_bounds__(NTHREADS)
pe_transform_bwd_kernel(const float* __restrict__ pts,
                        const float* __restrict__ m_all,
                        const float* __restrict__ aux,
                        const float* __restrict__ cut,
                        const float* __restrict__ dx0, int ldx0,
                        const float* __restrict__ dxv, int ldxv,
                        int S, int nfk, int nfv, float tau,
                        float* __restrict__ dpts, float* __restrict__ dm,
                        float* __restrict__ daux) {
  extern __shared__ __align__(16) float sm[];
  float* dpt = sm;                 // S x 72: d pts_t
  float* ddd = dpt + S * C72;      // S x 72: d view dirs
  float* sdt = ddd + S * C72;      // nfv x 72: sin(2^k d)
  float* cdt = sdt + nfv * C72;    // nfv x 72: cos(2^k d)
  const int ray = blockIdx.x, tid = threadIdx.x;
  const float* m = m_all + (size_t)ray * 3 * C72;
  const float* ax = aux + (size_t)ray * AUXW;

  for (int it = tid; it < nfv * C72; it += NTHREADS) {
    const int k = it / C72, c = it - k * C72;
    float f = 1.f;
    for (int q = 0; q < k; ++q) f *= 2.f;
    sincosf(ax[C72 + c] * f, &sdt[it], &cdt[it]);
  }
  __syncthreads();

  const int nb = J * (1 + 2 * nfk);  // first bone-direction column of x0
  for (int it = tid; it < S * J; it += NTHREADS) {
    const int s = it / J, j = it - s * J;
    const size_t p = (size_t)ray * S + s;
    const float x = pts[p * 3], y = pts[p * 3 + 1], z = pts[p * 3 + 2];
    float q[3];
    float ss = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int c = j * 3 + a;
      q[a] = fmaf(m[2 * C72 + c], z, fmaf(m[C72 + c], y, m[c] * x)) + ax[c];
      ss = fmaf(q[a], q[a], ss);
    }
    const float v = sqrtf(fmaxf(ss, 1e-24f));
    const float inv = 1.f / fmaxf(v, 1e-12f);
    const float w = 1.f / (1.f + expf(tau * (v - cut[j])));

    // kp bands: x0 = [v w | sin(2^k v) w, cos(2^k v) w .. | bone dirs]
    const float* gx = dx0 + p * ldx0;
    float dv = gx[j] * w, dw = gx[j] * v;
    float f = 1.f;
    for (int k = 0; k < nfk; ++k) {
      float sn, cs;
      sincosf(v * f, &sn, &cs);
      const float dsv = gx[J + 2 * J * k + j];
      const float dcv = gx[2 * J + 2 * J * k + j];
      dv += f * (dsv * cs - dcv * sn) * w;
      dw += dsv * sn + dcv * cs;
      f *= 2.f;
    }
    // view bands of the joint's 3 channels: xv = [d w | sin, cos .. | fc]
    const float* gv = dxv + p * ldxv;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int c = j * 3 + a;
      const float dc = ax[C72 + c];
      float dd = gv[c] * w, dwv = gv[c] * dc;
      float fv = 1.f;
      for (int k = 0; k < nfv; ++k) {
        const float sn = sdt[k * C72 + c], cs = cdt[k * C72 + c];
        const float dsd = gv[C72 + 2 * C72 * k + c];
        const float dcd = gv[2 * C72 + 2 * C72 * k + c];
        dd += fv * (dsd * cs - dcd * sn) * w;
        dwv += dsd * sn + dcd * cs;
        fv *= 2.f;
      }
      ddd[s * C72 + c] = dd;
      dw += dwv;
    }
    // window w = 1 - sigmoid(tau (v - cut)): dw/dv = -tau w (1 - w)
    dv += tau * dw * (-(1.f - w) * w);
    if constexpr (PE_ONLY) {
      float dds = 0.f, drs = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        dds += ddd[s * C72 + j * 3 + a];
        drs += gx[nb + j * 3 + a];
      }
      dpt[s * C72 + j * 3] = dv;
      dpt[s * C72 + j * 3 + 1] = dds;
      dpt[s * C72 + j * 3 + 2] = drs;
      continue;
    }

    // r = q / max(v, 1e-12), v = sqrt(max(|q|^2, 1e-24))
    float drb[3];
    float dvinv = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      drb[a] = gx[nb + j * 3 + a];
      dvinv = fmaf(drb[a], q[a], dvinv);
    }
    if (v > 1e-12f) dv += -dvinv * inv * inv;
    const float dv2s = dv * 0.5f * inv;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      dpt[s * C72 + j * 3 + a] = drb[a] * inv + dv2s * 2.f * q[a];
  }
  __syncthreads();
  if constexpr (PE_ONLY) {
    for (int it = tid; it < S * 3; it += NTHREADS) {
      const int s = it / 3, b = it - s * 3;
      float acc = 0.f;
      for (int j = 0; j < J; ++j) acc += dpt[s * C72 + j * 3 + b];
      dpts[((size_t)ray * S + s) * 3 + b] = acc;
    }
    return;
  }

  // dpts[p, b] = sum_c dpts_t[c] m[b, c]
  for (int it = tid; it < S * 3; it += NTHREADS) {
    const int s = it / 3, b = it - s * 3;
    float acc = 0.f;
    for (int c = 0; c < C72; ++c)
      acc = fmaf(dpt[s * C72 + c], m[b * C72 + c], acc);
    dpts[((size_t)ray * S + s) * 3 + b] = acc;
  }
  // dm_all[3 ray + b, c] = sum_s pts[s, b] dpts_t[s, c]
  for (int it = tid; it < 3 * C72; it += NTHREADS) {
    const int b = it / C72, c = it - b * C72;
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc = fmaf(pts[((size_t)ray * S + s) * 3 + b], dpt[s * C72 + c], acc);
    dm[((size_t)ray * 3 + b) * C72 + c] = acc;
  }
  // daux = [sum_s dpts_t | sum_s dd | sum_s dfc]
  const int fc0 = C72 * (1 + 2 * nfv);
  for (int c = tid; c < AUXW; c += NTHREADS) {
    float acc = 0.f;
    if (c < C72) {
      for (int s = 0; s < S; ++s) acc += dpt[s * C72 + c];
    } else if (c < 2 * C72) {
      for (int s = 0; s < S; ++s) acc += ddd[s * C72 + c - C72];
    } else {
      for (int s = 0; s < S; ++s)
        acc += dxv[((size_t)ray * S + s) * ldxv + fc0 + c - 2 * C72];
    }
    daux[(size_t)ray * AUXW + c] = acc;
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

// The backward sequence up to `stage` (BWD_*).
int run_bwd(int stage, const float* pts, const float* m_all,
            const float* aux, const void* wts, const float* bias,
            const float* w_rgb, const float* w_alpha, const float* b_out,
            const float* cut, const float* w32, const float* g, void* act_v,
            float* raw, float* dhv, float* dview, float* dh_a, float* dh_b,
            float* dx0, float* partial, float* dW, float* dpts, float* dm,
            float* daux, int P, int S, int depth, int skip_mask, int nfk,
            int nfv, int chunk, float tau, void* stream_v) {
  if (stage < BWD_FULL || stage > BWD_PE) return (int)cudaErrorInvalidValue;
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
  if (stage == BWD_RECOMPUTE) return 0;

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
      partial, dW, total, n_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (stage == BWD_MLP) return 0;

  // 6. PE and transform backward, per-ray sums
  const int R = P / S;
  const size_t smem_pe = (size_t)(2 * S + 2 * nfv) * C72 * sizeof(float);
  auto pe_kernel = stage == BWD_PE ? pe_transform_bwd_kernel<true>
                                   : pe_transform_bwd_kernel<false>;
  e = cudaFuncSetAttribute(pe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_pe);
  if (e != cudaSuccess) return (int)e;
  pe_kernel<<<R, NTHREADS, smem_pe, stream>>>(
      pts, m_all, aux, cut, dx0, d.k0p, dview + W, (int)ldv, S, nfk, nfv,
      tau, dpts, dm, daux);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Run K2 on `stream`: dW (flat, blocks in the Python grad_blocks order),
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
  return run_bwd(BWD_FULL, pts, m_all, aux, wts, bias, w_rgb, w_alpha, b_out,
                 cut, w32, g, act_v, raw, dhv, dview, dh_a, dh_b, dx0,
                 partial, dW, dpts, dm, daux, P, S, depth, skip_mask, nfk,
                 nfv, chunk, tau, stream_v);
}

// K2-d: the same sequence stopped after `stage` (1 recompute: raw and the
// saved activations; 2 mlp: dW, dx0 and dview too; 3 pe: dW and the PE
// digest in dpts; 0 full: anerf_fused_bwd).
int anerf_fused_bwd_staged(int stage, const float* pts, const float* m_all,
                           const float* aux, const void* wts,
                           const float* bias, const float* w_rgb,
                           const float* w_alpha, const float* b_out,
                           const float* cut, const float* w32,
                           const float* g, void* act_v, float* raw,
                           float* dhv, float* dview, float* dh_a,
                           float* dh_b, float* dx0, float* partial,
                           float* dW, float* dpts, float* dm, float* daux,
                           int P, int S, int depth, int skip_mask, int nfk,
                           int nfv, int chunk, float tau, void* stream_v) {
  return run_bwd(stage, pts, m_all, aux, wts, bias, w_rgb, w_alpha, b_out,
                 cut, w32, g, act_v, raw, dhv, dview, dh_a, dh_b, dx0,
                 partial, dW, dpts, dm, daux, P, S, depth, skip_mask, nfk,
                 nfv, chunk, tau, stream_v);
}

const char* anerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
