// The layered route of K1, K3, K4 and K2's recompute for Hopper (sm_90a):
// the same functions as K1's single kernel (fused_render_sm90.cu) for the
// shapes whose tile, activation buffers and weight stages do not fit in one
// block's shared memory: a trunk wider than 256 (at 512, the two 64-point
// activation buffers alone take 128 KB and one k-slice of a layer 64 KB),
// or MLP inputs wider than two weight stages leave room for (multires 10
// with multires_views 6 and a 32-wide framecode: 238,624 bytes at two
// stages). anerf_torch/kernels/fused_render.py:route_plan picks the route.
//
// Replaces, for those shapes, the same Pallas TPU kernels as the single
// kernel: anerf_tpu/kernels/fused_render.py:fused_encode_mlp_pts (K1 and,
// with SAVE, the forward that _fused_bwd_impl recomputes), fused_encode_mlp
// (K3) and anerf_tpu/kernels/fused_mlp.py:fused_mlp_apply (K4). The TPU
// kernel keeps a whole tile's activations in VMEM (megabytes); a Hopper
// block has 227 KB, so here every activation makes a round trip through
// HBM between layers instead.
//
// What bounds it on an H100: operations, as the single kernel (the MLP's
// bf16 products; 5.68 MFLOP a point at 8 x 512, roofline.py:
// mlp_macs_per_point), but the HBM traffic is no longer small beside them:
// each layer reads its bf16 input rows and writes its output rows
// (2 (K + N) bytes a point a layer, 4 KB at width 512),
// and every 64-point tile reads the layer's weights from L2. This is a
// correctness route; making it fast is later work.
//
// Design (one launch per step, all on PyTorch's stream, no atomics: two
// calls give the same bits):
//  1. phase_a_kernel (IN_PTS: K1, IN_RAW: K3; K4's inputs are already
//     embedded): the geometry, window and cutoff PE of a 64-point tile, the
//     same arithmetic as the single kernel, written as bf16 rows of the
//     row-major activation buffer X (x0 at column 0 and xv at rup64(k0),
//     each zero-padded to a multiple of 64 columns).
//  2. layer_kernel, once per MMA layer: C (64 points x 256 or 128 outputs)
//     = A W^T + bias (ReLU but on the feature layer), rounded to bf16 into
//     X. A is one or two segments of X's columns (a skip layer's [x0 | h],
//     the view layer's [feat | xv]; K4's x0 / xv straight from its input
//     rows), B the layer's k-slices of the weight image 'img' that the
//     single kernel reads (to_sm90_image: each slice's rows already in the
//     wgmma K-major 128-byte swizzle). Each 64-deep k-slice of A (a 64 x 64
//     chunk, swizzled as it is copied) and of B (256 rows) goes in by
//     cp.async, double-buffered, the next slice's copies in flight during
//     this slice's wgmma.m64n128k16 (m64n64k16 on a 128-wide view layer) of
//     two consumer warpgroups; f32 accumulators in registers across all of
//     a layer's k-slices, as the single kernel's.
//  3. heads_kernel: the 3-wide rgb and 1-wide alpha heads, f32 dot
//     products of the bf16 hv and last trunk activations with the f32 head
//     weights, plus b_out.
//  4. With SAVE (K2's recompute), X holds every MLP input and activation
//     in make_act_rows' columns, and to_act_kernel copies it into K2's
//     `act` layout (sm90_common.cuh: act_at), points past P as zeros.
// 1 + (depth + 2) + 1 launches (K4: no phase A; SAVE: one more).

#include "sm90_common.cuh"

namespace {

constexpr int LT = 256;                  // two consumer warpgroups
constexpr int L_IN_PTS = 0, L_IN_RAW = 1, L_IN_EMBEDDED = 2;

__host__ __device__ inline int rup64(int n) { return (n + KC - 1) / KC * KC; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Phase A of K1 (IN_PTS: world points, per-ray m_all and aux rows of
// d.auxw floats) or K3 (IN_RAW: per-point rows of d.raww floats
// [v | r | d | fc | pad]) for one tile of 64 points: the bf16 MLP inputs
// into X (row stride ldx): x0 = [kp bands | bone dirs] at columns 0 ..
// rup64(k0) - 1 and xv = [view bands | fc] at xv_col .. + rup64(kv) - 1,
// zero past k0 and kv. The arithmetic is the single kernel's (exact fp32
// geometry, the overflow-safe window, accurate sincosf and expf); the view
// bands are computed per point.
template <int MODE>
__global__ void __launch_bounds__(LT)
phase_a_kernel(const float* __restrict__ pts, const float* __restrict__ m_all,
               const float* __restrict__ aux, const float* __restrict__ cut,
               bf16* __restrict__ X, int ldx, int xv_col, int P, int S,
               int nfk, int nfv, int fc, float tau) {
  __shared__ float W24[TM * J];
  const Dims d = make_dims(nfk, nfv, fc);
  const int tid = threadIdx.x, row0 = blockIdx.x * TM;
  const int nb = J * (1 + 2 * nfk);      // first bone-direction column
  for (int it = tid; it < TM * J; it += LT) {
    const int r = it / J, j = it - (it / J) * J;
    const int p = last_row(row0 + r, P);
    float q[3], v, inv;
    if constexpr (MODE == L_IN_PTS) {
      const int ray = p / S;
      const float x = pts[(size_t)p * 3], y = pts[(size_t)p * 3 + 1],
                  z = pts[(size_t)p * 3 + 2];
      const float* m = m_all + (size_t)ray * 3 * C72;
      const float* tr = aux + (size_t)ray * d.auxw;
      float ss = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int c = j * 3 + a;
        q[a] = fmaf(m[2 * C72 + c], z, fmaf(m[C72 + c], y, m[c] * x))
               + tr[c];
        ss = fmaf(q[a], q[a], ss);
      }
      v = sqrtf(fmaxf(ss, 1e-24f));
      inv = 1.f / fmaxf(v, 1e-12f);
    } else {
      const float* xin = pts + (size_t)p * d.raww;
      v = xin[j];
#pragma unroll
      for (int a = 0; a < 3; ++a) q[a] = xin[J + j * 3 + a];
      inv = 1.f;
    }
    const float w = 1.f / (1.f + expf(tau * (v - cut[j])));
    W24[r * J + j] = w;
    if (row0 + r >= P) continue;
    bf16* xr = X + (size_t)(row0 + r) * ldx;
    xr[j] = __float2bfloat16_rn(v * w);
    float f = 1.f;
    for (int k = 0; k < nfk; ++k) {
      float s, c;
      sincosf(v * f, &s, &c);
      xr[J + 2 * J * k + j] = __float2bfloat16_rn(s * w);
      xr[2 * J + 2 * J * k + j] = __float2bfloat16_rn(c * w);
      f *= 2.f;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
      xr[nb + j * 3 + a] = __float2bfloat16_rn(q[a] * inv);
  }
  const int pad0 = rup64(d.k0) - d.k0;
  for (int it = tid; it < TM * pad0; it += LT) {
    const int r = it / pad0;
    if (row0 + r < P)
      X[(size_t)(row0 + r) * ldx + d.k0 + it % pad0] =
          __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  for (int it = tid; it < TM * C72; it += LT) {
    const int r = it / C72, c = it - (it / C72) * C72;
    const int p = row0 + r;
    if (p >= P) continue;
    const float dv = MODE == L_IN_PTS
                         ? aux[(size_t)(p / S) * d.auxw + C72 + c]
                         : pts[(size_t)p * d.raww + J + C72 + c];
    const float w = W24[r * J + c / 3];
    bf16* xr = X + (size_t)p * ldx + xv_col;
    xr[c] = __float2bfloat16_rn(dv * w);
    float f = 1.f;
    for (int k = 0; k < nfv; ++k) {
      float sn, cs;
      sincosf(dv * f, &sn, &cs);
      xr[C72 + 2 * C72 * k + c] = __float2bfloat16_rn(sn * w);
      xr[2 * C72 + 2 * C72 * k + c] = __float2bfloat16_rn(cs * w);
      f *= 2.f;
    }
  }
  // framecode and zero padding
  const int c0 = d.kv - d.fc, nfc = rup64(d.kv) - c0;
  for (int it = tid; it < TM * nfc; it += LT) {
    const int r = it / nfc, c = it - (it / nfc) * nfc;
    const int p = row0 + r;
    if (p >= P) continue;
    const float val =
        c < d.fc ? (MODE == L_IN_PTS
                        ? aux[(size_t)(p / S) * d.auxw + 2 * C72 + c]
                        : pts[(size_t)p * d.raww + J + 2 * C72 + c])
                 : 0.f;
    X[(size_t)p * ldx + xv_col + c0 + c] = __float2bfloat16_rn(val);
  }
}

// One input segment of a layer: columns 0 .. 64 nch - 1 of the bf16 rows
// at a (row stride lda, a multiple of 8; 16-byte aligned), zero from
// column `cols` on (a multiple of 8).
struct Seg {
  const bf16* a;
  int lda, cols, nch;
};

struct LayerArgs {
  Seg s0, s1;            // A = [s0 | s1]; s1.nch may be 0
  const bf16* w;         // the layer's weight image: k-slices of N x 64
  int N;                 // outputs
  const float* bias;
  int relu;
  bf16* out;             // C(p, n) at out[p * ldo + n]
  int ldo, P;
};

inline size_t layer_smem(int nacc) {
  return (size_t)2 * CHUNK * 2 + (size_t)2 * (4 * nacc) * KC * 2 + 1024;
}

// One MMA layer for 64 points (blockIdx.x) and 4 NACC outputs
// (blockIdx.y): two warpgroups of 2 NACC outputs each.
template <int NACC>
__global__ void __launch_bounds__(LT, 1)
layer_kernel(const __grid_constant__ LayerArgs L) {
  constexpr int NW = 2 * NACC;           // outputs a warpgroup
  constexpr int NTILE = 2 * NW;          // outputs a CTA
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* A = reinterpret_cast<bf16*>(base);             // 2 x 64 x 64
  bf16* B = A + 2 * CHUNK;                             // 2 x NTILE x 64
  const int tid = threadIdx.x, wg = tid >> 7;
  const int row0 = blockIdx.x * TM, nb0 = blockIdx.y * NTILE;
  const int nk = L.s0.nch + L.s1.nch;

  // k-slice c of A and of B into buffer `buf`, one cp.async group
  auto load = [&](int c, int buf) {
    const bool first = c < L.s0.nch;
    const Seg& sg = first ? L.s0 : L.s1;
    const int col = (first ? c : c - L.s0.nch) * KC;
    bf16* a = A + buf * CHUNK;
    for (int it = tid; it < TM * 8; it += LT) {
      const int r = it >> 3, q = it & 7, k = col + 8 * q;
      const bool ok = row0 + r < L.P && k < sg.cols;
      cp_async16(a + swz(r, 8 * q),
                 ok ? sg.a + (size_t)(row0 + r) * sg.lda + k : sg.a,
                 ok ? 16 : 0);
    }
    bf16* b = B + buf * NTILE * KC;
    const bf16* src = L.w + (size_t)c * L.N * KC;
    for (int it = tid; it < NTILE * 8; it += LT) {
      const int n = it >> 3, q = it & 7;
      const bool ok = nb0 + n < L.N;
      cp_async16(b + n * KC + 8 * q,
                 ok ? src + (size_t)(nb0 + n) * KC + 8 * q : L.w,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) d[i] = 0.f;
  fence_acc(d);
  load(0, 0);
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    // the other buffer was last read by slice c - 1, complete in both
    // warpgroups at the barrier that ended it
    if (c + 1 < nk) {
      load(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t a = smem_u32(A + (c & 1) * CHUNK);
    const uint32_t b = smem_u32(B + (c & 1) * NTILE * KC) + wg * NW * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      wgmma<NACC>(d, gmma_desc(a + kk * 32), gmma_desc(b + kk * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    __syncthreads();
  }

  // epilogue: warp w, lane (g, q), n8 block j hold rows 16 w + g (+ 8) at
  // columns 8 j + 2 q, + 1 of this warpgroup's NW
  const int t = tid & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int col = nb0 + wg * NW + 8 * j + 2 * q;
    if (col >= L.N) continue;
    const float b0 = __ldg(L.bias + col), b1 = __ldg(L.bias + col + 1);
    float v0 = d[4 * j] + b0, v1 = d[4 * j + 1] + b1;
    float v2 = d[4 * j + 2] + b0, v3 = d[4 * j + 3] + b1;
    if (L.relu) {
      v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
    }
    const int p = row0 + r0;
    if (p < L.P)
      *reinterpret_cast<__nv_bfloat162*>(L.out + (size_t)p * L.ldo + col) =
          __floats2bfloat162_rn(v0, v1);
    if (p + 8 < L.P)
      *reinterpret_cast<__nv_bfloat162*>(L.out + (size_t)(p + 8) * L.ldo
                                         + col) =
          __floats2bfloat162_rn(v2, v3);
  }
}

// out[p, o] = hv[p] . w_rgb[o] (o < 3) or h[p] . w_alpha (o = 3), plus
// b_out[o]: f32 sums in column order of the bf16 activations (hv: w / 2
// columns of X at hv_col, h: w columns at h_col) times the f32 weights.
__global__ void __launch_bounds__(LT)
heads_kernel(const bf16* __restrict__ X, int ldx, int hv_col, int h_col,
             int w, const float* __restrict__ w_rgb,
             const float* __restrict__ w_alpha,
             const float* __restrict__ b_out, float* __restrict__ out,
             int P) {
  const size_t idx = (size_t)blockIdx.x * LT + threadIdx.x;
  const int p = (int)(idx >> 2), o = (int)(idx & 3);
  if (p >= P) return;
  const bf16* x = X + (size_t)p * ldx + (o < 3 ? hv_col : h_col);
  const float* wt = o < 3 ? w_rgb + (size_t)o * (w / 2) : w_alpha;
  const int n = o < 3 ? w / 2 : w;
  float s = 0.f;
  for (int k = 0; k < n; ++k) s = fmaf(__bfloat162float(x[k]), wt[k], s);
  out[(size_t)p * 4 + o] = s + b_out[o];
}

// X's F columns (rows = points) -> act (K2's layout, act_at), for every
// 16-byte group of every tile's feature rows; points past P read 0.
__global__ void __launch_bounds__(LT)
to_act_kernel(const bf16* __restrict__ X, int ldx, int F,
              bf16* __restrict__ act, int P, long long n_groups) {
  const long long idx = (long long)blockIdx.x * LT + threadIdx.x;
  if (idx >= n_groups) return;
  const int g = (int)(idx & 7);
  const long long tf = idx >> 3;                 // tile * F + f
  const int f = (int)(tf % F);
  const int p0 = (int)(tf / F) * TM + 8 * (g ^ (f & 7));
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = p0 + e < P ? X[(size_t)(p0 + e) * ldx + f]
                      : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(act + tf * KC + 8 * g) =
      *reinterpret_cast<const uint4*>(v);
}

// Columns of X for a layered call (see anerf_layered_forward).
struct XCols {
  int x0, xv, feat, hv, need;
  int h[2];              // without SAVE: h_i at h[i & 1]
  int h0;                // with SAVE: h_i at h0 + i w
  bool save;
  int at(int i, int w) const { return save ? h0 + i * w : h[i & 1]; }
};

XCols x_cols(const Dims& d, int depth, int w, bool save, bool embedded) {
  const ActRows ar = make_act_rows(d, depth, w);
  XCols c;
  c.save = save;
  c.x0 = ar.x0;
  c.xv = ar.xv;
  if (save) {
    c.h0 = ar.h;
    c.feat = ar.feat;
    c.hv = ar.hv;
    c.need = ar.F;
  } else {
    const int base = embedded ? 0 : ar.h;
    c.h[0] = base;
    c.h[1] = base + w;
    c.h0 = 0;
    c.feat = c.h[depth & 1];             // not the last trunk layer's
    c.hv = base + 2 * w;
    c.need = base + 2 * w + w / 2;
  }
  return c;
}

cudaError_t set_layer_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      layer_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)layer_smem(64));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(layer_kernel<32>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)layer_smem(32));
}

}  // namespace

extern "C" {

// K1 (mode 0), K3 (mode 1) or K4 (mode 2) on the layered route, on
// `stream`: the single kernel's operands (K1: pts, m_all, aux; K3: pts =
// its rows; K4: pts = x0 (P, k0) and aux = xv (P, kv) bf16 rows, nfk / nfv
// = k0 / kv), a trunk of width w (a multiple of 256) and depth `depth`,
// skip[depth] the per-layer skip flags in host memory -> raw (P, 4). X is
// the bf16 scratch buffer of P rows and ldx columns (at least the columns
// of x_cols; anerf_torch/kernels/fused_render.py:layered_columns). With
// act != null (mode 0 only) it also writes K2's saved activations (X then
// holds make_act_rows' columns). Returns a cudaError_t code.
int anerf_layered_forward(int mode, const void* pts, const float* m_all,
                          const void* aux, const void* img,
                          const float* bias, const float* w_rgb,
                          const float* w_alpha, const float* b_out,
                          const float* cut, float* out, int P, int S, int w,
                          int depth, const int* skip, int nfk, int nfv,
                          int fc, float tau, void* xbuf, int ldx, void* act,
                          void* stream_v) {
  const bool embedded = mode == L_IN_EMBEDDED;
  if ((mode != L_IN_PTS && mode != L_IN_RAW && !embedded) || depth < 1
      || w % 256 != 0 || ldx % 8 != 0 || (act != nullptr && mode != L_IN_PTS))
    return (int)cudaErrorInvalidValue;
  const Dims d = embedded ? make_dims_k(nfk, nfv) : make_dims(nfk, nfv, fc);
  const XCols xc = x_cols(d, depth, w, act != nullptr, embedded);
  if (ldx < xc.need) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_layer_smem();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = (cudaStream_t)stream_v;
  bf16* X = reinterpret_cast<bf16*>(xbuf);
  const int tiles = (P + TM - 1) / TM;
  const int x0w = rup64(d.k0), xvw = rup64(d.kv);

  // 1. phase A
  if (mode == L_IN_PTS)
    phase_a_kernel<L_IN_PTS><<<tiles, LT, 0, stream>>>(
        reinterpret_cast<const float*>(pts), m_all,
        reinterpret_cast<const float*>(aux), cut, X, ldx, xc.xv, P, S, nfk,
        nfv, fc, tau);
  else if (mode == L_IN_RAW)
    phase_a_kernel<L_IN_RAW><<<tiles, LT, 0, stream>>>(
        reinterpret_cast<const float*>(pts), nullptr, nullptr, cut, X, ldx,
        xc.xv, P, 1, nfk, nfv, fc, tau);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const Seg x0 = embedded
      ? Seg{reinterpret_cast<const bf16*>(pts), d.k0, d.k0, x0w / KC}
      : Seg{X + xc.x0, ldx, x0w, x0w / KC};
  const Seg xv = embedded
      ? Seg{reinterpret_cast<const bf16*>(aux), d.kv, d.kv, xvw / KC}
      : Seg{X + xc.xv, ldx, xvw, xvw / KC};
  const Seg none{X, ldx, 0, 0};
  auto hseg = [&](int col) { return Seg{X + col, ldx, w, w / KC}; };

  // 2. the MMA layers, each's weight block in the image after the last
  const bf16* wl = reinterpret_cast<const bf16*>(img);
  auto layer = [&](const Seg& a0, const Seg& a1, int N, const float* bl,
                   int relu, int col) {
    LayerArgs L{a0, a1, wl, N, bl, relu, X + col, ldx, P};
    if (N <= 128)
      layer_kernel<32><<<dim3(tiles, 1), LT, layer_smem(32), stream>>>(L);
    else
      layer_kernel<64><<<dim3(tiles, (N + 255) / 256), LT, layer_smem(64),
                         stream>>>(L);
    wl += (size_t)N * (a0.nch + a1.nch) * KC;
    return cudaGetLastError();
  };
  for (int i = 0; i < depth && e == cudaSuccess; ++i) {
    if (i == 0)
      e = layer(x0, none, w, bias, 1, xc.at(0, w));
    else if (skip[i])
      e = layer(x0, hseg(xc.at(i - 1, w)), w, bias + (size_t)i * w, 1,
                xc.at(i, w));
    else
      e = layer(hseg(xc.at(i - 1, w)), none, w, bias + (size_t)i * w, 1,
                xc.at(i, w));
  }
  if (e == cudaSuccess)
    e = layer(hseg(xc.at(depth - 1, w)), none, w, bias + (size_t)depth * w,
              0, xc.feat);
  if (e == cudaSuccess)
    e = layer(hseg(xc.feat), xv, w / 2, bias + (size_t)(depth + 1) * w, 1,
              xc.hv);
  if (e != cudaSuccess) return (int)e;

  // 3. the heads
  heads_kernel<<<(unsigned)(((size_t)P * 4 + LT - 1) / LT), LT, 0, stream>>>(
      X, ldx, xc.hv, xc.at(depth - 1, w), w, w_rgb, w_alpha, b_out, out, P);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 4. K2's saved activations
  if (act != nullptr) {
    const long long n_groups = (long long)tiles * xc.need * 8;
    to_act_kernel<<<(unsigned)((n_groups + LT - 1) / LT), LT, 0, stream>>>(
        X, ldx, xc.need, reinterpret_cast<bf16*>(act), P, n_groups);
    e = cudaGetLastError();
  }
  return (int)e;
}

// The columns of X that anerf_layered_forward needs (its ldx at least).
int anerf_layered_columns(int mode, int w, int depth, int nfk, int nfv,
                          int fc, int save) {
  const bool embedded = mode == L_IN_EMBEDDED;
  const Dims d = embedded ? make_dims_k(nfk, nfv) : make_dims(nfk, nfv, fc);
  return x_cols(d, depth, w, save != 0, embedded).need;
}

const char* anerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
