// Device code shared by K1-v1 (fused_render.cu), K2-v1 (fused_render_bwd.cu)
// and K3-v1, K4-v1 (fused_render_modes.cu): the tile constants, the bf16
// mma.sync helpers and K1-v1's kernel body (K1, K2, K3, K4 and K1-d take
// the constants, Dims and the input modes; their kernels are the sm90
// sources).
// K1-v1 instantiates the kernel with SAVE = false; K2-v1's first pass
// instantiates it with SAVE = true, which also writes every bf16 MLP
// input and activation of the tile to device memory (the `act` rows the
// backward products read). MODE defaults to K1's (IN_PTS); every branch on
// it is `if constexpr`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;              // points per CTA
constexpr int NTHREADS = 256;       // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int W = 256;              // trunk width
constexpr int WV = W / 2;           // view layer width
constexpr int J = 24;               // joints
constexpr int C72 = 3 * J;
constexpr int FC = 16;              // framecode columns
constexpr int AUXW = 2 * C72 + FC;  // aux row: trans | view dirs | fc
constexpr int PF = 3;               // weight k-steps in flight per warp
constexpr int RAWW = J + 2 * C72 + FC;  // K3's input row: v | r | d | fc

// Input modes of both kernel bodies, K1-v1's below and K1's in
// fused_render_sm90.cu (template parameter MODE):
//  IN_PTS       K1: world points, per-ray rotation columns and aux rows;
//  IN_RAW       K3: per-point rows [v (24) | r (72) | d (72) | fc (16)]
//               in `pts` (RAWW floats a point); the window and every band
//               are computed as K1 computes them;
//  IN_EMBEDDED  K4: the MLP inputs, already embedded, as bf16 rows of k0
//               (in `pts`) and kv (in `aux`) columns, multiples of 8,
//               zero-padded in shared memory (to 16 here, to 64 in the
//               sm90 kernel); nfk and nfv carry k0 and kv; phase A is a
//               copy.
constexpr int IN_PTS = 0, IN_RAW = 1, IN_EMBEDDED = 2;
// Where K1's sm90 kernel stops (template parameter STAGE of
// fused_render_sm90.cu; K1-d, the staged K1 of
// anerf_torch/tools/kernel_bench.py --decompose; IN_PTS only):
//  ST_FULL         the whole kernel (production);
//  ST_TRANSFORM    after the geometry (local coordinates, v, unit dirs);
//  ST_PE           after both PE phases (accurate sincosf);
//  ST_PE_STANDIN   the same with sincosf replaced by a cheap polynomial;
//  ST_PE_FASTTRIG  the same with the __sincosf intrinsic.
// An early exit writes a digest of every live value to `out` (4 floats a
// point), so that the compiler keeps all the work before it.
constexpr int ST_FULL = 0, ST_TRANSFORM = 1, ST_PE = 2, ST_PE_STANDIN = 3,
              ST_PE_FASTTRIG = 4;

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int rup16(int n) { return (n + 15) / 16 * 16; }

// bf16 row stride whose byte size is an odd multiple of 16
__host__ __device__ inline int row_stride(int kp) {
  return ((kp / 8) % 2 == 0) ? kp + 8 : kp;
}

// fc, auxw and raww are the framecode columns of a config (FC, AUXW and
// RAWW at the flagship; the sm90 kernels take them from here, the first
// versions only ever see the flagship's). K3's rows are padded to a
// multiple of 4 floats, so that each starts 16 bytes aligned.
struct Dims {
  int k0, k0p;   // kp PE + bone dirs, and padded to 16
  int kv, kvp;   // view PE + framecode, and padded to 16
  int s0, sv, sh;
  int fc, auxw, raww;   // framecode columns, aux row, K3's input row
};

__host__ __device__ inline Dims make_dims(int nfk, int nfv, int fc = FC) {
  Dims d;
  d.k0 = J * (1 + 2 * nfk) + C72;
  d.k0p = rup16(d.k0);
  d.kv = C72 * (1 + 2 * nfv) + fc;
  d.kvp = rup16(d.kv);
  d.s0 = row_stride(d.k0p);
  d.sv = row_stride(d.kvp);
  d.sh = row_stride(W);
  d.fc = fc;
  d.auxw = 2 * C72 + fc;
  d.raww = (J + 2 * C72 + fc + 3) / 4 * 4;
  return d;
}

// Dims of embedded inputs of k0 and kv columns (IN_EMBEDDED).
__host__ __device__ inline Dims make_dims_k(int k0, int kv) {
  Dims d;
  d.k0 = k0;
  d.k0p = rup16(k0);
  d.kv = kv;
  d.kvp = rup16(kv);
  d.s0 = row_stride(d.k0p);
  d.sv = row_stride(d.kvp);
  d.sh = row_stride(W);
  d.fc = 0;
  d.auxw = d.raww = 0;
  return d;
}

template <int MODE>
__host__ __device__ inline Dims body_dims(int nfk, int nfv, int fc = FC) {
  if constexpr (MODE == IN_EMBEDDED) return make_dims_k(nfk, nfv);
  else return make_dims(nfk, nfv, fc);
}

// The PE's sin / cos pair for STAGE: accurate sincosf everywhere but in
// the two trig probes of K1-d. The stand-in is JAX's pe_notrig
// polynomial; it keeps a multiply-add chain of the same shape alive.
template <int STAGE>
__device__ __forceinline__ void pe_sincos(float x, float* s, float* c) {
  if constexpr (STAGE == ST_PE_STANDIN) {
    *s = x * 0.5f - x * x * 0.124f;
    *c = 1.f - x * x * 0.437f;
  } else if constexpr (STAGE == ST_PE_FASTTRIG) {
    __sincosf(x, s, c);
  } else {
    sincosf(x, s, c);
  }
}

inline size_t smem_bytes(const Dims& d) {
  return (size_t)TM * (d.s0 + d.sv + 2 * d.sh) * sizeof(bf16)
         + (size_t)TM * J * sizeof(float);
}

// rows past the end of the point axis recompute the last point (their
// results are never stored), so every tile runs the same finite math.
// Point indices are 32-bit: the wrapper keeps 4 * R * S below 2^31.
__device__ __forceinline__ int last_row(int p, int P) {
  return p < P ? p : P - 1;
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The A fragment of rows 0..15 and k0..k0+15 of a row-major bf16 tile in
// shared memory (row stride sa): one ldmatrix.x4, lanes 0-15 addressing
// rows 0-15 at k0 and lanes 16-31 the same rows at k0 + 8.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* A,
                                       int sa, int k0, int lane) {
  const bf16* p = A + (lane & 15) * sa + k0 + (lane >> 4) * 8;
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// B fragments of k-step ks for NT n-tiles. A weight block of N rows
// (outputs) and K columns is packed in fragment order: for each k-step,
// each pair of 8-row n-tiles, each lane (g = lane / 4, t = lane % 4),
// 8 bf16 = {W[n][k+2t], W[n][k+2t+1], W[n][k+2t+8], W[n][k+2t+9]} for
// n = 16 * pair + g, then the same for n + 8 (k = 16 * ks). `wb` points
// at this warp's first pair and lane.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2],
                                       const uint4* wb, int npairs, int ks) {
#pragma unroll
  for (int pp = 0; pp < NT / 2; ++pp) {
    const uint4 v = __ldg(wb + ((size_t)ks * npairs + pp) * 32);
    b[2 * pp][0] = v.x;
    b[2 * pp][1] = v.y;
    b[2 * pp + 1][0] = v.z;
    b[2 * pp + 1][1] = v.w;
  }
}

// acc[64 x NT*8] += A[64 x K] (shared, row stride sa) times the weight
// block `blk` (N rows, fragment order) at k-steps ks0 .. ks0 + K/16 - 1
// and n-tiles n0/8 .. n0/8 + NT - 1. K is a multiple of 16, n0 of 16.
template <int NT>
__device__ __forceinline__ void mma_segment(float (&acc)[4][NT][4],
                                            const bf16* A, int sa, int K,
                                            const bf16* blk, int N, int ks0,
                                            int n0, int lane) {
  const int npairs = N / 16;
  const uint4* wb = reinterpret_cast<const uint4*>(blk)
                    + ((size_t)ks0 * npairs + n0 / 16) * 32 + lane;
  const int nk = K / 16;
  uint32_t b[PF][NT][2];
#pragma unroll
  for (int s = 0; s < PF; ++s)
    if (s < nk) load_b<NT>(b[s], wb, npairs, s);
#pragma unroll 1
  for (int kb = 0; kb < nk; kb += PF) {
#pragma unroll
    for (int s = 0; s < PF; ++s) {
      const int ks = kb + s;
      if (ks < nk) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          load_a(a, A + mt * 16 * sa, sa, ks * 16, lane);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma16816(acc[mt][nt], a[0], a[1], a[2], a[3], b[s][nt][0],
                     b[s][nt][1]);
        }
        if (ks + PF < nk) load_b<NT>(b[s], wb, npairs, ks + PF);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[4][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
}

// O[row, n0 + ..] = bf16(act(acc + bias)); C fragment: (g, 2t..2t+1) and
// (g + 8, 2t..2t+1) of each 16x8 tile.
template <int NT>
__device__ __forceinline__ void store_layer(const float (&acc)[4][NT][4],
                                            const float* __restrict__ bias,
                                            bool relu, bf16* O, int so,
                                            int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = mt * 16 + g;
      float v0 = acc[mt][nt][0] + b0, v1 = acc[mt][nt][1] + b1;
      float v2 = acc[mt][nt][2] + b0, v3 = acc[mt][nt][3] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(O + row * so + col) =
          __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(O + (row + 8) * so + col) =
          __floats2bfloat162_rn(v2, v3);
    }
  }
}

// Column offsets of one point's row of saved bf16 activations (SAVE):
// [x0 (k0p) | xv (kvp) | h_0 .. h_{depth-1} (W each) | feat (W) | hv (WV)].
struct ActLayout {
  int x0, xv, h, feat, hv, width;
};

__host__ __device__ inline ActLayout make_act_layout(const Dims& d,
                                                     int depth) {
  ActLayout a;
  a.x0 = 0;
  a.xv = d.k0p;
  a.h = d.k0p + d.kvp;
  a.feat = a.h + depth * W;
  a.hv = a.feat + W;
  a.width = a.hv + WV;
  return a;
}

// Copy `ncols` bf16 columns (a multiple of 8) of the tile's rows from
// shared memory (row stride ss) to act[p, col0 ..], 16 bytes a thread.
__device__ __forceinline__ void save_tile(const bf16* src, int ss,
                                          bf16* __restrict__ act, int actw,
                                          int col0, int ncols, int row0,
                                          int P, int tid) {
  const int n8 = ncols / 8;
  for (int it = tid; it < TM * n8; it += NTHREADS) {
    const int r = it / n8, c = (it - r * n8) * 8;
    if (row0 + r < P)
      *reinterpret_cast<uint4*>(act + (size_t)(row0 + r) * actw + col0 + c) =
          *reinterpret_cast<const uint4*>(src + r * ss + c);
  }
}

// IN_EMBEDDED's phase A: the tile's rows of `k` bf16 columns (k a
// multiple of 8, rows 16-byte aligned) from src into shared memory (row
// stride ss), zero columns k .. kp, 16 bytes a thread.
__device__ __forceinline__ void copy_rows(bf16* dst, int ss,
                                          const bf16* __restrict__ src,
                                          int k, int kp, int row0, int P,
                                          int tid) {
  const int n8 = kp / 8, k8 = k / 8;
  for (int it = tid; it < TM * n8; it += NTHREADS) {
    const int r = it / n8, c = it - r * n8;
    const size_t p = last_row(row0 + r, P);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < k8) v = __ldg(reinterpret_cast<const uint4*>(src + p * k) + c);
    *reinterpret_cast<uint4*>(dst + r * ss + c * 8) = v;
  }
}

template <bool SAVE, int MODE = IN_PTS>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_encode_mlp_pts_kernel(const float* __restrict__ pts,
                            const float* __restrict__ m_all,
                            const float* __restrict__ aux,
                            const bf16* __restrict__ wts,
                            const float* __restrict__ bias,
                            const float* __restrict__ w_rgb,
                            const float* __restrict__ w_alpha,
                            const float* __restrict__ b_out,
                            const float* __restrict__ cut,
                            float* __restrict__ out, int P, int S,
                            int depth, int skip_mask, int nfk, int nfv,
                            float tau, bf16* __restrict__ act) {
  static_assert(!SAVE || MODE == IN_PTS, "K2 saves K1's activations");
  static_assert(NTHREADS == 4 * TM, "heads: one thread per output");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims d = body_dims<MODE>(nfk, nfv);
  bf16* X0 = reinterpret_cast<bf16*>(smem_raw);   // kp PE | bone dirs
  bf16* XV = X0 + TM * d.s0;                      // view PE | framecode
  bf16* HA = XV + TM * d.sv;                      // activations, ping
  bf16* HB = HA + TM * d.sh;                      // activations, pong
  float* W24 = reinterpret_cast<float*>(HB + TM * d.sh);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TM;

  if constexpr (MODE == IN_EMBEDDED) {
    // ---- phase A: copy the embedded bf16 rows, zero-padded to 16 ----
    copy_rows(X0, d.s0, reinterpret_cast<const bf16*>(pts), d.k0, d.k0p,
              row0, P, tid);
    copy_rows(XV, d.sv, reinterpret_cast<const bf16*>(aux), d.kv, d.kvp,
              row0, P, tid);
    __syncthreads();
  } else {
  // ---- phase A1: per (point, joint) geometry, window, kp bands ----
  const int nb = J * (1 + 2 * nfk);  // first bone-direction column
  for (int it = tid; it < TM * J; it += NTHREADS) {
    const int r = it / J, j = it - (it / J) * J;
    const int p = last_row(row0 + r, P);   // tail rows: finite dummy
    float q[3];   // IN_PTS: local coordinates; IN_RAW: the unit direction
    float v, inv;
    if constexpr (MODE == IN_PTS) {
      const int ray = p / S;
      const float x = pts[p * 3], y = pts[p * 3 + 1], z = pts[p * 3 + 2];
      const float* m = m_all + ray * 3 * C72;
      const float* tr = aux + ray * AUXW;
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
      const float* xin = pts + (size_t)p * RAWW;
      v = xin[j];
#pragma unroll
      for (int a = 0; a < 3; ++a) q[a] = xin[J + j * 3 + a];
      inv = 1.f;
    }
    const float w = 1.f / (1.f + expf(tau * (v - cut[j])));
    W24[r * J + j] = w;
    bf16* xr = X0 + r * d.s0;
    xr[j] = __float2bfloat16_rn(v * w);
    float f = 1.f;
    for (int k = 0; k < nfk; ++k) {
      float s, c;
      pe_sincos<ST_FULL>(v * f, &s, &c);
      xr[J + 2 * J * k + j] = __float2bfloat16_rn(s * w);
      xr[2 * J + 2 * J * k + j] = __float2bfloat16_rn(c * w);
      f *= 2.f;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
      xr[nb + j * 3 + a] = __float2bfloat16_rn(q[a] * inv);
  }
  const int pad0 = d.k0p - d.k0;
  for (int it = tid; it < TM * pad0; it += NTHREADS)
    X0[(it / pad0) * d.s0 + d.k0 + it % pad0] = __float2bfloat16_rn(0.f);
  __syncthreads();

  // ---- phase A2: per (point, view channel) windowed view bands ----
  for (int it = tid; it < TM * C72; it += NTHREADS) {
    const int r = it / C72, c = it - (it / C72) * C72;
    const int p = last_row(row0 + r, P);
    const float dv = MODE == IN_PTS
                         ? aux[(p / S) * AUXW + C72 + c]
                         : pts[(size_t)p * RAWW + J + C72 + c];
    const float w = W24[r * J + c / 3];
    bf16* xr = XV + r * d.sv;
    xr[c] = __float2bfloat16_rn(dv * w);
    float f = 1.f;
    for (int k = 0; k < nfv; ++k) {
      float s, co;
      pe_sincos<ST_FULL>(dv * f, &s, &co);
      xr[C72 + 2 * C72 * k + c] = __float2bfloat16_rn(s * w);
      xr[2 * C72 + 2 * C72 * k + c] = __float2bfloat16_rn(co * w);
      f *= 2.f;
    }
  }
  const int nfc = d.kvp - (d.kv - FC);   // framecode + zero pad columns
  for (int it = tid; it < TM * nfc; it += NTHREADS) {
    const int r = it / nfc, c = it % nfc;
    const int p = last_row(row0 + r, P);
    const float val = c < FC ? (MODE == IN_PTS
                                    ? aux[(p / S) * AUXW + 2 * C72 + c]
                                    : pts[(size_t)p * RAWW + J + 2 * C72
                                          + c])
                             : 0.f;
    XV[r * d.sv + (d.kv - FC) + c] = __float2bfloat16_rn(val);
  }
  __syncthreads();
  }  // phase A

  const ActLayout al = make_act_layout(d, depth);
  if constexpr (SAVE) {
    save_tile(X0, d.s0, act, al.width, al.x0, d.k0p, row0, P, tid);
    save_tile(XV, d.sv, act, al.width, al.xv, d.kvp, row0, P, tid);
  }

  // ---- phase B: trunk (skip concat = a second K segment), tensor cores ----
  const bf16* wl = wts;
  const float* bl = bias;
  bf16* hin = HB;
  bf16* hout = HA;
  const int n0 = warp * (W / NWARPS);
  for (int i = 0; i < depth; ++i) {
    float acc[4][4][4];
    zero_acc<4>(acc);
    int K;
    if (i == 0) {
      K = d.k0p;
      mma_segment<4>(acc, X0, d.s0, d.k0p, wl, W, 0, n0, lane);
    } else if ((skip_mask >> (i - 1)) & 1) {
      K = d.k0p + W;
      mma_segment<4>(acc, X0, d.s0, d.k0p, wl, W, 0, n0, lane);
      mma_segment<4>(acc, hin, d.sh, W, wl, W, d.k0p / 16, n0, lane);
    } else {
      K = W;
      mma_segment<4>(acc, hin, d.sh, W, wl, W, 0, n0, lane);
    }
    store_layer<4>(acc, bl, true, hout, d.sh, n0, lane);
    __syncthreads();
    if constexpr (SAVE)
      save_tile(hout, d.sh, act, al.width, al.h + i * W, W, row0, P, tid);
    wl += (size_t)W * K;
    bl += W;
    bf16* tmp = hin; hin = hout; hout = tmp;
  }

  // alpha head on the last trunk activations (hin), before they are reused
  const int hr = tid >> 2, ho = tid & 3;   // one (row, output) per thread
  float head = 0.f;
  if (ho == 3) {
    const bf16* h = hin + hr * d.sh;
    for (int k = 0; k < W; ++k)
      head = fmaf(__bfloat162float(h[k]), w_alpha[k], head);
  }

  // feature layer (no activation): hin -> hout
  {
    float acc[4][4][4];
    zero_acc<4>(acc);
    mma_segment<4>(acc, hin, d.sh, W, wl, W, 0, n0, lane);
    store_layer<4>(acc, bl, false, hout, d.sh, n0, lane);
    __syncthreads();
    if constexpr (SAVE)
      save_tile(hout, d.sh, act, al.width, al.feat, W, row0, P, tid);
    wl += (size_t)W * W;
    bl += W;
  }

  // view layer: [feature | view PE | framecode] -> 128, ReLU, into hin
  {
    const int nv0 = warp * (WV / NWARPS);
    float acc[4][2][4];
    zero_acc<2>(acc);
    mma_segment<2>(acc, hout, d.sh, W, wl, WV, 0, nv0, lane);
    mma_segment<2>(acc, XV, d.sv, d.kvp, wl, WV, W / 16, nv0, lane);
    store_layer<2>(acc, bl, true, hin, d.sh, nv0, lane);
    __syncthreads();
    if constexpr (SAVE)
      save_tile(hin, d.sh, act, al.width, al.hv, WV, row0, P, tid);
  }

  if (ho < 3) {
    const bf16* h = hin + hr * d.sh;
    const float* wr = w_rgb + ho * WV;
    for (int k = 0; k < WV; ++k)
      head = fmaf(__bfloat162float(h[k]), wr[k], head);
  }
  const int p = row0 + hr;
  if (p < P) out[p * 4 + ho] = head + b_out[ho];
}

}  // namespace
