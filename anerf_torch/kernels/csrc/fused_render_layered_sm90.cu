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
// mlp_macs_per_point), but each layer also reads its bf16 input rows and
// writes its output rows (2 (K + N) bytes a point a layer, 4 KB at width
// 512): at 8 x 512 these round trips (roofline.py: layered_design_bytes,
// 23.7 KB a point) take longer at 3.35 TB/s than the products at the bf16
// peak, so the design's own floor is its bytes. The layer GEMM is built
// to stream them: each layer is a bf16 GEMM of about 256 operations a
// byte, at the card's ridge.
//
// Design (one launch per step, all on PyTorch's stream, no atomics: two
// calls give the same bits):
//  1. phase_a_kernel (IN_PTS: K1, IN_RAW: K3; K4's inputs are already
//     embedded): the geometry, window and cutoff PE of a 64-point tile, the
//     same arithmetic as the single kernel, written as bf16 rows of the
//     row-major activation buffer X (x0 at column 0 and xv at rup64(k0),
//     each zero-padded to a multiple of 64 columns).
//  2. layer_gemm_kernel, once per MMA layer: C = A W^T + bias (ReLU but on
//     the feature layer), rounded to bf16 into X's columns. A is one or
//     two segments of X's columns (a skip layer's [x0 | h], the view
//     layer's [feat | xv]; K4's x0 / xv straight from its input rows), B
//     the layer's k-slices of the weight image 'img' that the single
//     kernel reads (to_sm90_image: each slice's rows already in the wgmma
//     K-major 128-byte swizzle). Persistent: one cluster of GCL CTAs per
//     pair of SMs that can hold one (cudaOccupancyMaxActiveClusters)
//     walks the (group of GCL point tiles, output block) items, the output
//     blocks of a group together, so that the second block's A rows come
//     from L2. A CTA is a producer warp and two consumer warpgroups
//     (setmaxnreg 40 / 232). The producer keeps a ring of up to
//     MAX_STAGES k-slices full, guarded by full / empty mbarriers: A's
//     GM x 64 slice by one TMA load (cp.async.bulk.tensor.2d, the 128-byte
//     swizzle done by the copy engine; a tensor map for each segment's
//     rows), B's BN x 64 slice by one 1-D bulk copy from the image, each
//     CTA of the cluster copying 1/GCL of it multicast to both, so that
//     each weight byte leaves L2 once per 2 GM points (K1's single kernel
//     copies its image the same way). Each consumer warpgroup runs
//     wgmma.m64n256k16 (m64n128k16 on a 128-wide block) on its 64 rows
//     over the whole output block, f32 accumulators in registers, one
//     wgmma group in flight while the next slice's wait runs; a slice is
//     released to the producers of both CTAs once the group after it has
//     been issued and its own has completed. The epilogue (bias, ReLU,
//     bf16 rounding: the single kernel's arithmetic) stages the tile in
//     shared memory and leaves it as coalesced 16-byte stores, while the
//     producer already loads the next item's slices.
//  3. heads_kernel: the 3-wide rgb and 1-wide alpha heads, f32 dot
//     products of the bf16 hv and last trunk activations with the f32 head
//     weights, plus b_out: the weights in shared memory, a warp a point
//     at a time, 16-byte loads along the row, a fixed shuffle tree for
//     the sums.
//  4. With SAVE (K2's recompute), X holds every MLP input and activation
//     in make_act_rows' columns, and to_act_kernel copies it into K2's
//     `act` layout (sm90_common.cuh: act_at), points past P as zeros.
// 1 + (depth + 2) + 1 launches (K4: no phase A; SAVE: one more).

#include <cuda.h>

#include "sm90_common.cuh"

namespace {

constexpr int LT = 256;                  // threads of phase A, heads, to_act
constexpr int L_IN_PTS = 0, L_IN_RAW = 1, L_IN_EMBEDDED = 2;

__host__ __device__ inline int rup64(int n) { return (n + KC - 1) / KC * KC; }

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

// ---- the layer GEMM ----
// Its plan (anerf_torch/kernels/fused_render.py:layered_plan mirrors it):
// GM points a tile, 64 a consumer warpgroup; an output block of BN = 256
// columns where the layer's N is a multiple of 256, else 128 (NACC = BN /
// 2 accumulators a thread); the ring's depth the most stages, up to
// MAX_STAGES, that fit beside the epilogue's staging (STG_COLS columns of
// each warpgroup's 64 rows at a time); clusters of GCL CTAs along the
// points where there are at least GCL point tiles.
constexpr int GM = 128;
constexpr int GCL = 2;
constexpr int MAX_STAGES = 4;
constexpr int STG_COLS = 128;            // columns staged at a time
constexpr int A_BYTES = GM * KC * 2;     // one k-slice of A

__host__ __device__ constexpr int stage_bytes(int nacc) {
  return A_BYTES + 2 * nacc * KC * 2;
}
// two warpgroups' 64 rows of STG_COLS bf16
__host__ __device__ constexpr int staging_bytes(int) {
  return 2 * 64 * STG_COLS * 2;
}
__host__ __device__ constexpr int gemm_stages(int nacc) {
  const int fit = (MAX_SMEM - 1024 - staging_bytes(nacc) - 16 * MAX_STAGES)
                  / stage_bytes(nacc);
  return fit < MAX_STAGES ? fit : MAX_STAGES;
}
// alignment slack, the ring, the staging, the full / empty barriers
__host__ __device__ constexpr int gemm_smem(int nacc) {
  return 1024 + gemm_stages(nacc) * stage_bytes(nacc) + staging_bytes(nacc)
         + 16 * gemm_stages(nacc);
}
static_assert(gemm_stages(128) == MAX_STAGES && gemm_smem(128) <= MAX_SMEM
                  && gemm_smem(64) <= MAX_SMEM,
              "the layer GEMM's plan fits a block");

// One layer: A = [segment 0 | segment 1], segment s the nch_s 64-column
// k-slices of map s from its column col_s on (map s: bf16 rows, boxes of
// 64 columns x GM rows, zero past its columns and rows).
struct GemmArgs {
  int col0, col1, nch0, nch1;
  const unsigned char* w;  // the layer's weight image: k-slices of N x 128 B
  int N;                   // outputs
  const float* bias;
  int relu;
  bf16* out;               // C(p, n) at out[p * ldo + n]
  int ldo, P;
  int n_blocks, n_groups;  // output blocks; groups of CL point tiles
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The 128 threads of consumer warpgroup wg (named barriers 2 and 3).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

template <int NACC, int CL>
__global__ void __launch_bounds__(NT, 1)
layer_gemm_kernel(const __grid_constant__ CUtensorMap map0,
                  const __grid_constant__ CUtensorMap map1,
                  const __grid_constant__ GemmArgs L) {
  constexpr int BN = 2 * NACC, NSTG = gemm_stages(NACC);
  constexpr int STG = stage_bytes(NACC);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  bf16* staged = reinterpret_cast<bf16*>(base + NSTG * STG);
  const uint32_t full = ring + NSTG * STG + staging_bytes(NACC);
  const uint32_t empty = full + 8 * NSTG;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < NSTG; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8 * CL);   // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL > 1) cluster_sync(); else __syncthreads();
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int first = blockIdx.x / CL, stride = gridDim.x / CL;
  const int n_items = L.n_groups * L.n_blocks, nk = L.nch0 + L.nch1;

  if (tid >= NCONS) {
    // ---- producer warp ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == NCONS) {
      int it = 0;
      for (int item = first; item < n_items; item += stride) {
        const int grp = item / L.n_blocks, nb = item - grp * L.n_blocks;
        const int row0 = (grp * CL + rank) * GM, n0 = nb * BN;
        const int rows = min(BN, L.N - n0);         // B rows of the block
        const int piece = rows * 128 / CL;
        const unsigned char* wb = L.w + (size_t)n0 * 128 + rank * piece;
        for (int c = 0; c < nk; ++c, ++it) {
          const int s = it % NSTG;
          mbar_wait(empty + 8 * s, ((it / NSTG) & 1) ^ 1);
          const uint32_t a = ring + s * STG, fb = full + 8 * s;
          mbar_expect_tx(fb, A_BYTES + rows * 128);
          if (c < L.nch0)
            tma_load_2d(a, &map0, L.col0 + c * KC, row0, fb);
          else
            tma_load_2d(a, &map1, L.col1 + (c - L.nch0) * KC, row0, fb);
          const unsigned char* src = wb + (size_t)c * L.N * 128;
          if constexpr (CL > 1)
            bulk_multicast<CL>(a + A_BYTES + rank * piece, src, piece, fb);
          else
            bulk_load(a + A_BYTES, src, piece, fb);
        }
      }
    }
    if constexpr (CL > 1) cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // ---- consumer warpgroups: rows wg * 64 .. + 63 of each tile ----
  const int wg = tid >> 7, t = tid & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2), q = lane & 3;
  bf16* my = staged + wg * 64 * STG_COLS;
  float d[NACC];
  int it = 0;
  for (int item = first; item < n_items; item += stride) {
    const int grp = item / L.n_blocks, nb = item - grp * L.n_blocks;
    const int row0 = (grp * CL + rank) * GM + wg * 64, n0 = nb * BN;
#pragma unroll
    for (int i = 0; i < NACC; ++i) d[i] = 0.f;
    fence_acc(d);
    wgmma_fence();
    int prev = -1;
#pragma unroll 1
    for (int c = 0; c < nk; ++c, ++it) {
      const int s = it % NSTG;
      mbar_wait(full + 8 * s, (it / NSTG) & 1);
      const uint32_t a = ring + s * STG + wg * (A_BYTES / 2);
      const uint32_t b = ring + s * STG + A_BYTES;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma<NACC>(d, gmma_desc(a + kk * 32), gmma_desc(b + kk * 32));
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        mbar_arrive_cluster<CL>(empty + 8 * prev);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive_cluster<CL>(empty + 8 * prev);

    // epilogue: warp w, lane (g, q), n8 block j hold rows 16 w + g (+ 8)
    // at columns 8 j + 2 q, + 1 of the block; STG_COLS columns at a time
    // are staged (16-byte group h of row r at h ^ (r % 8): no bank
    // conflicts either way), then leave as 16-byte rows
    const int cols = min(BN, L.N - n0);
    constexpr int CPR = STG_COLS / 8;   // 16-byte groups of a staged row
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += STG_COLS) {
      wg_sync(wg);                      // the staging's last reads are done
#pragma unroll
      for (int j = c0 / 8; j < (c0 + STG_COLS) / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const float b0 = col < cols ? __ldg(L.bias + n0 + col) : 0.f;
        const float b1 = col < cols ? __ldg(L.bias + n0 + col + 1) : 0.f;
        float v0 = d[4 * j] + b0, v1 = d[4 * j + 1] + b1;
        float v2 = d[4 * j + 2] + b0, v3 = d[4 * j + 3] + b1;
        if (L.relu) {
          v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
        }
        const int h = (j - c0 / 8) ^ (r0 & 7), e = 2 * q;
        *reinterpret_cast<__nv_bfloat162*>(my + r0 * STG_COLS + 8 * h + e) =
            __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(my + (r0 + 8) * STG_COLS + 8 * h
                                           + e) =
            __floats2bfloat162_rn(v2, v3);
      }
      wg_sync(wg);
      for (int i = t; i < 64 * CPR; i += 128) {
        const int r = i / CPR, ch = i - r * CPR;
        if (row0 + r < L.P && c0 + ch * 8 < cols)
          *reinterpret_cast<uint4*>(L.out + (size_t)(row0 + r) * L.ldo + n0
                                    + c0 + ch * 8) =
              *reinterpret_cast<const uint4*>(
                  my + r * STG_COLS + 8 * (ch ^ (r & 7)));
      }
    }
  }
  if constexpr (CL > 1) cluster_sync();
}

// out[p, o] = hv[p] . w_rgb[o] (o < 3) or h[p] . w_alpha (o = 3), plus
// b_out[o]: f32 sums of the bf16 activations (hv: w / 2 columns of X at
// hv_col, h: w columns at h_col; both multiples of 8 bf16 from 16-byte
// aligned rows) times the f32 weights. A block copies the head weights
// into shared memory once; each warp walks the points warp, warp +
// the grid's warps, ..., lane l taking the 8 columns 8 l + 256 i of each
// row by 16-byte loads, then a fixed xor-shuffle tree adds the lanes'
// sums (the same order on every call).
constexpr int HEAD_BLOCKS_PER_SM = 8;

// s + the 8 bf16 values of u times wt[0 .. 7] (16-byte aligned, shared
// memory), in column order.
__device__ __forceinline__ float dot8(const uint4& u, const float* wt,
                                      float s) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float4 a = *reinterpret_cast<const float4*>(wt);
  const float4 b = *reinterpret_cast<const float4*>(wt + 4);
  float2 f = __bfloat1622float2(h2[0]);
  s = fmaf(f.y, a.y, fmaf(f.x, a.x, s));
  f = __bfloat1622float2(h2[1]);
  s = fmaf(f.y, a.w, fmaf(f.x, a.z, s));
  f = __bfloat1622float2(h2[2]);
  s = fmaf(f.y, b.y, fmaf(f.x, b.x, s));
  f = __bfloat1622float2(h2[3]);
  return fmaf(f.y, b.w, fmaf(f.x, b.z, s));
}

__global__ void __launch_bounds__(LT)
heads_kernel(const bf16* __restrict__ X, int ldx, int hv_col, int h_col,
             int w, const float* __restrict__ w_rgb,
             const float* __restrict__ w_alpha,
             const float* __restrict__ b_out, float* __restrict__ out,
             int P) {
  extern __shared__ __align__(16) float hw[];   // w_rgb (3 x w / 2) | w_alpha
  const int wv = w / 2;
  for (int i = threadIdx.x; i < 3 * wv + w; i += LT)
    hw[i] = i < 3 * wv ? w_rgb[i] : w_alpha[i - 3 * wv];
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = gridDim.x * (LT / 32);
  const float bo0 = b_out[0], bo1 = b_out[1], bo2 = b_out[2],
              bo3 = b_out[3];
  for (int p = blockIdx.x * (LT / 32) + (threadIdx.x >> 5); p < P;
       p += warps) {
    const bf16* x = X + (size_t)p * ldx;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int k = 8 * lane; k < wv; k += 256) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + hv_col + k));
      s0 = dot8(u, hw + k, s0);
      s1 = dot8(u, hw + wv + k, s1);
      s2 = dot8(u, hw + 2 * wv + k, s2);
    }
    for (int k = 8 * lane; k < w; k += 256)
      s3 = dot8(__ldg(reinterpret_cast<const uint4*>(x + h_col + k)),
                hw + 3 * wv + k, s3);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      s2 += __shfl_xor_sync(0xffffffffu, s2, m);
      s3 += __shfl_xor_sync(0xffffffffu, s3, m);
    }
    if (lane == 0)
      *reinterpret_cast<float4*>(out + (size_t)p * 4) =
          make_float4(s0 + bo0, s1 + bo1, s2 + bo2, s3 + bo3);
  }
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

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against the driver library).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled f = nullptr;
  if (f == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    f = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = f;
  return cudaSuccess;
}

// The map of `rows` bf16 rows of `cols` columns at `a` (row stride ld, a
// multiple of 8; a 16-byte aligned) that the GEMM's producer reads: boxes
// of 64 columns x GM rows in the 128-byte swizzle, zeros past the edges.
cudaError_t row_map(CUtensorMap* m, const void* a, int rows, int cols,
                    int ld) {
  EncodeTiled enc;
  cudaError_t e = encoder(&enc);
  if (e != cudaSuccess) return e;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)GM};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(a), dim, stride, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One persistent launch of layer_gemm_kernel<NACC, CL>: as many clusters
// as the device holds at once (asked once a process), at most one an item.
template <int NACC, int CL>
cudaError_t launch_gemm(const CUtensorMap& m0, const CUtensorMap& m1,
                        const GemmArgs& L, cudaStream_t stream) {
  auto kernel = layer_gemm_kernel<NACC, CL>;
  constexpr int smem = gemm_smem(NACC);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    cfg.gridDim = dim3(sms / CL * CL);
    int n = 0;
    if ((e = cudaOccupancyMaxActiveClusters(
             &n, reinterpret_cast<const void*>(kernel), &cfg)) != cudaSuccess)
      return e;
    resident = n > 0 ? n : sms / CL;
  }
  const int items = L.n_groups * L.n_blocks;
  cfg.gridDim = dim3((items < resident ? items : resident) * CL);
  return cudaLaunchKernelEx(&cfg, kernel, m0, m1, L);
}

// The plan of one layer of N outputs on P points (layered_plan mirrors
// it): the block, the cluster, the launch.
cudaError_t gemm_layer(const CUtensorMap& m0, int col0, int nch0,
                       const CUtensorMap& m1, int col1, int nch1,
                       const bf16* w, int N, const float* bias, int relu,
                       bf16* out, int ldo, int P, cudaStream_t stream) {
  const bool wide = N % 256 == 0;
  const int bn = wide ? 256 : 128, tiles = (P + GM - 1) / GM;
  const int cl = tiles >= GCL ? GCL : 1;
  const GemmArgs L{col0, col1, nch0, nch1,
                   reinterpret_cast<const unsigned char*>(w), N, bias, relu,
                   out, ldo, P, (N + bn - 1) / bn, (tiles + cl - 1) / cl};
  if (wide)
    return cl == GCL ? launch_gemm<128, GCL>(m0, m1, L, stream)
                     : launch_gemm<128, 1>(m0, m1, L, stream);
  return cl == GCL ? launch_gemm<64, GCL>(m0, m1, L, stream)
                   : launch_gemm<64, 1>(m0, m1, L, stream);
}

}  // namespace

extern "C" {

// K1 (mode 0), K3 (mode 1) or K4 (mode 2) on the layered route, on
// `stream`: the single kernel's operands (K1: pts, m_all, aux; K3: pts =
// its rows; K4: pts = x0 (P, k0) and aux = xv (P, kv) bf16 rows, nfk / nfv
// = k0 / kv, multiples of 8, 16-byte aligned), a trunk of width w (a
// multiple of 256) and depth `depth`, skip[depth] the per-layer skip flags
// in host memory -> raw (P, 4). X is the bf16 scratch buffer of P rows and
// ldx columns (at least the columns of x_cols; anerf_torch/kernels/
// fused_render.py:layered_columns). With act != null (mode 0 only) it also
// writes K2's saved activations (X then holds make_act_rows' columns).
// Returns a cudaError_t code.
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
      || w % 256 != 0 || ldx % 8 != 0 || P < 1
      || (act != nullptr && mode != L_IN_PTS)
      || (embedded && (nfk % 8 != 0 || nfv % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  const Dims d = embedded ? make_dims_k(nfk, nfv) : make_dims(nfk, nfv, fc);
  const XCols xc = x_cols(d, depth, w, act != nullptr, embedded);
  if (ldx < xc.need) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_v;
  bf16* X = reinterpret_cast<bf16*>(xbuf);
  const int tiles = (P + TM - 1) / TM;
  cudaError_t e = cudaSuccess;

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

  // the GEMMs' A: X's columns, and K4's x0 / xv rows where they are read
  // in place
  CUtensorMap mx, m0, mv;
  if ((e = row_map(&mx, X, P, ldx, ldx)) != cudaSuccess) return (int)e;
  if (embedded) {
    if ((e = row_map(&m0, pts, P, d.k0, d.k0)) != cudaSuccess
        || (e = row_map(&mv, aux, P, d.kv, d.kv)) != cudaSuccess)
      return (int)e;
  }
  const CUtensorMap& x0m = embedded ? m0 : mx;
  const CUtensorMap& xvm = embedded ? mv : mx;
  const int x0c = embedded ? 0 : xc.x0, xvc = embedded ? 0 : xc.xv;
  const int x0n = rup64(d.k0) / KC, xvn = rup64(d.kv) / KC, hn = w / KC;

  // 2. the MMA layers, each's weight block in the image after the last
  const bf16* wl = reinterpret_cast<const bf16*>(img);
  auto layer = [&](const CUtensorMap& a0, int c0, int n0,
                   const CUtensorMap& a1, int c1, int n1, int N,
                   const float* bl, int relu, int col) {
    const cudaError_t r = gemm_layer(a0, c0, n0, a1, c1, n1, wl, N, bl, relu,
                                     X + col, ldx, P, stream);
    wl += (size_t)N * (n0 + n1) * KC;
    return r;
  };
  for (int i = 0; i < depth && e == cudaSuccess; ++i) {
    const float* bl = bias + (size_t)i * w;
    if (i == 0)
      e = layer(x0m, x0c, x0n, x0m, 0, 0, w, bl, 1, xc.at(0, w));
    else if (skip[i])
      e = layer(x0m, x0c, x0n, mx, xc.at(i - 1, w), hn, w, bl, 1,
                xc.at(i, w));
    else
      e = layer(mx, xc.at(i - 1, w), hn, mx, 0, 0, w, bl, 1, xc.at(i, w));
  }
  if (e == cudaSuccess)
    e = layer(mx, xc.at(depth - 1, w), hn, mx, 0, 0, w,
              bias + (size_t)depth * w, 0, xc.feat);
  if (e == cudaSuccess)
    e = layer(mx, xc.feat, hn, xvm, xvc, xvn, w / 2,
              bias + (size_t)(depth + 1) * w, 1, xc.hv);
  if (e != cudaSuccess) return (int)e;

  // 3. the heads: HEAD_BLOCKS_PER_SM blocks an SM, at most a warp a point
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess
      || (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess)
    return (int)e;
  const int head_pts = (int)((P + LT / 32 - 1) / (LT / 32));
  const int head_blocks = sms * HEAD_BLOCKS_PER_SM < head_pts
                              ? sms * HEAD_BLOCKS_PER_SM : head_pts;
  const size_t head_smem = (size_t)(3 * (w / 2) + w) * sizeof(float);
  if ((e = cudaFuncSetAttribute(heads_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)head_smem)) != cudaSuccess)
    return (int)e;
  heads_kernel<<<head_blocks, LT, head_smem, stream>>>(
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
