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
//  1. phase A (IN_PTS: K1, IN_RAW: K3; K4's inputs are already embedded):
//     the geometry, window and cutoff PE of a 64-point tile, the same
//     arithmetic as the single kernel, one CTA a tile, in 16-byte groups
//     of 8 bf16, one thread a group; phase_a_rows_kernel stages blocks of
//     8 whole rows of X (x0 at column 0 and xv at rup64(k0), each
//     zero-padded to a multiple of 64 columns) and stores them whole;
//     phase_a_act_kernel (with SAVE) writes act's feature rows, a warp
//     whole 128-byte rows. K1's view bands are computed once per ray the
//     tile touches (tables in shared memory) and weighted per point; K3's
//     rows carry per-point directions, so its bands stay per point.
//  2. layer_gemm_kernel, once per MMA layer: C = A W^T + bias (ReLU but on
//     the feature layer), rounded to bf16. A is one or two segments of the
//     activations (a skip layer's [x0 | h], the view layer's [feat | xv]),
//     B the layer's k-slices of the weight image 'img' that the single
//     kernel reads (to_sm90_image: each slice's rows already in the wgmma
//     K-major 128-byte swizzle). Persistent: one cluster of GCL CTAs per
//     pair of SMs that can hold one (cudaOccupancyMaxActiveClusters)
//     walks the (group of GCL point tiles, output block) items, the output
//     blocks of a group together, so that the second block's A rows come
//     from L2. A CTA is a producer warp and two consumer warpgroups
//     (setmaxnreg 40 / 232). The producer keeps a ring of up to
//     MAX_STAGES k-slices full, guarded by full / empty mbarriers: A's
//     GM x 64 slice, B's BN x 64 slice by one 1-D bulk copy from the image,
//     each CTA of the cluster copying 1/GCL of it multicast to both, so
//     that each weight byte leaves L2 once per 2 GM points (K1's single
//     kernel copies its image the same way). Each consumer warpgroup runs
//     wgmma.m64n256k16 (m64n128k16 on a 128-wide block) on its 64 rows
//     over the whole output block, f32 accumulators in registers, one
//     wgmma group in flight while the next slice's wait runs; a slice is
//     released to the producers of both CTAs once the group after it has
//     been issued and its own has completed. The epilogue (bias, ReLU,
//     bf16 rounding: the single kernel's arithmetic) stages STG_COLS
//     columns at a time in shared memory while the producer already loads
//     the next item's slices. Two layouts of the activations:
//     - without SAVE (K1, K3, K4), the row-major buffer X: A's slice comes
//       by one TMA load (cp.async.bulk.tensor.2d, the 128-byte swizzle
//       done by the copy engine; a tensor map for each segment's rows),
//       and the epilogue leaves as coalesced 16-byte stores of rows;
//     - with SAVE (K2's recompute), K2's act layout itself (sm90_common.
//       cuh: act_at), where every MLP input and activation is written
//       once, where it is made: a 64-point tile's 64 feature rows are
//       8 KB contiguous, already in the 128-byte swizzle with the points
//       as the contiguous index, so A's slice comes by one 1-D bulk copy
//       a warpgroup's tile and goes to wgmma MN-major (transposed A); the
//       epilogue transposes its chunk into act's layout with
//       stmatrix.trans and leaves it as one bulk store (16 KB of
//       contiguous feature rows). Points past P are written as zeros. X
//       then holds only what the heads read: the last trunk layer's rows
//       and hv, written by their layers' epilogues as well.
//  3. heads_kernel: the 3-wide rgb and 1-wide alpha heads, f32 dot
//     products of the bf16 hv and last trunk activations with the f32 head
//     weights, plus b_out: the weights in shared memory, a warp a point
//     at a time, 16-byte loads along the row, a fixed shuffle tree for
//     the sums.
// 1 + (depth + 2) + 1 launches (K4: no phase A).

#include <cuda.h>

#include "sm90_common.cuh"

namespace {

constexpr int LT = 256;                  // threads of phase A and heads
constexpr int L_IN_PTS = 0, L_IN_RAW = 1, L_IN_EMBEDDED = 2;

__host__ __device__ inline int rup64(int n) { return (n + KC - 1) / KC * KC; }

// ---- phase A ----
// Two kernels of the same arithmetic, one for each layout of the MLP
// inputs: phase_a_rows_kernel writes X's rows (K1, K3), phase_a_act_kernel
// K2's act tiles (K1 with SAVE). Both compute the geometry and window of
// each (point, joint) first, then x0 = [v w | each kp band's [sin | cos]
// (v 2^k) w | bone dirs | 0] and xv = [dv w | each view band's [sin | cos]
// (dv 2^k) w | fc | 0] (x0 and xv zero-padded to multiples of 64) in
// groups of 8 bf16, one thread a group, each group leaving as one 16-byte
// store of a whole run of contiguous bytes. K1's view bands are computed
// once per ray a tile touches (a table in shared memory) and weighted per
// point; K3's rows carry per-point directions, so its bands stay per
// point. The arithmetic is the single kernel's (exact fp32 geometry, the
// overflow-safe window, accurate sincosf and expf): a band's sincosf of
// the same value gives the same bits per ray as per point.

// One view band's [sin | cos] columns: a row of K1's per-ray table.
constexpr int PA_UNIT = 2 * C72;
// Points of phase_a_rows_kernel's staged block of whole rows.
constexpr int PA_RB = 8;
// The most shared memory phase_a_rows_kernel gives K1's tables of every
// view band; a tile whose rays need more takes its bands per point.
constexpr int PA_TABLES = 32 * 1024;

// Rays a 64-point tile of S samples a ray can touch (K1's view-band table).
__host__ __device__ inline int pa_rays(int S) {
  const int n = (TM - 1) / S + 2;
  return n < TM ? n : TM;
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  return u;
}

// v[0 .. 7] = p[0 .. 7], p 16-byte aligned (shared memory).
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

// Point p's joint j: the distance v, the window weight w and the bone
// direction b (K1: from the world point and its ray's m_all / aux rows;
// K3: from its row [v | r | ...]).
template <int MODE>
__device__ __forceinline__ void pa_joint(const float* __restrict__ pts,
                                         const float* __restrict__ m_all,
                                         const float* __restrict__ aux,
                                         const float* __restrict__ cut,
                                         const Dims& d, int p, int S, int j,
                                         float tau, float& v, float& w,
                                         float (&b)[3]) {
  float q[3], inv;
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
      q[a] = fmaf(m[2 * C72 + c], z, fmaf(m[C72 + c], y, m[c] * x)) + tr[c];
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
  w = 1.f / (1.f + expf(tau * (v - cut[j])));
#pragma unroll
  for (int a = 0; a < 3; ++a) b[a] = q[a] * inv;
}

// Shared memory of phase_a_rows_kernel: PA_RB staged rows of the x0 | xv
// columns (+ 8, moving successive rows onto other banks), the block's
// distances and window weights (PA_RB x (J + 4) f32 each), K1's tables of
// every view band (pa_rays x nfv x PA_UNIT f32, where they fit in
// PA_TABLES), the bone directions (PA_RB x C72 bf16), each point's ray in
// the tile.
__host__ __device__ inline int pa_rows_cols(const Dims& d) {
  return rup64(d.k0) + rup64(d.kv) + 8;
}
__host__ __device__ inline bool pa_tables(int mode, int S, int nfv) {
  return mode == L_IN_PTS && pa_rays(S) * nfv * PA_UNIT * 4 <= PA_TABLES;
}
__host__ __device__ inline int pa_rows_smem(int mode, const Dims& d, int S,
                                            int nfv) {
  return PA_RB * pa_rows_cols(d) * 2 + 2 * PA_RB * (J + 4) * 4
         + (pa_tables(mode, S, nfv) ? pa_rays(S) * nfv * PA_UNIT * 4 : 0)
         + PA_RB * C72 * 2 + PA_RB * 4;
}

// Phase A of K1 (IN_PTS: world points, per-ray m_all and aux rows of
// d.auxw floats) or K3 (IN_RAW: per-point rows of d.raww floats
// [v | r | d | fc | pad]) for one tile of 64 points into X's rows (stride
// ld): x0 at column 0, xv at rup64(k0), the columns of the two side by
// side. Blocks of PA_RB points at a time: their geometry, then each
// thread fills 16-byte groups of the block's staged rows, (row, group)
// with the rows varying fastest, a kp band's sin and cos groups of 8
// joints (or a view band's of 8 columns) by one thread, then the rows
// leave whole, as runs of 16-byte stores. K1's view-band tables of every
// band are computed first, where they fit (pa_tables); else K1's bands,
// as K3's, are computed per point.
template <int MODE>
__global__ void __launch_bounds__(LT)
phase_a_rows_kernel(const float* __restrict__ pts,
                    const float* __restrict__ m_all,
                    const float* __restrict__ aux,
                    const float* __restrict__ cut, bf16* __restrict__ X,
                    int ld, int P, int S, int nfk, int nfv, int fc,
                    float tau) {
  const Dims d = make_dims(nfk, nfv, fc);
  const int SP = pa_rows_cols(d), x0w = rup64(d.k0);
  const bool tables = pa_tables(MODE, S, nfv);
  extern __shared__ __align__(16) float pa_raw[];
  bf16* stg = reinterpret_cast<bf16*>(pa_raw);
  float* V = reinterpret_cast<float*>(stg + PA_RB * SP);
  float* Wt = V + PA_RB * (J + 4);
  float* tab = Wt + PA_RB * (J + 4);
  bf16* Q = reinterpret_cast<bf16*>(
      tab + (tables ? pa_rays(S) * nfv * PA_UNIT : 0));
  int* ray = reinterpret_cast<int*>(Q + PA_RB * C72);
  const int tid = threadIdx.x, row0 = blockIdx.x * TM;
  const int ray_lo = row0 / S;
  if (tables) {
    const int nr = (min(row0 + TM, P) - 1) / S - ray_lo + 1;
    for (int it = tid; it < nr * nfv * C72; it += LT) {
      const int c = it % C72, rk = it / C72, k = rk % nfv, rr = rk / nfv;
      float sn, cs;
      sincosf(aux[(size_t)(ray_lo + rr) * d.auxw + C72 + c]
                  * (float)(1 << k), &sn, &cs);
      tab[rk * PA_UNIT + c] = sn;
      tab[rk * PA_UNIT + C72 + c] = cs;
    }
  }
  // a row's groups: v (3), the kp bands' sin | cos pairs (3 each), the
  // bone dirs and x0's padding, dv (9), the view bands' pairs (9 each),
  // the framecode and xv's padding
  const int nb = J * (1 + 2 * nfk), gb = (x0w - nb) / 8;
  const int c0 = d.kv - d.fc, gf = (rup64(d.kv) - c0) / 8;
  const int q_band = 3, q_bone = q_band + 3 * nfk, q_dv = q_bone + gb;
  const int q_view = q_dv + C72 / 8, q_fc = q_view + 9 * nfv;
  const int n_q = q_fc + gf;

  for (int rb = 0; rb < TM; rb += PA_RB) {
    const int base = row0 + rb;
    if (base >= P) break;
    for (int it = tid; it < PA_RB * J; it += LT) {
      const int rr = it / J, j = it - rr * J;
      const int p = last_row(base + rr, P);
      float v, w, b[3];
      pa_joint<MODE>(pts, m_all, aux, cut, d, p, S, j, tau, v, w, b);
      V[rr * (J + 4) + j] = v;
      Wt[rr * (J + 4) + j] = w;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        Q[rr * C72 + j * 3 + a] = __float2bfloat16_rn(b[a]);
      if (j == 0) ray[rr] = p / S - ray_lo;
    }
    __syncthreads();                     // (and the tables, the first time)
    for (int it = tid; it < PA_RB * n_q; it += LT) {
      const int rr = it % PA_RB, q = it / PA_RB;
      const float* v = V + rr * (J + 4);
      const float* w = Wt + rr * (J + 4);
      const float* in = MODE == L_IN_PTS
          ? aux + (size_t)(ray_lo + ray[rr]) * d.auxw
          : pts + (size_t)last_row(base + rr, P) * d.raww + J;
      bf16* row = stg + rr * SP;
      float a[8], c8[8];
      int col, col2 = -1;
      if (q < q_band) {                  // v w of joints 8 q ..
        col = 8 * q;
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = v[col + e] * w[col + e];
      } else if (q < q_bone) {           // band k, joints 8 g ..
        const int k = (q - q_band) / 3, g = q - q_band - 3 * k;
        const float f = (float)(1 << k);
        float vv[8], ww[8];
        ld8(v + 8 * g, vv);
        ld8(w + 8 * g, ww);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sincosf(vv[e] * f, &a[e], &c8[e]);
          a[e] *= ww[e];
          c8[e] *= ww[e];
        }
        col = J + 2 * J * k + 8 * g;
        col2 = col + J;
      } else if (q < q_dv) {             // bone dirs, x0's padding
        col = nb + 8 * (q - q_bone);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          a[e] = col - nb + e < C72
                     ? __bfloat162float(Q[rr * C72 + col - nb + e]) : 0.f;
      } else if (q < q_view) {           // dv w of columns 8 g ..
        const int c = 8 * (q - q_dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          a[e] = in[C72 + c + e] * w[(c + e) / 3];
        col = x0w + c;
      } else if (q < q_fc) {             // view band k, columns 8 g ..
        const int k = (q - q_view) / 9, c = 8 * (q - q_view - 9 * k);
        if (tables) {
          const float* t = tab + (ray[rr] * nfv + k) * PA_UNIT + c;
          ld8(t, a);
          ld8(t + C72, c8);
        } else {
          const float f = (float)(1 << k);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            sincosf(in[C72 + c + e] * f, &a[e], &c8[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float we = w[(c + e) / 3];
          a[e] *= we;
          c8[e] *= we;
        }
        col = x0w + C72 + 2 * C72 * k + c;
        col2 = col + C72;
      } else {                           // the framecode, xv's padding
        const int c = 8 * (q - q_fc);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          a[e] = c + e < d.fc ? in[2 * C72 + c + e] : 0.f;
        col = x0w + c0 + c;
      }
      *reinterpret_cast<uint4*>(row + col) = pack8(a);
      if (col2 >= 0) *reinterpret_cast<uint4*>(row + col2) = pack8(c8);
    }
    __syncthreads();
    const int g_row = (SP - 8) / 8;
    for (int it = tid; it < PA_RB * g_row; it += LT) {
      const int rr = it / g_row, g = it - rr * g_row;
      if (base + rr < P)
        *reinterpret_cast<uint4*>(X + (size_t)(base + rr) * ld + 8 * g) =
            *reinterpret_cast<const uint4*>(stg + rr * SP + 8 * g);
    }
  }
}

// Shared memory of phase_a_act_kernel: the tile's distances and window
// weights (J x (TM + 4) f32 each: the points of a joint contiguous, the 4
// spare moving successive joints onto other banks), each point's ray in
// the tile, the bone directions (C72 x TM bf16), and K1's view-band tables
// of two bands in turn (2 x pa_rays x PA_UNIT f32).
__host__ __device__ inline int pa_act_smem(int S) {
  return 2 * J * (TM + 4) * 4 + TM * 4 + C72 * TM * 2
         + 2 * pa_rays(S) * PA_UNIT * 4;
}

// One unit of phase_a_act_kernel's columns (`n` feature rows of act from
// row col on; n % 8 == 0): 16-byte groups of 8 consecutive points
// 8 pg .. 8 pg + 7 of one feature row c, fill(pg, c, v) (with PAIR
// fill(pg, c, v, w), w the group of feature row c + n: sin | cos), points
// past P zero, each stored at its swizzled place (act_at), so that a warp
// writes whole 128-byte rows.
template <bool PAIR, class Fill>
__device__ __forceinline__ void pa_act_groups(bf16* tile, int row0, int P,
                                              int col, int n, Fill fill) {
  float a[8], b[8];
  for (int it = threadIdx.x; it < n * 8; it += LT) {
    const int pg = it & 7, c = it >> 3;
    if constexpr (PAIR) fill(pg, c, a, b);
    else fill(pg, c, a);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (row0 + 8 * pg + e >= P) a[e] = b[e] = 0.f;
    const int f = col + c;
    *reinterpret_cast<uint4*>(tile + (size_t)f * TM + 8 * (pg ^ (f & 7))) =
        pack8(a);
    if constexpr (PAIR)
      *reinterpret_cast<uint4*>(tile + (size_t)(f + n) * TM
                                + 8 * (pg ^ ((f + n) & 7))) = pack8(b);
  }
}

// Phase A of K1 with SAVE for one tile of 64 points into act's tile (F
// feature rows; x0 at feature row 0, xv at xv_row; points past P zero):
// the tile's geometry, then each unit of columns by pa_act_groups; view
// band k + 1's table is computed while band k is stored.
__global__ void __launch_bounds__(LT)
phase_a_act_kernel(const float* __restrict__ pts,
                   const float* __restrict__ m_all,
                   const float* __restrict__ aux,
                   const float* __restrict__ cut, bf16* __restrict__ act,
                   int xv_row, int F, int P, int S, int nfk, int nfv, int fc,
                   float tau) {
  extern __shared__ __align__(16) float pa_raw[];
  float* V = pa_raw;                             // distances
  float* Wt = V + J * (TM + 4);                  // window weights
  int* ray = reinterpret_cast<int*>(Wt + J * (TM + 4));
  bf16* Q = reinterpret_cast<bf16*>(ray + TM);   // bone directions
  float* tab = reinterpret_cast<float*>(Q + C72 * TM);
  const int nr_max = pa_rays(S);
  const Dims d = make_dims(nfk, nfv, fc);
  const int tid = threadIdx.x, row0 = blockIdx.x * TM;
  const int ray_lo = row0 / S;
  const int nr = (min(row0 + TM, P) - 1) / S - ray_lo + 1;
  bf16* tile = act + (size_t)blockIdx.x * F * TM;
  // view band k's table: per ray of the tile, [sin | cos](dv 2^k)
  auto table = [&](int k) {
    float* t = tab + (k & 1) * nr_max * PA_UNIT;
    const float f = (float)(1 << k);
    for (int it = tid; it < nr * C72; it += LT) {
      const int rr = it / C72, c = it - rr * C72;
      float sn, cs;
      sincosf(aux[(size_t)(ray_lo + rr) * d.auxw + C72 + c] * f, &sn, &cs);
      t[rr * PA_UNIT + c] = sn;
      t[rr * PA_UNIT + C72 + c] = cs;
    }
  };
  for (int it = tid; it < TM * J; it += LT) {
    const int r = it & (TM - 1), j = it >> 6;
    const int p = last_row(row0 + r, P);
    float v, w, b[3];
    pa_joint<L_IN_PTS>(pts, m_all, aux, cut, d, p, S, j, tau, v, w, b);
    V[j * (TM + 4) + r] = v;
    Wt[j * (TM + 4) + r] = w;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      Q[(j * 3 + a) * TM + r] = __float2bfloat16_rn(b[a]);
    if (j == 0) ray[r] = p / S - ray_lo;
  }
  if (nfv > 0) table(0);
  __syncthreads();

  // x0: v w, each kp band's [sin | cos](v 2^k) w, the bone dirs, padding
  pa_act_groups<false>(tile, row0, P, 0, J,
                       [&](int pg, int j, float (&a)[8]) {
    float v[8], w[8];
    ld8(V + j * (TM + 4) + 8 * pg, v);
    ld8(Wt + j * (TM + 4) + 8 * pg, w);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = v[e] * w[e];
  });
  for (int k = 0; k < nfk; ++k) {
    const float f = (float)(1 << k);
    pa_act_groups<true>(tile, row0, P, J + 2 * J * k, J,
                        [&](int pg, int j, float (&a)[8], float (&b)[8]) {
      float v[8], w[8];
      ld8(V + j * (TM + 4) + 8 * pg, v);
      ld8(Wt + j * (TM + 4) + 8 * pg, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sincosf(v[e] * f, &a[e], &b[e]);
        a[e] *= w[e];
        b[e] *= w[e];
      }
    });
  }
  const int nb = J * (1 + 2 * nfk);
  pa_act_groups<false>(tile, row0, P, nb, rup64(d.k0) - nb,
                       [&](int pg, int c, float (&a)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      a[e] = c < C72 ? __bfloat162float(Q[c * TM + 8 * pg + e]) : 0.f;
  });
  // xv: dv w (dv per ray), each view band's [sin | cos](dv 2^k) w from
  // the tables, the framecode and padding. A group's 8 points mostly share
  // one ray: its values are read once
  auto in_row = [&](int r) {
    return aux + (size_t)(ray_lo + ray[r]) * d.auxw;
  };
  auto one_ray = [&](int pg) { return ray[8 * pg] == ray[8 * pg + 7]; };
  pa_act_groups<false>(tile, row0, P, xv_row, C72,
                       [&](int pg, int c, float (&a)[8]) {
    float w[8];
    ld8(Wt + (c / 3) * (TM + 4) + 8 * pg, w);
    const float dv = in_row(8 * pg)[C72 + c];
    const bool one = one_ray(pg);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      a[e] = (one ? dv : in_row(8 * pg + e)[C72 + c]) * w[e];
  });
  const int c0 = d.kv - d.fc;
  pa_act_groups<false>(tile, row0, P, xv_row + c0, rup64(d.kv) - c0,
                       [&](int pg, int c, float (&a)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      a[e] = c < d.fc ? in_row(8 * pg + e)[2 * C72 + c] : 0.f;
  });
  for (int k = 0; k < nfv; ++k) {
    if (k > 0) __syncthreads();          // table k is whole, k - 1 read
    if (k + 1 < nfv) table(k + 1);
    const float* t = tab + (k & 1) * nr_max * PA_UNIT;
    pa_act_groups<true>(tile, row0, P, xv_row + C72 + 2 * C72 * k, C72,
                        [&](int pg, int c, float (&a)[8], float (&b)[8]) {
      float w[8];
      ld8(Wt + (c / 3) * (TM + 4) + 8 * pg, w);
      const float* t0 = t + ray[8 * pg] * PA_UNIT + c;
      const float sn = t0[0], cs = t0[C72];
      const bool one = one_ray(pg);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float* te = one ? t0 : t + ray[8 * pg + e] * PA_UNIT + c;
        a[e] = (one ? sn : te[0]) * w[e];
        b[e] = (one ? cs : te[C72]) * w[e];
      }
    });
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
// k-slices from column col_s on: of map s (bf16 rows, boxes of 64 columns
// x GM rows, zero past its columns and rows), or with ACT of act's feature
// rows (F a tile of 64 points, `tiles` tiles).
struct GemmArgs {
  int col0, col1, nch0, nch1;
  const unsigned char* w;  // the layer's weight image: k-slices of N x 128 B
  int N;                   // outputs
  const float* bias;
  int relu;
  bf16* out;               // C(p, n) at out[p * ldo + n], or null (ACT only)
  int ldo, P;
  int n_blocks, n_groups;  // output blocks; groups of CL point tiles
  bf16* act;               // ACT: A's rows, and C's at feature rows act_col..
  int F, act_col, tiles;
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

template <int NACC, int CL, bool ACT>
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
        // ACT: the act tiles of the item's two warpgroups that exist
        const int t0 = row0 / TM;
        const int live = ACT ? min(2, max(0, L.tiles - t0)) : 2;
        for (int c = 0; c < nk; ++c, ++it) {
          const int s = it % NSTG;
          mbar_wait(empty + 8 * s, ((it / NSTG) & 1) ^ 1);
          const uint32_t a = ring + s * STG, fb = full + 8 * s;
          mbar_expect_tx(fb, live * (A_BYTES / 2) + rows * 128);
          const int col = c < L.nch0 ? L.col0 + c * KC
                                     : L.col1 + (c - L.nch0) * KC;
          if constexpr (ACT) {
            for (int h = 0; h < live; ++h)
              bulk_load(a + h * (A_BYTES / 2),
                        L.act + ((size_t)(t0 + h) * L.F + col) * KC,
                        A_BYTES / 2, fb);
          } else {
            tma_load_2d(a, c < L.nch0 ? &map0 : &map1, col, row0, fb);
          }
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
  const uint32_t my_s = smem_u32(my);
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
      for (int kk = 0; kk < KC / 16; ++kk) {
        // ACT: A's 64 feature rows of 64 points, k = 16 rows of 128 bytes
        if constexpr (ACT)
          wgmma<NACC, 1>(d, gmma_desc_mn(a + kk * 2048),
                         gmma_desc(b + kk * 32));
        else
          wgmma<NACC>(d, gmma_desc(a + kk * 32), gmma_desc(b + kk * 32));
      }
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
    // are staged, then leave: rows of X as 16-byte stores (16-byte group
    // h of row r staged at h ^ (r % 8): no bank conflicts either way);
    // with ACT, act's feature rows of this warpgroup's tile, transposed
    // by stmatrix.trans into act's layout (points past P zero) and
    // stored by one bulk copy
    const int cols = min(BN, L.N - n0);
    const bool lo = row0 + r0 < L.P, hi = row0 + r0 + 8 < L.P;
    constexpr int CPR = STG_COLS / 8;   // 16-byte groups of a staged row
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += STG_COLS) {
      if (L.out != nullptr) {
        if (ACT && t == 0) bulk_wait_read();
        wg_sync(wg);                    // the staging's last reads are done
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
            *reinterpret_cast<uint4*>(L.out + (size_t)(row0 + r) * L.ldo
                                      + n0 + c0 + ch * 8) =
                *reinterpret_cast<const uint4*>(
                    my + r * STG_COLS + 8 * (ch ^ (r & 7)));
        }
      }
      if constexpr (ACT) {
        if (t == 0) bulk_wait_read();
        wg_sync(wg);
        // matrices (j, rows 16 w ..), (j, rows 16 w + 8 ..), the same of
        // j + 1; staged feature row c = 8 j' + i - c0 holds the 64 points
        // in 16-byte groups of 8, group g at g ^ (c % 8)
        const int m = lane >> 3, i = lane & 7;
        const uint32_t at =
            my_s + 2 * (8 * ((m >> 1)) * 64 + i * 64
                        + 8 * ((2 * (t >> 5) + (m & 1)) ^ i));
#pragma unroll
        for (int j = c0 / 8; j < (c0 + STG_COLS) / 8; j += 2) {
          uint32_t rg[4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int jj = j + hh, col = 8 * jj + 2 * q;
            const float b0 = col < cols ? __ldg(L.bias + n0 + col) : 0.f;
            const float b1 =
                col < cols ? __ldg(L.bias + n0 + col + 1) : 0.f;
            float v0 = d[4 * jj] + b0, v1 = d[4 * jj + 1] + b1;
            float v2 = d[4 * jj + 2] + b0, v3 = d[4 * jj + 3] + b1;
            if (L.relu) {
              v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
              v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
            }
            rg[2 * hh] = lo ? pack_bf16(v0, v1) : 0u;
            rg[2 * hh + 1] = hi ? pack_bf16(v2, v3) : 0u;
          }
          stmatrix_x4_trans(at + 2 * (8 * (j - c0 / 8)) * 64, rg[0], rg[1],
                            rg[2], rg[3]);
        }
        fence_async_smem();             // st.shared before the bulk copy
        wg_sync(wg);
        if (t == 0 && row0 < L.P && c0 < cols)
          bulk_store(L.act + ((size_t)(row0 / TM) * L.F + L.act_col + n0
                              + c0) * KC,
                     my_s, min(STG_COLS, cols - c0) * 128);
      }
    }
  }
  if constexpr (ACT)
    if (t == 0) bulk_wait();
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

// Columns of X for a layered call (see anerf_layered_forward): without
// SAVE x0 | xv (not K4's: its rows are read in place) | two trunk buffers
// (h_i at h[i & 1]) | hv, feat in the buffer the last trunk layer does not
// hold; with SAVE the activations live in act (make_act_rows) and X holds
// the heads' inputs alone: the last trunk layer at column 0, hv at w.
struct XCols {
  int x0, xv, feat, hv, need;
  int h[2];
  int last(int depth) const { return h[(depth - 1) & 1]; }
};

XCols x_cols(const Dims& d, int depth, int w, bool save, bool embedded) {
  XCols c;
  if (save) {
    c.x0 = c.xv = c.feat = -1;
    c.h[0] = c.h[1] = 0;
    c.hv = w;
    c.need = w + w / 2;
    return c;
  }
  const ActRows ar = make_act_rows(d, 1, w);
  const int base = embedded ? 0 : ar.h;
  c.x0 = ar.x0;
  c.xv = ar.xv;
  c.h[0] = base;
  c.h[1] = base + w;
  c.feat = c.h[depth & 1];               // not the last trunk layer's
  c.hv = base + 2 * w;
  c.need = base + 2 * w + w / 2;
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

// One persistent launch of layer_gemm_kernel<NACC, CL, ACT>: as many
// clusters as the device holds at once (asked once a process and
// instantiation), at most one an item.
template <int NACC, int CL, bool ACT>
cudaError_t launch_gemm(const CUtensorMap& m0, const CUtensorMap& m1,
                        const GemmArgs& L, cudaStream_t stream) {
  auto kernel = layer_gemm_kernel<NACC, CL, ACT>;
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

template <bool ACT>
cudaError_t launch_gemm_block(bool wide, int cl, const CUtensorMap& m0,
                              const CUtensorMap& m1, const GemmArgs& L,
                              cudaStream_t stream) {
  if (wide)
    return cl == GCL ? launch_gemm<128, GCL, ACT>(m0, m1, L, stream)
                     : launch_gemm<128, 1, ACT>(m0, m1, L, stream);
  return cl == GCL ? launch_gemm<64, GCL, ACT>(m0, m1, L, stream)
                   : launch_gemm<64, 1, ACT>(m0, m1, L, stream);
}

// The plan of one layer of N outputs on P points (layered_plan mirrors
// it): the block, the cluster, the launch. A's segments are columns of
// the maps' rows, or with act (F rows a tile) its feature rows; C goes to
// out's columns (if out) and to act's feature rows from act_col on.
cudaError_t gemm_layer(const CUtensorMap& m0, int col0, int nch0,
                       const CUtensorMap& m1, int col1, int nch1,
                       const bf16* w, int N, const float* bias, int relu,
                       bf16* out, int ldo, int P, bf16* act, int F,
                       int act_col, cudaStream_t stream) {
  const bool wide = N % 256 == 0;
  const int bn = wide ? 256 : 128, tiles = (P + GM - 1) / GM;
  const int cl = tiles >= GCL ? GCL : 1;
  const GemmArgs L{col0, col1, nch0, nch1,
                   reinterpret_cast<const unsigned char*>(w), N, bias, relu,
                   out, ldo, P, (N + bn - 1) / bn, (tiles + cl - 1) / cl,
                   act, F, act_col, (P + TM - 1) / TM};
  return act != nullptr
             ? launch_gemm_block<true>(wide, cl, m0, m1, L, stream)
             : launch_gemm_block<false>(wide, cl, m0, m1, L, stream);
}

// Phase A's launch: K1 (IN_PTS) or K3 (IN_RAW) into X's rows (ld
// columns), or with act (K1 only) into act's tiles (F feature rows, xv at
// feature row xv_row).
cudaError_t launch_phase_a(int mode, const float* pts, const float* m_all,
                           const float* aux, const float* cut, bf16* X,
                           int ld, bf16* act, int xv_row, int F, int P,
                           int S, int nfk, int nfv, int fc, float tau,
                           cudaStream_t stream) {
  const int tiles = (P + TM - 1) / TM;
  cudaError_t e;
  if (act != nullptr) {
    const int smem = pa_act_smem(S);
    if ((e = cudaFuncSetAttribute(
             phase_a_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem)) != cudaSuccess)
      return e;
    phase_a_act_kernel<<<tiles, LT, smem, stream>>>(
        pts, m_all, aux, cut, act, xv_row, F, P, S, nfk, nfv, fc, tau);
    return cudaGetLastError();
  }
  auto kernel = mode == L_IN_PTS ? phase_a_rows_kernel<L_IN_PTS>
                                 : phase_a_rows_kernel<L_IN_RAW>;
  const int smem = pa_rows_smem(mode, make_dims(nfk, nfv, fc), S, nfv);
  if ((e = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      != cudaSuccess)
    return e;
  kernel<<<tiles, LT, smem, stream>>>(pts, m_all, aux, cut, X, ld, P, S, nfk,
                                      nfv, fc, tau);
  return cudaGetLastError();
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
// fused_render.py:layered_columns). With act != null (mode 0 only) every
// MLP input and activation goes to K2's saved activations `act` (tiles of
// make_act_rows' F feature rows), where the layers read them, and X holds
// the heads' inputs alone. Returns a cudaError_t code.
int anerf_layered_forward(int mode, const void* pts, const float* m_all,
                          const void* aux, const void* img,
                          const float* bias, const float* w_rgb,
                          const float* w_alpha, const float* b_out,
                          const float* cut, float* out, int P, int S, int w,
                          int depth, const int* skip, int nfk, int nfv,
                          int fc, float tau, void* xbuf, int ldx, void* act,
                          void* stream_v) {
  const bool embedded = mode == L_IN_EMBEDDED, save = act != nullptr;
  if ((mode != L_IN_PTS && mode != L_IN_RAW && !embedded) || depth < 1
      || w % 256 != 0 || ldx % 8 != 0 || P < 1 || S < 1
      || (save && mode != L_IN_PTS)
      || (embedded && (nfk % 8 != 0 || nfv % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  const Dims d = embedded ? make_dims_k(nfk, nfv) : make_dims(nfk, nfv, fc);
  const XCols xc = x_cols(d, depth, w, save, embedded);
  const ActRows ar = make_act_rows(d, depth, w);
  if (ldx < xc.need) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_v;
  bf16* X = reinterpret_cast<bf16*>(xbuf);
  bf16* A = reinterpret_cast<bf16*>(act);
  cudaError_t e = cudaSuccess;

  // 1. phase A
  if (!embedded
      && (e = launch_phase_a(mode, reinterpret_cast<const float*>(pts),
                             m_all, reinterpret_cast<const float*>(aux), cut,
                             X, ldx, A, ar.xv, ar.F, P,
                             mode == L_IN_PTS ? S : 1, nfk, nfv, fc, tau,
                             stream)) != cudaSuccess)
    return (int)e;

  // the GEMMs' A without SAVE: X's columns, and K4's x0 / xv rows where
  // they are read in place (with SAVE, act's feature rows; the maps are
  // not read)
  CUtensorMap mx, m0, mv;
  if ((e = row_map(&mx, X, P, ldx, ldx)) != cudaSuccess) return (int)e;
  if (embedded) {
    if ((e = row_map(&m0, pts, P, d.k0, d.k0)) != cudaSuccess
        || (e = row_map(&mv, aux, P, d.kv, d.kv)) != cudaSuccess)
      return (int)e;
  }
  const CUtensorMap& x0m = embedded ? m0 : mx;
  const CUtensorMap& xvm = embedded ? mv : mx;
  const int x0c = save ? ar.x0 : embedded ? 0 : xc.x0;
  const int xvc = save ? ar.xv : embedded ? 0 : xc.xv;
  const int x0n = rup64(d.k0) / KC, xvn = rup64(d.kv) / KC, hn = w / KC;
  // layer i's output: X's column (without SAVE) or act's feature row
  auto h_at = [&](int i) { return save ? ar.h + i * w : xc.h[i & 1]; };
  const int feat = save ? ar.feat : xc.feat;

  // 2. the MMA layers, each's weight block in the image after the last;
  // with SAVE, into act, the last trunk layer and hv into X as well
  const bf16* wl = reinterpret_cast<const bf16*>(img);
  auto layer = [&](const CUtensorMap& a0, int c0, int n0,
                   const CUtensorMap& a1, int c1, int n1, int N,
                   const float* bl, int relu, int col, int xcol) {
    bf16* o = save ? (xcol < 0 ? nullptr : X + xcol) : X + col;
    const cudaError_t r =
        gemm_layer(a0, c0, n0, a1, c1, n1, wl, N, bl, relu, o, ldx, P, A,
                   ar.F, col, stream);
    wl += (size_t)N * (n0 + n1) * KC;
    return r;
  };
  for (int i = 0; i < depth && e == cudaSuccess; ++i) {
    const float* bl = bias + (size_t)i * w;
    const int xcol = i == depth - 1 ? xc.last(depth) : -1;
    if (i == 0)
      e = layer(x0m, x0c, x0n, x0m, 0, 0, w, bl, 1, h_at(0), xcol);
    else if (skip[i])
      e = layer(x0m, x0c, x0n, mx, h_at(i - 1), hn, w, bl, 1, h_at(i), xcol);
    else
      e = layer(mx, h_at(i - 1), hn, mx, 0, 0, w, bl, 1, h_at(i), xcol);
  }
  if (e == cudaSuccess)
    e = layer(mx, h_at(depth - 1), hn, mx, 0, 0, w,
              bias + (size_t)depth * w, 0, feat, -1);
  if (e == cudaSuccess)
    e = layer(mx, feat, hn, xvm, xvc, xvn, w / 2,
              bias + (size_t)(depth + 1) * w, 1, save ? ar.hv : xc.hv,
              xc.hv);
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
      X, ldx, xc.hv, xc.last(depth), w, w_rgb, w_alpha, b_out, out, P);
  return (int)cudaGetLastError();
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
