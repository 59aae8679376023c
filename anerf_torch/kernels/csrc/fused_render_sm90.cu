// K1 for Hopper (sm_90a): fused world->local transform + cutoff positional
// encoding + NeRF MLP forward, with the MLP on wgmma and the weights staged
// in shared memory by cluster-multicast bulk copies. Also K1-d, the same
// kernel stopped after a stage (anerf_torch/kernels/stages.py), K2's
// recompute, the same kernel also saving its bf16 MLP inputs and
// activations (SAVE, anerf_k2_recompute_sm90; fused_render_bwd_sm90.cu),
// and K3 and K4, the same kernel in its other input modes (MODE, as
// fused_render_common.cuh defines them): per-point raw rows instead of the
// transform (IN_RAW), or embedded bf16 rows copied in (IN_EMBEDDED).
//
// Replaces the Pallas TPU kernels anerf_tpu/kernels/fused_render.py:
// fused_encode_mlp_pts (kernel body _render_kernel_pts, _transform_tile,
// _forward_trace), fused_encode_mlp (K3, _render_kernel) and
// anerf_tpu/kernels/fused_mlp.py:fused_mlp_apply (K4, _kernel_entry,
// _mlp_chain), and tools/kernel_bench.py:decompose for K1-d. Python side:
// anerf_torch/kernels/fused_render.py (fused_encode_mlp_pts and
// fused_encode_mlp; the plain versions fused_encode_mlp_pts_ref and
// fused_encode_mlp_ref; the weight image to_sm90_image) and
// anerf_torch/kernels/fused_mlp.py (fused_mlp_apply, fused_mlp_apply_ref).
// The first versions (mma.sync, weights streamed from L2 per CTA) stay as
// the comparison: K1-v1 in fused_render.cu, K3-v1 and K4-v1 in
// fused_render_modes.cu.
//
// What bounds it on an H100: operations. The flagship MLP is 1.728 MFLOP a
// point, 1.03 ms of bf16 tensor-core work per 4096-ray bucket (S = 64 +
// 80) at the 989 TFLOP/s dense peak; the points and raw outputs are 28 B a
// point (K3's rows and output 752 B, K4's 2,208 B at the flagship widths:
// 0.13 and 0.39 ms of HBM time a bucket, still below). The mma.sync
// versions read every weight (1.73 MB) from L2 once per 64-point CTA, 64
// FLOP per L2 byte, which L2 cannot feed at the tensor-core rate.
//
// Design:
//  * A cluster of CL CTAs, each a tile of TM = 64 points and three
//    warpgroups: two consumers and one producer.
//  * The weights are a pre-packed image (to_sm90_image in Python): every MMA
//    layer's (N, K) bf16 block, K padded to 64, cut into 64-deep k-slices,
//    each slice in the shared-memory layout wgmma reads as B (K-major,
//    128-byte swizzle), so a slice is one contiguous run of N x 128 bytes.
//    The producer walks the image slice by slice into a ring of STAGES
//    buffers guarded by full / empty mbarriers; each CTA of the cluster
//    copies 1/CL of a slice with one 1-D bulk copy multicast to every CTA
//    of the cluster, so each weight byte leaves L2 once per cluster.
//    A stage is refilled only after every consumer warp of every CTA of
//    the cluster has arrived on the empty barrier (remote arrives, mapa).
//  * The consumers split each layer's N: wgmma m64n128k16 per warpgroup on
//    the 256-wide layers, m64n64k16 on the 128-wide view layer; A is the
//    bf16 activation tile in shared memory (the same swizzled layout),
//    accumulators are f32 in registers. The epilogue adds the bias,
//    applies ReLU, rounds to bf16 and writes the other activation buffer,
//    then fence.proxy.async and a barrier before the next layer's wgmma.
//  * Phase A (the consumers, fp32 CUDA cores; the same arithmetic as
//    K1-v1: exact geometry, the overflow-safe window 1 / (1 + exp(tau (v -
//    cut))), accurate sincosf and expf) writes X0 = [kp bands | bone dirs]
//    while the producer already fills the ring. The view inputs XV are
//    built late, after the feature layer, into X0 and the spent activation
//    buffer (adjacent by the choice of ping-pong parity), so that the tile,
//    two activation buffers and three 32 KB weight stages fit in 227 KB.
//  * The trunk is 256 wide (W); the depth, the per-layer skip flags, the
//    framecode width and the ring's depth (NSTG: three stages, or two for
//    MLP inputs wider than three leave room for) are the config's. Wider
//    trunks and inputs that not even two stages fit beside take the
//    layered route (fused_render_layered_sm90.cu).
//  * K3 (IN_RAW) stages the tile's v | r (24 KB) by cp.async in HB, free
//    until the first layer's epilogue, for phase A1. Its view dirs and
//    framecodes come late, for XV, from the rows in global memory (whole
//    rows, 47 KB a tile, have no room in shared memory): lanes run along a
//    row's channels, so that a warp's loads coalesce, and each thread loads
//    a group of 6 items ahead of the group it computes, so that it waits on
//    one load latency a group. The rows carry no ray structure, so every
//    point computes its own view bands (72 nfv sin / cos pairs), which K1
//    shares across a ray.
//  * K4 (IN_EMBEDDED) copies the tile's bf16 x0 rows into X0 and, late,
//    its xv rows into XV by cp.async, all of a thread's copies in flight
//    before it waits; it has no window.
//  * The 3-wide rgb and 1-wide alpha heads are fp32 dot products taken in
//    the epilogues of the view layer and of the last trunk layer, from the
//    bf16-rounded activations in registers: the view layer's output never
//    reaches shared memory.
// Every mode runs the same producer, ring, MLP, epilogues and heads.

#include "sm90_common.cuh"

namespace {

constexpr int CL = 2;                    // CTAs per cluster
constexpr int STAGES = 3;                // weight stages where they fit
constexpr int STAGE_BYTES = W * KC * 2;  // one k-slice of a 256-wide layer

__host__ __device__ inline int chunks(int k) { return (k + KC - 1) / KC; }

// 64-column chunks of X0, of XV, and of the region XV is built into
// together with the activation buffer HA that follows it.
struct Layout {
  int k0c, kvc, xr;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout l;
  l.k0c = chunks(d.k0);
  l.kvc = chunks(d.kv);
  l.xr = l.k0c > l.kvc - W / KC ? l.k0c : l.kvc - W / KC;
  return l;
}

// With nstg weight stages (STAGES, or 2 where three do not fit beside
// wider MLP inputs: anerf_torch/kernels/fused_render.py:route_plan).
inline size_t smem_bytes_sm90(const Layout& l, int nstg = STAGES) {
  return (size_t)(l.xr + 2 * (W / KC)) * CHUNK * 2   // X0 region, HA, HB
         + (size_t)TM * J * 4                        // windows
         + (size_t)2 * TM * 4 * 4                    // head partials
         + (size_t)nstg * STAGE_BYTES + 2 * nstg * 8
         + 1024;                                     // alignment slack
}

// The ring as the consumers see it: shared addresses of the stages and of
// the full / empty barriers, and the index of the next k-slice.
struct Ring {
  uint32_t stages, full, empty;
  int it;
};

// One MMA layer of this warpgroup: d = A B^T over the k-slices of the
// layer, A from two segments of the tile (n0 chunks at a0, then n1 chunks
// at a1), B = this warpgroup's NACC * 2 rows of each staged slice. Each
// slice is released (on every CTA of the cluster) once the wgmma group
// after it has been issued and its own group has completed.
template <int NACC, int NSTG>
__device__ __forceinline__ void mma_layer(float (&d)[NACC], Ring& ring,
                                          uint32_t a0, int n0, uint32_t a1,
                                          int n1, int wg) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) d[i] = 0.f;
  fence_acc(d);
  wgmma_fence();
  int prev = -1;
#pragma unroll 1
  for (int c = 0; c < n0 + n1; ++c, ++ring.it) {
    const int s = ring.it % NSTG;
    mbar_wait(ring.full + 8 * s, (ring.it / NSTG) & 1);
    const uint32_t a = c < n0 ? a0 + c * CHUNK * 2 : a1 + (c - n0) * CHUNK * 2;
    const uint32_t b = ring.stages + s * STAGE_BYTES + wg * NACC * 2 * 128;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      wgmma<NACC>(d, gmma_desc(a + kk * 32), gmma_desc(b + kk * 32));
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      mbar_arrive_cluster<CL>(ring.empty + 8 * prev);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(d);
  mbar_arrive_cluster<CL>(ring.empty + 8 * prev);
}

// O[row, col] = bf16(act(d + bias)) for this thread's accumulators: in
// warpgroup wg, warp w (of 4), lane (g = lane / 4, q = lane % 4), n8 block
// j holds rows 16 w + g and 16 w + g + 8 at columns n0 + 8 j + 2 q, + 1.
// With NH > 0, NH head outputs are also summed from the rounded values
// (and O may be null: the values are then not stored): hd[h][o] is this
// thread's part of row 16 w + g + 8 h's output o, the dot product with
// the f32 head weights wh[o * ws + col].
template <int NACC, int NH = 0>
__device__ __forceinline__ void store_acc(
    const float (&d)[NACC], const float* __restrict__ bias, bool relu,
    bf16* O, int n0, const float* __restrict__ wh = nullptr, int ws = 0,
    float (*hd)[NH > 0 ? NH : 1] = nullptr) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int col = n0 + 8 * j + 2 * q;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
    float v0 = d[4 * j] + b0, v1 = d[4 * j + 1] + b1;
    float v2 = d[4 * j + 2] + b0, v3 = d[4 * j + 3] + b1;
    if (relu) {
      v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
    }
    const __nv_bfloat162 top = __floats2bfloat162_rn(v0, v1);
    const __nv_bfloat162 bot = __floats2bfloat162_rn(v2, v3);
    if constexpr (NH == 0) {
      *reinterpret_cast<__nv_bfloat162*>(O + swz(r0, col)) = top;
      *reinterpret_cast<__nv_bfloat162*>(O + swz(r0 + 8, col)) = bot;
    } else {
      if (O != nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(O + swz(r0, col)) = top;
        *reinterpret_cast<__nv_bfloat162*>(O + swz(r0 + 8, col)) = bot;
      }
      const float2 a = __bfloat1622float2(top), b = __bfloat1622float2(bot);
#pragma unroll
      for (int o = 0; o < NH; ++o) {
        const float w0 = __ldg(wh + o * ws + col);
        const float w1 = __ldg(wh + o * ws + col + 1);
        hd[0][o] = fmaf(a.y, w1, fmaf(a.x, w0, hd[0][o]));
        hd[1][o] = fmaf(b.y, w1, fmaf(b.x, w0, hd[1][o]));
      }
    }
  }
}

// The head partials of store_acc summed over the four lanes of a row and
// stored per warpgroup: HD[(wg * TM + row) * 4 + o0 + o].
template <int NH>
__device__ __forceinline__ void store_heads(float (&hd)[2][NH], float* HD,
                                            int wg, int o0) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < NH; ++o) {
      float v = hd[h][o];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) HD[(wg * TM + r0 + 8 * h) * 4 + o0 + o] = v;
    }
}

// 16 bytes from global `src` to shared `dst` without registers (cp.async,
// L2 only); with src_bytes 0 the 16 bytes are zeros. cp_async_wait_all
// waits for this thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// IN_RAW's phase A2 walks the tile's (point, view channel) items RAW_G at
// a time, RAW_IT a thread; load_dirs loads the view dirs of the group that
// starts at item i0 (lanes along a row's channels: coalesced).
constexpr int RAW_IT = TM * C72 / NCONS, RAW_G = 6;
static_assert(TM * C72 % NCONS == 0 && RAW_IT % RAW_G == 0,
              "whole groups of items a thread");

__device__ __forceinline__ void load_dirs(float (&dv)[RAW_G],
                                          const float* __restrict__ raw,
                                          int raww, int row0, int P, int tid,
                                          int i0) {
#pragma unroll
  for (int i = 0; i < RAW_G; ++i) {
    const int it = tid + (i0 + i) * NCONS;
    const int r = it / C72, c = it - (it / C72) * C72;
    dv[i] = __ldg(raw + (size_t)last_row(row0 + r, P) * raww + J + C72 + c);
  }
}

// Phase A2: the windowed view bands, the framecode and zero padding of
// every row into XV (kvc chunks). IN_PTS: a band's sin / cos depends on
// the ray only, so it is computed once per ray of the tile, view channel
// and block of 8 rows, and multiplied by each row's window: the same
// values, bit for bit, as a per-point computation. IN_RAW: the rows `raw`
// carry no ray structure, so each (point, view channel) computes its own
// bands, the lanes of a warp along the channels of a row.
template <int STAGE, int MODE>
__device__ __forceinline__ void build_xv(bf16* XV, const Dims& d,
                                         const Layout& l,
                                         const float* __restrict__ raw,
                                         const float* __restrict__ aux,
                                         const float* W24, int row0, int P,
                                         int S, int nfv, int tid) {
  if constexpr (MODE == IN_PTS) {
    const int ray0 = last_row(row0, P) / S;
    const int ray_tail = (P - 1) / S;     // rows past P recompute its point
    const int n_items = (last_row(row0 + TM - 1, P) / S - ray0 + 1) * C72
                        * (TM / 8);
    for (int it = tid; it < n_items; it += NCONS) {
      const int c = it % C72, rb = (it / C72) % (TM / 8);
      const int ray = ray0 + it / (C72 * (TM / 8));
      // the rows of block rb whose point lies on `ray`
      const int lo = max(rb * 8, ray * S - row0);
      const int hi = ray == ray_tail ? rb * 8 + 8
                                     : min(rb * 8 + 8, (ray + 1) * S - row0);
      if (lo >= hi) continue;
      const float dv = aux[ray * d.auxw + C72 + c];
      for (int r = lo; r < hi; ++r)
        XV[swz(r, c)] = __float2bfloat16_rn(dv * W24[r * J + c / 3]);
      float f = 1.f;
      for (int k = 0; k < nfv; ++k) {
        float sn, cs;
        pe_sincos<STAGE>(dv * f, &sn, &cs);
        for (int r = lo; r < hi; ++r) {
          const float w = W24[r * J + c / 3];
          XV[swz(r, C72 + 2 * C72 * k + c)] = __float2bfloat16_rn(sn * w);
          XV[swz(r, 2 * C72 + 2 * C72 * k + c)] =
              __float2bfloat16_rn(cs * w);
        }
        f *= 2.f;
      }
    }
  } else {
    // RAW_IT items a thread, in groups of RAW_G whose view dirs are
    // loaded while the group before computes its bands: one load latency
    // a group instead of one an item
    float cur[RAW_G], nxt[RAW_G] = {};
    load_dirs(cur, raw, d.raww, row0, P, tid, 0);
#pragma unroll 1
    for (int i0 = 0; i0 < RAW_IT; i0 += RAW_G) {
      if (i0 + RAW_G < RAW_IT)
        load_dirs(nxt, raw, d.raww, row0, P, tid, i0 + RAW_G);
#pragma unroll
      for (int i = 0; i < RAW_G; ++i) {
        const int it = tid + (i0 + i) * NCONS;
        const int r = it / C72, c = it - (it / C72) * C72;
        const float dv = cur[i], w = W24[r * J + c / 3];
        XV[swz(r, c)] = __float2bfloat16_rn(dv * w);
        float f = 1.f;
        for (int k = 0; k < nfv; ++k) {
          float sn, cs;
          pe_sincos<STAGE>(dv * f, &sn, &cs);
          XV[swz(r, C72 + 2 * C72 * k + c)] = __float2bfloat16_rn(sn * w);
          XV[swz(r, 2 * C72 + 2 * C72 * k + c)] =
              __float2bfloat16_rn(cs * w);
          f *= 2.f;
        }
      }
#pragma unroll
      for (int i = 0; i < RAW_G; ++i) cur[i] = nxt[i];
    }
  }
  // framecode (d.fc columns) and zero padding, 8 columns (16 bytes) a
  // step: the bands end at 72 (1 + 2 nfv), a multiple of 8
  const int c0 = d.kv - d.fc, n8 = (l.kvc * KC - c0) / 8;
  for (int it = tid; it < TM * n8; it += NCONS) {
    const int r = it / n8, g = it - (it / n8) * n8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (8 * g < d.fc) {
      const int p = last_row(row0 + r, P);
      const float* fc = (MODE == IN_PTS ? aux + (size_t)(p / S) * d.auxw
                                        : raw + (size_t)p * d.raww + J)
                        + 2 * C72 + 8 * g;
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 8 * g + e < d.fc ? fc[e] : 0.f;
      const __nv_bfloat162 q0 = __floats2bfloat162_rn(x[0], x[1]);
      const __nv_bfloat162 q1 = __floats2bfloat162_rn(x[2], x[3]);
      const __nv_bfloat162 q2 = __floats2bfloat162_rn(x[4], x[5]);
      const __nv_bfloat162 q3 = __floats2bfloat162_rn(x[6], x[7]);
      v = make_uint4(*reinterpret_cast<const uint32_t*>(&q0),
                     *reinterpret_cast<const uint32_t*>(&q1),
                     *reinterpret_cast<const uint32_t*>(&q2),
                     *reinterpret_cast<const uint32_t*>(&q3));
    }
    *reinterpret_cast<uint4*>(XV + swz(r, c0 + 8 * g)) = v;
  }
}

// IN_EMBEDDED's phases A1 and A2: the tile's rows of k bf16 columns (k a
// multiple of 8, rows 16-byte aligned) from src into nch swizzled 64-column
// chunks at dst, zero past column k: cp.async copies of 16 bytes,
// neighbouring threads on neighbouring 16-byte groups of a row, all in
// flight before this thread waits for them.
__device__ __forceinline__ void copy_rows_swz(bf16* dst,
                                              const bf16* __restrict__ src,
                                              int k, int nch, int row0,
                                              int P, int tid) {
  const int n8 = nch * (KC / 8), k8 = k / 8;
  for (int it = tid; it < TM * n8; it += NCONS) {
    const int r = it / n8, g = it - (it / n8) * n8;
    const bf16* row = src + (size_t)last_row(row0 + r, P) * k;
    cp_async16(dst + swz(r, 8 * g), row + 8 * (g < k8 ? g : 0),
               g < k8 ? 16 : 0);
  }
  cp_async_wait_all();
}

// SAVE (K2's recompute): columns 0 .. ncols - 1 (a multiple of 8) of the
// tile at `src` (swizzled 64-column chunks, rows = points) to act's feature
// rows f0 .. f0 + ncols - 1 of this tile (make_act_rows). One
// ldmatrix.trans per warp reads an 8-column group of four 8-point blocks
// without bank conflicts and hands each lane two points of one column;
// four lanes then store a 16-byte group of a feature row. (Gathering the
// 16 bytes into one lane by shuffles first was slower on an H100.)
__device__ __forceinline__ void save_cols(const bf16* src, int ncols,
                                          bf16* __restrict__ act, int F,
                                          int f0, int tile, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int n_items = (ncols / 8) * 2;
  for (int item = warp; item < n_items; item += NCONS / 32) {
    const int col = (item >> 1) * 8, pg0 = (item & 1) * 4;
    const uint32_t addr =
        smem_u32(src + swz(8 * (pg0 + (lane >> 3)) + (lane & 7), col));
    uint32_t v[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
        : "r"(addr));
    const int f = f0 + col + (lane >> 2);
    bf16* row = act + ((size_t)tile * F + f) * KC + 2 * (lane & 3);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      *reinterpret_cast<uint32_t*>(row + (((pg0 + m) ^ (f & 7)) << 3)) = v[m];
  }
}

// The producer: every k-slice of the image in the consumers' order, 1/CL
// of each by this CTA, multicast to the cluster. skip[i] is 1 where trunk
// layer i takes [x0 | h] (a skip after layer i - 1).
template <int NSTG>
__device__ __forceinline__ void produce(const unsigned char* img,
                                        const Layout& l, int depth,
                                        const int* __restrict__ skip,
                                        uint32_t stages, uint32_t full,
                                        uint32_t empty) {
  const uint32_t rank = cluster_rank();
  size_t off = 0;
  int it = 0;
  for (int layer = 0; layer < depth + 2; ++layer) {
    int nch = W / KC, bytes = STAGE_BYTES;
    if (layer == 0) nch = l.k0c;
    else if (layer < depth && skip[layer])
      nch = l.k0c + W / KC;
    else if (layer == depth + 1) {
      nch = W / KC + l.kvc;
      bytes = WV * KC * 2;
    }
    const int piece = bytes / CL;
    for (int c = 0; c < nch; ++c, ++it, off += bytes) {
      const int s = it % NSTG;
      mbar_wait(empty + 8 * s, ((it / NSTG) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, bytes);
      bulk_multicast<CL>(stages + s * STAGE_BYTES + rank * piece,
                     img + off + rank * piece, piece, full + 8 * s);
    }
  }
}

// SAVE (K2's recompute, STAGE == ST_FULL only) also writes every bf16 MLP
// input and activation of the tile to `act` (save_cols); K1 itself is the
// SAVE = false instantiation, in which every SAVE branch is compiled out.
// MODE (fused_render_common.cuh) picks the inputs: IN_PTS (K1) world
// points with the per-ray m_all and aux; IN_RAW (K3) per-point rows of
// d.raww floats [v | r | d | fc | pad] in `pts`; IN_EMBEDDED (K4) bf16
// rows of k0 columns in `pts` and of kv columns in `aux`, nfk and nfv
// carrying k0 and kv. Stages and SAVE are K1's; every branch on MODE is
// `if constexpr`.
// NSTG is the weight ring's depth (STAGES; 2 for inputs too wide beside
// three: at multires 10 / 4 on an H100 the two-stage kernel takes 2.55
// ms for K1 where the layered route takes 4.54, chip_smoke.py phase 14),
// skip the per-layer skip flags (produce), fc the framecode columns
// (Dims).
template <int STAGE, bool SAVE = false, int MODE = IN_PTS, int NSTG = STAGES>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
k1_sm90_kernel(const float* __restrict__ pts, const float* __restrict__ m_all,
               const float* __restrict__ aux,
               const unsigned char* __restrict__ img,
               const float* __restrict__ bias,
               const float* __restrict__ w_rgb,
               const float* __restrict__ w_alpha,
               const float* __restrict__ b_out, const float* __restrict__ cut,
               float* __restrict__ out, int P, int S, int depth,
               const int* __restrict__ skip, int nfk, int nfv, int fc,
               float tau, bf16* __restrict__ act) {
  static_assert(!SAVE || STAGE == ST_FULL, "K2 saves K1's activations");
  static_assert(MODE == IN_PTS || (STAGE == ST_FULL && !SAVE),
                "stages and saves are K1's");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Dims d = body_dims<MODE>(nfk, nfv, fc);
  const Layout l = make_layout(d);
  bf16* X0 = reinterpret_cast<bf16*>(base);   // kp bands | bone dirs; XV
  bf16* HA = X0 + l.xr * CHUNK;               // activations (XV's tail)
  bf16* HB = HA + (W / KC) * CHUNK;           // activations
  float* W24 = reinterpret_cast<float*>(HB + (W / KC) * CHUNK);
  float* HD = W24 + TM * J;                   // head partials per warpgroup
  unsigned char* stage0 = reinterpret_cast<unsigned char*>(HD + 2 * TM * 4);
  const uint32_t full = smem_u32(stage0 + NSTG * STAGE_BYTES);
  const uint32_t empty = full + 8 * NSTG;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < NSTG; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8 * CL);   // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (tid >= NCONS) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if constexpr (STAGE == ST_FULL) {
      if (tid == NCONS)
        produce<NSTG>(img, l, depth, skip, smem_u32(stage0), full, empty);
    }
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // ---- phase A1: X0 = [kp bands | bone dirs], or K4's x0 rows ----
  const int row0 = blockIdx.x * TM;
  const int hr = tid >> 2, ho = tid & 3;   // a (row, output) per thread
  if constexpr (MODE == IN_EMBEDDED) {
    copy_rows_swz(X0, reinterpret_cast<const bf16*>(pts), d.k0, l.k0c, row0,
                  P, tid);
  } else {
    // K3: the tile's v | r (96 floats a row) staged in HB, which the first
    // layer's epilogue writes only after phase A, by cp.async
    const float* VR = reinterpret_cast<const float*>(HB);
    if constexpr (MODE == IN_RAW) {
      constexpr int G16 = (J + C72) / 4;   // 16-byte groups of a row
      for (int it = tid; it < TM * G16; it += NCONS) {
        const int r = it / G16, g = it - (it / G16) * G16;
        cp_async16(HB + r * (J + C72) * 2 + 8 * g,
                   pts + (size_t)last_row(row0 + r, P) * d.raww + 4 * g, 16);
      }
      cp_async_wait_all();
      consumers_sync();
    }
    // per (point, joint): the geometry (K1) or the row's v and r (K3),
    // the window, the kp bands and the bone direction
    const int nb = J * (1 + 2 * nfk);  // first bone-direction column
    for (int it = tid; it < TM * J; it += NCONS) {
      const int r = it / J, j = it - (it / J) * J;
      const int p = last_row(row0 + r, P);   // tail rows: finite dummy
      float q[3], v, inv;
      if constexpr (MODE == IN_PTS) {
        const int ray = p / S;
        const float x = pts[p * 3], y = pts[p * 3 + 1], z = pts[p * 3 + 2];
        const float* m = m_all + ray * 3 * C72;
        const float* tr = aux + ray * d.auxw;
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
        // the row's distance and unit bone direction to joint j
        const float* xin = VR + r * (J + C72);
        v = xin[j];
#pragma unroll
        for (int a = 0; a < 3; ++a) q[a] = xin[J + j * 3 + a];
        inv = 1.f;
      }
      if constexpr (STAGE == ST_TRANSFORM) {
        // (v, unit dir) of this (point, joint), summed per point below
        float* dg = reinterpret_cast<float*>(HA) + it * 4;
        dg[0] = v;
#pragma unroll
        for (int a = 0; a < 3; ++a) dg[1 + a] = q[a] * inv;
        continue;
      }
      const float w = 1.f / (1.f + expf(tau * (v - cut[j])));
      W24[r * J + j] = w;
      X0[swz(r, j)] = __float2bfloat16_rn(v * w);
      float f = 1.f;
      for (int k = 0; k < nfk; ++k) {
        float s, c;
        pe_sincos<STAGE>(v * f, &s, &c);
        X0[swz(r, J + 2 * J * k + j)] = __float2bfloat16_rn(s * w);
        X0[swz(r, 2 * J + 2 * J * k + j)] = __float2bfloat16_rn(c * w);
        f *= 2.f;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
        X0[swz(r, nb + j * 3 + a)] = __float2bfloat16_rn(q[a] * inv);
    }
    if constexpr (STAGE == ST_TRANSFORM) {
      // digest: out[p] = (sum_j v, sum_j r_x, sum_j r_y, sum_j r_z)
      consumers_sync();
      const float* dg = reinterpret_cast<const float*>(HA);
      float s = 0.f;
      for (int j = 0; j < J; ++j) s += dg[(hr * J + j) * 4 + ho];
      if (row0 + hr < P) out[(size_t)(row0 + hr) * 4 + ho] = s;
      cluster_sync();
      return;
    }
    const int pad0 = l.k0c * KC - d.k0;
    for (int it = tid; it < TM * pad0; it += NCONS)
      X0[swz(it / pad0, d.k0 + it % pad0)] = __float2bfloat16_rn(0.f);
  }
  consumers_sync();

  if constexpr (STAGE != ST_FULL) {
    // digest of the MLP inputs: out[p, k] = sum of the row's X0 and XV
    // columns c with c % 4 == k, in column order (XV is built into X0's
    // place, so X0 is summed first)
    float s = 0.f;
    for (int c = ho; c < d.k0p; c += 4) s += __bfloat162float(X0[swz(hr, c)]);
    consumers_sync();
    build_xv<STAGE, MODE>(X0, d, l, pts, aux, W24, row0, P, S, nfv, tid);
    consumers_sync();
    for (int c = ho; c < d.kvp; c += 4) s += __bfloat162float(X0[swz(hr, c)]);
    if (row0 + hr < P) out[(size_t)(row0 + hr) * 4 + ho] = s;
    cluster_sync();
    return;
  }

  // ---- phase B: the MLP on wgmma, weights from the ring ----
  fence_async_smem();
  consumers_sync();
  const ActRows ar = make_act_rows(d, depth);
  const bool save = SAVE && row0 < P;   // not the cluster's spare tile
  if (save) save_cols(X0, l.k0c * KC, act, ar.F, ar.x0, blockIdx.x, tid);
  Ring ring{smem_u32(stage0), full, empty, 0};
  const int wg = tid >> 7;
  const uint32_t x0a = smem_u32(X0);
  // the last trunk layer writes HA, so that XV can take X0 and HA
  uint32_t hin = 0;
  for (int i = 0; i < depth; ++i) {
    bf16* hout = ((depth - 1 - i) & 1) ? HB : HA;
    float acc[64];
    if (i == 0)
      mma_layer<64, NSTG>(acc, ring, x0a, l.k0c, 0, 0, wg);
    else if (skip[i])
      mma_layer<64, NSTG>(acc, ring, x0a, l.k0c, hin, W / KC, wg);
    else
      mma_layer<64, NSTG>(acc, ring, hin, W / KC, 0, 0, wg);
    if (i < depth - 1) {
      store_acc<64>(acc, bias + i * W, true, hout, wg * 128);
    } else {
      // the last trunk layer also feeds the alpha head
      float hd[2][1] = {{0.f}, {0.f}};
      store_acc<64, 1>(acc, bias + i * W, true, hout, wg * 128, w_alpha, 0,
                       hd);
      store_heads<1>(hd, HD, wg, 3);
    }
    fence_async_smem();
    consumers_sync();
    if (save) save_cols(hout, W, act, ar.F, ar.h + i * W, blockIdx.x, tid);
    hin = smem_u32(hout);
  }

  // feature layer (no activation): HA -> HB
  {
    float acc[64];
    mma_layer<64, NSTG>(acc, ring, hin, W / KC, 0, 0, wg);
    store_acc<64>(acc, bias + depth * W, false, HB, wg * 128);
    consumers_sync();   // HA is spent by both warpgroups
  }
  if (save) save_cols(HB, W, act, ar.F, ar.feat, blockIdx.x, tid);

  // ---- phase A2, late: the view inputs into X0 and HA ----
  if constexpr (MODE == IN_EMBEDDED)
    copy_rows_swz(X0, reinterpret_cast<const bf16*>(aux), d.kv, l.kvc, row0,
                  P, tid);
  else
    build_xv<STAGE, MODE>(X0, d, l, pts, aux, W24, row0, P, S, nfv, tid);
  fence_async_smem();
  consumers_sync();
  if (save) save_cols(X0, l.kvc * KC, act, ar.F, ar.xv, blockIdx.x, tid);

  // view layer: [feature | view PE | framecode] -> 128, ReLU, straight
  // into the rgb head
  {
    float acc[32];
    mma_layer<32, NSTG>(acc, ring, smem_u32(HB), W / KC, x0a, l.kvc, wg);
    float hd[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    store_acc<32, 3>(acc, bias + (depth + 1) * W, true, nullptr, wg * 64,
                     w_rgb, WV, hd);
    if constexpr (SAVE) {
      consumers_sync();   // HB is spent by both warpgroups
      store_acc<32>(acc, bias + (depth + 1) * W, true, HB, wg * 64);
    }
    store_heads<3>(hd, HD, wg, 0);
    consumers_sync();
  }
  if (save) save_cols(HB, WV, act, ar.F, ar.hv, blockIdx.x, tid);

  // one (row, output) a thread: the two warpgroups' halves and the bias
  const int p = row0 + hr;
  if (p < P)
    out[p * 4 + ho] = HD[hr * 4 + ho] + HD[(TM + hr) * 4 + ho] + b_out[ho];
  cluster_sync();
}

// A layout whose tile, buffers and NSTG stages do not fit in a block's
// shared memory returns cudaErrorInvalidValue, which the Python wrappers
// raise; their route plan (fused_render.py:route_plan) sends such a layout
// to the layered route (fused_render_layered_sm90.cu) instead.
template <int STAGE, bool SAVE = false, int MODE = IN_PTS, int NSTG = STAGES>
int launch(const float* pts, const float* m_all, const float* aux,
           const void* img, const float* bias, const float* w_rgb,
           const float* w_alpha, const float* b_out, const float* cut,
           float* out, int P, int S, int depth, const int* skip, int nfk,
           int nfv, int fc, float tau, void* stream, bf16* act = nullptr) {
  const Layout l = make_layout(body_dims<MODE>(nfk, nfv, fc));
  const size_t smem = smem_bytes_sm90(l, NSTG);
  if (smem > MAX_SMEM || depth < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k1_sm90_kernel<STAGE, SAVE, MODE, NSTG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (P + TM - 1) / TM;
  const int grid = (tiles + CL - 1) / CL * CL;   // whole clusters
  k1_sm90_kernel<STAGE, SAVE, MODE, NSTG>
      <<<grid, NT, smem, (cudaStream_t)stream>>>(
          pts, m_all, aux, reinterpret_cast<const unsigned char*>(img), bias,
          w_rgb, w_alpha, b_out, cut, out, P, S, depth, skip, nfk, nfv, fc,
          tau, act);
  return (int)cudaGetLastError();
}

// launch<ST_FULL, SAVE, MODE> with the ring depth `stages` (3 or 2).
template <bool SAVE, int MODE>
int launch_full(int stages, const float* pts, const float* m_all,
                const float* aux, const void* img, const float* bias,
                const float* w_rgb, const float* w_alpha, const float* b_out,
                const float* cut, float* out, int P, int S, int depth,
                const int* skip, int nfk, int nfv, int fc, float tau,
                void* stream, bf16* act = nullptr) {
  if (stages == STAGES)
    return launch<ST_FULL, SAVE, MODE>(pts, m_all, aux, img, bias, w_rgb,
                                       w_alpha, b_out, cut, out, P, S, depth,
                                       skip, nfk, nfv, fc, tau, stream, act);
  if (stages == 2)
    return launch<ST_FULL, SAVE, MODE, 2>(pts, m_all, aux, img, bias, w_rgb,
                                          w_alpha, b_out, cut, out, P, S,
                                          depth, skip, nfk, nfv, fc, tau,
                                          stream, act);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1 on `stream`: world points (P = R * S, 3), the per-ray m_all and aux
// (2 * 72 + fc floats a ray), the weight image -> raw (P, 4), with a ring
// of `stages` weight stages (3, or 2) and the device array skip[depth] of
// per-layer skip flags. Returns a cudaError_t code (0 on success).
int anerf_fused_encode_mlp_pts_sm90(int stages, const float* pts,
                                    const float* m_all, const float* aux,
                                    const void* img, const float* bias,
                                    const float* w_rgb, const float* w_alpha,
                                    const float* b_out, const float* cut,
                                    float* out, int P, int S, int depth,
                                    const int* skip, int nfk, int nfv,
                                    int fc, float tau, void* stream) {
  return launch_full<false, IN_PTS>(stages, pts, m_all, aux, img, bias,
                                    w_rgb, w_alpha, b_out, cut, out, P, S,
                                    depth, skip, nfk, nfv, fc, tau, stream);
}

// K1-d on `stream`: K1's operands and `stage` (ST_*) -> out (P, 4), the
// stage's digest (ST_FULL: K1's raw output, the same bits as K1).
int anerf_fused_stage_sm90(int stage, const float* pts, const float* m_all,
                           const float* aux, const void* img,
                           const float* bias, const float* w_rgb,
                           const float* w_alpha, const float* b_out,
                           const float* cut, float* out, int P, int S,
                           int depth, const int* skip, int nfk, int nfv,
                           int fc, float tau, void* stream) {
#define ANERF_STAGE(ST)                                                     \
  launch<ST>(pts, m_all, aux, img, bias, w_rgb, w_alpha, b_out, cut, out,   \
             P, S, depth, skip, nfk, nfv, fc, tau, stream)
  switch (stage) {
    case ST_FULL: return ANERF_STAGE(ST_FULL);
    case ST_TRANSFORM: return ANERF_STAGE(ST_TRANSFORM);
    case ST_PE: return ANERF_STAGE(ST_PE);
    case ST_PE_STANDIN: return ANERF_STAGE(ST_PE_STANDIN);
    case ST_PE_FASTTRIG: return ANERF_STAGE(ST_PE_FASTTRIG);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ANERF_STAGE
}

// K2's recompute on `stream`: K1 with every bf16 MLP input and activation
// also written to act (make_act_rows: F feature rows of 64 points per tile
// of 64 points, for ceil(P / 64) tiles) -> raw (P, 4), the same bits as
// K1.
int anerf_k2_recompute_sm90(int stages, const float* pts,
                            const float* m_all, const float* aux,
                            const void* img, const float* bias,
                            const float* w_rgb, const float* w_alpha,
                            const float* b_out, const float* cut, float* out,
                            int P, int S, int depth, const int* skip, int nfk,
                            int nfv, int fc, float tau, void* act,
                            void* stream) {
  return launch_full<true, IN_PTS>(stages, pts, m_all, aux, img, bias, w_rgb,
                                   w_alpha, b_out, cut, out, P, S, depth,
                                   skip, nfk, nfv, fc, tau, stream,
                                   reinterpret_cast<bf16*>(act));
}

// K3 on `stream`: x (P, raww) f32 rows [v | r | d | fc | pad] (raww = 2 *
// 72 + 24 + fc rounded up to a multiple of 4; 16-byte aligned), K1's
// weight image and heads -> out (P, 4).
int anerf_fused_encode_mlp_raw_sm90(int stages, const float* x,
                                    const void* img, const float* bias,
                                    const float* w_rgb, const float* w_alpha,
                                    const float* b_out, const float* cut,
                                    float* out, int P, int depth,
                                    const int* skip, int nfk, int nfv,
                                    int fc, float tau, void* stream) {
  return launch_full<false, IN_RAW>(stages, x, nullptr, nullptr, img, bias,
                                    w_rgb, w_alpha, b_out, cut, out, P, 1,
                                    depth, skip, nfk, nfv, fc, tau, stream);
}

// K4 on `stream`: x0 (P, k0) and xv (P, kv) bf16 rows (k0, kv multiples
// of 8, 16-byte aligned), the weight image of those widths -> out (P, 4).
int anerf_fused_mlp_sm90(int stages, const void* x0, const void* xv,
                         const void* img, const float* bias,
                         const float* w_rgb, const float* w_alpha,
                         const float* b_out, float* out, int P, int depth,
                         const int* skip, int k0, int kv, void* stream) {
  return launch_full<false, IN_EMBEDDED>(
      stages, reinterpret_cast<const float*>(x0), nullptr,
      reinterpret_cast<const float*>(xv), img, bias, w_rgb, w_alpha, b_out,
      nullptr, out, P, 1, depth, skip, k0, kv, 0, 0.f, stream);
}

// CTAs per cluster of the kernel above.
int anerf_sm90_cluster_size() { return CL; }

const char* anerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
