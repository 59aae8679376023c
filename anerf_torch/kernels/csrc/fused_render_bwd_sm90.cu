// K2 for Hopper (sm_90a): the backward of K1 with f32-accurate cotangent
// products on the tensor cores, as split-bf16 wgmma GEMMs, or with bf16
// cotangent operands (the --fast_grads flavour). Also K2-d, the
// same sequence stopped after a stage (anerf_torch/kernels/stages.py), and
// a probe entry that runs one product alone (the tests and chip_smoke.py
// hold it to an f64 matmul).
//
// Replaces the Pallas TPU kernel anerf_tpu/kernels/fused_render.py:
// _fused_bwd_impl (kernel body _render_kernel_pts_bwd), both of its
// flavours (bwd_f32 True and False), and tools/kernel_bench.py:
// decompose_bwd for K2-d. Python side:
// anerf_torch/kernels/fused_render.py (fused_bwd; the plain version
// fused_bwd_ref; the images t_image_index and act_image). The first
// version (K1-v1's body saving activations, f32 FMA GEMMs) stays in
// fused_render_bwd.cu as K2-v1, the comparison.
//
// What bounds it on an H100: operations. The cotangent products (dX = dY W
// and dW = X^T dY of every MMA layer) are 1.02 TFLOP of f32-accurate work
// per 2048-ray train step (S = 64 + 80). In each product one operand is
// exactly bf16 (the weights, the saved activations) and only the cotangent
// dY is f32, which splits exactly into three bf16 terms hi + mid + lo
// (split3: 3 x 8 bits of significand, each subtraction exact in f32). Each
// bf16 x bf16 product is exact in the f32 accumulator, so three bf16 wgmma
// passes against the same B give the f32 product up to the accumulation
// order: 3.06 TFLOP at 989 TFLOP/s = 3.1 ms, plus 0.5 ms of bf16 recompute.
// The layer-by-layer sequence also moves the saved activations and the f32
// cotangents through HBM (kernels/roofline.py prints the design traffic).
//
// Design:
//  1. The recompute is K1's kernel with SAVE (fused_render_sm90.cu,
//     launched from Python before this library's sequence): it writes
//     every bf16 MLP input and activation to `act` in the layout these
//     products read as B (sm90_common.cuh: make_act_rows, act_at).
//  2. heads_bwd_kernel (CUDA cores; N = 3 and 1): the rgb / alpha heads'
//     weight-gradient partials per point chunk, and dhv.
//  3. One launch per MMA layer, last first (bwd_layer_kernel), whose CTAs
//     take two roles over one grid:
//       DX   C (64 points x 256 inputs) = dY W: A = the dY tile, B = W^T
//            from a second weight image ('img_t', t_image_index: each
//            layer's input segment, rows padded to 256, in 64-deep
//            k-slices over the outputs, K-major 128-byte swizzle); the
//            epilogue adds the alpha head's term, accumulates dx0 across
//            the skip layer and layer 0, and applies the ReLU mask read
//            from act;
//       DWT  C (64 outputs x 256 inputs) = dY^T X over one chunk of
//            BWD_CHUNK points: A = the transposed dY tile, B = act's rows
//            of the layer's input; the epilogue writes C transposed into
//            the chunk's (K + 1, N) partial block, whose bias row the
//            splitting threads summed from dY in a fixed order.
//     Each CTA is K1's shape: a producer warp copies B's 32 KB k-slices
//     (one 1-D bulk copy each) into four stages guarded by full / empty
//     mbarriers (a ring for DWT; a DX CTA keeps all of W^T's k-slices
//     resident and walks DX_ITEMS point tiles, so that its set-up and B
//     copies are paid once); two consumer warpgroups load the f32 dY slice
//     (64 x 64) from global memory, split it into three bf16 planes in
//     shared memory (the same swizzled layout), and run wgmma.m64n128k16
//     on each plane against their half of the B slice (smem-A: both
//     operands go through K1's one descriptor form, and dY^T's transpose
//     happens in the splitter's stores). A is double-buffered: the next
//     slice's split overlaps this slice's MMAs. Each slice's sum is
//     added into f32 registers once its MMAs complete (a wgmma chain
//     accumulates less exactly than f32 FMAs: over a 2048-point chunk it
//     was 10x further from f64 than K2-v1's FMA GEMM, over 64 points it
//     stays within 4x). A DX tile's ReLU mask is one 32 KB bulk copy of
//     act, issued a tile ahead and read from shared memory by the
//     epilogue.
//  4. reduce_chunks_kernel sums the partials in chunk order;
//     pe_transform_bwd_kernel is the per-ray PE and transform backward in
//     exact fp32 (fused_render_bwd_common.cuh, shared with K2-v1).
// No float atomics: two calls give the same bits. 14 launches at the
// flagship (recompute, heads, 10 MMA layers, reduce, PE).
//
// The two flavours (the entry's bwd_f32):
//  bwd_f32 = 1: the layer kernel multiplies all three planes (f32-accurate
//     products, as above; chip_smoke.py holds K2 to K2-v1's FMA GEMMs).
//  bwd_f32 = 0: the JAX kernel's bf16 flavour (mmT / mmO cast both
//     operands to bf16 and sum in f32). The layer kernel multiplies the hi
//     plane alone, which is dY rounded to bf16 (RNE); the heads round g to
//     bf16 where it enters a product (the rgb / alpha dW, dhv), and so
//     does the DX epilogue's alpha-head term, bf16(g_alpha) w_alpha. The
//     bias rows stay f32 sums of the unrounded cotangents, as JAX sums dh
//     and g. Bound: one bf16 pass of the products plus the recompute,
//     1.55 ms a 2048-ray step at S = 64 + 80 (kernels/roofline.py); the
//     f32 cotangents still make the same HBM round trips, and the
//     splitter still loads them and stores the one plane, so it stays
//     far above that.

#include "sm90_common.cuh"
#include "fused_render_bwd_common.cuh"

#include <vector>

namespace {

// Stages of the sequence (K2-d; the recompute stage, 1, is K1's library).
constexpr int BWD_FULL = 0, BWD_MLP = 2, BWD_PE = 3;
constexpr int NB = 256;                  // C tile columns: 2 x 128
constexpr int BSTAGES = 4;               // B ring stages (DX: B resident)
constexpr int B_BYTES = NB * KC * 2;     // one 256 x 64 B slice, 32 KB
constexpr int ABUF = 2;                  // A buffers: split slices
constexpr int A_ELEMS = 3 * CHUNK;       // three 64 x 64 bf16 planes
constexpr int DX = 0, DWT = 1;
constexpr int MAXPROD = 4;
constexpr int DX_ITEMS = 8;              // 64-point tiles of a DX CTA

// One product of a layer launch (see the design note).
struct Prod {
  int kind;
  int n_ctas;            // CTAs of this product
  int m_tiles, n_tiles;  // 64-row and 256-column tiles (DWT: per chunk)
  int k_slices;          // DX: outputs / 64; DWT: point tiles per chunk
  const float* dy;       // dY(p, o) = dy[p * ldy + o], f32
  int ldy;
  const bf16* b;         // B at slice 0, column tile 0
  long long b_slice;     // elements between two k-slices of B
  int n_valid;           // DX: columns of C; DWT: rows of the dW block
  float* c;              // DX: C(p, n) at c[p * ldc + n]
  int ldc;
  int mask_row;          // DX: C = 0 where act(p, mask_row + n) <= 0; or -1
  int accumulate;        // DX: C += the old C, before the mask
  const float* ga;       // DX: C += ga[4 p] * wa[n] (the alpha head)
  const float* wa;
  float* part;           // DWT: chunk c's block row n at part + c total + n N
  int n_out;             // DWT: N, the layer's outputs
  int bias_row;          // DWT: the block row of the bias gradient, or -1
};

struct LayerArgs {
  Prod p[MAXPROD];
  int n_prod;
  int P, F, pt_tiles;    // points, act rows, point tiles (ceil(P / 64))
  long long total;       // elements of one chunk's partial sums
  const bf16* act;
};

inline size_t layer_smem() {
  return (size_t)ABUF * A_ELEMS * 2 + (size_t)BSTAGES * B_BYTES
         + B_BYTES                                   // DX: the mask tile
         + (size_t)NCONS * 4 + (2 * BSTAGES + 1) * 8 + 1024;
}

// x = hi + mid + lo exactly (for |x| in the normal range of bf16 with
// room for the two residuals): each residual is exact in f32, and each
// rounding keeps 8 more bits of the significand.
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16_rn(x);
  float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  r -= __bfloat162float(mid);
  lo = __float2bfloat16_rn(r);
}

// One 64 x 64 slice of A (rows m0.., k-slice starting at k0) into
// registers, four float4 a thread; points past P read 0.
//  DX: A(m, k) = dY(point m, output k); v[j] holds row idx / 16, columns
//      4 (idx % 16) .. + 3 (idx = tid + 256 j): one float4 load each.
//  DWT: A(m, k) = dY(point k, output m); v[j] holds row m = tid % 64,
//      columns k = 16 j + 4 (tid / 64) .. + 3: four scalar loads, each a
//      warp's 32 consecutive outputs of one point.
__device__ __forceinline__ void load_a(float4 (&v)[4], const Prod& pr,
                                       int m0, int k0, int P, int tid) {
  if (pr.kind == DX) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + NCONS * j;
      const int p = m0 + (idx >> 4);
      v[j] = p < P ? __ldg(reinterpret_cast<const float4*>(
                         pr.dy + (size_t)p * pr.ldy + k0 + (idx & 15) * 4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const float* col = pr.dy + m0 + (tid & 63);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = k0 + 16 * j + 4 * (tid >> 6);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = p + e < P ? __ldg(col + (size_t)(p + e) * pr.ldy) : 0.f;
    v[j] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The slice in registers -> its first PLANES bf16 planes (hi, mid, lo) at
// A, in the swizzled K-major layout, 8 bytes (4 k-values of one row) a
// store. PLANES = 1 (bf16 cotangents) stores the hi plane alone.
template <int PLANES>
__device__ __forceinline__ void store_a(const float4 (&v)[4], bf16* A,
                                        int kind, int tid) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = tid + NCONS * j;
    const int r = kind == DX ? idx >> 4 : tid & 63;
    const int k = kind == DX ? (idx & 15) * 4 : 16 * j + 4 * (tid >> 6);
    const float x[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    __align__(8) bf16 s[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(x[e], s[0][e], s[1][e], s[2][e]);
#pragma unroll
    for (int t = 0; t < PLANES; ++t)
      *reinterpret_cast<uint2*>(A + t * CHUNK + swz(r, k)) =
          *reinterpret_cast<const uint2*>(s[t]);
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wgmma<64> whose scale-d is an operand: 0 starts a new sum (D = A B^T).
__device__ __forceinline__ void wgmma_sd(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
#define ANERF_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ANERF_F8(0), ANERF_F8(8), ANERF_F8(16), ANERF_F8(24), ANERF_F8(32),
        ANERF_F8(40), ANERF_F8(48), ANERF_F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
#undef ANERF_F8
}

template <int PLANES>
__global__ void __launch_bounds__(NT, 1)
bwd_layer_kernel(const __grid_constant__ LayerArgs L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Abuf = reinterpret_cast<bf16*>(base);
  unsigned char* stage0 = base + ABUF * A_ELEMS * 2;
  bf16* Msk = reinterpret_cast<bf16*>(stage0 + BSTAGES * B_BYTES);
  float* bsum = reinterpret_cast<float*>(stage0 + (BSTAGES + 1) * B_BYTES);
  const uint32_t full = smem_u32(bsum + NCONS);
  const uint32_t empty = full + 8 * BSTAGES;
  const uint32_t mask_bar = empty + 8 * BSTAGES;
  const int tid = threadIdx.x;

  // this CTA's product and tiles: a DX CTA takes DX_ITEMS consecutive
  // 64-point tiles of one column tile, with B resident where its k-slices
  // fit in the stages (outputs <= 256) and through the ring, again for
  // each tile, where they do not; a DWT CTA one (chunk, 64-output tile,
  // column tile) through the ring
  int b = blockIdx.x, j = 0;
  while (j < L.n_prod - 1 && b >= L.p[j].n_ctas) b -= L.p[j++].n_ctas;
  const Prod& pr = L.p[j];
  const bool dx = pr.kind == DX;
  const int nt = b % pr.n_tiles;
  int m0, chunk = 0, kbase = 0, ks = pr.k_slices, items = 1;
  if (dx) {
    m0 = (b / pr.n_tiles) * DX_ITEMS;             // first point tile
    items = min(DX_ITEMS, L.pt_tiles - m0);
  } else {
    const int per = pr.m_tiles * pr.n_tiles;
    chunk = b / per;
    m0 = ((b % per) / pr.n_tiles) * TM;
    kbase = chunk * pr.k_slices;
    ks = min(pr.k_slices, L.pt_tiles - kbase);
  }
  const bool masked = dx && pr.mask_row >= 0;
  const bool ring = !dx || ks > BSTAGES;   // else B stays resident

  if (tid == 0) {
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCONS / 32);   // every consumer warp
    }
    mbar_init(mask_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---- producer warpgroup: B's k-slices (resident: all of them,
    // once; else every item's, in the consumers' order) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == NCONS) {
      const bf16* src = pr.b + (size_t)nt * NB * KC;
      const int n_copies = ring ? items * ks : ks;
      for (int g = 0; g < n_copies; ++g) {
        const int st = g % BSTAGES, s = g % ks;
        if (ring) mbar_wait(empty + 8 * st, ((g / BSTAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, B_BYTES);
        bulk_copy(smem_u32(stage0) + st * B_BYTES,
                  src + (size_t)(kbase + s) * pr.b_slice, B_BYTES,
                  full + 8 * st);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // ---- consumers: split A, three wgmma passes a k-step ----
  // a DX tile's ReLU mask: act rows mask_row + 256 nt .. + 255 of its 64
  // points, one contiguous 32 KB run (issued a tile ahead of its use)
  auto fetch_mask = [&](int item) {
    if (masked && tid == 0) {
      fence_async_smem();
      mbar_expect_tx(mask_bar, B_BYTES);
      bulk_copy(smem_u32(Msk),
                L.act + ((size_t)(m0 + item) * L.F + pr.mask_row + nt * NB)
                            * KC,
                B_BYTES, mask_bar);
    }
  };
  // row m0 of item i, and the k offset of slice s
  auto row0 = [&](int item) { return dx ? (m0 + item) * TM : m0; };
  const int kk0 = dx ? 0 : kbase * KC;
  const int wg = tid >> 7;
  float bs = 0.f;   // DWT: this thread's sum of its output's dY
  // A's global loads run two slices ahead: vn holds slice g + 1 (split
  // into shared memory during slice g's MMAs), vl receives slice g + 2
  float4 vn[4], vl[4];
  auto add_bias = [&](const float4 (&v)[4]) {
    if (!dx)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        bs += ((v[u].x + v[u].y) + v[u].z) + v[u].w;
  };
  // the slice after (item, s), as (item, s); item == items past the end
  auto advance = [&](int& it, int& sl) {
    if (++sl == ks) { sl = 0; ++it; }
  };
  fetch_mask(0);
  load_a(vn, pr, row0(0), kk0, L.P, tid);
  add_bias(vn);
  store_a<PLANES>(vn, Abuf, pr.kind, tid);
  fence_async_smem();
  int i1 = 0, s1 = 0;                           // slice g + 1
  advance(i1, s1);
  if (i1 < items) load_a(vn, pr, row0(i1), kk0 + s1 * KC, L.P, tid);
  int i2 = i1, s2 = s1;                         // slice g + 2
  advance(i2, s2);
  consumers_sync();

  // the tensor cores' sums of one k-slice (d) are added into f32
  // registers (acc) slice by slice: a wgmma chain accumulates less
  // exactly than f32 FMAs, so it runs over 64 k-values at a time
  float d[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = acc[i] = 0.f;
  const uint32_t a_base = smem_u32(Abuf);
  const int t = tid & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2), q = lane & 3;
  const int n_base = nt * NB + wg * 128;
  int g = 0;                                    // slices so far
#pragma unroll 1
  for (int item = 0; item < items; ++item) {
    const int mr = row0(item);
#pragma unroll 1
    for (int s = 0; s < ks; ++s, ++g) {
      const int st = (ring ? g : s) % BSTAGES;
      mbar_wait(full + 8 * st, ring ? (g / BSTAGES) & 1 : 0);
      const uint32_t a = a_base + (g % ABUF) * A_ELEMS * 2;
      const uint32_t bb = smem_u32(stage0) + st * B_BYTES + wg * 128 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int tp = PLANES - 1; tp >= 0; --tp)   // lo, mid, hi
          wgmma_sd(d, gmma_desc(a + tp * CHUNK * 2 + kk * 32),
                   gmma_desc(bb + kk * 32), kk > 0 || tp < PLANES - 1);
      wgmma_commit();
      // the next slice's split overlaps this slice's MMAs; its buffer was
      // last read by the slice before, complete in both warpgroups
      if (i2 < items) load_a(vl, pr, row0(i2), kk0 + s2 * KC, L.P, tid);
      if (i1 < items) {
        add_bias(vn);
        store_a<PLANES>(vn, Abuf + ((g + 1) % ABUF) * A_ELEMS, pr.kind,
                        tid);
        fence_async_smem();
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) vn[u] = vl[u];
      i1 = i2;
      s1 = s2;
      advance(i2, s2);
      wgmma_wait<0>();
      fence_acc(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = s ? acc[i] + d[i] : d[i];
      if (ring && (tid & 31) == 0) mbar_arrive(empty + 8 * st);
      consumers_sync();
    }

    // ---- epilogue: warp w, lane (g, q), n8 block j hold rows 16 w + g
    // (+ 8) at columns 8 j + 2 q, + 1 of this warpgroup's 128 ----
    if (dx) {
      if (masked) mbar_wait(mask_bar, item & 1);
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mr + r0 + 8 * h;
          if (p >= L.P) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n_base + 8 * jn + 2 * q + e;
            if (n >= pr.n_valid) continue;
            float val = acc[4 * jn + 2 * h + e];
            float* cp = pr.c + (size_t)p * pr.ldc + n;
            if (pr.ga != nullptr) {
              // the alpha head's term; the bf16 flavour (one plane)
              // rounds g_alpha as it rounds dY
              float ga = pr.ga[4 * (size_t)p];
              if (PLANES == 1) ga = __bfloat162float(__float2bfloat16_rn(ga));
              val += ga * pr.wa[n];
            }
            if (pr.accumulate) val += *cp;
            const int r = r0 + 8 * h, c = n - nt * NB;
            if (masked &&
                !(__bfloat162float(
                      Msk[c * KC + (((r >> 3) ^ (c & 7)) << 3) + (r & 7)])
                  > 0.f))
              val = 0.f;
            *cp = val;
          }
        }
      if (item + 1 < items) {
        consumers_sync();                 // the mask buffer is read
        fetch_mask(item + 1);
      }
      continue;
    }
    float* part = pr.part + (size_t)chunk * L.total;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mr + r0 + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_base + 8 * jn + 2 * q + e;
          if (n < pr.n_valid)
            part[(size_t)n * pr.n_out + m] = acc[4 * jn + 2 * h + e];
        }
      }
    if (pr.bias_row < 0 || nt != 0) continue;
    // the bias row: thread t summed output t % 64 over its points; the
    // four threads of each output, in thread order
    bsum[tid] = bs;
    consumers_sync();
    if (tid < TM) {
      const float sb = ((bsum[tid] + bsum[TM + tid]) + bsum[2 * TM + tid])
                       + bsum[3 * TM + tid];
      part[(size_t)pr.bias_row * pr.n_out + mr + tid] = sb;
    }
  }
}

// The heads (N = 3 and 1) of a trunk of width w on the CUDA cores, 256
// threads a block. Blocks [0, n_chunk * head_blocks(w)): block (chunk, rb)
// takes the 32 rows 32 rb .. of the chunk's rgb block (rows 0 .. w / 2,
// the last the bias) and alpha block (rows w / 2 + 1 .., the last the
// bias), four rows a warp; lane l sums the chunk's points l, l + 32, .. in
// order (coalesced reads of a feature row of act), then the lanes' sums
// are added by a fixed butterfly. The other blocks: dhv = (g_rgb w_rgb)
// masked by hv > 0 for 64 points each, 128 hv columns at a time, staged
// through shared memory so that both the act reads and the dhv writes are
// coalesced. With ROUND_G (the bf16 flavour) g enters every product
// rounded to bf16; the bias rows sum it unrounded. Without it the kernel
// is the f32 flavour's, unchanged.
constexpr int DHV_COLS = 128;
__host__ __device__ inline int head_rows(int w) { return w / 2 + 1 + w + 1; }
__host__ __device__ inline int head_blocks(int w) {
  return (head_rows(w) + 31) / 32;
}

// x, or x rounded to bf16 (RNE) when `round`: a cotangent entering a
// product in the bf16 flavour
__device__ __forceinline__ float cot_operand(float x, bool round) {
  return round ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool ROUND_G>
__global__ void __launch_bounds__(256)
heads_bwd_kernel(const bf16* __restrict__ act, int F, int row_hv,
                 int row_h, const float* __restrict__ g,
                 const float* __restrict__ w_rgb, float* __restrict__ dhv,
                 float* __restrict__ partial, long long total,
                 long long g_rgb, long long g_alpha, int P, int chunk,
                 int n_chunk, int w) {
  __shared__ float sm[TM * (DHV_COLS + 1)];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wv = w / 2, hb = head_blocks(w);
  if ((int)blockIdx.x >= n_chunk * hb) {
    const int p0 = (blockIdx.x - n_chunk * hb) * TM;
    for (int u0 = 0; u0 < wv; u0 += DHV_COLS) {
      if (u0 > 0) __syncthreads();   // the last columns' stores read sm
      for (int idx = tid; idx < TM * DHV_COLS; idx += 256) {
        const int u = u0 + idx / TM, r = idx % TM, p = p0 + r;
        float v = 0.f;
        if (p < P) {
          v = cot_operand(g[4 * (size_t)p], ROUND_G) * w_rgb[u];
          v = fmaf(cot_operand(g[4 * (size_t)p + 1], ROUND_G),
                   w_rgb[wv + u], v);
          v = fmaf(cot_operand(g[4 * (size_t)p + 2], ROUND_G),
                   w_rgb[2 * wv + u], v);
          if (!(__bfloat162float(act[act_at(p, row_hv + u, F)]) > 0.f))
            v = 0.f;
        }
        sm[r * (DHV_COLS + 1) + u - u0] = v;
      }
      __syncthreads();
      for (int idx = tid; idx < TM * DHV_COLS; idx += 256) {
        const int r = idx / DHV_COLS, u = idx % DHV_COLS;
        if (p0 + r < P)
          dhv[(size_t)(p0 + r) * wv + u0 + u] = sm[r * (DHV_COLS + 1) + u];
      }
    }
    return;
  }
  const int c = blockIdx.x / hb;
  const int p0 = c * chunk, p1 = min(P, p0 + chunk);
  float* part = partial + (size_t)c * total;
  for (int k = 0; k < 4; ++k) {
    const int row = (blockIdx.x % hb) * 32 + warp * 4 + k;
    if (row >= head_rows(w)) return;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    if (row <= wv) {
      const bool rd = ROUND_G && row < wv;   // the bias row: unrounded g
      for (int p = p0 + lane; p < p1; p += 32) {
        const float x = row < wv
            ? __bfloat162float(act[act_at(p, row_hv + row, F)]) : 1.f;
        s0 = fmaf(x, cot_operand(g[4 * (size_t)p], rd), s0);
        s1 = fmaf(x, cot_operand(g[4 * (size_t)p + 1], rd), s1);
        s2 = fmaf(x, cot_operand(g[4 * (size_t)p + 2], rd), s2);
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        part[g_rgb + row * 3] = s0;
        part[g_rgb + row * 3 + 1] = s1;
        part[g_rgb + row * 3 + 2] = s2;
      }
    } else {
      const int r = row - wv - 1;
      const bool rd = ROUND_G && r < w;
      for (int p = p0 + lane; p < p1; p += 32) {
        const float x = r < w
            ? __bfloat162float(act[act_at(p, row_h + r, F)]) : 1.f;
        s0 = fmaf(x, cot_operand(g[4 * (size_t)p + 3], rd), s0);
      }
      s0 = warp_sum(s0);
      if (lane == 0) part[g_alpha + r] = s0;
    }
  }
}

// The launches of one layer-by-layer backward, in order.
struct Seq {
  cudaStream_t stream;
  int planes;            // 3 (bwd_f32) or 1 (bf16 cotangents)
  LayerArgs L;
  cudaError_t err = cudaSuccess;

  Prod& add(int kind, const float* dy, int ldy, const bf16* b,
            long long b_slice, int k_slices, int m_tiles, int n_tiles,
            int n_valid, int n_chunk) {
    Prod& p = L.p[L.n_prod++];
    p = Prod{};
    p.kind = kind;
    p.dy = dy;
    p.ldy = ldy;
    p.b = b;
    p.b_slice = b_slice;
    p.k_slices = k_slices;
    p.m_tiles = m_tiles;
    p.n_tiles = n_tiles;
    p.n_valid = n_valid;
    p.mask_row = -1;
    p.bias_row = -1;
    p.n_ctas = kind == DX
                   ? (L.pt_tiles + DX_ITEMS - 1) / DX_ITEMS * n_tiles
                   : n_chunk * m_tiles * n_tiles;
    return p;
  }

  void launch() {
    if (err == cudaSuccess) {
      int ctas = 0;
      for (int i = 0; i < L.n_prod; ++i) ctas += L.p[i].n_ctas;
      if (planes == 3)
        bwd_layer_kernel<3><<<ctas, NT, layer_smem(), stream>>>(L);
      else
        bwd_layer_kernel<1><<<ctas, NT, layer_smem(), stream>>>(L);
      err = cudaGetLastError();
    }
    L.n_prod = 0;
  }
};

cudaError_t set_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      bwd_layer_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)layer_smem());
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(bwd_layer_kernel<1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)layer_smem());
}

inline int tiles256(int n) { return (n + NB - 1) / NB; }

// The sequence after the recompute, up to `stage` (BWD_*), in the flavour
// bwd_f32 (1: f32-accurate products on three planes of the cotangents;
// 0: bf16 cotangent operands, the hi plane alone), for a trunk of width w
// (a multiple of 256) and depth `depth`, skip[depth] the per-layer skip
// flags (host memory), fc framecode columns.
int run_bwd(int stage, int bwd_f32, const float* pts, const float* m_all,
            const float* aux, const float* cut, const bf16* img_t,
            const bf16* act, const float* g, const float* w_rgb,
            const float* w_alpha, float* dhv, float* dview, float* dh_a,
            float* dh_b, float* dx0, float* partial, float* dW, float* dpts,
            float* dm, float* daux, int P, int S, int w, int depth,
            const int* skip, int nfk, int nfv, int fc, int chunk, float tau,
            void* stream_v) {
  if ((stage != BWD_FULL && stage != BWD_MLP && stage != BWD_PE)
      || (bwd_f32 != 0 && bwd_f32 != 1))
    return (int)cudaErrorInvalidValue;
  if (chunk % TM != 0 || depth < 1 || w % NB != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = (cudaStream_t)stream_v;
  const Dims d = make_dims(nfk, nfv, fc);
  const ActRows ar = make_act_rows(d, depth, w);
  const int W = w, WV = w / 2;   // this call's widths
  const int k0t = tiles256(d.k0p) * NB, kvt = tiles256(d.kvp) * NB;

  // offsets of the dW blocks (rows K + 1, cols N) and of the W^T image's
  // input segments (rows padded to 256, N columns) of every MMA layer:
  // layer 0 [x0], a skip layer [x0 | h], the others [h], view [feat | xv]
  std::vector<long long> goff(depth + 2), toff0(depth + 2),
      toff1(depth + 2);
  long long go = 0, to = 0;
  for (int i = 0; i < depth + 2; ++i) {
    const bool sk = i > 0 && i < depth && skip[i];
    const int N = i == depth + 1 ? WV : W;
    int K = W, rows0 = W, rows1 = 0;
    if (i == 0) { K = d.k0p; rows0 = k0t; }
    else if (sk) { K = d.k0p + W; rows0 = k0t; rows1 = W; }
    else if (i == depth + 1) { K = W + d.kvp; rows1 = kvt; }
    goff[i] = go;
    go += (long long)(K + 1) * N;
    toff0[i] = to;
    toff1[i] = to + (long long)rows0 * N;
    to += (long long)(rows0 + rows1) * N;
  }
  const long long g_rgb = go, g_alpha = go + (WV + 1) * 3;
  const long long total = g_alpha + (W + 1);
  const int n_chunk = (P + chunk - 1) / chunk;
  const int cs = chunk / TM;                 // point tiles per chunk
  const long long aslice = (long long)ar.F * KC;
  const int iF = depth, iV = depth + 1, ldv = W + d.kvp;
  const int h_last = ar.h + (depth - 1) * W;
  auto arow = [&](int row) { return act + (size_t)row * KC; };
  auto tseg = [&](int i, int s) {
    return img_t + (s ? toff1[i] : toff0[i]);
  };

  Seq q{stream, bwd_f32 ? 3 : 1};
  q.L.n_prod = 0;
  q.L.P = P;
  q.L.F = ar.F;
  q.L.pt_tiles = (P + TM - 1) / TM;
  q.L.total = total;
  q.L.act = act;

  // 2. the heads and dhv
  auto heads = bwd_f32 ? heads_bwd_kernel<false> : heads_bwd_kernel<true>;
  heads<<<n_chunk * head_blocks(W) + q.L.pt_tiles, 256, 0, stream>>>(
      act, ar.F, ar.hv, h_last, g, w_rgb, dhv, partial, total, g_rgb,
      g_alpha, P, chunk, n_chunk, W);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 3. the view layer: dW of [feat | xv], d[feat | xv] = dview
  {
    Prod& a = q.add(DWT, dhv, WV, arow(ar.feat), aslice, cs, WV / TM,
                    tiles256(W), W, n_chunk);
    a.part = partial + goff[iV];
    a.n_out = WV;
    Prod& b = q.add(DWT, dhv, WV, arow(ar.xv), aslice, cs, WV / TM,
                    tiles256(d.kvp), d.kvp, n_chunk);
    b.part = partial + goff[iV] + (long long)W * WV;
    b.n_out = WV;
    b.bias_row = d.kvp;
    Prod& c = q.add(DX, dhv, WV, tseg(iV, 0), (long long)W * KC, WV / KC, 1,
                    tiles256(W), W, n_chunk);
    c.c = dview;
    c.ldc = ldv;
    Prod& x = q.add(DX, dhv, WV, tseg(iV, 1), (long long)kvt * KC, WV / KC,
                    1, tiles256(d.kvp), d.kvp, n_chunk);
    x.c = dview + W;
    x.ldc = ldv;
    q.launch();
  }
  // 4. the feature layer (no activation) and the alpha head's cotangent
  {
    Prod& a = q.add(DWT, dview, ldv, arow(h_last), aslice, cs, W / TM,
                    tiles256(W), W, n_chunk);
    a.part = partial + goff[iF];
    a.n_out = W;
    a.bias_row = W;
    Prod& c = q.add(DX, dview, ldv, tseg(iF, 0), (long long)W * KC, W / KC,
                    1, tiles256(W), W, n_chunk);
    c.c = dh_a;
    c.ldc = W;
    c.mask_row = h_last;
    c.ga = g + 3;
    c.wa = w_alpha;
    q.launch();
  }
  // 5. the trunk, last layer first; a skip layer's x0 rows feed dx0
  float* cur = dh_a;
  float* nxt = dh_b;
  int dx0_set = 0;
  for (int i = depth - 1; i >= 0; --i) {
    const bool sk = i > 0 && skip[i];
    const long long x0_rows = i == 0 || sk ? (long long)d.k0p * W : 0;
    if (x0_rows) {
      Prod& a = q.add(DWT, cur, W, arow(ar.x0), aslice, cs, W / TM,
                      tiles256(d.k0p), d.k0p, n_chunk);
      a.part = partial + goff[i];
      a.n_out = W;
      if (i == 0) a.bias_row = d.k0p;
    }
    if (i > 0) {
      Prod& a = q.add(DWT, cur, W, arow(ar.h + (i - 1) * W), aslice, cs,
                      W / TM, tiles256(W), W, n_chunk);
      a.part = partial + goff[i] + x0_rows;
      a.n_out = W;
      a.bias_row = W;
    }
    if (x0_rows) {
      Prod& c = q.add(DX, cur, W, tseg(i, 0), (long long)k0t * KC, W / KC,
                      1, tiles256(d.k0p), d.k0p, n_chunk);
      c.c = dx0;
      c.ldc = d.k0p;
      c.accumulate = dx0_set;
      dx0_set = 1;
    }
    if (i > 0) {
      Prod& c = q.add(DX, cur, W, tseg(i, sk ? 1 : 0), (long long)W * KC,
                      W / KC, 1, tiles256(W), W, n_chunk);
      c.c = nxt;
      c.ldc = W;
      c.mask_row = ar.h + (i - 1) * W;
    }
    q.launch();
    float* t = cur; cur = nxt; nxt = t;
  }
  if (q.err != cudaSuccess) return (int)q.err;

  // 6. fixed-order sum of the dW partials
  reduce_chunks_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, dW, total, n_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (stage == BWD_MLP) return 0;

  // 7. PE and transform backward, per-ray sums
  const int R = P / S;
  const size_t smem_pe = (size_t)(2 * S + 2 * nfv) * C72 * sizeof(float);
  auto pe_kernel = stage == BWD_PE ? pe_transform_bwd_kernel<true>
                                   : pe_transform_bwd_kernel<false>;
  e = cudaFuncSetAttribute(pe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_pe);
  if (e != cudaSuccess) return (int)e;
  pe_kernel<<<R, NTHREADS, smem_pe, stream>>>(
      pts, m_all, aux, cut, dx0, d.k0p, dview + W, ldv, S, nfk, nfv, tau,
      dpts, dm, daux, fc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 after its recompute (anerf_k2_recompute_sm90 of K1's library wrote
// act) on `stream`, up to `stage` (0 full: dW flat in the Python
// grad_blocks order, dpts, dm_all, daux; 2 mlp: dW, dx0 and dview; 3 pe:
// dW and the PE digest in dpts), with bwd_f32 1 (f32-accurate cotangent
// products) or 0 (bf16 cotangent operands), for a trunk of width w and
// depth `depth` with the host array skip[depth] of per-layer skip flags
// and fc framecode columns (aux rows of 2 * 72 + fc floats). The
// recompute may also be the layered route's (anerf_layered_forward of
// fused_render_layered_sm90.cu with act). img_t is the W^T image
// (packed 'img_t'); the f32 scratch buffers come from the caller. Returns
// a cudaError_t code (0 on success).
int anerf_fused_bwd_sm90(int stage, int bwd_f32, const float* pts,
                         const float* m_all, const float* aux,
                         const float* cut, const void* img_t,
                         const void* act, const float* g,
                         const float* w_rgb, const float* w_alpha,
                         float* dhv, float* dview, float* dh_a, float* dh_b,
                         float* dx0, float* partial, float* dW, float* dpts,
                         float* dm, float* daux, int P, int S, int w,
                         int depth, const int* skip, int nfk, int nfv,
                         int fc, int chunk, float tau, void* stream) {
  return run_bwd(stage, bwd_f32, pts, m_all, aux, cut,
                 reinterpret_cast<const bf16*>(img_t),
                 reinterpret_cast<const bf16*>(act), g, w_rgb, w_alpha, dhv,
                 dview, dh_a, dh_b, dx0, partial, dW, dpts, dm, daux, P, S,
                 w, depth, skip, nfk, nfv, fc, chunk, tau, stream);
}

// One split product alone (a layer launch of one role), for the tests:
// kind 0 (DX): out (P x n_valid, row stride ld_out) = dy (P x 64 k_slices,
// row stride ldy) W, with B = the W^T image of n_tiles 256-row tiles
// (b_slice elements a k-slice); kind 1 (DWT): out[c] (n_valid + 1 rows,
// ld_out = N columns, c = 0 .. ceil(P / chunk) - 1, `total` elements
// apart) = X_c^T dy_c and the column sums of dy_c, with B = X's act image
// (b_slice = F * 64) and m_tiles = N / 64.
int anerf_split_gemm_probe(int kind, const float* dy, int ldy, const void* b,
                           long long b_slice, int k_slices, int m_tiles,
                           int n_tiles, int n_valid, float* out, int ld_out,
                           int P, int chunk, long long total, void* stream) {
  if ((kind != DX && kind != DWT) || chunk % TM != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return (int)e;
  Seq q{(cudaStream_t)stream, 3};
  q.L.n_prod = 0;
  q.L.P = P;
  q.L.F = 0;
  q.L.pt_tiles = (P + TM - 1) / TM;
  q.L.total = total;
  q.L.act = nullptr;
  Prod& p = q.add(kind, dy, ldy, reinterpret_cast<const bf16*>(b), b_slice,
                  kind == DX ? k_slices : chunk / TM, m_tiles, n_tiles,
                  n_valid, (P + chunk - 1) / chunk);
  if (kind == DX) {
    p.c = out;
    p.ldc = ld_out;
  } else {
    p.part = out;
    p.n_out = ld_out;
    p.bias_row = n_valid;
  }
  q.launch();
  return (int)q.err;
}

const char* anerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
