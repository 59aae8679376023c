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
//     operands to bf16 and sum in f32), its own sequence and plan
//     (run_bwd_bf16, bwd_layer_kernel_bf16 below): every MMA-layer
//     cotangent that only enters products is kept in HBM as bf16 tiles
//     in act's layout, rounded (RNE) where the f32 flavour's splitter
//     rounds it (after the alpha head's term bf16(g_alpha) w_alpha and
//     the mask); both roles take their A by bulk copies through the
//     producer's ring (dY^T K-major, dY MN-major from the same 8 KB
//     block); the bias rows, f32 sums of the unrounded cotangents as JAX
//     sums dh and g, come from the DX epilogue that makes each cotangent
//     (and from the heads for dhv), per DX group, and the chunk sum adds
//     them (reduce_chunks_kernel); the grid is sized from P
//     (fused_render.py: bwd_plan). dx0 and d[xv] stay f32 rows: the f32
//     PE backward reads them. Bound: one bf16 pass of the products plus
//     the recompute, 1.55 ms a 2048-ray step at S = 64 + 80
//     (kernels/roofline.py); its own HBM bytes with bf16 cotangents are
//     the floor it meets first (roofline.k2_launch_bytes).

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
constexpr int PLANES = 3;                // split3's bf16 planes
constexpr int A_ELEMS = PLANES * CHUNK;  // three 64 x 64 bf16 planes
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

// The slice in registers -> its three bf16 planes (hi, mid, lo) at A, in
// the swizzled K-major layout, 8 bytes (4 k-values of one row) a store.
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
        bulk_load(smem_u32(stage0) + st * B_BYTES,
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
      bulk_load(smem_u32(Msk),
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
  store_a(vn, Abuf, pr.kind, tid);
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
        store_a(vn, Abuf + ((g + 1) % ABUF) * A_ELEMS, pr.kind,
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
            if (pr.ga != nullptr) val += pr.ga[4 * (size_t)p] * pr.wa[n];
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

constexpr int DHV_COLS = 128;
// bf16 flavour: hv columns a dhv block takes
constexpr int DHV_SLAB = 32;
__host__ __device__ inline int head_rows(int w) { return w / 2 + 1 + w + 1; }
// blocks of one chunk's rows: 32 a block (four a warp; f32), 8 (one a
// warp; bf16)
__host__ __device__ inline int head_blocks(int w, bool bf16) {
  return (head_rows(w) + (bf16 ? 7 : 31)) / (bf16 ? 8 : 32);
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

// The heads' backward (N = 3 and 1) of a trunk of width w on the CUDA
// cores, 256 threads a block, in two parts.
// Blocks [0, n_chunk * head_blocks(w, BF16)): the rgb block (rows 0 ..
// w / 2, the last the bias) and the alpha block (rows w / 2 + 1 .., the
// last the bias) of each chunk's dW partial, block (chunk, rb) its rows
// 32 rb .. (f32: four a warp, lane l summing the chunk's points l, l +
// 32, .. in order) or 8 rb .. (bf16: one a warp, lane l summing four
// strands of points l + 32 k, + 128, .., added in strand order); then a
// fixed butterfly over the lanes. Reads of a feature row of act are
// coalesced.
// The other blocks make dhv = (g_rgb w_rgb) masked by hv > 0.
//  f32 flavour (BF16 false, unchanged): 64 points a block, 128 hv columns
//     at a time, staged through shared memory so that both the act reads
//     and the f32 rows' writes are coalesced.
//  bf16 flavour (BF16): g enters every product rounded to bf16 (the bias
//     rows sum it unrounded). Block (group, slab) takes one DX group's
//     dx_items tiles and DHV_SLAB hv columns, thread (point group pg,
//     column) the 8 points 8 pg .. of each tile: it reads their mask (a
//     16-byte run of hv's feature row), writes dhv rounded to bf16 (RNE)
//     in act's tile layout (one 16-byte store), and sums the unrounded
//     dhv; the column's 8 point groups are added in order into row
//     `group` of the bias partials at column bias_col (the view layer's
//     bias).
template <bool BF16>
__global__ void __launch_bounds__(256)
heads_bwd_kernel(const bf16* __restrict__ act, int F, int row_hv,
                 int row_h, const float* __restrict__ g,
                 const float* __restrict__ w_rgb, void* __restrict__ dhv_out,
                 float* __restrict__ partial, long long total,
                 long long g_rgb, long long g_alpha, int P, int chunk,
                 int n_chunk, int w, int dx_items,
                 float* __restrict__ bpart, int n_bias, int bias_col) {
  __shared__ float sm[TM * (DHV_COLS + 1)];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wv = w / 2, hb = head_blocks(w, BF16);
  if ((int)blockIdx.x >= n_chunk * hb && BF16) {
    const int slabs = wv / DHV_SLAB, b = blockIdx.x - n_chunk * hb;
    const int grp = b / slabs, u = (b % slabs) * DHV_SLAB + lane;
    const int pg = warp, fh = row_hv + u;
    const int t0 = grp * dx_items;
    const int t1 = min((P + TM - 1) / TM, t0 + dx_items);
    bf16* dhv = reinterpret_cast<bf16*>(dhv_out);
    const float w0 = w_rgb[u], w1 = w_rgb[wv + u], w2 = w_rgb[2 * wv + u];
    float bs = 0.f;
    for (int t = t0; t < t1; ++t) {
      __syncthreads();                   // the last tile's g is read
      // the tile's g rounded to bf16, 4 a point (TM * 4 = 256 threads)
      sm[tid] = t * TM + (tid >> 2) < P
                    ? cot_operand(g[4 * (size_t)t * TM + tid], true)
                    : 0.f;
      __syncthreads();
      const uint4 mk = *reinterpret_cast<const uint4*>(
          act + ((size_t)t * F + fh) * KC + 8 * (pg ^ (fh & 7)));
      const bf16* m8 = reinterpret_cast<const bf16*>(&mk);
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = 8 * pg + e;
        float x = sm[4 * r] * w0;
        x = fmaf(sm[4 * r + 1], w1, x);
        x = fmaf(sm[4 * r + 2], w2, x);
        if (!(__bfloat162float(m8[e]) > 0.f) || t * TM + r >= P) x = 0.f;
        bs += x;
        v[e] = x;
      }
      uint4 o;
      o.x = pack_bf16(v[0], v[1]);
      o.y = pack_bf16(v[2], v[3]);
      o.z = pack_bf16(v[4], v[5]);
      o.w = pack_bf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(dhv + ((size_t)t * wv + u) * KC
                                + 8 * (pg ^ (u & 7))) = o;
    }
    __syncthreads();                     // sm's g is read
    sm[pg * DHV_SLAB + lane] = bs;
    __syncthreads();
    if (warp == 0) {
      float sb = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) sb += sm[k * DHV_SLAB + lane];
      bpart[(size_t)grp * n_bias + bias_col + u] = sb;
    }
    return;
  }
  if ((int)blockIdx.x >= n_chunk * hb) {
    float* dhv = reinterpret_cast<float*>(dhv_out);
    const int p0 = (blockIdx.x - n_chunk * hb) * TM;
    for (int u0 = 0; u0 < wv; u0 += DHV_COLS) {
      if (u0 > 0) __syncthreads();   // the last columns' stores read sm
      for (int idx = tid; idx < TM * DHV_COLS; idx += 256) {
        const int u = u0 + idx / TM, r = idx % TM, p = p0 + r;
        float v = 0.f;
        if (p < P) {
          v = g[4 * (size_t)p] * w_rgb[u];
          v = fmaf(g[4 * (size_t)p + 1], w_rgb[wv + u], v);
          v = fmaf(g[4 * (size_t)p + 2], w_rgb[2 * wv + u], v);
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
  if constexpr (BF16) {
    const int row = (blockIdx.x % hb) * 8 + warp;
    if (row >= head_rows(w)) return;
    const bool rgb = row <= wv;
    const int r = row - wv - 1;
    const bool bias = rgb ? row == wv : r == w;   // unrounded g
    const int f = rgb ? row_hv + row : row_h + r;
    float s[4][3] = {};
    for (int p = p0 + lane; p < p1; p += 128) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pk = p + 32 * k;
        if (pk >= p1) continue;
        const float x = bias ? 1.f : __bfloat162float(act[act_at(pk, f, F)]);
        if (rgb) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            s[k][ch] = fmaf(x, cot_operand(g[4 * (size_t)pk + ch], !bias),
                            s[k][ch]);
        } else {
          s[k][0] = fmaf(x, cot_operand(g[4 * (size_t)pk + 3], !bias),
                         s[k][0]);
        }
      }
    }
    float sum[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      sum[ch] = warp_sum(((s[0][ch] + s[1][ch]) + s[2][ch]) + s[3][ch]);
    if (lane == 0) {
      if (rgb) {
        part[g_rgb + row * 3] = sum[0];
        part[g_rgb + row * 3 + 1] = sum[1];
        part[g_rgb + row * 3 + 2] = sum[2];
      } else {
        part[g_alpha + r] = sum[0];
      }
    }
    return;
  }
  for (int k = 0; k < 4; ++k) {
    const int row = (blockIdx.x % hb) * 32 + warp * 4 + k;
    if (row >= head_rows(w)) return;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    if (row <= wv) {
      for (int p = p0 + lane; p < p1; p += 32) {
        const float x = row < wv
            ? __bfloat162float(act[act_at(p, row_hv + row, F)]) : 1.f;
        s0 = fmaf(x, g[4 * (size_t)p], s0);
        s1 = fmaf(x, g[4 * (size_t)p + 1], s1);
        s2 = fmaf(x, g[4 * (size_t)p + 2], s2);
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
      for (int p = p0 + lane; p < p1; p += 32) {
        const float x = r < w
            ? __bfloat162float(act[act_at(p, row_h + r, F)]) : 1.f;
        s0 = fmaf(x, g[4 * (size_t)p + 3], s0);
      }
      s0 = warp_sum(s0);
      if (lane == 0) part[g_alpha + r] = s0;
    }
  }
}

// ---- the bf16 flavour's layer kernel ----
// Every MMA-layer cotangent that only enters products (dhv, d[feat], each
// trunk dh) lives in HBM as bf16, rounded (RNE) where the f32 flavour's
// splitter rounds it, in act's tile layout: tile t of 64 points holds the
// cotangent's columns as feature rows of 64 points (128 bytes, the
// 128-byte swizzle), so rows o .. o + 63 of a tile are one contiguous 8 KB
// block. That block is dY^T's K-major 64 x 64 slice for the DWT role and,
// read MN-major (wgmma's transpose bit, as the layered route reads act),
// dY's slice for the DX role. A producer thread feeds both roles through
// one ring of BF_STAGES stages (A's 8 KB block and B's 32 KB slice, full /
// empty mbarriers); a DX CTA copies W^T's k-slices once where they divide
// the stages (B resident) and only A after. The consumers run the MMAs
// and the epilogues. DWT accumulates in the tensor cores over the chunk's
// points, one wait a slice behind (its sums feed no rounding). DX adds
// each 64-output slice's sum into f32 registers, as bwd_layer_kernel
// does: a long tensor-core chain sums less exactly, and the cotangents DX
// makes are rounded to bf16 and feed every layer after (one chain over
// all the outputs read 25-40% further from the plain backward in the MLP
// stage). Epilogues:
//   DX to a bf16 tile (dh, d[feat]): + bf16(g_alpha) w_alpha (the feature
//      layer), the ReLU mask (act's rows, a 32 KB bulk copy a tile ahead),
//      points past P zero; rounded, transposed by stmatrix.trans into act's
//      layout and left as one 16 KB bulk store a warpgroup; each column's
//      unrounded sum over the CTA's tiles (registers, then a fixed
//      butterfly and warp order) is the next layer's bias partial, row
//      `group` of the bias partials;
//   DX to f32 rows (dx0, accumulated across the skip layer and layer 0;
//      d[xv]): staged in shared memory (these products have no mask and
//      no bf16 tile), then whole-row 16-byte stores;
//   DWT: C (64 outputs x 256 inputs) of its chunk transposed into the
//      chunk's partial block (no bias row: the DX epilogues make those).
// Grid: a DX CTA takes dx_items tiles of one 256-column tile, a DWT CTA
// one (chunk, 64-output tile, 256-column tile) of chunk_tiles tiles; the
// plan (fused_render.py: bwd_plan) sizes both from P so that one launch
// fills the card with CTAs of about equal MMA work.
constexpr int BF_STAGES = 4;
constexpr int A_BYTES = TM * KC * 2;            // one 8 KB cotangent block
constexpr int BF_STAGE = A_BYTES + B_BYTES;     // 40 KB
constexpr int STG_BYTES = TM * 128 * 2;         // a warpgroup's 64 x 128

struct ProdBf {
  int kind;
  int n_ctas;
  int m_tiles, n_tiles;  // DWT: 64-output tiles; both: 256-column tiles
  int k_slices;          // DX: outputs / 64
  const bf16* a;         // dY: tile t's column o at a + (t a_rows + o) 64
  int a_rows;
  const bf16* b;         // B at column tile 0
  long long b_slice;     // elements between DX's k-slices / DWT's tiles
  int n_valid;           // DX: columns of C; DWT: rows of the dW block
  bf16* ct;              // DX: C as tiles of ct_rows feature rows, or null
  int ct_rows;
  float* c;              // DX without ct: C(p, n) at c[p * ldc + n]
  int ldc;
  int accumulate;        // DX to f32 rows: C += the old C
  int mask_row;          // DX to a tile: C = 0 where act(p, mask_row + n)
                         // <= 0; or -1
  const float* ga;       // DX to a tile: C += bf16(ga[4 p]) wa[n]
  const float* wa;
  int bias_col;          // DX to a tile: the bias partial column of C's
                         // column 0, or -1
  float* part;           // DWT: chunk c's block row n at part + c total
  int n_out;             //   + n N (N = n_out, the layer's outputs)
};

struct LayerArgsBf {
  ProdBf p[MAXPROD];
  int n_prod;
  int P, F, pt_tiles;    // points, act rows, point tiles (ceil(P / 64))
  int chunk_tiles;       // tiles of a DWT chunk
  int dx_items;          // tiles of a DX CTA (a bias partial row)
  long long total;       // elements of one chunk's partial sums
  int n_bias;            // columns of a bias partial row
  float* bpart;
  const bf16* act;
};

inline size_t layer_smem_bf16() {
  return 1024 + (size_t)BF_STAGES * BF_STAGE + B_BYTES + 2 * STG_BYTES
         + (2 * BF_STAGES + 1) * 8;
}

// The consumer warpgroups of one CTA in the role DXR (DX) or not (DWT).
template <bool DXR>
__device__ __forceinline__ void bf16_consumers(
    const LayerArgsBf& L, const ProdBf& pr, int grp, int nt, int mt,
    int t0, int items, uint32_t ring, uint32_t full, uint32_t empty,
    uint32_t mask_bar, bf16* Msk, bf16* Stg) {
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int lane = t & 31, warp = t >> 5;
  const int r0 = warp * 16 + (lane >> 2), q = lane & 3;
  const int n_base = nt * NB + wg * 128;
  const bool masked = DXR && pr.mask_row >= 0;
  const bool tiles = DXR && pr.ct != nullptr;
  const int n_outer = DXR ? items : 1, n_inner = DXR ? pr.k_slices : items;
  auto fetch_mask = [&](int item) {
    if (masked && tid == 0) {
      fence_async_smem();
      mbar_expect_tx(mask_bar, B_BYTES);
      bulk_load(smem_u32(Msk),
                L.act + ((size_t)(t0 + item) * L.F + pr.mask_row + nt * NB)
                            * KC,
                B_BYTES, mask_bar);
    }
  };
  fetch_mask(0);
  // stmatrix.trans: lane 8 m + i addresses row i of matrix m (see the
  // epilogue), staged feature row 8 (m / 2) + i, point group 2 warp +
  // m % 2 at its swizzled place
  const uint32_t my_s = smem_u32(Stg + wg * (STG_BYTES / 2));
  const int mi = lane >> 3, ri = lane & 7;
  const uint32_t at = my_s + 2 * (8 * (mi >> 1) * KC + ri * KC
                                  + 8 * ((2 * warp + (mi & 1)) ^ ri));
  // DX: each 64-output slice's sum (d) is added into f32 registers (acc)
  float d[64], acc[DXR ? 64 : 1], bacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) bacc[i] = 0.f;
  int g = 0;
#pragma unroll 1
  for (int item = 0; item < n_outer; ++item) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_acc(d);
    wgmma_fence();
    int prev = -1;
#pragma unroll 1
    for (int s = 0; s < n_inner; ++s, ++g) {
      const int st = g % BF_STAGES;
      mbar_wait(full + 8 * st, (g / BF_STAGES) & 1);
      const uint32_t a = ring + st * BF_STAGE;
      const uint32_t bb = a + A_BYTES + wg * 128 * 128;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if constexpr (DXR)   // A = dY: 16 output rows of 128 bytes a step
          wgmma<64, 1>(d, gmma_desc_mn(a + kk * 2048),
                       gmma_desc(bb + kk * 32));
        else
          wgmma<64>(d, gmma_desc(a + kk * 32), gmma_desc(bb + kk * 32));
      }
      wgmma_commit();
      if constexpr (DXR) {
        wgmma_wait<0>();
        fence_acc(d);
        if (lane == 0) mbar_arrive(empty + 8 * st);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          acc[i] = s ? acc[i] + d[i] : d[i];
          d[i] = 0.f;
        }
        fence_acc(d);
        wgmma_fence();
      } else {
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = st;
      }
    }
    if constexpr (DXR) {
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = acc[i];
    } else {
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(empty + 8 * prev);
    }

    // epilogue: warp w, lane (g, q), n8 block j hold rows 16 w + g (+ 8)
    // at columns 8 j + 2 q, + 1 of this warpgroup's 128
    if constexpr (DXR) {
      const int tile = t0 + item, p0 = tile * TM;
      if (!tiles) {
        // f32 rows: each warp's 16 rows of 128 columns staged in the idle
        // mask / staging buffers (32 KB a warpgroup; 16-byte groups of a
        // row permuted by row % 4: no bank conflicts either way), then
        // stored, read-modify-written with `accumulate`, a row a warp
        // instruction as 16-byte runs
        float* sf = reinterpret_cast<float*>(Msk) + wg * TM * 128;
        __syncwarp();                    // the last tile's reads are done
#pragma unroll
        for (int jn = 0; jn < 16; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            *reinterpret_cast<float2*>(sf + r * 128
                                       + ((8 * jn + 2 * q) ^ (8 * (r & 3)))) =
                make_float2(d[4 * jn + 2 * h], d[4 * jn + 2 * h + 1]);
          }
        __syncwarp();
        const int n = n_base + 4 * lane;
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
          const int r = warp * 16 + i, p = p0 + r;
          if (p >= L.P || n >= pr.n_valid) continue;
          float4 v = *reinterpret_cast<const float4*>(
              sf + r * 128 + ((4 * lane) ^ (8 * (r & 3))));
          float4* cp = reinterpret_cast<float4*>(pr.c + (size_t)p * pr.ldc
                                                 + n);
          if (pr.accumulate) {
            const float4 o = *cp;
            v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
          }
          *cp = v;
        }
        continue;
      }
      if (masked) mbar_wait(mask_bar, item & 1);
      float gah[2] = {0.f, 0.f};
      if (pr.ga != nullptr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + r0 + 8 * h;
          gah[h] = p < L.P ? cot_operand(pr.ga[4 * (size_t)p], true) : 0.f;
        }
      if (t == 0) bulk_wait_read();      // the last tile's store read Stg
      wg_sync(wg);
      // matrices (j, rows 16 w ..), (j, rows 16 w + 8 ..), the same of
      // j + 1, each stored transposed: staged feature row 8 j' + i holds
      // the 64 points in 16-byte groups of 8, group h at h ^ (row % 8)
#pragma unroll
      for (int jn = 0; jn < 16; jn += 2) {
        uint32_t rg[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jj = jn + hh;
          float v[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = r0 + 8 * h, n = n_base + 8 * jj + 2 * q + e;
              const int c = n - nt * NB;
              float val = d[4 * jj + 2 * h + e];
              if (pr.ga != nullptr) val += gah[h] * pr.wa[n];
              if (masked &&
                  !(__bfloat162float(
                        Msk[c * KC + (((r >> 3) ^ (c & 7)) << 3) + (r & 7)])
                    > 0.f))
                val = 0.f;
              if (p0 + r >= L.P) val = 0.f;
              bacc[2 * jj + e] += val;
              v[h][e] = val;
            }
          rg[2 * hh] = pack_bf16(v[0][0], v[0][1]);
          rg[2 * hh + 1] = pack_bf16(v[1][0], v[1][1]);
        }
        stmatrix_x4_trans(at + 2 * (8 * jn) * KC, rg[0], rg[1], rg[2],
                          rg[3]);
      }
      fence_async_smem();                // st.shared before the bulk copy
      wg_sync(wg);
      if (t == 0)
        bulk_store(pr.ct + ((size_t)tile * pr.ct_rows + n_base) * KC, my_s,
                   STG_BYTES);
      if (item + 1 < items) {
        consumers_sync();                // the mask buffer is read
        fetch_mask(item + 1);
      }
    } else {
      float* part = pr.part + (size_t)grp * L.total;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * TM + r0 + 8 * h;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n_base + 8 * jn + 2 * q + e;
            if (n < pr.n_valid)
              part[(size_t)n * pr.n_out + m] = d[4 * jn + 2 * h + e];
          }
        }
    }
  }
  if (!tiles) return;
  if (pr.bias_col >= 0) {
    // the bias partial: each column's sum over this thread's rows of the
    // CTA's tiles, then over the 8 lanes of a column (butterfly) and the
    // 4 warps (in order), staged in the idle mask buffer
    consumers_sync();
    float* sc = reinterpret_cast<float*>(Msk) + wg * 4 * 128;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float v = bacc[i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) sc[warp * 128 + 8 * (i >> 1) + 2 * lane + (i & 1)] = v;
    }
    consumers_sync();
    if (n_base + t < pr.n_valid)
      L.bpart[(size_t)grp * L.n_bias + pr.bias_col + n_base + t] =
          ((sc[t] + sc[128 + t]) + sc[256 + t]) + sc[384 + t];
  }
  if (t == 0) bulk_wait();
}

__global__ void __launch_bounds__(NT, 1)
bwd_layer_kernel_bf16(const __grid_constant__ LayerArgsBf L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  bf16* Msk = reinterpret_cast<bf16*>(base + BF_STAGES * BF_STAGE);
  bf16* Stg = Msk + B_BYTES / 2;
  const uint32_t full = ring + BF_STAGES * BF_STAGE + B_BYTES + 2 * STG_BYTES;
  const uint32_t empty = full + 8 * BF_STAGES;
  const uint32_t mask_bar = empty + 8 * BF_STAGES;
  const int tid = threadIdx.x;

  // this CTA's product, group (DX: dx_items tiles; DWT: the chunk) and
  // tiles
  int b = blockIdx.x, j = 0;
  while (j < L.n_prod - 1 && b >= L.p[j].n_ctas) b -= L.p[j++].n_ctas;
  const ProdBf& pr = L.p[j];
  const bool dx = pr.kind == DX;
  const int nt = b % pr.n_tiles, rest = b / pr.n_tiles;
  const int mt = dx ? 0 : rest % pr.m_tiles;
  const int grp = dx ? rest : rest / pr.m_tiles;
  const int per = dx ? L.dx_items : L.chunk_tiles;
  const int t0 = grp * per, items = min(per, L.pt_tiles - t0);
  const int ks = dx ? pr.k_slices : 1;
  // DX: W^T's k-slices stay in the stages where they divide them (stage
  // st holds slice st % ks)
  const bool resident = dx && BF_STAGES % ks == 0;

  if (tid == 0) {
    for (int s = 0; s < BF_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCONS / 32);   // every consumer warp
    }
    mbar_init(mask_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---- producer: A's block and B's slice of every k-step in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == NCONS) {
      const bf16* bsrc = pr.b + (size_t)nt * NB * KC;
      for (int g = 0; g < items * ks; ++g) {
        const int st = g % BF_STAGES, item = g / ks, s = g - item * ks;
        const int tile = t0 + item;
        const bool with_b = !resident || g < BF_STAGES;
        const uint32_t dst = ring + st * BF_STAGE, fb = full + 8 * st;
        mbar_wait(empty + 8 * st, ((g / BF_STAGES) & 1) ^ 1);
        mbar_expect_tx(fb, A_BYTES + (with_b ? B_BYTES : 0));
        bulk_load(dst,
                  pr.a + ((size_t)tile * pr.a_rows + (dx ? s * KC : mt * TM))
                             * KC,
                  A_BYTES, fb);
        if (with_b)
          bulk_load(dst + A_BYTES,
                    bsrc + (size_t)(dx ? s : tile) * pr.b_slice, B_BYTES, fb);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (dx)
    bf16_consumers<true>(L, pr, grp, nt, mt, t0, items, ring, full, empty,
                         mask_bar, Msk, Stg);
  else
    bf16_consumers<false>(L, pr, grp, nt, mt, t0, items, ring, full, empty,
                          mask_bar, Msk, Stg);
}

// The launches of one layer-by-layer backward, in order: the f32
// flavour's (bwd_layer_kernel) ...
struct Seq {
  cudaStream_t stream;
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
      bwd_layer_kernel<<<ctas, NT, layer_smem(), stream>>>(L);
      err = cudaGetLastError();
    }
    L.n_prod = 0;
  }
};

// ... and the bf16 flavour's (bwd_layer_kernel_bf16): DX CTAs n_dxg a
// 256-column tile, DWT CTAs n_chunk a (64-output, 256-column) tile.
struct SeqBf {
  cudaStream_t stream;
  LayerArgsBf L;
  int n_chunk, n_dxg;
  cudaError_t err = cudaSuccess;

  ProdBf& add(int kind, const bf16* a, int a_rows, const bf16* b,
              long long b_slice, int slices_or_m, int n_tiles,
              int n_valid) {
    ProdBf& p = L.p[L.n_prod++];
    p = ProdBf{};
    p.kind = kind;
    p.a = a;
    p.a_rows = a_rows;
    p.b = b;
    p.b_slice = b_slice;
    p.n_tiles = n_tiles;
    p.n_valid = n_valid;
    p.mask_row = -1;
    p.bias_col = -1;
    p.k_slices = kind == DX ? slices_or_m : 1;
    p.m_tiles = kind == DX ? 1 : slices_or_m;
    p.n_ctas = kind == DX ? n_dxg * n_tiles : n_chunk * slices_or_m * n_tiles;
    return p;
  }

  void launch() {
    if (err == cudaSuccess) {
      int ctas = 0;
      for (int i = 0; i < L.n_prod; ++i) ctas += L.p[i].n_ctas;
      bwd_layer_kernel_bf16<<<ctas, NT, layer_smem_bf16(), stream>>>(L);
      err = cudaGetLastError();
    }
    L.n_prod = 0;
  }
};

cudaError_t set_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      bwd_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)layer_smem());
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(bwd_layer_kernel_bf16,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)layer_smem_bf16());
}

inline int tiles256(int n) { return (n + NB - 1) / NB; }

// What both flavours' sequences share: the call's widths, act's rows, the
// dW blocks' offsets (rows K + 1, cols N) and the W^T image's input
// segments (rows padded to 256, N columns) of every MMA layer: layer 0
// [x0], a skip layer [x0 | h], the others [h], view [feat | xv].
struct BwdGeo {
  Dims d;
  ActRows ar;
  int W, WV, k0t, kvt, iF, iV, h_last, n_chunk, cs;
  std::vector<long long> goff, toff0, toff1;
  long long g_rgb, g_alpha, total, aslice;
};

BwdGeo make_geo(int P, int w, int depth, const int* skip, int nfk, int nfv,
                int fc, int chunk) {
  BwdGeo G;
  G.d = make_dims(nfk, nfv, fc);
  const Dims& d = G.d;
  G.ar = make_act_rows(d, depth, w);
  G.W = w;
  G.WV = w / 2;
  G.k0t = tiles256(d.k0p) * NB;
  G.kvt = tiles256(d.kvp) * NB;
  G.goff.resize(depth + 2);
  G.toff0.resize(depth + 2);
  G.toff1.resize(depth + 2);
  long long go = 0, to = 0;
  for (int i = 0; i < depth + 2; ++i) {
    const bool sk = i > 0 && i < depth && skip[i];
    const int N = i == depth + 1 ? G.WV : G.W;
    int K = G.W, rows0 = G.W, rows1 = 0;
    if (i == 0) { K = d.k0p; rows0 = G.k0t; }
    else if (sk) { K = d.k0p + G.W; rows0 = G.k0t; rows1 = G.W; }
    else if (i == depth + 1) { K = G.W + d.kvp; rows1 = G.kvt; }
    G.goff[i] = go;
    go += (long long)(K + 1) * N;
    G.toff0[i] = to;
    G.toff1[i] = to + (long long)rows0 * N;
    to += (long long)(rows0 + rows1) * N;
  }
  G.g_rgb = go;
  G.g_alpha = go + (G.WV + 1) * 3;
  G.total = G.g_alpha + (G.W + 1);
  G.n_chunk = (P + chunk - 1) / chunk;
  G.cs = chunk / TM;                          // point tiles per chunk
  G.aslice = (long long)G.ar.F * KC;
  G.iF = depth;
  G.iV = depth + 1;
  G.h_last = G.ar.h + (depth - 1) * G.W;
  return G;
}

// 7. PE and transform backward, per-ray sums, from dx0 (P x k0p) and dxv
// (row stride ldxv)
int launch_pe(int stage, const float* pts, const float* m_all,
              const float* aux, const float* cut, const float* dx0,
              const float* dxv, int ldxv, float* dpts, float* dm,
              float* daux, int P, int S, int nfk, int nfv, int fc, int k0p,
              float tau, cudaStream_t stream) {
  const int R = P / S;
  const size_t smem_pe = (size_t)(2 * S + 2 * nfv) * C72 * sizeof(float);
  auto pe_kernel = stage == BWD_PE ? pe_transform_bwd_kernel<true>
                                   : pe_transform_bwd_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      pe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_pe);
  if (e != cudaSuccess) return (int)e;
  pe_kernel<<<R, NTHREADS, smem_pe, stream>>>(
      pts, m_all, aux, cut, dx0, k0p, dxv, ldxv, S, nfk, nfv, tau, dpts, dm,
      daux, fc);
  return (int)cudaGetLastError();
}

// The bf16 flavour's sequence after the recompute (see run_bwd): dhv,
// dh_a and dh_b bf16 tiles in act's layout (dh_b first holds d[feat]);
// dxv (P x kvp) and dx0 f32 rows; bpart the bias partials (n_dxg rows of
// n_bias = (depth + 1) w + w / 2: trunk layer i at column i w, the
// feature layer at depth w, the view layer at (depth + 1) w), bmap their
// table for the chunk sum (fused_render.py: bias_map).
int run_bwd_bf16(int stage, const BwdGeo& G, const float* pts,
                 const float* m_all, const float* aux, const float* cut,
                 const bf16* img_t, const bf16* act, const float* g,
                 const float* w_rgb, const float* w_alpha, bf16* dhv,
                 float* dxv, bf16* dh_a, bf16* dh_b, float* dx0,
                 float* partial, float* bpart, const long long* bmap,
                 float* dW, float* dpts, float* dm, float* daux, int P,
                 int S, int depth, const int* skip, int nfk, int nfv, int fc,
                 int chunk, int dx_items, float tau, cudaStream_t stream) {
  const Dims& d = G.d;
  const ActRows& ar = G.ar;
  const int W = G.W, WV = G.WV, n_bias = (depth + 1) * W + WV;
  const int pt_tiles = (P + TM - 1) / TM;
  const int n_dxg = (pt_tiles + dx_items - 1) / dx_items;
  auto arow = [&](int row) { return act + (size_t)row * KC; };
  auto tseg = [&](int i, int s) {
    return img_t + (s ? G.toff1[i] : G.toff0[i]);
  };
  cudaError_t e;

  // 2. the heads, and dhv as bf16 tiles with the view layer's bias
  heads_bwd_kernel<true><<<G.n_chunk * head_blocks(W, true)
                               + n_dxg * (WV / DHV_SLAB),
                           256, 0, stream>>>(
      act, ar.F, ar.hv, G.h_last, g, w_rgb, dhv, partial, G.total, G.g_rgb,
      G.g_alpha, P, chunk, G.n_chunk, W, dx_items, bpart, n_bias,
      (depth + 1) * W);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  SeqBf q{stream};
  q.n_chunk = G.n_chunk;
  q.n_dxg = n_dxg;
  q.L.n_prod = 0;
  q.L.P = P;
  q.L.F = ar.F;
  q.L.pt_tiles = pt_tiles;
  q.L.chunk_tiles = G.cs;
  q.L.dx_items = dx_items;
  q.L.total = G.total;
  q.L.n_bias = n_bias;
  q.L.bpart = bpart;
  q.L.act = act;
  const int iF = G.iF, iV = G.iV, h_last = G.h_last;

  // 3. the view layer: dW of [feat | xv]; d[feat] (dh_b, with the feature
  // layer's bias) and d[xv] (f32 rows)
  {
    ProdBf& a = q.add(DWT, dhv, WV, arow(ar.feat), G.aslice, WV / TM,
                      tiles256(W), W);
    a.part = partial + G.goff[iV];
    a.n_out = WV;
    ProdBf& b = q.add(DWT, dhv, WV, arow(ar.xv), G.aslice, WV / TM,
                      tiles256(d.kvp), d.kvp);
    b.part = partial + G.goff[iV] + (long long)W * WV;
    b.n_out = WV;
    ProdBf& c = q.add(DX, dhv, WV, tseg(iV, 0), (long long)W * KC, WV / KC,
                      tiles256(W), W);
    c.ct = dh_b;
    c.ct_rows = W;
    c.bias_col = iF * W;
    ProdBf& x = q.add(DX, dhv, WV, tseg(iV, 1), (long long)G.kvt * KC,
                      WV / KC, tiles256(d.kvp), d.kvp);
    x.c = dxv;
    x.ldc = d.kvp;
    q.launch();
  }
  // 4. the feature layer (no activation) and the alpha head's cotangent
  {
    ProdBf& a = q.add(DWT, dh_b, W, arow(h_last), G.aslice, W / TM,
                      tiles256(W), W);
    a.part = partial + G.goff[iF];
    a.n_out = W;
    ProdBf& c = q.add(DX, dh_b, W, tseg(iF, 0), (long long)W * KC, W / KC,
                      tiles256(W), W);
    c.ct = dh_a;
    c.ct_rows = W;
    c.mask_row = h_last;
    c.ga = g + 3;
    c.wa = w_alpha;
    c.bias_col = (depth - 1) * W;
    q.launch();
  }
  // 5. the trunk, last layer first; a skip layer's x0 rows feed dx0
  bf16* cur = dh_a;
  bf16* nxt = dh_b;
  int dx0_set = 0;
  for (int i = depth - 1; i >= 0; --i) {
    const bool sk = i > 0 && skip[i];
    const long long x0_rows = i == 0 || sk ? (long long)d.k0p * W : 0;
    if (x0_rows) {
      ProdBf& a = q.add(DWT, cur, W, arow(ar.x0), G.aslice, W / TM,
                        tiles256(d.k0p), d.k0p);
      a.part = partial + G.goff[i];
      a.n_out = W;
    }
    if (i > 0) {
      ProdBf& a = q.add(DWT, cur, W, arow(ar.h + (i - 1) * W), G.aslice,
                        W / TM, tiles256(W), W);
      a.part = partial + G.goff[i] + x0_rows;
      a.n_out = W;
    }
    if (x0_rows) {
      ProdBf& c = q.add(DX, cur, W, tseg(i, 0), (long long)G.k0t * KC,
                        W / KC, tiles256(d.k0p), d.k0p);
      c.c = dx0;
      c.ldc = d.k0p;
      c.accumulate = dx0_set;
      dx0_set = 1;
    }
    if (i > 0) {
      ProdBf& c = q.add(DX, cur, W, tseg(i, sk ? 1 : 0), (long long)W * KC,
                        W / KC, tiles256(W), W);
      c.ct = nxt;
      c.ct_rows = W;
      c.mask_row = ar.h + (i - 1) * W;
      c.bias_col = (i - 1) * W;
    }
    q.launch();
    bf16* t = cur; cur = nxt; nxt = t;
  }
  if (q.err != cudaSuccess) return (int)q.err;

  // 6. fixed-order sums of the dW partials and of the bias partials
  reduce_chunks_kernel<<<(unsigned)((G.total + 255) / 256), 256, 0,
                         stream>>>(partial, dW, G.total, G.n_chunk, bpart,
                                   bmap, depth + 2, n_dxg, n_bias);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (stage == BWD_MLP) return 0;
  return launch_pe(stage, pts, m_all, aux, cut, dx0, dxv, d.kvp, dpts, dm,
                   daux, P, S, nfk, nfv, fc, d.k0p, tau, stream);
}

// The sequence after the recompute, up to `stage` (BWD_*), in the flavour
// bwd_f32 (1: f32-accurate products on three planes of the cotangents, f32
// cotangent buffers dhv, dview, dh_a, dh_b; 0: bf16 cotangent operands,
// run_bwd_bf16's buffers in the same places, dview holding d[xv]), for a
// trunk of width w (a multiple of 256) and depth `depth`, skip[depth] the
// per-layer skip flags (host memory), fc framecode columns; chunk points a
// dW partial and, in the bf16 flavour, dx_items tiles a DX CTA (the plan's).
int run_bwd(int stage, int bwd_f32, const float* pts, const float* m_all,
            const float* aux, const float* cut, const bf16* img_t,
            const bf16* act, const float* g, const float* w_rgb,
            const float* w_alpha, void* dhv_v, float* dview, void* dh_a_v,
            void* dh_b_v, float* dx0, float* partial, float* bpart,
            const long long* bmap, float* dW, float* dpts, float* dm,
            float* daux, int P, int S, int w, int depth, const int* skip,
            int nfk, int nfv, int fc, int chunk, int dx_items, float tau,
            void* stream_v) {
  if ((stage != BWD_FULL && stage != BWD_MLP && stage != BWD_PE)
      || (bwd_f32 != 0 && bwd_f32 != 1))
    return (int)cudaErrorInvalidValue;
  if (chunk % TM != 0 || depth < 1 || w % NB != 0
      || (!bwd_f32 && dx_items < 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = (cudaStream_t)stream_v;
  const BwdGeo G = make_geo(P, w, depth, skip, nfk, nfv, fc, chunk);
  if (!bwd_f32)
    return run_bwd_bf16(stage, G, pts, m_all, aux, cut, img_t, act, g, w_rgb,
                        w_alpha, reinterpret_cast<bf16*>(dhv_v), dview,
                        reinterpret_cast<bf16*>(dh_a_v),
                        reinterpret_cast<bf16*>(dh_b_v), dx0, partial, bpart,
                        bmap, dW, dpts, dm, daux, P, S, depth, skip, nfk, nfv,
                        fc, chunk, dx_items, tau, stream);
  const Dims& d = G.d;
  const ActRows& ar = G.ar;
  const int W = G.W, WV = G.WV, k0t = G.k0t, kvt = G.kvt;
  const long long total = G.total, aslice = G.aslice;
  const int n_chunk = G.n_chunk, cs = G.cs;
  const int iF = G.iF, iV = G.iV, ldv = W + d.kvp, h_last = G.h_last;
  float* dhv = reinterpret_cast<float*>(dhv_v);
  float* dh_a = reinterpret_cast<float*>(dh_a_v);
  float* dh_b = reinterpret_cast<float*>(dh_b_v);
  auto arow = [&](int row) { return act + (size_t)row * KC; };
  auto tseg = [&](int i, int s) {
    return img_t + (s ? G.toff1[i] : G.toff0[i]);
  };
  const std::vector<long long>& goff = G.goff;

  Seq q{stream};
  q.L.n_prod = 0;
  q.L.P = P;
  q.L.F = ar.F;
  q.L.pt_tiles = (P + TM - 1) / TM;
  q.L.total = total;
  q.L.act = act;

  // 2. the heads and dhv
  heads_bwd_kernel<false><<<n_chunk * head_blocks(W, false) + q.L.pt_tiles,
                            256, 0, stream>>>(
      act, ar.F, ar.hv, h_last, g, w_rgb, dhv, partial, total, G.g_rgb,
      G.g_alpha, P, chunk, n_chunk, W, 0, nullptr, 0, 0);
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
      partial, dW, total, n_chunk, nullptr, nullptr, 0, 0, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (stage == BWD_MLP) return 0;

  return launch_pe(stage, pts, m_all, aux, cut, dx0, dview + W, ldv, dpts,
                   dm, daux, P, S, nfk, nfv, fc, d.k0p, tau, stream);
}

}  // namespace

extern "C" {

// K2 after its recompute (anerf_k2_recompute_sm90 of K1's library wrote
// act) on `stream`, up to `stage` (0 full: dW flat in the Python
// grad_blocks order, dpts, dm_all, daux; 2 mlp: dW, dx0 and d[xv]; 3 pe:
// dW and the PE digest in dpts), with bwd_f32 1 (f32-accurate cotangent
// products) or 0 (bf16 cotangent operands), for a trunk of width w and
// depth `depth` with the host array skip[depth] of per-layer skip flags
// and fc framecode columns (aux rows of 2 * 72 + fc floats). The
// recompute may also be the layered route's (anerf_layered_forward of
// fused_render_layered_sm90.cu with act). img_t is the W^T image
// (packed 'img_t'); the scratch buffers come from the caller, as
// fused_render.py's bwd_plan sizes them (the f32 flavour: f32 dhv, dview,
// dh_a, dh_b; the bf16 flavour: bf16 tiles dhv, dh_a, dh_b, f32 d[xv] in
// dview's place, and bpart / bmap, which the f32 flavour does not read),
// with `chunk` points a dW partial and dx_items tiles a DX CTA (bf16).
// Returns a cudaError_t code (0 on success).
int anerf_fused_bwd_sm90(int stage, int bwd_f32, const float* pts,
                         const float* m_all, const float* aux,
                         const float* cut, const void* img_t,
                         const void* act, const float* g,
                         const float* w_rgb, const float* w_alpha,
                         void* dhv, float* dview, void* dh_a, void* dh_b,
                         float* dx0, float* partial, float* bpart,
                         const long long* bmap, float* dW, float* dpts,
                         float* dm, float* daux, int P, int S, int w,
                         int depth, const int* skip, int nfk, int nfv,
                         int fc, int chunk, int dx_items, float tau,
                         void* stream) {
  return run_bwd(stage, bwd_f32, pts, m_all, aux, cut,
                 reinterpret_cast<const bf16*>(img_t),
                 reinterpret_cast<const bf16*>(act), g, w_rgb, w_alpha, dhv,
                 dview, dh_a, dh_b, dx0, partial, bpart, bmap, dW, dpts, dm,
                 daux, P, S, w, depth, skip, nfk, nfv, fc, chunk, dx_items,
                 tau, stream);
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
  Seq q{(cudaStream_t)stream};
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
