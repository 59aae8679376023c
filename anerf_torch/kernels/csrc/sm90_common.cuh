// Hopper (sm_90a) building blocks shared by K1 (fused_render_sm90.cu), K2
// (fused_render_bwd_sm90.cu) and the layered route
// (fused_render_layered_sm90.cu): the 128-byte-swizzled tile layout that
// wgmma reads, its shared-memory descriptors, mbarrier waits and arrives,
// the cluster's remote arrives, bulk copies (multicast too) and bulk
// stores, stmatrix.trans, named barriers, and the wgmma.m64n256k16 /
// m64n128k16 / m64n64k16 instructions with bf16 operands from shared
// memory and f32 accumulators in registers.
#pragma once

#include "fused_render_common.cuh"

namespace {

constexpr int NCONS = 256;               // two consumer warpgroups
constexpr int NT = NCONS + 128;          // + one producer warpgroup
constexpr int KC = 64;                   // k-slice depth (128 bytes of bf16)
constexpr int CHUNK = TM * KC;           // bf16 of one 64 x 64 A chunk
constexpr int MAX_SMEM = 232448;         // an H100 block's opt-in maximum

// The bf16 element offset of (row r, column k) in a tile stored as
// 64-column chunks of 64 rows x 128 bytes, each 16-byte group of a row
// swizzled by the row (the wgmma K-major 128-byte swizzle; the buffer is
// 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int k) {
  return (k >> 6) * CHUNK + r * KC + ((((k >> 3) & 7) ^ (r & 7)) << 3)
         + (k & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for an MN-major operand in the 128-byte swizzle: 64 rows'
// worth (128 bytes) of each k, 8 k in a 1,024-byte atom, the atoms of
// successive 8 k 1,024 bytes apart (the stride field; the other field,
// the stride between 64-row atoms, is unused at 64 rows and set alike).
__device__ __forceinline__ uint64_t gmma_desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait for the phase of parity `parity` of barrier `bar` to complete. A
// wait of more than about 10 s (2^34 clocks) can only be a fault of the
// pipeline: it traps, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// A warp's arrive on the barrier at the same offset in every CTA of a
// cluster of NCTA: lane c arrives on CTA c's, so the NCTA remote arrives go
// out together (the default .release.cta semantics: a .cluster-scope
// release is a fence of about 1,500 cycles, paid once per warp and
// k-slice).
template <int NCTA>
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  const uint32_t lane = threadIdx.x & 31;
  if (lane < NCTA) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(bar), "r"(lane));
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
                 : "memory");
  }
}

// `bytes` from global `src` to shared `dst` of every CTA of a cluster of
// NCTA (the same offset in each), completing on each CTA's barrier `bar`.
template <int NCTA>
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               int bytes, uint32_t bar) {
  const uint16_t mask = (1 << NCTA) - 1;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// bf16 pair (lo in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// `bytes` from global `src` to shared `dst`, completing on barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One arrive on barrier `bar` of this CTA.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The 128 threads of consumer warpgroup wg (named barriers 2 and 3).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// `bytes` of shared `src` to global `dst`, one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory / are done.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices of the warp's fragments (register i holds
// matrix i: row lane / 4, columns 2 (lane % 4), + 1), each stored
// transposed: row i of matrix m (a column of the fragment) at the address
// lane 8 m + i gives.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// The 256 consumer threads only (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
}

// Ordinary st.shared before wgmma's async-proxy reads of the same bytes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K2's saved activations ('act', written by K1's SAVE instantiation and
// read by K2's weight-gradient products as their B operand): per tile of
// TM = 64 points, F feature rows of 64 points (128 bytes), the 16-byte
// group h of feature row f holding points 8 (h ^ (f % 8)) .. + 7: the
// K-major 128-byte swizzle with the points as k. Feature rows: x0
// (padded to 64) | xv (padded to 64) | h_0 .. h_{depth-1} | feat | hv, for
// a trunk of width w (W at the flagship).
struct ActRows {
  int x0, xv, h, feat, hv, F;
};

__host__ __device__ inline ActRows make_act_rows(const Dims& d, int depth,
                                                 int w = W) {
  ActRows a;
  a.x0 = 0;
  a.xv = (d.k0 + KC - 1) / KC * KC;
  a.h = a.xv + (d.kv + KC - 1) / KC * KC;
  a.feat = a.h + depth * w;
  a.hv = a.feat + w;
  a.F = a.hv + w / 2;
  return a;
}

// The element offset of (point p, feature row f) in act.
__device__ __forceinline__ size_t act_at(int p, int f, int F) {
  return ((size_t)(p >> 6) * F + f) * KC + ((((p >> 3) & 7) ^ (f & 7)) << 3)
         + (p & 7);
}

template <int NACC>
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ANERF_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x N] += A (desc a) B^T (desc b), bf16 operands, f32 accumulators;
// NACC = N / 2 registers a thread. TA = 1 reads A MN-major (gmma_desc_mn:
// the rows' index contiguous, as K2's act layout holds a tile), else
// K-major.
template <int NACC, int TA = 0>
__device__ __forceinline__ void wgmma(float (&d)[NACC], uint64_t a,
                                      uint64_t b) {
  static_assert(NACC == 128 || NACC == 64 || NACC == 32, "wgmma width");
  if constexpr (NACC == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, "
        "%128, %129, p, 1, 1, %131, 0;\n}\n"
        : ANERF_F8(0), ANERF_F8(8), ANERF_F8(16), ANERF_F8(24), ANERF_F8(32),
          ANERF_F8(40), ANERF_F8(48), ANERF_F8(56), ANERF_F8(64),
          ANERF_F8(72), ANERF_F8(80), ANERF_F8(88), ANERF_F8(96),
          ANERF_F8(104), ANERF_F8(112), ANERF_F8(120)
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  } else if constexpr (NACC == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, 0;\n}\n"
        : ANERF_F8(0), ANERF_F8(8), ANERF_F8(16), ANERF_F8(24), ANERF_F8(32),
          ANERF_F8(40), ANERF_F8(48), ANERF_F8(56)
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, 0;\n}\n"
        : ANERF_F8(0), ANERF_F8(8), ANERF_F8(16), ANERF_F8(24)
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
}
#undef ANERF_F8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

}  // namespace
