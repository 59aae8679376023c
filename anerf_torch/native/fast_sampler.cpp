// Native host-side batch assembly for the training data path.
//
// The per-iteration host work (mask-restricted pixel sampling without
// replacement, pixel gathers from the flattened (H*W, C) image rows, ray
// direction assembly) is the data loader's inner loop. The reference
// parallelizes it with 16 torch DataLoader worker processes
// (core/load_data.py:78-80); here it is a small C++ library driven by the
// thread pool of the Python BatchLoader: no worker processes, no pickling.
//
// A plain C interface, bound with ctypes (anerf_torch/native/__init__.py),
// which releases the interpreter lock for every call. The sampling and
// gather arithmetic is that of the JAX package's extension
// (anerf_tpu/native/fast_sampler.cpp), statement for statement, so both
// give the same batches from the same seeds when built by the same
// compiler. Every function returns 0; the callers check shapes, dtypes and
// contiguity before they pass pointers.
//
//   anerf_sample_mask_pixels(mask u8 (n,), n, n_samples, seed, out i64)
//       sorted sample WITHOUT replacement of indices where mask > 0
//       (with replacement only if fewer are valid than requested).
//   anerf_gather_rays(dirs f32 (HW, 3), idxs i64 (S,), S, c2w f32 (4, 4),
//                     focal_x, focal_y, out f32 (S, 6))
//       gathers precomputed pixel directions, divides by focal, rotates by
//       c2w and broadcasts the origin (mirrors dataset.get_rays,
//       core/dataset.py:346-364): [o(3) d(3)] per ray.
//   anerf_gather_pixels(img_row u8 (HW, C), idxs i64 (S,), S, C,
//                       out f32 (S, C))   pixels scaled by 1/255.
//   anerf_assemble_super_batch(...)   see below.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <random>
#include <thread>
#include <vector>

namespace {

// The mask-restricted sample of one item: `sel` gets n_samples sorted
// pixel indices drawn from `valid` (scratch, filled here) by a
// mt19937_64 seeded with `seed`.
void sample_pixels(const uint8_t* m, int64_t n, int64_t n_samples,
                   uint64_t seed, std::vector<int64_t>* valid_scratch,
                   int64_t* sel) {
  std::vector<int64_t>& valid = *valid_scratch;
  valid.clear();
  for (int64_t i = 0; i < n; ++i) {
    if (m[i] > 0) valid.push_back(i);
  }
  std::mt19937_64 rng(seed);
  if (valid.empty()) {
    for (int64_t i = 0; i < n; ++i) valid.push_back(i);
  }
  const size_t nv = valid.size();
  if (static_cast<size_t>(n_samples) <= nv) {
    // partial Fisher-Yates: the first n_samples entries are a uniform
    // sample
    for (int64_t i = 0; i < n_samples; ++i) {
      std::uniform_int_distribution<size_t> d(static_cast<size_t>(i),
                                              nv - 1);
      std::swap(valid[i], valid[d(rng)]);
      sel[i] = valid[i];
    }
  } else {
    std::uniform_int_distribution<size_t> d(0, nv - 1);
    for (int64_t i = 0; i < n_samples; ++i) sel[i] = valid[d(rng)];
  }
  std::sort(sel, sel + n_samples);
}

// assemble_super_batch ---------------------------------------------------
//
// Whole-dispatch batch assembly in one call: for each of the
// M = stack*n_images items, mask-restricted pixel sampling (the stream of
// anerf_sample_mask_pixels given the same per-item seed), ray assembly
// from a precomputed direction mesh, and pixel/fg/bg gathers, written
// directly into the caller's pre-allocated stacked output slabs. Replaces
// ~M Python get_item calls + per-key concatenates per dispatch (the
// reference's analogue is the DataLoader worker pool + collate,
// core/load_data.py:78-80, core/dataset.py:813-820). Multithreaded over
// items.
//
// Item operands (length M, C-contiguous):
//   img_idxs i64; dirs_idxs i64 (row into dirs); bg_rows i64 (-1 = none);
//   c2ws f32 (M,16) row-major 4x4; focals f32 (M,2); seeds u64.
// Table operands: imgs u8 (N,HW,3); masks u8 (N,HW); smasks u8 (N,HW);
//   bgs u8 (B,HW,3) or empty; dirs f32 (D,HW,3).
// Outputs (pre-allocated):
//   rays f32 (M*S, 11) = [o(3) d(3) near=0 far=1 viewdir(3)];
//   target f32 (M*S, 3); fg f32 (M*S, 1); bg f32 (M*S, 3).

struct SuperArgs {
  const uint8_t *imgs, *masks, *smasks, *bgs;
  const float* dirs;
  const int64_t *img_idxs, *dirs_idxs, *bg_rows;
  const float *c2ws, *focals;
  const uint64_t* seeds;
  float *rays, *target, *fg, *bg;
  int64_t M, S, HW;
  int mask_img;
};

void assemble_item(const SuperArgs& a, int64_t it,
                   std::vector<int64_t>* valid_scratch,
                   std::vector<int64_t>* out_scratch) {
  const int64_t S = a.S, HW = a.HW;
  std::vector<int64_t>& sel = *out_scratch;
  sel.resize(static_cast<size_t>(S));
  sample_pixels(a.smasks + a.img_idxs[it] * HW, HW, S, a.seeds[it],
                valid_scratch, sel.data());

  // --- rays + viewdirs ---
  const float* C = a.c2ws + it * 16;
  const float* D = a.dirs + a.dirs_idxs[it] * HW * 3;
  const float fx = a.focals[it * 2], fy = a.focals[it * 2 + 1];
  const float inv_fx = 1.0f / fx, inv_fy = 1.0f / fy;
  const float ox = C[3], oy = C[7], oz = C[11];
  const uint8_t* img = a.imgs + a.img_idxs[it] * HW * 3;
  const uint8_t* msk = a.masks + a.img_idxs[it] * HW;
  const uint8_t* bgr =
      a.bg_rows[it] >= 0 ? a.bgs + a.bg_rows[it] * HW * 3 : nullptr;
  constexpr float kInv = 1.0f / 255.0f;

  for (int64_t s = 0; s < S; ++s) {
    const int64_t pix = sel[s];
    const float* d = D + pix * 3;
    const float dx = d[0] * inv_fx, dy = d[1] * inv_fy, dz = d[2];
    const float wx = C[0] * dx + C[1] * dy + C[2] * dz;
    const float wy = C[4] * dx + C[5] * dy + C[6] * dz;
    const float wz = C[8] * dx + C[9] * dy + C[10] * dz;
    float* r = a.rays + (it * S + s) * 11;
    r[0] = ox; r[1] = oy; r[2] = oz;
    r[3] = wx; r[4] = wy; r[5] = wz;
    r[6] = 0.0f; r[7] = 1.0f;
    const float inv_n = 1.0f / std::sqrt(wx * wx + wy * wy + wz * wz);
    r[8] = wx * inv_n; r[9] = wy * inv_n; r[10] = wz * inv_n;

    const float fgv = static_cast<float>(msk[pix]);
    a.fg[it * S + s] = fgv;
    float* t = a.target + (it * S + s) * 3;
    float* b = a.bg + (it * S + s) * 3;
    const uint8_t* p = img + pix * 3;
    if (bgr != nullptr) {
      const uint8_t* q = bgr + pix * 3;
      for (int c = 0; c < 3; ++c) {
        const float bv = static_cast<float>(q[c]) * kInv;
        float iv = static_cast<float>(p[c]) * kInv;
        if (a.mask_img) iv = iv * fgv + (1.0f - fgv) * bv;
        t[c] = iv;
        b[c] = bv;
      }
    } else {
      for (int c = 0; c < 3; ++c) {
        t[c] = static_cast<float>(p[c]) * kInv;
        b[c] = 1.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

int anerf_sample_mask_pixels(const uint8_t* mask, int64_t n,
                             int64_t n_samples, uint64_t seed,
                             int64_t* out) {
  std::vector<int64_t> valid;
  valid.reserve(static_cast<size_t>(n / 8));
  sample_pixels(mask, n, n_samples, seed, &valid, out);
  return 0;
}

int anerf_gather_rays(const float* dirs, const int64_t* idxs, int64_t S,
                      const float* c2w, double focal_x, double focal_y,
                      float* out) {
  const float ox = c2w[3], oy = c2w[7], oz = c2w[11];
  const float r00 = c2w[0], r01 = c2w[1], r02 = c2w[2];
  const float r10 = c2w[4], r11 = c2w[5], r12 = c2w[6];
  const float r20 = c2w[8], r21 = c2w[9], r22 = c2w[10];
  const float inv_fx = 1.0f / static_cast<float>(focal_x);
  const float inv_fy = 1.0f / static_cast<float>(focal_y);
  for (int64_t s = 0; s < S; ++s) {
    const float* d = dirs + idxs[s] * 3;
    const float dx = d[0] * inv_fx, dy = d[1] * inv_fy, dz = d[2];
    float* o = out + s * 6;
    o[0] = ox;
    o[1] = oy;
    o[2] = oz;
    o[3] = r00 * dx + r01 * dy + r02 * dz;
    o[4] = r10 * dx + r11 * dy + r12 * dz;
    o[5] = r20 * dx + r21 * dy + r22 * dz;
  }
  return 0;
}

int anerf_gather_pixels(const uint8_t* img, const int64_t* idxs, int64_t S,
                        int64_t channels, float* out) {
  constexpr float kInv = 1.0f / 255.0f;
  for (int64_t s = 0; s < S; ++s) {
    const uint8_t* p = img + idxs[s] * channels;
    for (int64_t c = 0; c < channels; ++c) {
      out[s * channels + c] = static_cast<float>(p[c]) * kInv;
    }
  }
  return 0;
}

int anerf_assemble_super_batch(
    const uint8_t* imgs, const uint8_t* masks, const uint8_t* smasks,
    const uint8_t* bgs, const float* dirs, const int64_t* img_idxs,
    const int64_t* dirs_idxs, const int64_t* bg_rows, const float* c2ws,
    const float* focals, const uint64_t* seeds, int64_t M, float* rays,
    float* target, float* fg, float* bg, int64_t S, int64_t HW,
    int mask_img, int n_threads) {
  SuperArgs a;
  a.imgs = imgs;
  a.masks = masks;
  a.smasks = smasks;
  a.bgs = bgs;
  a.dirs = dirs;
  a.img_idxs = img_idxs;
  a.dirs_idxs = dirs_idxs;
  a.bg_rows = bg_rows;
  a.c2ws = c2ws;
  a.focals = focals;
  a.seeds = seeds;
  a.rays = rays;
  a.target = target;
  a.fg = fg;
  a.bg = bg;
  a.M = M;
  a.S = S;
  a.HW = HW;
  a.mask_img = mask_img;

  const int nt = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(n_threads, a.M)));
  if (nt == 1) {
    std::vector<int64_t> valid, sel;
    for (int64_t it = 0; it < a.M; ++it) assemble_item(a, it, &valid, &sel);
  } else {
    std::vector<std::thread> pool;
    std::atomic<int64_t> next(0);
    pool.reserve(static_cast<size_t>(nt));
    for (int t = 0; t < nt; ++t) {
      pool.emplace_back([&a, &next]() {
        std::vector<int64_t> valid, sel;
        for (;;) {
          const int64_t it = next.fetch_add(1);
          if (it >= a.M) break;
          assemble_item(a, it, &valid, &sel);
        }
      });
    }
    for (auto& t : pool) t.join();
  }
  return 0;
}

}  // extern "C"
