// Device code shared by K2 (fused_render_bwd_sm90.cu) and K2-v1
// (fused_render_bwd.cu): the fixed-order sum of the per-chunk weight-gradient
// partials and the per-ray backward of the cutoff PE and the world->local
// transform in exact fp32.
#pragma once

#include "fused_render_common.cuh"

namespace {

// out[i] = sum over chunks c = 0, 1, .. of partial[c * total + i], but in
// a bias row (bmap: per MMA layer its dW offset, length and bias partial
// column, in dW order; n_layers = 0 where there is none, as in K2's f32
// flavour and K2-v1) the sum over the n_groups rows of the bias partials
// bpart (K2's bf16 flavour: one row a DX group) instead. Both in a fixed
// order.
__global__ void reduce_chunks_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out,
                                     long long total, int n_chunk,
                                     const float* __restrict__ bpart,
                                     const long long* __restrict__ bmap,
                                     int n_layers, int n_groups, int n_bias) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int lo = 0, hi = n_layers - 1, l = -1;   // the last layer at or before i
  while (lo <= hi) {
    const int mid = (lo + hi) / 2;
    if (bmap[3 * mid] <= i) { l = mid; lo = mid + 1; } else { hi = mid - 1; }
  }
  float s = 0.f;
  if (l >= 0 && i < bmap[3 * l] + bmap[3 * l + 1]) {
    const long long col = bmap[3 * l + 2] + (i - bmap[3 * l]);
    for (int c = 0; c < n_groups; ++c) s += bpart[(long long)c * n_bias + col];
  } else {
    for (int c = 0; c < n_chunk; ++c) s += partial[(long long)c * total + i];
  }
  out[i] = s;
}

// One CTA per ray: the cutoff-PE and transform backward of its S points,
// from the cotangents of the MLP inputs dx0 (P x k0p, row stride ldx0)
// and dxv (P x kvp, row stride ldxv). Shared memory: dpts_t and dd of
// every sample (2 x S x 72 f32) and the ray's view-band sin / cos
// (2 x nfv x 72 f32). aux rows and daux rows are 2 x 72 + fc floats (fc
// framecode columns, FC at the flagship). PE_ONLY (K2-d's pe stage) stops
// before the transform backward and writes dpts[p] = (sum_j dv_j,
// sum_c dd_c, sum_c dr_c): dv is the distances' cotangent with the window
// derivative, dd the view directions', dr the unit bone directions' (read
// from dx0).
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
                        float* __restrict__ daux, int fc) {
  const int auxw = 2 * C72 + fc;
  extern __shared__ __align__(16) float sm[];
  float* dpt = sm;                 // S x 72: d pts_t
  float* ddd = dpt + S * C72;      // S x 72: d view dirs
  float* sdt = ddd + S * C72;      // nfv x 72: sin(2^k d)
  float* cdt = sdt + nfv * C72;    // nfv x 72: cos(2^k d)
  const int ray = blockIdx.x, tid = threadIdx.x;
  const float* m = m_all + (size_t)ray * 3 * C72;
  const float* ax = aux + (size_t)ray * auxw;

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
  for (int c = tid; c < auxw; c += NTHREADS) {
    float acc = 0.f;
    if (c < C72) {
      for (int s = 0; s < S; ++s) acc += dpt[s * C72 + c];
    } else if (c < 2 * C72) {
      for (int s = 0; s < S; ++s) acc += ddd[s * C72 + c - C72];
    } else {
      for (int s = 0; s < S; ++s)
        acc += dxv[((size_t)ray * S + s) * ldxv + fc0 + c - 2 * C72];
    }
    daux[(size_t)ray * auxw + c] = acc;
  }
}

}  // namespace
