// K6: the SSAA shade pass, forward and analytic backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. In the SSAA path it takes over the work of K2's
// per-fragment fetches, of K3's scatter behind them, and of the XLA-fused jnp
// shade of hifihr_tpu/render/renderer.py (barycentrics, interpolation, UV
// sample, Phong, the pool); K2 and K3 stay for the MSAA paths. Added because
// the port's composed route, about 250 PyTorch operations forward and 650
// backward (checkpoint's recompute included) over (80, 672^2, .) tensors, took
// 303 ms of the textured FreiHAND cell's 351-ms train step on an H100.
//
// Contract (render/ssaa_shade.py; `ssaa_shade_partials_plain` is the plain
// version of both launches): face_id (B, S, S) int32 from K4, -1 on
// background; faces (F, 3) int64; the per-vertex table (B, V, R) fp32, a row
// [u, v, z | channels | zeros] laid out as `Lay` says for the plan (kind 0:
// vertex colours, 1: UV from a per-face atlas face_uv (F, 3, 2), 2: UV from
// the per-vertex chart in the row; with or without the tangents and the
// normal and spec maps); the maps (B, Ht, Wt, C) fp32, of which the first 7
// (maps) or 3 channels are read; the light (B, 12) [ambient, 0.8 diffuse,
// 0.2 specular, unit direction]. Forward: out (B, S / aa, S / aa, 5), the
// mean over each aa x aa block of [rgb, 1, z] at covered supersamples and 0
// elsewhere. Each covered supersample at (col + 0.5, row + 0.5) is
//   e_k = E(corner k + 1, corner k + 2), E(p, q) = (q_x - p_x)(v - p_y) -
//   (q_y - p_y)(u - p_x); area = e_0 + e_1 + e_2 (1e-12 where |area| is
//   below it); w = e / area; z_k 1e-8 where |z_k| is below it; wp = w / z;
//   den = sum wp (1e-12 where below); bary = clamp(wp / den, -4, 5);
//   each channel the bary-weighted sum of its corners' (the atlas corners the
//   same way); the UV clipped to [0, 1], scaled by (W - 1, H - 1), the texel
//   quad at its floor with the last row and column clamped, the bilinear
//   sample; then Phong as render/shading.py: n = unit(N) (perturbed by the
//   tangent-space normal map in the frame of the unit tangent made
//   orthogonal to n), ndl = max(n.l, 0), view = -unit(P), r = -l + 2 (n.l) n,
//   cos = max(view.r, 0) where ndl > 0 else 0, rgb = T (amb + dif ndl) +
//   spe cos^30 [spec map]; unit(x) = x rsqrt(|x|^2 + 1e-12).
// Backward: the gradients of the forward at grad (B, S / aa, S / aa, 5) with
// respect to the table (every channel), the maps (when asked) and the light
// (when asked), added into zeroed fp32 buffers, with torch's subgradients: the
// clamps pass the gradient at their bounds, the UV clip half of it, the
// guards none, cos^30 none at 0, the specular term none where ndl <= 0.
//
// What bounds it on this card: bytes. At the textured cell's (80, 672^2) with
// 12% of supersamples covered, the forward reads face_id (144.5 MB) and each
// covered fragment's corners and texel quad (the table is 23 MB, the maps 147
// MB) and writes 80.3 MB: about 0.12 ms at 3.35 TB/s. The backward reads the
// same and the output's gradient, and adds into the table's and the maps'
// gradients: about 0.2 ms.
//
// Design. One thread per output pixel walks its aa x aa supersamples in row
// order and returns after one 4-byte read on each background sample (most of
// the image). A covered sample loads its face's three corner rows (float4,
// kept while the next sample has the same face) and shades in registers; the
// forward writes the block's mean, so nothing of the supersampled size is
// written. The backward recomputes each covered sample's forward in registers
// and applies the chain rule by hand; its corner gradients are summed in
// registers over a run of samples of one face (a face covers about nine
// supersamples here, so most of an output pixel's block) and added with one
// atomic a channel when the face changes; each texel's gradient is an atomic
// add (about 0.8 covered fragments a texel here, so little contention); the
// light's gradient is summed over the block through warp shuffles and shared
// memory, then one atomic a float a block. All arithmetic is fp32, every
// product and sum rounded on its own (no contracted multiply-add, the build's
// -fmad=false), in the plain version's order where it fixes one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Args {
  const int* face_id;       // (B, S, S)
  const long long* faces;   // (F, 3)
  const float* face_uv;     // (F, 3, 2) or null
  const float* table;       // (B, V, R)
  const float* tex;         // (B, Ht, Wt, C) or null
  const float* light;       // (B, 12)
  int F, V, R, Ht, Wt, C, S, aa;
};

// Offsets in a table row. kKind 0: [uvz | colour | normal | point], 1: [uvz |
// tangent? | normal | point], 2: [uvz | uv | tangent? | normal | point].
template <int kKind, bool kMaps>
struct Lay {
  static constexpr int color = 3;
  static constexpr int uv = 3;
  static constexpr int after = kKind == 0 ? 6 : kKind == 2 ? 5 : 3;
  static constexpr int tangent = after;
  static constexpr int normal = kMaps ? after + 3 : after;
  static constexpr int point = normal + 3;
  static constexpr int used = point + 3;                // floats of a row that are read
  static constexpr int width = (used + 3) / 4 * 4;      // R
  static constexpr int nt = kKind == 0 ? 0 : kMaps ? 7 : 3;  // channels of the maps read
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// y = x r with r = rsqrt(|x|^2 + 1e-12): dx = r dy - r^3 (x.dy) x.
__device__ __forceinline__ void norm_bwd(const float* x, float r, const float* dy, float* dx) {
  const float k = (r * r * r) * dot3(x, dy);
  for (int c = 0; c < 3; ++c) dx[c] = r * dy[c] - k * x[c];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// d clip(x, 0, 1) / dx as torch takes it for min(max(x, 0), 1).
__device__ __forceinline__ float clip01_grad(float x) {
  return (x > 0.0f && x < 1.0f) ? 1.0f : (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
}

template <int kKind, bool kMaps>
__device__ __forceinline__ void load_rows(const Args& a, int b, int f, int (&vid)[3],
                                          float (&r)[3][Lay<kKind, kMaps>::width]) {
  using L = Lay<kKind, kMaps>;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vid[k] = (int)__ldg(a.faces + 3 * (size_t)f + k);
    const float4* src = reinterpret_cast<const float4*>(a.table + ((size_t)b * a.V + vid[k]) * L::width);
#pragma unroll
    for (int j = 0; j < L::width / 4; ++j) {
      const float4 q = __ldg(src + j);
      r[k][4 * j] = q.x;
      r[k][4 * j + 1] = q.y;
      r[k][4 * j + 2] = q.z;
      r[k][4 * j + 3] = q.w;
    }
  }
}

// One covered supersample of face f of image b at (u, v), its corner rows r.
// Forward (kBwd false): s5 = [rgb, 1, z]. Backward: with g5 the sample's share
// of the output's gradient, adds the corner gradients into acc, the light's
// into lacc (when g_light), the maps' into g_tex (when not null).
template <int kKind, bool kMaps, bool kBwd>
__device__ __forceinline__ void fragment(const Args& a, int b, int f, float u, float v,
                                         const float (&r)[3][Lay<kKind, kMaps>::width], float* s5,
                                         const float* g5, float (&acc)[3][Lay<kKind, kMaps>::width],
                                         float (&lacc)[12], float* g_tex) {
  using L = Lay<kKind, kMaps>;
  constexpr int D = L::used - 3;
  constexpr int NT = L::nt > 0 ? L::nt : 1;
  float px[3], py[3], pz[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    px[k] = r[k][0];
    py[k] = r[k][1];
    pz[k] = r[k][2];
  }
  float e[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = (k + 1) % 3, q = (k + 2) % 3;
    e[k] = (px[q] - px[p]) * (v - py[p]) - (py[q] - py[p]) * (u - px[p]);
  }
  const float area = (e[0] + e[1]) + e[2];
  const bool area_ok = !(fabsf(area) < 1e-12f);
  const float area_s = area_ok ? area : 1e-12f;
  float w[3], zs[3], wp[3];
  bool z_ok[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = e[k] / area_s;
    z_ok[k] = !(fabsf(pz[k]) < 1e-8f);
    zs[k] = z_ok[k] ? pz[k] : 1e-8f;
    wp[k] = w[k] / zs[k];
  }
  const float den = (wp[0] + wp[1]) + wp[2];
  const bool den_ok = !(fabsf(den) < 1e-12f);
  const float den_s = den_ok ? den : 1e-12f;
  float braw[3], bary[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    braw[k] = wp[k] / den_s;
    bary[k] = fminf(fmaxf(braw[k], -4.0f), 5.0f);
  }
  float P[D];
#pragma unroll
  for (int c = 0; c < D; ++c) P[c] = (bary[0] * r[0][3 + c] + bary[1] * r[1][3 + c]) + bary[2] * r[2][3 + c];

  // the UV sample
  float uvc[2] = {0.0f, 0.0f}, fuv[3][2];
  float samp[NT], top[NT], bot[NT], t00[NT], t01[NT], t10[NT], t11[NT];
  float fx = 0.0f, fy = 0.0f;
  size_t o00 = 0, o01 = 0, o10 = 0, o11 = 0;
  if constexpr (L::nt > 0) {
    if constexpr (kKind == 1) {
      const float* fu = a.face_uv + 6 * (size_t)f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        fuv[k][0] = __ldg(fu + 2 * k);
        fuv[k][1] = __ldg(fu + 2 * k + 1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) uvc[j] = (bary[0] * fuv[0][j] + bary[1] * fuv[1][j]) + bary[2] * fuv[2][j];
    } else {
      uvc[0] = P[L::uv - 3];
      uvc[1] = P[L::uv - 2];
    }
    const float x = fminf(fmaxf(uvc[0], 0.0f), 1.0f) * (float)(a.Wt - 1);
    const float y = fminf(fmaxf(uvc[1], 0.0f), 1.0f) * (float)(a.Ht - 1);
    const float x0 = floorf(x), y0 = floorf(y);
    fx = x - x0;
    fy = y - y0;
    const int ix0 = (int)x0, iy0 = (int)y0;
    const int ix1 = min(ix0 + 1, a.Wt - 1), iy1 = min(iy0 + 1, a.Ht - 1);
    const size_t img = (size_t)b * a.Ht;
    o00 = ((img + iy0) * a.Wt + ix0) * a.C;
    o01 = ((img + iy0) * a.Wt + ix1) * a.C;
    o10 = ((img + iy1) * a.Wt + ix0) * a.C;
    o11 = ((img + iy1) * a.Wt + ix1) * a.C;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      t00[c] = __ldg(a.tex + o00 + c);
      t01[c] = __ldg(a.tex + o01 + c);
      t10[c] = __ldg(a.tex + o10 + c);
      t11[c] = __ldg(a.tex + o11 + c);
      top[c] = t00[c] * (1.0f - fx) + t01[c] * fx;
      bot[c] = t10[c] * (1.0f - fx) + t11[c] * fx;
      samp[c] = top[c] * (1.0f - fy) + bot[c] * fy;
    }
  }

  // Phong
  float T[3], Nr[3], Q[3], n0[3], n[3], l[3], amb[3], dif[3], spe[3];
  const float* lb = a.light + 12 * (size_t)b;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if constexpr (L::nt > 0) {
      T[c] = samp[c];
    } else {
      T[c] = P[L::color - 3 + c];
    }
    Nr[c] = P[L::normal - 3 + c];
    Q[c] = P[L::point - 3 + c];
    amb[c] = __ldg(lb + c);
    dif[c] = __ldg(lb + 3 + c);
    spe[c] = __ldg(lb + 6 + c);
    l[c] = __ldg(lb + 9 + c);
  }
  const float r0 = rsqrtf(dot3(Nr, Nr) + 1e-12f);
#pragma unroll
  for (int c = 0; c < 3; ++c) n0[c] = Nr[c] * r0;
  float Tg[3], s = 0.0f, tp[3], rt = 0.0f, t[3], bt[3], nm[3], m[3], rm = 0.0f, SM = 1.0f;
  if constexpr (kMaps) {
#pragma unroll
    for (int c = 0; c < 3; ++c) Tg[c] = P[L::tangent - 3 + c];
    s = dot3(Tg, n0);
#pragma unroll
    for (int c = 0; c < 3; ++c) tp[c] = Tg[c] - s * n0[c];
    rt = rsqrtf(dot3(tp, tp) + 1e-12f);
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c] = tp[c] * rt;
    cross3(n0, t, bt);
#pragma unroll
    for (int c = 0; c < 3; ++c) nm[c] = samp[3 + c] * 2.0f - 1.0f;
    SM = samp[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) m[c] = (t[c] * nm[0] + bt[c] * nm[1]) + n0[c] * nm[2];
    rm = rsqrtf(dot3(m, m) + 1e-12f);
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = m[c] * rm;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = n0[c];
  }
  const float ndl_raw = dot3(n, l);
  const float ndl = fmaxf(ndl_raw, 0.0f);
  const float rq = rsqrtf(dot3(Q, Q) + 1e-12f);
  float view[3], refl[3];
  const float two_ndl = 2.0f * ndl_raw;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    view[c] = -(Q[c] * rq);
    refl[c] = -l[c] + two_ndl * n[c];
  }
  const float ca_raw = dot3(view, refl);
  const float ca = ndl > 0.0f ? fmaxf(ca_raw, 0.0f) : 0.0f;
  const float pw = powf(ca, 30.0f);
  if constexpr (!kBwd) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float spec = spe[c] * pw;
      if constexpr (kMaps) spec = spec * SM;
      s5[c] = T[c] * (amb[c] + dif[c] * ndl) + spec;
    }
    s5[3] = 1.0f;
    s5[4] = Q[2];
    return;
  } else {
    const float* gs = g5;
    float dP[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dP[c] = 0.0f;
    dP[L::point - 3 + 2] = g5[4];
    float dT[3], d_ndl = 0.0f, d_pw = 0.0f, d_SM = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dT[c] = gs[c] * (amb[c] + dif[c] * ndl);
      const float gT = gs[c] * T[c];
      d_ndl += gT * dif[c];
      lacc[c] += gT;
      lacc[3 + c] += gT * ndl;
      if constexpr (kMaps) {
        lacc[6 + c] += gs[c] * SM * pw;
        d_SM += gs[c] * (spe[c] * pw);
        d_pw += (gs[c] * SM) * spe[c];
      } else {
        lacc[6 + c] += gs[c] * pw;
        d_pw += gs[c] * spe[c];
      }
    }
    float d_ca = ndl > 0.0f ? d_pw * 30.0f * powf(ca, 29.0f) : 0.0f;
    if (!(ca_raw >= 0.0f)) d_ca = 0.0f;
    float d_view[3], d_refl[3], d_n[3], d_l[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d_view[c] = d_ca * refl[c];
      d_refl[c] = d_ca * view[c];
    }
    const float d_ndl_raw = 2.0f * dot3(d_refl, n) + (ndl_raw >= 0.0f ? d_ndl : 0.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d_n[c] = two_ndl * d_refl[c] + d_ndl_raw * l[c];
      d_l[c] = -d_refl[c] + d_ndl_raw * n[c];
      lacc[9 + c] += d_l[c];
    }
    {
      float mdv[3], dq[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) mdv[c] = -d_view[c];
      norm_bwd(Q, rq, mdv, dq);
#pragma unroll
      for (int c = 0; c < 3; ++c) dP[L::point - 3 + c] += dq[c];
    }
    float d_n0[3], d_NM[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (kMaps) {
      float d_m[3], d_t[3], d_bt[3], cr[3], d_tp[3];
      norm_bwd(m, rm, d_n, d_m);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d_t[c] = d_m[c] * nm[0];
        d_bt[c] = d_m[c] * nm[1];
        d_n0[c] = d_m[c] * nm[2];
      }
      d_NM[0] = 2.0f * dot3(d_m, t);
      d_NM[1] = 2.0f * dot3(d_m, bt);
      d_NM[2] = 2.0f * dot3(d_m, n0);
      cross3(t, d_bt, cr);
#pragma unroll
      for (int c = 0; c < 3; ++c) d_n0[c] += cr[c];
      cross3(d_bt, n0, cr);
#pragma unroll
      for (int c = 0; c < 3; ++c) d_t[c] += cr[c];
      norm_bwd(tp, rt, d_t, d_tp);
      const float d_s = -dot3(d_tp, n0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dP[L::tangent - 3 + c] += d_tp[c] + d_s * n0[c];
        d_n0[c] = d_n0[c] - s * d_tp[c] + d_s * Tg[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) d_n0[c] = d_n[c];
    }
    {
      float dnr[3];
      norm_bwd(Nr, r0, d_n0, dnr);
#pragma unroll
      for (int c = 0; c < 3; ++c) dP[L::normal - 3 + c] += dnr[c];
    }
    float d_bary[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (L::nt > 0) {
      float d_samp[NT];
#pragma unroll
      for (int c = 0; c < NT; ++c) d_samp[c] = c < 3 ? dT[c] : c < 6 ? d_NM[c - 3] : d_SM;
      float d_fx = 0.0f, d_fy = 0.0f;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const float d_top = d_samp[c] * (1.0f - fy), d_bot = d_samp[c] * fy;
        if (g_tex != nullptr) {
          atomicAdd(g_tex + o00 + c, d_top * (1.0f - fx));
          atomicAdd(g_tex + o01 + c, d_top * fx);
          atomicAdd(g_tex + o10 + c, d_bot * (1.0f - fx));
          atomicAdd(g_tex + o11 + c, d_bot * fx);
        }
        d_fx += d_top * (t01[c] - t00[c]) + d_bot * (t11[c] - t10[c]);
        d_fy += d_samp[c] * (bot[c] - top[c]);
      }
      const float d_u = d_fx * (float)(a.Wt - 1) * clip01_grad(uvc[0]);
      const float d_v = d_fy * (float)(a.Ht - 1) * clip01_grad(uvc[1]);
      if constexpr (kKind == 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) d_bary[k] = d_u * fuv[k][0] + d_v * fuv[k][1];
      } else {
        dP[L::uv - 3] += d_u;
        dP[L::uv - 2] += d_v;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) dP[L::color - 3 + c] += dT[c];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float db = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        acc[k][3 + c] += bary[k] * dP[c];
        db += r[k][3 + c] * dP[c];
      }
      d_bary[k] += db;
    }
    float d_wp[3], d_dot = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d_braw = (braw[k] >= -4.0f && braw[k] <= 5.0f) ? d_bary[k] : 0.0f;
      d_wp[k] = d_braw / den_s;
      d_dot += d_braw * wp[k];
    }
    const float d_den = den_ok ? -d_dot / (den_s * den_s) : 0.0f;
    float d_w[3], d_e[3], d_we = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_wp[k] += d_den;
      d_w[k] = d_wp[k] / zs[k];
      acc[k][2] += z_ok[k] ? -d_wp[k] * w[k] / (zs[k] * zs[k]) : 0.0f;
      d_we += d_w[k] * e[k];
    }
    const float d_area = area_ok ? -d_we / (area_s * area_s) : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) d_e[k] = d_w[k] / area_s + d_area;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = (k + 1) % 3, q = (k + 2) % 3;
      const float de = d_e[k];
      acc[q][0] += de * (v - py[p]);
      acc[q][1] -= de * (u - px[p]);
      acc[p][0] += de * ((py[q] - py[p]) - (v - py[p]));
      acc[p][1] += de * ((u - px[p]) - (px[q] - px[p]));
    }
  }
}

template <int kKind, bool kMaps>
__global__ void __launch_bounds__(kThreads)
shade_forward_kernel(Args a, float* __restrict__ out) {
  using L = Lay<kKind, kMaps>;
  const int Ho = a.S / a.aa;
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= Ho * Ho) return;
  const int oy = p / Ho, ox = p - oy * Ho;
  const int* fid = a.face_id + (size_t)b * a.S * a.S;
  float sum[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float r[3][L::width], acc[3][L::width], lacc[12];
  int vid[3];
  int cur = -1;
  for (int sy = 0; sy < a.aa; ++sy) {
    const int y = oy * a.aa + sy;
    for (int sx = 0; sx < a.aa; ++sx) {
      const int x = ox * a.aa + sx;
      const int f = __ldg(fid + (size_t)y * a.S + x);
      if ((unsigned)f >= (unsigned)a.F) continue;  // background (-1)
      if (f != cur) {
        load_rows<kKind, kMaps>(a, b, f, vid, r);
        cur = f;
      }
      float s5[5];
      fragment<kKind, kMaps, false>(a, b, f, (float)x + 0.5f, (float)y + 0.5f, r, s5, nullptr, acc, lacc, nullptr);
#pragma unroll
      for (int c = 0; c < 5; ++c) sum[c] += s5[c];
    }
  }
  const float inv = 1.0f / (float)(a.aa * a.aa);
  float* o = out + ((size_t)b * Ho * Ho + p) * 5;
#pragma unroll
  for (int c = 0; c < 5; ++c) o[c] = sum[c] * inv;
}

template <int kKind, bool kMaps>
__device__ __forceinline__ void flush(const Args& a, int b, const int (&vid)[3],
                                      float (&acc)[3][Lay<kKind, kMaps>::width], float* g_table) {
  using L = Lay<kKind, kMaps>;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float* dst = g_table + ((size_t)b * a.V + vid[k]) * L::width;
#pragma unroll
    for (int c = 0; c < L::used; ++c) {
      atomicAdd(dst + c, acc[k][c]);
      acc[k][c] = 0.0f;
    }
  }
}

template <int kKind, bool kMaps>
__global__ void __launch_bounds__(kThreads)
shade_backward_kernel(Args a, const float* __restrict__ grad, float* __restrict__ g_table, float* g_tex,
                      float* g_light) {
  using L = Lay<kKind, kMaps>;
  __shared__ float s_light[12];
  const int Ho = a.S / a.aa;
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (g_light != nullptr) {
    if (threadIdx.x < 12) s_light[threadIdx.x] = 0.0f;
    __syncthreads();
  }
  float lacc[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) lacc[j] = 0.0f;
  if (p < Ho * Ho) {
    const int oy = p / Ho, ox = p - oy * Ho;
    const int* fid = a.face_id + (size_t)b * a.S * a.S;
    const float* gp = grad + ((size_t)b * Ho * Ho + p) * 5;
    const float n = (float)(a.aa * a.aa);
    float g5[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) g5[c] = __ldg(gp + c) / n;
    float r[3][L::width], acc[3][L::width];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int c = 0; c < L::width; ++c) acc[k][c] = 0.0f;
    }
    int vid[3] = {0, 0, 0};
    int cur = -1;
    for (int sy = 0; sy < a.aa; ++sy) {
      const int y = oy * a.aa + sy;
      for (int sx = 0; sx < a.aa; ++sx) {
        const int x = ox * a.aa + sx;
        const int f = __ldg(fid + (size_t)y * a.S + x);
        if ((unsigned)f >= (unsigned)a.F) continue;
        if (f != cur) {
          if (cur >= 0) flush<kKind, kMaps>(a, b, vid, acc, g_table);
          load_rows<kKind, kMaps>(a, b, f, vid, r);
          cur = f;
        }
        fragment<kKind, kMaps, true>(a, b, f, (float)x + 0.5f, (float)y + 0.5f, r, nullptr, g5, acc, lacc, g_tex);
      }
    }
    if (cur >= 0) flush<kKind, kMaps>(a, b, vid, acc, g_table);
  }
  if (g_light != nullptr) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      float x = lacc[j];
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if ((threadIdx.x & 31) == 0) atomicAdd(s_light + j, x);
    }
    __syncthreads();
    if (threadIdx.x < 12) atomicAdd(g_light + 12 * (size_t)b + threadIdx.x, s_light[threadIdx.x]);
  }
}

template <int kKind, bool kMaps>
int launch(bool backward, const Args& a, int B, float* out, const float* grad, float* g_table, float* g_tex,
           float* g_light, cudaStream_t st) {
  if (a.R != Lay<kKind, kMaps>::width) return (int)cudaErrorInvalidValue;
  const int Ho = a.S / a.aa;
  const dim3 grid((unsigned)((Ho * Ho + kThreads - 1) / kThreads), (unsigned)B);
  if (backward) {
    shade_backward_kernel<kKind, kMaps><<<grid, kThreads, 0, st>>>(a, grad, g_table, g_tex, g_light);
  } else {
    shade_forward_kernel<kKind, kMaps><<<grid, kThreads, 0, st>>>(a, out);
  }
  return (int)cudaGetLastError();
}

int dispatch(int kind, int maps, bool backward, const Args& a, int B, float* out, const float* grad,
             float* g_table, float* g_tex, float* g_light, cudaStream_t st) {
  if (B == 0 || a.S == 0) return 0;
  if (a.aa < 1 || a.S % a.aa != 0) return (int)cudaErrorInvalidValue;
  if (kind == 0 && !maps) return launch<0, false>(backward, a, B, out, grad, g_table, g_tex, g_light, st);
  if (kind == 1 && !maps) return launch<1, false>(backward, a, B, out, grad, g_table, g_tex, g_light, st);
  if (kind == 1 && maps) return launch<1, true>(backward, a, B, out, grad, g_table, g_tex, g_light, st);
  if (kind == 2 && !maps) return launch<2, false>(backward, a, B, out, grad, g_table, g_tex, g_light, st);
  if (kind == 2 && maps) return launch<2, true>(backward, a, B, out, grad, g_table, g_tex, g_light, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const int* face_id, const long long* faces, int F, const float* face_uv, const float* table, int V,
               int R, const float* tex, int Ht, int Wt, int C, const float* light, int S, int aa) {
  return Args{face_id, faces, face_uv, table, tex, light, F, V, R, Ht, Wt, C, S, aa};
}

}  // namespace

// Each function makes one launch on `stream`, does not synchronise, and
// returns its cudaError_t (0 on success). kind: 0 vertex colours, 1 a per-face
// atlas, 2 a per-vertex chart; maps: the tangents and the normal and spec maps.

// out (B, S / aa, S / aa, 5).
extern "C" int hifihr_ssaa_shade_forward(int kind, int maps, const int* face_id, const long long* faces, int F,
                                         const float* face_uv, const float* table, int V, int R, const float* tex,
                                         int Ht, int Wt, int C, const float* light, int B, int S, int aa, float* out,
                                         void* stream) {
  const Args a = make_args(face_id, faces, F, face_uv, table, V, R, tex, Ht, Wt, C, light, S, aa);
  return dispatch(kind, maps, false, a, B, out, nullptr, nullptr, nullptr, nullptr,
                  static_cast<cudaStream_t>(stream));
}

// grad (B, S / aa, S / aa, 5); g_table (B, V, R), g_tex (B, Ht, Wt, C) or null,
// g_light (B, 12) or null, each zeroed by the caller and added into.
extern "C" int hifihr_ssaa_shade_backward(int kind, int maps, const int* face_id, const long long* faces, int F,
                                          const float* face_uv, const float* table, int V, int R, const float* tex,
                                          int Ht, int Wt, int C, const float* light, int B, int S, int aa,
                                          const float* grad, float* g_table, float* g_tex, float* g_light,
                                          void* stream) {
  const Args a = make_args(face_id, faces, F, face_uv, table, V, R, tex, Ht, Wt, C, light, S, aa);
  return dispatch(kind, maps, true, a, B, nullptr, grad, g_table, g_tex, g_light,
                  static_cast<cudaStream_t>(stream));
}
