// One lane of the BSDF dispatch (bsdf/dispatch.py): the lobes' sample,
// eval and pdf as device functions, for the kernels of bsdf.cu.
//
// Every function repeats the plain PyTorch version's operations in their
// order, as torch's CUDA ops compute them, so that the kernels built with
// --fmad=false equal the torch code to the bit:
//
// - a Python float constant reaches an f32 op rounded to f32 (`F(x)`:
//   the double literal cast, never an f32 literal, which could round the
//   decimal otherwise);
// - `c / t` with a Python float c is torch's `t.reciprocal() * c`, so it is
//   written (1 / t) * c; `t / c` never occurs;
// - `clamp` passes NaN through, as torch's does (fmaxf would drop it);
// - the libm calls are those of torch's ops: sqrtf, powf, acosf, sinf,
//   cosf, floorf, and IEEE division.
//
// The shading frame has the normal as +Y (math/vec.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cmj.cuh"

namespace henjou {
namespace bsdf {

#define HJ_FN __device__ __forceinline__
// a Python float as torch hands it to an f32 op
#define F(x) ((float)(x))

constexpr double kPi = 3.141592653589793;  // math/constants.py PI
constexpr double kInvPi = 1.0 / kPi;
// bsdf/disney.py: clearcoat gloss 1, so alpha 0.001; PI * log(alpha^2)
// computed in f32 as the module does
constexpr double kCcAlpha = 0.1 * (1.0 - 1.0) + 0.001 * 1.0;
constexpr double kCcA2 = kCcAlpha * kCcAlpha;
constexpr float kCcPiLogA2 = -0x1.5b38cp+5f;  // -43.4027099609375
// bsdf/msggx.py `_INF`, "left the microsurface"
constexpr float kInf = F(3.4e38);
constexpr int kMaxScatteringOrder = 5;

// lobe and scene flags of the dispatch (bsdf/dispatch.py)
constexpr long long kHasSpecular = 1, kHasMetal = 2, kHasSheen = 4, kHasClearcoat = 8,
                    kSobol = 16;

struct V3 {
  float x, y, z;
};

// torch.clamp(v, min=lo): NaN stays NaN
HJ_FN float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
HJ_FN float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// math/vec.py
HJ_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HJ_FN V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
HJ_FN V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
HJ_FN V3 normalize(V3 v) {
  const float s = 1.0f / sqrtf(clamp_min(dot(v, v), F(1e-20)));
  return {v.x * s, v.y * s, v.z * s};
}
HJ_FN float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}
HJ_FN V3 reflect(V3 v, V3 n) {
  const float k = 2.0f * dot(v, n);
  return {v.x - k * n.x, v.y - k * n.y, v.z - k * n.z};
}
HJ_FN V3 schlick_fresnel(V3 f0, V3 w, V3 n) {
  const float p = pow5(1.0f - dot(w, n));
  return {(1.0f - f0.x) * p + f0.x, (1.0f - f0.y) * p + f0.y, (1.0f - f0.z) * p + f0.z};
}

// bsdf/microfacet.py
HJ_FN float ggx_d(V3 wm, float alpha) {
  const float a2 = alpha * alpha;
  const float term1 = (wm.x * wm.x + wm.z * wm.z) / a2 + wm.y * wm.y;
  return 1.0f / (F(kPi) * a2 * term1 * term1);
}
HJ_FN float ggx_lambda(V3 v, float alpha) {
  const float y2 = clamp_min(v.y * v.y, F(1e-12));
  const float delta = 1.0f + alpha * alpha * (v.x * v.x + v.z * v.z) / y2;
  return (-1.0f + sqrtf(delta)) * 0.5f;
}
HJ_FN float ggx_g1(V3 v, float alpha) { return 1.0f / (1.0f + ggx_lambda(v, alpha)); }
HJ_FN float ggx_g2_height_correlated(V3 wi, V3 wo, float alpha) {
  return 1.0f / (1.0f + ggx_lambda(wi, alpha) + ggx_lambda(wo, alpha));
}
HJ_FN V3 sample_visible_normal(float xi0, float xi1, V3 wo, float alpha) {
  const V3 swo = normalize({wo.x * alpha, wo.y, wo.z * alpha});
  const float phi = F(2.0 * kPi) * xi0;
  const float z = (1.0f - xi1) * (1.0f + swo.y) - swo.y;
  const float sin_t = sqrtf(clamp(1.0f - z * z, 0.0f, 1.0f));
  const float x = sin_t * cosf(phi);
  const float y = sin_t * sinf(phi);
  const V3 h = {x + swo.x, z + swo.y, y + swo.z};
  return normalize({h.x * alpha, h.y, h.z * alpha});
}
HJ_FN float vndf_pdf(V3 wm, V3 wo, float alpha) {
  return 0.25f * ggx_d(wm, alpha) * ggx_g1(wo, alpha) / clamp_min(fabsf(wo.y), F(1e-12));
}

// The lane's sampler state: each draw takes the next dimension counter
// (sampling/cmj.py `cmj_1d`, `cmj_2d`).
struct Sampler {
  uint32_t n_spp, image_idx, depth, scramble;
  bool sobol;
  HJ_FN void draw_2d(float& x, float& y) {
    cmj::draw_2d(n_spp, image_idx, depth, scramble, sobol, x, y);
    depth += 1u;
  }
  HJ_FN float draw_1d() {
    float x, y;
    draw_2d(x, y);
    return x;
  }
};

// A hit's material as the dispatch reads it.
struct Material {
  V3 basecolor;
  float roughness, metallic, sheen, clearcoat, ior;
  bool thinfilm, specular;
};

// The thin-film LUT, [h, w, 3] f32 row-major; tex null when the scene has
// no thin-film material.
struct Lut {
  const float* tex;
  long long h, w;
};

struct Sample {
  V3 bsdf, wi;
  float pdf;
};

// torch.remainder of int64 by a positive int: the sign of the divisor
HJ_FN long long floor_mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// texture/sampler.py `sample_bilinear_wrap` at (u, v)
HJ_FN V3 sample_lut(const Lut& lut, float u, float v) {
  const float x = u * (float)lut.w - 0.5f;
  const float y = v * (float)lut.h - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const long long x0i = (long long)x0f;
  const long long y0i = (long long)y0f;
  const long long x1 = floor_mod(x0i + 1, lut.w);
  const long long y1 = floor_mod(y0i + 1, lut.h);
  const long long x0 = floor_mod(x0i, lut.w);
  const long long y0 = floor_mod(y0i, lut.h);
  const float* t00 = lut.tex + (y0 * lut.w + x0) * 3;
  const float* t10 = lut.tex + (y0 * lut.w + x1) * 3;
  const float* t01 = lut.tex + (y1 * lut.w + x0) * 3;
  const float* t11 = lut.tex + (y1 * lut.w + x1) * 3;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = t00[c] * (1.0f - fx) + t10[c] * fx;
    const float bot = t01[c] * (1.0f - fx) + t11[c] * fx;
    out[c] = top * (1.0f - fy) + bot * fy;
  }
  return {out[0], out[1], out[2]};
}

// bsdf/disney.py. The Disney alpha: clamp(roughness^2, 0.01, 1).
HJ_FN float disney_alpha(float roughness) {
  return clamp(roughness * roughness, F(0.01), 1.0f);
}

HJ_FN float f_t_schlick(float wn, float f90) {
  const float delta = clamp_min(1.0f - wn, 0.0f);
  return 1.0f + (f90 - 1.0f) * pow5(delta);
}

HJ_FN float clearcoat_d(V3 wm) {
  const float t = 1.0f + F(kCcA2 - 1.0) * (wm.y * wm.y);
  return (1.0f / (kCcPiLogA2 * t)) * F(kCcA2 - 1.0);
}

HJ_FN float clearcoat_lambda(V3 w) {  // alpha 0.25: alpha * alpha is 0.0625
  const float y2 = clamp_min(w.y * w.y, F(1e-12));
  const float term1 = 1.0f + F(0.0625) * (w.x * w.x + w.z * w.z) / y2;
  return 0.5f * (-1.0f + sqrtf(term1));
}

HJ_FN V3 disney_eval(const Material& m, float alpha, V3 wo, V3 wi, const Lut& lut,
                     bool has_sheen, bool has_clearcoat) {
  const V3 wm = normalize(add(wo, wi));
  const float dot_wi_n = fabsf(wi.y);
  const float dot_wo_n = fabsf(wo.y);
  const float cosine_d = fabsf(dot(wi, wm));
  const float f_d90 = 2.0f * alpha * cosine_d * cosine_d + 0.5f;
  const float f_tsi = f_t_schlick(dot_wi_n, f_d90);
  const float f_tso = f_t_schlick(dot_wo_n, f_d90);
  const float k_diffuse = f_tsi * f_tso * F(kInvPi);
  const float deltacos = 1.0f / clamp_min(dot_wi_n + dot_wo_n, F(1e-6)) - 0.5f;
  const float k_sub = F(kInvPi * 1.25) * (f_tsi * f_tso * deltacos + 0.5f);
  const V3 bc = m.basecolor;
  // F0 = lerp(0.08, basecolor, metallic), or the thin-film LUT
  const float om = 1.0f - m.metallic;
  V3 f0 = {F(0.08) * om + bc.x * m.metallic, F(0.08) * om + bc.y * m.metallic,
           F(0.08) * om + bc.z * m.metallic};
  if (lut.tex != nullptr && m.thinfilm) f0 = sample_lut(lut, bc.x, fabsf(dot(wi, wm)));
  const float d = ggx_d(wm, alpha);
  const float g2 = ggx_g2_height_correlated(wi, wo, alpha);
  const V3 f = schlick_fresnel(f0, wo, wm);
  const float k_spec = 0.25f * (d * g2 / clamp_min(dot_wo_n * dot_wi_n, F(1e-9)));
  const float fd[3] = {bc.x * k_diffuse, bc.y * k_diffuse, bc.z * k_diffuse};
  const float fs[3] = {bc.x * k_sub, bc.y * k_sub, bc.z * k_sub};
  const float fspec[3] = {k_spec * f.x, k_spec * f.y, k_spec * f.z};
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // lerp(f_diffuse, f_subsurface, subsurface = 0)
    const float blend = fd[c] * (1.0f - 0.0f) + fs[c] * 0.0f;
    out[c] = blend * om + fspec[c];
  }
  if (has_sheen) {
    const float delta = clamp_min(1.0f - cosine_d, 0.0f);
    const float f_sheen = m.sheen * pow5(delta) * 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = out[c] + f_sheen * om;
  }
  if (has_clearcoat) {
    const float ccd = clearcoat_d(wm);
    const float ccg = 1.0f / (1.0f + clearcoat_lambda(wi) + clearcoat_lambda(wo));
    const float ccf = (1.0f - F(0.04)) * pow5(1.0f - dot(wo, wm)) + F(0.04);
    const float k_cc = 0.25f * (ccd * ccg / clamp_min(dot_wo_n * dot_wi_n, F(1e-9)));
    const float f_cc = k_cc * ccf * 0.25f;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = out[c] + f_cc * m.clearcoat;
  }
  return {out[0], out[1], out[2]};
}

// `_lobe_weights` normalised: diffuse 1 - metallic, specular 0.5, clearcoat 0
HJ_FN void lobe_weights(float metallic, float& dw, float& sw) {
  const float d = 1.0f - metallic;
  const float total = d + 0.5f + 0.0f;
  dw = d / total;
  sw = 0.5f / total;
}

HJ_FN float disney_pdf(float metallic, float alpha, V3 wo, V3 wi) {
  float dw, sw;
  lobe_weights(metallic, dw, sw);
  const V3 wm = normalize(add(wo, wi));
  return dw * (fabsf(wi.y) * F(kInvPi)) + sw * vndf_pdf(wm, wo, alpha);
}

// `disney_sample`: one 1D and one 2D draw; the diffuse or the specular
// direction as the 1D draw picks, then eval and the mixture pdf.
HJ_FN Sample disney_sample(const Material& m, V3 wo, Sampler& s, const Lut& lut,
                           bool has_sheen, bool has_clearcoat) {
  const float alpha = disney_alpha(m.roughness);
  float dw, sw;
  lobe_weights(m.metallic, dw, sw);
  const float select_p = s.draw_1d();
  float xi0, xi1;
  s.draw_2d(xi0, xi1);
  V3 wi;
  if (select_p < dw) {  // `_sample_diffuse`
    const float theta = 0.5f * acosf(clamp(1.0f - 2.0f * xi0, -1.0f, 1.0f));
    const float phi = F(2.0 * kPi) * xi1;
    const float ct = cosf(theta);
    const float st = sinf(theta);
    wi = {cosf(phi) * st, ct, sinf(phi) * st};
  } else {
    wi = reflect(neg(wo), sample_visible_normal(xi0, xi1, wo, alpha));
  }
  const V3 wm = normalize(add(wo, wi));
  Sample out;
  out.wi = wi;
  if (wi.y < 0.0f) {
    out.bsdf = {0.0f, 0.0f, 0.0f};
    out.pdf = 1.0f;
  } else {
    out.pdf = dw * (fabsf(wi.y) * F(kInvPi)) + sw * vndf_pdf(wm, wo, alpha);
    out.bsdf = disney_eval(m, alpha, wo, wi, lut, has_sheen, has_clearcoat);
  }
  return out;
}

// bsdf/msggx.py: the microsurface walk with uniform heights
HJ_FN float c1(float h) { return clamp(0.5f * (h + 1.0f), 0.0f, 1.0f); }
HJ_FN float inv_c1(float u) { return clamp(2.0f * u - 1.0f, -1.0f, 1.0f); }

HJ_FN float lambda_signed(V3 v, float alpha) {
  const float y = v.y;
  const float y2 = clamp_min(y * y, F(1e-12));
  const float delta = 1.0f + alpha * alpha * (v.x * v.x + v.z * v.z) / y2;
  const float sign = y > 0.0f ? 1.0f : -1.0f;
  float lam = (-1.0f + sign * sqrtf(delta)) * 0.5f;
  if (y > F(0.9999)) lam = 0.0f;
  if (y < F(-0.9999)) lam = -1.0f;
  return lam;
}

HJ_FN float g1_height(V3 w, float h0, float alpha) {
  const float c = c1(h0);
  const float lam = lambda_signed(w, alpha);
  float val = powf(clamp_min(c, F(1e-20)), lam);
  if (w.y > F(0.9999)) val = 1.0f;
  if (w.y <= 0.0f) val = 0.0f;
  return val;
}

// the next height, or kInf when the ray leaves the microsurface
HJ_FN float sample_height(V3 wr, float hr, float u, float alpha) {
  const float y = wr.y;
  const float lam = lambda_signed(wr, alpha);
  const float g1 = g1_height(wr, hr, alpha);
  float h;
  if (y > F(0.9999)) {  // straight up: leaves
    h = kInf;
  } else if (y < F(-0.9999)) {  // straight down
    h = inv_c1(u * c1(hr));
  } else if (fabsf(y) < F(1e-4)) {  // horizontal
    h = hr;
  } else if (u > 1.0f - g1) {
    h = kInf;
  } else {
    const float pow_term = powf(clamp_min(1.0f - u, F(1e-20)),
                                1.0f / (fabsf(lam) > F(1e-12) ? lam : F(1e-12)));
    h = inv_c1(c1(hr) / clamp_min(pow_term, F(1e-20)));
  }
  return h;
}

// `msggx_sample`: at most kMaxScatteringOrder + 1 heights; each step takes
// a 1D draw, and a 2D draw when the ray stays inside. A walk that exceeds
// the order or NaNs ends with bsdf 0, pdf 1 and wi (0, 0, 1).
HJ_FN Sample msggx_sample(V3 f0, float roughness, V3 wo, Sampler& s) {
  const float alpha = clamp(roughness * roughness, F(1e-4), 1.0f);
  V3 wr = neg(wo);
  float hr = F(1.998);
  V3 weight = {1.0f, 1.0f, 1.0f};
  bool walking = true, exceeded = false;
  int order = 0;
  for (int step = 0; step < kMaxScatteringOrder + 1 && walking; ++step) {
    const float u = s.draw_1d();
    const float h_new = sample_height(wr, hr, u, alpha);
    bool continues = !(h_new >= kInf);
    if (continues) {
      order += 1;
      if (order > kMaxScatteringOrder) {
        exceeded = true;
        continues = false;
      }
    }
    if (continues) {  // the phase function's bounce
      float xi0, xi1;
      s.draw_2d(xi0, xi1);
      const V3 v = neg(wr);
      const V3 wm = sample_visible_normal(xi0, xi1, v, alpha);
      const float d = dot(v, wm);
      const V3 w_out = {-v.x + 2.0f * wm.x * d, -v.y + 2.0f * wm.y * d,
                        -v.z + 2.0f * wm.z * d};
      if (isnan(h_new) || isnan(w_out.z)) {
        exceeded = true;
        continues = false;
      } else {
        const V3 w1 = schlick_fresnel(f0, v, wm);
        wr = w_out;
        weight = {weight.x * w1.x, weight.y * w1.y, weight.z * w1.z};
        hr = h_new;
      }
    }
    walking = continues;
  }
  Sample out;
  const bool bad = exceeded || walking || wr.y < 0.0f;
  out.wi = exceeded ? V3{0.0f, 0.0f, 1.0f} : wr;
  out.bsdf = bad ? V3{0.0f, 0.0f, 0.0f} : weight;
  out.pdf = bad ? 1.0f : clamp_min(fabsf(out.wi.y), F(1e-12));
  return out;
}

// bsdf/glass.py `meta_glass_sample` with rho 1: Fresnel picks reflect or
// refract (total internal reflection reflects); the refracted ray is
// mirrored across the inverted normal.
HJ_FN Sample meta_glass_sample(float ior, V3 wo, Sampler& s) {
  const bool leaving = wo.y < 0.0f;
  const float ior_o = leaving ? ior : 1.0f;
  const float ior_i = leaving ? 1.0f : ior;
  const float sign = leaving ? -1.0f : 1.0f;
  const V3 lwo = {wo.x * 1.0f, wo.y * sign, wo.z * 1.0f};
  const V3 n = {0.0f, 1.0f, 0.0f};
  float r0 = (ior_o - ior_i) / (ior_o + ior_i);  // schlick_fresnel_ior
  r0 = r0 * r0;
  const float fr = r0 + (1.0f - r0) * pow5(1.0f - dot(lwo, n));
  const float p = s.draw_1d();
  const V3 refl = reflect(neg(lwo), n);
  // refract(lwo, n, ior_o, ior_i)
  const float eta = ior_o / ior_i;
  const float dn = dot(lwo, n);
  const V3 t_h = {-eta * (lwo.x - dn * n.x), -eta * (lwo.y - dn * n.y),
                  -eta * (lwo.z - dn * n.z)};
  const float sin2 = dot(t_h, t_h);
  const bool ok = sin2 <= 1.0f;
  const float t_p = -sqrtf(clamp_min(1.0f - sin2, 0.0f));
  const V3 trans = {-(t_h.x + t_p * n.x), t_h.y + t_p * n.y, -(t_h.z + t_p * n.z)};
  const V3 lwi = (p < fr || !ok) ? refl : trans;
  const float b = 1.0f / clamp_min(fabsf(lwi.y), F(1e-12));
  Sample out;
  out.bsdf = {b, b, b};
  out.wi = {lwi.x * 1.0f, lwi.y * sign, lwi.z * 1.0f};
  out.pdf = 1.0f;
  return out;
}

// bsdf/dispatch.py `bsdf_sample`: meta-glass, else the walk, else Disney
HJ_FN Sample bsdf_sample(const Material& m, V3 wo, Sampler& s, const Lut& lut,
                         long long flags) {
  if ((flags & kHasSpecular) && m.specular) return meta_glass_sample(m.ior, wo, s);
  if ((flags & kHasMetal) && m.metallic > 0.5f) return msggx_sample(m.basecolor, m.roughness, wo, s);
  return disney_sample(m, wo, s, lut, flags & kHasSheen, flags & kHasClearcoat);
}

// `bsdf_eval`: glass lanes are delta (0), every other lane Disney
HJ_FN V3 bsdf_eval(const Material& m, V3 wo, V3 wi, const Lut& lut, long long flags) {
  if (m.specular) return {0.0f, 0.0f, 0.0f};
  return disney_eval(m, disney_alpha(m.roughness), wo, wi, lut, flags & kHasSheen,
                     flags & kHasClearcoat);
}

// `bsdf_pdf`: glass lanes 0, every other lane the Disney mixture
HJ_FN float bsdf_pdf(float roughness, float metallic, bool specular, V3 wo, V3 wi) {
  if (specular) return 0.0f;
  return disney_pdf(metallic, disney_alpha(roughness), wo, wi);
}

#undef F
#undef HJ_FN

}  // namespace bsdf
}  // namespace henjou
