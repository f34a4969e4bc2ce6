// Shading helpers of the port's kernels that repeat PyTorch's elementwise
// arithmetic operation for operation, so that a kernel agrees bit for bit
// with its plain PyTorch version on the card: float32 vectors, torch's
// clamps and divisions, the transcendentals of ops/fmath.py, the
// counter-based streams of ops/rng.py, the Disney BSDF's evaluation
// (ops/bsdf/disney.py::evaluate_bsdf) and the sampling helpers of its
// bsdf_sample (ops/bsdf/common.py). Header-only; every function is inline.
//
// What PyTorch does on the card, and the helpers repeat:
// - every op rounds once (the library is built --fmad=false);
// - a Python float meets a float32 tensor as that float rounded to float32
//   (RFW_F below: a double literal rounded once, as torch rounds the
//   Python float, never a float literal read straight from its decimals);
// - torch.clamp keeps a NaN and otherwise takes fmaxf / fminf;
// - `c / t` for a Python c is t.reciprocal() * c (Tensor.__rtruediv__);
//   `t / c` is t * (1 / c) (the CUDA division by a host scalar);
// - ops/fmath.py's transcendentals run in double and round once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rfw {

#define RFW_F(x) static_cast<float>(x)

constexpr double kPi = 3.141592653589793;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 load3(const float* __restrict__ p, size_t i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* __restrict__ p, size_t i,
                                       V3 a) {
  p[3 * i] = a.x;
  p[3 * i + 1] = a.y;
  p[3 * i + 2] = a.z;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return v3(a.x / s, a.y / s, a.z / s);
}
__device__ __forceinline__ V3 select(bool c, V3 a, V3 b) { return c ? a : b; }

// ops/intersect.py::dot3: (a0 b0 + a1 b1) + a2 b2.
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// torch.clamp(x, min=lo), torch.clamp(x, max=hi), torch.clamp(x, lo, hi).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// `c / x` for a Python float c: x.reciprocal() * c.
__device__ __forceinline__ float rdiv(float c, float x) {
  return (1.0f / x) * c;
}

// torch.remainder(x, m) for floats: fmod, moved to the divisor's sign.
__device__ __forceinline__ float remainder(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.0f && ((m < 0.0f) != (r < 0.0f))) r += m;
  return r;
}

// ops/fmath.py: in double, rounded once.
__device__ __forceinline__ float sin_r(float x) {
  return static_cast<float>(sin(static_cast<double>(x)));
}
__device__ __forceinline__ float cos_r(float x) {
  return static_cast<float>(cos(static_cast<double>(x)));
}
__device__ __forceinline__ float log_r(float x) {
  return static_cast<float>(log(static_cast<double>(x)));
}
__device__ __forceinline__ float exp_r(float x) {
  return static_cast<float>(exp(static_cast<double>(x)));
}

// ops/bsdf/common.py
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + t * (b - a);
}
__device__ __forceinline__ V3 lerp(V3 a, V3 b, float t) {
  return v3(lerp(a.x, b.x, t), lerp(a.y, b.y, t), lerp(a.z, b.z, t));
}
__device__ __forceinline__ V3 safe_normalize(V3 v) {
  const float ls = dot3(v, v);
  return ls > 0.0f ? v / sqrtf(clamp_min(ls, RFW_F(1e-30)))
                   : v3(0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float schlick_fresnel(float u) {
  const float m = clamp(1.0f - u, 0.0f, 1.0f);
  return (m * m) * (m * m) * m;
}
__device__ __forceinline__ float gtr1(float n_dot_h, float a) {
  const float a2 = a * a;
  const float t = 1.0f + (a2 - 1.0f) * n_dot_h * n_dot_h;
  const float lg = log_r(clamp_min(a2, RFW_F(1e-8)));
  const float val = (a2 - 1.0f) / (RFW_F(kPi) * lg * (t != 0.0f ? t : 1.0f));
  return a >= 1.0f ? RFW_F(1.0 / kPi) : val;
}
__device__ __forceinline__ float gtr2(float n_dot_h, float a) {
  const float a2 = a * a;
  const float t = 1.0f + (a2 - 1.0f) * n_dot_h * n_dot_h;
  return a2 / (RFW_F(kPi) * t * t);
}
// smith_ggx given a = alpha_g squared: for a Python alpha_g the square is
// taken in double, for a tensor one in float (smith_ggx below).
__device__ __forceinline__ float smith_ggx_sq(float n_dot_v, float a) {
  const float b = n_dot_v * n_dot_v;
  return rdiv(1.0f, n_dot_v + sqrtf(clamp_min(a + b - a * b, 0.0f)));
}
__device__ __forceinline__ float smith_ggx(float n_dot_v, float alpha_g) {
  return smith_ggx_sq(n_dot_v, alpha_g * alpha_g);
}
// fr: exact dielectric Fresnel, 1 on total internal reflection.
__device__ __forceinline__ float fr(float v_dot_n, float eio) {
  const float sin_theta_t2 = (eio * eio) * (1.0f - v_dot_n * v_dot_n);
  const float l_dot_n = sqrtf(clamp_min(1.0f - sin_theta_t2, 0.0f));
  const float eta = rdiv(1.0f, clamp_min(eio, RFW_F(1e-6)));
  const float denom1 = v_dot_n + eta * l_dot_n;
  const float denom2 = l_dot_n + eta * v_dot_n;
  const float r1 =
      (v_dot_n - eta * l_dot_n) / (denom1 != 0.0f ? denom1 : 1.0f);
  const float r2 =
      (l_dot_n - eta * v_dot_n) / (denom2 != 0.0f ? denom2 : 1.0f);
  return sin_theta_t2 > 1.0f ? 1.0f : 0.5f * (r1 * r1 + r2 * r2);
}

// reflect(d, n) = d - (2 dot(d, n)) n
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return d - n * (2.0f * dot3(d, n));
}
// refract_dir(wi, n, eta): the refracted direction; *ok without total
// internal reflection.
__device__ __forceinline__ V3 refract_dir(V3 wi, V3 n, float eta, bool* ok) {
  const float cos_i = dot3(n, wi);
  const float sin2_i = clamp_min(1.0f - cos_i * cos_i, 0.0f);
  const float sin2_t = eta * eta * sin2_i;
  *ok = sin2_t < 1.0f;
  const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  return (-wi) * eta + n * (eta * cos_i - cos_t);
}
// tangent_to_world(local, t, b, n) = (t l.x + b l.y) + n l.z
__device__ __forceinline__ V3 tangent_to_world(V3 l, V3 t, V3 b, V3 n) {
  return t * l.x + b * l.y + n * l.z;
}
// diffuse_reflection_uniform and diffuse_reflection_cos_weighted: 2 pi r0
// is the float product of r0 and 2 pi rounded to float.
__device__ __forceinline__ V3 diffuse_uniform(float r0, float r1) {
  const float term1 = r0 * RFW_F(2.0 * kPi);
  const float term2 = sqrtf(clamp_min(1.0f - r1 * r1, 0.0f));
  return v3(cos_r(term1) * term2, sin_r(term1) * term2, r1);
}
__device__ __forceinline__ V3 diffuse_cos_weighted(float r0, float r1) {
  const float term1 = r0 * RFW_F(2.0 * kPi);
  const float term2 = sqrtf(clamp_min(1.0f - r1, 0.0f));
  return safe_normalize(v3(cos_r(term1) * term2, sin_r(term1) * term2,
                           sqrtf(clamp_min(r1, 0.0f))));
}
// ops/bsdf/disney.py::_sample_half_vector: a GGX half vector, flipped
// towards wo.
__device__ __forceinline__ V3 sample_half_vector(V3 t, V3 b, V3 n, V3 wo,
                                                 float roughness, float r1,
                                                 float r2) {
  const float cos_h = sqrtf(clamp_min(
      (1.0f - r2) / (1.0f + (roughness * roughness - 1.0f) * r2), 0.0f));
  const float sin_h = sqrtf(clamp_min(1.0f - cos_h * cos_h, 0.0f));
  const float phi = r1 * RFW_F(2.0 * kPi);
  const V3 h = tangent_to_world(v3(sin_h * cos_r(phi), sin_h * sin_r(phi),
                                   cos_h), t, b, n);
  return dot3(h, wo) <= 0.0f ? -h : h;
}

// The Disney parameters evaluate_bsdf reads (anisotropy and sheen are
// not evaluated).
struct Disney {
  V3 color;
  float metallic, subsurface, specular, roughness, specular_tint, clearcoat,
      clearcoat_gloss, transmission, eta;
};

// ops/bsdf/disney.py::bsdf_pdf(sd, n, wo, wi), given its halfway vector
// h = safe_normalize(wi + wo).
__device__ __forceinline__ float disney_pdf(const Disney& sd, V3 n, V3 wo,
                                            V3 wi, V3 h) {
  const float n_dot_l = dot3(n, wi);
  const float brdf_pdf_below = RFW_F(1.0 / (2.0 * kPi)) * sd.subsurface * 0.5f;
  const float f = fr(dot3(n, wo), sd.eta);
  const float cos_theta_half = fabsf(dot3(h, n));
  const float pdf_half = gtr2(cos_theta_half, sd.roughness) * cos_theta_half;
  const float pdf_spec = 0.25f * pdf_half / clamp_min(dot3(wi, h), RFW_F(1e-6));
  const float pdf_diff = fabsf(n_dot_l) * RFW_F(1.0 / kPi)
                         * (1.0f - sd.subsurface);
  const float bsdf_pdf_above = pdf_spec * f;
  const float brdf_pdf_above = lerp(pdf_diff, pdf_spec, 0.5f);
  const bool below = n_dot_l <= 0.0f;
  const float brdf_pdf = below ? brdf_pdf_below : brdf_pdf_above;
  const float bsdf_pdf = below ? 0.0f : bsdf_pdf_above;
  return lerp(brdf_pdf, bsdf_pdf, sd.transmission);
}

// ops/bsdf/disney.py::evaluate_bsdf(sd, n, ., ., wo, wi): the value
// (bsdf_eval on a front face) and its pdf (bsdf_pdf).
__device__ __forceinline__ V3 disney_evaluate(const Disney& sd, V3 n, V3 wo,
                                              V3 wi, float* pdf_out) {
  const float n_dot_l = dot3(n, wi);
  const float n_dot_v = dot3(n, wo);
  const V3 h = safe_normalize(wi + wo);
  const float n_dot_h = dot3(n, h);
  const float l_dot_h = dot3(wi, h);
  const V3 cdlin = sd.color;
  const float cdlum = RFW_F(0.3) * cdlin.x + RFW_F(0.6) * cdlin.y
                      + RFW_F(0.1) * cdlin.z;
  const V3 ctint = cdlum > 0.0f ? cdlin / clamp_min(cdlum, RFW_F(1e-20))
                                : v3(1.0f, 1.0f, 1.0f);
  const V3 one = v3(1.0f, 1.0f, 1.0f);
  const V3 cspec0 = lerp(lerp(one, ctint, sd.specular_tint)
                             * (sd.specular * RFW_F(0.08)),
                         cdlin, sd.metallic);
  const float a = sd.roughness;

  // BSDF side (transmission > 0)
  const float f_v = fr(n_dot_v, sd.eta);
  const float trans = (1.0f - f_v) / clamp_min(fabsf(n_dot_l), RFW_F(1e-7))
                      * (1.0f - sd.metallic) * sd.transmission;
  const V3 bsdf_trans = v3(trans, trans, trans);
  const float ds = gtr2(n_dot_h, a);
  const float fh_exact = fr(l_dot_h, sd.eta);
  const V3 fs_bsdf = lerp(cspec0, one, fh_exact);
  const float gs = smith_ggx(n_dot_v, a) * smith_ggx(n_dot_l, a);
  const V3 bsdf_spec = fs_bsdf * (gs * ds);
  const V3 bsdf_side = select(n_dot_l <= 0.0f, bsdf_trans, bsdf_spec);

  // BRDF side (transmission < 1)
  const V3 s = v3(sqrtf(clamp_min(sd.color.x, 0.0f)),
                  sqrtf(clamp_min(sd.color.y, 0.0f)),
                  sqrtf(clamp_min(sd.color.z, 0.0f)));
  const float fl_abs = schlick_fresnel(fabsf(n_dot_l));
  const float fv = schlick_fresnel(n_dot_v);
  const float fd_ss = (1.0f - 0.5f * fl_abs) * (1.0f - 0.5f * fv);
  V3 brdf_below = s * (RFW_F(1.0 / kPi) * fd_ss * sd.subsurface
                       * (1.0f - sd.metallic));
  if (!(sd.subsurface > 0.0f)) brdf_below = v3(0.0f, 0.0f, 0.0f);
  const float fh = schlick_fresnel(l_dot_h);
  const V3 fs = lerp(cspec0, one, fh);
  const float fl = schlick_fresnel(n_dot_l);
  const float fd90 = 0.5f + 2.0f * l_dot_h * l_dot_h * a;
  const float fd = lerp(1.0f, fd90, fl) * lerp(1.0f, fd90, fv);
  // lerp(0.1, 0.001, g) and lerp(0.04, 1.0, fh) of Python floats: b - a
  // in double, rounded once
  const float dr = gtr1(n_dot_h, RFW_F(0.1)
                                     + sd.clearcoat_gloss * RFW_F(0.001 - 0.1));
  const float fc = RFW_F(0.04) + fh * RFW_F(1.0 - 0.04);
  const float gr = smith_ggx_sq(n_dot_l, RFW_F(0.25 * 0.25))
                   * smith_ggx_sq(n_dot_v, RFW_F(0.25 * 0.25));
  const float cc = sd.clearcoat * gr * fc * dr;
  const V3 brdf_above =
      cdlin * (RFW_F(1.0 / kPi) * fd * (1.0f - sd.metallic)
               * (1.0f - sd.subsurface))
      + fs * (gs * ds) + v3(cc, cc, cc);
  const V3 brdf_side = select(n_dot_l <= 0.0f, brdf_below, brdf_above);

  *pdf_out = disney_pdf(sd, n, wo, wi, h);
  return lerp(brdf_side, bsdf_side, sd.transmission);
}

// ops/rng.py on uint32 words.
__device__ __forceinline__ uint32_t wang_hash(uint32_t s) {
  s = (s ^ 61u) ^ (s >> 16);
  s *= 9u;
  s ^= s >> 4;
  s *= 0x27D4EB2Du;
  return s ^ (s >> 15);
}
// rng.random_float: one xorshift step, then the bits as a float in [0, 1).
__device__ __forceinline__ float random_float(uint32_t* seed) {
  uint32_t s = *seed;
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  *seed = s;
  return __uint2float_rn(s) * RFW_F(2.3283064365387e-10);
}

}  // namespace rfw
