// The BSDF extension of one depth for Hopper (sm_90a), plain C interface:
// for each lane the Disney BSDF sample of the next direction, its pdf and
// value, Russian roulette, the validity test and the next ray's state
// (origin, direction, throughput, last pdf and normal, the specular flag,
// alive), alpha-cut lanes passing straight through their surface.
//
// Built by rfw_tpu_torch/ops/cuda_lib.py with the other kernels
// (--fmad=false, IEEE division and square root) and bound with ctypes. The
// entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError().
//
// Replaces no Pallas kernel: rfw_tpu runs this step at the end of
// rfw_tpu/render/integrator.py's depth stage, which XLA fuses. Its plain
// PyTorch version is ops/extension.py::extend_plain, some 690 eager
// launches a 518,400-lane chunk; the kernel repeats its arithmetic
// operation for operation (shading.cuh says how), so the two agree bit for
// bit:
// - two draws of the lane's stream after the NEE's (r3, r4), and a third
//   for Russian roulette;
// - ops/bsdf/disney.py::bsdf_sample: the transmission side (r3 below the
//   transmission: a GGX reflection where r4 is below the Fresnel term,
//   else the refraction, whose pdf is (1 - F) transmission) or the BRDF
//   side (r4 below 0.5: the uniform subsurface sample below the surface or
//   the cosine-weighted one, else a GGX reflection). The plain version
//   computes every side and selects; the kernel computes the side it
//   selects, which gives the same bits;
// - the value and pdf of ops/bsdf/disney.py::bsdf_eval and bsdf_pdf toward
//   the sample (shading.cuh's disney_evaluate), the absorption
//   exp(-absorption t) on a back face;
// - the new throughput, Russian roulette's survival (the largest channel
//   of the throughput, clamped to [1e-6, 1]) and its kill, the validity
//   test (pdf above 1e-6, the throughput finite and not negative), and the
//   state's selections for alpha-cut lanes.
// The [1, 1, -1] of the subsurface sample is a constant here; the plain
// version makes it a tensor, which waits for the device.
//
// Bound: bytes. A lane reads 8 (seed) + 24 + 36 (material: colour,
// absorption, nine scalars) + 6 x 12 (normals, tangent frame, ray, hit
// point) + 4 (t) + 2 x 12 + 4 + 12 (throughputs, last pdf, last normal) +
// 5 (flags) = 189 B and writes 4 x 12 + 4 + 2 = 54 B: 243 B a lane. Every
// intermediate lives in registers: one thread a lane, no shared memory,
// each per-lane array read and written once, neighbouring lanes on
// neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shading.cuh"

namespace {

using rfw::V3;
using rfw::dot3;
using rfw::v3;

constexpr int kExtendThreads = 128;

// Field for field ops/extension.py's ExtendArgs: the pointers, then the
// ints, then the floats.
struct ExtendArgs {
  const long long* seed;
  const float* color;
  const float* absorption;
  const float* metallic;
  const float* subsurface;
  const float* specular;
  const float* roughness;
  const float* specular_tint;
  const float* clearcoat;
  const float* clearcoat_gloss;
  const float* transmission;
  const float* eta;
  const float* hit_pos;
  const float* i_n;
  const float* n_geom;
  const float* t_vec;
  const float* b_vec;
  const float* direction;
  const float* t;
  const float* throughput;
  const float* throughput_predpdf;
  const float* last_pdf;
  const float* last_n;
  const uint8_t* spec_bounce;
  const uint8_t* alive;
  const uint8_t* alpha_cut;
  const uint8_t* spec_mat;
  const uint8_t* backfacing;
  float* origin_out;
  float* direction_out;
  float* throughput_out;
  float* last_pdf_out;
  float* last_n_out;
  uint8_t* spec_bounce_out;
  uint8_t* alive_out;
  int n, russian_roulette;
  float geometry_epsilon;
};

// torch.amax over the three channels: NaN if any is NaN.
__device__ __forceinline__ float amax3(V3 a) {
  if (isnan(a.x)) return a.x;
  if (isnan(a.y)) return a.y;
  if (isnan(a.z)) return a.z;
  return fmaxf(fmaxf(a.x, a.y), a.z);
}

__global__ void __launch_bounds__(kExtendThreads)
extend_kernel(const ExtendArgs a) {
  using rfw::clamp_min;
  const int lane = blockIdx.x * kExtendThreads + threadIdx.x;
  if (lane >= a.n) return;
  const size_t i = lane;
  uint32_t seed = static_cast<uint32_t>(a.seed[i]);
  const float r3 = rfw::random_float(&seed);
  const float r4 = rfw::random_float(&seed);

  rfw::Disney sd;
  sd.color = rfw::load3(a.color, i);
  sd.metallic = a.metallic[i];
  sd.subsurface = a.subsurface[i];
  sd.specular = a.specular[i];
  sd.roughness = a.roughness[i];
  sd.specular_tint = a.specular_tint[i];
  sd.clearcoat = a.clearcoat[i];
  sd.clearcoat_gloss = a.clearcoat_gloss[i];
  sd.transmission = a.transmission[i];
  sd.eta = a.eta[i];
  const V3 nrm = rfw::load3(a.i_n, i);
  const V3 t_vec = rfw::load3(a.t_vec, i);
  const V3 b_vec = rfw::load3(a.b_vec, i);
  const V3 dir = rfw::load3(a.direction, i);
  const V3 wo = -dir;

  // bsdf_sample: the side r3 and r4 select
  const float f = rfw::fr(dot3(nrm, wo), sd.eta);
  V3 wi;
  bool refracted = false;
  float pdf_refract = 0.0f;
  if (r3 < sd.transmission) {
    if (r4 < f) {
      const float r1_t = r3 / clamp_min(sd.transmission, RFW_F(1e-9));
      const float r2_t = r4 / clamp_min(f, RFW_F(1e-9));
      wi = rfw::reflect(-wo, rfw::sample_half_vector(
                                 t_vec, b_vec, nrm, wo, sd.roughness, r1_t,
                                 r2_t));
    } else {
      bool ok;
      wi = rfw::refract_dir(wo, nrm, sd.eta, &ok);
      refracted = true;
      pdf_refract = ok ? (1.0f - f) * sd.transmission : 0.0f;
    }
  } else {
    const float r1 = (r3 - sd.transmission)
                     / clamp_min(1.0f - sd.transmission, RFW_F(1e-9));
    if (r4 < 0.5f) {
      const float r2d = r4 * 2.0f;
      V3 d;
      if (r2d < sd.subsurface) {
        // the subsurface sample goes below the surface
        const V3 u = rfw::diffuse_uniform(
            r1, r2d / clamp_min(sd.subsurface, RFW_F(1e-9)));
        d = v3(u.x * 1.0f, u.y * 1.0f, u.z * -1.0f);
      } else {
        d = rfw::diffuse_cos_weighted(
            r1, (r2d - sd.subsurface)
                    / clamp_min(1.0f - sd.subsurface, RFW_F(1e-9)));
      }
      wi = rfw::tangent_to_world(d, t_vec, b_vec, nrm);
    } else {
      const float r2s = (r4 - 0.5f) * 2.0f;
      wi = rfw::reflect(-wo, rfw::sample_half_vector(
                                 t_vec, b_vec, nrm, wo, sd.roughness, r1,
                                 r2s));
    }
  }

  // bsdf_eval and bsdf_pdf toward the sample
  float pdf;
  V3 val = rfw::disney_evaluate(sd, nrm, wo, wi, &pdf);
  if (refracted) pdf = pdf_refract;
  const float t_hit = a.t[i];
  const V3 ab = rfw::load3(a.absorption, i);
  if (a.backfacing[i])
    val = val * v3(rfw::exp_r(-ab.x * t_hit), rfw::exp_r(-ab.y * t_hit),
                   rfw::exp_r(-ab.z * t_hit));

  const V3 tp = rfw::load3(a.throughput, i);
  V3 new_tp = tp * val * fabsf(dot3(nrm, wi));
  const bool alpha_cut = a.alpha_cut[i];
  bool alive = a.alive[i];
  if (a.russian_roulette) {
    const float survival =
        rfw::clamp(rfw::clamp_max(amax3(tp), 1.0f), RFW_F(1e-6), 1.0f);
    const float rr = rfw::random_float(&seed);
    alive = alive && ((rr <= survival) || alpha_cut);
    new_tp = new_tp / survival;
  }
  const bool valid = pdf > RFW_F(1e-6) && !isnan(pdf) && new_tp.x >= 0.0f
                     && new_tp.y >= 0.0f && new_tp.z >= 0.0f
                     && !isnan(new_tp.x) && !isnan(new_tp.y)
                     && !isnan(new_tp.z);
  alive = alive && (valid || alpha_cut);

  // alpha-cut lanes pass straight through the surface
  const V3 hit = rfw::load3(a.hit_pos, i);
  const V3 tp_pre = rfw::load3(a.throughput_predpdf, i);
  const float last_pdf = a.last_pdf[i];
  const V3 last_n = rfw::load3(a.last_n, i);
  const bool spec_bounce = a.spec_bounce[i];
  const V3 n_geom = rfw::load3(a.n_geom, i);
  rfw::store3(a.throughput_out, i, alpha_cut ? tp_pre : new_tp);
  a.last_pdf_out[i] = alpha_cut ? last_pdf : pdf;
  a.spec_bounce_out[i] = alpha_cut ? spec_bounce : a.spec_mat[i] != 0;
  rfw::store3(a.last_n_out, i, alpha_cut ? last_n : nrm);
  rfw::store3(a.origin_out, i,
              alpha_cut ? hit + dir * a.geometry_epsilon
                        : hit + n_geom * RFW_F(1e-5));
  rfw::store3(a.direction_out, i, alpha_cut ? dir : wi);
  a.alive_out[i] = alive;
}

}  // namespace

// `block` is an ExtendArgs (a type of this file alone, so not in the
// signature: that would keep the symbol out of the library).
extern "C" int rfw_extend(const void* block, cudaStream_t stream) {
  const ExtendArgs* args = static_cast<const ExtendArgs*>(block);
  if (args->n <= 0) return 0;
  const int grid = (args->n + kExtendThreads - 1) / kExtendThreads;
  extend_kernel<<<grid, kExtendThreads, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}
