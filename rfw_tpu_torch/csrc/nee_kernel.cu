// The next-event estimation of one depth for Hopper (sm_90a), plain C
// interface: for each lane a light sample and, where the envmap is
// importance-sampled, an envmap sample, each weighted by MIS against the
// Disney BSDF, and the shadow rays that test them, written where the one
// occlusion launch of the depth reads them. A second kernel adds the
// contributions whose rays were not occluded.
//
// Built by rfw_tpu_torch/ops/cuda_lib.py with the other kernels
// (--fmad=false, IEEE division and square root) and bound with ctypes.
// The entry points launch on the given stream, allocate nothing and
// return cudaGetLastError().
//
// Replaces no Pallas kernel: rfw_tpu runs this step as part of
// rfw_tpu/render/integrator.py's depth stage, which XLA fuses. Its plain
// PyTorch version is ops/nee.py::nee_plain, some 1,500 eager launches a
// 518,400-lane chunk; the kernel repeats its arithmetic operation for
// operation (shading.cuh says how), so the two agree bit for bit:
// - the lane's stream (ops/nee.py::lane_seed) and two draws, or the
//   blue-noise pair of this depth from the per-pixel shift rows, the
//   hashed pair past blue_noise_spp_cutoff;
// - random_barycentrics' 16 base-4 digit steps;
// - the light pick: under importance sampling the potentials of every
//   light slot and their prefix sums, left to right; else the uniform
//   pick over the live lights. Then the picked slot's point, pdf and
//   radiance (area, point, spot or directional; none without lights);
// - the Disney evaluation toward the light, the MIS denominator (no BSDF
//   term for delta lights), the NaN scrub and the firefly clamp;
// - the envmap sample where the depth takes one: the lane's image tile's
//   stream (interleaved sampling; the plain version's tile table holds
//   the same value for every lane of a tile) or a third draw of the
//   lane's stream, an inverse-CDF search, the second Disney evaluation;
// - the shadow rays: origin hit_pos + n_geom 1e-5, the light ray's length
//   less twice the geometry epsilon, the envmap ray's 1e30, 0 where no
//   ray is shot; the rows [0, n) light rays, [n, 2n) envmap rays.
// The block counts the rays shot and the lanes scrubbed and adds them to
// two device counters, so nothing is read back.
//
// Bound: bytes. A lane reads 4 (pid) + 5 x 12 (hit point, normals, ray,
// throughput) + 3 (flags) + 12 + 9 x 4 (material) = 115 B and writes its
// seed, 8 B, and 12 + 12 + 4 + 12 + 1 = 41 B a shadow ray: 164 B a lane,
// 205 B with the envmap's ray. The blue-noise stack (1 MB), the light
// slots and the envmap's tables stay in L2. Every intermediate lives in
// registers: one thread a lane, no shared memory, coalesced loads of the
// per-lane arrays.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shading.cuh"

namespace {

using rfw::V3;
using rfw::dot3;
using rfw::v3;

constexpr int kNeeThreads = 128;

// Field for field ops/nee.py's NeeArgs: the pointers, then the ints, then
// the floats.
struct NeeArgs {
  const int* pid;
  const float* hit_pos;
  const float* i_n;
  const float* n_geom;
  const float* direction;
  const float* throughput;
  const uint8_t* alive;
  const uint8_t* spec_mat;
  const uint8_t* alpha_cut;
  const float* color;
  const float* metallic;
  const float* subsurface;
  const float* specular;
  const float* roughness;
  const float* specular_tint;
  const float* clearcoat;
  const float* clearcoat_gloss;
  const float* transmission;
  const float* eta;
  const float* area_v0;
  const float* area_v1;
  const float* area_v2;
  const float* area_normal;
  const float* area_radiance;
  const float* area_area;
  const float* area_energy;
  const float* point_position;
  const float* point_radiance;
  const float* point_energy;
  const float* spot_position;
  const float* spot_direction;
  const float* spot_radiance;
  const float* spot_cos_inner;
  const float* spot_cos_outer;
  const float* spot_energy;
  const float* dir_direction;
  const float* dir_radiance;
  const float* dir_energy;
  const int* light_counts;
  const float* blue_noise;
  const float* flat_cdf;
  const float* sky_pdf;
  const float* sky_pixels;
  long long* seed_out;
  float* origin_out;
  float* direction_out;
  float* dist_out;
  float* contrib_out;
  uint8_t* want_out;
  unsigned long long* counts_out;
  int n, width, n_area, n_point, n_spot, n_dir, importance;
  int bn_size, bn_dims, bn_index0, bn_index1, bn_ox0, bn_oy0, bn_ox1, bn_oy1;
  int hashed, key, env_mode, tile, tiles_x, sky_w, sky_h;
  float bn_add0, bn_add1, clamp, shadow_eps;
};

// rng.wang_hash(rng.path_seed(id, sample, depth) ^ salt); `key` holds the
// sample's and depth's terms.
__device__ __forceinline__ uint32_t lane_stream(uint32_t id, uint32_t key,
                                                uint32_t salt) {
  return rfw::wang_hash(rfw::wang_hash(id * 16789u + key) ^ salt);
}

// light_sampling.random_barycentrics
__device__ V3 random_barycentrics(float r0) {
  long long u64 = static_cast<long long>(r0 * 4294967296.0f);
  if (u64 > 0xFFFFFFFFLL) u64 = 0xFFFFFFFFLL;
  const uint32_t uf = static_cast<uint32_t>(u64);
  float ax = 1.0f, ay = 0.0f, bx = 0.0f, by = 1.0f, cx = 0.0f, cy = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t d = (uf >> (2 * (15 - i))) & 3u;
    float anx, any, bnx, bny, cnx, cny;
    if (d == 0) {
      anx = (bx + cx) * 0.5f; any = (by + cy) * 0.5f;
      bnx = (ax + cx) * 0.5f; bny = (ay + cy) * 0.5f;
      cnx = (ax + bx) * 0.5f; cny = (ay + by) * 0.5f;
    } else if (d == 1) {
      anx = ax; any = ay;
      bnx = (ax + bx) * 0.5f; bny = (ay + by) * 0.5f;
      cnx = (ax + cx) * 0.5f; cny = (ay + cy) * 0.5f;
    } else if (d == 2) {
      anx = (bx + ax) * 0.5f; any = (by + ay) * 0.5f;
      bnx = bx; bny = by;
      cnx = (bx + cx) * 0.5f; cny = (by + cy) * 0.5f;
    } else {
      anx = (cx + ax) * 0.5f; any = (cy + ay) * 0.5f;
      bnx = (cx + bx) * 0.5f; bny = (cy + by) * 0.5f;
      cnx = cx; cny = cy;
    }
    ax = anx; ay = any; bx = bnx; by = bny; cx = cnx; cy = cny;
  }
  const float rx = (ax + bx + cx) * RFW_F(1.0 / 3.0);
  const float ry = (ay + by + cy) * RFW_F(1.0 / 3.0);
  return v3(rx, ry, 1.0f - rx - ry);
}

// 1 / max(|l|^2, 1e-12) (light_sampling._att)
__device__ __forceinline__ float att(V3 l) {
  return rfw::rdiv(1.0f, rfw::clamp_min(dot3(l, l), RFW_F(1e-12)));
}

// light_sampling.all_potentials' column j: slot j of area | point | spot |
// directional, seen from point p with normal nrm.
__device__ float potential(const NeeArgs& a, int j, V3 bary, V3 p, V3 nrm) {
  using rfw::clamp_min;
  if (j < a.n_area) {
    const V3 q = rfw::load3(a.area_v0, j) * bary.x
                 + rfw::load3(a.area_v1, j) * bary.y
                 + rfw::load3(a.area_v2, j) * bary.z;
    const V3 l = q - p;
    const float at = att(l);
    const V3 ld = rfw::safe_normalize(l);
    const float ln = clamp_min(-dot3(rfw::load3(a.area_normal, j), ld), 0.0f);
    const float nl = clamp_min(dot3(nrm, ld), 0.0f);
    return a.area_energy[j] * ln * nl * at;
  }
  j -= a.n_area;
  if (j < a.n_point) {
    const V3 l = rfw::load3(a.point_position, j) - p;
    const float nl = clamp_min(dot3(nrm, l), 0.0f);
    return a.point_energy[j] * nl * att(l);
  }
  j -= a.n_point;
  if (j < a.n_spot) {
    const V3 l = rfw::load3(a.spot_position, j) - p;
    const float at = att(l);
    const V3 ld = rfw::safe_normalize(l);
    const float den = a.spot_cos_inner[j] - a.spot_cos_outer[j];
    const float d =
        (clamp_min(-dot3(ld, rfw::load3(a.spot_direction, j)), 0.0f)
         - a.spot_cos_outer[j]) / (den != 0.0f ? den : 1.0f);
    const float nl = clamp_min(dot3(nrm, ld), 0.0f);
    return a.spot_energy[j] * rfw::clamp(d, 0.0f, 1.0f) * nl * at;
  }
  j -= a.n_spot;
  const float ln =
      clamp_min(-dot3(rfw::load3(a.dir_direction, j), nrm), 0.0f);
  return a.dir_energy[j] * ln;
}

struct LightSample {
  V3 position, radiance;
  float pick_prob, light_pdf;
  bool is_delta;
};

// light_sampling.random_point_on_light for one lane.
__device__ LightSample point_on_light(const NeeArgs& a, float r0, float r1,
                                      V3 p, V3 nrm) {
  using rfw::clamp_min;
  const V3 bary = random_barycentrics(r0);
  const int n_lights = a.n_area + a.n_point + a.n_spot + a.n_dir;
  long long idx;
  float pick_prob;
  bool no_light;
  if (a.importance) {
    float s = 0.0f;
    for (int j = 0; j < n_lights; ++j) {
      const float pot = potential(a, j, bary, p, nrm);
      s = j == 0 ? pot : s + pot;
    }
    const float thr = r1 * s;
    float cdf = 0.0f;
    int below = 0;
    for (int j = 0; j < n_lights; ++j) {
      const float pot = potential(a, j, bary, p, nrm);
      cdf = j == 0 ? pot : cdf + pot;
      below += cdf < thr;
    }
    idx = min(below, n_lights - 1);
    pick_prob = potential(a, static_cast<int>(idx), bary, p, nrm)
                / clamp_min(s, RFW_F(1e-30));
    no_light = s <= 0.0f;
  } else {
    const long long c0 = a.light_counts[0], c1 = a.light_counts[1],
                    c2 = a.light_counts[2], c3 = a.light_counts[3];
    const float live_total = static_cast<float>(c0 + c1 + c2 + c3);
    long long u = static_cast<long long>(r0 * live_total);
    u = min(max(u, 0LL), max(static_cast<long long>(live_total) - 1, 0LL));
    if (u < c0)
      idx = u;
    else if (u < c0 + c1)
      idx = a.n_area + (u - c0);
    else if (u < c0 + c1 + c2)
      idx = a.n_area + a.n_point + (u - c0 - c1);
    else
      idx = a.n_area + a.n_point + a.n_spot + (u - c0 - c1 - c2);
    pick_prob = live_total > 0.0f
                    ? rfw::rdiv(1.0f, clamp_min(live_total, 1.0f)) * 1.0f
                    : 0.0f;
    no_light = live_total <= 0.0f;
  }

  LightSample ls;
  float pdf;
  ls.is_delta = !(idx < a.n_area);
  if (idx < a.n_area) {
    const int i = static_cast<int>(max(idx, 0LL));
    const V3 q = rfw::load3(a.area_v0, i) * bary.x
                 + rfw::load3(a.area_v1, i) * bary.y
                 + rfw::load3(a.area_v2, i) * bary.z;
    const V3 l = p - q;
    const float sq = dot3(l, l);
    const V3 ld = rfw::safe_normalize(l);
    const float ln = dot3(ld, rfw::load3(a.area_normal, i));
    const float reci = sq / clamp_min(a.area_area[i] * ln, RFW_F(1e-30));
    pdf = (ln > 0.0f && dot3(ld, nrm) < 0.0f) ? reci : 0.0f;
    ls.position = q;
    ls.radiance = rfw::load3(a.area_radiance, i);
  } else if (idx < a.n_area + a.n_point) {
    const int i = static_cast<int>(idx - a.n_area);
    const V3 q = rfw::load3(a.point_position, i);
    const V3 l = p - q;
    pdf = dot3(l, nrm) < 0.0f ? dot3(l, l) : 0.0f;
    ls.position = q;
    ls.radiance = rfw::load3(a.point_radiance, i);
  } else if (idx < a.n_area + a.n_point + a.n_spot) {
    const int i = static_cast<int>(idx - a.n_area - a.n_point);
    const V3 q = rfw::load3(a.spot_position, i);
    const V3 l = p - q;
    const float sq = dot3(l, l);
    const V3 ld = rfw::safe_normalize(l);
    const float den = a.spot_cos_inner[i] - a.spot_cos_outer[i];
    const float fall =
        (clamp_min(dot3(ld, rfw::load3(a.spot_direction, i)), 0.0f)
         - a.spot_cos_outer[i]) / (den != 0.0f ? den : 1.0f);
    const float ln = rfw::clamp_max(fall, 1.0f);
    pdf = (ln > 0.0f && dot3(ld, nrm) < 0.0f)
              ? sq / clamp_min(ln, RFW_F(1e-6)) : 0.0f;
    ls.position = q;
    ls.radiance = rfw::load3(a.spot_radiance, i);
  } else {
    const int i = static_cast<int>(
        min(idx - a.n_area - a.n_point - a.n_spot,
            static_cast<long long>(a.n_dir - 1)));
    const V3 d = rfw::load3(a.dir_direction, i);
    pdf = dot3(d, nrm) < 0.0f ? 1.0f : 0.0f;
    ls.position = p - d * RFW_F(1000.0);
    ls.radiance = rfw::load3(a.dir_radiance, i);
  }
  ls.light_pdf = no_light ? 0.0f : pdf;
  ls.pick_prob = no_light ? 0.0f : pick_prob;
  if (no_light) ls.position = p + v3(1.0f, 1.0f, 1.0f);
  return ls;
}

// integrator.sample_envmap for one uniform r: direction, pdf, radiance.
__device__ V3 sample_envmap(const NeeArgs& a, float r, float* pdf, V3* rad) {
  // torch.searchsorted (left), then the clamp to the last texel
  long long lo = 0, hi = static_cast<long long>(a.sky_w) * a.sky_h;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (!(a.flat_cdf[mid] >= r))
      lo = mid + 1;
    else
      hi = mid;
  }
  const long long idx = min(lo, static_cast<long long>(a.sky_w) * a.sky_h - 1);
  const long long y = idx / a.sky_w, x = idx % a.sky_w;
  // `t / w` by a host scalar multiplies by its float reciprocal
  const float u = (static_cast<float>(x) + 0.5f)
                  * (1.0f / static_cast<float>(a.sky_w));
  const float v = (static_cast<float>(y) + 0.5f)
                  * (1.0f / static_cast<float>(a.sky_h));
  const float phi = (2.0f * u - 1.0f) * RFW_F(rfw::kPi);
  const float theta = v * RFW_F(rfw::kPi);
  const float sin_t = rfw::sin_r(theta);
  *pdf = a.sky_pdf[idx];
  *rad = rfw::load3(a.sky_pixels, idx);
  return v3(sin_t * rfw::sin_r(phi), rfw::cos_r(theta),
            -sin_t * rfw::cos_r(phi));
}

// bsdf/common.clamp_intensity after the NaN scrub: scale to the clamp.
__device__ __forceinline__ V3 scrub_clamp(V3 c, float clamp_v, bool* had_nan) {
  *had_nan = isnan(c.x) || isnan(c.y) || isnan(c.z);
  c = v3(isnan(c.x) ? 0.0f : c.x, isnan(c.y) ? 0.0f : c.y,
         isnan(c.z) ? 0.0f : c.z);
  const float m = fmaxf(fmaxf(c.x, c.y), c.z);
  const float scale = m > clamp_v
                          ? rfw::rdiv(clamp_v, rfw::clamp_min(m, RFW_F(1e-20)))
                          : 1.0f;
  return c * scale;
}

__global__ void __launch_bounds__(kNeeThreads)
nee_kernel(const NeeArgs a) {
  const int lane = blockIdx.x * kNeeThreads + threadIdx.x;
  const bool live = lane < a.n;
  int shot = 0, scrubbed = 0;
  if (live) {
    const size_t i = lane;
    const uint32_t pid = static_cast<uint32_t>(a.pid[i]);
    const int px = static_cast<int>(pid % static_cast<uint32_t>(a.width));
    const int py = static_cast<int>(pid / static_cast<uint32_t>(a.width));
    uint32_t seed = lane_stream(pid, static_cast<uint32_t>(a.key), 0x9E3779B9u);

    float r0, r1;
    if (a.blue_noise != nullptr) {
      const int s = a.bn_size;
      const size_t row0 = static_cast<size_t>((py + a.bn_oy0) % s) * s
                          + (px + a.bn_ox0) % s;
      const size_t row1 = static_cast<size_t>((py + a.bn_oy1) % s) * s
                          + (px + a.bn_ox1) % s;
      const float s0 = a.blue_noise[row0 * a.bn_dims + a.bn_index0];
      const float s1 = a.blue_noise[row1 * a.bn_dims + a.bn_index1];
      r0 = rfw::remainder(s0 + a.bn_add0, 1.0f);
      r1 = rfw::remainder(s1 + a.bn_add1, 1.0f);
      const float h0 = rfw::random_float(&seed);
      const float h1 = rfw::random_float(&seed);
      if (a.hashed) {
        r0 = h0;
        r1 = h1;
      }
    } else {
      r0 = rfw::random_float(&seed);
      r1 = rfw::random_float(&seed);
    }

    const V3 hit = rfw::load3(a.hit_pos, i);
    const V3 nrm = rfw::load3(a.i_n, i);
    const V3 wo = -rfw::load3(a.direction, i);
    const V3 tp = rfw::load3(a.throughput, i);
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
    const bool shading = a.alive[i] && !a.spec_mat[i] && !a.alpha_cut[i];

    const LightSample ls = point_on_light(a, r0, r1, hit, nrm);
    const V3 l_vec = ls.position - hit;
    const float dist = sqrtf(rfw::clamp_min(dot3(l_vec, l_vec), RFW_F(1e-20)));
    const V3 l_dir = l_vec / dist;
    const float n_dot_l = dot3(l_dir, nrm);
    float s_pdf;
    const V3 s_val = rfw::disney_evaluate(sd, nrm, wo, l_dir, &s_pdf);
    const float denom =
        (ls.is_delta ? 0.0f : s_pdf) + ls.light_pdf * ls.pick_prob;
    const bool want = shading && n_dot_l > 0.0f && ls.light_pdf > 0.0f
                      && s_pdf > 0.0f;
    bool bad;
    const V3 nee = scrub_clamp(
        tp * s_val * ls.radiance
            * (n_dot_l / rfw::clamp_min(denom, RFW_F(1e-20))),
        a.clamp, &bad);
    scrubbed += bad && want;
    shot += want;
    const V3 n_geom = rfw::load3(a.n_geom, i);
    const V3 origin = hit + n_geom * RFW_F(1e-5);
    rfw::store3(a.origin_out, i, origin);
    rfw::store3(a.direction_out, i, l_dir);
    a.dist_out[i] = want ? dist - a.shadow_eps : 0.0f;
    rfw::store3(a.contrib_out, i, nee);
    a.want_out[i] = want;

    if (a.env_mode != 0) {
      float re;
      if (a.env_mode == 2) {
        const uint32_t gid = static_cast<uint32_t>(
            (py / a.tile) * a.tiles_x + px / a.tile);
        uint32_t g =
            lane_stream(gid, static_cast<uint32_t>(a.key), 0x517CC1B7u);
        re = rfw::random_float(&g);
      } else {
        re = rfw::random_float(&seed);
      }
      float e_pdf;
      V3 e_rad;
      const V3 e_dir = sample_envmap(a, re, &e_pdf, &e_rad);
      const float e_cos = dot3(e_dir, nrm);
      float eb_pdf;
      const V3 eb_val = rfw::disney_evaluate(sd, nrm, wo, e_dir, &eb_pdf);
      const bool e_want = shading && e_cos > 0.0f && e_pdf > 0.0f
                          && eb_pdf > 0.0f;
      const V3 e_contrib = scrub_clamp(
          tp * eb_val * e_rad
              * (e_cos / rfw::clamp_min(e_pdf + eb_pdf, RFW_F(1e-20))),
          a.clamp, &bad);
      scrubbed += bad && e_want;
      shot += e_want;
      const size_t j = i + a.n;
      rfw::store3(a.origin_out, j, origin);
      rfw::store3(a.direction_out, j, e_dir);
      a.dist_out[j] = e_want ? RFW_F(1e30) : 0.0f;
      rfw::store3(a.contrib_out, j, e_contrib);
      a.want_out[j] = e_want;
    }
    a.seed_out[i] = static_cast<long long>(seed);
  }
  // every thread of the block reaches both counts
  const int block_shot = __syncthreads_count(shot > 0) +
                         __syncthreads_count(shot > 1);
  const int block_scrubbed = __syncthreads_count(scrubbed > 0) +
                             __syncthreads_count(scrubbed > 1);
  if (threadIdx.x == 0) {
    if (block_shot)
      atomicAdd(a.counts_out, static_cast<unsigned long long>(block_shot));
    if (block_scrubbed)
      atomicAdd(a.counts_out + 1,
                static_cast<unsigned long long>(block_scrubbed));
  }
}

// integrator's radiance after the occlusion: each block of n rows adds
// its contribution where its ray is shot and not occluded, in order.
__global__ void __launch_bounds__(kNeeThreads)
nee_add_kernel(const float* __restrict__ radiance, int row_stride,
               const float* __restrict__ contrib,
               const uint8_t* __restrict__ want,
               const uint8_t* __restrict__ occ, int n, int blocks,
               float* __restrict__ out) {
  const int lane = blockIdx.x * kNeeThreads + threadIdx.x;
  if (lane >= n) return;
  const size_t i = lane;
  const float* r = radiance + i * row_stride;
  V3 acc = v3(r[0], r[1], r[2]);
  for (int k = 0; k < blocks; ++k) {
    const size_t j = i + static_cast<size_t>(k) * n;
    const V3 c = (want[j] && !occ[j]) ? rfw::load3(contrib, j)
                                      : v3(0.0f, 0.0f, 0.0f);
    acc = acc + c;
  }
  rfw::store3(out, i, acc);
}

}  // namespace

// `block` is a NeeArgs (a type of this file alone, so not in the
// signature: that would keep the symbol out of the library).
extern "C" int rfw_nee(const void* block, cudaStream_t stream) {
  const NeeArgs* args = static_cast<const NeeArgs*>(block);
  cudaError_t err = cudaMemsetAsync(args->counts_out, 0,
                                    2 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  if (args->n <= 0) return 0;
  const int grid = (args->n + kNeeThreads - 1) / kNeeThreads;
  nee_kernel<<<grid, kNeeThreads, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int rfw_nee_add(const float* radiance, int row_stride,
                           const float* contrib, const uint8_t* want,
                           const uint8_t* occ, int n, int blocks, float* out,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kNeeThreads - 1) / kNeeThreads;
  nee_add_kernel<<<grid, kNeeThreads, 0, stream>>>(
      radiance, row_stride, contrib, want, occ, n, blocks, out);
  return (int)cudaGetLastError();
}
