"""Disney principled BSDF (torch port of ``rfw_tpu.ops.bsdf.disney``).

``sd`` (ShadingData) is a dict of per-ray tensors: color (R,3),
absorption (R,3), metallic, subsurface, specular, roughness,
specular_tint, anisotropic, sheen, sheen_tint, clearcoat,
clearcoat_gloss, transmission, eta — all (R,), roughness pre-clamped.
"""

from __future__ import annotations

import torch

from ...utils import tracing
from .. import fmath
from .common import (INV2PI, INVPI, TWOPI, diffuse_reflection_cos_weighted,
                     diffuse_reflection_uniform, dot3, fr, gtr1, gtr2, lerp,
                     reflect, refract_dir, safe_normalize, schlick_fresnel,
                     smith_ggx, sqr, tangent_to_world)

BSDF_REFLECTED = 0
BSDF_TRANSMITTED = 1
BSDF_SPECULAR = 2


def bsdf_pdf(sd, n, wo, wi):
    roughness = sd["roughness"]
    n_dot_wi = dot3(n, wi)
    brdf_pdf_below = INV2PI * sd["subsurface"] * 0.5
    f = fr(dot3(n, wo), sd["eta"])
    halfway = safe_normalize(wi + wo)
    cos_theta_half = dot3(halfway, n).abs()
    pdf_half = gtr2(cos_theta_half, roughness) * cos_theta_half
    pdf_spec = 0.25 * pdf_half / torch.clamp(dot3(wi, halfway), min=1e-6)
    pdf_diff = n_dot_wi.abs() * INVPI * (1.0 - sd["subsurface"])
    bsdf_pdf_above = pdf_spec * f
    brdf_pdf_above = lerp(pdf_diff, pdf_spec, 0.5)
    below = n_dot_wi <= 0.0
    brdf = torch.where(below, brdf_pdf_below, brdf_pdf_above)
    bsdf = torch.where(below, 0.0, bsdf_pdf_above)
    return lerp(brdf, bsdf, sd["transmission"])


def bsdf_eval(sd, n, wo, wi, t, backfacing):
    """Returns (R, 3) reflectance."""
    n_dot_l = dot3(n, wi)
    n_dot_v = dot3(n, wo)
    h = safe_normalize(wi + wo)
    n_dot_h = dot3(n, h)
    l_dot_h = dot3(wi, h)
    cdlin = sd["color"]
    cdlum = 0.3 * cdlin[..., 0] + 0.6 * cdlin[..., 1] + 0.1 * cdlin[..., 2]
    ctint = torch.where(cdlum[..., None] > 0.0,
                        cdlin / torch.clamp(cdlum[..., None], min=1e-20), 1.0)
    cspec0 = lerp(
        sd["specular"][..., None] * 0.08
        * lerp(torch.ones_like(cdlin), ctint, sd["specular_tint"][..., None]),
        cdlin, sd["metallic"][..., None])
    a = sd["roughness"]

    # BSDF side (transmission > 0)
    f_v = fr(n_dot_v, sd["eta"])
    bsdf_trans = ((1.0 - f_v) / torch.clamp(n_dot_l.abs(), min=1e-7)
                  * (1.0 - sd["metallic"]) * sd["transmission"])[..., None]
    bsdf_trans = bsdf_trans.expand(cdlin.shape)
    ds = gtr2(n_dot_h, a)
    fh_exact = fr(l_dot_h, sd["eta"])
    fs_bsdf = lerp(cspec0, torch.ones_like(cspec0), fh_exact[..., None])
    gs = smith_ggx(n_dot_v, a) * smith_ggx(n_dot_l, a)
    bsdf_spec = (gs * ds)[..., None] * fs_bsdf
    bsdf_side = torch.where((n_dot_l <= 0.0)[..., None], bsdf_trans,
                            bsdf_spec)

    # BRDF side (transmission < 1)
    s = torch.sqrt(torch.clamp(sd["color"], min=0.0))
    fl_abs = schlick_fresnel(n_dot_l.abs())
    fv = schlick_fresnel(n_dot_v)
    fd_ss = (1.0 - 0.5 * fl_abs) * (1.0 - 0.5 * fv)
    brdf_below = (INVPI * fd_ss * sd["subsurface"]
                  * (1.0 - sd["metallic"]))[..., None] * s
    brdf_below = torch.where((sd["subsurface"] > 0.0)[..., None],
                             brdf_below, 0.0)
    fh = schlick_fresnel(l_dot_h)
    fs = lerp(cspec0, torch.ones_like(cspec0), fh[..., None])
    fl = schlick_fresnel(n_dot_l)
    fd90 = 0.5 + 2.0 * l_dot_h * l_dot_h * a
    fd = lerp(1.0, fd90, fl) * lerp(1.0, fd90, fv)
    dr = gtr1(n_dot_h, lerp(0.1, 0.001, sd["clearcoat_gloss"]))
    fc = lerp(0.04, 1.0, fh)
    gr = smith_ggx(n_dot_l, 0.25) * smith_ggx(n_dot_v, 0.25)
    brdf_above = (
        (INVPI * fd * (1.0 - sd["metallic"])
         * (1.0 - sd["subsurface"]))[..., None] * cdlin
        + (gs * ds)[..., None] * fs
        + (sd["clearcoat"] * gr * fc * dr)[..., None])
    brdf_side = torch.where((n_dot_l <= 0.0)[..., None], brdf_below,
                            brdf_above)

    final = lerp(brdf_side, bsdf_side, sd["transmission"][..., None])
    absorbed = fmath.exp(-sd["absorption"] * t[..., None])
    return torch.where(backfacing[..., None], final * absorbed, final)


def _sample_half_vector(t, b, n, wo, roughness, r1, r2):
    """GGX half-vector sample, flipped towards ``wo``."""
    cos_theta_half = torch.sqrt(torch.clamp(
        (1.0 - r2) / (1.0 + (sqr(roughness) - 1.0) * r2), min=0.0))
    sin_theta_half = torch.sqrt(torch.clamp(1.0 - sqr(cos_theta_half),
                                            min=0.0))
    phi = r1 * TWOPI
    local = torch.stack([sin_theta_half * fmath.cos(phi),
                         sin_theta_half * fmath.sin(phi), cos_theta_half],
                        dim=-1)
    halfway = tangent_to_world(local, t, b, n)
    flip = dot3(halfway, wo) <= 0.0
    return torch.where(flip[..., None], -halfway, halfway)


def bsdf_sample(sd, t_vec, b_vec, n, wo, r3, r4, t_dist, backfacing):
    """Returns (wi, pdf, sample_type), branchless."""
    transmission = sd["transmission"]
    roughness = sd["roughness"]

    # transmission side (r3 < transmission)
    f = fr(dot3(n, wo), sd["eta"])
    r1_t = r3 / torch.clamp(transmission, min=1e-9)
    r2_t = r4 / torch.clamp(f, min=1e-9)
    half_t = _sample_half_vector(t_vec, b_vec, n, wo, roughness, r1_t, r2_t)
    wi_reflect_t = reflect(-wo, half_t)
    refract_ok, wi_refract = refract_dir(wo, n, sd["eta"])
    take_reflect = r4 < f
    wi_trans = torch.where(take_reflect[..., None], wi_reflect_t, wi_refract)
    type_trans = torch.where(take_reflect, BSDF_REFLECTED, BSDF_SPECULAR)

    # BRDF side
    r1 = (r3 - transmission) / torch.clamp(1.0 - transmission, min=1e-9)
    subsurface = sd["subsurface"]
    r2d = r4 * 2.0
    r5_ss = r2d / torch.clamp(subsurface, min=1e-9)
    # the subsurface sample goes below the surface; a tensor made from a
    # list is a host-to-device copy that waits for the device
    with tracing.span("sync.disney_const"):
        below = r1.new_tensor([1.0, 1.0, -1.0])
    d_ss = diffuse_reflection_uniform(r1, r5_ss) * below
    r5_cos = (r2d - subsurface) / torch.clamp(1.0 - subsurface, min=1e-9)
    d_cos = diffuse_reflection_cos_weighted(r1, r5_cos)
    take_ss = r2d < subsurface
    d_local = torch.where(take_ss[..., None], d_ss, d_cos)
    wi_diffuse = tangent_to_world(d_local, t_vec, b_vec, n)
    type_diffuse = torch.where(take_ss, BSDF_TRANSMITTED, BSDF_REFLECTED)
    r2s = (r4 - 0.5) * 2.0
    half_s = _sample_half_vector(t_vec, b_vec, n, wo, roughness, r1, r2s)
    wi_spec = reflect(-wo, half_s)

    take_diffuse = r4 < 0.5
    wi_brdf = torch.where(take_diffuse[..., None], wi_diffuse, wi_spec)
    type_brdf = torch.where(take_diffuse, type_diffuse, BSDF_REFLECTED)

    take_trans = r3 < transmission
    wi = torch.where(take_trans[..., None], wi_trans, wi_brdf)
    stype = torch.where(take_trans, type_trans, type_brdf)

    pdf = bsdf_pdf(sd, n, wo, wi)
    pdf_refract = torch.where(refract_ok, (1.0 - f) * transmission, 0.0)
    pdf = torch.where(take_trans & ~take_reflect, pdf_refract, pdf)
    return wi, pdf, stype


def evaluate_bsdf(sd, i_n, t_vec, b_vec, wo, wi):
    """Returns (bsdf (R,3), pdf (R,))."""
    zeros = torch.zeros_like(sd["roughness"])
    val = bsdf_eval(sd, i_n, wo, wi, zeros, zeros > 1.0)
    return val, bsdf_pdf(sd, i_n, wo, wi)


def sample_bsdf(sd, i_n, n, t_vec, b_vec, wo, t_dist, backfacing, r3, r4):
    """Returns (bsdf, wi, pdf, sample_type)."""
    wi, pdf, stype = bsdf_sample(sd, t_vec, b_vec, i_n, wo, r3, r4, t_dist,
                                 backfacing)
    val = bsdf_eval(sd, i_n, wo, wi, t_dist, backfacing)
    return val, wi, pdf, stype
