"""Microfacet BSDF: GGX specular over a Lambert base (torch port of
``rfw_tpu.ops.bsdf.microfacet``).

Importance-sampled GGX normal distribution, Smith masking, Schlick
Fresnel tinted by the specular colour, and the energy split between the
diffuse and specular lobes by their mean albedos. Selected with
``RenderConfig(bsdf="microfacet")``.
"""

from __future__ import annotations

import torch

from .. import fmath
from .common import (INVPI, TWOPI, diffuse_reflection_cos_weighted, dot3,
                     gtr2, lerp, reflect, safe_normalize, schlick_fresnel,
                     smith_ggx, sqr, tangent_to_world)


def _alpha(sd):
    return torch.clamp(sqr(sd["roughness"]), min=1e-4)


def _mean3(x):
    """Mean of the three channels, summed in a fixed order."""
    return (x[..., 0] + x[..., 1] + x[..., 2]) / 3.0


def _spec_color(sd):
    # F0 from the specular parameter (0.5 gives 4 %), tinted toward the
    # base colour by metalness
    f0 = (0.08 * sd["specular"])[..., None]
    return lerp(f0.expand(sd["color"].shape), sd["color"],
                sd["metallic"][..., None])


def _spec_prob(sd):
    """Probability of sampling the specular lobe: mean F0 against the
    diffuse albedo."""
    spec_l = _mean3(_spec_color(sd))
    diff_l = _mean3(sd["color"]) * (1.0 - sd["metallic"])
    return torch.clamp(spec_l / torch.clamp(spec_l + diff_l, min=1e-6),
                       0.1, 0.9)


def _eval_terms(sd, n, wo, wi):
    a = _alpha(sd)
    h = safe_normalize(wo + wi)
    n_dot_h = dot3(n, h)
    n_dot_o = dot3(n, wo)
    n_dot_i = dot3(n, wi)
    d = gtr2(n_dot_h, a)
    g = smith_ggx(n_dot_o.abs(), a) * smith_ggx(n_dot_i.abs(), a)
    spec_c = _spec_color(sd)
    f = spec_c + (1.0 - spec_c) * schlick_fresnel(dot3(wi, h))[..., None]
    spec = (d * g)[..., None] * f
    kd = (1.0 - sd["metallic"])[..., None] * (1.0 - spec_c)
    diff = kd * sd["color"] * INVPI
    val = torch.where((n_dot_i > 0)[..., None], spec + diff, 0.0)

    pdf_h = d * torch.clamp(n_dot_h, min=0.0)
    pdf_spec = 0.25 * pdf_h / torch.clamp(dot3(wi, h), min=1e-6)
    pdf_diff = torch.clamp(n_dot_i, min=0.0) * INVPI
    pdf = torch.where(n_dot_i > 0,
                      lerp(pdf_diff, pdf_spec, _spec_prob(sd)), 0.0)
    return val, pdf


def evaluate_bsdf(sd, i_n, t_vec, b_vec, wo, wi):
    return _eval_terms(sd, i_n, wo, wi)


def sample_bsdf(sd, i_n, n, t_vec, b_vec, wo, t_dist, backfacing, r3, r4):
    a = _alpha(sd)
    spec_prob = _spec_prob(sd)
    take_spec = r3 < spec_prob
    # r3 renormalised within its branch
    r3s = r3 / torch.clamp(spec_prob, min=1e-6)
    r3d = (r3 - spec_prob) / torch.clamp(1.0 - spec_prob, min=1e-6)

    # GGX half-vector sample
    cos_h = torch.sqrt(torch.clamp((1.0 - r4) / (1.0 + (a * a - 1.0) * r4),
                                   min=0.0))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    phi = TWOPI * r3s
    h_local = torch.stack([sin_h * fmath.cos(phi), sin_h * fmath.sin(phi),
                           cos_h], dim=-1)
    h = tangent_to_world(h_local, t_vec, b_vec, i_n)
    h = torch.where((dot3(h, wo) <= 0)[..., None], -h, h)
    wi_spec = reflect(-wo, h)

    wi_diff = tangent_to_world(diffuse_reflection_cos_weighted(r3d, r4),
                               t_vec, b_vec, i_n)

    wi = torch.where(take_spec[..., None], wi_spec, wi_diff)
    val, pdf = _eval_terms(sd, i_n, wo, wi)
    return val, wi, pdf, torch.zeros_like(pdf, dtype=torch.int32)
