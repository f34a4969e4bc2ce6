"""Multiple-scattering microsurface BSDF (Heitz et al. 2016; torch port
of ``rfw_tpu.ops.bsdf.microsurface``).

A conductor with Beckmann slopes and uniform heights, sampled and
evaluated by the unbiased random walk: a ray enters the statistical
microsurface, alternates the height sample (an escape test through the
height-resolved masking G1) with the conductor phase function (a
reflection at a visible normal drawn from the Beckmann distribution of
visible normals), and every bounce adds a next-event term toward the
outgoing direction. Energy is conserved at every roughness.

As in rfw_tpu: the visible-slope solve is a fixed 20-step masked
bisection/Newton hybrid; each bounce draws fresh xorshift uniforms from
a WangHash seed made of the query's bits (``_seed_from``); the walk is
capped at ``MAX_BOUNCES`` masked steps, and a lane still inside at the
cap is invalid. The loops of ``jax.lax.fori_loop`` are Python loops of
the same fixed counts over tensors. Seeds are int64 tensors holding
uint32 words (``ops.rng``); ``erf``, ``erfinv``, powers and the other
transcendentals go through ``ops.fmath``.

``sample_bsdf`` returns ``value = color^k · pdf_claim / cos`` for a path
of order k, with ``pdf_claim`` the closed-form single-scattering
approximation that ``evaluate_bsdf`` reports, so MIS weights agree.
Selected with ``RenderConfig(bsdf="microsurface")``.
"""

from __future__ import annotations

import math

import torch

from .. import fmath, rng
from .common import INVPI, dot3, safe_normalize, sqr, tangent_to_world

MAX_BOUNCES = 16
_SQRT_PI_INV_HALF = 0.28209479177387814   # 0.5 / sqrt(pi)
_FLT_BIG = 3.0e37
_BISECTION_STEPS = 20


# -- heights: uniform on [-1, 1] --------------------------------------------

def _c1(h):
    return torch.clamp(0.5 * (h + 1.0), 0.0, 1.0)


def _inv_c1(u):
    return torch.clamp(2.0 * u - 1.0, -1.0, 1.0)


# -- Beckmann slopes, isotropic alpha ---------------------------------------

def _slope_of(alpha, w):
    cz = torch.clamp(w[..., 2], -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cz * cz, min=1e-12))
    return cz, sin_t, cz / (sin_t * torch.clamp(alpha, min=1e-6))


def _lambda(alpha, w):
    """Smith Lambda."""
    cz, _, a = _slope_of(alpha, w)
    val = 0.5 * (fmath.erf(a) - 1.0) \
        + _SQRT_PI_INV_HALF / a * fmath.exp(-a * a)
    val = torch.where(cz > 0.9999, 0.0, val)
    return torch.where(cz < -0.9999, -1.0, val)


def _projected_area(alpha, w):
    cz, sin_t, a = _slope_of(alpha, w)
    val = (0.5 * (fmath.erf(a) + 1.0) * cz
           + _SQRT_PI_INV_HALF * alpha * sin_t * fmath.exp(-a * a))
    val = torch.where(cz > 0.9999, 1.0, val)
    return torch.where(cz < -0.9999, 0.0, val)


def _ndf(alpha, wm):
    """Beckmann normal distribution through P22."""
    wz = torch.clamp(wm[..., 2], min=1e-6)
    sx = -wm[..., 0] / wz
    sy = -wm[..., 1] / wz
    a2 = alpha * alpha
    p22 = fmath.exp(-(sx * sx + sy * sy) / a2) / (math.pi * a2)
    wz2 = wz * wz
    return torch.where(wm[..., 2] > 0.0, p22 / (wz2 * wz2), 0.0)


def _vndf(alpha, wi, wm):
    """Distribution of visible normals D_wi."""
    pa = _projected_area(alpha, wi)
    c = 1.0 / torch.clamp(pa, min=1e-9)
    val = c * torch.clamp(dot3(wi, wm), min=0.0) * _ndf(alpha, wm)
    return torch.where((wm[..., 2] > 0.0) & (pa > 0.0), val, 0.0)


def _erfinv_clip(x):
    return fmath.erfinv(torch.clamp(x, -0.9999, 0.9999))


def _sample_p22_11(theta_i, u1, u2):
    """Visible Beckmann slope at alpha = 1: a fixed-step masked
    bisection/Newton solve on erf(slope)."""
    sin_t = fmath.sin(theta_i)
    cos_t = fmath.cos(theta_i)
    slope_i = cos_t / torch.clamp(sin_t, min=1e-6)
    erf_i = fmath.erf(slope_i)
    proj = (0.5 * (erf_i + 1.0) * cos_t
            + _SQRT_PI_INV_HALF * sin_t * fmath.exp(-slope_i * slope_i))
    c = 1.0 / torch.clamp(proj, min=1e-6)

    lo = torch.full_like(theta_i, -0.9999)
    hi = torch.maximum(lo, erf_i)
    cur = 0.5 * (lo + hi)
    for _ in range(_BISECTION_STEPS):
        cur = torch.where((cur >= lo) & (cur <= hi), cur, 0.5 * (lo + hi))
        slope = _erfinv_clip(cur)
        cdf = torch.where(
            slope >= slope_i, 1.0,
            c * (_SQRT_PI_INV_HALF * sin_t * fmath.exp(-slope * slope)
                 + cos_t * (0.5 + 0.5 * fmath.erf(slope))))
        diff = cdf - u1
        hi = torch.where(diff > 0.0, cur, hi)
        lo = torch.where(diff > 0.0, lo, cur)
        deriv = 0.5 * c * cos_t - 0.5 * c * sin_t * slope
        cur = cur - diff / torch.where(deriv.abs() < 1e-6,
                                       torch.sign(deriv) * 1e-6 + 1e-12,
                                       deriv)
    sx = _erfinv_clip(torch.minimum(hi, torch.maximum(lo, cur)))
    sy = _erfinv_clip(2.0 * u2 - 1.0)
    # normal incidence: a direct polar sample
    r = torch.sqrt(-fmath.log(torch.clamp(u1, min=1e-9)))
    phi = 6.28318530718 * u2
    near0 = theta_i < 1e-4
    sx = torch.where(near0, r * fmath.cos(phi), sx)
    sy = torch.where(near0, r * fmath.sin(phi), sy)
    bad = proj < 1e-4
    return torch.where(bad, 0.0, sx), torch.where(bad, 0.0, sy)


def _sample_vndf(alpha, wi, u1, u2):
    """Sample the distribution of visible normals."""
    wi11 = safe_normalize(torch.stack(
        [alpha * wi[..., 0], alpha * wi[..., 1], wi[..., 2]], dim=-1))
    theta = fmath.arccos(torch.clamp(wi11[..., 2], -1.0, 1.0))
    s11x, s11y = _sample_p22_11(theta, u1, u2)
    phi = fmath.atan2(wi11[..., 1], wi11[..., 0])
    cp, sp = fmath.cos(phi), fmath.sin(phi)
    sx = (cp * s11x - sp * s11y) * alpha
    sy = (sp * s11x + cp * s11y) * alpha
    wm = safe_normalize(torch.stack([-sx, -sy, torch.ones_like(sx)], dim=-1))
    # numerical fallback
    bad = ~torch.isfinite(sx)
    up = torch.tensor([0.0, 0.0, 1.0], device=wm.device).expand(wm.shape)
    side = safe_normalize(torch.stack(
        [wi[..., 0], wi[..., 1], torch.zeros_like(sx)], dim=-1))
    fb = torch.where((wi[..., 2] > 0)[..., None], up, side)
    return torch.where(bad[..., None], fb, wm)


# -- microsurface walk helpers ---------------------------------------------

def _g1_h(alpha, w, h0):
    """Height-resolved masking."""
    val = fmath.pow(_c1(h0), _lambda(alpha, w))
    val = torch.where(w[..., 2] > 0.9999, 1.0, val)
    return torch.where(w[..., 2] <= 0.0, 0.0, val)


def _sample_height(alpha, wr, hr, u):
    """Next interaction height; ``_FLT_BIG`` means escaped."""
    lam = _lambda(alpha, wr)
    g1 = _g1_h(alpha, wr, hr)
    escape = u > 1.0 - g1
    expo = 1.0 / torch.where(lam.abs() < 1e-9, 1e-9, lam)
    h_new = _inv_c1(_c1(hr) / torch.clamp(fmath.pow(1.0 - u, expo),
                                          min=1e-12))
    h = torch.where(escape, _FLT_BIG, h_new)
    # straight up: always escapes; straight down: resample below hr;
    # grazing: height unchanged
    h = torch.where(wr[..., 2] > 0.9999, _FLT_BIG, h)
    h = torch.where(wr[..., 2] < -0.9999, _inv_c1(u * _c1(hr)), h)
    return torch.where(wr[..., 2].abs() < 1e-4, hr, h)


def _phase_conductor(alpha, wi, wo):
    """Conductor phase function p(wi → wo)."""
    wh = safe_normalize(wi + wo)
    val = 0.25 * _vndf(alpha, wi, wh) / torch.clamp(dot3(wi, wh), min=1e-6)
    return torch.where(wh[..., 2] > 0.0, val, 0.0)


def _to_local(v, t, b, n):
    return torch.stack([dot3(v, t), dot3(v, b), dot3(v, n)], dim=-1)


def _alpha_of(sd):
    return torch.clamp(sqr(sd["roughness"]), min=1e-3)


def _pdf_approx(alpha, wi_l, wo_l):
    """Closed-form MIS pdf claim: the single-scattering pdf plus a cosine
    floor standing in for the higher orders, used alike by
    ``evaluate_bsdf`` and ``sample_bsdf``."""
    ss = _phase_conductor(alpha, wi_l, wo_l)
    cos_floor = torch.clamp(wo_l[..., 2], min=0.0) * INVPI
    return ss * 0.9 + cos_floor * 0.1


def _entry_height(like):
    return 1.0 + _inv_c1(torch.full(like.shape[:-1], 0.999,
                                    device=like.device))


def _reflect_at(wr, wm):
    return safe_normalize(wr - 2.0 * wm * dot3(wr, wm)[..., None])


def _walk_eval_rgb(alpha, color, wi_l, wo_l, seed):
    """The walk's estimate of f·cos toward ``wo_l``, its order-k terms
    weighted by color^k (the conductor's reflectance per bounce)."""
    wr = -wi_l
    hr = _entry_height(wi_l)
    total = torch.zeros(wi_l.shape[:-1] + (3,), device=wi_l.device)
    colw = torch.ones_like(total)
    alive = torch.ones(wi_l.shape[:-1], dtype=torch.bool, device=wi_l.device)
    for _ in range(MAX_BOUNCES):
        seed, (u1, u2, u3) = rng.random_floats(seed, 3)
        h_new = _sample_height(alpha, wr, hr, u1)
        inside = alive & (h_new < _FLT_BIG * 0.5)
        colw_here = colw * color              # bounce k applies color^k
        pf = _phase_conductor(alpha, -wr, wo_l)
        shadow = _g1_h(alpha, wo_l, h_new)
        term = pf * shadow
        scal = torch.where(inside & torch.isfinite(term), term, 0.0)
        total = total + scal[..., None] * colw_here
        wr_new = _reflect_at(wr, _sample_vndf(alpha, -wr, u2, u3))
        wr = torch.where(inside[..., None], wr_new, wr)
        hr = torch.where(inside, h_new, hr)
        colw = torch.where(inside[..., None], colw_here, colw)
        alive = inside & torch.isfinite(hr) & torch.isfinite(wr[..., 2])
    return total


def _seed_from(*vals):
    """WangHash chain over the float32 bit patterns of ``vals``."""
    s = torch.full_like(vals[0], 0x9E3779B9, dtype=torch.int64)
    for v in vals:
        bits = v.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
        s = rng.wang_hash(s ^ bits)
    return s


def evaluate_bsdf(sd, i_n, t_vec, b_vec, wo, wi):
    """Unbiased stochastic estimate of f(wo → wi) (no cosine) and the MIS
    pdf claim. The randoms hash the query directions: deterministic per
    query, varying per (pixel, sample, bounce)."""
    alpha = _alpha_of(sd)
    wo_l = _to_local(wo, t_vec, b_vec, i_n)
    wi_l = _to_local(wi, t_vec, b_vec, i_n)
    seed = _seed_from(wi[..., 0], wi[..., 1], wi[..., 2],
                      wo[..., 0], wo[..., 1], wo[..., 2])
    # walk from wo, connect to wi; the walk's next-event terms carry
    # cos(wi), divided out to return plain f like the other BSDFs
    val = _walk_eval_rgb(alpha, sd["color"], wo_l, wi_l, seed)
    cos_i = torch.clamp(wi_l[..., 2], min=1e-4)
    f = val / cos_i[..., None]
    ok = (wo_l[..., 2] > 0) & (wi_l[..., 2] > 0)
    f = torch.where(ok[..., None], f, 0.0)
    pdf = torch.where(ok, _pdf_approx(alpha, wo_l, wi_l), 0.0)
    return f, pdf


def sample_bsdf(sd, i_n, n, t_vec, b_vec, wo, t_dist, backfacing, r3, r4):
    """Sample by running the walk: the weight is exactly color^order,
    expressed through the claimed pdf so that the integrator's
    value·cos/pdf equals it."""
    alpha = _alpha_of(sd)
    wo_l = _to_local(wo, t_vec, b_vec, i_n)
    seed = _seed_from(r3, r4, wo[..., 0], wo[..., 1], wo[..., 2])

    wr = -wo_l
    hr = _entry_height(wo_l)
    colw = torch.ones(wo_l.shape[:-1] + (3,), device=wo_l.device)
    inside = torch.ones(wo_l.shape[:-1], dtype=torch.bool,
                        device=wo_l.device)
    for _ in range(MAX_BOUNCES):
        seed, (u1, u2, u3) = rng.random_floats(seed, 3)
        h_new = _sample_height(alpha, wr, hr, u1)
        bouncing = inside & (h_new < _FLT_BIG * 0.5)
        wr_new = _reflect_at(wr, _sample_vndf(alpha, -wr, u2, u3))
        wr = torch.where(bouncing[..., None], wr_new, wr)
        hr = torch.where(bouncing, h_new, hr)
        colw = torch.where(bouncing[..., None], colw * sd["color"], colw)
        inside = bouncing & torch.isfinite(hr) & torch.isfinite(wr[..., 2])

    wi_l = wr
    # invalid: never escaped within the cap, or escaped downward
    valid = ~inside & (wi_l[..., 2] > 1e-5)
    wi_w = safe_normalize(tangent_to_world(wi_l, t_vec, b_vec, i_n))
    cos_i = torch.clamp(wi_l[..., 2], min=1e-4)
    pdf = torch.where(valid, _pdf_approx(alpha, wo_l, wi_l), 0.0)
    value = torch.where(valid[..., None], colw * (pdf / cos_i)[..., None],
                        0.0)
    return value, wi_w, pdf, torch.zeros_like(pdf, dtype=torch.int32)
