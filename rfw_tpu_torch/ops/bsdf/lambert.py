"""Lambert BSDF (torch port of ``rfw_tpu.ops.bsdf.lambert``): the
reference's simple alternative, for analytic furnace results and cheap
previews."""

from __future__ import annotations

import torch

from .common import (INVPI, diffuse_reflection_cos_weighted, dot3,
                     tangent_to_world)


def evaluate_bsdf(sd, i_n, t_vec, b_vec, wo, wi):
    n_dot_wi = dot3(i_n, wi)
    val = torch.where((n_dot_wi > 0)[..., None], sd["color"] * INVPI, 0.0)
    pdf = torch.where(n_dot_wi > 0, n_dot_wi * INVPI, 0.0)
    return val, pdf


def sample_bsdf(sd, i_n, n, t_vec, b_vec, wo, t_dist, backfacing, r3, r4):
    local = diffuse_reflection_cos_weighted(r3, r4)
    wi = tangent_to_world(local, t_vec, b_vec, i_n)
    pdf = torch.clamp(dot3(i_n, wi), min=0.0) * INVPI
    val = sd["color"] * INVPI
    return val, wi, pdf, torch.zeros_like(pdf, dtype=torch.int32)
