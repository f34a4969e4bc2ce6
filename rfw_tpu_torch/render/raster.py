"""Forward-shading preview engine, the GLRenderer analog (port of
``rfw_tpu.render.raster``).

The reference's GLRenderer is a forward rasterizer: per fragment it
evaluates every light of all four types with distance and N·L
attenuation and no shadows. Here primary visibility comes from the same
intersectors as the path tracers: one bounce, no shadow rays, no
accumulation. One sample per pixel, deterministic: the rays of sample 0.
A frame runs in equal chunks of at most ``config.max_rays_per_pass``
lanes, through the engines' chunk loop (``parallel.tiles.make_step``).

Unlike rfw_tpu's, this engine forces RESET and one sample on the
asynchronous path too (``render_frame_async``), so a resolved frame is
the 1-spp radiance whatever status or sample count the caller passes.
rfw_tpu overrides only ``render_frame``; through its async path a
CONVERGE frame overwrites the accumulator but still counts the samples,
and comes out darker (radiance / count).
"""

from __future__ import annotations

import math

import torch

from ..ops import raygen
from ..ops.bsdf.common import safe_normalize
from ..ops.intersect import dot3
from ..ops.shade import get_shading_data
from ..parallel import tiles
from .context import RenderStatus, register_engine
from .engines import PathTracerEngine
from .integrator import sample_skybox
from .intersectors import make_intersector


def _eval_lights(lights, p, n, albedo):
    """All four light loops of the GLRenderer's fragment shader, with no
    occlusion: ``p`` and ``n`` (R, 3) the hit points and their normals,
    ``albedo`` (R, 3); returns the shaded color (R, 3)."""
    color = torch.zeros_like(albedo)
    f = albedo * (1.0 / math.pi)
    nn = n[:, None, :]

    # area lights (radiance * area * NdotL / d²; LNdotL gate)
    l_vec = lights["area_position"][None] - p[:, None, :]
    d2 = torch.sum(l_vec * l_vec, dim=-1)
    l_dir = safe_normalize(l_vec)
    ndotl = dot3(nn, l_dir)
    lndotl = -dot3(lights["area_normal"][None], l_dir)
    w = torch.where((ndotl > 0) & (lndotl > 0),
                    ndotl / torch.clamp(d2, min=1e-9)
                    * lights["area_area"][None], 0.0)
    color = color + f * torch.sum(
        w[..., None] * lights["area_radiance"][None], dim=1)

    # point lights
    l_vec = lights["point_position"][None] - p[:, None, :]
    d2 = torch.sum(l_vec * l_vec, dim=-1)
    l_dir = safe_normalize(l_vec)
    ndotl = dot3(nn, l_dir)
    w = torch.where(ndotl > 0, ndotl / torch.clamp(d2, min=1e-9), 0.0)
    color = color + f * torch.sum(
        w[..., None] * lights["point_radiance"][None], dim=1)

    # spot lights (a light with cos_inner == cos_outer divides by 1)
    l_vec = p[:, None, :] - lights["spot_position"][None]
    d2 = torch.sum(l_vec * l_vec, dim=-1)
    l_dir = safe_normalize(l_vec)
    denom = (lights["spot_cos_inner"] - lights["spot_cos_outer"])[None]
    fall = torch.clamp((dot3(l_dir, lights["spot_direction"][None])
                        - lights["spot_cos_outer"][None])
                       / torch.where(denom != 0, denom, 1.0), 0.0, 1.0)
    ndotl = -dot3(nn, l_dir)
    w = torch.where(ndotl > 0, ndotl * fall / torch.clamp(d2, min=1e-9), 0.0)
    color = color + f * torch.sum(
        w[..., None] * lights["spot_radiance"][None], dim=1)

    # directional lights
    ndotl = -dot3(nn, lights["dir_direction"][None])
    w = torch.clamp(ndotl, min=0.0)
    color = color + f * torch.sum(
        w[..., None] * lights["dir_radiance"][None], dim=1)
    return color


@register_engine("raster")
class RasterEngine(PathTracerEngine):
    """Un-shadowed forward shading (the GLRenderer contract)."""

    default_intersector = "bvh"

    def _get_step(self, width: int, height: int):
        key = (width, height, self._intersector_name)
        if self._step is not None and self._step_key == key:
            return self._step
        cfg = self.config
        if cfg.n_devices and cfg.n_devices > 1:
            raise ValueError(
                f"the raster engine renders on one device; n_devices="
                f"{cfg.n_devices} applies to the path tracers")
        intersector = make_intersector(self._intersector_name, cfg)
        self._driver = None
        # equal chunks of at most max_rays_per_pass lanes, as the path
        # tracers take them: the light loops hold (lanes, lights, 3)
        n_chunks = tiles.chunk_count(width * height, cfg.max_rays_per_pass,
                                     height)
        n_local = width * height // n_chunks

        def trace(i, scene, view, rows, probe_index, sample_index,
                  with_aux):
            # sample 0's rays whatever the sample index: deterministic
            pid = torch.arange(i * n_local, (i + 1) * n_local,
                               dtype=torch.int32, device=rows.device)
            origin, direction = raygen.generate_primary_rays(
                view, width, height, 0, pid)
            t, prim, u, v = intersector.closest(scene, origin, direction)
            miss = prim < 0
            prim_safe = torch.clamp(prim, min=0).long()
            hit_pos = origin + direction * t[..., None]
            sd, _, i_n, _, _, _ = get_shading_data(
                scene, prim_safe, u, v, direction, view["spread_angle"] * t)
            flip = torch.where(dot3(direction, i_n) > 0, -1.0, 1.0)
            i_n = i_n * flip[..., None]
            shaded = _eval_lights(scene["lights"], hit_pos, i_n, sd["color"])
            # emissive surfaces show their color (lamp visualization)
            emissive = torch.any(sd["color"] > 1.0, dim=-1)
            shaded = torch.where(emissive[..., None], sd["color"], shaded)
            radiance = torch.where(miss[..., None],
                                   sample_skybox(scene, direction), shaded)
            probe_prim = prim_safe[probe_index]
            probe = torch.stack([
                scene["tri_instance"][probe_prim].to(torch.float32),
                scene["tri_prim"][probe_prim].to(torch.float32),
                torch.where(miss[probe_index], -1.0, t[probe_index])])
            # the GLRenderer redraws: the radiance replaces the
            # accumulator, and no aux planes are made (denoise does nothing)
            return radiance, probe, {"ray_count_0": n_local}, None

        step = tiles.make_step((self.device,) * n_chunks, n_local, trace,
                               self._replicas)
        self._step, self._step_key = step, key
        return step

    def render_frame_async(self, view, status=None, samples: int = 1) -> None:
        """A fresh 1-spp frame whatever ``status`` and ``samples`` say
        (``render_frame`` comes through here too)."""
        super().render_frame_async(view, RenderStatus.RESET, samples=1)
