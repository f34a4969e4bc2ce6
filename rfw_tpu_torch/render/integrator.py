"""The path-tracing integrator (torch port of
``rfw_tpu.render.integrator``): ray-gen → [closest hit → shade (sky /
emissive) → NEE + occlusion → BSDF extension] per depth, over an
explicit ``PathState`` whose lanes are freely permutable — every random
draw is keyed by pixel id (+ sample, depth).

Engines inject an ``Intersector``; ``trace_sample`` runs every depth on
fixed lanes (dead lanes masked) and ``wavefront_driver`` runs the same
``depth_stage`` with lane compaction between depths.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import extension, fmath, light_sampling, nee, raygen, rng
from ..ops.bsdf import get as get_bsdf
from ..ops.bsdf.common import clamp_intensity, dot3
from ..ops.shade import get_shading_data
from ..utils import tracing


class Intersector(NamedTuple):
    closest: Callable    # (scene, O, D, t_max, sort, coherent) -> (t, prim, u, v)
    occluded: Callable   # (scene, O, D, dist, sort, coherent) -> bool mask
    # a t_max/dist of 0 marks a dead lane: intersectors skip it


class PathState(NamedTuple):
    """Per-lane path state between depths."""

    origin: torch.Tensor       # (N, 3)
    direction: torch.Tensor    # (N, 3)
    throughput: torch.Tensor   # (N, 3)
    radiance: torch.Tensor     # (N, 3) accumulated along the path
    last_pdf: torch.Tensor     # (N,)
    spec_bounce: torch.Tensor  # (N,) bool — specular path flag
    last_n: torch.Tensor       # (N, 3) shading normal at previous vertex
    alive: torch.Tensor        # (N,) bool
    pid: torch.Tensor          # (N,) int32 absolute pixel id


def _sky_texel(scene, d):
    """Direction → (x, y) equirect texel."""
    pix = scene["skybox"]["pixels"]
    h, w = pix.shape[0], pix.shape[1]
    u = (w * 0.5 * (1.0 + fmath.atan2(d[..., 0], -d[..., 2])
                    * (1.0 / math.pi))).to(torch.int32)
    v = (h * (fmath.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
              * (1.0 / math.pi))).to(torch.int32)
    return (torch.clamp(u, 0, w - 1).long(), torch.clamp(v, 0, h - 1).long())


def sample_skybox(scene, d):
    """Equirect miss lookup."""
    if "skybox" not in scene:
        return torch.zeros(d.shape[:-1] + (3,), device=d.device)
    x, y = _sky_texel(scene, d)
    return scene["skybox"]["pixels"][y, x]


def sample_skybox_with_pdf(scene, d):
    """Miss radiance and the envmap sampler's pdf of ``d``."""
    sky = scene["skybox"]
    x, y = _sky_texel(scene, d)
    if "pixpdf" in sky:     # packed (H, W, 4): one gather for both
        row = sky["pixpdf"][y, x]
        return row[..., 0:3], row[..., 3]
    return sky["pixels"][y, x], sky["pdf"][y, x]


def _tile_permutation(width: int, n: int, tile: int = 16):
    """Static pixel→lane permutation grouping 16x16 image tiles into
    contiguous lanes (square ray blocks cross fewer cells than row
    strips). Returns (perm, inv) numpy int32, or None when the range is
    not tileable."""
    if n % width != 0:
        return None
    rows = n // width
    if rows < tile or width < tile:
        return None
    y, x = np.divmod(np.arange(n, dtype=np.int64), width)
    key = (((y // tile) * (width // tile + 1) + x // tile) * (tile * tile)
           + (y % tile) * tile + (x % tile))
    perm = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


def make_path_state(scene, view, width: int, height: int, sample_index: int,
                    config: RenderConfig, pid, pixel_cache=None) -> PathState:
    """Ray-gen + fresh path state for the lanes in ``pid`` (int32
    absolute pixel ids, any order)."""
    bn = scene.get("blue_noise") if config.blue_noise else None
    origin, direction = raygen.generate_primary_rays(
        view, width, height, sample_index, pid, blue_noise_mask=bn,
        pixel_cache=pixel_cache)
    n = pid.shape[0]
    dev = pid.device
    return PathState(
        origin=origin, direction=direction,
        throughput=torch.ones((n, 3), device=dev),
        radiance=torch.zeros((n, 3), device=dev),
        last_pdf=torch.ones(n, device=dev),
        spec_bounce=torch.zeros(n, dtype=torch.bool, device=dev),
        last_n=direction,
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        pid=pid)


def depth_stage(scene, view, state: PathState, width: int, depth: int,
                sample_index: int, probe_lane: int, config: RenderConfig,
                intersector: Intersector, tex_flags=None,
                sort_rays: bool | None = None, height: int | None = None,
                with_aux: bool = True):
    """One depth of the wavefront loop: closest hit → shade (sky /
    emissive) → NEE + occlusion → extension BSDF sample (``ops/nee.py``
    and ``ops/extension.py`` choose their kernel or plain step).

    ``probe_lane`` is the lane to probe (depth 0 only). ``sort_rays``
    overrides the closest-hit coherence sort (None: sort iff depth > 0;
    the compacted driver passes False for its pre-sorted streams).
    Returns (state, stats, probe, aux): stats {"ray_count",
    "shadow_count"} for this depth as device scalars; at depth 0 probe
    (3,) and the denoiser's guide planes aux {"normal" (N, 3), "depth"
    (N,)} (the shading normal and the hit distance, 0 on a miss; None
    unless ``with_aux``), else None and None.
    """
    n = state.pid.shape[0]
    bsdf = get_bsdf(config.bsdf)
    clamp_v = float(config.firefly_clamp)
    lights = scene["lights"]

    (origin, direction, throughput, radiance, last_pdf, spec_bounce,
     last_n, alive, pid) = state
    pid_l = pid.long()
    probe = aux = None
    stats = {}

    ray_tmax = torch.where(alive, 1e30, 0.0)
    do_sort = (depth > 0) if sort_rays is None else sort_rays
    t, prim, u, v = intersector.closest(scene, origin, direction, ray_tmax,
                                        sort=do_sort, coherent=depth == 0)
    prim = torch.where(alive, prim, -1)
    stats["ray_count"] = alive.sum()

    with tracing.span("stage.shade"):
        miss = prim < 0
        # skybox on miss, MIS-weighted against the previous vertex's envmap
        # NEE (a specular bounce shot none)
        if depth > 0 and nee.env_nee_at(scene, config, depth - 1):
            sky, e_pdf = sample_skybox_with_pdf(scene, direction)
            denom_m = torch.where(spec_bounce, last_pdf, last_pdf + e_pdf)
        else:
            sky = sample_skybox(scene, direction)
            denom_m = last_pdf
        contrib = throughput * sky / torch.clamp(denom_m, min=1e-20)[..., None]
        contrib = clamp_intensity(
            nee.scrub(contrib, alive & miss, stats, config), clamp_v)
        radiance = radiance + torch.where((alive & miss)[..., None],
                                          contrib, 0.0)
        alive = alive & ~miss
        prim_safe = torch.clamp(prim, min=0).long()

        hit_pos = origin + direction * t[..., None]
        cone_width = view["spread_angle"] * t
        stoch_seed = None
        if config.texture_filter == "stochastic" and (
                tex_flags is None or any(tex_flags.values())):
            # a salted stream of its own for the one-tap texture fetches
            stoch_seed = rng.wang_hash(
                rng.path_seed(pid_l, sample_index, depth) ^ 0x7FEB352D)
        sd, n_geom, i_n, t_vec, b_vec, alpha_cut = get_shading_data(
            scene, prim_safe, u, v, direction, cone_width, tex_flags=tex_flags,
            tex_filter=config.texture_filter, stoch_seed=stoch_seed)
        alpha_cut = alpha_cut & alive

        if depth == 0:
            if with_aux:
                aux = {"normal": torch.where(miss[..., None], 0.0, i_n),
                       "depth": torch.where(miss, 0.0, t)}
            probe_prim = prim_safe[probe_lane]
            # indexing by a 0-d device tensor reads it to the host
            with tracing.span("sync.probe"):
                probe = torch.stack([
                    scene["tri_instance"][probe_prim].to(torch.float32),
                    scene["tri_prim"][probe_prim].to(torch.float32),
                    torch.where(miss[probe_lane], -1.0, t[probe_lane])])

        # emissive hit terminates the path
        emissive = (sd["color"] > 1.0).any(-1) & ~alpha_cut
        d_dot_nl = -dot3(direction, n_geom)
        if depth == 0:
            e_contrib = sd["color"]
        elif not config.variance_reduction:
            e_contrib = throughput * sd["color"] \
                / torch.clamp(last_pdf, min=1e-20)[..., None]
        else:
            row = scene["tri_pack"][prim_safe]
            light_pdf = light_sampling.calculate_light_pdf(
                direction, t, row[:, 26], n_geom)
            pick_prob = light_sampling.light_pick_prob(
                row[:, 27].long(), lights, origin, last_n, hit_pos)
            denom = last_pdf + light_pdf * pick_prob
            mis_c = throughput * sd["color"] \
                / torch.clamp(denom, min=1e-20)[..., None]
            mis_c = torch.where((denom > 0)[..., None], mis_c, 0.0)
            spec_c = throughput * sd["color"] \
                / torch.clamp(last_pdf, min=1e-20)[..., None]
            e_contrib = torch.where(spec_bounce[..., None], spec_c, mis_c)
        e_contrib = torch.where((d_dot_nl > 0)[..., None], e_contrib, 0.0)
        e_contrib = clamp_intensity(
            nee.scrub(e_contrib, alive & emissive, stats, config), clamp_v)
        radiance = radiance + torch.where((alive & emissive)[..., None],
                                          e_contrib, 0.0)
        alive = alive & ~emissive

        # face normals toward the ray; apply the postponed pdf
        flip = torch.where(dot3(direction, n_geom) > 0, -1.0, 1.0)
        n_geom = n_geom * flip[..., None]
        i_n = i_n * flip[..., None]
        backfacing = flip < 0
        throughput_predpdf = throughput
        throughput = throughput / torch.clamp(last_pdf, min=1e-20)[..., None]

    spec_mat = sd["roughness"] < config.min_roughness

    with tracing.span("stage.nee"):
        if config.variance_reduction:
            lanes = nee.NeeLanes(sd, hit_pos, i_n, n_geom, t_vec, b_vec,
                                 direction, throughput, alive, spec_mat,
                                 alpha_cut, pid)
            rays = nee.nee(scene, config, bsdf, lanes, width, height,
                           depth, sample_index, stats)
            # one occlusion launch for light and envmap shadow rays; only
            # bounces sort, and depth 0's light rays alone come coherent
            light_only = rays.want.shape[0] == n
            occ = intersector.occluded(
                scene, rays.origin, rays.direction, rays.dist,
                sort=depth > 0, coherent=depth == 0 and light_only)
            radiance = nee.add_unoccluded(radiance, rays, occ)
            seed = rays.seed
        else:
            seed = nee.lane_seed(pid, sample_index, depth)

    if depth >= config.max_path_length:
        # final depth: no extension rays
        state = PathState(origin, direction, throughput, radiance, last_pdf,
                          spec_bounce, last_n, torch.zeros_like(alive), pid)
        return state, stats, probe, aux

    # extension: sample the BSDF for the next ray
    with tracing.span("stage.extend"):
        lanes = extension.ExtendLanes(
            sd, hit_pos, i_n, n_geom, t_vec, b_vec, direction, t, backfacing,
            throughput, throughput_predpdf, last_pdf, last_n, spec_bounce,
            alive, alpha_cut, spec_mat)
        state = extension.extend(config, bsdf, lanes, seed,
                                 state._replace(radiance=radiance))
    return state, stats, probe, aux


def trace_sample(scene, view, width: int, height: int, sample_index: int,
                 probe_index: int, config: RenderConfig,
                 intersector: Intersector, pixel_offset: int = 0,
                 n_pixels: int | None = None, tex_flags=None,
                 with_aux: bool = True):
    """One sample for every pixel of a contiguous range, all depths on
    fixed lanes (the fused path). Returns (radiance (N, 3), probe (3,),
    stats {"ray_count_d", "shadow_count_d"}, aux {"normal" (N, 3),
    "depth" (N,)}, None unless ``with_aux``), radiance and aux in pixel
    order."""
    n = n_pixels if n_pixels is not None else width * height
    dev = scene["tri_pack"].device
    tp = _tile_permutation(width, n)
    if tp is not None:
        perm, inv = tp
        pid = torch.from_numpy(perm + np.int32(pixel_offset)).to(dev)
        probe_lane = int(inv[probe_index])
    else:
        pid = torch.arange(pixel_offset, pixel_offset + n, dtype=torch.int32,
                           device=dev)
        probe_lane = probe_index
    state = make_path_state(scene, view, width, height, sample_index,
                            config, pid)
    stats = {}
    probe = aux = None
    for depth in range(config.max_path_length + 1):
        state, st, probe_d, aux_d = depth_stage(
            scene, view, state, width, depth, sample_index,
            probe_lane if depth == 0 else 0, config, intersector,
            tex_flags=tex_flags, sort_rays=depth > 0, height=height,
            with_aux=with_aux)
        if depth == 0:
            probe, aux = probe_d, aux_d
        for k, val in st.items():
            stats[f"{k}_{depth}"] = val
    radiance = state.radiance
    if tp is not None:
        inv_t = torch.from_numpy(inv).to(dev).long()
        radiance = radiance[inv_t]
        if aux is not None:
            aux = {k: v[inv_t] for k, v in aux.items()}
    return radiance, probe, stats, aux
