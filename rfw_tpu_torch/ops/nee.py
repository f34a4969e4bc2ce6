"""Next-event estimation of one depth (the NEE step of
``render/integrator.py::depth_stage``): a light sample a lane and, where
the envmap is importance-sampled, an envmap sample, each weighted by MIS
against the BSDF, and the shadow rays that test them.

``nee`` makes the kernel-or-plain choice: it runs ``csrc/nee_kernel.cu``
(one thread a lane) for CUDA lanes under the Disney BSDF, and
``nee_plain`` for CPU lanes and every other BSDF; the two agree bit for
bit on the same CUDA tensors.
``add_unoccluded`` adds the contributions whose shadow rays reached
their light; on CUDA tensors it is one launch of the same source.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils import tracing
from . import cuda_lib, fmath, light_sampling, rng
from .bsdf import disney
from .bsdf.common import clamp_intensity, dot3, safe_origin

# the salts of the lane stream and of the envmap tile stream
SEED_SALT = 0x9E3779B9
ENV_SALT = 0x517CC1B7


class NeeLanes(NamedTuple):
    """What the NEE step reads of each of the ``n`` lanes of a depth."""

    sd: dict                   # shading data (ops/shade.py): (n,), (n, 3)
    hit_pos: torch.Tensor      # (n, 3)
    i_n: torch.Tensor          # (n, 3) shading normal, facing the ray
    n_geom: torch.Tensor       # (n, 3) geometric normal, facing the ray
    t_vec: torch.Tensor        # (n, 3) tangent
    b_vec: torch.Tensor        # (n, 3) bitangent
    direction: torch.Tensor    # (n, 3) the ray that hit
    throughput: torch.Tensor   # (n, 3) with the previous pdf applied
    alive: torch.Tensor        # (n,) bool
    spec_mat: torch.Tensor     # (n,) bool, below the minimum roughness
    alpha_cut: torch.Tensor    # (n,) bool
    pid: torch.Tensor          # (n,) int32 absolute pixel id


class ShadowRays(NamedTuple):
    """The NEE's shadow rays for the one occlusion launch: m = n light
    rays, then n envmap rays where the envmap is sampled (m = 2n)."""

    seed: torch.Tensor         # (n,) int64 lane seeds past the NEE's draws
    origin: torch.Tensor       # (m, 3)
    direction: torch.Tensor    # (m, 3)
    dist: torch.Tensor         # (m,) 0 where no ray is shot
    contrib: torch.Tensor      # (m, 3) radiance added if unoccluded
    want: torch.Tensor         # (m,) bool, the ray is shot


def env_nee_at(scene, config, depth: int) -> bool:
    """Whether a vertex at ``depth`` shoots an envmap NEE ray."""
    return (config.envmap_nee and config.variance_reduction
            and "skybox" in scene and "pdf" in scene["skybox"]
            and (config.envmap_nee_max_depth < 0
                 or depth <= config.envmap_nee_max_depth))


def lane_seed(pid, sample_index: int, depth: int):
    """The lane stream of (pixel, sample, depth), salted apart from the
    primary-ray stream."""
    return rng.wang_hash(rng.path_seed(pid.long(), sample_index, depth)
                         ^ SEED_SALT)


def scrub(x, mask, stats, config):
    """Zero NaN contributions; with ``config.debug_checks`` count the
    selected lanes that needed it in ``stats["nan_scrubbed"]``."""
    if config.debug_checks:
        bad = torch.isnan(x).any(-1) & mask
        stats["nan_scrubbed"] = stats.get("nan_scrubbed", 0) + bad.sum()
    return torch.where(torch.isnan(x), 0.0, x)


def sample_envmap(scene, r):
    """Inverse-CDF envmap sample: uniform r → (direction, pdf, radiance)."""
    sky = scene["skybox"]
    pix = sky["pixels"]
    h, w = pix.shape[0], pix.shape[1]
    idx = torch.clamp(torch.searchsorted(sky["flat_cdf"], r), 0, h * w - 1)
    y = idx // w
    x = idx % w
    u = (x.to(torch.float32) + 0.5) / w
    v = (y.to(torch.float32) + 0.5) / h
    phi = (2.0 * u - 1.0) * math.pi
    theta = v * math.pi
    sin_t = fmath.sin(theta)
    d = torch.stack([sin_t * fmath.sin(phi), fmath.cos(theta),
                     -sin_t * fmath.cos(phi)], dim=-1)
    return d, sky["pdf"][y, x], pix[y, x]


def _env_tile(config):
    """(tb, on): the side of the square image tile that shares one envmap
    sample, and whether samples are shared at all."""
    il = config.env_nee_interleave
    return max(int(round(il ** 0.5)), 1), il > 1


def nee_plain(scene, config, bsdf, lanes: NeeLanes, width: int,
              height: int | None, depth: int, sample_index: int,
              stats: dict) -> ShadowRays:
    """The NEE step in plain PyTorch, for any BSDF module ``bsdf``: sets
    ``stats["shadow_count"]`` (and, under ``debug_checks``, adds to
    ``stats["nan_scrubbed"]``)."""
    tracing.count("nee.plain")
    sd, hit_pos, i_n, n_geom = lanes.sd, lanes.hit_pos, lanes.i_n, lanes.n_geom
    t_vec, b_vec, direction = lanes.t_vec, lanes.b_vec, lanes.direction
    throughput, alive = lanes.throughput, lanes.alive
    spec_mat, alpha_cut = lanes.spec_mat, lanes.alpha_cut
    pid_l = lanes.pid.long()
    px, py = pid_l % width, pid_l // width
    clamp_v = float(config.firefly_clamp)
    lights = scene["lights"]
    bn = scene.get("blue_noise") if config.blue_noise else None
    seed = lane_seed(lanes.pid, sample_index, depth)

    if bn is not None:
        # a distinct blue-noise dimension pair per depth
        d0_, d1_ = 4 + 2 * depth, 5 + 2 * depth
        if bn.ndim == 3:
            brow = rng.blue_noise_shift_row(bn, px, py)
            nd = bn.shape[2]
            r0 = rng.blue_noise_from_shift(brow[:, d0_ % nd], sample_index,
                                           d0_)
            r1 = rng.blue_noise_from_shift(brow[:, d1_ % nd], sample_index,
                                           d1_)
        else:
            r0 = rng.blue_noise_sample(bn, px, py, sample_index, d0_)
            r1 = rng.blue_noise_sample(bn, px, py, sample_index, d1_)
        seed, (h0, h1) = rng.random_floats(seed, 2)
        if sample_index >= config.blue_noise_spp_cutoff:
            r0, r1 = h0, h1
    else:
        seed, (r0, r1) = rng.random_floats(seed, 2)
    ls = light_sampling.random_point_on_light(
        lights, r0, r1, hit_pos, i_n,
        importance_sample=config.importance_sample_lights)
    l_vec = ls["position"] - hit_pos
    dist = torch.sqrt(torch.clamp(dot3(l_vec, l_vec), min=1e-20))
    l_dir = l_vec / dist[..., None]
    n_dot_l = dot3(l_dir, i_n)
    s_val, s_pdf = bsdf.evaluate_bsdf(sd, i_n, t_vec, b_vec, -direction,
                                      l_dir)
    # MIS with BSDF sampling only for area lights
    denom = (torch.where(ls["is_delta"], 0.0, s_pdf)
             + ls["light_pdf"] * ls["pick_prob"])
    nee = (throughput * s_val * ls["radiance"]
           * (n_dot_l / torch.clamp(denom, min=1e-20))[..., None])
    want_shadow = (alive & ~spec_mat & ~alpha_cut & (n_dot_l > 0)
                   & (ls["light_pdf"] > 0) & (s_pdf > 0))
    nee = clamp_intensity(scrub(nee, want_shadow, stats, config), clamp_v)
    s_origin = safe_origin(hit_pos, n_geom)
    s_dist = torch.where(want_shadow,
                         dist - 2.0 * config.geometry_epsilon, 0.0)
    stats["shadow_count"] = want_shadow.sum()
    if not env_nee_at(scene, config, depth):
        return ShadowRays(seed, s_origin, l_dir, s_dist, nee, want_shadow)

    tb, shared = _env_tile(config)
    if shared:
        # interleaved sampling: one env sample per tb x tb image tile,
        # keyed by absolute pixel coords
        tiles_x = (width + tb - 1) // tb
        gid = (py // tb) * tiles_x + px // tb
        if height is not None:
            # evaluate the tile table once, gather per lane
            tiles_y = (height + tb - 1) // tb
            tid = torch.arange(tiles_x * tiles_y, device=pid_l.device)
            _, re_t = rng.random_float(rng.wang_hash(
                rng.path_seed(tid, sample_index, depth) ^ ENV_SALT))
            ed_t, ep_t, er_t = sample_envmap(scene, re_t)
            e_dir, e_pdf, e_rad = ed_t[gid], ep_t[gid], er_t[gid]
        else:
            _, re = rng.random_float(rng.wang_hash(
                rng.path_seed(gid, sample_index, depth) ^ ENV_SALT))
            e_dir, e_pdf, e_rad = sample_envmap(scene, re)
    else:
        seed, re = rng.random_float(seed)
        e_dir, e_pdf, e_rad = sample_envmap(scene, re)
    e_cos = dot3(e_dir, i_n)
    eb_val, eb_pdf = bsdf.evaluate_bsdf(sd, i_n, t_vec, b_vec, -direction,
                                        e_dir)
    e_contrib = (throughput * eb_val * e_rad
                 * (e_cos / torch.clamp(e_pdf + eb_pdf, min=1e-20))[..., None])
    e_want = (alive & ~spec_mat & ~alpha_cut & (e_cos > 0) & (e_pdf > 0)
              & (eb_pdf > 0))
    e_contrib = clamp_intensity(scrub(e_contrib, e_want, stats, config),
                                clamp_v)
    stats["shadow_count"] = stats["shadow_count"] + e_want.sum()
    return ShadowRays(seed, torch.cat([s_origin, s_origin]),
                      torch.cat([l_dir, e_dir]),
                      torch.cat([s_dist, torch.where(e_want, 1e30, 0.0)]),
                      torch.cat([nee, e_contrib]),
                      torch.cat([want_shadow, e_want]))


# the kernel's argument block, field for field csrc/nee_kernel.cu's
# NeeArgs: the pointers first, then the ints, then the floats
_P = ("pid", "hit_pos", "i_n", "n_geom", "direction", "throughput", "alive",
      "spec_mat", "alpha_cut", "color", "metallic", "subsurface", "specular",
      "roughness", "specular_tint", "clearcoat", "clearcoat_gloss",
      "transmission", "eta",
      "area_v0", "area_v1", "area_v2", "area_normal", "area_radiance",
      "area_area", "area_energy", "point_position", "point_radiance",
      "point_energy", "spot_position", "spot_direction", "spot_radiance",
      "spot_cos_inner", "spot_cos_outer", "spot_energy", "dir_direction",
      "dir_radiance", "dir_energy", "light_counts",
      "blue_noise", "flat_cdf", "sky_pdf", "sky_pixels",
      "seed_out", "origin_out", "direction_out", "dist_out", "contrib_out",
      "want_out", "counts_out")
_I = ("n", "width", "n_area", "n_point", "n_spot", "n_dir", "importance",
      "bn_size", "bn_dims", "bn_index0", "bn_index1", "bn_ox0", "bn_oy0",
      "bn_ox1", "bn_oy1", "hashed", "key", "env_mode", "tile", "tiles_x",
      "sky_w", "sky_h")
_F = ("bn_add0", "bn_add1", "clamp", "shadow_eps")


class NeeArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _P]
                + [(k, ctypes.c_int) for k in _I]
                + [(k, ctypes.c_float) for k in _F])


_SD_KEYS = ("color", "metallic", "subsurface", "specular", "roughness",
            "specular_tint", "clearcoat", "clearcoat_gloss", "transmission",
            "eta")
_LIGHT_KEYS = _P[_P.index("area_v0"):_P.index("light_counts")]
_M32 = 0xFFFFFFFF


def _seed_key(sample_index: int, depth: int) -> int:
    """The part of ``rng.path_seed`` that does not depend on the lane (or
    on the envmap tile): the kernel adds ``id * 16789`` to it modulo
    2**32."""
    return (((sample_index * 1791) & _M32)
            + ((depth * 720898027) & _M32)) & _M32


def _signed(u: int) -> int:
    """A uint32 word as the int32 with its bits, for a ``c_int`` field."""
    return u - (1 << 32) if u >= 1 << 31 else u


def nee(scene, config, bsdf, lanes: NeeLanes, width: int,
        height: int | None, depth: int, sample_index: int,
        stats: dict) -> ShadowRays:
    """The NEE step of BSDF module ``bsdf``: one launch of
    ``csrc/nee_kernel.cu`` for CUDA lanes under the Disney BSDF, equal to
    ``nee_plain`` bit for bit, else ``nee_plain``. Sets ``stats`` as
    ``nee_plain`` does."""
    if bsdf is not disney or not cuda_lib.kernel_device(lanes.pid, "nee"):
        return nee_plain(scene, config, bsdf, lanes, width, height, depth,
                         sample_index, stats)
    tracing.count("nee.kernel")
    dev, n = lanes.pid.device, lanes.pid.shape[0]
    f32, b8 = torch.float32, torch.bool
    lights = scene["lights"]
    env = env_nee_at(scene, config, depth)
    m = 2 * n if env else n
    vec = {k: getattr(lanes, k).contiguous()
           for k in ("hit_pos", "i_n", "n_geom", "direction", "throughput")}
    tensors = {"pid": (lanes.pid, torch.int32),
               **{k: (v, f32) for k, v in vec.items()},
               **{k: (getattr(lanes, k), b8)
                  for k in ("alive", "spec_mat", "alpha_cut")},
               **{k: (lanes.sd[k], f32) for k in _SD_KEYS},
               **{k: (lights[k], f32) for k in _LIGHT_KEYS},
               "light_counts": (lights["counts"], torch.int32)}
    args = NeeArgs(n=n, width=width,
                   importance=int(config.importance_sample_lights),
                   key=_signed(_seed_key(sample_index, depth)),
                   clamp=config.firefly_clamp,
                   shadow_eps=2.0 * config.geometry_epsilon)
    for k, kind in (("n_area", "area_v0"), ("n_point", "point_position"),
                    ("n_spot", "spot_position"), ("n_dir", "dir_direction")):
        setattr(args, k, lights[kind].shape[0])
        if lights[kind].shape[0] < 1:
            raise ValueError(f"nee kernel: no {kind} slot")
    bn = scene.get("blue_noise") if config.blue_noise else None
    if bn is not None:
        tensors["blue_noise"] = (bn, f32)
        args.bn_size = bn.shape[0]
        args.bn_dims = bn.shape[2] if bn.ndim == 3 else 1
        for j, d in enumerate((4 + 2 * depth, 5 + 2 * depth)):
            setattr(args, f"bn_add{j}", rng.r2_offset(sample_index, d))
            if bn.ndim == 3:
                setattr(args, f"bn_index{j}", d % bn.shape[2])
            else:
                ox, oy = rng.dim_offsets(d, bn.shape[0])
                setattr(args, f"bn_ox{j}", ox)
                setattr(args, f"bn_oy{j}", oy)
        args.hashed = int(sample_index >= config.blue_noise_spp_cutoff)
    if env:
        sky = scene["skybox"]
        tensors.update(flat_cdf=(sky["flat_cdf"], f32),
                       sky_pdf=(sky["pdf"], f32),
                       sky_pixels=(sky["pixels"], f32))
        args.sky_h, args.sky_w = sky["pixels"].shape[0], sky["pixels"].shape[1]
        tb, shared = _env_tile(config)
        # 1: a draw of the lane's seed; 2: the lane's image tile's stream
        args.env_mode = 2 if shared else 1
        args.tile, args.tiles_x = tb, (width + tb - 1) // tb
    cuda_lib.check_inputs(dev, **tensors)
    out = {"seed_out": torch.empty(n, dtype=torch.int64, device=dev),
           "origin_out": torch.empty((m, 3), dtype=f32, device=dev),
           "direction_out": torch.empty((m, 3), dtype=f32, device=dev),
           "dist_out": torch.empty(m, dtype=f32, device=dev),
           "contrib_out": torch.empty((m, 3), dtype=f32, device=dev),
           "want_out": torch.empty(m, dtype=b8, device=dev),
           "counts_out": torch.empty(2, dtype=torch.int64, device=dev)}
    for k, (t, _) in tensors.items():
        setattr(args, k, t.data_ptr())
    for k, t in out.items():
        setattr(args, k, t.data_ptr())
    with cuda_lib.launch(dev) as (lib, stream):
        cuda_lib.check(lib.rfw_nee(ctypes.addressof(args), stream),
                       "nee kernel")
    cuda_lib.launch_counts["nee"] += 1
    counts = out["counts_out"]
    stats["shadow_count"] = counts[0]
    if config.debug_checks:
        stats["nan_scrubbed"] = stats.get("nan_scrubbed", 0) + counts[1]
    return ShadowRays(out["seed_out"], out["origin_out"],
                      out["direction_out"], out["dist_out"],
                      out["contrib_out"], out["want_out"])


def add_unoccluded_plain(radiance, rays: ShadowRays, occ):
    """``radiance`` plus, in order, each block of n contributions whose ray
    is shot and not occluded."""
    n = radiance.shape[0]
    for k in range(0, rays.want.shape[0], n):
        hit = rays.want[k:k + n] & ~occ[k:k + n]
        radiance = radiance + torch.where(hit[..., None],
                                          rays.contrib[k:k + n], 0.0)
    return radiance


def add_unoccluded(radiance, rays: ShadowRays, occ):
    """``add_unoccluded_plain`` into a new (n, 3) tensor: for CUDA tensors
    one launch of ``csrc/nee_kernel.cu``'s second kernel, equal bit for
    bit. ``radiance`` may be a view with rows of any stride."""
    if not cuda_lib.kernel_device(radiance, "nee"):
        return add_unoccluded_plain(radiance, rays, occ)
    dev, n = radiance.device, radiance.shape[0]
    m = rays.want.shape[0]
    if radiance.dtype != torch.float32:
        raise TypeError(f"radiance has dtype {radiance.dtype}")
    if (radiance.shape != (n, 3) or radiance.stride(1) != 1
            or m not in (n, 2 * n) or occ.shape != (m,)
            or rays.contrib.shape != (m, 3)):
        raise ValueError("add_unoccluded: mismatched shapes")
    cuda_lib.check_inputs(dev, contrib=(rays.contrib, torch.float32),
                          want=(rays.want, torch.bool),
                          occ=(occ, torch.bool))
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    ptr = cuda_lib.ptr
    with cuda_lib.launch(dev) as (lib, stream):
        cuda_lib.check(lib.rfw_nee_add(
            ptr(radiance), radiance.stride(0), ptr(rays.contrib),
            ptr(rays.want), ptr(occ), n, m // n, ptr(out), stream),
            "nee add kernel")
    cuda_lib.launch_counts["nee_add"] += 1
    return out
