"""The BSDF extension of one depth (the last step of
``render/integrator.py::depth_stage``): each lane samples its BSDF for
the next direction, Russian roulette may end it, and the next ray's state
is set; alpha-cut lanes pass straight through their surface.

``extend`` makes the kernel-or-plain choice: it runs
``csrc/extend_kernel.cu`` (one thread a lane) for CUDA lanes under the
Disney BSDF, and ``extend_plain`` for CPU lanes and every other BSDF; the
two agree bit for bit on the same CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import tracing
from . import cuda_lib, rng
from .bsdf import disney
from .bsdf.common import dot3, safe_origin, survival_probability


class ExtendLanes(NamedTuple):
    """What the extension reads of each of the ``n`` lanes of a depth."""

    sd: dict                   # shading data (ops/shade.py): (n,), (n, 3)
    hit_pos: torch.Tensor      # (n, 3)
    i_n: torch.Tensor          # (n, 3) shading normal, facing the ray
    n_geom: torch.Tensor       # (n, 3) geometric normal, facing the ray
    t_vec: torch.Tensor        # (n, 3) tangent
    b_vec: torch.Tensor        # (n, 3) bitangent
    direction: torch.Tensor    # (n, 3) the ray that hit
    t: torch.Tensor            # (n,) its hit distance
    backfacing: torch.Tensor   # (n,) bool, the ray hit a back face
    throughput: torch.Tensor   # (n, 3) with the previous pdf applied
    throughput_predpdf: torch.Tensor  # (n, 3) before it
    last_pdf: torch.Tensor     # (n,)
    last_n: torch.Tensor       # (n, 3)
    spec_bounce: torch.Tensor  # (n,) bool
    alive: torch.Tensor        # (n,) bool
    alpha_cut: torch.Tensor    # (n,) bool
    spec_mat: torch.Tensor     # (n,) bool, below the minimum roughness


def extend_plain(config, bsdf, lanes: ExtendLanes, seed, state):
    """The extension in plain PyTorch, for any BSDF module ``bsdf``, from
    the lane seeds ``seed`` ((n,) int64) the NEE left. Returns ``state``
    (the path state, whose radiance and pid carry over) with the next
    ray's fields."""
    tracing.count("extend.plain")
    (sd, hit_pos, i_n, n_geom, t_vec, b_vec, direction, t, backfacing,
     throughput, throughput_predpdf, last_pdf, last_n, spec_bounce, alive,
     alpha_cut, spec_mat) = lanes
    seed, (r3, r4) = rng.random_floats(seed, 2)
    b_val, wi, new_pdf, _ = bsdf.sample_bsdf(
        sd, i_n, n_geom, t_vec, b_vec, -direction, t, backfacing, r3, r4)
    new_throughput = throughput * b_val * dot3(i_n, wi).abs()[..., None]
    if config.russian_roulette:
        survival = torch.clamp(survival_probability(throughput), 1e-6, 1.0)
        seed, rr = rng.random_float(seed)
        alive = alive & ((rr <= survival) | alpha_cut)
        new_throughput = new_throughput / survival[..., None]
    valid = ((new_pdf > 1e-6) & ~torch.isnan(new_pdf)
             & (new_throughput >= 0.0).all(-1)
             & ~torch.isnan(new_throughput).any(-1))
    alive = alive & (valid | alpha_cut)
    # alpha-cut lanes pass straight through the surface
    ac = alpha_cut[..., None]
    return state._replace(
        origin=torch.where(ac, hit_pos + direction * config.geometry_epsilon,
                           safe_origin(hit_pos, n_geom)),
        direction=torch.where(ac, direction, wi),
        throughput=torch.where(ac, throughput_predpdf, new_throughput),
        last_pdf=torch.where(alpha_cut, last_pdf, new_pdf),
        spec_bounce=torch.where(alpha_cut, spec_bounce, spec_mat),
        last_n=torch.where(ac, last_n, i_n),
        alive=alive)


# the kernel's argument block, field for field csrc/extend_kernel.cu's
# ExtendArgs: the pointers first, then the ints, then the floats
_SD_KEYS = ("color", "absorption", "metallic", "subsurface", "specular",
            "roughness", "specular_tint", "clearcoat", "clearcoat_gloss",
            "transmission", "eta")
_VEC = ("hit_pos", "i_n", "n_geom", "t_vec", "b_vec", "direction")
_STATE = ("t", "throughput", "throughput_predpdf", "last_pdf", "last_n")
_FLAGS = ("spec_bounce", "alive", "alpha_cut", "spec_mat", "backfacing")
_OUT = ("origin", "direction", "throughput", "last_pdf", "last_n",
        "spec_bounce", "alive")
_P = ("seed", *_SD_KEYS, *_VEC, *_STATE, *_FLAGS,
      *(f"{k}_out" for k in _OUT))
_I = ("n", "russian_roulette")
_F = ("geometry_epsilon",)


class ExtendArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _P]
                + [(k, ctypes.c_int) for k in _I]
                + [(k, ctypes.c_float) for k in _F])


def extend_kernel(config, lanes: ExtendLanes, seed, state):
    """``extend_plain`` under the Disney BSDF as one launch of
    ``csrc/extend_kernel.cu`` on CUDA tensors, equal bit for bit."""
    tracing.count("extend.kernel")
    dev, n = lanes.i_n.device, lanes.i_n.shape[0]
    f32, b8 = torch.float32, torch.bool
    inputs = {"seed": (seed, torch.int64),
              **{k: (lanes.sd[k].contiguous(), f32) for k in _SD_KEYS},
              **{k: (getattr(lanes, k).contiguous(), f32)
                 for k in (*_VEC, *_STATE)},
              **{k: (getattr(lanes, k).contiguous(), b8) for k in _FLAGS}}
    cuda_lib.check_inputs(dev, **inputs)
    out = {k: torch.empty((n, 3), dtype=f32, device=dev)
           for k in ("origin", "direction", "throughput", "last_n")}
    out["last_pdf"] = torch.empty(n, dtype=f32, device=dev)
    out.update({k: torch.empty(n, dtype=b8, device=dev)
                for k in ("spec_bounce", "alive")})
    args = ExtendArgs(n=n, russian_roulette=int(config.russian_roulette),
                      geometry_epsilon=config.geometry_epsilon)
    for k, (t, _) in inputs.items():
        setattr(args, k, t.data_ptr())
    for k, t in out.items():
        setattr(args, f"{k}_out", t.data_ptr())
    with cuda_lib.launch(dev) as (lib, stream):
        cuda_lib.check(lib.rfw_extend(ctypes.addressof(args), stream),
                       "extend kernel")
    cuda_lib.launch_counts["extend"] += 1
    return state._replace(**out)


def extend(config, bsdf, lanes: ExtendLanes, seed, state):
    """The extension of BSDF module ``bsdf``: ``extend_kernel`` for CUDA
    lanes under the Disney BSDF, else ``extend_plain``."""
    if bsdf is not disney or not cuda_lib.kernel_device(lanes.i_n, "extend"):
        return extend_plain(config, bsdf, lanes, seed, state)
    return extend_kernel(config, lanes, seed, state)
