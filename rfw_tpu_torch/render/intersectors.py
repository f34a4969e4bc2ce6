"""Intersectors pluggable into the integrator (port of
``rfw_tpu.render.intersectors``).

* ``bvh`` — per-ray stack traversal of the 4-wide BVH (ops/traverse.py),
  a hand-written CUDA kernel; the default of every engine but
  ``wavefront``.
* ``visit`` — the visit-list intersector (ops/visit_intersect.py), whose
  kernels are hand-written CUDA; the wavefront engine's default.
* ``tvisit`` — the sub-cell variant (ops/tvisit_intersect.py): scattered
  streams walk per-128-ray lists of K/4-triangle child cells; coherent
  streams go to ``visit``. Needs ``config.subcell_tables``.
* ``brute`` — O(R·T) dense and exact; the oracle for tiny scenes.
* ``dense`` — every ray against every cell slot's Woop matrix, plain
  torch; an oracle for tiny scenes.
* ``tlas`` — the two-level path (``bvh.tlas.walk``): per BLAS a premask
  of its instances' world boxes, then each ray's walk of the touched
  instances, in object space over their shared BLAS; two hand-written
  CUDA kernels a BLAS, no host read. Needs ``config.use_tlas``.
"""

from __future__ import annotations

import torch

from ..bvh import tlas
from ..config import RenderConfig
from ..ops import traverse, tvisit_intersect, visit_intersect
from ..ops.intersect import BIG_T, closest_hit_woop, intersect_woop
from ..utils import tracing
from .integrator import Intersector


def _tris_from_scene(scene):
    return traverse.tri_edges(scene["tri_vertices"])


def make_brute_intersector(config: RenderConfig) -> Intersector:
    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        with tracing.span("isect.closest"):
            t, prim, u, v = traverse.brute_force_closest(
                o, d, _tris_from_scene(scene), t_epsilon=config.t_epsilon)
            if t_max is not None:
                prim = torch.where(t < t_max, prim, -1)
                t = torch.where(prim >= 0, t, BIG_T)
            return t, prim, u, v

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        with tracing.span("isect.occluded"):
            t, prim, _, _ = traverse.brute_force_closest(
                o, d, _tris_from_scene(scene), t_epsilon=config.t_epsilon)
            return (prim >= 0) & (t < dist)

    return Intersector(closest, occluded)


def make_bvh_intersector(config: RenderConfig,
                         leaf_size: int = traverse.LEAF_SIZE) -> Intersector:
    """Over the scene's derived triangle table ("tri_table"): no edges
    or copies are made per call."""
    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        with tracing.span("isect.closest"):
            return traverse.traverse_wide(
                o, d, scene["bvh"], scene["tri_table"],
                leaf_size=leaf_size, t_epsilon=config.t_epsilon, t_max=t_max)

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        with tracing.span("isect.occluded"):
            _, prim, _, _ = traverse.traverse_wide(
                o, d, scene["bvh"], scene["tri_table"],
                leaf_size=leaf_size, t_max=dist, t_epsilon=config.t_epsilon,
                any_hit=True)
            return prim >= 0

    return Intersector(closest, occluded)


def dense_woop(tl):
    """The (T_pad, 3, 4) Woop matrix of every cell slot, read back from
    rows 0-11 of the cell plane blocks ``wplanes`` (the exact inverse of
    the build's ``_woop_planes``), so it follows every refit."""
    wp = tl["wplanes"]
    n_cells, _, k = wp.shape
    return wp[:, :12].reshape(n_cells, 3, 4, k).permute(0, 3, 1, 2) \
        .reshape(-1, 3, 4)


def make_dense_intersector(config: RenderConfig) -> Intersector:
    """Every ray against every cell slot, with a Möller–Trumbore refine
    of the winner: exact, and economical for tiny scenes only."""
    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        with tracing.span("isect.closest"):
            tl = scene["treelets"]
            woop = dense_woop(tl)
            t, slot, u, v = closest_hit_woop(
                o, d, woop, torch.arange(woop.shape[0], device=woop.device),
                t_epsilon=config.t_epsilon, tri_verts=tl["verts"],
                t_max=BIG_T if t_max is None else t_max)
            prim = torch.where(
                slot >= 0, tl["slot_to_prim"][torch.clamp(slot, min=0)], -1)
            return torch.where(prim >= 0, t, BIG_T), prim, u, v

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        with tracing.span("isect.occluded"):
            hit, t, _, _ = intersect_woop(o, d, dense_woop(scene["treelets"]),
                                          t_epsilon=config.t_epsilon)
            return (hit & (t < dist[:, None])).any(dim=-1)

    return Intersector(closest, occluded)


def make_visit_intersector(config: RenderConfig) -> Intersector:
    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        with tracing.span("isect.closest"):
            return visit_intersect.closest_hit(
                scene, o, d, config, t_max=t_max, sort=sort,
                coherent=coherent)

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        with tracing.span("isect.occluded"):
            return visit_intersect.any_hit(scene, o, d, dist, config,
                                           sort=sort, coherent=coherent)

    return Intersector(closest, occluded)


def make_tvisit_intersector(config: RenderConfig) -> Intersector:
    """Scattered streams (bounces, every occlusion launch the integrator
    marks incoherent) walk the tvisit kernel's child lists; coherent ones
    (primary tiles) go to the visit kernel, whose per-block unions are
    already small there."""
    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        with tracing.span("isect.closest"):
            mod = visit_intersect if coherent else tvisit_intersect
            return mod.closest_hit(scene, o, d, config, t_max=t_max,
                                   sort=sort, coherent=coherent)

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        with tracing.span("isect.occluded"):
            mod = visit_intersect if coherent else tvisit_intersect
            return mod.any_hit(scene, o, d, dist, config, sort=sort,
                               coherent=coherent)

    return Intersector(closest, occluded)


# rays a slab pass of the plain premask takes at once (the CPU path):
# bounds its (rays x instances) transient; tests shrink it to run the
# multi-chunk path
_TLAS_RAY_CHUNK = 65536


def make_tlas_intersector(config: RenderConfig) -> Intersector:
    """The two-level TLAS/BLAS walk over ``scene["tlas"]``
    (``bvh.tlas.walk``; on the CPU ``_TLAS_RAY_CHUNK`` rays a premask
    pass); a hit maps through ``orig_to_perm`` from the flattened input
    order into the build's order of the shading planes, so shading is
    that of the flat intersectors."""
    eps = config.t_epsilon

    def _loop(scene, o, d, t_max, any_hit: bool):
        tl = scene["tlas"]
        t, orig, u, v = tlas.walk(tl, o, d, t_max, eps, any_hit=any_hit,
                                  ray_chunk=_TLAS_RAY_CHUNK)
        flat = torch.where(orig >= 0, tl["orig_to_perm"][
            torch.clamp(orig, min=0).long()], -1)
        return t, flat, u, v

    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        with tracing.span("isect.closest"):
            t, prim, u, v = _loop(scene, o, d,
                                  BIG_T if t_max is None else t_max,
                                  any_hit=False)
            return torch.where(prim >= 0, t, BIG_T), prim, u, v

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        with tracing.span("isect.occluded"):
            _, prim, _, _ = _loop(scene, o, d, dist, any_hit=True)
            return prim >= 0

    return Intersector(closest, occluded)


FACTORIES = {
    "brute": make_brute_intersector,
    "bvh": make_bvh_intersector,
    "dense": make_dense_intersector,
    "visit": make_visit_intersector,
    "tvisit": make_tvisit_intersector,
    "tlas": make_tlas_intersector,
}


def make_intersector(name: str, config: RenderConfig) -> Intersector:
    if name not in FACTORIES:
        raise ValueError(f"unknown intersector {name!r}; available: "
                         f"{sorted(FACTORIES)}")
    return FACTORIES[name](config)
