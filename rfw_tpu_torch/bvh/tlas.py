"""Two-level acceleration structure: a TLAS over instances, a BLAS per
mesh (port of ``rfw_tpu.bvh.tlas``), and the one two-level walk that
both this module's ``trace_tlas`` and the ``tlas`` intersector run.

The build is numpy, as the reference's: one object-space BLAS per mesh,
shared by every instance of it, and per instance the inverse matrix and
the world box of its BLAS's root box. Moving an instance refits only
those (``TLAS.refit``); no BLAS is rebuilt.

``walk`` takes the tables grouped per BLAS (one dict a BLAS: its node
and triangle tables and its instances' rows, ``group_instances``). Per
BLAS a premask slab-tests every (ray, instance) pair and keeps the
instances some ray crosses, front to back by their nearest entry; each
of those walks the BLAS with ``traverse_wide`` (the traversal kernel on
CUDA tensors, its plain version on CPU tensors), the rays that miss its
world box as dead lanes (``t_max`` 0), the others in object space (the
direction left unnormalised, so object t equals world t).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import traverse
from ..ops.intersect import BIG_T
from .builder import build_bvh, triangle_bounds
from .wide import WideBVH, collapse_wide


@dataclasses.dataclass
class BLAS:
    """One mesh's bottom-level structure, in object space."""

    wide: WideBVH
    v0: np.ndarray            # (T, 3), the build's triangle order
    e1: np.ndarray
    e2: np.ndarray
    prim_order: np.ndarray    # build order -> mesh-local triangle id
    bmin: np.ndarray          # (3,) object-space root box
    bmax: np.ndarray
    _tables: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    def arrays(self) -> dict:
        """The BLAS as the scene's numpy tables: the wide BVH, the
        triangles, ``prim_order`` (int32) and the root box."""
        w = self.wide
        return {"bmin": w.bmin, "bmax": w.bmax, "child": w.child,
                "count": w.count, "v0": self.v0, "e1": self.e1,
                "e2": self.e2, "prim_order": self.prim_order.astype(np.int32),
                "root_lo": self.bmin, "root_hi": self.bmax}

    def tables(self, device) -> dict:
        """``arrays()`` on ``device`` with the walk's derived tables
        (``walk_tables``), made once a device."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = walk_tables(
                {k: torch.from_numpy(v).to(device)
                 for k, v in self.arrays().items()})
        return self._tables[device]


def walk_tables(blas: dict) -> dict:
    """Adds the traversal kernel's tables to a BLAS dict of tensors, in
    place: ``traverse.node_table`` as "nodes" and ``traverse.tri_table``
    of (v0, e1, e2) as "tri_table". Returns the dict."""
    if "nodes" not in blas:
        blas["nodes"] = traverse.node_table(blas)
        blas["tri_table"] = traverse.tri_table(
            (blas["v0"], blas["e1"], blas["e2"]))
    return blas


def build_blas(vertices: np.ndarray, leaf_size: int = 4) -> BLAS:
    """The BLAS of object-space triangles ``vertices`` (T, 3, 3)."""
    tmin, tmax = triangle_bounds(vertices)
    bvh = build_bvh(tmin, tmax, leaf_size=leaf_size)
    wide = collapse_wide(bvh)
    perm = vertices[bvh.prim_order]
    return BLAS(
        wide=wide,
        v0=perm[:, 0].copy(),
        e1=(perm[:, 1] - perm[:, 0]).copy(),
        e2=(perm[:, 2] - perm[:, 0]).copy(),
        prim_order=bvh.prim_order,
        bmin=tmin.min(0), bmax=tmax.max(0),
    )


def box_world_aabb(bmin: np.ndarray, bmax: np.ndarray,
                   transform: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """World box of the object-space box (``bmin``, ``bmax``) under the
    4x4 ``transform``: the box of its 8 transformed corners."""
    corners = np.array([[x, y, z]
                        for x in (bmin[0], bmax[0])
                        for y in (bmin[1], bmax[1])
                        for z in (bmin[2], bmax[2])], np.float32)
    w = corners @ transform[:3, :3].T + transform[:3, 3]
    return w.min(0).astype(np.float32), w.max(0).astype(np.float32)


def instance_world_aabb(blas: BLAS, transform: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """World box of an instance of ``blas`` under ``transform``."""
    return box_world_aabb(blas.bmin, blas.bmax, transform)


def group_instances(n_blas: int, inst_blas, inst_inv, inst_bmin,
                    inst_bmax, inst_base) -> list[dict]:
    """Per-instance rows (in instance order) grouped under their BLAS:
    one dict a BLAS with its instances' "inst_inv" (k, 4, 4), "inst_bmin"
    and "inst_bmax" (k, 3) and "inst_base" (k,) int32, the offset of each
    instance's triangles in the flattened input order, in instance
    order."""
    inst_blas = np.asarray(inst_blas)
    out = []
    for b in range(n_blas):
        idx = np.flatnonzero(inst_blas == b)
        out.append({"inst_inv": inst_inv[idx],
                    "inst_bmin": inst_bmin[idx].astype(np.float32),
                    "inst_bmax": inst_bmax[idx].astype(np.float32),
                    "inst_base": np.asarray(inst_base)[idx]
                    .astype(np.int32)})
    return out


@dataclasses.dataclass
class TLAS:
    """The instances over their shared BLASes."""

    blas_list: list[BLAS]
    inst_blas: np.ndarray       # (I,) int32 BLAS of each instance
    inst_inv: np.ndarray        # (I, 4, 4) world -> object
    inst_bmin: np.ndarray       # (I, 3) world boxes
    inst_bmax: np.ndarray       # (I, 3)

    def refit(self, transforms: np.ndarray) -> None:
        """New instance matrices: the inverses (in the matrices' own
        precision, as rfw_tpu's TLAS) and world boxes only."""
        for i in range(len(self.inst_blas)):
            m = transforms[i]
            self.inst_inv[i] = np.linalg.inv(m)
            lo, hi = instance_world_aabb(self.blas_list[self.inst_blas[i]], m)
            self.inst_bmin[i], self.inst_bmax[i] = lo, hi

    def tables(self, device) -> tuple[dict, torch.Tensor]:
        """``walk``'s tables on ``device`` (the BLASes' cached tables,
        the instance rows as they stand) and the first flattened triangle
        of each instance (I,), the instances' triangles laid end to end
        in instance order."""
        counts = [self.blas_list[b].v0.shape[0] for b in self.inst_blas]
        base = np.cumsum([0] + counts[:-1]).astype(np.int32)
        blas = []
        for b, rows in zip(self.blas_list, group_instances(
                len(self.blas_list), self.inst_blas, self.inst_inv,
                self.inst_bmin, self.inst_bmax, base)):
            if rows["inst_base"].size:
                blas.append({**b.tables(device), **{
                    k: torch.from_numpy(v).to(device)
                    for k, v in rows.items()}})
        return {"blas": tuple(blas)}, torch.from_numpy(base).to(device)


def build_tlas(meshes: list[np.ndarray],
               instances: list[tuple[int, np.ndarray]]) -> TLAS:
    """``meshes``: (T, 3, 3) vertex arrays; ``instances``: (mesh index,
    4x4 transform) pairs."""
    blas_list = [build_blas(v) for v in meshes]
    n = len(instances)
    inst_blas = np.array([m for m, _ in instances], np.int32)
    tl = TLAS(blas_list, inst_blas, np.zeros((n, 4, 4), np.float32),
              np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32))
    tl.refit(np.stack([t for _, t in instances]))
    return tl


def safe_inv_box_dir(d):
    """1 / d with components below 1e-12 in magnitude set to 1e-12: the
    TLAS's own box-test reciprocal (not ``safe_inv_dir``)."""
    return 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)


def box_hit(lo, hi, o, inv_d, cap):
    """Rays (R, 3) against boxes (..., 3) broadcast over them: the closed
    slab test ``tfar >= max(tnear, 0) & tnear < cap``, NaN carried
    through the minima and maxima. Returns (hit, tnear)."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tn = torch.minimum(t1, t2).amax(-1)
    tf = torch.maximum(t1, t2).amin(-1)
    return (tf >= torch.clamp(tn, min=0.0)) & (tn < cap), tn


def to_object(inv, o, d):
    """Rays into object space under the world -> object matrix ``inv``
    (4, 4), as fixed-order elementwise sums, so that the card and the CPU
    make the same rays; the direction is not normalised."""
    o_obj = torch.stack([o[:, 0] * inv[k, 0] + o[:, 1] * inv[k, 1]
                         + o[:, 2] * inv[k, 2] + inv[k, 3]
                         for k in range(3)], dim=-1)
    d_obj = torch.stack([d[:, 0] * inv[k, 0] + d[:, 1] * inv[k, 1]
                         + d[:, 2] * inv[k, 2] for k in range(3)], dim=-1)
    return o_obj, d_obj


def walk(tables: dict, o, d, t_max, t_epsilon: float,
         any_hit: bool = False, ray_chunk: int = 65536):
    """The two-level walk of rays (R, 3) over ``tables`` ({"blas": one
    dict a BLAS}, each with ``walk_tables``' tables, "prim_order" and its
    instances' rows), BLAS by BLAS, as rfw_tpu's ``tlas`` intersector: a
    premask slab-tests every (ray, instance) pair of the BLAS
    (``ray_chunk`` rays at a time) and keeps the instances some ray
    crosses, ordered front to back by their nearest entry (a stable
    sort, so ties keep instance order); each of those is walked in turn.
    A walk culls the rays that miss the instance's world box (or, for
    any hit, already hit) to dead lanes, ``t_max`` 0, which the traversal
    kernel writes without a walk: the reference skips an instance no ray
    enters, and here a launch of dead lanes changes nothing, so no host
    sync an instance is needed. One host read a BLAS and call: the
    touched instances. ``t_max`` is a number or one bound a ray.

    Returns (t, orig, u, v): ``orig`` the hit triangle in the flattened
    input order (``inst_base + prim_order[prim]``), -1 where none, and t
    the ray's ``t_max`` there."""
    n = o.shape[0]
    best_t = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=o.device), (n,)).clone()
    best_orig = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros(n, device=o.device)
    best_v = torch.zeros(n, device=o.device)
    inv_d = safe_inv_box_dir(d)
    for blas in tables["blas"]:
        lo_all, hi_all = blas["inst_bmin"], blas["inst_bmax"]
        # premask: does any ray cross instance i, and its nearest entry
        # over the crossing rays
        cross = torch.zeros(lo_all.shape[0], dtype=torch.bool,
                            device=o.device)
        tn_min = torch.full((lo_all.shape[0],), BIG_T, device=o.device)
        for s in range(0, n, ray_chunk):
            sl = slice(s, s + ray_chunk)
            hit, tn = box_hit(lo_all, hi_all, o[sl, None], inv_d[sl, None],
                              best_t[sl, None])
            cross |= hit.any(0)
            tn_min = torch.minimum(tn_min, torch.where(
                hit, torch.clamp(tn, min=0.0), BIG_T).amin(0))
        order = torch.argsort(torch.where(cross, tn_min, torch.inf),
                              stable=True)
        # one read: the touched instances lead the order
        ids, flags = torch.stack([order, cross[order].long()]).tolist()
        for i in ids[:sum(flags)]:
            hit_box, _ = box_hit(lo_all[i], hi_all[i], o, inv_d, best_t)
            if any_hit:
                hit_box &= best_orig < 0
            o_obj, d_obj = to_object(blas["inst_inv"][i], o, d)
            t_i, prim_i, u_i, v_i = traverse.traverse_wide(
                o_obj, d_obj, blas, blas["tri_table"],
                leaf_size=traverse.LEAF_SIZE,
                t_max=torch.where(hit_box, best_t, 0.0),
                t_epsilon=t_epsilon, any_hit=any_hit)
            better = (prim_i >= 0) & (t_i < best_t)
            orig = blas["inst_base"][i] + blas["prim_order"][
                torch.clamp(prim_i, min=0).long()]
            best_t = torch.where(better, t_i, best_t)
            best_orig = torch.where(better, orig, best_orig)
            best_u = torch.where(better, u_i, best_u)
            best_v = torch.where(better, v_i, best_v)
    return best_t, best_orig, best_u, best_v


def trace_tlas(tlas: TLAS, origins, directions, t_epsilon: float = 1e-4):
    """Two-level closest hit of rays (R, 3) through ``walk``. Returns (t,
    instance, prim, u, v), t in world units, prim mesh-local; t = BIG_T
    and instance = prim = -1 on a miss. Of two hits at the same t the
    one walked first wins: ``walk`` goes front to back, rfw_tpu's
    ``trace_tlas`` in instance order."""
    tables, base = tlas.tables(origins.device)
    t, orig, u, v = walk(tables, origins, directions, BIG_T, t_epsilon)
    hit = orig >= 0
    inst = torch.searchsorted(base, orig, right=True).int() - 1
    inst = torch.where(hit, inst, -1)
    prim = torch.where(hit, orig - base[torch.clamp(inst, min=0).long()], -1)
    return t, inst, prim, u, v
