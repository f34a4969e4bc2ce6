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
instances some ray crosses, front to back by their nearest entry, and
lists the rays that cross any box; each listed ray then walks those
instances whose world box it enters below its best t, in object space
(the direction left unnormalised, so object t equals world t). On CUDA
tensors that is two hand-written kernels a BLAS (``csrc/tlas_kernel.cu``:
``premask`` and ``walk_group``, with the visit order sorted on the
device between them), and nothing is read to the host; on CPU tensors
``walk_ref``, which reads the touched instances and walks each with the
traversal's plain version. ``premask_ref`` and ``walk_group_ref`` are
the two kernels' plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..ops import cuda_lib, traverse
from ..ops.cuda_lib import check_inputs, launch_counts, ptr
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


def premask_ref(lo, hi, o, inv_d, best_t, t_epsilon: float, orig=None,
                ray_chunk: int = 65536):
    """The premask of one BLAS's instances, boxes ``lo``, ``hi`` (k, 3),
    over rays ``o`` (R, 3) with the box reciprocals ``inv_d``
    (``safe_inv_box_dir``): per instance, does any ray cross its box
    (``box_hit`` below the ray's ``best_t``), and the least max(tnear, 0)
    over the crossing rays, BIG_T where none does; ``ray_chunk`` rays a
    slab pass. ``+ 0.0`` makes a -0.0 entry +0.0, as the kernel's bits
    order it. Per ray, whether it walks: it crosses some box, its
    ``best_t`` exceeds ``t_epsilon`` and, where ``orig`` (the state's
    hits, given for any hit) is given, it has no hit yet (``orig < 0``).
    A ray that crosses a box with a dead bound (``best_t`` 0, its origin
    inside the box) counts in ``cross`` and ``tn_min`` and does not walk.

    Returns (cross (k,) bool, tn_min (k,) float32, lanes (R,) int32,
    n_lanes (1,) int32): ``lanes`` holds the walking rays, ascending, in
    its first ``n_lanes`` entries and the others, ascending, after them.
    """
    n = o.shape[0]
    cross = torch.zeros(lo.shape[0], dtype=torch.bool, device=o.device)
    tn_min = torch.full((lo.shape[0],), BIG_T, device=o.device)
    walks = torch.zeros(n, dtype=torch.bool, device=o.device)
    for s in range(0, n, ray_chunk):
        sl = slice(s, s + ray_chunk)
        hit, tn = box_hit(lo, hi, o[sl, None], inv_d[sl, None],
                          best_t[sl, None])
        cross |= hit.any(0)
        walks[sl] = hit.any(1)
        tn_min = torch.minimum(tn_min, torch.where(
            hit, torch.clamp(tn, min=0.0) + 0.0, BIG_T).amin(0))
    walks &= best_t > t_epsilon
    if orig is not None:
        walks &= orig < 0
    lanes = torch.cat([walks.nonzero()[:, 0], (~walks).nonzero()[:, 0]])
    return (cross, tn_min, lanes.int(),
            walks.sum(dtype=torch.int32).reshape(1))


def visit_order(cross, tn_min):
    """The instances some ray crosses first, front to back by their
    nearest entry (a stable sort, so ties keep instance order), and how
    many they are, both left on the device: (order (k,) int32, count
    (1,) int32)."""
    order = torch.argsort(torch.where(cross, tn_min, torch.inf), stable=True)
    return order.int(), cross.sum(dtype=torch.int32).reshape(1)


def start_state(o, t_max) -> tuple:
    """A walk's state before the first BLAS: (t_max a ray, orig -1, u 0,
    v 0). ``t_max`` is a number or a tensor broadcast to the rays; a
    number is filled on the device, with no copy from the host."""
    n, dev = o.shape[0], o.device
    if torch.is_tensor(t_max):
        best_t = torch.broadcast_to(t_max.to(device=dev, dtype=torch.float32),
                                    (n,)).contiguous()
    else:
        best_t = torch.full((n,), float(t_max), device=dev)
    return (best_t, torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros(n, device=dev), torch.zeros(n, device=dev))


def walk_ref(tables: dict, o, d, t_max, t_epsilon: float,
             any_hit: bool = False, ray_chunk: int = 65536):
    """The plain version of ``walk``, with one host read a BLAS: per
    BLAS ``premask_ref`` and the touched instances read in their visit
    order, each walked in turn with ``traverse_wide`` (the traversal
    kernel on CUDA tensors, its plain version on CPU tensors). A walk
    culls the rays that miss the instance's world box (or, for any hit,
    already hit) to dead lanes, ``t_max`` 0, which the traversal writes
    without a walk."""
    best_t, best_orig, best_u, best_v = start_state(o, t_max)
    inv_d = safe_inv_box_dir(d)
    for blas in tables["blas"]:
        lo_all, hi_all = blas["inst_bmin"], blas["inst_bmax"]
        cross, tn_min, _, _ = premask_ref(lo_all, hi_all, o, inv_d, best_t,
                                          t_epsilon, ray_chunk=ray_chunk)
        order, count = visit_order(cross, tn_min)
        # one read: the touched instances lead the order
        touched, *ids = torch.cat([count, order]).tolist()
        for i in ids[:touched]:
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


def walk_group_ref(rows: dict, o, d, state, order, count, t_epsilon: float,
                   any_hit: bool = False, stats: dict | None = None):
    """The plain version of ``tlas_walk_kernel``: rays (R, 3) from
    ``state`` = (t, orig, u, v) over the BLAS group ``rows`` (its tables
    and its instances' rows), entry q of ``order`` for every q below
    ``count`` (read on the device, as the kernel reads it), each ray
    walking instance ``order[q]`` where its box is hit below the ray's
    best t (any hit: only while the ray has no hit), in object space
    with ``traverse_wide_ref``. Every ray takes part: the kernel's list
    of lanes (``premask``) is not read, so the rays it leaves out must
    come out as they went in. Returns the new state. ``stats``, when
    given, receives ``traverse_wide_ref``'s counts over the walks
    (visits, tests, node_seen, tri_seen, longest), ``box_tests`` (the
    (ray, instance) box tests of the rays that walk, the ones the kernel
    runs over the list), ``box_tests_every_ray`` (those of every ray, as
    a thread a ray over all of them tests), ``walks`` (the (ray,
    instance) walks, each a transform) and ``walked`` (R,), the rays
    that walked at least once."""
    best_t, best_orig, best_u, best_v = state
    inv_d = safe_inv_box_dir(d)
    walked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    ray_tests = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    for q in range(order.shape[0]):
        i = order[q].long()
        tested = torch.broadcast_to(count > q, best_orig.shape)
        if any_hit:
            tested = tested & (best_orig < 0)
        hit_box, _ = box_hit(rows["inst_bmin"][i], rows["inst_bmax"][i], o,
                             inv_d, best_t)
        hit_box &= tested
        o_obj, d_obj = to_object(rows["inst_inv"][i], o, d)
        t_max = torch.where(hit_box, best_t, 0.0)
        t_i, prim_i, u_i, v_i = traverse.traverse_wide_ref(
            o_obj, d_obj, rows, rows["tri_table"],
            leaf_size=traverse.LEAF_SIZE, t_max=t_max, t_epsilon=t_epsilon,
            any_hit=any_hit, stats=stats)
        if stats is not None:
            walks = t_max > t_epsilon
            ray_tests += tested
            stats["walks"] = stats.get("walks", 0) + int(walks.sum())
            walked |= walks
        better = (prim_i >= 0) & (t_i < best_t)
        orig = rows["inst_base"][i] + rows["prim_order"][
            torch.clamp(prim_i, min=0).long()]
        best_t = torch.where(better, t_i, best_t)
        best_orig = torch.where(better, orig, best_orig)
        best_u = torch.where(better, u_i, best_u)
        best_v = torch.where(better, v_i, best_v)
    if stats is not None:
        stats["box_tests"] = stats.get("box_tests", 0) + int(
            ray_tests[walked].sum())
        stats["box_tests_every_ray"] = stats.get(
            "box_tests_every_ray", 0) + int(ray_tests.sum())
        stats["walked"] = stats.get("walked", walked) | walked
    return best_t, best_orig, best_u, best_v


def _check_shape(name, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def group_buffers(rows: dict, device=None) -> tuple:
    """The tensors of a BLAS group that ``tlas_walk_kernel`` reads, in
    its argument order: "inst_bmin", "inst_bmax" (k, 3) float32,
    "inst_inv" (k, 4, 4) float32 (row r of instance i at 16 i + 4 r),
    "inst_base" (k,) int32, "nodes" (N, 8, 4) float32, "tri_table" (T,
    3, 4) float32 and "prim_order" (T,) int32, each checked (on
    ``device``, by default the nodes'), none converted: the refreshed
    rows of an instance move are read as they stand."""
    k = rows["inst_base"].shape[0]
    n_tri = rows["tri_table"].shape[0]
    want = (("inst_bmin", torch.float32, (k, 3)),
            ("inst_bmax", torch.float32, (k, 3)),
            ("inst_inv", torch.float32, (k, 4, 4)),
            ("inst_base", torch.int32, (k,)),
            ("nodes", torch.float32, (rows["nodes"].shape[0], 8, 4)),
            ("tri_table", torch.float32, (n_tri, 3, 4)),
            ("prim_order", torch.int32, (n_tri,)))
    for name, dtype, shape in want:
        _check_shape(name, rows[name], shape)
    check_inputs(rows["nodes"].device if device is None else device,
                 **{name: (rows[name], dtype) for name, dtype, _ in want})
    return tuple(rows[name] for name, _, _ in want)


def _rays(o, d):
    n = o.shape[0]
    _check_shape("origins", o, (n, 3))
    _check_shape("directions", d, (n, 3))
    return n, o.contiguous(), d.contiguous()


def premask(lo, hi, o, d, best_t, t_epsilon: float, orig=None,
            ray_chunk: int = 65536):
    """``premask_ref`` of the boxes ``lo``, ``hi`` (k, 3) over rays (R,
    3) below ``best_t`` (R,), with ``orig`` (R,) int32 for any hit:
    ``tlas_premask_kernel`` on CUDA tensors (one thread a ray over every
    box; ``ray_chunk`` is not needed), the plain version on CPU tensors.
    Returns (cross (k,) bool, tn_min (k,) float32, lanes (R,) int32,
    n_lanes (1,) int32). The kernel's ``lanes`` is a permutation of the
    rays, the walking ones in its first ``n_lanes`` entries, each part in
    an order that may change from run to run; ``n_lanes`` stays on the
    device."""
    if not cuda_lib.kernel_device(o, "tlas"):
        return premask_ref(lo, hi, o, safe_inv_box_dir(d), best_t, t_epsilon,
                           orig, ray_chunk)
    dev = o.device
    n, o, d = _rays(o, d)
    k = lo.shape[0]
    _check_shape("inst_bmin", lo, (k, 3))
    _check_shape("inst_bmax", hi, (k, 3))
    _check_shape("best_t", best_t, (n,))
    check_inputs(dev, origins=(o, torch.float32),
                 directions=(d, torch.float32),
                 best_t=(best_t, torch.float32),
                 inst_bmin=(lo, torch.float32), inst_bmax=(hi, torch.float32))
    if orig is not None:
        _check_shape("orig", orig, (n,))
        check_inputs(dev, orig=(orig, torch.int32))
    # cross (k,) and the two ends of the list, zeroed by one fill
    zeroed = torch.zeros(k + 2, dtype=torch.int32, device=dev)
    cross, ends = zeroed[:k], zeroed[k:]
    tn_min = torch.full((k,), BIG_T, device=dev)
    lanes = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return cross.bool(), tn_min, lanes, ends[:1]
    with cuda_lib.launch(dev) as (lib, stream):
        err = lib.rfw_tlas_premask(
            ptr(o), ptr(d), ptr(best_t),
            None if orig is None else ptr(orig), n, float(t_epsilon),
            ptr(lo), ptr(hi), k, ptr(cross), ptr(tn_min), ptr(lanes),
            ptr(ends), stream)
        cuda_lib.check(err, "tlas premask kernel")
    launch_counts["tlas_premask"] += 1
    return cross.bool(), tn_min, lanes, ends[:1]


def walk_group(rows: dict, o, d, state, order, count, lanes, n_lanes,
               t_epsilon: float, any_hit: bool = False):
    """``walk_group_ref``'s result: ``tlas_walk_kernel`` on CUDA tensors
    (thread j takes ray ``lanes[j]``: below ``n_lanes`` it walks the first
    ``count`` entries of ``order``, all three read on the device, past it
    it copies the ray's state), the plain version on CPU tensors, which
    walks every ray. ``state`` is (t, orig, u, v), each (R,); ``lanes``
    and ``n_lanes`` are ``premask``'s of the same rays and state.
    Returns the new state."""
    if not cuda_lib.kernel_device(o, "tlas"):
        return walk_group_ref(rows, o, d, state, order, count, t_epsilon,
                              any_hit)
    dev = o.device
    n, o, d = _rays(o, d)
    bufs = group_buffers(rows, dev)
    t_in, orig_in, u_in, v_in = (x.contiguous() for x in state)
    for name, x in (("t", t_in), ("orig", orig_in), ("u", u_in),
                    ("v", v_in), ("lanes", lanes)):
        _check_shape(name, x, (n,))
    _check_shape("order", order, (rows["inst_base"].shape[0],))
    _check_shape("count", count, (1,))
    _check_shape("n_lanes", n_lanes, (1,))
    check_inputs(dev, origins=(o, torch.float32),
                 directions=(d, torch.float32), t=(t_in, torch.float32),
                 orig=(orig_in, torch.int32), u=(u_in, torch.float32),
                 v=(v_in, torch.float32), lanes=(lanes, torch.int32),
                 n_lanes=(n_lanes, torch.int32), order=(order, torch.int32),
                 count=(count, torch.int32))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    orig = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, orig, u, v
    with cuda_lib.launch(dev) as (lib, stream):
        err = lib.rfw_tlas_walk(
            ptr(o), ptr(d), n, ptr(t_in), ptr(orig_in), ptr(u_in), ptr(v_in),
            ptr(lanes), ptr(n_lanes), ptr(order), ptr(count),
            *(ptr(b) for b in bufs), traverse.LEAF_SIZE, float(t_epsilon),
            int(any_hit), ptr(t), ptr(orig), ptr(u), ptr(v), stream)
        cuda_lib.check(err, "tlas walk kernel")
    launch_counts["tlas_walk"] += 1
    return t, orig, u, v


def occupancy(lib=None) -> dict:
    """Resident blocks per SM of the current CUDA device of the premask
    and the walk kernel (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    from ``lib`` or this checkout's kernel library."""
    lib = lib or cuda_lib.load()
    premask_blocks, walk_blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(lib.rfw_tlas_occupancy(ctypes.byref(premask_blocks),
                                          ctypes.byref(walk_blocks)),
                   "tlas occupancy query")
    return {"tlas_premask": premask_blocks.value,
            "tlas_walk": walk_blocks.value}


def walk_groups(tables: dict, o, d, t_max, t_epsilon: float,
                any_hit: bool = False, ray_chunk: int = 65536):
    """``walk`` BLAS by BLAS through the two wrappers: ``premask`` below
    the best t the BLASes before left (for any hit, of the rays without a
    hit), ``visit_order`` and ``walk_group``; the kernels on CUDA
    tensors, ``premask_ref`` and ``walk_group_ref`` on CPU tensors.
    Nothing is read to the host."""
    state = start_state(o, t_max)
    for rows in tables["blas"]:
        cross, tn_min, lanes, n_lanes = premask(
            rows["inst_bmin"], rows["inst_bmax"], o, d, state[0], t_epsilon,
            state[1] if any_hit else None, ray_chunk)
        order, count = visit_order(cross, tn_min)
        state = walk_group(rows, o, d, state, order, count, lanes, n_lanes,
                           t_epsilon, any_hit)
    return state


def walk(tables: dict, o, d, t_max, t_epsilon: float,
         any_hit: bool = False, ray_chunk: int = 65536):
    """The two-level walk of rays (R, 3) over ``tables`` ({"blas": one
    dict a BLAS}, each with ``walk_tables``' tables, "prim_order" and its
    instances' rows), BLAS by BLAS, as rfw_tpu's ``tlas`` intersector: a
    premask slab-tests every (ray, instance) pair of the BLAS and keeps
    the instances some ray crosses, ordered front to back by their
    nearest entry (a stable sort, so ties keep instance order); each of
    those is walked in turn, by the rays that hit its world box below
    their best t (for any hit, that have no hit yet). On CUDA tensors
    ``walk_groups`` (two kernels a BLAS, no host read), on CPU tensors
    ``walk_ref`` (``ray_chunk`` rays a premask pass); any other device
    raises. ``t_max`` is a number or one bound a ray.

    Returns (t, orig, u, v): ``orig`` the hit triangle in the flattened
    input order (``inst_base + prim_order[prim]``), -1 where none, and t
    the ray's ``t_max`` there."""
    if not cuda_lib.kernel_device(o, "tlas"):
        return walk_ref(tables, o, d, t_max, t_epsilon, any_hit, ray_chunk)
    return walk_groups(tables, o, d, t_max, t_epsilon, any_hit)


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
