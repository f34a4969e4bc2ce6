"""Device scene assembly (port of ``rfw_tpu.render.scene_data``): the
host build in numpy, then ``scene_to_torch`` moves it to the device.

``build_device_scene`` flattens every instance to world space, builds
the BVH (the wide BVH of the ``bvh`` intersector, and the leaf-contiguous
triangle order), cuts the spatial visit cells and packs the intersector
and shading tables, with the ``tvisit`` child-cell tables when
``config.subcell_tables`` asks for them. The arrays it returns equal the
reference's build, array for array; ``build_device_scene_cached`` keeps
them in a disk cache.

With ``config.use_tlas`` the build also makes the two-level tables of
the ``tlas`` intersector (``_build_tlas_tables``): one object-space BLAS
per mesh slot and its instances' inverses and world boxes.

Same-topology updates (deformed meshes, moved instances) skip the build,
by one of two paths:

* ``move_instances_device``, the device update: one CUDA kernel,
  ``retransform``, writes the world planes, the triangle table and the
  pack in the build's triangle order; then the scene's TLAS instance
  tables are made again (``_moved_tlas``) or, in a scene without them,
  its visit tables are re-celled by a Morton sort (``recell``). It
  leaves the wide BVH and the BLASes as they were, so the engines do not
  take it under ``bvh``, nor for a deformation of a scene with TLAS
  tables;
* ``refit_deformed``, the host refit, re-transforms the planes in numpy,
  refits the binary BVH and collapses it again, and rebuilds the cell
  tables over their unchanged membership. Unlike rfw_tpu's, it also
  rebuilds the ``tvisit`` child tables, which rfw_tpu's refit leaves
  stale.

Left out: tables that no ported consumer reads (the per-triangle and
per-slot Woop matrices, whose rows ``wplanes`` carries, and
``cbounds``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..bvh.builder import BVH, build_bvh, triangle_bounds
from ..bvh.tlas import (box_world_aabb, build_blas, group_instances,
                        walk_tables)
from ..bvh.wide import (SUPER_G, collapse_wide, extract_treelets,
                        spatial_treelets, subdivide_cells)
from ..config import RenderConfig
from ..ops import cuda_lib
from ..ops.intersect import cross3, dot3, woop_matrices
from ..ops.traverse import node_table, tri_edges, tri_table
from ..ops.visit_intersect import device_tables
from ..scene.mesh import TriangleSoA
from ..utils import tracing


@dataclasses.dataclass
class InstancedMesh:
    """One (mesh, instance) pair queued for upload."""

    triangles: TriangleSoA
    transform: np.ndarray          # (4, 4) world transform
    instance_id: int
    mesh_slot: int


def _transform_triangles_all(instances: list[InstancedMesh]) -> dict:
    """Instance transforms applied to every triangle SoA at once (normals
    by the inverse-transpose). Returns the concatenated planes plus
    ``counts``/``offsets`` per instance."""
    counts = np.array([im.triangles.vertices.shape[0] for im in instances],
                      np.int64)
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    gidx = np.repeat(np.arange(len(instances)), counts)

    xf = np.stack([im.transform for im in instances]).astype(np.float32)
    rot = xf[:, :3, :3]
    trn = xf[:, :3, 3]
    safe = np.abs(np.linalg.det(rot)) > 1e-12
    rot_safe = np.where(safe[:, None, None], rot, np.eye(3, dtype=np.float32))
    nmat = np.linalg.inv(rot_safe).transpose(0, 2, 1)
    nmat = np.where(safe[:, None, None], nmat, rot)

    def cat(attr):
        return np.concatenate([getattr(im.triangles, attr)
                               for im in instances], axis=0)

    r_t, n_t, t_t = rot[gidx], nmat[gidx], trn[gidx]

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                              1e-20)

    verts = np.einsum("tij,tvj->tvi", r_t, cat("vertices")) + t_t[:, None]
    normals = norm(np.einsum("tij,tvj->tvi", n_t, cat("normals")))
    gn = norm(np.einsum("tij,tj->ti", n_t, cat("gnormal")))
    tangent = norm(np.einsum("tij,tj->ti", r_t, cat("tangent")))
    bitangent = norm(np.einsum("tij,tj->ti", r_t, cat("bitangent")))
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    return {
        "vertices": verts.astype(np.float32, copy=False),
        "normals": normals.astype(np.float32, copy=False),
        "gnormal": gn.astype(np.float32, copy=False),
        "tangent": tangent.astype(np.float32, copy=False),
        "bitangent": bitangent.astype(np.float32, copy=False),
        "uv": cat("uv"),
        "material": cat("material"),
        "area": area.astype(np.float32, copy=False),
        "lod": cat("lod"),
        "light_tri_idx": cat("light_tri_idx"),
        "counts": counts,
        "offsets": offsets,
    }


def _woop_planes(pad_woop: np.ndarray, k_size: int, cell_bmin: np.ndarray,
                 cell_bmax: np.ndarray) -> np.ndarray:
    """(T_pad, 3, 4) Woop matrices → (n_cells, 16, k_size) plane blocks:
    rows 0-3 give u, 4-7 v, 8-11 w for the cell's K triangles; row 12
    holds the cell AABB in lanes 0-5; rows 13-15 are zero."""
    n_cells = pad_woop.shape[0] // k_size
    w = pad_woop.reshape(n_cells, k_size, 3, 4).transpose(0, 2, 3, 1)
    planes = np.zeros((n_cells, 16, k_size), np.float32)
    planes[:, 0:12] = w.reshape(n_cells, 12, k_size)
    planes[:, 12, 0:3] = cell_bmin
    planes[:, 12, 3:6] = cell_bmax
    return planes


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _pad_wide(wide, min_cap: int = 0):
    """Pad wide-BVH node arrays to a power-of-two count (>= ``min_cap``)."""
    n = wide.bmin.shape[0]
    cap = max(_pow2(n), min_cap)
    if cap == n:
        return wide
    pad = cap - n
    w = wide.bmin.shape[1]
    wide.bmin = np.concatenate([wide.bmin, np.zeros((pad, w, 3), np.float32)])
    wide.bmax = np.concatenate([wide.bmax, np.zeros((pad, w, 3), np.float32)])
    wide.child = np.concatenate([wide.child, np.full((pad, w), -1, np.int32)])
    wide.count = np.concatenate([wide.count, np.full((pad, w), -1, np.int32)])
    return wide


def _instance_tables(instances: list[InstancedMesh], roots) -> list[dict]:
    """The TLAS's instance tables, one dict a BLAS
    (``tlas.group_instances``): the instances grouped under their mesh
    slot's BLAS (slots in the order first seen; ``roots`` the BLASes'
    object-space root boxes (lo, hi) in that order), each with its
    inverse matrix (inverted in float64, as rfw_tpu's scene tables), world
    box and the offset ``inst_base`` of its triangles in the flattened
    input order."""
    slot_blas: dict[int, int] = {}
    blas_of, inv, lo, hi, base = [], [], [], [], [0]
    for im in instances:
        bi = slot_blas.setdefault(im.mesh_slot, len(slot_blas))
        box = box_world_aabb(*roots[bi], im.transform)
        blas_of.append(bi)
        inv.append(np.linalg.inv(im.transform.astype(np.float64))
                   .astype(np.float32))
        lo.append(box[0])
        hi.append(box[1])
        base.append(base[-1] + im.triangles.vertices.shape[0])
    return group_instances(len(roots), blas_of, np.stack(inv), np.stack(lo),
                           np.stack(hi), base[:-1])


def _build_tlas_tables(instances: list[InstancedMesh],
                       inv_perm: np.ndarray) -> dict:
    """The ``tlas`` intersector's tables: one object-space BLAS per mesh
    slot (``BLAS.arrays``), in the order the slots are first seen, with
    its instances' tables (``_instance_tables``), and ``orig_to_perm``,
    which maps the flattened input order into the build's triangle order
    of the shading planes."""
    blas_list: list[dict] = []
    seen: set[int] = set()
    for im in instances:
        if im.mesh_slot not in seen:
            seen.add(im.mesh_slot)
            blas_list.append(build_blas(im.triangles.vertices).arrays())
    roots = [(bl["root_lo"], bl["root_hi"]) for bl in blas_list]
    for bl, t in zip(blas_list, _instance_tables(instances, roots)):
        bl.update(t)
    return {"blas": tuple(blas_list),
            "orig_to_perm": inv_perm.astype(np.int32)}


def build_tri_pack(scene: dict):
    """The per-triangle shading attributes in ONE (T, 32) float32 plane:
    0-8 normals, 9-14 uv, 15-17 gnormal, 18-20 tangent, 21-23 bitangent,
    24 material id, 25 lod, 26 area, 27 light_tri_idx (ids exact below
    2^24; larger scenes get no pack)."""
    t = scene["tri_vertices"].shape[0]
    if t >= (1 << 24) or scene["tri_material"].max(initial=0) >= (1 << 24):
        return None
    p = np.zeros((t, 32), np.float32)
    p[:, 0:9] = scene["tri_normals"].reshape(t, 9)
    p[:, 9:15] = scene["tri_uv"].reshape(t, 6)
    p[:, 15:18] = scene["tri_gnormal"]
    p[:, 18:21] = scene["tri_tangent"]
    p[:, 21:24] = scene["tri_bitangent"]
    p[:, 24] = scene["tri_material"]
    p[:, 25] = scene["tri_lod"]
    p[:, 26] = scene["tri_area"]
    p[:, 27] = scene["tri_light_idx"]
    return p


def build_device_scene(
    instances: list[InstancedMesh],
    materials: dict[str, np.ndarray],
    lights: dict[str, np.ndarray],
    skybox: dict[str, np.ndarray] | None,
    atlas: dict[str, np.ndarray] | None,
    config: RenderConfig,
    area_light_overrides: dict[tuple[int, int], int] | None = None,
    shape_caps: dict | None = None,
) -> dict:
    """Assemble the flat scene as a dict of numpy arrays.

    ``atlas`` is ``scene.texture.build_atlases_cached``'s dict (or
    None). ``area_light_overrides`` maps (instance_id, mesh-local tri
    index) → area-light index. ``shape_caps`` (engine-held, updated here)
    keeps padded sizes from shrinking between rebuilds."""
    if not instances:
        raise ValueError("cannot build an empty scene")
    shape_caps = shape_caps if shape_caps is not None else {}
    cat = _transform_triangles_all(instances)
    counts = cat.pop("counts")
    offsets = cat.pop("offsets")
    total = int(offsets[-1])
    cat["instance_id"] = np.repeat(
        np.array([im.instance_id for im in instances], np.int32), counts)
    cat["prim_id"] = (np.arange(total, dtype=np.int64)
                      - np.repeat(offsets[:-1], counts)).astype(np.int32)
    if area_light_overrides:
        lti = cat["light_tri_idx"] = cat["light_tri_idx"].copy()
        for j, im in enumerate(instances):
            for (inst, tri), li in area_light_overrides.items():
                if inst == im.instance_id and tri < counts[j]:
                    lti[offsets[j] + tri] = li

    tmin, tmax = triangle_bounds(cat["vertices"])
    bvh = build_bvh(tmin, tmax, leaf_size=4)
    perm = bvh.prim_order
    wide = _pad_wide(collapse_wide(bvh, width=4),
                     min_cap=shape_caps.get("bvh_nodes", 0))
    shape_caps["bvh_nodes"] = wide.bmin.shape[0]
    if config.treelet_spatial:
        cells = spatial_treelets(tmin, tmax, size=config.treelet_size)
    else:
        cells = extract_treelets(bvh, tmin, tmax, size=config.treelet_size)
    # children need >= 8 slots each: _woop_planes writes the cell bounds
    # into lanes 0:6 of plane row 12
    sub_tables = (config.subcell_tables and config.treelet_size % 4 == 0
                  and config.treelet_size >= 32)
    if sub_tables:
        # reorder each cell's slots into 4 spatial quarters (membership
        # unchanged, so every other table is unaffected) and derive the
        # K/4-triangle child cells of the tvisit intersector
        cells.pad_map, bmin32, bmax32, _ = subdivide_cells(
            cells.pad_map, tmin, tmax, config.treelet_size)

    verts = cat["vertices"][perm]
    scene = {
        "tri_vertices": verts,
        "tri_normals": cat["normals"][perm],
        "tri_gnormal": cat["gnormal"][perm],
        "tri_tangent": cat["tangent"][perm],
        "tri_bitangent": cat["bitangent"][perm],
        "tri_uv": cat["uv"][perm],
        "tri_material": cat["material"][perm],
        "tri_area": cat["area"][perm],
        "tri_lod": cat["lod"][perm],
        "tri_light_idx": cat["light_tri_idx"][perm],
        "tri_instance": cat["instance_id"][perm],
        "tri_prim": cat["prim_id"][perm],
        "bvh": {"bmin": wide.bmin, "bmax": wide.bmax,
                "child": wide.child, "count": wide.count},
        "materials": materials,
        "lights": lights,
    }
    woop = woop_matrices(verts[:, 0], verts[:, 1], verts[:, 2])

    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(len(perm), dtype=perm.dtype)
    pad_valid = cells.pad_map >= 0
    pad_perm = np.where(pad_valid, inv_perm[np.maximum(cells.pad_map, 0)],
                        -1).astype(np.int32)
    padded_verts = np.zeros((len(cells.pad_map), 3, 3), np.float32)
    padded_verts[pad_valid] = cat["vertices"][cells.pad_map[pad_valid]]
    # pad the cell count to a power of two >= SUPER_G; pad cells are a
    # far-away point box (never crossed)
    n_cells = cells.bmin.shape[0]
    cap = max(_pow2(n_cells), SUPER_G, shape_caps.get("treelets", 0))
    shape_caps["treelets"] = cap
    bmin, bmax = cells.bmin, cells.bmax
    if cap != n_cells:
        pad_n = cap - n_cells
        k = cells.size
        bmin = np.concatenate([bmin, np.full((pad_n, 3), 3e37, np.float32)])
        bmax = np.concatenate([bmax, np.full((pad_n, 3), 3e37, np.float32)])
        pad_perm = np.concatenate([pad_perm, np.full(pad_n * k, -1, np.int32)])
        padded_verts = np.concatenate(
            [padded_verts, np.zeros((pad_n * k, 3, 3), np.float32)])
        if sub_tables:
            bmin32 = np.concatenate(
                [bmin32, np.full((pad_n * 4, 3), 3e37, np.float32)])
            bmax32 = np.concatenate(
                [bmax32, np.full((pad_n * 4, 3), 3e37, np.float32)])

    # per-slot Woop matrices gathered from the per-triangle ones; pad
    # slots get the unreachable w ≡ 1 plane
    pv_all = pad_perm >= 0
    pad_woop = np.zeros((pad_perm.shape[0], 3, 4), np.float32)
    pad_woop[:, 2, 3] = 1.0
    pad_woop[pv_all] = woop[pad_perm[pv_all]]
    # super-cell bounds for the "super" visit granularity
    n_super = bmin.shape[0] // SUPER_G
    sbmin = bmin.reshape(n_super, SUPER_G, 3).min(axis=1)
    smax_raw = np.where(bmax.reshape(n_super, SUPER_G, 3) > 1e37, -3e38,
                        bmax.reshape(n_super, SUPER_G, 3))
    sbmax = smax_raw.max(axis=1)
    empty = sbmax[:, 0] < sbmin[:, 0]
    sbmin[empty] = 3e37
    sbmax[empty] = 3e37
    scene["treelets"] = {
        "wplanes": _woop_planes(pad_woop, config.treelet_size, bmin, bmax),
        "verts": padded_verts,
        "slot_to_prim": pad_perm,
        "bmin": bmin, "bmax": bmax,
        "sbmin": sbmin.astype(np.float32),
        "sbmax": sbmax.astype(np.float32),
        # true scene bounds (pad cells are far-away points)
        "scene_lo": tmin.min(axis=0).astype(np.float32),
        "scene_hi": tmax.max(axis=0).astype(np.float32),
        "size": cells.size,
    }
    if sub_tables:
        # one (16, 128) plane block per child, its k4 triangles in lanes
        # 0..k4-1 and zeros beyond: the reference's lane-padded layout,
        # kept so both builds agree array for array
        k4 = config.treelet_size // 4
        wp32 = np.zeros((bmin32.shape[0], 16, 128), np.float32)
        wp32[:, :, :k4] = _woop_planes(pad_woop, k4, bmin32, bmax32)
        scene["treelets"].update(
            {"bmin32": bmin32, "bmax32": bmax32, "wplanes32": wp32})
    if config.use_tlas:
        scene["tlas"] = _build_tlas_tables(instances, inv_perm)
    if skybox is not None:
        scene["skybox"] = skybox
    if atlas is not None:
        scene["atlas"] = atlas["atlas"]
        scene["atlas_desc"] = atlas["desc"]
        if "matlas" in atlas:
            scene["matlas"] = atlas["matlas"]
            scene["matlas_desc"] = atlas["matlas_desc"]
    else:
        scene["atlas"] = None
        scene["atlas_desc"] = None
    tp = build_tri_pack(scene)
    if tp is None:
        raise NotImplementedError(
            "scenes past 2^24 triangles or materials (no tri pack) are "
            "not supported by rfw_tpu_torch")
    scene["tri_pack"] = tp
    # host caches for the refits (dropped by scene_to_torch): the pack,
    # whose invariant columns the host refit keeps, the binary BVH it
    # refits in place, and the triangle order of the build
    scene["_pack_host"] = tp
    scene["_bvh_host"] = bvh
    scene["_perm_host"] = perm
    return scene


# ---------------------------------------------------------------------------
# disk cache of the build
# ---------------------------------------------------------------------------

# keys attached from the caller's arguments, never cached
_SCENE_ATTACH_KEYS = ("materials", "lights", "skybox", "atlas",
                      "atlas_desc", "matlas", "matlas_desc")
# the port's sources that decide what the build makes (this module, the
# BVH and cell builders, the native builder and the Woop matrices)
_SCENE_BUILD_SOURCES = ("render/scene_data.py", "bvh/__init__.py",
                        "bvh/builder.py", "bvh/wide.py", "bvh/tlas.py",
                        "native/__init__.py", "native/bvh_builder.cpp",
                        "ops/intersect.py")


@functools.lru_cache(maxsize=1)
def _scene_build_hash() -> str:
    """Hash of the build's sources: a change to any of them keys new
    cache entries, so no build made by older code is ever read."""
    import hashlib
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha1()
    for rel in _SCENE_BUILD_SOURCES:
        h.update(rel.encode())
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _scene_cache_dir() -> str | None:
    """The port's own cache directory (``RFW_SCENE_CACHE_DIR`` overrides
    it); ``RFW_NO_SCENE_CACHE`` turns the cache off."""
    import os
    if os.environ.get("RFW_NO_SCENE_CACHE"):
        return None
    return os.environ.get(
        "RFW_SCENE_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "rfw_tpu_torch",
                     "scene"))


def _scene_cache_key(instances, config, area_light_overrides,
                     shape_caps) -> str:
    """Hash of the build's sources and of every geometry input of
    ``build_device_scene``: the raw triangle planes, transforms, instance
    and slot ids, light overrides, the geometry knobs of the config and
    the shape caps (pad sizes)."""
    import hashlib
    h = hashlib.sha1(str((
        _scene_build_hash(), config.treelet_size, config.treelet_spatial,
        config.use_tlas, SUPER_G, config.subcell_tables,
        sorted((area_light_overrides or {}).items(), key=lambda kv: kv[0]),
        sorted((shape_caps or {}).items()),
    )).encode())
    for im in instances:
        h.update(str((im.instance_id, im.mesh_slot)).encode())
        h.update(np.ascontiguousarray(im.transform).tobytes())
        for f in dataclasses.fields(TriangleSoA):
            a = np.ascontiguousarray(getattr(im.triangles, f.name))
            h.update(str((a.shape, str(a.dtype))).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _scene_tree_split(obj, arrays: list):
    """Numpy leaves → index markers (the arrays appended to ``arrays``);
    a BVH becomes a tagged dict of its fields, a tuple or list (the TLAS's
    BLASes) a tagged list."""
    if isinstance(obj, np.ndarray):
        arrays.append(np.ascontiguousarray(obj))
        return {"__npy__": len(arrays) - 1}
    if isinstance(obj, BVH):
        return {"__bvh__": {f.name: _scene_tree_split(getattr(obj, f.name),
                                                      arrays)
                            for f in dataclasses.fields(BVH)}}
    if isinstance(obj, dict):
        return {k: _scene_tree_split(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return {"__seq__": [_scene_tree_split(v, arrays) for v in obj],
                "__tuple__": isinstance(obj, tuple)}
    return obj


def _scene_tree_join(obj, fetch):
    if isinstance(obj, dict):
        if "__npy__" in obj:
            return fetch(obj["__npy__"])
        if "__bvh__" in obj:
            # the host refit writes its node arrays in place: load them
            # writable, never memory-mapped
            return BVH(**{k: np.array(_scene_tree_join(v, fetch))
                          for k, v in obj["__bvh__"].items()})
        if "__seq__" in obj:
            seq = [_scene_tree_join(v, fetch) for v in obj["__seq__"]]
            return tuple(seq) if obj["__tuple__"] else seq
        return {k: _scene_tree_join(v, fetch) for k, v in obj.items()}
    return obj


def _attach(scene, materials, lights, skybox, atlas) -> None:
    scene["materials"] = materials
    scene["lights"] = lights
    if skybox is not None:
        scene["skybox"] = skybox
    if atlas is not None:
        scene["atlas"] = atlas["atlas"]
        scene["atlas_desc"] = atlas["desc"]
        if "matlas" in atlas:
            scene["matlas"] = atlas["matlas"]
            scene["matlas_desc"] = atlas["matlas_desc"]
    else:
        scene["atlas"] = None
        scene["atlas_desc"] = None


def build_device_scene_cached(instances, materials, lights, skybox, atlas,
                              config, area_light_overrides=None,
                              shape_caps=None) -> dict:
    """``build_device_scene`` behind a disk cache keyed by a hash of its
    sources and geometry inputs (``_scene_cache_key``). A hit loads the
    geometry arrays (memory-mapped, read-only) and attaches materials,
    lights, sky and atlas from the arguments; the host pack cache is the
    loaded ``tri_pack``, which the refit copies before it writes. A
    failed read or write falls back to the build and leaves the cache as
    it was."""
    import json
    import os
    import shutil
    import tempfile

    d = _scene_cache_dir()
    mdir = None
    if d is not None:
        mdir = os.path.join(d, "scene_" + _scene_cache_key(
            instances, config, area_light_overrides, shape_caps))
    if mdir and os.path.exists(os.path.join(mdir, "manifest.json")):
        try:
            with open(os.path.join(mdir, "manifest.json")) as f:
                man = json.load(f)
            scene = _scene_tree_join(man["tree"], lambda i: np.load(
                os.path.join(mdir, f"{i}.npy"), mmap_mode="r"))
            if shape_caps is not None:
                shape_caps.update(man["shape_caps"])
            _attach(scene, materials, lights, skybox, atlas)
            scene["_pack_host"] = scene["tri_pack"]
            return scene
        except (OSError, KeyError, ValueError, json.JSONDecodeError):
            pass

    shape_caps = shape_caps if shape_caps is not None else {}
    scene = build_device_scene(
        instances, materials, lights, skybox, atlas, config,
        area_light_overrides=area_light_overrides, shape_caps=shape_caps)
    if mdir:
        try:
            arrays: list = []
            tree = _scene_tree_split(
                {k: v for k, v in scene.items()
                 if k not in _SCENE_ATTACH_KEYS and k != "_pack_host"},
                arrays)
            os.makedirs(d, exist_ok=True)
            tmp = tempfile.mkdtemp(dir=d, prefix=".scene_tmp_")
            for i, a in enumerate(arrays):
                np.save(os.path.join(tmp, f"{i}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"tree": tree, "shape_caps": shape_caps}, f)
            if os.path.exists(mdir):      # a concurrent writer won
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                os.replace(tmp, mdir)
        except OSError:
            pass
    return scene


# ---------------------------------------------------------------------------
# same-topology updates
# ---------------------------------------------------------------------------

# the object-space planes a device update reads per mesh slot
SLOT_PLANES = ("vertices", "normals", "gnormal", "tangent", "bitangent")


def woop_matrices_torch(v0, v1, v2):
    """``ops.intersect.woop_matrices`` on the vertices' device, with the
    host build's arithmetic: edges in float32, the rows (all three over
    |n|²) and the translation in float64, rounded once to float32; a
    degenerate triangle gets the unreachable w ≡ 1 plane. So a refit of
    unchanged vertices gives the build's matrices, and its frames the
    build's (rfw_tpu's refit keeps w = n in float32, whose last bits flip
    some shadow rays; see README)."""
    e1 = (v1 - v0).double()
    e2 = (v2 - v0).double()
    n = cross3(e1, e2)
    det = dot3(n, n)
    bad = det < 1e-18
    inv_det = (1.0 / torch.where(bad, 1.0, det))[:, None, None]
    rot = torch.stack([cross3(e2, n), cross3(n, e1), n], dim=1) * inv_det
    trans = -dot3(rot, v0.double()[:, None, :])
    out = torch.cat([rot, trans[:, :, None]], dim=2).float()
    unreachable = out.new_zeros((3, 4))
    unreachable[2, 3] = 1.0
    return torch.where(bad[:, None, None], unreachable, out)


def _spread3(x):
    """The low 10 bits of ``x`` (int64) moved to every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_order(verts):
    """(T,) int64 permutation of triangles (T, 3, 3) by the 30-bit Morton
    code of their box centres over the centres' bounds: x in the top bit
    of each triple, then y, then z. The sort is stable, as jnp.argsort
    is, so that equal codes keep triangle order."""
    cent = 0.5 * (verts.amin(dim=1) + verts.amax(dim=1))
    lo, hi = cent.amin(dim=0), cent.amax(dim=0)
    q = torch.clamp((cent - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)
    qi = torch.clamp((q * 1024.0).long(), max=1023)
    code = ((_spread3(qi[:, 0]) << 2) | (_spread3(qi[:, 1]) << 1)
            | _spread3(qi[:, 2]))
    return torch.sort(code, stable=True).indices


def _cell_tables(pv, pad_woop, p_val, k: int, has_sub: bool) -> dict:
    """The visit tables of padded cell slots: ``pv`` (S, 3, 3) slot
    vertices, ``pad_woop`` (S, 3, 4) their Woop matrices, ``p_val``
    (S, 1) 1 where a slot holds a triangle. Cells are K consecutive
    slots, supers SUPER_G consecutive cells and, with ``has_sub``, the
    child cells K/4 consecutive slots. Empty cells, supers and children
    become far boxes (3e37)."""
    n_cells = pv.shape[0] // k
    n_super = n_cells // SUPER_G
    vlo = torch.where(p_val > 0, pv.amin(dim=1), 3e37)
    vhi = torch.where(p_val > 0, pv.amax(dim=1), -3e37)

    def boxes(g):
        lo = vlo.reshape(-1, g, 3).amin(dim=1)
        hi = vhi.reshape(-1, g, 3).amax(dim=1)
        empty = (hi[:, 0] < lo[:, 0])[:, None]
        return torch.where(empty, 3e37, lo), torch.where(empty, 3e37, hi)

    def planes(g, lanes, lo, hi):
        w = pad_woop.reshape(-1, g, 3, 4).permute(0, 2, 3, 1)
        out = pv.new_zeros((w.shape[0], 16, lanes))
        out[:, 0:12, :g] = w.reshape(-1, 12, g)
        out[:, 12, 0:3] = lo
        out[:, 12, 3:6] = hi
        return out

    bmin, bmax = boxes(k)
    sbmin = bmin.reshape(n_super, SUPER_G, 3).amin(dim=1)
    sb = bmax.reshape(n_super, SUPER_G, 3)
    sbmax = torch.where(sb > 1e37, -3e38, sb).amax(dim=1)
    s_empty = (sbmax[:, 0] < sbmin[:, 0])[:, None]
    tl = {"wplanes": planes(k, k, bmin, bmax), "verts": pv,
          "bmin": bmin, "bmax": bmax,
          "sbmin": torch.where(s_empty, 3e37, sbmin),
          "sbmax": torch.where(s_empty, 3e37, sbmax)}
    if has_sub:
        # lane-padded (16, 128) child blocks, as build_device_scene's
        b32lo, b32hi = boxes(k // 4)
        tl.update(bmin32=b32lo, bmax32=b32hi,
                  wplanes32=planes(k // 4, 128, b32lo, b32hi))
    return tl


def _has_sub(tl) -> bool:
    return "bmin32" in tl and int(tl["size"]) % 4 == 0


def _apply_to(x, m):
    """Rows of ``x`` (..., 3) times ``m.T``, ``m`` (..., 3, 3) broadcast
    against them, as three products and two sums, each rounded on its
    own: no matrix-multiply library (so no TF32) and no fused
    multiply-add, on the card as on the CPU."""
    return x[..., 0:1] * m[..., 0] + x[..., 1:2] * m[..., 1] \
        + x[..., 2:3] * m[..., 2]


def _unit(v):
    """``v`` (..., 3) over its length clamped below at 1e-20."""
    return v / torch.clamp(torch.sqrt(dot3(v, v)), min=1e-20)[..., None]


def instance_matrices(transforms) -> np.ndarray:
    """(I, 21) float32, a row an instance: the (3, 4) rows of its world
    transform, then its (3, 3) normal matrix (the inverse transpose, or
    the rotation itself where |det| <= 1e-12), inverted in the
    transforms' own precision."""
    m = np.stack([np.asarray(t)[:3] for t in transforms])
    rot = m[:, :, :3]
    safe = (np.abs(np.linalg.det(rot)) > 1e-12)[:, None, None]
    inv = np.linalg.inv(np.where(safe, rot, np.eye(3, dtype=rot.dtype)))
    nmat = np.where(safe, inv.transpose(0, 2, 1), rot)
    return np.concatenate([m.reshape(-1, 12), nmat.reshape(-1, 9)],
                          axis=1).astype(np.float32)


def _world_tables(verts, normals, gnormal, tangent, bitangent,
                  pack) -> dict:
    """The planes of a re-transform from its world vertices (T, 3, 3) and
    unit vectors: the area, the triangle table (``traverse.tri_table``)
    and a copy of ``pack`` with its geometric columns (normals 0-8,
    gnormal, tangent, bitangent 15-23, area 26) replaced."""
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    nrm = cross3(e1, e2)
    area = 0.5 * torch.sqrt(dot3(nrm, nrm))
    tp = pack.clone()
    tp[:, 0:9] = normals.reshape(-1, 9)
    tp[:, 15:18] = gnormal
    tp[:, 18:21] = tangent
    tp[:, 21:24] = bitangent
    tp[:, 26] = area
    return {"tri_vertices": verts, "tri_normals": normals,
            "tri_gnormal": gnormal, "tri_tangent": tangent,
            "tri_bitangent": bitangent, "tri_area": area,
            "tri_table": tri_table((verts[:, 0], e1, e2)), "tri_pack": tp}


def recell(treelets: dict, verts) -> dict:
    """The visit tables of ``treelets`` made again over the world
    vertices ``verts`` (T, 3, 3), in the build's triangle order, on their
    device: the triangles are re-celled by a Morton sort
    (``morton_order``; ``slot_to_prim`` changes), then the cells, supers
    and, when the scene has them, the tvisit children are boxed and
    planed (``_cell_tables``), and the kernels' derived tables
    (``visit_intersect.device_tables``) made again."""
    stp = treelets["slot_to_prim"]
    pad_tail = torch.full((stp.shape[0] - verts.shape[0],), -1,
                          dtype=torch.int32, device=verts.device)
    slots = torch.cat([morton_order(verts).int(), pad_tail])
    p_src = torch.clamp(slots, min=0).long()
    p_val = (slots >= 0).float()[:, None]
    # pad slots: all-zero vertices, so the unreachable w ≡ 1 plane
    pv = verts[p_src] * p_val[:, :, None]
    pad_woop = woop_matrices_torch(pv[:, 0], pv[:, 1], pv[:, 2])
    tl = dict(treelets)
    tl.update(_cell_tables(pv, pad_woop, p_val, int(treelets["size"]),
                           _has_sub(treelets)))
    tl["scene_lo"] = verts.reshape(-1, 3).amin(dim=0)
    tl["scene_hi"] = verts.reshape(-1, 3).amax(dim=0)
    tl["slot_to_prim"] = slots
    tl.update(device_tables(tl))
    return tl


# the world planes a change of instance transforms or vertices rewrites
_GEOMETRIC_PLANES = ("vertices", "normals", "gnormal", "tangent",
                     "bitangent", "area")


def _host(x) -> np.ndarray:
    """A scene leaf as a numpy array: a tensor is copied to the host."""
    if torch.is_tensor(x):
        with tracing.span("sync.host_table"):
            return x.detach().cpu().numpy()
    return np.asarray(x)


def refresh_tri_pack(pack_host: np.ndarray, planes: dict) -> np.ndarray:
    """A copy of the host pack with its transform-dependent columns
    (normals, gnormal, tangent, bitangent, area) taken from ``planes``;
    the invariant ones (uv, material, lod, light index) stay."""
    p = np.array(pack_host)
    t = p.shape[0]
    p[:, 0:9] = _host(planes["tri_normals"]).reshape(t, 9)
    p[:, 15:18] = _host(planes["tri_gnormal"])
    p[:, 18:21] = _host(planes["tri_tangent"])
    p[:, 21:24] = _host(planes["tri_bitangent"])
    p[:, 26] = _host(planes["tri_area"])
    return p


def retransform_instances(scene: dict, instances: list[InstancedMesh],
                          perm: np.ndarray,
                          pack_host: np.ndarray | None = None) -> dict:
    """The scene with its geometric world planes (and the pack's
    geometric columns) made again from ``instances`` in numpy, under the
    build's triangle order ``perm``, for the host refit; every other
    table is the scene's. The new planes, the traversal kernel's
    triangle table derived from them (``traverse.tri_table``) and the
    pack are numpy arrays, and the new pack is also returned as
    ``_pack_host``."""
    with tracing.span("scene.retransform"):
        with tracing.span("scene.transform"):
            cat = _transform_triangles_all(instances)
            out = dict(scene)
            for k in _GEOMETRIC_PLANES:
                out["tri_area" if k == "area" else f"tri_{k}"] = cat[k][perm]
        with tracing.span("scene.tri_table"):
            out["tri_table"] = tri_table(
                tri_edges(torch.from_numpy(out["tri_vertices"]))).numpy()
        if "tri_pack" in scene:
            with tracing.span("scene.pack"):
                if pack_host is not None:
                    tp = refresh_tri_pack(pack_host, out)
                else:
                    tp = build_tri_pack({k: _host(v) for k, v in out.items()
                                         if k.startswith("tri_")})
                if tp is not None:
                    out["tri_pack"] = tp
                    out["_pack_host"] = tp
    return out


def _moved_tlas(scene: dict, instances: list[InstancedMesh]) -> dict:
    """``scene``'s TLAS tables with each BLAS's instance tables made
    again from ``instances`` (``_instance_tables``: inverted in float64,
    grouped per BLAS in the order the build first saw their mesh slots),
    as numpy arrays; the BLASes stay."""
    with tracing.span("scene.instance_tables"):
        tl = dict(scene["tlas"])
        blas_list = [dict(b) for b in tl["blas"]]
        roots = [(_host(b["root_lo"]), _host(b["root_hi"]))
                 for b in blas_list]
        for bl, t in zip(blas_list, _instance_tables(instances, roots)):
            bl.update(t)
        tl["blas"] = tuple(blas_list)
    return tl


# what a device update's re-transform writes, in the order of the
# kernel's outputs
MOVE_PLANES = ("tri_vertices", "tri_normals", "tri_gnormal", "tri_tangent",
               "tri_bitangent", "tri_area", "tri_table", "tri_pack")


def move_tables(scene: dict, instances: list[InstancedMesh],
                slot_planes: dict) -> dict:
    """What every device update of the tensor ``scene`` reads besides the
    transforms, made on the scene's device once a full build and again
    after each change of a mesh version, which changes "obj": "obj", the
    object-space planes of the mesh slots (``slot_planes``: mesh slot ->
    {name: tensor} for ``SLOT_PLANES``) concatenated in the order the
    slots are first seen; "base" (I,) int32, the first row in them of
    each instance's mesh slot, in instance order; and "row" (T,) int32,
    the instance (its index in ``instances``) of each triangle in the
    build's order, from the scene's ``tri_instance``. With the scene's
    ``tri_prim``, triangle j is object-space triangle
    ``base[row[j]] + tri_prim[j]``."""
    ids = scene["tri_instance"]
    dev = ids.device
    first: dict[int, int] = {}
    parts, n = [], 0
    for im in instances:
        if im.mesh_slot not in first:
            first[im.mesh_slot] = n
            parts.append(slot_planes[im.mesh_slot])
            n += parts[-1]["vertices"].shape[0]
    inst_ids = torch.tensor([im.instance_id for im in instances],
                            dtype=torch.int32, device=dev)
    sorted_ids, order = torch.sort(inst_ids)
    at = torch.searchsorted(sorted_ids, ids, out_int32=True)
    return {"obj": {k: torch.cat([p[k] for p in parts])
                    for k in SLOT_PLANES},
            "base": torch.tensor([first[im.mesh_slot] for im in instances],
                                 dtype=torch.int32, device=dev),
            "row": order.int().index_select(0, at)}


def retransform(row, prim, base, xf, obj: dict, pack) -> dict:
    """The planes of a device update (``MOVE_PLANES``): triangle j is
    object-space triangle ``base[row[j]] + prim[j]`` of ``obj``
    (``SLOT_PLANES``) under row ``row[j]`` of ``xf`` (``instance_
    matrices``); the pack's other columns are ``pack``'s. On CUDA tensors
    ``csrc/retransform_kernel.cu`` writes them into new tensors, equal
    bit for bit to ``retransform_ref``, which runs for CPU tensors."""
    if not cuda_lib.kernel_device(row, "retransform"):
        return retransform_ref(row, prim, base, xf, obj, pack)
    dev, n = row.device, row.shape[0]
    cuda_lib.check_inputs(
        dev, row=(row, torch.int32), prim=(prim, torch.int32),
        base=(base, torch.int32), xf=(xf, torch.float32),
        pack=(pack, torch.float32),
        **{f"obj_{k}": (obj[k], torch.float32) for k in SLOT_PLANES})
    s = obj["vertices"].shape[0]
    if (prim.shape != (n,) or pack.shape != (n, 32)
            or xf.shape != (base.shape[0], 21)
            or any(obj[k].shape != (s, 3, 3) for k in ("vertices", "normals"))
            or any(obj[k].shape != (s, 3)
                   for k in ("gnormal", "tangent", "bitangent"))):
        raise ValueError("retransform: mismatched shapes")
    shapes = ((n, 3, 3), (n, 3, 3), (n, 3), (n, 3), (n, 3), (n,), (n, 3, 4),
              (n, 32))
    out = {k: torch.empty(shape, dtype=torch.float32, device=dev)
           for k, shape in zip(MOVE_PLANES, shapes)}
    ptr = cuda_lib.ptr
    with cuda_lib.launch(dev) as (lib, stream):
        err = lib.rfw_retransform(
            ptr(row), ptr(prim), ptr(base), ptr(xf),
            *(ptr(obj[k]) for k in SLOT_PLANES), ptr(pack), n,
            *(ptr(out[k]) for k in MOVE_PLANES), stream)
        cuda_lib.check(err, "retransform kernel")
    cuda_lib.launch_counts["retransform"] += 1
    return out


def retransform_ref(row, prim, base, xf, obj: dict, pack) -> dict:
    """The plain version of ``retransform``, vectorised over triangles:
    ``_apply_to``, ``_unit`` and ``_world_tables`` on each triangle's own
    instance row."""
    r = row.long()
    src = base.long()[r] + prim.long()
    m = xf[r]
    rt = m[:, :12].reshape(-1, 3, 4)
    rot, nmat = rt[..., :3], m[:, 12:].reshape(-1, 3, 3)
    verts = _apply_to(obj["vertices"][src], rot[:, None]) + rt[:, None, :, 3]
    return _world_tables(
        verts, _unit(_apply_to(obj["normals"][src], nmat[:, None])),
        _unit(_apply_to(obj["gnormal"][src], nmat)),
        _unit(_apply_to(obj["tangent"][src], rot)),
        _unit(_apply_to(obj["bitangent"][src], rot)), pack)


def move_instances_device(scene: dict, tables: dict,
                          instances: list[InstancedMesh]) -> dict:
    """The device update of a same-topology change (moved instances,
    deformed meshes) of the tensor ``scene``: the tables it changes, made
    again on its device as new tensors. The world planes, the triangle
    table and the pack in the build's triangle order come from
    ``retransform`` over ``tables`` (``move_tables``'); then a scene with
    TLAS tables gets its instances' tables (``_moved_tlas``; its BLASes
    and visit tables stay), and one without them its visit tables
    re-celled over the new vertices (``recell``; its wide BVH stays).
    What it uploads is the (I, 21) transform table (``instance_matrices``)
    and the instance tables."""
    with tracing.span("scene.retransform"):
        up = {"xf": instance_matrices([im.transform for im in instances])}
        if "tlas" in scene:
            up["tlas"] = _moved_tlas(scene, instances)
        up = scene_to_torch(up, scene["tri_prim"].device)
        with tracing.span("scene.transform"):
            out = retransform(tables["row"], scene["tri_prim"],
                              tables["base"], up.pop("xf"), tables["obj"],
                              scene["tri_pack"])
        out.update(up)
        if "tlas" not in scene:
            out["treelets"] = recell(scene["treelets"], out["tri_vertices"])
    return out


def refit_deformed(scene: dict, instances: list[InstancedMesh],
                   perm: np.ndarray, bvh_host: BVH, config: RenderConfig,
                   shape_caps: dict, pack_host: np.ndarray | None = None):
    """The host refit of a same-topology update (deformed vertices, moved
    instances): the world planes under the build's order, the binary BVH
    ``bvh_host`` refitted in place (native C++) and collapsed to the wide
    BVH again, and the cell tables rebuilt over their unchanged
    membership (``slot_to_prim`` stays, so every array keeps its shape).
    With the ``tvisit`` child tables, those are rebuilt too, as the build
    makes them (child boxes over the members' padded triangle bounds):
    rfw_tpu's refit leaves them stale. ``scene`` may hold numpy arrays or
    tensors; the tables made here are numpy, for ``scene_to_torch``.

    Returns the new scene, or None when the native refit is unavailable
    or the scene has TLAS tables (the caller builds in full): a
    deformation changes the BLASes' object-space geometry, which this
    refit does not refresh."""
    from ..native import native_refit_bvh

    if "tlas" in scene:
        return None
    out = retransform_instances(scene, instances, perm, pack_host=pack_host)
    verts = out["tri_vertices"]                 # (T, 3, 3), build order
    inv_p = np.argsort(perm).astype(np.int64)
    tmin, tmax = triangle_bounds(verts[inv_p])  # input order, for the refit
    if not native_refit_bvh(bvh_host, tmin, tmax):
        return None
    wide = _pad_wide(collapse_wide(bvh_host, width=4),
                     min_cap=shape_caps.get("bvh_nodes", 0))
    out["bvh"] = {"bmin": wide.bmin, "bmax": wide.bmax,
                  "child": wide.child, "count": wide.count}
    woop = woop_matrices(verts[:, 0], verts[:, 1], verts[:, 2])

    tl = dict(scene["treelets"])
    stp = _host(tl["slot_to_prim"])
    k = int(tl["size"])
    n_cells = stp.shape[0] // k
    valid = stp >= 0
    padded_verts = np.zeros((stp.shape[0], 3, 3), np.float32)
    padded_verts[valid] = verts[stp[valid]]
    pad_woop = np.zeros((stp.shape[0], 3, 4), np.float32)
    pad_woop[:, 2, 3] = 1.0
    pad_woop[valid] = woop[stp[valid]]
    # cell bounds over the unchanged membership, as rfw_tpu's refit makes
    # them (the vertices' own bounds)
    vlo = np.where(valid[:, None], padded_verts.min(axis=1), 3e37)
    vhi = np.where(valid[:, None], padded_verts.max(axis=1), -3e37)
    bmin_c = vlo.reshape(n_cells, k, 3).min(axis=1)
    bmax_c = vhi.reshape(n_cells, k, 3).max(axis=1)
    empty = bmax_c[:, 0] < bmin_c[:, 0]          # an all-pad cell
    bmin_c[empty] = 3e37
    bmax_c[empty] = 3e37
    n_super = n_cells // SUPER_G
    sbmin = bmin_c.reshape(n_super, SUPER_G, 3).min(axis=1)
    smax_raw = np.where(bmax_c.reshape(n_super, SUPER_G, 3) > 1e37, -3e38,
                        bmax_c.reshape(n_super, SUPER_G, 3))
    sbmax = smax_raw.max(axis=1)
    s_empty = sbmax[:, 0] < sbmin[:, 0]
    sbmin[s_empty] = 3e37
    sbmax[s_empty] = 3e37
    tl.update({
        "wplanes": _woop_planes(pad_woop, k, bmin_c, bmax_c),
        "verts": padded_verts,
        "bmin": bmin_c.astype(np.float32),
        "bmax": bmax_c.astype(np.float32),
        "sbmin": sbmin.astype(np.float32),
        "sbmax": sbmax.astype(np.float32),
        "scene_lo": tmin.min(axis=0).astype(np.float32),
        "scene_hi": tmax.max(axis=0).astype(np.float32),
    })
    if _has_sub(tl):
        tl.update(_child_tables(stp, pad_woop, verts, k))
    out["treelets"] = tl
    return out


def _child_tables(stp: np.ndarray, pad_woop: np.ndarray, verts: np.ndarray,
                  k: int) -> dict:
    """The ``tvisit`` child tables over the slots ``stp`` as the build
    makes them: child c is K/4 consecutive slots, boxed by its members'
    padded triangle bounds (a far box when it has none), with its
    lane-padded (16, 128) plane block."""
    k4 = k // 4
    tri_lo, tri_hi = triangle_bounds(verts)
    sc = stp.reshape(-1, k4)
    valid = sc >= 0
    idx = np.maximum(sc, 0)
    bmin32 = np.where(valid[..., None], tri_lo[idx],
                      np.float32(3e37)).min(axis=1).astype(np.float32)
    bmax32 = np.where(valid[..., None], tri_hi[idx],
                      np.float32(-3e38)).max(axis=1).astype(np.float32)
    empty = ~valid.any(axis=1)
    bmin32[empty] = 3e37
    bmax32[empty] = 3e37
    wp32 = np.zeros((bmin32.shape[0], 16, 128), np.float32)
    wp32[:, :, :k4] = _woop_planes(pad_woop, k4, bmin32, bmax32)
    return {"bmin32": bmin32, "bmax32": bmax32, "wplanes32": wp32}


def scene_to_torch(scene_np: dict, device) -> dict:
    """The numpy scene dict (the port's or ``rfw_tpu``'s own build) as
    tensors on ``device``: floating arrays as float32, integer arrays as
    int32, bools as bool. The merged material atlas ``matlas`` (uint32
    RGBA8 words, >= 2^31 wherever alpha >= 128) is carried as its int32
    bit pattern, which ``ops.shade`` unpacks by shift and mask. Keys
    starting with "_" (host-side caches) are dropped; non-array leaves
    pass through. A scene with visit tables gains the kernels' derived
    tables (``visit_intersect.device_tables``), one with a wide BVH the
    traversal kernel's node table (``traverse.node_table``) and one with
    triangles its triangle table (``traverse.tri_table``, "tri_table";
    the host refit brings its own, ``retransform_instances``'), made here
    once per build and once per host refit; each BLAS of the TLAS tables
    gains its own ("nodes" and "tri_table") once per build."""
    def conv(x, key=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()
                    if not k.startswith("_")}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, np.ndarray):
            if key == "matlas" and x.dtype == np.uint32:
                x = x.view(np.int32)
            elif x.dtype.kind == "f":
                x = x.astype(np.float32, copy=False)
            elif x.dtype.kind in "iu":
                if x.size and (x.min() < -(1 << 31) or x.max() >= (1 << 31)):
                    raise ValueError("integer table does not fit int32")
                x = x.astype(np.int32, copy=False)
            x = np.ascontiguousarray(x)
            if not x.flags.writeable:    # a memory-mapped cache member
                x = x.copy()
            tracing.count("upload_bytes", x.nbytes)
            return torch.from_numpy(x).to(device)
        return x
    with tracing.span("scene.upload"):
        out = conv(scene_np)
        if "wplanes" in out.get("treelets", {}):
            out["treelets"].update(device_tables(out["treelets"]))
        if "child" in out.get("bvh", {}):
            out["bvh"]["nodes"] = node_table(out["bvh"])
        if "tri_vertices" in out and "tri_table" not in out:
            out["tri_table"] = tri_table(tri_edges(out["tri_vertices"]))
        for b in out.get("tlas", {}).get("blas", ()):
            walk_tables(b)
    return out
