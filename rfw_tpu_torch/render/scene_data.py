"""Device scene assembly (port of ``rfw_tpu.render.scene_data``): the
host build in numpy, then ``scene_to_torch`` moves it to the device.

``build_device_scene`` flattens every instance to world space, builds
the BVH (for its leaf-contiguous triangle order), cuts the spatial
visit cells and packs the intersector and shading tables, with the
``tvisit`` child-cell tables when ``config.subcell_tables`` asks for
them. The arrays it returns equal the reference's build, array for
array. Left out: refit, the TLAS tables, the disk cache, and tables that
no ported consumer reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bvh.builder import build_bvh, triangle_bounds
from ..bvh.wide import (SUPER_G, collapse_wide, extract_treelets,
                        spatial_treelets, subdivide_cells)
from ..config import RenderConfig
from ..ops.intersect import woop_matrices
from ..ops.visit_intersect import device_tables
from ..scene.mesh import TriangleSoA


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
    if config.use_tlas:
        raise NotImplementedError(
            "TLAS tables are not ported to rfw_tpu_torch yet "
            "(ROADMAP.md, Queue 1)")
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
    return scene


def scene_to_torch(scene_np: dict, device) -> dict:
    """The numpy scene dict (the port's or ``rfw_tpu``'s own build) as
    tensors on ``device``: floating arrays as float32, integer arrays as
    int32, bools as bool. The merged material atlas ``matlas`` (uint32
    RGBA8 words, >= 2^31 wherever alpha >= 128) is carried as its int32
    bit pattern, which ``ops.shade`` unpacks by shift and mask. Keys
    starting with "_" (host-side caches) are dropped; non-array leaves
    pass through. A scene with visit tables gains the kernels' derived
    tables (``visit_intersect.device_tables``), made here once per
    build."""
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
            return torch.from_numpy(x).to(device)
        return x
    out = conv(scene_np)
    if "wplanes" in out.get("treelets", {}):
        out["treelets"].update(device_tables(out["treelets"]))
    return out
