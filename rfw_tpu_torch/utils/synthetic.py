"""Synthetic geometry, numpy only and deterministic (seeded where it is
random): a soup of small random triangles and a wide BVH deep enough to
overflow the traversal's 64-entry stack, for checks of the traversal;
the icosphere and the skinned glTF tube that ``chip_smoke.py``'s scenes
and the examples' stand-ins for absent assets are built from; made-up
parent windows and rays for checks of the child expansion; the inputs
of an instance move's re-transform at a million triangles and of a
depth's next-event estimation at a chunk's lanes; and the 1080p
slice (``build_slice_scene``), the generated stand-in for the reference
bench's pica-4x scene that ``bench_torch.py`` and ``chip_smoke.py``
render. The slice's builders take a ``RenderSystem`` and load the port's
scene modules when they are called."""

from __future__ import annotations

import base64
import json
import os

import numpy as np

# the seed of the 1080p slice's sphere placements (and of chip_smoke.py's
# other generated inputs)
SEED = 20261016


def tri_soup(n: int, seed: int, spread: float = 4.0):
    """n small random triangles (n, 3, 3) in a cube of half-width
    ``spread``, from ``seed``."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    return np.stack([v0, v1, v2], axis=1)


def comb_bvh(levels: int = 40, seed: int = 5):
    """A wide BVH (numpy bmin, bmax, child, count) deep enough to overflow
    the traversal's 64-entry stack, and its triangles (v0, e1, e2): a
    comb of ``levels`` wide nodes whose boxes all hold every ray's path.
    Node i's slot 0 is node i + 1, slots 1-3 are internal nodes with four
    one- to three-triangle leaves. Every slot's box is the same, so a ray
    pushes all four children of every comb node, pops slot 0 first (equal
    tnear, lowest slot) and the stack (3 more entries a level) overflows:
    a walk loses the subtrees the clamped push overwrote."""
    rng = np.random.default_rng(seed)
    n_nodes = levels * 4
    child = np.full((n_nodes, 4), -1, np.int32)
    count = np.full((n_nodes, 4), -1, np.int32)
    first = 0
    side = levels
    for i in range(levels):
        if i + 1 < levels:
            child[i, 0] = i + 1
        for s in (1, 2, 3):
            dead_end = side
            side += 1
            child[i, s] = dead_end
            for j in range(4):
                c = int(rng.integers(1, 4))
                child[dead_end, j] = first
                count[dead_end, j] = c
                first += c
    verts = tri_soup(first, seed, spread=3.0)
    lo = np.full((n_nodes, 4, 3), -5.0, np.float32)
    hi = np.full((n_nodes, 4, 3), 5.0, np.float32)
    wb = {"bmin": lo, "bmax": hi, "child": child, "count": count}
    tris = (verts[:, 0], verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    return wb, tris


def icosphere(level: int):
    """The unit icosphere of ``level`` subdivisions of the icosahedron
    (float32 vertices (V, 3), int32 faces (F, 3)): 20 * 4**level faces."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(level):
        mid: dict = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.stack(verts).astype(np.float32), np.array(faces, np.int32)


TUBE_LENGTH = 1.6


def write_skinned_gltf(path, seed: int, around: int = 256,
                       rings: int = 128) -> int:
    """glTF 2.0 of a skinned tube standing on y = 0 (length TUBE_LENGTH,
    radius ~0.2, ``around`` x ``rings`` quads, radii jittered from
    ``seed``), its buffers inline as a data URI: two joints (a root and
    one at half height), JOINTS_0/WEIGHTS_0 blending from the lower to
    the upper joint around the middle, inverse-bind matrices, and one
    LINEAR rotation channel on the upper joint that bends the tube by
    0, 40 and 80 degrees at t = 0, 0.5, 1 about a horizontal axis drawn
    from ``seed``. Returns the triangle count."""
    rng = np.random.default_rng(seed)
    ang = 2.0 * np.pi * np.arange(around) / around
    y = TUBE_LENGTH * np.arange(rings + 1) / rings
    rad = 0.2 * (1.0 + 0.04 * rng.uniform(-1.0, 1.0, (rings + 1, around)))
    ca, sa = np.cos(ang)[None, :], np.sin(ang)[None, :]
    pos = np.stack([rad * ca, np.broadcast_to(y[:, None], rad.shape),
                    rad * sa], -1).reshape(-1, 3)
    nrm = np.broadcast_to(np.stack([ca, 0.0 * ca, sa], -1),
                          (rings + 1, around, 3)).reshape(-1, 3)
    uv = np.stack(np.meshgrid(np.arange(around) / around,
                              np.arange(rings + 1) / rings), -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(rings), np.arange(around), indexing="ij")
    a = i * around + j
    b = i * around + (j + 1) % around
    faces = np.concatenate([np.stack([a, a + around, b], -1).reshape(-1, 3),
                            np.stack([b, a + around, b + around],
                                     -1).reshape(-1, 3)])
    s = np.clip((pos[:, 1] - 0.3 * TUBE_LENGTH) / (0.4 * TUBE_LENGTH), 0, 1)
    w1 = s * s * (3.0 - 2.0 * s)
    weights = np.stack([1.0 - w1, w1, 0 * w1, 0 * w1], -1)
    joints = np.tile(np.array([0, 1, 0, 0], np.uint16), (len(pos), 1))
    half = 0.5 * TUBE_LENGTH
    ibm = np.stack([np.eye(4), np.eye(4)])
    ibm[1, 1, 3] = -half                     # inverse of the joint's bind
    phi = rng.uniform(0.0, np.pi)
    axis = np.array([np.cos(phi), 0.0, np.sin(phi)])
    quats = [np.concatenate([axis * np.sin(th / 2), [np.cos(th / 2)]])
             for th in np.radians([0.0, 40.0, 80.0])]
    blobs = [pos.astype("<f4"), nrm.astype("<f4"), uv.astype("<f4"),
             joints.astype("<u2"), weights.astype("<f4"),
             faces.astype("<u4"),
             ibm.transpose(0, 2, 1).astype("<f4"),     # column-major
             np.array([0.0, 0.5, 1.0], "<f4"), np.array(quats, "<f4")]
    raw = [b.tobytes() for b in blobs]
    offs = np.cumsum([0] + [len(r) for r in raw])
    acc = [(5126, "VEC3", len(pos)), (5126, "VEC3", len(pos)),
           (5126, "VEC2", len(pos)), (5123, "VEC4", len(pos)),
           (5126, "VEC4", len(pos)), (5125, "SCALAR", faces.size),
           (5126, "MAT4", 2), (5126, "SCALAR", 3), (5126, "VEC4", 3)]
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": int(offs[-1]),
                     "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(b"".join(raw)).decode("ascii")}],
        "bufferViews": [{"buffer": 0, "byteOffset": int(o),
                         "byteLength": len(r)} for o, r in zip(offs, raw)],
        "accessors": [{"bufferView": n, "componentType": c, "type": t,
                       "count": k} for n, (c, t, k) in enumerate(acc)],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.35, 0.25, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.6}}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2,
                           "JOINTS_0": 3, "WEIGHTS_0": 4},
            "indices": 5, "material": 0}]}],
        "nodes": [{"name": "root", "children": [1]},
                  {"name": "bend", "translation": [0.0, half, 0.0]},
                  {"name": "tube", "mesh": 0, "skin": 0}],
        "skins": [{"joints": [0, 1], "inverseBindMatrices": 6}],
        "animations": [{"samplers": [{"input": 7, "output": 8,
                                      "interpolation": "LINEAR"}],
                        "channels": [{"sampler": 0, "target": {
                            "node": 1, "path": "rotation"}}]}],
        "scenes": [{"nodes": [0, 2]}], "scene": 0}
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(faces)


def expansion_windows(ids, rays, t_p: int, seed: int) -> dict:
    """Made-up parent windows for checks of the child expansion, from one
    real window: ``ids`` (NB, M_C) int32 and the packed rays (8, NB*256)
    float32 of ``ops/visit_intersect.py::_pack_rays``, numpy. Returns
    {name: (ids, rays)}, from ``seed``:

    * ``all_real``: every parent valid (random ids below ``t_p``), so
      every window holds 4*M_C real child slots, the full row;
    * ``interleaved``: the same with a random half of each window's
      parents invalid (``t_p``), valid and invalid mixed;
    * ``one_live``: interleaved parents and one live lane a 128-ray
      sub-block (t_hi 0 elsewhere);
    * ``dead_nan``: the real window; every fourth block all dead (t_hi 0,
      -1 and NaN in turn) and a tenth of the other lanes NaN;
    * ``far``: interleaved parents and lane 0 of each sub-block on the
      diagonal, o = (1, 1, 1) and d = (1e8, 1e8, 1e8): its entry into the
      far-point box that invalid slots hold (3e37 on every axis) is about
      3e29, below its t_hi of 1e30, so invalid slots enter the lists.
    """
    rng = np.random.default_rng(seed)
    nb, m_c = ids.shape
    real = rng.integers(0, t_p, (nb, m_c)).astype(np.int32)
    mixed = np.where(rng.random((nb, m_c)) < 0.5, t_p, real).astype(
        np.int32)
    one = rays.copy()
    one[3] = 0.0
    sub = one.shape[1] // 128
    one[3, np.arange(sub) * 128 + rng.integers(0, 128, sub)] = 1e30
    dead = rays.copy()
    t_hi = dead[3].reshape(nb, 256)
    t_hi[::4] = np.resize(np.float32([0.0, -1.0, np.nan]), 256)
    t_hi[rng.random((nb, 256)) < 0.1] = np.nan
    far = rays.copy()
    lane0 = np.arange(sub) * 128
    far[0:3, lane0] = 1.0
    far[3, lane0] = 1e30
    far[4:7, lane0] = 1e8
    return {"all_real": (real, rays), "interleaved": (mixed, rays),
            "one_live": (mixed, one), "dead_nan": (ids, dead),
            "far": (mixed, far)}


def tlas_cases(lo, hi, o, d, t, seed: int) -> dict:
    """Made-up inputs for checks of the tlas premask and walk on one BLAS
    group of k >= 2 instances, from its world boxes ``lo``, ``hi`` (k, 3)
    and real rays ``o``, ``d`` (R, 3) with bounds ``t`` (R,), float32
    numpy with finite directions. Returns {name: (o, d, t, any_hit,
    twin)}: rays, bounds, the hit mode, and whether instance 1 is to take
    instance 0's matrix and box (the caller copies the rows), from
    ``seed``:

    * ``dead_inside``: every third ray starts at the centre of a box
      with bound 0 (ray 3 j in box j mod k, so every box holds one when
      R >= 3 k), the others as given: dead lanes whose origins lie inside
      a box count in the premask's cross and tn_min (entry 0) and walk
      nothing;
    * ``all_live``: every ray starts at the centre of a box, bound 1e30:
      every lane crosses a box and walks;
    * ``none_cross``: every ray starts above the highest box and points
      up, bound 1e30: no lane crosses a box, the list is empty;
    * ``coincident_closest``, ``coincident_any``: instance 1 on instance
      0, every ray aimed at a point of their box, bound 1e30: their hits
      tie, the first walked wins (closest hit), the first in the visit
      order that hits is taken (any hit).
    """
    rng = np.random.default_rng(seed)
    n, k = o.shape[0], lo.shape[0]
    centres = ((lo + hi) * np.float32(0.5)).astype(np.float32)
    far = np.full(n, 1e30, np.float32)
    dead_o, dead_t = o.copy(), t.copy()
    dead_o[::3] = centres[np.arange(dead_o[::3].shape[0]) % k]
    dead_t[::3] = 0.0
    up_o, up_d = o.copy(), d.copy()
    up_o[:, 1] = hi[:, 1].max() + 1.0 + np.abs(o[:, 1])
    up_d[:, 1] = np.abs(d[:, 1]) + 1.0
    aim = centres[0] + (rng.uniform(-0.4, 0.4, (n, 3)) * (hi[0] - lo[0]))
    aim_d = (aim - o).astype(np.float32)
    aim_d /= np.linalg.norm(aim_d, axis=-1, keepdims=True)
    return {"dead_inside": (dead_o, d, dead_t, False, False),
            "all_live": (centres[np.arange(n) % k], d, far, False, False),
            "none_cross": (up_o, up_d, far, False, False),
            "coincident_closest": (o, aim_d, far, False, True),
            "coincident_any": (o, aim_d, far, True, True)}


def _unit_rows(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def retransform_case(seed: int, spheres: int = 820, level: int = 3,
                     quads: int = 4) -> dict:
    """Made-up inputs of ``render/scene_data.retransform`` at the layout
    of the benchmark's sphereflake: ``spheres`` instances of one icosphere
    of ``level`` (1,280 triangles at 3) and ``quads`` of a 2-triangle
    quad, 1,049,608 triangles by default. From ``seed``: each instance's
    transform (a rotation, scales in [0.1, 2], a translation in a 100-unit
    cube; instance 0 mirrored, instance 1 scaled so that |det| <= 1e-12),
    the build order (each instance's triangles together, in an order of
    their own, the instances shuffled, as a BVH's leaves keep them) and a
    pack of random columns. Returns numpy "row", "prim" (T,) and "base"
    (I,) int32, "transforms" (I, 4, 4) float32, "obj" ({name: planes} of
    the two meshes, one after the other) and "pack" (T, 32) float32."""
    rng = np.random.default_rng(seed)
    v, f = icosphere(level)
    quad = np.float32([[[-1, 0, -1], [1, 0, -1], [1, 0, 1]],
                       [[-1, 0, -1], [1, 0, 1], [-1, 0, 1]]])
    verts = np.concatenate([v[f], quad])
    normals = np.concatenate([v[f], np.broadcast_to(np.float32([0, 1, 0]),
                                                    quad.shape)])
    n_obj = verts.shape[0]
    obj = {"vertices": verts, "normals": np.ascontiguousarray(normals),
           "gnormal": _unit_rows(np.cross(verts[:, 1] - verts[:, 0],
                                          verts[:, 2] - verts[:, 0])),
           "tangent": _unit_rows(rng.normal(size=(n_obj, 3))),
           "bitangent": _unit_rows(rng.normal(size=(n_obj, 3)))}
    n_inst = spheres + quads
    counts = np.array([f.shape[0]] * spheres + [2] * quads)
    base = np.array([0] * spheres + [f.shape[0]] * quads, np.int32)
    q, _ = np.linalg.qr(rng.normal(size=(n_inst, 3, 3)))
    q[np.linalg.det(q) < 0, :, 2] *= -1.0         # rotations, no mirror
    scale = rng.uniform(0.1, 2.0, (n_inst, 3))
    scale[0, 0] *= -1.0
    scale[1] = (1e-5, 1e-5, 1e-3)
    xf = np.tile(np.eye(4, dtype=np.float32), (n_inst, 1, 1))
    xf[:, :3, :3] = q * scale[:, None, :]
    xf[:, :3, 3] = rng.uniform(-50.0, 50.0, (n_inst, 3))
    rows, prims = [], []
    for i in rng.permutation(n_inst):
        rows.append(np.full(counts[i], i, np.int32))
        prims.append(rng.permutation(counts[i]).astype(np.int32))
    row = np.concatenate(rows)
    return {"row": row, "prim": np.concatenate(prims), "base": base,
            "transforms": xf, "obj": obj,
            "pack": rng.normal(size=(row.shape[0], 32)).astype(np.float32)}


def nee_case(seed: int, n: int, width: int = 1920, height: int = 1080,
             lights: str = "all", order: str = "tiles", glass: float = 0.0,
             nan_share: float = 0.0, sky: tuple = (512, 256)) -> dict:
    """Made-up inputs of ``ops/nee.nee`` for ``n`` lanes of a ``width`` x
    ``height`` image, from ``seed``. ``lights`` "lamps" holds the
    benchmark sphereflake's three 0.5 x 0.5 area lamps (six triangles),
    "all" adds a point, a spot and a directional light (each class padded
    to a power of two with zero-energy slots). ``order`` "tiles" takes
    the first ``n`` pixels in the integrator's 16 x 16 tile order (a
    depth-0 chunk), "scattered" ``n`` pixels in a random order (a bounce
    chunk after compaction). Hit points, normals (the shading normal a
    small tilt off the geometric one, both facing the ray), Disney
    materials (roughness down to 0.001; a ``glass`` share of lanes with
    transmission 1 and eta 1.5, as the mount's spheres), throughputs and
    flags (a tenth dead, 2 % alpha-cut) are random; a ``nan_share`` of the
    lanes has a NaN throughput. The sky is ``Skybox.test_sky`` at ``sky``
    with its importance tables. Returns numpy "lights" (``pack_lights``),
    "skybox" ({pixels, pdf, flat_cdf}) and "lanes" (``ops/nee.NeeLanes``'
    fields, "sd" a dict)."""
    from ..scene.lights import (AreaLight, DirectionalLight, PointLight,
                                SpotLight, pack_lights)
    from ..scene.skybox import Skybox

    rng = np.random.default_rng(seed)
    area = []
    for pos in ((4.0, 2.0, -3.0), (1.0, 4.0, 4.0), (-3.0, 5.0, -1.0)):
        c = np.float32(pos)
        nrm = _unit_rows(-c[None])[0]
        t = _unit_rows(np.cross(nrm, [0.0, 1.0, 0.3])[None])[0]
        b = np.cross(nrm, t).astype(np.float32)
        q = [c + 0.25 * (sx * t + sy * b)
             for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        for i0, i1, i2 in ((0, 1, 2), (0, 2, 3)):
            area.append(AreaLight(q[i0], q[i1], q[i2], nrm,
                                  np.float32([120.0] * 3), 0.125))
    point, spot, directional = [], [], []
    if lights == "all":
        point = [PointLight(np.float32([1.8, 4.5, -1.5]),
                            np.float32([12.0, 11.0, 10.0]))]
        spot = [SpotLight(np.float32([-2.0, 4.0, 2.0]),
                          _unit_rows(np.float32([[0.4, -1.0, -0.3]]))[0],
                          np.float32([30.0, 28.0, 25.0]), 0.95, 0.8)]
        directional = [DirectionalLight(
            _unit_rows(np.float32([[-0.3, -1.0, 0.2]]))[0],
            np.float32([1.5, 1.4, 1.2]))]
    packed = pack_lights(area, point, spot, directional)
    box = Skybox.test_sky(*sky)
    skybox = {"pixels": box.pixels, **box.build_importance_tables()}

    if order == "tiles":
        y, x = np.divmod(np.arange(width * height, dtype=np.int64), width)
        key = (((y // 16) * (width // 16 + 1) + x // 16) * 256
               + (y % 16) * 16 + (x % 16))
        pid = np.argsort(key, kind="stable")[:n]
    else:
        pid = rng.choice(width * height, size=n, replace=False)
    u = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa
    n_geom = _unit_rows(rng.normal(size=(n, 3)))
    i_n = _unit_rows(n_geom + 0.1 * rng.normal(size=(n, 3)))
    d = _unit_rows(rng.normal(size=(n, 3)))
    d = np.where((d * n_geom).sum(-1, keepdims=True) > 0, -d, d)
    is_glass = rng.random(n) < glass
    sd = {"color": rng.uniform(0, 1, (n, 3)).astype(np.float32),
          "absorption": rng.uniform(0, 0.5, (n, 3)).astype(np.float32),
          "metallic": u(0, 1), "subsurface": u(0, 1), "specular": u(0, 1),
          "roughness": np.exp(u(np.log(1e-3), 0.0)).astype(np.float32),
          "specular_tint": u(0, 1), "anisotropic": u(0, 1), "sheen": u(0, 1),
          "sheen_tint": u(0, 1), "clearcoat": u(0, 1),
          "clearcoat_gloss": u(0, 1),
          "transmission": np.where(is_glass, 1.0, 0.0).astype(np.float32),
          "eta": np.where(is_glass, 1.5, u(1.1, 1.8)).astype(np.float32)}
    throughput = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    throughput[rng.random(n) < nan_share, 1] = np.nan
    lanes = {"sd": sd,
             "hit_pos": rng.uniform(-3, 3, (n, 3)).astype(np.float32),
             "i_n": i_n, "n_geom": n_geom,
             "t_vec": _unit_rows(np.cross(i_n, [0.0, 1.0, 0.0])),
             "b_vec": _unit_rows(np.cross(i_n, [1.0, 0.0, 0.0])),
             "direction": d, "throughput": throughput,
             "alive": rng.random(n) < 0.9,
             "spec_mat": sd["roughness"] < 0.01,
             "alpha_cut": rng.random(n) < 0.02,
             "pid": pid.astype(np.int32)}
    return {"lights": packed, "skybox": skybox, "lanes": lanes}


def extend_case(seed: int, n: int, order: str = "tiles", glass: float = 0.2,
                nan_share: float = 0.0) -> dict:
    """Made-up inputs of ``ops/extension.extend`` for ``n`` lanes, from
    ``seed``: ``nee_case``'s lanes (Disney materials with metallic,
    subsurface and a ``glass`` share, a tenth dead, 2 % alpha-cut, a
    ``nan_share`` of NaN throughputs) and what the extension reads
    besides: a hit distance, a third of the lanes on a back face, the
    throughput before the pdf, the last pdf and normal, the specular flag
    (a fifth), and lane seeds over all of uint32. Returns numpy "lanes"
    (``ExtendLanes``' fields, "sd" a dict) and "seed" (int64)."""
    base = nee_case(seed, n, order=order, glass=glass, nan_share=nan_share,
                    sky=(16, 8))["lanes"]
    rng = np.random.default_rng(seed + 1)
    lanes = {k: base[k] for k in ("sd", "hit_pos", "i_n", "n_geom", "t_vec",
                                  "b_vec", "direction")}
    lanes.update(
        t=rng.uniform(0.01, 20.0, n).astype(np.float32),
        backfacing=rng.random(n) < 1 / 3,
        throughput=base["throughput"],
        throughput_predpdf=rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32),
        last_pdf=rng.uniform(0.05, 5.0, n).astype(np.float32),
        last_n=_unit_rows(rng.normal(size=(n, 3))),
        spec_bounce=rng.random(n) < 0.2,
        alive=base["alive"], alpha_cut=base["alpha_cut"],
        spec_mat=base["spec_mat"])
    return {"lanes": lanes,
            "seed": rng.integers(0, 1 << 32, n, dtype=np.int64)}


# ---------------------------------------------------------------------------
# the 1080p slice: the stand-in for the reference bench's pica-4x scene
# ---------------------------------------------------------------------------

def _grid(origin, du, dv, n: int):
    """n x n quads spanning origin + [0,1]du + [0,1]dv, normal du x dv."""
    s = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    uu, vv = np.meshgrid(s, s, indexing="ij")
    pos = (np.asarray(origin, np.float32) + uu[..., None] * du
           + vv[..., None] * dv).reshape(-1, 3)
    i = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
    quads = np.stack([i, i + n + 1, i + n + 2, i + 1], -1).reshape(-1, 4)
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    nrm = np.cross(du, dv).astype(np.float32)
    nrm /= np.linalg.norm(nrm)
    return pos, np.broadcast_to(nrm, pos.shape), faces


def write_ply(path, pos, nrm, faces, uv=None):
    """Binary PLY of positions, normals and, given ``uv``, texture
    coordinates (properties u, v)."""
    props = ["x", "y", "z", "nx", "ny", "nz"] + (["u", "v"] if uv is not None
                                                  else [])
    header = (f"ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(pos)}\n"
              + "".join(f"property float {p}\n" for p in props)
              + f"element face {len(faces)}\n"
              f"property list uchar int vertex_indices\nend_header\n")
    cols = [pos, nrm] + ([uv] if uv is not None else [])
    vert = np.concatenate(cols, axis=1).astype("<f4")
    face = np.zeros(len(faces), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    face["n"] = 3
    face["i"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vert.tobytes())
        f.write(face.tobytes())


def sphere_uv(unit):
    """Spherical projection of unit-sphere vertices."""
    u = 0.5 + np.arctan2(unit[:, 2], unit[:, 0]) / (2.0 * np.pi)
    v = np.arccos(np.clip(unit[:, 1], -1.0, 1.0)) / np.pi
    return np.stack([u, v], axis=1).astype(np.float32)


def _planar_uv(pos, nrm, tile: float = 4.0):
    """Planar projection along each vertex's dominant normal axis, one
    texture repeat every ``tile`` units."""
    axis = np.abs(nrm).argmax(axis=1)
    keep = np.array([[1, 2], [0, 2], [0, 1]])[axis]
    return (np.take_along_axis(pos, keep, axis=1) / tile).astype(np.float32)


def build_slice_scene(rs, workdir: str, materials=None) -> int:
    """A stand-in for the reference bench's pica-4x scene (~305k
    triangles of closed surfaces, absent here): 60 level-4 icospheres on
    a floor, two walls, the bench's lamp quad and test sky. The spheres
    and the room are written as binary PLY with texture coordinates and
    loaded with add_object, the loader path users take. Deterministic
    from SEED. ``materials`` = (sphere material ids, room material id)
    gives sphere i material ``i % len(sphere ids)``, one PLY per sphere
    material; without it, one untextured material each."""
    sv, sf = icosphere(4)
    spheres = [sv * r + c for r, c in sphere_placements()]
    if materials is None:
        materials = slice_materials_plain(rs)
    sphere_m, room_m = materials
    for g, mat in enumerate(sphere_m):
        group = spheres[g::len(sphere_m)]
        path = os.path.join(workdir, f"spheres{g}.ply")
        write_ply(path, np.concatenate(group), np.tile(sv, (len(group), 1)),
                  np.concatenate([sf + i * len(sv)
                                  for i in range(len(group))]),
                  np.tile(sphere_uv(sv), (len(group), 1)))
        rs.add_instance(rs.add_object(path, material_override=mat))
    return len(spheres) * len(sf) + add_room(rs, workdir, room_m)


def sphere_placements():
    """The slice's 60 spheres as (radius, centre), drawn from SEED."""
    rng = np.random.default_rng(SEED)
    out = []
    for ix in range(10):
        for iz in range(6):
            r = rng.uniform(0.7, 1.1)
            c = np.array([(ix - 4.5) * 2.5, r, (iz - 2.5) * 2.5])
            c[[0, 2]] += rng.uniform(-0.3, 0.3, 2)
            out.append((r, c))
    return out


def slice_materials_plain(rs):
    """The untextured slice's sphere and room materials."""
    return ([rs.add_material([0.8, 0.75, 0.7], roughness=0.35,
                             metallic=0.2)],
            rs.add_material([0.6, 0.62, 0.65]))


def add_room(rs, workdir: str, room_m: int) -> int:
    """The slice's floor and two walls (one PLY), the bench's lamp quad,
    the test sky and the 1080p camera. Returns their triangle count."""
    from rfw_tpu_torch.scene import Skybox
    room = [_grid([-20, 0, -20], np.float32([0, 0, 40]),
                  np.float32([40, 0, 0]), 40),                   # floor
            _grid([-20, 0, 15], np.float32([40, 0, 0]),
                  np.float32([0, 20, 0]), 40),                   # back wall
            _grid([-20, 0, -20], np.float32([0, 20, 0]),
                  np.float32([0, 0, 40]), 40)]                   # left wall
    room_ply = os.path.join(workdir, "room.ply")
    off = np.cumsum([0] + [len(p) for p, _, _ in room])
    pos = np.concatenate([p for p, _, _ in room])
    nrm = np.concatenate([n for _, n, _ in room])
    write_ply(room_ply, pos, nrm,
              np.concatenate([f + o for (_, _, f), o in zip(room, off)]),
              _planar_uv(pos, nrm))
    rs.add_instance(rs.add_object(room_ply, material_override=room_m))
    lamp = rs.add_material([40.0, 40.0, 40.0])
    rs.add_instance(rs.add_quad([0, -1, 0], [0, 18.0, 0], 6, 6, lamp))
    rs.set_skybox(Skybox.test_sky())
    rs.camera.resize(1920, 1080)
    rs.camera.fov = 60.0
    rs.camera.look_at([0.0, 12.0, -22.0], [0.0, 1.0, 2.0])
    return sum(len(f) for _, _, f in room) + 2
