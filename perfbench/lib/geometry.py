"""Frozen numpy helpers of the benchmark's scenes, so that a change to the
program cannot move the yardstick. A scene is made by its generator,
``scenes/<generator>.py``, named in the configuration; this module holds
what every generator shares and nothing about one scene.

A scene's *layout* lists its instances in the order they are added to
the program, each a dict of:

* ``mesh``: the name of its geometry; instances of one name share it;
* ``pos``, ``nrm`` (float32 (V, 3)), ``faces`` (int32 (F, 3)) and ``uv``
  (float32 (V, 2) or None): the object-space mesh as the PLY holds it;
* ``quad`` (or absent): the ``add_quad`` arguments of a mesh the
  program makes itself (``pos``/``nrm``/``faces`` are then its copy);
* ``material``: a key of the configuration's ``materials``;
* ``scale``, ``translation``: float32 (3,), or None for the identity;
* ``group``: triangles a bounding sphere in the reference's brute force,
  or None to test every ray against the whole mesh;
* ``movable``: whether the edit traffic may move it.

``world_instances`` applies the transforms as the program's host does
(float32). Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

SKY_SIZE = (256, 512)


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


def sphere_uv(unit):
    """Spherical projection of unit-sphere vertices."""
    u = 0.5 + np.arctan2(unit[:, 2], unit[:, 0]) / (2.0 * np.pi)
    v = np.arccos(np.clip(unit[:, 1], -1.0, 1.0)) / np.pi
    return np.stack([u, v], axis=1).astype(np.float32)


def z_up_to_y_up(p):
    """A z-up point or direction in the renderer's y-up frame: (x, z, -y),
    a rotation."""
    p = np.asarray(p, np.float64)
    return np.stack([p[..., 0], p[..., 2], -p[..., 1]], axis=-1)


def quad_mesh(normal, position, width: float, height: float):
    """The two-triangle quad centred at ``position`` facing ``normal``, as
    the program's quad generator makes it: (positions, normals,
    faces)."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    pos = np.asarray(position, np.float64)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(n, up)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    t = np.cross(up, n)
    t = t / np.linalg.norm(t)
    b = np.cross(n, t)
    hw, hh = width * 0.5, height * 0.5
    corners = np.stack([pos - hw * t - hh * b, pos + hw * t - hh * b,
                        pos + hw * t + hh * b,
                        pos - hw * t + hh * b]).astype(np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    e1 = corners[2] - corners[0]
    e2 = corners[1] - corners[0]
    if np.dot(np.cross(e1, e2), n) < 0:
        faces = faces[:, ::-1].copy()
    return corners, np.repeat(n[None, :].astype(np.float32), 4, axis=0), faces


def quad_instance(quad: dict) -> dict:
    """A layout entry for a quad of the configuration (``normal``,
    ``position``, ``width``, ``height``, ``material``; ``mesh`` names it),
    made by the program's ``add_quad``."""
    args = {k: quad[k] for k in ("normal", "position", "width", "height")}
    pos, nrm, faces = quad_mesh(**args)
    return {"mesh": quad["mesh"], "material": quad["material"], "quad": args,
            "pos": pos, "nrm": nrm, "faces": faces, "uv": None,
            "scale": None, "translation": None, "group": None,
            "movable": False}


def sky_pixels(sky: dict) -> np.ndarray:
    """The sky the configuration states: ``color``, a constant background
    of that radiance (float32 (H, W, 3))."""
    return np.broadcast_to(np.asarray(sky["color"], np.float32),
                           (*SKY_SIZE, 3)).copy()


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


def triangle_count(layout) -> int:
    return sum(len(inst["faces"]) for inst in layout)


def world_instances(layout, translations=None) -> list[dict]:
    """Each instance's world-space triangles as the program's host
    transforms them (float32 matrix products): ``verts`` (T, 3, 3), unit
    vertex ``normals`` (T, 3, 3) and geometric normals ``gnormal`` (T, 3)
    (the object-space edge cross product, normalised, taken through the
    inverse transpose and normalised again), ``area`` (T,) and
    ``material``. ``translations`` overrides the instances' translations
    (index -> float32 (3,)), as the edit traffic's moves leave them."""
    translations = translations or {}

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                              1e-20)

    out = []
    for i, inst in enumerate(layout):
        v = inst["pos"][inst["faces"]].astype(np.float32)
        n = inst["nrm"][inst["faces"]].astype(np.float32)
        g = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        g = (g / np.maximum(np.linalg.norm(g, axis=-1), 1e-20)[:, None]
             ).astype(np.float32)
        rot, nmat = np.eye(3, dtype=np.float32), np.eye(3, dtype=np.float32)
        tr = np.zeros(3, np.float32)
        if inst["scale"] is not None:
            rot = np.diag(inst["scale"]).astype(np.float32)
            nmat = np.linalg.inv(rot).T.astype(np.float32)
            tr = np.asarray(translations.get(i, inst["translation"]),
                            np.float32)
        v = np.einsum("ij,tvj->tvi", rot, v) + tr
        n = norm(np.einsum("ij,tvj->tvi", nmat, n))
        g = norm(np.einsum("ij,tj->ti", nmat, g))
        area = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0],
                                             v[:, 2] - v[:, 0]), axis=-1)
        out.append({"verts": np.ascontiguousarray(v, np.float32),
                    "normals": np.ascontiguousarray(n, np.float32),
                    "gnormal": np.ascontiguousarray(g, np.float32),
                    "area": area.astype(np.float32),
                    "material": inst["material"]})
    return out


def bounding_sphere(inst, translation=None):
    """(centre (3,), radius) in float64 around an instance's world
    triangles at ``translation`` (default: its own)."""
    tr = {0: translation} if translation is not None else None
    v = world_instances([inst], tr)[0]["verts"].reshape(-1, 3)
    v = v.astype(np.float64)
    c = 0.5 * (v.min(0) + v.max(0))
    return c, float(np.sqrt(((v - c) ** 2).sum(-1).max()))
