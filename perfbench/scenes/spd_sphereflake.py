"""SPD ``balls``: Haines's Standard Procedural Databases' sphereflake
(``balls.c``): a sphere of radius 0.5 at the origin, and on every sphere
of the first ``size_factor`` generations nine of a third its radius,
touching it, six round its equator and three above, each facing away
from its parent; 1 + 9 + ... + 9**size_factor spheres, on a ground
square at the root's foot. z-up in the SPD, turned to the renderer's
y-up. Each sphere is an instance (scale r, translation c) of one
icosphere of ``sphere_level`` subdivisions, the renderer's only surface
being triangles.

Parameters (the configuration's ``scene``): ``size_factor``,
``sphere_level``, ``movable_generations`` (the spheres of the first
generations that the edit traffic may move), ``sphere_material``,
``ground`` (a quad: ``normal``, ``position``, ``width``, ``height``,
``material``, ``mesh``).
"""

import math

import numpy as np

from perfbench.lib import geometry


def _axis_rotation(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * k @ k


def child_directions() -> np.ndarray:
    """The nine unit offsets of the children about +z (balls.c's object
    set: a trio of cube edge directions tilted by asin(2 / sqrt 6) about
    (1, -1, 0), turned by 0, 120 and 240 degrees about z)."""
    d = 1.0 / math.sqrt(2.0)
    trio = np.array([[d, d, 0.0], [d, 0.0, -d], [0.0, d, -d]])
    trio = trio @ _axis_rotation([1, -1, 0],
                                 math.asin(2.0 / math.sqrt(6.0))).T
    return np.concatenate([trio @ _axis_rotation([0, 0, 1],
                                                 s * 2 * math.pi / 3).T
                           for s in range(3)])


def _frame(direction) -> np.ndarray:
    """The least rotation taking +z to ``direction``."""
    z = np.array([0.0, 0.0, 1.0])
    c = float(z @ direction)
    if c < -1.0 + 1e-12:
        return np.diag([1.0, -1.0, -1.0])
    v = np.cross(z, direction)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k / (1.0 + c)


def spheres(size_factor: int):
    """(centre (3,), radius, generation) of every sphere, generation by
    generation, in the SPD's z-up frame."""
    kids = child_directions()
    gen = [(np.zeros(3), 0.5, np.array([0.0, 0.0, 1.0]))]
    out = [(gen[0][0], gen[0][1], 0)]
    for g in range(1, size_factor + 1):
        nxt = []
        for c, r, d in gen:
            for k in kids @ _frame(d).T:
                nxt.append((c + k * (r + r / 3.0), r / 3.0, k))
        out += [(c, r, g) for c, r, _ in nxt]
        gen = nxt
    return out


def layout(params: dict) -> list[dict]:
    sv, sf = geometry.icosphere(int(params["sphere_level"]))
    uv = geometry.sphere_uv(sv)
    movable = int(params["movable_generations"])
    out = []
    for c, r, g in spheres(int(params["size_factor"])):
        out.append({"mesh": "sphere", "material": params["sphere_material"],
                    "pos": sv, "nrm": sv, "faces": sf, "uv": uv,
                    "scale": np.full(3, r, np.float32),
                    "translation": geometry.z_up_to_y_up(c).astype(
                        np.float32),
                    "group": len(sf), "movable": g < movable})
    out.append(geometry.quad_instance(params["ground"]))
    return out
