"""SPD ``tetra``: Haines's Standard Procedural Databases' tetrahedral
pyramid (``tetra.c``), a Sierpinski tetrahedron: the tetrahedron on four
corners of the cube [-1, 1]^3, split ``size_factor`` times into four
half-size tetrahedra at its corners; 4**size_factor tetrahedra, four
triangles each. The apex (-1, -1, 1), the SPD's up, is turned to the
renderer's +y.

Parameters (the configuration's ``scene``): ``size_factor``, ``group``
(triangles a bounding sphere in the reference: whole sub-pyramids, as
the tetrahedra come depth first), ``material``.
"""

import numpy as np

CORNERS = np.array([[1, 1, 1], [-1, -1, 1], [-1, 1, -1], [1, -1, -1]],
                   np.float64)
APEX = CORNERS[1] / np.linalg.norm(CORNERS[1])


def up_rotation() -> np.ndarray:
    """The rotation taking the apex direction to +y (Rodrigues)."""
    b = np.array([0.0, 1.0, 0.0])
    v = np.cross(APEX, b)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k / (1.0 + APEX @ b)


def tetrahedra(size_factor: int):
    """Centres (N, 3), depth first, and the common size of the
    ``4**size_factor`` tetrahedra (corner = centre + size * CORNERS)."""
    centres, size = np.zeros((1, 3)), 1.0
    for _ in range(size_factor):
        size *= 0.5
        centres = (centres[:, None, :] + size * CORNERS[None]).reshape(-1, 3)
    return centres, size


def layout(params: dict) -> list[dict]:
    centres, size = tetrahedra(int(params["size_factor"]))
    corners = centres[:, None, :] + size * CORNERS[None]      # (N, 4, 3)
    tris = []
    for j in range(4):
        face = corners[:, [k for k in range(4) if k != j]]    # (N, 3, 3)
        n = np.cross(face[:, 1] - face[:, 0], face[:, 2] - face[:, 0])
        inward = (n * CORNERS[j]).sum(-1) > 0  # faces j: turn
        face[inward] = face[inward][:, ::-1]
        tris.append(face)
    tris = np.stack(tris, axis=1).reshape(-1, 3, 3) @ up_rotation().T
    g = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    pos = tris.reshape(-1, 3).astype(np.float32)
    nrm = np.repeat(g, 3, axis=0).astype(np.float32)
    faces = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
    return [{"mesh": "tetra", "material": params["material"], "pos": pos,
             "nrm": nrm, "faces": faces, "uv": None, "scale": None,
             "translation": None, "group": int(params["group"]),
             "movable": False}]
