"""Seeded synthetic geometry for checks of the traversal, numpy only: a
soup of small random triangles, and a wide BVH deep enough to overflow
the traversal's 64-entry stack. ``chip_smoke.py`` and the tests build
their edge cases from these."""

from __future__ import annotations

import numpy as np


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
