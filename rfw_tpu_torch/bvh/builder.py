"""Binned-SAH BVH construction (host, numpy — with optional C++ fast path).

The port's own copy of ``rfw_tpu/bvh/builder.py``, with its logic
unchanged (the port imports nothing of ``rfw_tpu``). It stays for good.

Replaces the reference's Rust ``rtbvh`` crate (BinnedSAH/SBVH builders pulled
via FFI — RFW/system/bvh/CMakeLists.txt:12-47,
bvh_tree.cpp:74-101) and the self-contained C++ builder template
(bvh_node.h:56-233). The build is a host-side preprocessing step; traversal
consumes the flat SoA arrays on device.

Output is a *binary* BVH in SoA form plus a triangle permutation; leaves hold
contiguous triangle ranges, so downstream consumers (wide collapse, treelet
extraction for the MXU intersector) slice permuted triangle arrays directly.

When the native library built from the port's native/bvh_builder.cpp is
available it is used automatically (≈20× faster than the numpy path); both
produce identical output format and are cross-checked in tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclasses.dataclass(eq=False)
class BVH:
    """Binary BVH, SoA. Internal nodes: left child = child[i], right child =
    child[i] + 1, count[i] == 0. Leaves: first[i]/count[i] index the
    *permuted* triangle order ``prim_order``."""

    bmin: np.ndarray        # (N, 3) float32
    bmax: np.ndarray        # (N, 3)
    child: np.ndarray       # (N,) int32 — left child for internal, first for leaf
    count: np.ndarray       # (N,) int32 — 0 internal, else #tris
    prim_order: np.ndarray  # (T,) int32 permutation of input triangles
    depth: np.ndarray       # (N,) int32 node depth (root = 0)

    def __eq__(self, other) -> bool:
        """Field by field, array for array (the dataclass default would
        take the truth value of an array). Any object with the same
        fields compares, rfw_tpu's BVH too."""
        try:
            return all(np.array_equal(getattr(self, f.name),
                                      getattr(other, f.name))
                       for f in dataclasses.fields(self))
        except AttributeError:
            return NotImplemented

    @property
    def node_count(self) -> int:
        return int(self.bmin.shape[0])

    @property
    def max_depth(self) -> int:
        return int(self.depth.max()) if self.node_count else 0

    def validate(self) -> None:
        """Structural invariants (used by tests; SURVEY §4c)."""
        n = self.node_count
        seen = np.zeros(len(self.prim_order), bool)
        for i in range(n):
            if self.count[i] > 0:
                lo, hi = self.child[i], self.child[i] + self.count[i]
                assert 0 <= lo <= hi <= len(self.prim_order)
                seen[lo:hi] = True
            else:
                l = self.child[i]
                assert 0 < l and l + 1 < n
                for c in (l, l + 1):
                    assert (self.bmin[i] <= self.bmin[c] + 1e-4).all()
                    assert (self.bmax[i] >= self.bmax[c] - 1e-4).all()
        assert seen.all(), "every triangle must appear in exactly one leaf"


def _sah_split(cmin, cmax, centroids, tri_min, tri_max, idx):
    """Pick best binned-SAH split for primitive set ``idx``.

    Returns (axis, left_idx, right_idx, cost) or None when unsplittable —
    the binning logic of bvh_node.h:136-233, vectorized.
    """
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] < 1e-12:
        return None
    c = centroids[idx, axis]
    rel = (c - cmin[axis]) / ext[axis]
    bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)

    # per-bin counts and bounds via vectorized min/max-at
    counts = np.bincount(bins, minlength=N_BINS)
    bmin = np.full((N_BINS, 3), np.inf, np.float32)
    bmax = np.full((N_BINS, 3), -np.inf, np.float32)
    np.minimum.at(bmin, bins, tri_min[idx])
    np.maximum.at(bmax, bins, tri_max[idx])

    # prefix/suffix sweeps
    def area(mn, mx):
        d = np.maximum(mx - mn, 0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    lmin = np.minimum.accumulate(bmin, axis=0)
    lmax = np.maximum.accumulate(bmax, axis=0)
    rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
    lcount = np.cumsum(counts)
    rcount = counts.sum() - lcount

    la = area(lmin, lmax)
    ra = np.concatenate([area(rmin[1:], rmax[1:]), [0.0]])
    cost = la * lcount + ra * rcount
    cost = np.where((lcount == 0) | (rcount == 0), np.inf, cost)
    k = int(np.argmin(cost[:-1]))
    if not np.isfinite(cost[k]):
        return None
    mask = bins <= k
    return axis, idx[mask], idx[~mask], float(cost[k])


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray,
              leaf_size: int = 4, use_native: bool = True,
              method: str = "sah") -> BVH:
    """Build over triangle AABBs.

    tri_min/tri_max: (T, 3) per-triangle bounds. ``leaf_size`` is the target
    max primitives per leaf (SAH may terminate earlier). ``method``:
    "sah" (top-down binned SAH, the default — reference rtbvh
    BvhType::BinnedSAH) or "loc" (bottom-up locally-ordered clustering,
    PLOC — rtbvh BvhType::LocallyOrderedClustering, both consumed at
    bvh_tree.cpp:74-101). LOC builds faster on large meshes at slightly
    lower tree quality; it is native-only and falls back to SAH when the
    library is unavailable.
    """
    if method == "loc" and use_native:
        from ..native import native_build_bvh_loc
        out = native_build_bvh_loc(tri_min, tri_max, leaf_size)
        if out is not None:
            return BVH(*out)
    if use_native:
        from ..native import native_build_bvh
        out = native_build_bvh(tri_min, tri_max, leaf_size)
        if out is not None:
            return BVH(*out)
    return _build_bvh_numpy(tri_min, tri_max, leaf_size)


def _build_bvh_numpy(tri_min: np.ndarray, tri_max: np.ndarray,
                     leaf_size: int = 4) -> BVH:
    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    t = tri_min.shape[0]
    assert t > 0, "empty BVH build"
    centroids = 0.5 * (tri_min + tri_max)

    cap = max(2 * t, 16)
    bmin = np.zeros((cap, 3), np.float32)
    bmax = np.zeros((cap, 3), np.float32)
    child = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    depth = np.zeros(cap, np.int32)
    order = np.empty(t, np.int32)

    n_nodes = 1
    n_placed = 0
    # worklist of (node_idx, prim_idx_array, depth)
    stack = [(0, np.arange(t, dtype=np.int64), 0)]
    while stack:
        node, idx, d = stack.pop()
        nb_min = tri_min[idx].min(axis=0)
        nb_max = tri_max[idx].max(axis=0)
        bmin[node], bmax[node], depth[node] = nb_min, nb_max, d

        make_leaf = len(idx) <= leaf_size
        split = None
        if not make_leaf:
            cmin = centroids[idx].min(axis=0)
            cmax = centroids[idx].max(axis=0)
            split = _sah_split(cmin, cmax, centroids, tri_min, tri_max, idx)
            if split is None:
                # degenerate centroid extent: median split to bound leaf size
                if len(idx) > 2 * leaf_size:
                    half = len(idx) // 2
                    split = (0, idx[:half], idx[half:], 0.0)
                else:
                    make_leaf = True

        if make_leaf or split is None:
            child[node] = n_placed
            count[node] = len(idx)
            order[n_placed:n_placed + len(idx)] = idx
            n_placed += len(idx)
            continue

        _, lidx, ridx, _ = split
        l = n_nodes
        n_nodes += 2
        child[node] = l
        count[node] = 0
        stack.append((l + 1, ridx, d + 1))
        stack.append((l, lidx, d + 1))

    return BVH(
        bmin=bmin[:n_nodes].copy(), bmax=bmax[:n_nodes].copy(),
        child=child[:n_nodes].copy(), count=count[:n_nodes].copy(),
        prim_order=order, depth=depth[:n_nodes].copy(),
    )


def triangle_bounds(vertices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(T, 3, 3) triangle vertices → (tri_min, tri_max), epsilon-padded the
    way the reference pads flat AABBs (bvh_tree.cpp:388-452)."""
    tmin = vertices.min(axis=1) - 1e-6
    tmax = vertices.max(axis=1) + 1e-6
    return tmin.astype(np.float32), tmax.astype(np.float32)
