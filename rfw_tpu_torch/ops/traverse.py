"""Wide-BVH traversal and the brute-force oracle (torch port of
``rfw_tpu/ops/traverse.py``).

``traverse_wide`` walks the 4-wide BVH of the scene build for a batch of
rays, closest hit or any hit: a hand-written CUDA kernel on CUDA tensors
(``csrc/traverse_kernel.cu``, one thread a ray), and on CPU tensors its
plain PyTorch version ``traverse_wide_ref``, which steps every live ray
through the same fixed-stack loop in lock step. Both follow the
reference's per-ray order exactly, so the kernel equals the plain
version bit for bit:

* a node's 4 child boxes are slab-tested against the best t at node
  entry: ``tfar >= max(tnear, 0) & tnear < t_best & child >= 0``, with
  NaN carried through the min/max as jnp's ``minimum``/``maximum`` do;
* the hit leaf slots are intersected in slot order 0..3, each leaf's
  first ``min(count, leaf_size)`` triangles in order, each against the
  running best with a strict ``<``;
* the hit internal children are pushed so that the nearest pops first,
  on equal ``tnear`` the lower slot (the reference's stable argsort,
  reversed); a push past the 64-entry stack writes its last slot while
  the pointer keeps counting, and a pop past it reads that slot, as
  JAX's clamped scatter and gather do;
* any hit stops after the node in which a hit was recorded.

A dead ray, ``!(t_max > t_epsilon)``, returns ``(t_max, -1, 0, 0)``
without a walk in both: a triangle counts only for ``eps < t < t_best``
and ``t_best`` starts at ``t_max``, so the reference's walk of such a
ray changes nothing.

The kernel reads two tables derived from the build, once per build and
once per refit (``render/scene_data.py``): ``node_table``'s node-major
nodes and ``tri_table``'s triangle-major rows. Left out of the port: the
reference's chunking of large launches (a workaround for its TPU
worker).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .intersect import BIG_T, intersect_tri, safe_inv_dir
from .cuda_lib import check_inputs, launch_counts, ptr

STACK_DEPTH = 64
LEAF_SIZE = 4
MAX_LEAF_SIZE = 8       # the kernel's per-slot field of leaf tests


def node_table(bvh) -> torch.Tensor:
    """The kernel's node-major table of a wide BVH: (N, 8, 4) float32,
    for node n and slot j row j = (bmin xyz, child) and row 4 + j =
    (bmax xyz, count), the ints as their bit patterns. One node is 128
    contiguous bytes, one 16-byte load a slot and bound."""
    child = bvh["child"].contiguous().view(torch.float32)
    count = bvh["count"].contiguous().view(torch.float32)
    lo = torch.cat([bvh["bmin"], child[..., None]], dim=-1)
    hi = torch.cat([bvh["bmax"], count[..., None]], dim=-1)
    return torch.cat([lo, hi], dim=1).contiguous()


def tri_edges(verts):
    """(v0, e1, e2) of triangles ``verts`` (T, 3, 3): e1 = v1 - v0 and
    e2 = v2 - v0, each (T, 3) in the vertices' dtype."""
    return verts[:, 0], verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]


def tri_table(tris) -> torch.Tensor:
    """The kernel's triangle-major table of ``tris`` = (v0, e1, e2), each
    (T, 3): (T, 3, 4) float32, rows (v0, 0), (e1, 0), (e2, 0). A
    triangle is 48 contiguous bytes, three 16-byte loads."""
    t = torch.stack(tris, dim=1).to(torch.float32)
    return torch.nn.functional.pad(t, (0, 1)).contiguous()


def _split_tris(tris):
    """(v0, e1, e2) from a ``tri_table`` or from the tuple itself."""
    if torch.is_tensor(tris):
        return tris[:, 0, :3], tris[:, 1, :3], tris[:, 2, :3]
    return tris


def _slab(lo, hi, o, inv):
    """tnear and tfar of rays (R, 1, 3) against boxes (R, W, 3), the
    axes' minima and maxima chained x, y, z."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin, tmax = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tnear = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]),
                          tmin[..., 2])
    tfar = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]),
                         tmax[..., 2])
    return tnear, tfar


def traverse_wide_ref(origins, directions, bvh, tris,
                      leaf_size: int = LEAF_SIZE, t_max=None,
                      t_epsilon: float = 1e-4, any_hit: bool = False,
                      stats: dict | None = None, walk_dead: bool = False):
    """The plain version of ``traverse_wide``: every ray still walking
    takes one pop a step, until none is left. A leaf's triangles are
    tested in one batch against the best t at node entry, and the first
    of the nearest hits wins, which is what the sequential strict-``<``
    updates give. A dead ray (``!(t_max > t_epsilon)``) does not walk;
    ``walk_dead`` walks it all the same, as the kernel did before its
    exact exit, for counting the work that exit saves (the results are
    the same). ``stats``, when given, receives the work this batch
    needed, summed over the calls that share it: ``visits`` (nodes
    popped) and ``tests`` (triangle tests), the masks ``node_seen`` (N,)
    and ``tri_seen`` (T,) of the nodes popped and the triangles tested at
    least once, which are what a kernel must read, and ``longest``, the
    most nodes one ray popped (the largest over the calls)."""
    dev = origins.device
    n = origins.shape[0]
    v0, e1, e2 = _split_tris(tris)
    w = bvh["child"].shape[1]
    t_best = (torch.full((n,), BIG_T, device=dev) if t_max is None
              else torch.broadcast_to(torch.as_tensor(
                  t_max, dtype=torch.float32, device=dev), (n,)).clone())
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ub = torch.zeros(n, device=dev)
    vb = torch.zeros(n, device=dev)
    inv_dir = safe_inv_dir(directions)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    ptr = torch.ones(n, dtype=torch.int64, device=dev)
    slots = torch.arange(w, device=dev)
    # the leaf tests of a node, slot-major: (slot, i) for i < leaf_size
    leaf_slot = slots.repeat_interleave(leaf_size)
    leaf_i = torch.arange(leaf_size, device=dev).repeat(w)
    visits = tests = steps = 0
    if stats is not None:
        node_seen = stats.setdefault("node_seen", torch.zeros(
            bvh["child"].shape[0], dtype=torch.bool, device=dev))
        tri_seen = stats.setdefault("tri_seen", torch.zeros(
            v0.shape[0], dtype=torch.bool, device=dev))
    live = (torch.arange(n, device=dev) if walk_dead
            else torch.nonzero(t_best > t_epsilon).flatten())
    while live.numel():
        o, inv = origins[live][:, None], inv_dir[live][:, None]
        d = directions[live]
        tb = t_best[live]
        p = ptr[live] - 1
        node = stack[live, torch.clamp(p, max=STACK_DEPTH - 1)].long()
        child, count = bvh["child"][node], bvh["count"][node]     # (L, W)
        tnear, tfar = _slab(bvh["bmin"][node], bvh["bmax"][node], o, inv)
        hit = ((tfar >= torch.clamp(tnear, min=0.0)) & (tnear < tb[:, None])
               & (child >= 0))
        # leaves: slot j, triangle i, in that order
        n_tri = torch.clamp(count & 0x7FFFFFFF, max=leaf_size)
        test = ((hit & (count > 0))[:, leaf_slot]
                & (leaf_i < n_tri[:, leaf_slot]))
        idx = torch.where(test, child[:, leaf_slot] + leaf_i, 0).long()
        th, t, u, v = intersect_tri(
            o, d[:, None], v0[idx], e1[idx], e2[idx], t_epsilon=t_epsilon,
            t_max=tb[:, None])
        t = torch.where(th & test, t, torch.inf)
        k = torch.argmin(t, dim=1)
        rows = torch.arange(live.numel(), device=dev)
        tk = t[rows, k]
        better = tk < tb
        sel = live[better]
        t_best[sel] = tk[better]
        prim[sel] = idx[rows, k][better].int()
        ub[sel] = u[rows, k][better]
        vb[sel] = v[rows, k][better]
        # internal children, the farthest pushed first: slot j goes
        # after every pushed slot whose tnear is larger, or equal with a
        # higher slot
        push = hit & (count < 0)
        key = torch.where(push, tnear, BIG_T)
        before = ((key[:, None, :] > key[:, :, None])
                  | ((key[:, None, :] == key[:, :, None])
                     & (slots[None, :] > slots[:, None])[None]))
        pos = (before & push[:, None, :]).sum(-1)
        for q in range(w):
            at = push & (pos == q)
            do = at.any(1)
            r = live[do]
            where_ = torch.clamp(p[do] + q, max=STACK_DEPTH - 1)
            stack[r, where_] = (child * at).sum(1)[do].int()
        ptr[live] = p + push.sum(1)
        visits += live.numel()
        tests += int(test.sum())
        steps += 1
        if stats is not None:
            node_seen[node] = True
            tri_seen[idx[test]] = True
        go = ptr[live] > 0
        if any_hit:
            go &= prim[live] < 0
        live = live[go]
    if stats is not None:
        stats["visits"] = stats.get("visits", 0) + visits
        stats["tests"] = stats.get("tests", 0) + tests
        stats["longest"] = max(stats.get("longest", 0), steps)
    return t_best, prim, ub, vb


def traverse_wide(origins, directions, bvh, tris, leaf_size: int = LEAF_SIZE,
                  t_max=None, t_epsilon: float = 1e-4,
                  any_hit: bool = False):
    """Closest-hit (or any-hit) traversal of rays (R, 3) through the wide
    BVH ``bvh`` ({bmin, bmax} (N, 4, 3), {child, count} (N, 4) and, for
    the kernel, ``nodes``, ``node_table``'s) over triangles in the
    build's order: ``tri_table``'s (T, 3, 4) table, or the tuple (v0, e1,
    e2) of (T, 3) arrays, of which the kernel makes that table. ``t_max``
    is None, a number or one bound per ray. Returns (t, prim, u, v): t =
    t_max and prim = -1 on a miss. The kernel on CUDA tensors,
    ``traverse_wide_ref`` on CPU tensors."""
    if not cuda_lib.kernel_device(origins, "traversal"):
        return traverse_wide_ref(origins, directions, bvh, tris,
                                 leaf_size=leaf_size, t_max=t_max,
                                 t_epsilon=t_epsilon, any_hit=any_hit)
    dev = origins.device
    n = origins.shape[0]
    nodes = bvh["nodes"]
    table = tris if torch.is_tensor(tris) else tri_table(tris)
    if (origins.shape != (n, 3) or directions.shape != (n, 3)
            or nodes.dim() != 3 or nodes.shape[1:] != (8, 4)
            or table.dim() != 3 or table.shape[1:] != (3, 4)):
        raise ValueError(f"bad shapes: origins {tuple(origins.shape)}, "
                         f"directions {tuple(directions.shape)}, nodes "
                         f"{tuple(nodes.shape)}, triangles "
                         f"{tuple(table.shape)}")
    if not 1 <= leaf_size <= MAX_LEAF_SIZE:
        raise ValueError(f"leaf_size {leaf_size} outside [1, "
                         f"{MAX_LEAF_SIZE}]")
    tm = (torch.full((n,), BIG_T, device=dev) if t_max is None
          else torch.broadcast_to(torch.as_tensor(
              t_max, dtype=torch.float32, device=dev), (n,)).contiguous())
    origins, directions = origins.contiguous(), directions.contiguous()
    check_inputs(dev, origins=(origins, torch.float32),
                  directions=(directions, torch.float32),
                  t_max=(tm, torch.float32), nodes=(nodes, torch.float32),
                  triangles=(table, torch.float32))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, u, v
    with cuda_lib.launch(dev) as (lib, stream):
        err = lib.rfw_traverse(ptr(origins), ptr(directions), ptr(tm), n,
                               ptr(nodes), ptr(table),
                               int(leaf_size), float(t_epsilon),
                               int(any_hit), ptr(t), ptr(prim), ptr(u),
                               ptr(v), stream)
        cuda_lib.check(err, "traverse kernel")
    launch_counts["traverse"] += 1
    return t, prim, u, v


def brute_force_closest(origins, directions, tris, t_epsilon=1e-4,
                        chunk=4096):
    """Closest hit of every ray against every triangle, in triangle
    chunks. Returns (t, prim, u, v); t = BIG_T and prim = -1 on a miss;
    ties go to the lowest triangle index."""
    v0, e1, e2 = tris
    n = origins.shape[0]
    t_best = torch.full((n,), BIG_T, device=origins.device)
    prim = torch.full((n,), -1, dtype=torch.int32, device=origins.device)
    ub = torch.zeros(n, device=origins.device)
    vb = torch.zeros(n, device=origins.device)
    rows = torch.arange(n, device=origins.device)
    for s in range(0, v0.shape[0], chunk):
        hit, t, u, v = intersect_tri(
            origins[:, None, :], directions[:, None, :],
            v0[None, s:s + chunk], e1[None, s:s + chunk],
            e2[None, s:s + chunk], t_epsilon=t_epsilon,
            t_max=t_best[:, None])
        t = torch.where(hit, t, BIG_T)
        k = torch.argmin(t, dim=-1)
        tk = t[rows, k]
        better = tk < t_best
        t_best = torch.where(better, tk, t_best)
        prim = torch.where(better, (k + s).to(torch.int32), prim)
        ub = torch.where(better, u[rows, k], ub)
        vb = torch.where(better, v[rows, k], vb)
    return t_best, prim, ub, vb
