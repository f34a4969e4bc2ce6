"""The TLAS walk's two kernels, on the CPU, through their plain versions
(``rfw_tpu_torch/bvh/tlas.py``): ``premask_ref`` and ``walk_group_ref``,
composed BLAS by BLAS by ``walk_groups`` as the card runs the two
kernels, against ``walk_ref`` (the walk with a host read a BLAS) and
against rfw_tpu's ``tlas`` intersector, also on the made-up inputs of
``utils/synthetic.py::tlas_cases`` (dead lanes inside a box, every lane
live, no lane crossing, coincident instances), with the premask's list
of walking lanes against the rays the plain walk walked; a per-ray
emulation of ``tlas_walk_kernel``'s loop over the list and the tensors
the wrapper hands it; the rows an instance move refreshes; and the
dispatch (CPU tensors count no launch, an unknown device raises).

Tolerances: the plain versions against each other and the emulation,
bit for bit (the same float32 operations in the same order); against
rfw_tpu, tests/test_visit.py's bars (hit masks equal, prim agreement >
0.999, relative t < 1e-4: the object-space rays are fixed-order sums
here and XLA's matrix products there).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.config import RenderConfig as JConfig
from rfw_tpu.render import intersectors as j_isect
from rfw_tpu.render import scene_data as j_sd
from rfw_tpu.scene.mesh import build_triangles as j_build_triangles

from rfw_tpu_torch.bvh import tlas
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib, traverse
from rfw_tpu_torch.ops.intersect import BIG_T
from rfw_tpu_torch.render import RenderStatus, create_engine
from rfw_tpu_torch.render import intersectors, scene_data
from rfw_tpu_torch.scene import HostMaterial, MaterialList, make_quad
from rfw_tpu_torch.scene.lights import pack_lights
from rfw_tpu_torch.scene.mesh import build_triangles
from rfw_tpu_torch.utils import synthetic

EPS = 1e-4


@pytest.fixture(autouse=True)
def _no_scene_cache(monkeypatch):
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")


def _mesh(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * scale
    return np.stack([
        v0, v0 + rng.uniform(-.7, .7, (n, 3)).astype(np.float32) * scale,
        v0 + rng.uniform(-.7, .7, (n, 3)).astype(np.float32) * scale], 1)


def _xform(t, s=1.0, angle=0.0):
    c, sn = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]],
                         np.float32) * s
    m[:3, 3] = t
    return m


# two meshes, five instances: mesh 0 four times (two of them coincident,
# so their hits tie in t), mesh 1 once, between them
PLACED = [(0, _xform([0, 0, 0])), (1, _xform([2.5, 0.3, 0.5], s=1.3)),
          (0, _xform([-2.5, 0.3, 0], angle=0.7)),
          (0, _xform([0, 0, 0])),
          (0, _xform([0, -2.5, 0.2], s=0.5, angle=-1.1))]
MESHES = [_mesh(120, 3), _mesh(60, 4, scale=0.6)]


def _instances(mod, build, placed=PLACED):
    out = []
    for iid, (slot, m) in enumerate(placed):
        v = MESHES[slot]
        tris = build(v.reshape(-1, 3),
                     np.arange(v.shape[0] * 3).reshape(-1, 3))
        out.append(mod.InstancedMesh(triangles=tris, transform=m,
                                     instance_id=iid, mesh_slot=slot))
    return out


def _perm():
    n = sum(MESHES[s].shape[0] for s, _ in PLACED)
    return np.random.default_rng(0).permutation(n)


def _port_tables(placed=PLACED):
    tables = scene_data._build_tlas_tables(
        _instances(scene_data, build_triangles, placed), _perm())
    return scene_data.scene_to_torch({"tlas": tables}, "cpu")["tlas"]


def _rays(n=192, seed=5, edges=True):
    """Rays from in front of the instances towards points among them;
    with ``edges``
    every 8th has a zero (or -0.0) direction component, one a NaN
    component, one a zero direction and one a NaN origin."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] -= 8.0
    to = rng.uniform((-3.5, -3.0, -1.0), (3.5, 1.5, 1.0), (n, 3))
    d = (to - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if edges:
        d[1::8, 0] = 0.0
        d[2::8, 1] = -0.0
        d[3::8, 2] = 0.0
        d[4::8, :2] = 0.0
        d[5::32, 1] = np.nan
        d[6::32] = 0.0
        o[7::32] = np.nan
    return torch.from_numpy(o), torch.from_numpy(d)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("ray_chunk", [64, 65536])
@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_groups_equal_walk_ref(any_hit, ray_chunk):
    """premask_ref + visit_order + walk_group_ref, BLAS by BLAS
    (walk_groups on CPU tensors, what the card's two kernels compute),
    equal walk_ref bit for bit: closest and any hit, one premask chunk or
    many, NaN and zero direction components; any hit under per-ray
    bounds."""
    tables = _port_tables()
    o, d = _rays()
    t_max = (torch.linspace(0.5, 12.0, o.shape[0]) if any_hit else BIG_T)
    want = tlas.walk_ref(tables, o, d, t_max, EPS, any_hit, ray_chunk)
    got = tlas.walk_groups(tables, o, d, t_max, EPS, any_hit, ray_chunk)
    assert _equal(got, want)
    assert (want[1] >= 0).sum() > 20 and (want[1] < 0).sum() > 20
    assert torch.equal(tlas.walk(tables, o, d, t_max, EPS, any_hit,
                                 ray_chunk)[1], want[1])


def test_premask_and_visit_order():
    """The premask's tn_min is the least max(tnear, 0) over the crossing
    rays (+0.0 where a ray starts on a box face, never -0.0), BIG_T for
    an instance no ray crosses; the visit order puts the crossed
    instances first, front to back, ties in instance order; both stay
    tensors (count (1,) int32)."""
    rows = _port_tables()["blas"][0]
    lo, hi = rows["inst_bmin"], rows["inst_bmax"]
    c = (lo[0] + hi[0]) * 0.5
    # ray 0 starts on box 0's +x face, leaving it along -x: its tnear is
    # 0 * -1 = -0.0; ray 1 runs along +z through box 0's middle, which
    # row 2's coincident instance shares
    o = torch.stack([torch.stack([hi[0, 0], c[1], c[2]]),
                     torch.stack([c[0], c[1], torch.tensor(-40.0)])])
    d = torch.tensor([[-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    best_t = torch.full((2,), 1e30)
    cross, tn_min, lanes, n_lanes = tlas.premask_ref(
        lo, hi, o, tlas.safe_inv_box_dir(d), best_t, EPS)
    assert lanes.tolist() == [0, 1] and n_lanes.tolist() == [2]
    assert cross[0] and cross[2]
    assert _bits(tn_min[0]) == 0 and _bits(tn_min[2]) == 0   # not -0.0
    assert (tn_min[~cross] == BIG_T).all()
    order, count = tlas.visit_order(cross, tn_min)
    assert order.dtype == torch.int32 and count.dtype == torch.int32
    assert count.shape == (1,) and int(count) == int(cross.sum())
    lead = order[:int(count)].long()
    assert cross[lead].all()
    keys = tn_min[lead]
    assert (keys[1:] >= keys[:-1]).all()
    # instances 0 and 2 are coincident: equal keys keep instance order
    assert (order == 0).nonzero() < (order == 2).nonzero()


def test_coincident_instances_first_walked_wins():
    """Two coincident instances of one mesh (0 and 2 of BLAS 0) hit at
    one t: the one walked first, the lower instance, wins in the port
    (walk_ref and walk_groups) and in rfw_tpu."""
    tables = _port_tables()
    rows = tables["blas"][0]
    o, d = _rays(edges=False)
    t, orig, _, _ = tlas.walk_groups(tables, o, d, BIG_T, EPS)
    base = rows["inst_base"]          # instance order: 0, 2, 3, 4 of PLACED
    n0 = MESHES[0].shape[0]
    on_first = (orig >= base[0]) & (orig < base[0] + n0)
    on_twin = (orig >= base[2]) & (orig < base[2] + n0)
    assert on_first.sum() > 5 and not on_twin.any()
    assert _equal((t, orig), tlas.walk_ref(tables, o, d, BIG_T, EPS)[:2])
    j_t, j_prim = _rfw_tpu_closest(o, d)
    _agree(t.numpy(), orig.numpy(), j_t, np.argsort(_perm())[j_prim],
           j_prim >= 0)
    j_orig = np.argsort(_perm())[j_prim[j_prim >= 0]]
    assert not ((j_orig >= int(base[2])) & (j_orig < int(base[2]) + n0)).any()


def _agree(t, orig, j_t, j_orig, j_hit):
    """tests/test_visit.py's bars: hit masks equal, ids agreeing on >
    0.999 of the hits, relative t below 1e-4."""
    hit = orig >= 0
    assert hit.sum() > 20 and np.array_equal(hit, j_hit)
    assert (orig[hit] == j_orig[hit]).mean() > 0.999
    rel = np.abs(t[hit] - j_t[hit]) / np.maximum(np.abs(j_t[hit]), 1e-6)
    assert rel.max() < 1e-4


def _rfw_tpu_tables(placed=PLACED):
    tables = j_sd._build_tlas_tables(
        _instances(j_sd, j_build_triangles, placed), _perm())
    return jax.tree_util.tree_map(jnp.asarray, tables)


def _rfw_tpu_closest(o, d, dist=None, placed=PLACED, t_max=None):
    isect = j_isect.FACTORIES["tlas"](JConfig(use_tlas=True))
    scene = {"tlas": _rfw_tpu_tables(placed)}
    if dist is not None:
        return np.asarray(isect.occluded(scene, jnp.asarray(o.numpy()),
                                         jnp.asarray(d.numpy()),
                                         jnp.asarray(dist.numpy())))
    t, prim, _, _ = isect.closest(
        scene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        None if t_max is None else jnp.asarray(t_max.numpy()))
    return np.asarray(t), np.asarray(prim)


def test_walk_groups_match_rfw_tpu_intersector(monkeypatch):
    """The port's tlas intersector on the plain composition of the two
    kernels against rfw_tpu's tlas intersector on rfw_tpu's tables of
    the same instances, closest and occluded, at the test_visit bars;
    64-ray premask chunks in rfw_tpu."""
    monkeypatch.setattr(j_isect, "_TLAS_RAY_CHUNK", 64)
    monkeypatch.setattr(tlas, "walk", tlas.walk_groups)
    o, d = _rays(edges=False)
    scene = {"tlas": _port_tables()}
    isect = intersectors.make_intersector("tlas",
                                          RenderConfig(use_tlas=True))
    t, prim, _, _ = (x.numpy() for x in isect.closest(scene, o, d))
    j_t, j_prim = _rfw_tpu_closest(o, d)
    _agree(t, prim, j_t, j_prim, j_prim >= 0)
    dist = torch.from_numpy(np.where(np.arange(o.shape[0]) % 2 == 0,
                                     t * 0.5, t * 1.5).astype(np.float32))
    occ = isect.occluded(scene, o, d, dist).numpy()
    assert np.array_equal(occ, _rfw_tpu_closest(o, d, dist))
    assert occ.any() and not occ.all()


# -- made-up inputs (utils/synthetic.py::tlas_cases) -------------------------

# instance 1 of BLAS 0's group is PLACED[2]; the coincident cases put it
# on instance 0 (PLACED[0]), as tlas_cases' rows copy asks
TWIN_PLACED = [PLACED[0], PLACED[1], PLACED[0], *PLACED[3:]]
CASES = ("dead_inside", "all_live", "none_cross", "coincident_closest",
         "coincident_any")


@pytest.mark.parametrize("case", CASES)
def test_made_up_cases(case, monkeypatch):
    """tlas_cases' inputs on BLAS 0's group (4 instances, 2 of them
    already coincident), from _rays: walk_groups (premask_ref,
    visit_order, walk_group_ref BLAS by BLAS) equals walk_ref bit for
    bit; every group's list of walking lanes equals the rays
    walk_group_ref walked (``stats["walked"]``, in order) and the rest of
    the list the others; dead lanes inside a box set their instance's
    tn_min to 0 and stay off the list; all-live lists every lane of BLAS
    0's group, none-cross none anywhere; the coincident pair's ties go to
    the instance walked first. Against rfw_tpu's tlas intersector on the
    same instances (the twin placed on instance 0 by its transform): hit
    masks and hit triangles equal, t within 1e-4 relative (object-space
    rays are fixed-order sums here, XLA's matrix products there)."""
    placed = TWIN_PLACED if case.startswith("coincident") else PLACED
    tables = _port_tables()
    rows = tables["blas"][0]
    o, d = _rays(edges=False)
    lo, hi = rows["inst_bmin"].numpy(), rows["inst_bmax"].numpy()
    o_n, d_n, t_n, any_hit, twin = synthetic.tlas_cases(
        lo, hi, o.numpy(), d.numpy(),
        np.full(o.shape[0], BIG_T, np.float32), seed=3)[case]
    o, d, t_max = (torch.from_numpy(x) for x in (o_n, d_n, t_n))
    if twin:
        rows = dict(rows)
        for k in ("inst_inv", "inst_bmin", "inst_bmax"):
            rows[k] = rows[k].clone()
            rows[k][1] = rows[k][0]
        tables = {"blas": (rows, *tables["blas"][1:])}
        placed_rows = _port_tables(placed)["blas"][0]
        assert all(_equal((placed_rows[k],), (rows[k],))
                   for k in ("inst_inv", "inst_bmin", "inst_bmax",
                             "inst_base"))

    walks = []
    walk_group = tlas.walk_group

    def held(rows_, o_, d_, state, order, count, lanes, n_lanes, *a):
        stats = {}
        tlas.walk_group_ref(rows_, o_, d_, state, order, count, *a,
                            stats=stats)
        walks.append((lanes, n_lanes, stats["walked"], state))
        return walk_group(rows_, o_, d_, state, order, count, lanes, n_lanes,
                          *a)

    monkeypatch.setattr(tlas, "walk_group", held)
    got = tlas.walk_groups(tables, o, d, t_max, EPS, any_hit)
    want = tlas.walk_ref(tables, o, d, t_max, EPS, any_hit)
    assert _equal(got, want)
    assert len(walks) == len(tables["blas"])
    for lanes, n_lanes, walked, _ in walks:
        k = int(n_lanes[0])
        assert torch.equal(lanes[:k].long(), walked.nonzero()[:, 0])
        assert torch.equal(lanes[k:].long(), (~walked).nonzero()[:, 0])

    n = o.shape[0]
    listed = [int(w[1][0]) for w in walks]
    hit = got[1] >= 0
    if case == "dead_inside":
        dead = t_max == 0
        cross, tn_min, lanes, n_lanes = tlas.premask_ref(
            rows["inst_bmin"], rows["inst_bmax"], o,
            tlas.safe_inv_box_dir(d), t_max, EPS)
        assert cross.all() and (tn_min == 0).all()
        assert not dead[lanes[:int(n_lanes[0])].long()].any()
        assert torch.equal(got[0][dead], t_max[dead]) and not hit[dead].any()
        assert 0 < listed[0] < n
    elif case == "all_live":
        assert listed[0] == n and hit.sum() > n // 2
    elif case == "none_cross":
        assert listed == [0] * len(walks) and not hit.any()
        assert _equal(got, tlas.start_state(o, t_max))
    else:
        base = rows["inst_base"]
        n0 = MESHES[0].shape[0]
        on = [(got[1] >= base[i]) & (got[1] < base[i] + n0)
              for i in range(3)]
        assert hit.sum() > n // 2 and on[0].sum() > n // 4
        assert not (on[1] | on[2]).any()

    if any_hit:
        occ = _rfw_tpu_closest(o, d, dist=t_max, placed=placed)
        assert np.array_equal(hit.numpy(), occ)
        return
    j_t, j_prim = _rfw_tpu_closest(o, d, placed=placed, t_max=t_max)
    j_hit = j_prim >= 0
    assert np.array_equal(hit.numpy(), j_hit)
    j_orig = np.argsort(_perm())[j_prim[j_hit]]
    assert np.array_equal(got[1].numpy()[j_hit], j_orig)
    t, jt = got[0].numpy()[j_hit], j_t[j_hit]
    assert (np.abs(t - jt) / np.maximum(np.abs(jt), 1e-6)).max(
        initial=0.0) < 1e-4


# -- a per-ray emulation of tlas_walk_kernel ---------------------------------

F = np.float32


def _tmin(a, b):
    return F(np.nan) if np.isnan(a) or np.isnan(b) else min(a, b)


def _tmax(a, b):
    return F(np.nan) if np.isnan(a) or np.isnan(b) else max(a, b)


def _slab(lo, hi, o, inv):
    """tnear, tfar as the kernels chain them, x, y, z."""
    t1 = [(F(lo[k]) - o[k]) * inv[k] for k in range(3)]
    t2 = [(F(hi[k]) - o[k]) * inv[k] for k in range(3)]
    tn = _tmax(_tmax(_tmin(t1[0], t2[0]), _tmin(t1[1], t2[1])),
               _tmin(t1[2], t2[2]))
    tf = _tmin(_tmin(_tmax(t1[0], t2[0]), _tmax(t1[1], t2[1])),
               _tmax(t1[2], t2[2]))
    return tn, tf


def _test_tri(o, d, tris, idx, eps, best):
    a, e1, e2 = (tris[12 * idx + 4 * r:12 * idx + 4 * r + 3]
                 for r in range(3))
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    valid = abs(det) > F(1e-12)
    inv_det = F(1.0) / det if valid else F(0.0)
    tx, ty, tz = o[0] - a[0], o[1] - a[1], o[2] - a[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    if (valid and F(0) <= u <= F(1) and v >= F(0) and u + v <= F(1)
            and eps < t < best[0]):
        best[:] = [t, u, v, idx]


def _walk_bvh(o, d, nodes, nodes_i, tris, leaf_size, eps, any_hit, best):
    """bvh_walk.cuh's walk_bvh: a node is 32 floats, slot j's (bmin,
    child) at 4 j and (bmax, count) at 16 + 4 j."""
    inv = [F(1.0) / ((F(-1e-12) if x < 0 else F(1e-12))
                     if abs(x) < F(1e-12) else x) for x in d]
    stack, ptr = [0] * traverse.STACK_DEPTH, 1
    while True:
        node = stack[min(ptr - 1, traverse.STACK_DEPTH - 1)]
        ptr -= 1
        t_entry = best[0]
        tnear, child, push, todo = [], [], [], []
        for j in range(4):
            at = 32 * node + 4 * j
            tn, tf = _slab(nodes[at:at + 3], nodes[at + 16:at + 19], o, inv)
            child.append(int(nodes_i[at + 3]))
            count = int(nodes_i[at + 19])
            hit = (tf >= _tmax(tn, F(0.0)) and tn < t_entry
                   and child[j] >= 0)
            tnear.append(tn)
            push.append(hit and count < 0)
            if hit and count > 0:
                todo += [(j, i) for i in range(min(count & 0x7FFFFFFF,
                                                   leaf_size))]
        for j, i in todo:
            _test_tri(o, d, tris, child[j] + i, eps, best)
        pos = [sum(push[k] and (tnear[k] > tnear[j] or (
            tnear[k] == tnear[j] and k > j)) for k in range(4))
            for j in range(4)]
        pushed = 0
        for q in range(4):
            for j in range(4):
                if push[j] and pos[j] == q:
                    stack[min(ptr + q, traverse.STACK_DEPTH - 1)] = child[j]
                    pushed += 1
        ptr += pushed
        if not (ptr > 0 and not (any_hit and best[3] >= 0)):
            return


def _walk_batch():
    """kTlasWalkBatch of the shipped kernel source."""
    src = os.path.join(os.path.dirname(cuda_lib.SOURCES[0]),
                       "tlas_kernel.cu")
    with open(src) as f:
        return int(re.search(r"constexpr int kTlasWalkBatch = (\d+);",
                             f.read()).group(1))


def _emulate_walk_kernel(rows, o, d, state, order, count, lanes, n_lanes,
                         eps, any_hit):
    """tlas_walk_kernel, one thread j at a time, over the flat buffers of
    the tensors the wrapper hands it (``group_buffers``; the state, list,
    order and counts as int32/float32 arrays), float32 arithmetic
    throughout: thread j takes ray lanes[j], walks it below n_lanes (the
    next kTlasWalkBatch boxes tested at the current best t, the first hit
    walked, the scan going on after it) and copies its state past it."""
    bmin, bmax, inv_m, base, nodes, tris, prim_order = (
        b.numpy().reshape(-1) for b in tlas.group_buffers(rows))
    nodes_i = nodes.view(np.int32)
    o, d = o.numpy(), d.numpy()
    t_in, orig_in, u_in, v_in = (x.numpy() for x in state)
    order = order.numpy().astype(np.int32, casting="no")
    lanes = lanes.numpy().astype(np.int32, casting="no")
    touched = int(count.numpy().astype(np.int32, casting="no")[0])
    listed = int(n_lanes.numpy().astype(np.int32, casting="no")[0])
    batch = _walk_batch()
    out = [np.full_like(t_in, np.nan), np.full_like(orig_in, -7),
           np.full_like(u_in, np.nan), np.full_like(v_in, np.nan)]

    def box(i, orr, inv, cap):
        tn, tf = _slab(bmin[3 * i:3 * i + 3], bmax[3 * i:3 * i + 3], orr,
                       inv)
        return tf >= _tmax(tn, F(0.0)) and tn < cap

    for j in range(o.shape[0]):
        r = int(lanes[j])
        bt, bo, bu, bv = t_in[r], int(orig_in[r]), u_in[r], v_in[r]
        orr, dr = o[r], d[r]
        inv = [F(1.0) / (F(1e-12) if abs(x) < F(1e-12) else x) for x in dr]
        q = 0
        while j < listed:
            if q >= touched or (any_hit and bo >= 0) or not bt > eps:
                break
            hits = [b for b in range(batch) if q + b < touched
                    and box(int(order[q + b]), orr, inv, bt)]
            if not hits:
                q += batch
                continue
            q += hits[0] + 1
            i = int(order[q - 1])
            m = inv_m[16 * i:16 * i + 16]
            oo = [orr[0] * m[4 * k] + orr[1] * m[4 * k + 1]
                  + orr[2] * m[4 * k + 2] + m[4 * k + 3]
                  for k in range(3)]
            dd = [dr[0] * m[4 * k] + dr[1] * m[4 * k + 1]
                  + dr[2] * m[4 * k + 2] for k in range(3)]
            best = [bt, F(0.0), F(0.0), -1]
            _walk_bvh(oo, dd, nodes, nodes_i, tris, traverse.LEAF_SIZE,
                      F(eps), any_hit, best)
            if best[3] >= 0:
                bt, bu, bv = best[0], best[1], best[2]
                bo = int(base[i]) + int(prim_order[best[3]])
        out[0][r], out[1][r], out[2][r], out[3][r] = bt, bo, bu, bv
    return tuple(torch.from_numpy(x) for x in out)


def _shuffled(lanes, n_lanes, seed):
    """The plain list with each part in a seeded order, as the kernel's
    parts come in an order that changes from run to run."""
    rng = np.random.default_rng(seed)
    a = lanes.numpy().copy()
    k = int(n_lanes[0])
    a[:k], a[k:] = rng.permutation(a[:k]), rng.permutation(a[k:])
    return torch.from_numpy(a)


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_emulation_equals_walk_ref(any_hit):
    """The emulation of tlas_walk_kernel, BLAS by BLAS after the plain
    premask (its list of lanes, each part shuffled) and visit order,
    equals walk_group_ref launch by launch and walk_ref at the end, bit
    for bit: the kernel's reading of the wrapper's buffers (dtypes,
    strides, inst_inv's rows), its walk over the listed rays only and its
    copy of the others are right, in any order of the list."""
    tables = _port_tables()
    o, d = _rays()
    t_max = torch.linspace(0.5, 12.0, o.shape[0]) if any_hit else BIG_T
    state = tlas.start_state(o, t_max)
    emulated = state
    listed = []
    for g, rows in enumerate(tables["blas"]):
        cross, tn_min, lanes, n_lanes = tlas.premask_ref(
            rows["inst_bmin"], rows["inst_bmax"], o,
            tlas.safe_inv_box_dir(d), state[0], EPS,
            state[1] if any_hit else None)
        order, count = tlas.visit_order(cross, tn_min)
        want = tlas.walk_group_ref(rows, o, d, state, order, count, EPS,
                                   any_hit)
        with np.errstate(all="ignore"):
            got = _emulate_walk_kernel(rows, o, d, state, order, count,
                                       _shuffled(lanes, n_lanes, g),
                                       n_lanes, EPS, any_hit)
        assert _equal(got, want)
        listed.append(int(n_lanes[0]))
        state = emulated = want
    assert _equal(emulated, tlas.walk_ref(tables, o, d, t_max, EPS, any_hit))
    assert (emulated[1] >= 0).sum() > 10
    assert all(0 < k < o.shape[0] for k in listed)


def test_group_buffers_check_the_layout():
    rows = dict(_port_tables()["blas"][0])
    bufs = tlas.group_buffers(rows)
    assert [b.dtype for b in bufs] == [torch.float32] * 3 + [torch.int32] \
        + [torch.float32] * 2 + [torch.int32]
    assert all(b.is_contiguous() for b in bufs)
    with pytest.raises(TypeError, match="inst_inv has dtype"):
        tlas.group_buffers({**rows, "inst_inv": rows["inst_inv"].double()})
    with pytest.raises(ValueError, match="inst_inv must be contiguous"):
        tlas.group_buffers({**rows, "inst_inv":
                            rows["inst_inv"].transpose(1, 2)})
    with pytest.raises(ValueError, match="inst_bmin has shape"):
        tlas.group_buffers({**rows, "inst_bmin": rows["inst_bmin"][:, :2]})


# -- instance moves -----------------------------------------------------------

def _quad_engine(moved=None):
    eng = create_engine("megakernel", RenderConfig(
        blue_noise=False, max_path_length=1, russian_roulette=False),
        device="cpu")
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    ml.add(HostMaterial(color=np.array([6.0, 5.0, 4.0])))
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0).triangles())
    eng.set_mesh(2, make_quad([0, -1, 0], [0, 4, 0], 2, 2, 1).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, _xform([-2.0, 0.0, 0.5]) if moved is None
                     else moved)
    eng.set_instance(2, 1, _xform([2.0, 0.3, 0.0], s=0.8, angle=0.6))
    eng.set_instance(3, 2, np.eye(4, dtype=np.float32))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights([], [], [], []))
    eng.set_setting("intersector", "tlas")
    eng.resize(8, 8)
    eng.update()
    return eng


def test_move_refreshes_the_rows_the_kernels_read(monkeypatch):
    """After an instance move (the device update, no full build),
    every buffer the walk kernel reads, and the premask's boxes, equal a
    fresh build's of the moved scene, bit for bit."""
    eng = _quad_engine()
    before = [tlas.group_buffers(b) for b in eng._scene["tlas"]["blas"]]
    builds = {"n": 0}
    real = scene_data.build_device_scene

    def counting(*a, **k):
        builds["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(scene_data, "build_device_scene", counting)
    target = _xform([1.5, 0.3, 0.0], angle=0.4)
    eng.set_instance(1, 1, target)
    eng.update()
    assert builds["n"] == 0
    moved = [tlas.group_buffers(b) for b in eng._scene["tlas"]["blas"]]
    monkeypatch.setattr(scene_data, "build_device_scene", real)
    fresh = [tlas.group_buffers(b)
             for b in _quad_engine(moved=target)._scene["tlas"]["blas"]]
    assert len(moved) == len(fresh) == 3
    for a, b in zip(moved, fresh):
        assert _equal(a, b)
    # the moved instance's rows changed, the BLAS tables stayed
    assert not torch.equal(before[1][2], moved[1][2])
    assert moved[1][4] is before[1][4]
    view = eng.render_frame(_view(), RenderStatus.RESET, samples=1)
    assert np.isfinite(view).all()


def _view():
    from rfw_tpu_torch import Camera
    cam = Camera()
    cam.resize(8, 8)
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    return cam.get_view().as_pytree()


# -- dispatch -----------------------------------------------------------------

def test_cpu_tensors_count_no_launch():
    tables = _port_tables()
    o, d = _rays(n=64)
    before = dict(cuda_lib.launch_counts)
    tlas.walk(tables, o, d, BIG_T, EPS)
    tlas.walk_groups(tables, o, d, BIG_T, EPS, any_hit=True)
    rows = tables["blas"][0]
    state = tlas.start_state(o, BIG_T)
    cross, tn_min, lanes, n_lanes = tlas.premask(
        rows["inst_bmin"], rows["inst_bmax"], o, d, state[0], EPS)
    tlas.walk_group(rows, o, d, state, *tlas.visit_order(cross, tn_min),
                    lanes, n_lanes, EPS)
    assert cuda_lib.launch_counts == before


def test_unknown_device_raises():
    tables = _port_tables()
    o, d = (x.to("meta") for x in _rays(n=8))
    rows = tables["blas"][0]
    with pytest.raises(RuntimeError, match="no tlas kernels for device meta"):
        tlas.walk(tables, o, d, BIG_T, EPS)
    with pytest.raises(RuntimeError, match="no tlas kernels for device meta"):
        tlas.premask(rows["inst_bmin"], rows["inst_bmax"], o, d,
                     torch.full((8,), 1.0, device="meta"), EPS)
    state = tlas.start_state(o, BIG_T)
    with pytest.raises(RuntimeError, match="no tlas kernels for device meta"):
        tlas.walk_group(rows, o, d, state, torch.zeros(4, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32),
                        torch.arange(8, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), EPS)
