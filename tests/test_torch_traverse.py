"""The port's wide-BVH traversal (``rfw_tpu_torch/ops/traverse.py``) and
dense Woop tests (``ops/intersect.py``) against rfw_tpu's.

* ``traverse_wide_ref`` against ``rfw_tpu.ops.traverse.traverse_wide``
  on tests/test_bvh.py's random triangles (n = 65 and 1000) and on a
  generated BVH deep enough to overflow the 64-entry stack, closest and
  any hit: equal hit masks, prim agreement above 0.999 and relative t
  error below 1e-4. Not bit-equal: XLA's CPU fusion contracts some
  multiply-adds of the slab and triangle tests, the port rounds each.
* Against the port's ``brute_force_closest``, and the any-hit
  consistency of tests/test_bvh.py.
* The node-major table the kernel reads, and the CUDA wrapper's
  refusal of other devices.
* ``intersect_woop``/``closest_hit_woop``/``intersect_aabb`` against
  rfw_tpu's, and the dense intersector's Woop table read back from the
  cell planes equal to the build's per-slot matrices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.ops import intersect as j_intersect
from rfw_tpu.ops import traverse as j_traverse
from rfw_tpu.render import scene_data as jax_sd

from rfw_tpu_torch.bvh import build_bvh, collapse_wide, triangle_bounds
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib
from rfw_tpu_torch.ops import intersect as p_intersect
from rfw_tpu_torch.ops import traverse
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.render.intersectors import (_tris_from_scene, dense_woop,
                                               make_bvh_intersector)
from rfw_tpu_torch.scene.mesh import build_triangles
from rfw_tpu_torch.utils import synthetic


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_tris(n=500, seed=3, spread=4.0):
    """tests/test_bvh.py's triangle soup."""
    return synthetic.tri_soup(n, seed, spread)


def random_rays(r, seed=10, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def soup_bvh(n, seed):
    """(wide BVH arrays, (v0, e1, e2)) in the builder's order."""
    verts = random_tris(n, seed=seed)
    tmin, tmax = triangle_bounds(verts)
    bvh = build_bvh(tmin, tmax, leaf_size=4, use_native=False)
    wide = collapse_wide(bvh, width=4)
    perm = verts[bvh.prim_order]
    tris = (perm[:, 0], perm[:, 1] - perm[:, 0], perm[:, 2] - perm[:, 0])
    wb = {"bmin": wide.bmin, "bmax": wide.bmax, "child": wide.child,
          "count": wide.count}
    return wb, tris


def deep_bvh(levels=40, seed=5):
    """``synthetic.comb_bvh``: every ray pushes all four children of
    every comb node, and the stack (3 more entries a level) overflows its
    64 entries."""
    return synthetic.comb_bvh(levels, seed)


def _both(wb, tris, o, d, **kw):
    ref = j_traverse.traverse_wide(
        jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(v) for k, v in wb.items()},
        tuple(jnp.asarray(x) for x in tris), leaf_size=4, **kw)
    got = traverse.traverse_wide_ref(
        torch.from_numpy(o), torch.from_numpy(d),
        {k: torch.from_numpy(v) for k, v in wb.items()},
        tuple(torch.from_numpy(x) for x in tris), **kw)
    return ([np.asarray(x) for x in ref], [x.numpy() for x in got])


def _assert_close(ref, got):
    t_r, p_r, u_r, v_r = ref
    t_g, p_g, u_g, v_g = got
    hit = p_r >= 0
    assert np.array_equal(hit, p_g >= 0)
    assert hit.any()
    assert (p_r[hit] == p_g[hit]).mean() > 0.999
    assert np.all(np.abs(t_g - t_r) <= 1e-4 * np.abs(t_r))
    same = hit & (p_r == p_g)
    assert np.allclose(u_g[same], u_r[same], atol=1e-4)
    assert np.allclose(v_g[same], v_r[same], atol=1e-4)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [65, 1000])
def test_traverse_ref_matches_rfw_tpu(n, any_hit):
    wb, tris = soup_bvh(n, seed=n)
    o, d = random_rays(256)
    _assert_close(*_both(wb, tris, o, d, any_hit=any_hit))


@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_ref_stack_overflow_matches_rfw_tpu(any_hit):
    """The comb overflows the stack: the clamped push and pop lose the
    same subtrees in both, so they miss the same triangles."""
    wb, tris = deep_bvh()
    o, d = random_rays(128, seed=3, spread=2.5)
    stats = {}
    traverse.traverse_wide_ref(
        torch.from_numpy(o), torch.from_numpy(d),
        {k: torch.from_numpy(v) for k, v in wb.items()},
        tuple(torch.from_numpy(x) for x in tris), stats=stats)
    # more nodes than the stack holds are pending at the comb's bottom
    assert stats["visits"] >= 128 * 40
    ref, got = _both(wb, tris, o, d, any_hit=any_hit)
    _assert_close(ref, got)
    # a lost subtree is one brute force would have found
    bt, bp, _, _ = traverse.brute_force_closest(
        torch.from_numpy(o), torch.from_numpy(d),
        tuple(torch.from_numpy(x) for x in tris))
    if not any_hit:
        assert (got[1] != bp.numpy()).any()


def test_traverse_ref_with_t_max_matches_rfw_tpu():
    wb, tris = soup_bvh(400, seed=4)
    o, d = random_rays(200, seed=12)
    t_max = np.random.default_rng(1).uniform(0.0, 6.0, 200).astype(
        np.float32)
    t_max[:20] = 0.0                     # dead lanes
    ref = j_traverse.traverse_wide(
        jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(v) for k, v in wb.items()},
        tuple(jnp.asarray(x) for x in tris), leaf_size=4,
        t_max=jnp.asarray(t_max))
    got = traverse.traverse_wide_ref(
        torch.from_numpy(o), torch.from_numpy(d),
        {k: torch.from_numpy(v) for k, v in wb.items()},
        tuple(torch.from_numpy(x) for x in tris),
        t_max=torch.from_numpy(t_max))
    ref, got = [np.asarray(x) for x in ref], [x.numpy() for x in got]
    _assert_close(ref, got)
    assert (got[1][:20] == -1).all() and (got[0][:20] == 0).all()


@pytest.mark.parametrize("n", [65, 1000])
def test_traverse_ref_matches_brute_force(n):
    wb, tris = soup_bvh(n, seed=n)
    o, d = (torch.from_numpy(x) for x in random_rays(256))
    tt = tuple(torch.from_numpy(x) for x in tris)
    t_b, p_b, _, _ = traverse.traverse_wide_ref(
        o, d, {k: torch.from_numpy(v) for k, v in wb.items()}, tt)
    t_r, p_r, _, _ = traverse.brute_force_closest(o, d, tt)
    hit = p_r >= 0
    assert torch.equal(p_b >= 0, hit)
    assert torch.equal(t_b[hit], t_r[hit])        # the same tests, in order
    assert float((p_b[hit] == p_r[hit]).float().mean()) > 0.98


def test_any_hit_terminates_consistently():
    """tests/test_bvh.py's check, on the port."""
    wb, tris = soup_bvh(400, seed=5)
    o, d = (torch.from_numpy(x) for x in random_rays(128, seed=11))
    wt = {k: torch.from_numpy(v) for k, v in wb.items()}
    tt = tuple(torch.from_numpy(x) for x in tris)
    t_c, p_c, _, _ = traverse.traverse_wide_ref(o, d, wt, tt)
    t_a, p_a, _, _ = traverse.traverse_wide_ref(o, d, wt, tt, any_hit=True)
    assert torch.equal(p_a >= 0, p_c >= 0)
    hit = p_c >= 0
    assert bool((t_a[hit] >= t_c[hit]).all())


def test_traverse_ref_stats_count_distinct_work():
    """``stats`` sums the visits and tests over the calls that share it
    and marks each node and triangle read once, however many rays read
    it: the root, every triangle hit, and never a padded node."""
    verts = random_tris(400, seed=7)
    tmin, tmax = triangle_bounds(verts)
    bvh = build_bvh(tmin, tmax, leaf_size=4, use_native=False)
    wide = collapse_wide(bvh, width=4)
    n_real = wide.child.shape[0]
    wide = scene_data._pad_wide(wide, min_cap=2 * n_real)
    wt = {"bmin": torch.from_numpy(wide.bmin),
          "bmax": torch.from_numpy(wide.bmax),
          "child": torch.from_numpy(wide.child),
          "count": torch.from_numpy(wide.count)}
    perm = verts[bvh.prim_order]
    tt = tuple(torch.from_numpy(x) for x in
               (perm[:, 0], perm[:, 1] - perm[:, 0], perm[:, 2] - perm[:, 0]))
    o, d = (torch.from_numpy(x) for x in random_rays(128, seed=13))
    one, halves = {}, {}
    _, prim, _, _ = traverse.traverse_wide_ref(o, d, wt, tt, stats=one)
    for h in (slice(0, 64), slice(64, 128)):
        traverse.traverse_wide_ref(o[h], d[h], wt, tt, stats=halves)
    assert halves["visits"] == one["visits"]
    assert halves["tests"] == one["tests"]
    # the longest walk lies in one of the halves, and a maximum lies
    # between the mean and the sum
    assert halves["longest"] == one["longest"]
    assert one["visits"] / 128 <= one["longest"] < one["visits"]
    assert torch.equal(halves["node_seen"], one["node_seen"])
    assert torch.equal(halves["tri_seen"], one["tri_seen"])
    nodes, tris = one["node_seen"], one["tri_seen"]
    assert nodes.shape == (2 * n_real,) and tris.shape == (400,)
    assert bool(nodes[0]) and not bool(nodes[n_real:].any())
    assert bool(tris[prim[prim >= 0].long()].all())
    assert 0 < int(nodes.sum()) < one["visits"]
    assert 0 < int(tris.sum()) < one["tests"]


def _torch(wb):
    return {k: torch.from_numpy(v) for k, v in wb.items()}


def test_node_table_layout():
    wb, _ = soup_bvh(300, seed=6)
    wt = _torch(wb)
    nodes = traverse.node_table(wt)
    assert nodes.shape == (wb["child"].shape[0], 8, 4) and nodes.is_contiguous()
    assert torch.equal(nodes[:, :4, :3], wt["bmin"])
    assert torch.equal(nodes[:, 4:, :3], wt["bmax"])
    assert torch.equal(nodes[:, :4, 3].contiguous().view(torch.int32),
                       wt["child"])
    assert torch.equal(nodes[:, 4:, 3].contiguous().view(torch.int32),
                       wt["count"])


def test_tri_table_layout():
    """Rows (v0, 0), (e1, 0), (e2, 0) a triangle, the edges bit for bit
    the intersectors' own (``_tris_from_scene``), and the plain version
    given the table walks as given the tuple."""
    verts = torch.from_numpy(random_tris(300, seed=11))
    edges = _tris_from_scene({"tri_vertices": verts})
    table = traverse.tri_table(edges)
    assert table.shape == (300, 3, 4) and table.dtype == torch.float32
    assert table.is_contiguous()
    for i, x in enumerate(edges):
        assert torch.equal(table[:, i, :3], x)
    assert torch.equal(table[..., 3], torch.zeros(300, 3))
    assert torch.equal(edges[1], verts[:, 1] - verts[:, 0])
    assert torch.equal(edges[2], verts[:, 2] - verts[:, 0])
    wb, tris = soup_bvh(300, seed=11)
    tt = tuple(torch.from_numpy(x) for x in tris)
    o, d = (torch.from_numpy(x) for x in random_rays(128, seed=5))
    a = traverse.traverse_wide_ref(o, d, _torch(wb), tt)
    b = traverse.traverse_wide(o, d, _torch(wb), traverse.tri_table(tt))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("any_hit", [False, True])
def test_dead_lanes_return_t_max(any_hit):
    """Lanes with t_max 0, negative, eps or NaN, mixed with live ones in
    one batch, come back (t_max, -1, 0, 0) without a walk; walking them
    anyway (``walk_dead``) changes no result, only the work counted."""
    wb, tris = soup_bvh(400, seed=4)
    wt, tt = _torch(wb), tuple(torch.from_numpy(x) for x in tris)
    o, d = (torch.from_numpy(x) for x in random_rays(200, seed=12))
    eps = 1e-4
    t_max = torch.full((200,), 1e30)
    dead = torch.arange(200) % 5 != 0
    pattern = torch.tensor([0.0, -2.5, eps, float("nan")])
    t_max[dead] = pattern[torch.arange(int(dead.sum())) % 4]
    # the origins of some dead lanes inside the root's boxes: the walk
    # before the exit popped nodes for them
    o[dead] *= 0.1
    one, every = {}, {}
    got = traverse.traverse_wide_ref(o, d, wt, tt, t_max=t_max,
                                     t_epsilon=eps, any_hit=any_hit,
                                     stats=one)
    walked = traverse.traverse_wide_ref(o, d, wt, tt, t_max=t_max,
                                        t_epsilon=eps, any_hit=any_hit,
                                        stats=every, walk_dead=True)
    for x, y in zip(got, walked):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    t, prim, u, v = got
    assert torch.equal(t[dead].view(torch.int32),
                       t_max[dead].view(torch.int32))
    assert (prim[dead] == -1).all()
    assert (u[dead] == 0).all() and (v[dead] == 0).all()
    assert bool((prim[~dead] >= 0).any())
    assert every["visits"] > one["visits"] > 0
    # the live lanes alone do the same work as in the mixed batch
    alone = {}
    traverse.traverse_wide_ref(o[~dead], d[~dead], wt, tt,
                               t_max=t_max[~dead], t_epsilon=eps,
                               any_hit=any_hit, stats=alone)
    assert alone["visits"] == one["visits"]
    assert alone["tests"] == one["tests"]


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_intersector_matches_rfw_tpu(any_hit):
    """The ``bvh`` intersector over a port build's derived tables (the
    node table and "tri_table") against rfw_tpu's ``traverse_wide`` on
    rfw_tpu's own build of the same triangles, with live, dead and
    bounded lanes."""
    from rfw_tpu import config as j_config
    from rfw_tpu.scene.mesh import build_triangles as j_build
    rng = np.random.default_rng(21)
    pos = rng.uniform(-2, 2, (600, 3)).astype(np.float32)
    faces = rng.integers(0, 600, (500, 3)).astype(np.int32)
    ref = jax_sd.build_device_scene(
        [jax_sd.InstancedMesh(j_build(pos, faces),
                              np.eye(4, dtype=np.float32), 0, 0)],
        None, None, None, None, j_config.RenderConfig())
    port = scene_data.scene_to_torch(scene_data.build_device_scene(
        [scene_data.InstancedMesh(build_triangles(pos, faces),
                                  np.eye(4, dtype=np.float32), 0, 0)],
        None, None, None, None, RenderConfig()), "cpu")
    assert np.array_equal(port["tri_vertices"].numpy(), ref["tri_vertices"])
    o, d = random_rays(256, seed=22, spread=3.0)
    t_max = rng.uniform(0.5, 8.0, 256).astype(np.float32)
    t_max[::7] = 0.0
    isect = make_bvh_intersector(RenderConfig())
    v = ref["tri_vertices"]
    j_tris = tuple(jnp.asarray(x) for x in
                   (v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    want = j_traverse.traverse_wide(
        jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(x) for k, x in ref["bvh"].items()}, j_tris,
        leaf_size=4, t_max=jnp.asarray(t_max), any_hit=any_hit)
    o, d, tm = (torch.from_numpy(x) for x in (o, d, t_max))
    if any_hit:
        got = isect.occluded(port, o, d, tm)
        assert np.array_equal(got.numpy(), np.asarray(want[1]) >= 0)
        assert got.any()
        return
    got = isect.closest(port, o, d, tm)
    _assert_close([np.asarray(x) for x in want], [x.numpy() for x in got])


def test_traverse_wrapper_runs_plain_on_cpu_only():
    wb, tris = soup_bvh(65, seed=65)
    wt = {k: torch.from_numpy(v) for k, v in wb.items()}
    tt = tuple(torch.from_numpy(x) for x in tris)
    o, d = (torch.from_numpy(x) for x in random_rays(64))
    counts = dict(cuda_lib.launch_counts)
    a = traverse.traverse_wide(o, d, wt, tt)
    b = traverse.traverse_wide_ref(o, d, wt, tt)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cuda_lib.launch_counts == counts       # no kernel launch counted
    with pytest.raises(RuntimeError, match="no traversal kernels"):
        traverse.traverse_wide(o.to("meta"), d.to("meta"), wt, tt)


def test_woop_tests_match_rfw_tpu():
    verts = random_tris(64, seed=8, spread=2.0)
    woop = j_intersect.woop_matrices(verts[:, 0], verts[:, 1], verts[:, 2])
    o, d = random_rays(96, seed=9, spread=3.0)
    t_max = np.full(96, 4.0, np.float32)
    ref = j_intersect.intersect_woop(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(woop),
                                     t_max=jnp.asarray(t_max))
    got = p_intersect.intersect_woop(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(woop),
                                     t_max=torch.from_numpy(t_max))
    hr, hg = np.asarray(ref[0]), got[0].numpy()
    assert hr.any() and (hr == hg).mean() > 0.999
    both = hr & hg
    for a, b in zip(ref[1:], got[1:]):
        assert np.allclose(np.asarray(a)[both], b.numpy()[both], rtol=1e-4,
                           atol=1e-4)

    ids = np.arange(64, dtype=np.int32)[::-1].copy()
    ref = j_intersect.closest_hit_woop(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(woop), jnp.asarray(ids),
        tri_verts=jnp.asarray(verts))
    got = p_intersect.closest_hit_woop(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(woop),
        torch.from_numpy(ids), tri_verts=torch.from_numpy(verts))
    pr, pg = np.asarray(ref[1]), got[1].numpy()
    assert (pr >= 0).any() and np.array_equal(pr, pg)
    for a, b in zip(ref[0::2], got[0::2]):
        assert np.allclose(np.asarray(a), b.numpy(), rtol=1e-5, atol=1e-5)


def test_closest_hit_woop_ties_pick_the_first():
    """Two copies of one triangle: jnp.argmin's first index wins."""
    v = np.array([[[-1, -1, 2], [1, -1, 2], [0, 1, 2]]], np.float32)
    verts = np.concatenate([v, v])
    woop = torch.from_numpy(p_intersect.woop_matrices(
        verts[:, 0], verts[:, 1], verts[:, 2]))
    o = torch.zeros((1, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]])
    t, prim, _, _ = p_intersect.closest_hit_woop(
        o, d, woop, torch.tensor([7, 9], dtype=torch.int32))
    assert int(prim[0]) == 7 and float(t[0]) == pytest.approx(2.0)


def test_intersect_aabb_matches_rfw_tpu():
    rng = np.random.default_rng(2)
    o, d = random_rays(200, seed=2)
    d[:10, 0] = 0.0                          # axis-parallel: 0 x 1e12
    lo = rng.uniform(-3, 0, (200, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 3, (200, 3)).astype(np.float32)
    inv_j = j_intersect.safe_inv_dir(jnp.asarray(d))
    inv_p = p_intersect.safe_inv_dir(torch.from_numpy(d))
    assert np.array_equal(np.asarray(inv_j), inv_p.numpy())
    hj, tj = j_intersect.intersect_aabb(jnp.asarray(o), inv_j,
                                        jnp.asarray(lo), jnp.asarray(hi))
    hp, tp = p_intersect.intersect_aabb(torch.from_numpy(o), inv_p,
                                        torch.from_numpy(lo),
                                        torch.from_numpy(hi))
    assert np.array_equal(np.asarray(hj), hp.numpy())
    assert np.array_equal(np.asarray(tj), tp.numpy())
    nan = torch.tensor([[float("nan"), 0.0, 0.0]])
    h, t = p_intersect.intersect_aabb(nan, inv_p[:1], torch.from_numpy(lo[:1]),
                                      torch.from_numpy(hi[:1]))
    assert not bool(h[0]) and bool(torch.isnan(t[0]))


def test_dense_woop_inverts_the_cell_planes():
    """Rows 0-11 of ``wplanes`` give back the build's per-slot Woop
    matrices (rfw_tpu's ``treelets["woop"]``) exactly."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(-2, 2, (600, 3)).astype(np.float32)
    faces = rng.integers(0, 600, (400, 3)).astype(np.int32)
    from rfw_tpu.scene.mesh import build_triangles as j_build
    inst_p = [scene_data.InstancedMesh(build_triangles(pos, faces),
                                       np.eye(4, dtype=np.float32), 0, 0)]
    inst_j = [jax_sd.InstancedMesh(j_build(pos, faces),
                                   np.eye(4, dtype=np.float32), 0, 0)]
    from rfw_tpu import config as j_config
    ref = jax_sd.build_device_scene(inst_j, None, None, None, None,
                                    j_config.RenderConfig(treelet_size=32))
    port = scene_data.build_device_scene(inst_p, None, None, None, None,
                                         RenderConfig(treelet_size=32))
    tl = {k: torch.from_numpy(v) for k, v in port["treelets"].items()
          if isinstance(v, np.ndarray)}
    woop = dense_woop(tl)
    assert np.array_equal(woop.numpy(), ref["treelets"]["woop"])
