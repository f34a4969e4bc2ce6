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
from rfw_tpu_torch.render.intersectors import dense_woop
from rfw_tpu_torch.scene.mesh import build_triangles


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_tris(n=500, seed=3, spread=4.0):
    """tests/test_bvh.py's triangle soup."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    return np.stack([v0, v1, v2], axis=1)


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
    """A comb of ``levels`` wide nodes whose boxes all hold every ray's
    path: node i's slot 0 is node i + 1, slots 1-3 are internal nodes
    with four one- to three-triangle leaves. Every slot's box is the
    same, so a ray pushes all four children of every comb node, pops
    slot 0 first (equal tnear, lowest slot) and the stack (3 more
    entries a level) overflows its 64 entries."""
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
    verts = random_tris(first, seed=seed, spread=3.0)
    lo = np.full((n_nodes, 4, 3), -5.0, np.float32)
    hi = np.full((n_nodes, 4, 3), 5.0, np.float32)
    wb = {"bmin": lo, "bmax": hi, "child": child, "count": count}
    tris = (verts[:, 0], verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    return wb, tris


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
    assert torch.equal(halves["node_seen"], one["node_seen"])
    assert torch.equal(halves["tri_seen"], one["tri_seen"])
    nodes, tris = one["node_seen"], one["tri_seen"]
    assert nodes.shape == (2 * n_real,) and tris.shape == (400,)
    assert bool(nodes[0]) and not bool(nodes[n_real:].any())
    assert bool(tris[prim[prim >= 0].long()].all())
    assert 0 < int(nodes.sum()) < one["visits"]
    assert 0 < int(tris.sum()) < one["tests"]


def test_node_table_layout():
    wb, _ = soup_bvh(300, seed=6)
    wt = {k: torch.from_numpy(v) for k, v in wb.items()}
    nodes = traverse.node_table(wt)
    assert nodes.shape == (wb["child"].shape[0], 8, 4) and nodes.is_contiguous()
    assert torch.equal(nodes[:, :4, :3], wt["bmin"])
    assert torch.equal(nodes[:, 4:, :3], wt["bmax"])
    assert torch.equal(nodes[:, :4, 3].contiguous().view(torch.int32),
                       wt["child"])
    assert torch.equal(nodes[:, 4:, 3].contiguous().view(torch.int32),
                       wt["count"])


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
