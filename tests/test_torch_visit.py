"""The port's visit-list intersector against rfw_tpu's and the oracle.

On the CPU the port runs its kernels' plain versions, and rfw_tpu runs
its Pallas kernels in interpret mode. Tolerances:
* enumeration, envelope and candidate windows: exact (min/max, one IEEE
  division, integer keys — nothing to round differently);
* visit kernel: found masks equal, slot agreement > 0.999, relative t
  < 1e-4 — the Woop transform rounds differently where XLA fuses a
  multiply-add, which can move a hit by ulps (and, at a shared edge,
  pick the neighbouring triangle);
* hits against the brute-force oracle: the bars of tests/test_visit.py.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu import config as j_config
from rfw_tpu.ops import visit_intersect as jvi
from rfw_tpu.render import scene_data as jax_sd
from rfw_tpu.scene.lights import pack_lights as j_pack_lights
from rfw_tpu.scene.materials import MaterialList as JMaterialList
from rfw_tpu.scene.mesh import build_triangles as j_build_triangles

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import traverse
from rfw_tpu_torch.ops import visit_intersect as tvi
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.scene.mesh import build_triangles

J_CFG = j_config.RenderConfig()


def _build(verts):
    """The same triangles through each package's own build: (the port's
    scene as tensors, rfw_tpu's numpy scene)."""
    nt = verts.shape[0]
    idx = np.arange(nt * 3).reshape(nt, 3)
    eye = np.eye(4, dtype=np.float32)
    ref = jax_sd.build_device_scene(
        [jax_sd.InstancedMesh(
            triangles=j_build_triangles(verts.reshape(-1, 3), idx),
            transform=eye, instance_id=0, mesh_slot=0)],
        JMaterialList().generate_device_materials(),
        j_pack_lights([], [], [], []), None, None, J_CFG)
    port = scene_data.build_device_scene(
        [scene_data.InstancedMesh(
            triangles=build_triangles(verts.reshape(-1, 3), idx),
            transform=eye, instance_id=0, mesh_slot=0)],
        None, None, None, None, RenderConfig())
    return scene_data.scene_to_torch(port, "cpu"), ref


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()
                if not k.startswith("_")}
    return jnp.asarray(tree) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def soup():
    """tests/test_visit.py's soup: 800 triangles, seed 7."""
    rng = np.random.default_rng(7)
    nt = 800
    centers = rng.uniform(-10, 10, (16, 3))
    tri_c = centers[rng.integers(0, 16, nt)] + rng.normal(0, 1.2, (nt, 3))
    verts = (tri_c[:, None, :] + rng.normal(0, 0.35, (nt, 3, 3))).astype(
        np.float32)
    port, ref = _build(verts)
    return port, _to_jax(ref), RenderConfig()


def _rays(n, seed=0, dead_frac=0.3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(n, 1e30, np.float32)
    tm[rng.random(n) < dead_frac] = 0.0
    return o, d, tm


def _first_pass(soup, coherent=False):
    """Both packages' pass-0 inputs on the same 1024 rays."""
    port, ref, cfg = soup
    o, d, tm = _rays(1024)
    wg_j, b_j, _, _ = jvi._granularity(ref["treelets"], J_CFG)
    gran = tvi._granularity(port["treelets"], cfg)
    wg_t, b_t = gran.planes, gran.bounds8
    rays8 = jvi._pack_rays8(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    rays = tvi._pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(tm))
    return rays8, b_j, wg_j, rays, b_t, wg_t


@pytest.mark.parametrize("enum", ["kernel", "envelope"])
def test_block_entries_exact(soup, enum):
    rays8, b_j, _, rays, b_t, _ = _first_pass(soup)
    if enum == "kernel":
        ref = jvi.block_entries(rays8, b_j)
        got = tvi.block_entries_ref(rays, b_t)
    else:
        ref = jvi.block_entries_envelope(rays8, b_j)
        got = tvi.block_entries_envelope(rays, b_t)
    assert np.array_equal(np.asarray(ref), got.numpy())


def test_candidate_windows_exact(soup):
    rays8, b_j, _, _, _, _ = _first_pass(soup)
    b_entry = np.asarray(jvi.block_entries(rays8, b_j))
    diag = np.float32(7.25)
    m_c = 4   # several windows on this small scene
    keys_j, counts_j = jvi.sort_candidates(jnp.asarray(b_entry), diag, m_c)
    keys_t, counts_t = tvi.sort_candidates(torch.tensor(b_entry),
                                           torch.tensor(diag), m_c)
    assert np.array_equal(np.asarray(keys_j), keys_t.numpy())
    assert np.array_equal(np.asarray(counts_j), counts_t.numpy())
    t_c = b_entry.shape[1]
    for it in range(keys_t.shape[1] // m_c):
        ref = jvi.window_candidates(keys_j, counts_j, it, diag, m_c, t_c)
        got = tvi.window_candidates(keys_t, counts_t, it, torch.tensor(diag),
                                    m_c, t_c)
        for a, b in zip(ref, got):
            assert np.array_equal(np.asarray(a), b.numpy()), it


@pytest.mark.parametrize("any_hit", [False, True])
def test_visit_plain_matches_pallas(soup, any_hit):
    rays8, b_j, wg_j, rays, _, wg_t = _first_pass(soup)
    port, ref, cfg = soup
    lo, hi = ref["treelets"]["scene_lo"], ref["treelets"]["scene_hi"]
    diag = jnp.sqrt(jnp.sum((hi - lo) ** 2))
    keys, counts = jvi.sort_candidates(jvi.block_entries(rays8, b_j), diag,
                                       jvi.M_C)
    ids, cnt, tn, _ = jvi.window_candidates(keys, counts, 0, diag, jvi.M_C,
                                            b_j.shape[1])
    t_j, s_j = jvi._run_visit_kernel(rays8, ids, cnt, tn, wg_j, 1,
                                     wg_j.shape[2], J_CFG.t_epsilon, any_hit)
    t_t, s_t = tvi.visit_ref(
        rays, torch.from_numpy(np.asarray(ids)),
        torch.from_numpy(np.asarray(cnt)), torch.from_numpy(np.asarray(tn)),
        wg_t, 1, wg_t.shape[2], cfg.t_epsilon, any_hit)
    t_j, s_j = np.asarray(t_j), np.asarray(s_j)
    t_t, s_t = t_t.numpy(), s_t.numpy()
    assert ((s_j >= 0) == (s_t >= 0)).all()
    both = s_j >= 0
    assert both.sum() > 10
    assert (s_j[both] == s_t[both]).mean() > 0.999
    assert (np.abs(t_j[both] - t_t[both])
            / np.maximum(t_j[both], 1e-6)).max() < 1e-4


def _tube_scene():
    """tests/test_visit.py's heterogeneous-finish scene: a tube of rings
    whose axis rays walk many passes at M_C = 2, plus a near quad that
    another block hits on pass 1."""
    rng = np.random.default_rng(31)
    tris = []
    for i in range(16):
        x = 4.0 + 2.0 * i
        for a in rng.random(64) * 2 * np.pi:
            c = np.array([x, 2.0 * np.cos(a), 2.0 * np.sin(a)])
            tris.append(c[None] + rng.normal(0, 0.15, (3, 3)))
    tris.append(np.array([[40.0, -3, -3], [40.0, 6, -3], [40.0, -3, 6]]))
    tris.append(np.array([[0, -60, -3], [0, -54, -3], [0, -60, 3]]))
    tris.append(np.array([[0, -54, -3], [0, -54, 3], [0, -60, 3]]))
    scene, _ = _build(np.stack(tris).astype(np.float32))
    o0 = np.tile([[0.5, -57.0, 0.0]], (256, 1)) + rng.normal(0, 0.2, (256, 3))
    d0 = np.tile([[-1.0, 0.0, 0.0]], (256, 1)) + rng.normal(0, 0.01,
                                                            (256, 3))
    o1 = np.tile([[0.0, 0.0, 0.0]], (256, 1)) + rng.normal(0, 0.05, (256, 3))
    d1 = np.tile([[1.0, 0.0, 0.0]], (256, 1)) + rng.normal(0, 0.001,
                                                           (256, 3))
    o = np.concatenate([o0, o1]).astype(np.float32)
    d = np.concatenate([d0, d1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return scene, o, d


def _coherent_rays():
    rng = np.random.default_rng(11)
    o = np.full((256, 3), -20.0, np.float32) + rng.normal(0, 0.5, (256, 3))
    d = np.tile([[1.0, 1.0, 1.0]], (256, 1)) + rng.normal(0, 0.05, (256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _brute(scene, o, d, cfg):
    v = scene["tri_vertices"]
    return traverse.brute_force_closest(
        o, d, (v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
        t_epsilon=cfg.t_epsilon)


CASES = ["closest", "recull", "tube", "super", "coherent_unsorted",
         "envelope"]


@pytest.mark.parametrize("case", CASES)
def test_closest_hit_matches_brute(soup, monkeypatch, case):
    """The oracle cases of tests/test_visit.py, through the port."""
    scene, _, cfg = soup
    tm = None
    kw = {}
    if case == "tube":
        monkeypatch.setattr(tvi, "M_C", 2)
        scene, o, d = _tube_scene()
        kw = {"sort": False}     # keeps the two engineered blocks intact
    elif case == "coherent_unsorted":
        o, d = _coherent_rays()
        kw = {"sort": False}
    else:
        seed, dead = {"closest": (0, 0.3), "recull": (13, 0.2),
                      "super": (21, 0.3), "envelope": (11, 0.2)}[case]
        o, d, tm = _rays(1024 if case != "recull" else 512, seed, dead)
        tm = torch.from_numpy(tm)
        if case == "recull":
            monkeypatch.setattr(tvi, "M_C", 2)
        if case == "super":
            cfg = dataclasses.replace(cfg, visit_granularity="super")
        if case == "envelope":
            kw = {"sort": False, "coherent": True}
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_p, prim_p, _, _ = tvi.closest_hit(scene, o, d, cfg, t_max=tm, **kw)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    if tm is not None:
        prim_b = torch.where((t_b < tm) & (prim_b >= 0), prim_b, -1)
    t_p, prim_p, t_b, prim_b = (x.numpy() for x in (t_p, prim_p, t_b,
                                                    prim_b))
    assert ((prim_p >= 0) == (prim_b >= 0)).all()
    both = (prim_p >= 0) & (prim_b >= 0)
    assert both.sum() > 10
    assert (prim_p[both] == prim_b[both]).mean() > 0.999
    terr = np.abs(t_p[both] - t_b[both]) / np.maximum(t_b[both], 1e-6)
    assert terr.max() < 1e-4


def _occlusion_rays():
    o, d, _ = _rays(1024, seed=3, dead_frac=0.0)
    dist = np.full(1024, 6.0, np.float32)
    dist[np.random.default_rng(5).random(1024) < 0.3] = 0.0
    return o, d, dist


def test_any_hit_matches_brute(soup):
    scene, _, cfg = soup
    o, d, dist = (torch.from_numpy(a) for a in _occlusion_rays())
    occ = tvi.any_hit(scene, o, d, dist, cfg)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    assert torch.equal(occ, (prim_b >= 0) & (t_b < dist))


def test_closest_and_any_hit_match_reference(soup):
    """Identical rays through both packages' full intersector, each on
    its own build of the same triangles."""
    port, ref, cfg = soup
    o, d, tm = _rays(1024, seed=0)
    t_j, p_j, _, _ = jvi.closest_hit(ref, jnp.asarray(o), jnp.asarray(d),
                                     J_CFG, t_max=jnp.asarray(tm))
    t_t, p_t, _, _ = tvi.closest_hit(port, torch.from_numpy(o),
                                     torch.from_numpy(d), cfg,
                                     t_max=torch.from_numpy(tm))
    t_j, p_j, t_t, p_t = np.asarray(t_j), np.asarray(p_j), t_t.numpy(), \
        p_t.numpy()
    assert ((p_j >= 0) == (p_t >= 0)).all()
    both = p_j >= 0
    assert (p_j[both] == p_t[both]).mean() > 0.999
    assert (np.abs(t_j[both] - t_t[both])
            / np.maximum(t_j[both], 1e-6)).max() < 1e-4

    o, d, dist = _occlusion_rays()
    occ_j = np.asarray(jvi.any_hit(ref, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(dist), J_CFG))
    occ_t = tvi.any_hit(port, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(dist), cfg).numpy()
    assert np.array_equal(occ_j, occ_t)


def test_cuda_wrapper_rejects_other_devices():
    rays = torch.zeros((8, 256), device="meta")
    with pytest.raises(RuntimeError, match="no visit-list kernels"):
        tvi.block_entries(rays, torch.zeros((8, 8), device="meta"), 8)


# ---------------------------------------------------------------------------
# What surrounds the CUDA kernels: the triangle-major planes, the real
# cell counts and the wrappers' shape checks (the kernels themselves run
# only on the card, in chip_smoke.py)
# ---------------------------------------------------------------------------

def _scenes(soup):
    """The soup, the tube scene and config 2, each as the port built it."""
    from chip_smoke import make_config2
    from rfw_tpu_torch.system import RenderSystem
    rs = make_config2(RenderSystem("wavefront", device="cpu"))
    rs.synchronize()
    return {"soup": soup[0], "tube": _tube_scene()[0],
            "config2": rs.context._scene}


@pytest.mark.parametrize("granularity", ["cell", "super"])
def test_triangle_major_planes(soup, granularity):
    """planes_tm[g, s·K + k, q] == wplanes[g·G + s, q, k] for q < 12."""
    cfg = dataclasses.replace(soup[2], visit_granularity=granularity)
    for name, scene in _scenes(soup).items():
        tl = scene["treelets"]
        gran = tvi._granularity(tl, cfg)
        wp = tl["wplanes"].numpy()
        assert np.array_equal(tl["wplanes_tm"].numpy(),
                              wp[:, :12].transpose(0, 2, 1)), name
        t, _, k = wp.shape
        g = gran.super_g
        assert g == (1 if granularity == "cell" else 8)
        want = wp[:, :12].transpose(0, 2, 1).reshape(t // g, g * k, 12)
        assert np.array_equal(gran.planes_tm.numpy(), want), name
        assert gran.planes_tm.is_contiguous()
        last = gran.planes_tm.shape[0] - 1   # spot-check the index formula
        for s in range(g):
            assert np.array_equal(gran.planes_tm[last, s * k + 5].numpy(),
                                  wp[last * g + s, :12, 5]), name


def test_real_cells_and_padding_entries(soup):
    """The real count is the number of cells that hold a triangle, and
    the plain enumeration gives 1e30 for every cell past it, so the
    kernel may write 1e30 there without testing."""
    o, d, tm = _rays(1024, seed=4, dead_frac=0.1)
    rays = tvi._pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(tm))
    skipped = 0
    for name, scene in _scenes(soup).items():
        tl = scene["treelets"]
        filled = (tl["slot_to_prim"].reshape(tl["bmin"].shape[0], -1)
                  >= 0).any(1)
        assert tl["n_cells"] == int(filled.sum()), name
        assert bool(filled[:tl["n_cells"]].all())
        assert tl["n_super"] == int(filled.reshape(-1, 8).any(1).sum())
        for gname in ("cell", "super"):
            cfg = dataclasses.replace(soup[2], visit_granularity=gname)
            gran = tvi._granularity(tl, cfg)
            skipped += gran.bounds8.shape[1] - gran.n_real
            ent = tvi.block_entries_ref(rays, gran.bounds8)
            assert bool((ent[:, gran.n_real:] == 1e30).all()), (name, gname)
            assert bool((ent[:, :gran.n_real] < 1e30).any()), (name, gname)
            assert torch.equal(
                tvi.block_entries(rays, gran.bounds8, gran.n_real), ent)
    assert skipped >= 8       # the scenes do have padding cells to skip


def test_dead_lanes_enter_no_cell(soup):
    """A dead lane (t_max 0) crosses no box wherever it starts or points:
    moving the dead lanes changes no entry, and a block of dead lanes
    gives 1e30 for every cell. So the enum kernel may skip dead rays."""
    port, _, cfg = soup
    gran = tvi._granularity(port["treelets"], cfg)
    o, d, tm = _rays(1024, seed=5, dead_frac=0.4)
    tm[256:512] = 0.0                              # block 1 all dead
    dead = tm <= 0
    rng = np.random.default_rng(6)
    o2, d2 = o.copy(), d.copy()
    o2[dead] = rng.uniform(-3, 3, (int(dead.sum()), 3))   # inside the soup
    d2[dead] = -d2[dead]
    ents = [tvi.block_entries_ref(
        tvi._pack_rays(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(tm)), gran.bounds8)
        for a, b in ((o, d), (o2, d2))]
    assert torch.equal(ents[0], ents[1])
    assert bool((ents[0][1] == 1e30).all())
    assert bool((ents[0][[0, 2, 3]] < 1e30).any())


@pytest.mark.parametrize("const", ["kEnumCells", "kExpandSlots",
                                   "kExpandMinBlocks", "kTvisitRays",
                                   "kPremaskBoxes", "kPremaskCluster",
                                   "kTlasWalkBatch",
                                   "kTlasWalkThreads"])
def test_enum_variant_sources(tmp_path, const):
    """The kernel A/B script's variant copies replace exactly the named
    constant (of the enum, expansion, tvisit or tlas kernels), carry the
    shared headers beside them, and refuse a name the sources lack."""
    from rfw_tpu_torch.tools import kernel_variant
    paths = kernel_variant.variant_sources({const: "1"}, str(tmp_path))
    texts = [pathlib.Path(p).read_text() for p in paths]
    assert sum(t.count(f"constexpr int {const} = 1;") for t in texts) == 1
    assert sum(t.count(const) for t in texts) == sum(
        pathlib.Path(p).read_text().count(const)
        for p in kernel_variant.cuda_lib.SOURCES)
    headers = kernel_variant.cuda_lib.headers()
    assert headers and all((tmp_path / pathlib.Path(h).name).read_text()
                           == pathlib.Path(h).read_text() for h in headers)
    with pytest.raises(ValueError, match="kNoSuch"):
        kernel_variant.variant_sources({"kNoSuch": "2"}, str(tmp_path))


def test_real_cells_rejects_reachable_padding():
    lo = torch.tensor([[0.0, 0, 0], [1, 1, 1], [3e37, 3e37, 3e37],
                       [3e37, 3e37, 3e37]])
    assert tvi.real_cells(lo) == 2
    lo[2] = torch.tensor([5.0, 5, 5])      # a real box after a far box
    lo[1] = 3e37
    with pytest.raises(ValueError, match="far boxes"):
        tvi.real_cells(lo)


def test_wrapper_shape_checks_raise(soup):
    scene, _, cfg = soup
    gran = tvi._granularity(scene["treelets"], cfg)
    o, d, tm = (torch.from_numpy(x) for x in _rays(512))
    rays = tvi._pack_rays(o, d, tm)
    nb = 2
    ids = torch.zeros((nb, 4), dtype=torch.int32)
    counts = torch.ones(nb, dtype=torch.int32)
    tn = torch.zeros((nb, 4))
    bad = gran._replace(planes_tm=gran.planes_tm[:, :, :8])
    with pytest.raises(ValueError, match="triangle-major planes"):
        tvi.visit(rays, ids, counts, tn, bad, 1e-4, False)
    bad = gran._replace(planes_tm=gran.planes_tm[:-1])
    with pytest.raises(ValueError, match="bad shapes"):
        tvi.visit(rays, ids, counts, tn, bad, 1e-4, False)
    with pytest.raises(ValueError, match="bad shapes"):
        tvi.visit(rays, ids, counts, tn, gran, 1e-4, False,
                  walked=torch.zeros(nb + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="kernel only"):
        tvi.visit(rays, ids, counts, tn, gran, 1e-4, False,
                  walked=torch.zeros(nb, dtype=torch.int32))
    t_dim = gran.bounds8.shape[1]
    for n_real in (-1, t_dim + 1):
        with pytest.raises(ValueError, match="real cell count"):
            tvi.block_entries(rays, gran.bounds8, n_real)
    with pytest.raises(ValueError, match="bad shapes"):
        tvi.block_entries(rays[:7], gran.bounds8, t_dim)
    t_p, s_p = tvi.visit(rays, ids, counts, tn, gran, 1e-4, False)
    t_r, s_r = tvi.visit_ref(rays, ids, counts, tn, gran.planes,
                             gran.super_g, gran.k_size, 1e-4, False)
    assert torch.equal(t_p, t_r) and torch.equal(s_p, s_r)
