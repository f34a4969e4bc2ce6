"""The port's sub-cell (tvisit) intersector against rfw_tpu's and the
oracle, on tests/test_tvisit.py's 800-triangle soup (seed 7).

On the CPU the port runs its kernel's plain version, and rfw_tpu runs its
Pallas kernel in interpret mode. Tolerances:
* child tables, scene build and child expansion: exact (a numpy copy of
  the same code; min/max, one IEEE division and exact-integer keys);
* tvisit kernel against the Pallas kernel on the same packed inputs:
  found masks equal, slot agreement > 0.999, relative t < 1e-4 — the
  Woop transform rounds differently where XLA fuses a multiply-add;
* hits against the brute-force oracle: the bars of tests/test_tvisit.py
  (a lone ray on a padded wall: the oracle's triangle, relative t < 1e-4);
* the engine's tvisit frame against its own visit frame: rtol 1e-5,
  atol 1e-6 (same estimator, same refined winners; only coincident-
  triangle ties could differ).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu import config as j_config
from rfw_tpu.bvh import builder as j_builder
from rfw_tpu.bvh import wide as j_wide
from rfw_tpu.ops import tvisit_intersect as jtv
from rfw_tpu.ops import visit_intersect as jvi
from rfw_tpu.render import scene_data as jax_sd
from rfw_tpu.scene import MaterialList as JMaterialList
from rfw_tpu.scene.lights import pack_lights as j_pack_lights
from rfw_tpu.scene.mesh import build_triangles as j_build_triangles

import rfw_tpu_torch
from rfw_tpu_torch.bvh import wide as p_wide
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import traverse
from rfw_tpu_torch.ops import tvisit_intersect as ptv
from rfw_tpu_torch.ops import visit_intersect as pvi
from rfw_tpu_torch.render import RenderStatus, create_engine, scene_data
from rfw_tpu_torch.scene import HostMaterial, MaterialList, make_quad
from rfw_tpu_torch.scene.lights import PointLight, pack_lights
from rfw_tpu_torch.scene.mesh import build_triangles
from rfw_tpu_torch.utils import synthetic

CFG = RenderConfig(subcell_tables=True)            # the port's
J_CFG = j_config.RenderConfig(subcell_tables=True)  # rfw_tpu's


def _soup_verts():
    rng = np.random.default_rng(7)
    nt = 800
    centers = rng.uniform(-10, 10, (16, 3))
    tri_c = centers[rng.integers(0, 16, nt)] + rng.normal(0, 1.2, (nt, 3))
    return (tri_c[:, None, :] + rng.normal(0, 0.35, (nt, 3, 3))).astype(
        np.float32)


def _instance(mod, build, verts):
    """One identity instance of ``verts`` through a package's own
    ``build_triangles`` and ``InstancedMesh``."""
    nt = verts.shape[0]
    soa = build(verts.reshape(-1, 3), np.arange(nt * 3).reshape(nt, 3))
    return mod.InstancedMesh(triangles=soa,
                             transform=np.eye(4, dtype=np.float32),
                             instance_id=0, mesh_slot=0)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()
                if not k.startswith("_")}
    return jnp.asarray(tree) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def soup():
    """(port's own build as tensors, its numpy build, rfw_tpu's numpy
    build, rfw_tpu's build as jax arrays), all with the child tables."""
    verts = _soup_verts()
    ref = jax_sd.build_device_scene(
        [_instance(jax_sd, j_build_triangles, verts)],
        JMaterialList().generate_device_materials(),
        j_pack_lights([], [], [], []), None, None, J_CFG)
    port = scene_data.build_device_scene(
        [_instance(scene_data, build_triangles, verts)], None, None, None,
        None, CFG)
    return scene_data.scene_to_torch(port, "cpu"), port, ref, _to_jax(ref)


def _torch(x):
    return torch.tensor(np.asarray(x))


def _rays(n, seed=0, dead_frac=0.3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(n, 1e30, np.float32)
    tm[rng.random(n) < dead_frac] = 0.0
    return o, d, tm


@pytest.mark.parametrize("size", [32, 64, 128])
def test_subdivide_cells_matches_reference(size):
    verts = _soup_verts()
    tmin, tmax = j_builder.triangle_bounds(verts)
    cells = j_wide.spatial_treelets(tmin, tmax, size=size)
    ref = j_wide.subdivide_cells(cells.pad_map.copy(), tmin, tmax, size)
    got = p_wide.subdivide_cells(cells.pad_map.copy(), tmin, tmax, size)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_subcell_scene_matches_reference(soup):
    _, port, ref, _ = soup
    for k in ("bmin32", "bmax32", "wplanes32", "slot_to_prim", "wplanes",
              "verts", "bmin", "bmax"):
        a, b = ref["treelets"][k], port["treelets"][k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert np.array_equal(a, b), k
    assert port["treelets"]["wplanes32"].shape[1:] == (16, 128)


@pytest.fixture(scope="module", params=[128, 2], ids=["m_c128", "m_c2"])
def first_window(soup, request):
    """Pass 0's parent window through both packages' child expansion, on
    the same 1024 rays and a fifth 256-ray block of dead lanes (whose
    window holds only invalid parent slots): (JAX inputs and lists, port
    inputs and lists, the port's expansion arguments)."""
    m_c = request.param
    _, _, _, ref = soup
    tl = ref["treelets"]
    o, d, tm = (np.concatenate(x) for x in zip(_rays(1024), _rays(256, 1)))
    tm[1024:] = 0.0
    rays8 = jvi._pack_rays8(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    wg, b8, _, _ = jvi._granularity(tl, j_config.RenderConfig())
    diag = jnp.sqrt(jnp.sum((tl["scene_hi"] - tl["scene_lo"]) ** 2))
    t_p = b8.shape[1]
    keys, counts = jvi.sort_candidates(jvi.block_entries(rays8, b8), diag,
                                       m_c)
    ids = jvi.window_candidates(keys, counts, 0, diag, m_c, t_p)[0]
    j_lists = jtv.expand_children(ids, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(tm), tl["bmin32"], tl["bmax32"],
                                  diag, t_p)
    rays = pvi._pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(tm))
    p_args = (_torch(ids), rays, _torch(tl["bmin32"]), _torch(tl["bmax32"]),
              _torch(diag), t_p)
    p_lists = ptv.expand_children(*p_args)
    return rays8, j_lists, rays, p_lists, p_args


def test_expand_children_exact(first_window):
    """The wrapper on CPU tensors equals the plain version and rfw_tpu's
    expansion, including invalid parent slots and a block of dead lanes
    (whose sub-blocks get empty lists)."""
    _, j_lists, _, p_lists, p_args = first_window
    ref = ptv.expand_children_ref(*p_args)
    for name, a, b, c in zip(("cids", "counts", "tnears"), j_lists, p_lists,
                             ref):
        assert np.array_equal(np.asarray(a), b.numpy()), name
        assert torch.equal(b, c), name
    ids, t_p = p_args[0], p_args[-1]
    assert bool((ids >= t_p).any()) and bool((ids < t_p).any())
    assert int(p_lists[1].max()) > 1
    assert p_lists[1][8:].tolist() == [0, 0]           # the dead block
    assert bool((p_lists[0][8:] == 4 * t_p).all())
    assert bool((p_lists[2][8:] == ptv.BIG_T).all())


MADE_UP = ("all_real", "interleaved", "one_live", "dead_nan", "far")


def _window(first_window, name):
    """The expansion's arguments for one of synthetic.expansion_windows'
    made-up windows, built on the first window."""
    p_args = first_window[4]
    ids, rays = (torch.from_numpy(x) for x in synthetic.expansion_windows(
        p_args[0].numpy(), p_args[1].numpy(), p_args[-1], seed=11)[name])
    return (ids, rays, *p_args[2:])


def _closed_only(cids, tnears, j_cids, j_tnears):
    """The child ids of a port list (cids, tnears) that rfw_tpu's list of
    the same sub-block leaves out; rfw_tpu's entries must be the port's
    in the same order."""
    extra, at = set(), 0
    for c, t in zip(cids.tolist(), tnears.tolist()):
        if at < len(j_cids) and (c, t) == (int(j_cids[at]),
                                           float(j_tnears[at])):
            at += 1
        else:
            extra.add(c)
    assert at == len(j_cids)
    return extra


def _slab(lo, hi, lanes):
    """Per-lane slab entry (clamped at 0), exit and t_hi of a box."""
    inv = ptv.safe_inv_dir(lanes[4:7])
    t1 = (lo[:, None] - lanes[0:3]) * inv
    t2 = (hi[:, None] - lanes[0:3]) * inv
    ent = torch.clamp(torch.minimum(t1, t2).amax(0), min=0.0)
    return ent, torch.maximum(t1, t2).amin(0), lanes[3]


@pytest.mark.parametrize("name", MADE_UP)
def test_expand_made_up_windows_exact(first_window, name):
    """chip_smoke.py's made-up windows (all parents real, invalid ones
    interleaved, one live lane a sub-block, dead and NaN t_hi blocks, a
    ray reaching the far-point box) through the wrapper,
    expand_children_ref and rfw_tpu's expansion on the CPU: exactly
    equal, except on ``far``. There the far lane meets the far-point box
    that invalid slots hold, and some flat child boxes, with ent == ext,
    which the port's closed slab test crosses and rfw_tpu's strict
    ``ent < ext`` does not (``visit_intersect.slab_crossed``): the port
    lists those slots (invalid ones as child id 4*t_p), and its lists
    without them are rfw_tpu's, in order."""
    args = _window(first_window, name)
    ids, rays, bmin32, bmax32, diag, t_p = args
    ref = ptv.expand_children_ref(*args)
    for what, b, c in zip(("cids", "counts", "tnears"), ref,
                          ptv.expand_children(*args)):
        assert torch.equal(b, c), what
    r = rays.numpy()
    j_lists = [torch.from_numpy(np.array(x)) for x in jtv.expand_children(
        jnp.asarray(ids.numpy()), jnp.asarray(r[0:3].T.copy()),
        jnp.asarray(r[4:7].T.copy()), jnp.asarray(r[3]),
        jnp.asarray(bmin32.numpy()), jnp.asarray(bmax32.numpy()),
        jnp.asarray(diag.numpy()), t_p)]
    cids, counts, tnears = ref
    if name == "far":
        lo = torch.cat([bmin32, torch.full((1, 3), 3e37)])
        hi = torch.cat([bmax32, torch.full((1, 3), 3e37)])
        for row in range(cids.shape[0]):
            extra = _closed_only(cids[row, :int(counts[row])],
                                 tnears[row, :int(counts[row])],
                                 j_lists[0][row, :int(j_lists[1][row])],
                                 j_lists[2][row, :int(j_lists[1][row])])
            # every sub-block's lane 0 reaches the far box
            assert (4 * t_p in extra) == bool((ids[row // 2] >= t_p).any())
            lanes = rays[:, row * ptv.LANES:(row + 1) * ptv.LANES]
            for c in extra:
                ent, ext, t_hi = _slab(lo[c], hi[c], lanes)
                assert bool(((ent <= ext) & (ent < t_hi)).any()), c
                assert not bool(((ent < ext) & (ent < t_hi)).any()), c
    else:
        for what, a, b in zip(("cids", "counts", "tnears"), j_lists, ref):
            assert torch.equal(a, b), what
    live = (rays[3] > 0).reshape(-1, ptv.LANES)
    assert bool((counts[~live.any(1)] == 0).all())
    if name == "all_real":
        assert bool((ids < t_p).all())
        assert int(counts.max()) > ids.shape[1]     # more than one a parent
    elif name == "interleaved":
        assert bool(((ids < t_p).any(1) & (ids >= t_p).any(1)).any())
    elif name == "one_live":
        assert live.sum(1).tolist() == [1] * live.shape[0]
        assert int(counts.max()) > 0
    elif name == "dead_nan":
        assert bool(rays[3].isnan().any()) and int(counts.max()) > 0
        assert not bool(live.reshape(-1, 2, ptv.LANES)[::4].any())


@pytest.mark.parametrize("any_hit", [False, True])
def test_tvisit_plain_matches_pallas(soup, first_window, any_hit):
    scene, port, _, ref = soup
    rays8, (cids, counts, tnears), rays, p_lists, _ = first_window
    wg32 = ref["treelets"]["wplanes32"]
    k32 = ref["treelets"]["slot_to_prim"].shape[0] // wg32.shape[0]
    t_j, s_j = jtv._run_tvisit_kernel(rays8, cids, counts, tnears, wg32, k32,
                                      J_CFG.t_epsilon, any_hit)
    t_t, s_t = ptv.tvisit(rays, *p_lists,
                          torch.from_numpy(port["treelets"]["wplanes32"]),
                          scene["treelets"]["wplanes32_tm"], k32,
                          CFG.t_epsilon, any_hit)
    t_j, s_j, t_t, s_t = np.asarray(t_j), np.asarray(s_j), t_t.numpy(), \
        s_t.numpy()
    assert ((s_j >= 0) == (s_t >= 0)).all()
    both = s_j >= 0
    assert both.sum() > 10
    assert (s_j[both] == s_t[both]).mean() > 0.999
    assert (np.abs(t_j[both] - t_t[both])
            / np.maximum(t_j[both], 1e-6)).max() < 1e-4


def _brute(scene, o, d):
    v = scene["tri_vertices"]
    return traverse.brute_force_closest(
        o, d, (v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
        t_epsilon=CFG.t_epsilon)


@pytest.mark.parametrize("case", ["closest", "recull"])
def test_closest_hit_matches_brute(soup, monkeypatch, case):
    """tests/test_tvisit.py's oracle cases; "recull" caps the parent
    window at 2 cells, so every block runs several passes."""
    scene = soup[0]
    if case == "recull":
        monkeypatch.setattr(ptv, "M_C", 2)
        o, d, tm = _rays(512, seed=13, dead_frac=0.2)
    else:
        o, d, tm = _rays(1024)
    o, d, tm = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm)
    t_p, prim_p, _, _ = ptv.closest_hit(scene, o, d, CFG, t_max=tm)
    t_b, prim_b, _, _ = _brute(scene, o, d)
    prim_b = torch.where((t_b < tm) & (prim_b >= 0), prim_b, -1)
    t_p, prim_p, t_b, prim_b = (x.numpy() for x in (t_p, prim_p, t_b,
                                                    prim_b))
    assert ((prim_p >= 0) == (prim_b >= 0)).all()
    both = (prim_p >= 0) & (prim_b >= 0)
    assert both.sum() > 10
    assert (prim_p[both] == prim_b[both]).mean() > 0.999
    terr = np.abs(t_p[both] - t_b[both]) / np.maximum(t_b[both], 1e-6)
    assert terr.max() < 1e-4


def test_any_hit_matches_brute(soup):
    scene = soup[0]
    o, d, _ = _rays(1024, seed=3, dead_frac=0.0)
    dist = np.full(1024, 6.0, np.float32)
    dist[np.random.default_rng(5).random(1024) < 0.3] = 0.0
    o, d, dist = torch.from_numpy(o), torch.from_numpy(d), \
        torch.from_numpy(dist)
    occ = ptv.any_hit(scene, o, d, dist, CFG)
    t_b, prim_b, _, _ = _brute(scene, o, d)
    assert torch.equal(occ, (prim_b >= 0) & (t_b < dist))


@pytest.mark.parametrize("mod", [pvi, ptv], ids=["visit", "tvisit"])
def test_lone_ray_hits_padded_wall(mod):
    """A wall at z = 15 (chip_smoke's back wall): its boxes are padded by
    one ulp there, ``lo - o`` rounds that away and the ray's slab
    interval collapses to ent == ext. The closed slab test keeps the hit
    for a ray that no other ray of its block helps (rfw_tpu's strict test
    reports a miss here)."""
    from rfw_tpu_torch.utils.synthetic import _grid
    pos, _, faces = _grid([-20, 0, 15], np.float32([40, 0, 0]),
                          np.float32([0, 20, 0]), 40)
    inst = scene_data.InstancedMesh(
        triangles=build_triangles(pos, faces),
        transform=np.eye(4, dtype=np.float32), instance_id=0, mesh_slot=0)
    scene = scene_data.scene_to_torch(
        scene_data.build_device_scene([inst], None, None, None, None, CFG),
        "cpu")
    o = torch.tensor([[-13.531232833862305, 0.0010000000474974513,
                       -4.724479675292969]])
    d = torch.tensor([[-1.1448605619079899e-05, 0.5722855925559998,
                       0.8200543522834778]])
    t_b, prim_b, _, _ = _brute(scene, o, d)
    assert int(prim_b[0]) >= 0
    t, prim, _, _ = mod.closest_hit(scene, o, d, CFG)
    assert int(prim[0]) == int(prim_b[0])
    assert abs(float(t[0]) - float(t_b[0])) < 1e-4 * float(t_b[0])
    assert bool(mod.any_hit(scene, o, d, torch.tensor([30.0]), CFG)[0])


def test_switch_after_build_rebuilds_tables(monkeypatch):
    """Selecting tvisit after the scene was built without child tables
    rebuilds the geometry with them (tests/test_tvisit.py's regression),
    and the frame equals the port's own visit frame."""
    calls = []
    plain = ptv.tvisit_ref
    monkeypatch.setattr(ptv, "tvisit_ref",
                        lambda *a: calls.append(1) or plain(*a))
    cfg = RenderConfig(max_path_length=2, blue_noise=False,
                       max_rays_per_pass=1024)
    eng = create_engine("wavefront", cfg, device="cpu")
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights(
        [], [PointLight(position=np.array([1.0, 4.0, -1.0], np.float32),
                        radiance=np.array([30.0, 30.0, 30.0],
                                          np.float32))], [], []))
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    cam = rfw_tpu_torch.Camera()
    cam.resize(48, 32)
    cam.fov = 55
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    eng.resize(48, 32)
    view = cam.get_view().as_pytree()
    a = eng.render_frame(view, RenderStatus.RESET, samples=2)
    assert "bmin32" not in eng._scene["treelets"] and not calls
    eng.set_setting("intersector", "tvisit")            # post-build switch
    assert cfg.subcell_tables
    assert "tvisit" in eng.get_available_settings()[0].options
    # CONVERGE: the rebuilt scene restarts accumulation all the same
    b = eng.render_frame(view, RenderStatus.CONVERGE, samples=2)
    assert "bmin32" in eng._scene["treelets"] and calls
    assert eng._driver is not None                      # 2 chunks
    assert np.isfinite(b).all() and b.mean() > 1e-5
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_missing_child_tables_raise(soup):
    port = scene_data.scene_to_torch(
        scene_data.build_device_scene(
            [_instance(scene_data, build_triangles, _soup_verts())], None,
            None, None, None, RenderConfig()), "cpu")
    o, d, _ = (torch.from_numpy(x) for x in _rays(256))
    with pytest.raises(ValueError, match="subcell_tables"):
        ptv.closest_hit(port, o, d, CFG)
    with pytest.raises(ValueError, match="subcell_tables"):
        ptv.any_hit(port, o, d, torch.full((256,), 5.0), CFG)
    rays = torch.zeros((8, 256), device="meta")
    with pytest.raises(RuntimeError, match="no visit-list kernels"):
        ptv.tvisit(rays, torch.zeros((2, 8), dtype=torch.int32,
                                     device="meta"),
                   torch.zeros(2, dtype=torch.int32, device="meta"),
                   torch.zeros((2, 8), device="meta"),
                   torch.zeros((4, 16, 128), device="meta"),
                   torch.zeros((4, 32, 12), device="meta"), 32, 1e-4,
                   False)
    with pytest.raises(RuntimeError, match="no visit-list kernels"):
        ptv.expand_children(torch.zeros((1, 2), dtype=torch.int32,
                                        device="meta"), rays,
                            torch.zeros((8, 3), device="meta"),
                            torch.zeros((8, 3), device="meta"),
                            torch.zeros((), device="meta"), 2)


def test_walked_is_kernel_only(soup, first_window):
    """``walked=`` is filled by the kernel alone: on CPU tensors the
    wrapper raises instead of running the plain version without it."""
    scene = soup[0]
    _, _, rays, (cids, counts, tnears), _ = first_window
    tl = scene["treelets"]
    _, _, wg32, wtm32, k32 = ptv.child_tables(tl)
    walked = torch.zeros(cids.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match="kernel only"):
        ptv.tvisit(rays, cids, counts, tnears, wg32, wtm32, k32,
                   CFG.t_epsilon, False, walked=walked)


@pytest.mark.parametrize("subcell", [True, False], ids=["on", "off"])
def test_triangle_major_child_planes(soup, subcell):
    """``wplanes32_tm`` is rows 0-11 of ``wplanes32[:, :, :k32]``, one
    triangle's 12 floats after another, and exists exactly when the scene
    has the child tables."""
    if subcell:
        tl = soup[0]["treelets"]
    else:
        tl = scene_data.scene_to_torch(scene_data.build_device_scene(
            [_instance(scene_data, build_triangles, _soup_verts())], None,
            None, None, None, RenderConfig()), "cpu")["treelets"]
    assert ("wplanes32_tm" in tl) == ("bmin32" in tl) == subcell
    if not subcell:
        return
    wp = tl["wplanes32"].numpy()
    k32 = tl["slot_to_prim"].shape[0] // wp.shape[0]
    assert k32 == 32 and wp.shape[2] == 128
    got = tl["wplanes32_tm"]
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert np.array_equal(got.numpy(),
                          wp[:, :12, :k32].transpose(0, 2, 1))
    assert np.array_equal(got[-1, 7].numpy(), wp[-1, :12, 7])


@pytest.mark.parametrize(
    "qmax", [(1 << (24 - pvi._cid_bits(4096))) - 1,
             (1 << (24 - pvi._cid_bits(1024))) - 1,
             ptv._slot_bits(4 * ptv.M_C)[1]],
    ids=["cells4096", "cells1024", "children"])
def test_quant_gran_is_the_ieee_quotient(soup, qmax):
    """``quant_gran`` (the keys' step, diag / qmax) is numpy's IEEE
    float32 quotient for the cell keys' and the child keys' qmax. The
    seeded diagonals include some where a multiply by the reciprocal,
    what the card makes of a tensor divided by a Python number, is off by
    an ulp."""
    diags = np.concatenate([
        np.random.default_rng(17).uniform(1.0, 200.0, 4096),
        [float(pvi.scene_diag(soup[0]["treelets"])), 1.0, 1e-3]]).astype(
            np.float32)
    want = diags / np.float32(qmax)
    got = np.array([pvi.quant_gran(qmax, torch.tensor(d)).item()
                    for d in diags[-3:]], np.float32)
    got = np.concatenate([pvi.quant_gran(qmax, torch.from_numpy(
        diags[:-3])).numpy(), got])
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (diags * (np.float32(1.0) / np.float32(qmax)) != want).any()


def test_expand_times_swaps_and_restores_libraries(monkeypatch, tmp_path):
    """tools/expand_times.py builds an earlier checkout's kernels from its
    own csrc/ and leaves this checkout's library state as it was; `using`
    routes launches to a library inside its block only; the wrapper
    module's `expand_occupancy` reads the kernel's resident blocks
    through a pointer."""
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.tools import expand_times
    seen = {}

    def fake_load():
        seen["sources"] = cuda_lib.SOURCES
        cuda_lib.build_log = "Compiling entry function '_Z13expand_kernelv'" \
            "\nptxas info    : Used 47 registers, 19520 bytes smem"
        return "parent-lib"

    monkeypatch.setattr(cuda_lib, "load", fake_load)
    before = (cuda_lib.SOURCES, cuda_lib._lib, cuda_lib.build_log)
    lib, report = expand_times.parent_library(str(tmp_path))
    assert lib == "parent-lib" and report["registers"] == 47
    csrc = tmp_path / "rfw_tpu_torch" / "csrc"
    assert seen["sources"] == tuple(str(csrc / pathlib.Path(s).name)
                                    for s in before[0])
    assert (cuda_lib.SOURCES, cuda_lib._lib, cuda_lib.build_log) == before
    with expand_times.using("other"):
        assert cuda_lib._lib == "other"
    assert cuda_lib._lib == before[1]

    class Lib:
        def rfw_expand_occupancy(self, blocks):
            blocks._obj.value = 10
            return 0

    assert ptv.expand_occupancy(Lib()) == 10
