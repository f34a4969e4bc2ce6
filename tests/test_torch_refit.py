"""Same-topology updates of the port (``render/scene_data.py``'s refit
paths, the engine's rebuild-vs-refit policy) against fresh builds and
against rfw_tpu.

* A deformed mesh or a moved instance renders like a fresh build of the
  same geometry (RMSE < 1e-3, tests/test_refit.py's bar), through visit
  and tvisit, by the device update (``scene_data.move_instances_device``)
  without a full build, also deformations and moves in turn, whose move
  tables follow the mesh versions; a change of topology builds in full;
  with ``device_refit=False`` and under the ``bvh`` intersector
  (``megakernel``), a same-topology update takes the host refit, without
  a full build, and renders like a fresh build.
* The host refit's tables equal rfw_tpu's ``refit_deformed`` on the same
  inputs: the wide BVH, the planes, the pack and the cell tables; its
  tvisit child tables equal a fresh build's where that build keeps the
  cells, and rfw_tpu's stay as they were built.
* The device update's tables equal rfw_tpu's device refit
  (``make_device_refit``) on the same inputs: the Morton order and
  ``slot_to_prim`` exactly, the planes, bounds and pack within 1e-5, but
  for the Woop w rows, which the port makes as the build does (README,
  deviations); the kernels' derived tables are made again.
* ``build_device_scene_cached`` gives the uncached build, and never
  reads an entry that other build sources wrote.
* Config 4 (a skinned glTF, built at t = 0 and posed at t = 0.5 through
  the refit, as tests/golden_scenes.py::make_config4 poses CesiumMan)
  lies within RMSE 2e-3 of rfw_tpu's wavefront frame, and both within
  that bar of a fresh build at t = 0.5.

The fresh builds and every engine here run with the disk cache off, so
that each build is counted; the cache test gives it a temporary
directory.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu import config as j_config
from rfw_tpu.ops.intersect import woop_matrices as j_woop
from rfw_tpu.render import scene_data as jax_sd
from rfw_tpu.scene.mesh import build_triangles as j_build_triangles

import chip_smoke
import rfw_tpu_torch
from rfw_tpu_torch.bvh import triangle_bounds
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import traverse
from rfw_tpu_torch.ops import visit_intersect as pvi
from rfw_tpu_torch.ops.intersect import woop_matrices as p_woop
from rfw_tpu_torch.render import RenderStatus, create_engine
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.scene import HostMaterial, MaterialList, Skybox, make_quad
from rfw_tpu_torch.scene.lights import PointLight, pack_lights
from rfw_tpu_torch.scene.mesh import build_triangles
from rfw_tpu_torch.system import RenderSystem
from rfw_tpu_torch.utils import synthetic
from rfw_tpu_torch.utils.synthetic import write_skinned_gltf


@pytest.fixture(autouse=True)
def _no_scene_cache(monkeypatch):
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small frames are thousands of small torch ops: one thread
    runs them as fast as many and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def _wavy(build, shift=0.0, bend=0.0):
    """A 12x12 grid (288 triangles) standing at z = 0.5, rippled along
    x; ``shift`` moves the ripple's phase and ``bend`` tilts its top:
    one topology, many shapes."""
    pos, _, faces = synthetic._grid([-1.5, 0.0, 0.5], np.float32([3, 0, 0]),
                                    np.float32([0, 2, 0]), 12)
    pos = pos.copy()
    pos[:, 2] += 0.15 * np.sin(3.0 * pos[:, 0] + shift) + bend * pos[:, 1]
    return build(pos, faces)


def _count_calls(monkeypatch, name):
    calls = {"n": 0}
    real = getattr(scene_data, name)

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(scene_data, name, counting)
    return calls


def _count_builds(monkeypatch):
    return _count_calls(monkeypatch, "build_device_scene")


def _count_device_updates(monkeypatch):
    return _count_calls(monkeypatch, "move_instances_device")


def _device_update(scene, instances):
    """The device update of the tensor ``scene`` to ``instances``, over
    move tables made of their meshes' planes."""
    tables = scene_data.move_tables(scene, instances,
                                    _slot_planes(instances, True))
    return scene_data.move_instances_device(scene, tables, instances)


def _engine(intersector, **cfg_kw):
    cfg = RenderConfig(blue_noise=False, max_path_length=1,
                       russian_roulette=False, **cfg_kw)
    eng = create_engine("wavefront", cfg, device="cpu")
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights(
        [], [PointLight(position=np.array([1.0, 4.0, -1.0], np.float32),
                        radiance=np.array([30.0, 30.0, 30.0], np.float32))],
        [], []))
    eng.set_setting("intersector", intersector)
    eng.resize(40, 40)
    return eng


def _scene(eng, wavy, moved=np.eye(4, dtype=np.float32)):
    """tests/test_refit.py's floor and small quad, plus the wavy grid."""
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0).triangles())
    eng.set_mesh(2, wavy)
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, moved)
    eng.set_instance(2, 2, np.eye(4, dtype=np.float32))


def _render(eng):
    cam = rfw_tpu_torch.Camera()
    cam.resize(40, 40)
    cam.fov = 55
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    return eng.render_frame(cam.get_view().as_pytree(), RenderStatus.RESET,
                            samples=2)


def _fresh(intersector, wavy, moved=np.eye(4, dtype=np.float32), **cfg_kw):
    eng = _engine(intersector, **cfg_kw)
    _scene(eng, wavy, moved)
    return _render(eng)


def _move(i):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.1 * i), np.sin(0.1 * i)
    m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    m[:3, 3] = [0.1 * i, 0.05 * i, 0.0]
    return m


@pytest.mark.parametrize("intersector", ["visit", "tvisit"])
def test_deform_refit_matches_fresh_build(monkeypatch, intersector):
    """A deformed mesh (same topology) takes the device update and renders
    like a fresh build; accumulation restarts."""
    eng = _engine(intersector)
    _scene(eng, _wavy(build_triangles))
    _render(eng)
    before = eng._scene["treelets"]
    calls = _count_builds(monkeypatch)
    updates = _count_device_updates(monkeypatch)
    deformed = _wavy(build_triangles, shift=0.9, bend=0.3)
    eng.set_mesh(2, deformed)
    moved = _render(eng)
    assert calls["n"] == 0, "deformation took the full-build path"
    assert updates["n"] == 1 and eng._refits == 0
    assert eng._sample_count == 2
    tl = eng._scene["treelets"]
    assert not torch.equal(tl["wplanes_tm"], before["wplanes_tm"])
    assert torch.equal(tl["wplanes_tm"], pvi.triangle_major(tl["wplanes"]))
    if intersector == "tvisit":
        assert not torch.equal(tl["wplanes32"], before["wplanes32"])
    monkeypatch.undo()
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")
    fresh = _fresh(intersector, deformed)
    assert _rmse(moved, fresh) < 1e-3
    assert moved.mean() > 1e-4


@pytest.mark.parametrize("intersector", ["visit", "tvisit"])
def test_instance_moves_never_hit_full_build(monkeypatch, intersector):
    """Ten instance moves under max_refits=4: the device update with fresh
    Morton cells has no drift, so no move builds in full."""
    eng = _engine(intersector, max_refits=4)
    wavy = _wavy(build_triangles)
    _scene(eng, wavy)
    _render(eng)
    calls = _count_builds(monkeypatch)
    for i in range(1, 11):
        eng.set_instance(1, 1, _move(i))
        eng.update()
    moved = _render(eng)
    assert calls["n"] == 0, f"{calls['n']} full builds during moves"
    assert eng._refits == 0
    monkeypatch.undo()
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")
    fresh = _fresh(intersector, wavy, _move(10))
    assert _rmse(moved, fresh) < 1e-3
    assert moved.mean() > 1e-4


@pytest.mark.parametrize("intersector", ["visit", "tvisit"])
def test_deformations_and_moves_take_the_device_update(monkeypatch,
                                                       intersector):
    """A deformation, a move, then another deformation: each takes one
    device update and no build, and renders like a fresh build of its
    state. The move tables follow the mesh version: made again after each
    deformation, kept across the move, their object-space planes the
    current mesh's."""
    eng = _engine(intersector)
    _scene(eng, _wavy(build_triangles))
    _render(eng)
    builds = _count_builds(monkeypatch)
    updates = _count_device_updates(monkeypatch)
    first = _wavy(build_triangles, shift=0.9, bend=0.3)
    second = _wavy(build_triangles, shift=-0.6, bend=-0.2)
    eye = np.eye(4, dtype=np.float32)
    steps = [("deform", first, eye), ("move", first, _move(4)),
             ("deform", second, _move(4))]
    frames, tables = [], []
    for kind, mesh, xf in steps:
        if kind == "deform":
            eng.set_mesh(2, mesh)
        else:
            eng.set_instance(1, 1, xf)
        frames.append(_render(eng))
        t = eng._move_tables
        tables.append(t)
        base, n = int(t["base"][2]), mesh.vertices.shape[0]
        assert torch.equal(t["obj"]["vertices"][base:base + n],
                           torch.from_numpy(np.float32(mesh.vertices)))
    assert builds["n"] == 0 and updates["n"] == 3 and eng._refits == 0
    assert tables[1] is tables[0] and tables[2] is not tables[1]
    monkeypatch.undo()
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")
    for (_, mesh, xf), frame in zip(steps, frames):
        assert _rmse(frame, _fresh(intersector, mesh, xf)) < 1e-3
        assert frame.mean() > 1e-4


def test_host_refit_is_not_ported(monkeypatch):
    """Checks that ``device_refit=False`` takes the host refit. (The name
    is kept from when the host refit was not ported and this option
    raised.) A same-topology update builds nothing, runs no device update,
    and renders like a fresh build."""
    eng = _engine("visit", device_refit=False)
    _scene(eng, _wavy(build_triangles))
    assert np.isfinite(_render(eng)).all()
    updates = _count_device_updates(monkeypatch)
    eng.prewarm_instance_moves()                 # a no-op, as in rfw_tpu
    assert eng._move_tables is None
    calls = _count_builds(monkeypatch)
    deformed = _wavy(build_triangles, shift=0.9)
    eng.set_mesh(2, deformed)
    img = _render(eng)
    assert calls["n"] == 0 and updates["n"] == 0
    assert eng._move_tables is None and eng._refits == 1
    monkeypatch.undo()
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")
    assert _rmse(img, _fresh("visit", deformed)) < 1e-3


def _megakernel(**cfg_kw):
    cfg = RenderConfig(blue_noise=False, max_path_length=1,
                       russian_roulette=False, **cfg_kw)
    eng = create_engine("megakernel", cfg, device="cpu")
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights(
        [], [PointLight(position=np.array([1.0, 4.0, -1.0], np.float32),
                        radiance=np.array([30.0, 30.0, 30.0], np.float32))],
        [], []))
    eng.resize(40, 40)
    return eng


def test_megakernel_deformation_takes_host_refit(monkeypatch):
    """Under ``bvh`` the device update would leave the wide BVH stale: a
    deformation and a move take the host refit (no full build), refit
    the BVH and its node table, and render like a fresh build."""
    eng = _megakernel()
    _scene(eng, _wavy(build_triangles))
    _render(eng)
    before = eng._scene["bvh"]
    calls = _count_builds(monkeypatch)
    refits = []
    real = scene_data.refit_deformed
    monkeypatch.setattr(scene_data, "refit_deformed",
                        lambda *a, **k: refits.append(1) or real(*a, **k))
    deformed = _wavy(build_triangles, shift=0.9, bend=0.3)
    eng.set_mesh(2, deformed)
    eng.set_instance(1, 1, _move(3))
    img = _render(eng)
    assert calls["n"] == 0 and len(refits) == 1
    assert eng._move_tables is None and eng._refits == 1
    bvh = eng._scene["bvh"]
    assert not torch.equal(bvh["bmin"], before["bmin"])
    # the int columns are bit patterns (-1 reads as a NaN)
    assert torch.equal(bvh["nodes"].view(torch.int32),
                       traverse.node_table(bvh).view(torch.int32))
    assert torch.equal(eng._scene["tri_table"], traverse.tri_table(
        traverse.tri_edges(eng._scene["tri_vertices"])))
    eng.validate()
    monkeypatch.undo()
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")
    fresh = _megakernel()
    _scene(fresh, deformed, _move(3))
    want = _render(fresh)
    assert _rmse(img, want) < 2e-3
    assert img.mean() > 1e-4


def _pair(kw, xf, cfg, j_cfg, scale=None):
    """Both builds of ``_instances``' scene, every instance premultiplied
    by ``scale`` when given."""
    def inst(sd, build):
        out = _instances(sd, build, kw, xf)
        if scale is not None:
            for im in out:
                im.transform = (scale @ im.transform).astype(np.float32)
        return out
    ref = jax_sd.build_device_scene(inst(jax_sd, j_build_triangles), None,
                                    None, None, None, j_cfg)
    port = scene_data.build_device_scene(inst(scene_data, build_triangles),
                                         None, None, None, None, cfg)
    return ref, port, inst


@pytest.mark.parametrize("case", ["deform", "move"])
def test_refit_deformed_matches_reference(case):
    """The port's host refit against rfw_tpu's on the same inputs (both
    builds equal array for array): every table rfw_tpu's refit rewrites
    is equal, and the child tables rfw_tpu's leaves alone are the
    port's own."""
    cfg = RenderConfig(subcell_tables=True)
    j_cfg = j_config.RenderConfig(subcell_tables=True)
    eye = np.eye(4, dtype=np.float32)
    ref, port, _ = _pair({}, eye, cfg, j_cfg)
    kw, xf = (({"shift": 0.7, "bend": -0.25}, eye) if case == "deform"
              else ({}, _move(4)))
    j_inst = _instances(jax_sd, j_build_triangles, kw, xf)
    p_inst = _instances(scene_data, build_triangles, kw, xf)
    caps = {"bvh_nodes": port["bvh"]["child"].shape[0]}
    got_ref = jax_sd.refit_deformed(dict(ref), j_inst, ref["_perm_host"],
                                    ref["_bvh_host"], j_cfg, dict(caps),
                                    pack_host=ref["_pack_host"])
    # the port's refit takes the device scene's tensors
    got = scene_data.refit_deformed(
        scene_data.scene_to_torch(port, "cpu"), p_inst, port["_perm_host"],
        port["_bvh_host"], cfg, dict(caps), pack_host=port["_pack_host"])
    assert got is not None and got_ref is not None
    for key in ("bmin", "bmax", "child", "count"):
        np.testing.assert_array_equal(got["bvh"][key], got_ref["bvh"][key],
                                      err_msg=key)
    assert not np.array_equal(got["bvh"]["bmin"], port["bvh"]["bmin"])
    for key in ("tri_vertices", "tri_normals", "tri_gnormal", "tri_tangent",
                "tri_bitangent", "tri_area", "tri_pack", "_pack_host"):
        np.testing.assert_array_equal(got[key], got_ref[key], err_msg=key)
    tl, tl_ref = got["treelets"], got_ref["treelets"]
    for key in ("wplanes", "verts", "bmin", "bmax", "sbmin", "sbmax",
                "scene_lo", "scene_hi"):
        np.testing.assert_array_equal(tl[key], tl_ref[key], err_msg=key)
    assert "cbounds" not in tl and "woop" not in tl
    # rfw_tpu's child tables are the build's; the port's follow the
    # refit: boxes around the members' padded bounds, planes from the
    # cells' own Woop rows
    for key in ("bmin32", "bmax32", "wplanes32"):
        np.testing.assert_array_equal(tl_ref[key], ref["treelets"][key])
        assert not np.array_equal(tl[key], tl_ref[key]), key
    k4 = 32
    n32 = tl["bmin32"].shape[0]
    np.testing.assert_array_equal(
        tl["wplanes32"][:, :12, :k4],
        tl["wplanes"][:, :12].reshape(-1, 12, 4, k4).transpose(
            0, 2, 1, 3).reshape(n32, 12, k4))
    stp = tl["slot_to_prim"].numpy().reshape(n32, k4)
    lo, hi = triangle_bounds(got["tri_vertices"])
    for c in range(0, n32, 97):
        m = stp[c][stp[c] >= 0]
        if len(m):
            np.testing.assert_array_equal(tl["bmin32"][c], lo[m].min(0))
            np.testing.assert_array_equal(tl["bmax32"][c], hi[m].max(0))
    # the scene_to_torch of the refit derives the kernels' tables anew
    t = scene_data.scene_to_torch(got, "cpu")
    assert torch.equal(t["treelets"]["wplanes32_tm"],
                       pvi.device_tables(t["treelets"])["wplanes32_tm"])
    assert torch.equal(t["bvh"]["nodes"].view(torch.int32),
                       traverse.node_table(t["bvh"]).view(torch.int32))


def test_refit_child_tables_equal_fresh_build():
    """Scaling the whole scene by 2 keeps every cell's members (the kd
    splits and the child quarters follow the centroids' order): a fresh
    build of the scaled scene has the refit's cells, and the port's
    refit gives its child tables exactly, where rfw_tpu's keeps the
    unscaled ones."""
    cfg = RenderConfig(subcell_tables=True)
    j_cfg = j_config.RenderConfig(subcell_tables=True)
    eye = np.eye(4, dtype=np.float32)
    two = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    ref, port, _ = _pair({}, eye, cfg, j_cfg)
    _, fresh, inst = _pair({}, eye, cfg, j_cfg, scale=two)
    caps = {"bvh_nodes": port["bvh"]["child"].shape[0]}
    got = scene_data.refit_deformed(
        dict(port), inst(scene_data, build_triangles), port["_perm_host"],
        port["_bvh_host"], cfg, dict(caps), pack_host=port["_pack_host"])
    got_ref = jax_sd.refit_deformed(
        dict(ref), inst(jax_sd, j_build_triangles), ref["_perm_host"],
        ref["_bvh_host"], j_cfg, dict(caps), pack_host=ref["_pack_host"])
    members = [p["_perm_host"][np.maximum(p["treelets"]["slot_to_prim"], 0)]
               for p in (port, fresh)]
    assert np.array_equal(*members), "the scaled build cut other cells"
    for key in ("bmin32", "bmax32", "wplanes32"):
        np.testing.assert_array_equal(got["treelets"][key],
                                      fresh["treelets"][key], err_msg=key)
        np.testing.assert_array_equal(got_ref["treelets"][key],
                                      ref["treelets"][key], err_msg=key)
        assert not np.array_equal(got_ref["treelets"][key],
                                  fresh["treelets"][key]), key


def test_topology_change_forces_build(monkeypatch):
    eng = _engine("visit")
    _scene(eng, _wavy(build_triangles))
    _render(eng)
    calls = _count_builds(monkeypatch)
    tris = make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles()
    double = type(tris)(**{f.name: np.concatenate([getattr(tris, f.name)] * 2)
                           for f in dataclasses.fields(tris)})
    eng.set_mesh(0, double)
    img = _render(eng)
    assert calls["n"] == 1 and eng._refits == 0
    assert np.isfinite(img).all()


def test_small_tables_upload_once_per_object():
    """An instance move re-uploads neither materials, lights nor the blue
    noise: their device tensors keep their identity, so WavefrontDriver's
    pixel cache (keyed on the blue noise's id) holds."""
    cfg = RenderConfig(max_path_length=1, max_rays_per_pass=512)
    eng = create_engine("wavefront", cfg, device="cpu")
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    _scene(eng, _wavy(build_triangles))
    eng.resize(40, 40)
    _render(eng)
    before = {k: eng._scene[k] for k in ("materials", "lights",
                                         "blue_noise")}
    pc = eng._driver._pixel_cache(eng._scene)
    eng.set_instance(1, 1, _move(3))
    _render(eng)
    for k, v in before.items():
        assert eng._scene[k] is v, k
    assert eng._driver._pixel_cache(eng._scene) is pc
    eng.set_materials(ml.generate_device_materials())       # a new object
    eng.update()
    assert eng._scene["materials"] is not before["materials"]


def test_prewarm_instance_moves_keeps_state(monkeypatch):
    eng = _engine("visit")
    _scene(eng, _wavy(build_triangles))
    _render(eng)
    scene, geo_key = eng._scene, eng._geo_key
    eng.prewarm_instance_moves()
    assert eng._move_tables is not None
    assert eng._scene is scene and eng._geo_key == geo_key
    calls = _count_builds(monkeypatch)
    eng.set_instance(1, 1, _move(2))
    eng.update()
    assert calls["n"] == 0


# ---------------------------------------------------------------------------
# the refit's tables against rfw_tpu's
# ---------------------------------------------------------------------------

def _instances(sd, build, wavy_kw, xf):
    floor = synthetic._grid([-4.0, 0.0, -4.0], np.float32([0, 0, 8]),
                            np.float32([8, 0, 0]), 16)
    return [sd.InstancedMesh(triangles=build(floor[0], floor[2]),
                             transform=np.eye(4, dtype=np.float32),
                             instance_id=0, mesh_slot=0),
            sd.InstancedMesh(triangles=_wavy(build, **wavy_kw),
                             transform=xf, instance_id=1, mesh_slot=1)]


def _slot_planes(instances, torch_out: bool):
    out = {}
    for im in instances:
        planes = {k: getattr(im.triangles, k) for k in scene_data.SLOT_PLANES}
        out[im.mesh_slot] = ({k: torch.from_numpy(v) for k, v in
                              planes.items()} if torch_out else planes)
    return out


@pytest.mark.parametrize("case", ["deform", "move"])
def test_make_device_refit_tables_match_reference(case):
    cfg = RenderConfig(subcell_tables=True)
    j_cfg = j_config.RenderConfig(subcell_tables=True)
    eye = np.eye(4, dtype=np.float32)
    ref = jax_sd.build_device_scene(
        _instances(jax_sd, j_build_triangles, {}, eye), None, None, None,
        None, j_cfg)
    port_np = scene_data.build_device_scene(
        _instances(scene_data, build_triangles, {}, eye), None, None, None,
        None, cfg)
    port = scene_data.scene_to_torch(port_np, "cpu")
    np.testing.assert_array_equal(port_np["_perm_host"], ref["_perm_host"])
    if case == "deform":      # new vertices, the same (identity) transform
        kw, xf = {"shift": 0.7, "bend": -0.25}, eye
    else:                     # the same vertices, the instance moved
        kw, xf = {}, _move(4)
    j_inst = _instances(jax_sd, j_build_triangles, kw, xf)
    p_inst = _instances(scene_data, build_triangles, kw, xf)
    ref_in = dict(ref)
    ref_in["tri_pack"] = jnp.asarray(ref["tri_pack"])
    got_ref = jax_sd.make_device_refit(ref_in, j_inst, ref["_perm_host"],
                                       j_cfg)(_slot_planes(j_inst, False),
                                              [im.transform for im in j_inst])
    got = _device_update(port, p_inst)
    tl, tl_ref = got["treelets"], got_ref["treelets"]
    n_tris = port_np["tri_vertices"].shape[0]
    stp_ref = np.asarray(tl_ref["slot_to_prim"])
    # the Morton order of the same vertices is the reference's, exactly
    order = scene_data.morton_order(
        torch.from_numpy(np.asarray(got_ref["tri_vertices"])))
    np.testing.assert_array_equal(order.numpy(), stp_ref[:n_tris])
    if case == "deform":
        np.testing.assert_array_equal(tl["slot_to_prim"].numpy(), stp_ref)
    else:
        # near-equal vertices may swap equal-rank neighbours at most
        assert float((tl["slot_to_prim"].numpy() == stp_ref).mean()) > 0.99
    for key in ("tri_vertices", "tri_normals", "tri_gnormal", "tri_tangent",
                "tri_bitangent", "tri_area", "tri_pack"):
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(got_ref[key]), rtol=0,
                                   atol=1e-5, err_msg=key)
    if case == "deform":
        for key in ("verts", "bmin", "bmax", "sbmin", "sbmax", "scene_lo",
                    "scene_hi", "bmin32", "bmax32"):
            np.testing.assert_allclose(tl[key].numpy(),
                                       np.asarray(tl_ref[key]), rtol=0,
                                       atol=1e-5, err_msg=key)
        # the u and v rows and the bounds row within 1e-5 of rfw_tpu's
        # refit; the w rows as rfw_tpu's build makes them (n / |n|², in
        # float64; its refit keeps n in float32), and bit for bit the
        # port's own build arithmetic on the same vertices
        pv = np.asarray(tl_ref["verts"])
        build_w = j_woop(pv[:, 0], pv[:, 1], pv[:, 2])
        port_w = p_woop(*(tl["verts"].numpy()[:, i] for i in range(3)))
        for key, g in (("wplanes", 128), ("wplanes32", 32)):
            got_p, want = tl[key].numpy(), np.asarray(tl_ref[key])
            for rows in (slice(0, 8), slice(12, 16)):
                np.testing.assert_allclose(got_p[:, rows], want[:, rows],
                                           rtol=0, atol=1e-5, err_msg=key)
            w_rows = got_p[:, 8:12, :g]
            np.testing.assert_allclose(
                w_rows, build_w[:, 2].reshape(-1, g, 4).transpose(0, 2, 1),
                rtol=1e-6, atol=1e-5, err_msg=key)
            np.testing.assert_array_equal(
                got_p[:, :12, :g],
                port_w.reshape(-1, g, 12).transpose(0, 2, 1))
    assert "cbounds" not in tl and "woop" not in tl
    # the kernels' tables are derived from the refit's, not the build's
    derived = pvi.device_tables(tl)
    for key in ("wplanes_tm", "wplanes32_tm"):
        assert torch.equal(tl[key], derived[key]), key
        assert not torch.equal(tl[key], port["treelets"][key]), key
    assert tl["n_cells"] == derived["n_cells"] == -(-n_tris // 128)
    assert tl["n_super"] == derived["n_super"]


@pytest.mark.parametrize("path", ["retransform", "host", "device"])
def test_tri_table_is_derived_again_after_refit(path):
    """The traversal kernel's triangle table follows the vertices through
    ``retransform_instances``, the host refit (through ``scene_to_torch``)
    and the device update: it is the table of the new vertices, not the
    build's, and row for row a fresh build's of the same geometry
    (within 1e-5 after the device update, whose transforms are torch's
    separate products; exactly after the host's numpy)."""
    cfg = RenderConfig()
    eye = np.eye(4, dtype=np.float32)
    built = scene_data.build_device_scene(
        _instances(scene_data, build_triangles, {}, eye), None, None, None,
        None, cfg)
    scene = scene_data.scene_to_torch(built, "cpu")
    inst = _instances(scene_data, build_triangles,
                      {"shift": 0.7, "bend": -0.25}, _move(3))
    perm = built["_perm_host"]
    if path == "retransform":
        out = scene_data.retransform_instances(scene, inst, perm)
        table = torch.from_numpy(out["tri_table"])
    elif path == "host":
        caps = {"bvh_nodes": built["bvh"]["child"].shape[0]}
        out = scene_data.scene_to_torch(scene_data.refit_deformed(
            scene, inst, perm, built["_bvh_host"], cfg, caps,
            pack_host=built["_pack_host"]), "cpu")
        table = out["tri_table"]
    else:
        out = _device_update(scene, inst)
        table = out["tri_table"]
    verts = torch.as_tensor(out["tri_vertices"])
    assert table.shape == (verts.shape[0], 3, 4)
    assert torch.equal(table, traverse.tri_table(traverse.tri_edges(verts)))
    assert not torch.equal(table, scene["tri_table"])
    fresh = scene_data.build_device_scene(inst, None, None, None, None, cfg)
    want = scene_data.scene_to_torch(fresh, "cpu")["tri_table"]
    rows = torch.from_numpy(np.argsort(fresh["_perm_host"])[perm])
    if path == "device":
        torch.testing.assert_close(table, want[rows], rtol=0, atol=1e-5)
    else:
        assert torch.equal(table, want[rows])


def _xf(t, scale=(1.0, 1.0, 1.0), angle=0.0):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                         np.float32) @ np.diag(np.float32(scale))
    m[:3, 3] = t
    return m


# the instances' transforms of each case; the last instance's alone
# differs: a mirror (det < 0), or a scale whose |det| <= 1e-12, so that
# the normal matrix is the rotation itself
_MOVES = {
    "moved": _xf([0.2, 0.4, -0.3], (0.8, 0.8, 0.8), 1.1),
    "mirrored": _xf([0.2, 0.4, -0.3], (-1.0, 0.7, 1.3), 0.4),
    "singular": _xf([0.2, 0.4, -0.3], (1e-5, 1e-5, 1e-3), 0.9),
}


def _slot_instances(last):
    """Two mesh slots (an icosphere, the wavy grid), three and two
    instances of them, their ids out of slot order."""
    v, f = synthetic.icosphere(1)
    sphere, wavy = build_triangles(v, f), _wavy(build_triangles, shift=0.3)
    rows = [(7, 0, sphere, _xf([0, 1, 0], (1.0, 2.0, 1.0), 0.3)),
            (2, 1, wavy, _xf([1.5, 0, 0], angle=-0.5)),
            (11, 0, sphere, _xf([-2, 0.5, 1], (0.5, 0.5, 0.5), 1.0)),
            (5, 1, wavy, _xf([0, 0, 3], angle=2.0)),
            (9, 0, sphere, last)]
    return [scene_data.InstancedMesh(triangles=tris, transform=xf,
                                     instance_id=iid, mesh_slot=slot)
            for iid, slot, tris, xf in rows]


@pytest.mark.parametrize("case", sorted(_MOVES))
def test_device_move_plain_version_matches_retransform_instances(case):
    """The device update's plain version (``move_tables``, then
    ``move_instances_device`` on CPU tensors, which runs
    ``retransform_ref``) writes every plane, the triangle table and the
    pack's geometric columns as the host's ``retransform_instances``
    does, within 1e-5 (the device update's bar: torch's separate products
    against numpy's einsums), and keeps the pack's other columns bit for
    bit; its map puts each triangle on its instance's object-space
    triangle."""
    cfg = RenderConfig()
    built = scene_data.build_device_scene(
        _slot_instances(np.eye(4, dtype=np.float32)), None, None, None,
        None, cfg)
    scene = scene_data.scene_to_torch(built, "cpu")
    inst = _slot_instances(_MOVES[case])
    perm = built["_perm_host"]
    tables = scene_data.move_tables(scene, inst, _slot_planes(inst, True))
    counts = np.array([im.triangles.vertices.shape[0] for im in inst])
    offsets = np.concatenate([[0], np.cumsum(counts)])
    row = np.searchsorted(offsets, perm, side="right") - 1
    assert np.array_equal(tables["row"].numpy(), row)
    src = tables["base"].numpy()[row] + built["tri_prim"]
    assert np.array_equal(tables["obj"]["vertices"].numpy()[src],
                          np.stack([inst[r].triangles.vertices[p]
                                    for r, p in zip(row,
                                                    built["tri_prim"])]))
    got = scene_data.move_instances_device(scene, tables, inst)
    want = scene_data.retransform_instances(scene, inst, perm)
    for k in scene_data.MOVE_PLANES:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], torch.from_numpy(want[k]),
                                   rtol=0, atol=1e-5, msg=k)
    assert torch.equal(got["tri_table"], traverse.tri_table(
        traverse.tri_edges(got["tri_vertices"])))
    fixed = [c for c in range(32)
             if c not in (*range(0, 9), *range(15, 24), 26)]
    assert torch.equal(got["tri_pack"][:, fixed], scene["tri_pack"][:, fixed])
    assert not torch.equal(got["tri_vertices"], scene["tri_vertices"])


def test_build_device_scene_cached_equals_uncached(tmp_path, monkeypatch):
    monkeypatch.delenv("RFW_NO_SCENE_CACHE")
    monkeypatch.setenv("RFW_SCENE_CACHE_DIR", str(tmp_path))
    cfg = RenderConfig(subcell_tables=True)
    inst = _instances(scene_data, build_triangles, {}, _move(2))
    want = scene_data.build_device_scene(inst, None, None, None, None, cfg)
    calls = _count_builds(monkeypatch)
    caps = [{}, {}]
    first = scene_data.build_device_scene_cached(inst, None, None, None,
                                                 None, cfg,
                                                 shape_caps=caps[0])
    second = scene_data.build_device_scene_cached(inst, None, None, None,
                                                  None, cfg,
                                                  shape_caps=caps[1])
    assert calls["n"] == 1, "the second build did not come from the cache"
    assert caps[0] == caps[1] and caps[1]
    assert len(list(tmp_path.glob("scene_*/manifest.json"))) == 1
    for got in (first, second):
        assert got.keys() == want.keys()
        for k in want:
            a, b = want[k], got[k]
            if isinstance(a, dict):
                assert a.keys() == b.keys(), k
                for kk in a:
                    if isinstance(a[kk], np.ndarray):
                        np.testing.assert_array_equal(a[kk], b[kk])
                    else:
                        assert a[kk] == b[kk], (k, kk)
            elif isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                assert a == b, k
    assert not second["tri_pack"].flags.writeable      # memory-mapped
    # a hit takes the device update as a build does
    t = scene_data.scene_to_torch(second, "cpu")
    moved = _instances(scene_data, build_triangles, {"shift": 0.3}, _move(2))
    out = _device_update(t, moved)
    assert torch.isfinite(out["tri_pack"]).all()


def test_scene_cache_is_keyed_by_build_sources(tmp_path, monkeypatch):
    """An entry written by other build sources is never read: the key
    holds a hash of the build's code, so an edited builder builds anew."""
    monkeypatch.delenv("RFW_NO_SCENE_CACHE")
    monkeypatch.setenv("RFW_SCENE_CACHE_DIR", str(tmp_path))
    cfg = RenderConfig()
    inst = _instances(scene_data, build_triangles, {},
                      np.eye(4, dtype=np.float32))
    src = scene_data._scene_build_hash()
    assert src == scene_data._scene_build_hash() and len(src) == 40
    key = scene_data._scene_cache_key(inst, cfg, None, None)
    calls = _count_builds(monkeypatch)
    scene_data.build_device_scene_cached(inst, None, None, None, None, cfg)
    monkeypatch.setattr(scene_data, "_scene_build_hash", lambda: "0" * 40)
    assert scene_data._scene_cache_key(inst, cfg, None, None) != key
    scene_data.build_device_scene_cached(inst, None, None, None, None, cfg)
    assert calls["n"] == 2, "an entry of other build sources was read"
    assert len(list(tmp_path.glob("scene_*/manifest.json"))) == 2


# ---------------------------------------------------------------------------
# config 4: a skinned glTF posed through the refit
# ---------------------------------------------------------------------------

def _config4(rs, path, sky, build_at, pose=None):
    """tests/golden_scenes.py::make_config4's scene with the in-repo
    skinned tube in place of CesiumMan, built at t = ``build_at`` and
    then, given ``pose``, posed there (through the refit)."""
    ref = rs.add_object(path)
    rs.add_instance(ref)
    floor = rs.add_material([0.5, 0.5, 0.55])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 10, 10, floor))
    rs.add_directional_light([0.4, -1.0, 0.3], [2.5, 2.4, 2.2])
    rs.set_skybox(sky.test_sky(128, 64))
    rs.camera.resize(64, 64)
    rs.camera.fov = 45.0
    c = np.concatenate([m.base_positions for m in ref.object.meshes]).mean(0)
    rs.camera.look_at(c + np.array([1.2, 0.6, 2.4]), c)
    rs.set_animations_to(build_at)
    rs.synchronize()                      # the full build
    if pose is not None:
        rs.set_animations_to(pose)
    return rs


def test_config4_refit_frame_matches_reference(tmp_path, monkeypatch):
    from rfw_tpu.config import RenderConfig as JRenderConfig
    from rfw_tpu.scene import Skybox as JSkybox
    from rfw_tpu.system import RenderSystem as JRenderSystem
    path = str(tmp_path / "tube.gltf")
    assert write_skinned_gltf(path, chip_smoke.SEED, around=16,
                              rings=12) == 384

    def port(build_at, pose=None):
        return _config4(RenderSystem("wavefront", RenderConfig(
            blue_noise=True, max_path_length=2, max_rays_per_pass=1024),
            device="cpu"), path, Skybox, build_at, pose)

    rs = port(0.0, 0.5)
    calls = _count_builds(monkeypatch)
    refit = rs.render_frame(samples=8)
    assert calls["n"] == 0 and rs.context._move_tables is not None
    assert rs.context._driver is not None          # 4 chunks: compacted
    fresh = port(0.5).render_frame(samples=8)
    assert calls["n"] == 1
    still = port(0.0).render_frame(samples=8)

    j_rs = JRenderSystem("wavefront", JRenderConfig(blue_noise=True,
                                                    max_path_length=2))
    j_rs.set_setting("intersector", "visit")
    j_frame = np.asarray(_config4(j_rs, path, JSkybox, 0.0, 0.5)
                         .render_frame(samples=8))
    assert j_rs.context._device_refit is not None

    assert refit.shape == (64, 64, 3) and np.isfinite(refit).all()
    assert _rmse(refit, j_frame) < 2e-3
    assert _rmse(refit, fresh) < 2e-3
    assert _rmse(j_frame, fresh) < 2e-3
    # the pose shows: the bind-pose frame lies well off the posed one
    assert _rmse(still, fresh) > 4 * max(_rmse(refit, fresh), 1e-4)
