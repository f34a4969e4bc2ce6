"""The port's two-level path (``rfw_tpu_torch/bvh/tlas.py``, the TLAS
tables of ``render/scene_data.py``, the ``tlas`` intersector and the
engines' instance-move update) against rfw_tpu and the flattened oracle.

On the CPU the port's traversal runs ``traverse_wide_ref``, the traversal
kernel's plain version. Tolerances, tests/test_visit.py's where not
stated: hit masks equal, prim agreement > 0.999, relative t < 1e-4 (the
object-space rays are fixed-order sums here and XLA's matrix products
there, so t differs in the last bits); the numpy builds exactly;
``tlas`` frames against ``bvh`` frames of one engine < 1e-4 max abs (the
same hits up to those bits, tests/test_tlas.py's bar), against rfw_tpu's
``tlas`` frames RMSE < 2e-3 (the goldens' bar).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rfw_tpu
from rfw_tpu.bvh import tlas as j_tlas
from rfw_tpu.config import RenderConfig as JConfig
from rfw_tpu.render import create_engine as j_create_engine
from rfw_tpu.render import intersectors as j_isect
from rfw_tpu.render import scene_data as j_sd
from rfw_tpu.scene import HostMaterial as JHostMaterial
from rfw_tpu.scene import MaterialList as JMaterialList
from rfw_tpu.scene import make_quad as j_make_quad
from rfw_tpu.scene.lights import pack_lights as j_pack_lights
from rfw_tpu.scene.mesh import build_triangles as j_build_triangles

import rfw_tpu_torch
from rfw_tpu_torch.bvh import tlas
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import traverse
from rfw_tpu_torch.render import RenderStatus, create_engine
from rfw_tpu_torch.render import intersectors, scene_data
from rfw_tpu_torch.scene import HostMaterial, MaterialList, make_quad
from rfw_tpu_torch.scene.lights import pack_lights
from rfw_tpu_torch.scene.mesh import build_triangles
from rfw_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _no_scene_cache(monkeypatch):
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


# -- tests/test_tlas.py's three-instance scene --------------------------------

def _mesh(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * scale
    return np.stack([
        v0, v0 + rng.uniform(-.3, .3, (n, 3)).astype(np.float32),
        v0 + rng.uniform(-.3, .3, (n, 3)).astype(np.float32)], 1)


def _xform(t, s=1.0, angle=0.0):
    c, sn = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]],
                         np.float32) * s
    m[:3, 3] = t
    return m


def _scene():
    meshes = [_mesh(200, 1), _mesh(150, 2, scale=0.5)]
    instances = [
        (0, _xform([0, 0, 0])),
        (0, _xform([3, 0.5, 0], s=0.7, angle=0.8)),   # shares mesh 0's BLAS
        (1, _xform([-3, 0, 1], s=1.5, angle=-0.4)),
    ]
    return meshes, instances


def _rays(n=2048, seed=7):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _flat_oracle(meshes, instances, o, d):
    """Brute force over the instances flattened to world space: (t,
    instance, mesh-local prim), -1 on a miss."""
    parts, inst_of, prim_of = [], [], []
    for idx, (mi, m) in enumerate(instances):
        parts.append((meshes[mi] @ m[:3, :3].T + m[:3, 3]).astype(np.float32))
        inst_of.append(np.full(len(meshes[mi]), idx, np.int32))
        prim_of.append(np.arange(len(meshes[mi]), dtype=np.int32))
    verts = torch.from_numpy(np.concatenate(parts))
    t, flat, _, _ = traverse.brute_force_closest(
        torch.from_numpy(o), torch.from_numpy(d), traverse.tri_edges(verts))
    t, flat = t.numpy(), flat.numpy()
    hit = flat >= 0
    inst = np.where(hit, np.concatenate(inst_of)[np.maximum(flat, 0)], -1)
    prim = np.where(hit, np.concatenate(prim_of)[np.maximum(flat, 0)], -1)
    return t, inst, prim


def _agree(t_a, id_a, t_b, id_b, hit_a, hit_b):
    """The test_visit bars: hit masks equal, ids agreeing on > 0.999 of
    the hits, relative t below 1e-4."""
    assert hit_a.sum() > 10
    assert np.array_equal(hit_a, hit_b)
    assert (id_a[hit_a] == id_b[hit_a]).mean() > 0.999
    rel = np.abs(t_a[hit_a] - t_b[hit_a]) / np.maximum(np.abs(t_b[hit_a]),
                                                       1e-6)
    assert rel.max() < 1e-4


def test_build_tlas_equals_rfw_tpu():
    meshes, instances = _scene()
    mine = tlas.build_tlas(meshes, instances)
    ref = j_tlas.build_tlas(meshes, instances)
    assert len(mine.blas_list) == len(ref.blas_list) == 2
    for a, b in zip(mine.blas_list, ref.blas_list):
        for k in ("bmin", "bmax", "child", "count"):
            assert np.array_equal(getattr(a.wide, k), getattr(b.wide, k)), k
        for k in ("v0", "e1", "e2", "prim_order", "bmin", "bmax"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ("inst_blas", "inst_inv", "inst_bmin", "inst_bmax"):
        assert np.array_equal(getattr(mine, k), getattr(ref, k)), k
    # the walk's tables: the kernel's node and triangle tables
    wb = mine.blas_list[0].tables("cpu")
    assert torch.equal(wb["nodes"].view(torch.int32),
                       traverse.node_table(wb).view(torch.int32))
    assert torch.equal(wb["tri_table"], traverse.tri_table(tuple(
        torch.from_numpy(x) for x in (mine.blas_list[0].v0,
                                      mine.blas_list[0].e1,
                                      mine.blas_list[0].e2))))
    assert torch.equal(wb["prim_order"], torch.from_numpy(
        ref.blas_list[0].prim_order.astype(np.int32)))
    assert mine.blas_list[0].tables("cpu") is wb          # made once


def test_trace_tlas_matches_rfw_tpu_and_oracle():
    meshes, instances = _scene()
    o, d = _rays()
    t, inst, prim, _, _ = (x.numpy() for x in tlas.trace_tlas(
        tlas.build_tlas(meshes, instances), torch.from_numpy(o),
        torch.from_numpy(d)))
    t_j, inst_j, prim_j, _, _ = (np.asarray(x) for x in j_tlas.trace_tlas(
        j_tlas.build_tlas(meshes, instances), jnp.asarray(o),
        jnp.asarray(d)))
    key = inst * 1000 + prim
    _agree(t, key, t_j, inst_j * 1000 + prim_j, inst >= 0, inst_j >= 0)
    t_o, inst_o, prim_o = _flat_oracle(meshes, instances, o, d)
    _agree(t, key, t_o, inst_o * 1000 + prim_o, inst >= 0, inst_o >= 0)


@pytest.mark.parametrize("ray_chunk", [64, 65536])
def test_walk_any_hit_agrees_with_closest(ray_chunk):
    """``trace_tlas`` and the ``tlas`` intersector run one walk: on a
    TLAS with an unused mesh, its closest hits are ``trace_tlas``'s (one
    premask chunk or many), and its any-hit walk occludes exactly the
    rays whose closest hit lies below their bound."""
    meshes, instances = _scene()
    tl = tlas.build_tlas(meshes + [_mesh(20, 6)], instances)
    tables, base = tl.tables("cpu")
    assert len(tables["blas"]) == 2
    o, d = (torch.from_numpy(x) for x in _rays(seed=13))
    t, orig, u, v = tlas.walk(tables, o, d, traverse.BIG_T, 1e-4,
                              ray_chunk=ray_chunk)
    want = tlas.trace_tlas(tl, o, d)
    hit = orig >= 0
    assert torch.equal(t, want[0]) and torch.equal(hit, want[1] >= 0)
    assert torch.equal(orig[hit], (base[want[1].long()] + want[2])[hit])
    assert torch.equal(u, want[3]) and torch.equal(v, want[4])
    dist = torch.where(torch.arange(o.shape[0]) % 2 == 0, t * 0.5,
                       t * 1.5)
    _, occ, _, _ = tlas.walk(tables, o, d, dist, 1e-4, any_hit=True,
                             ray_chunk=ray_chunk)
    assert torch.equal(occ >= 0, hit & (t < dist))
    assert (occ >= 0).any() and (hit & ~(occ >= 0)).any()


def test_refit_moves_an_instance_without_touching_the_blases():
    meshes, instances = _scene()
    tl = tlas.build_tlas(meshes, instances)
    blases = [(id(b), b.v0.copy(), b.wide.bmin.copy()) for b in tl.blas_list]
    moved = [m for _, m in instances]
    moved[1] = _xform([30, 0, 0])
    tl.refit(np.stack(moved))
    for b, (ident, v0, bmin) in zip(tl.blas_list, blases):
        assert id(b) == ident
        assert np.array_equal(b.v0, v0) and np.array_equal(b.wide.bmin, bmin)
    ref = j_tlas.build_tlas(meshes, list(zip([mi for mi, _ in instances],
                                             moved)))
    for k in ("inst_inv", "inst_bmin", "inst_bmax"):
        assert np.array_equal(getattr(tl, k), getattr(ref, k)), k
    o, d = _rays(seed=9)
    t, inst, prim, _, _ = (x.numpy() for x in tlas.trace_tlas(
        tl, torch.from_numpy(o), torch.from_numpy(d)))
    t_o, inst_o, prim_o = _flat_oracle(
        meshes, list(zip([mi for mi, _ in instances], moved)), o, d)
    _agree(t, inst * 1000 + prim, t_o, inst_o * 1000 + prim_o, inst >= 0,
           inst_o >= 0)


def test_culled_lane_equals_its_walk():
    """A lane the TLAS culls walks with t_max 0: its result is what a
    walk of it gives (``walk_dead``), so culling changes no hit."""
    meshes, instances = _scene()
    wb = tlas.build_tlas(meshes, instances).blas_list[0].tables("cpu")
    tris = wb["tri_table"]
    o, d = (torch.from_numpy(x) for x in _rays(seed=11))
    tm = torch.where(torch.arange(o.shape[0]) % 3 == 0, 0.0, 1e30)
    for any_hit in (False, True):
        culled = traverse.traverse_wide_ref(o, d, wb, tris, t_max=tm,
                                            any_hit=any_hit)
        walked = traverse.traverse_wide_ref(o, d, wb, tris, t_max=tm,
                                            any_hit=any_hit, walk_dead=True)
        assert all(torch.equal(a, b) for a, b in zip(culled, walked))
        assert (culled[1][1::3] >= 0).any()
        assert (culled[1][::3] == -1).all()


# -- the device scene's tables -------------------------------------------------

def _shared_instances(mod, build, shift=0.0):
    """Three meshes, five instances (mesh 0 three times, mesh 1 twice,
    one of them before mesh 2's), through a package's own
    ``build_triangles`` and ``InstancedMesh``."""
    meshes = [_mesh(60, 3), _mesh(40, 4, scale=0.6), _mesh(30, 5)]
    placed = [(0, _xform([0, 0, 0])), (1, _xform([2.5, 0, 0.5], s=1.3)),
              (0, _xform([-2.5, 0.3, 0], angle=0.7)),
              (2, _xform([0, 2.5, 1 + shift], s=0.8)),
              (0, _xform([0, -2.5, shift], s=0.5, angle=-1.1)),
              (1, _xform([-1, -1, 3]))]
    out = []
    for iid, (slot, m) in enumerate(placed):
        v = meshes[slot]
        tris = build(v.reshape(-1, 3), np.arange(v.shape[0] * 3).reshape(-1, 3))
        out.append(mod.InstancedMesh(triangles=tris, transform=m,
                                     instance_id=iid, mesh_slot=slot))
    return out


def test_tlas_tables_equal_rfw_tpu():
    p_inst = _shared_instances(scene_data, build_triangles)
    j_inst = _shared_instances(j_sd, j_build_triangles)
    perm = np.random.default_rng(0).permutation(
        sum(im.triangles.vertices.shape[0] for im in p_inst))
    mine = scene_data._build_tlas_tables(p_inst, perm)
    ref = j_sd._build_tlas_tables(j_inst, perm)
    assert np.array_equal(mine["orig_to_perm"], ref["orig_to_perm"])
    assert len(mine["blas"]) == len(ref["blas"]) == 3
    for a, b in zip(mine["blas"], ref["blas"]):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert [len(b["inst_base"]) for b in mine["blas"]] == [3, 2, 1]
    # an instance move refreshes the instance tables (``_moved_tlas``, the
    # device update's) as rfw_tpu's does
    moved = _shared_instances(scene_data, build_triangles, shift=0.75)
    j_moved = _shared_instances(j_sd, j_build_triangles, shift=0.75)
    got = scene_data._moved_tlas(
        scene_data.scene_to_torch({"tlas": mine}, "cpu"), moved)
    want = j_sd.retransform_instances({"tlas": ref}, j_moved, perm)
    for a, b in zip(got["blas"], want["tlas"]["blas"]):
        for k in ("inst_inv", "inst_bmin", "inst_bmax"):
            assert np.array_equal(a[k], np.asarray(b[k])), k


# -- the intersector -------------------------------------------------------------

def _grid_engine(pkg, cfg_mod, create, quad, mats, hmat, lights):
    """tests/test_tlas.py's many-instance scene (5x5 quads of one mesh)
    plus a second mesh twice, built with TLAS tables in a package's
    ``megakernel``."""
    cfg = cfg_mod(blue_noise=False, use_tlas=True)
    eng = create("megakernel", cfg, **pkg)
    ml = mats()
    ml.add(hmat(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(lights([], [], [], []))
    eng.set_mesh(0, quad([0, 0, -1], [0, 0, 0], 1.5, 1.5, 0).triangles())
    eng.set_mesh(1, quad([0, 1, 0], [0, 0, 0], 3.0, 3.0, 0).triangles())
    for i in range(25):
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = (i % 5 - 2) * 4.0
        m[1, 3] = (i // 5 - 2) * 4.0
        eng.set_instance(i, 0, m)
    for i, z in ((25, 2.0), (26, 6.0)):
        m = _xform([0.5, -1.0, z], angle=0.3)
        eng.set_instance(i, 1, m)
    eng.set_setting("intersector", "tlas")
    eng.resize(8, 8)
    eng.update()
    return eng, cfg


def _grid_rays(n=200):
    rng = np.random.default_rng(3)
    o = np.tile(np.array([[0.0, 0.0, -8.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_tlas_intersector_matches_rfw_tpu(monkeypatch):
    """Closest and occluded on a multi-chunk premask (64-ray chunks in
    both packages), against rfw_tpu's intersector on rfw_tpu's build of
    the same scene and against the port's ``bvh`` intersector."""
    eng, cfg = _grid_engine({"device": "cpu"}, RenderConfig, create_engine,
                            make_quad, MaterialList, HostMaterial,
                            pack_lights)
    j_eng, j_cfg = _grid_engine({}, JConfig, j_create_engine, j_make_quad,
                                JMaterialList, JHostMaterial, j_pack_lights)
    monkeypatch.setattr(intersectors, "_TLAS_RAY_CHUNK", 64)
    monkeypatch.setattr(j_isect, "_TLAS_RAY_CHUNK", 64)
    o, d = _grid_rays()
    dist = np.where(np.arange(len(o)) % 4 == 0, 0.0, 9.0).astype(np.float32)
    mine = intersectors.make_intersector("tlas", cfg)
    t, prim, _, _ = (x.numpy() for x in mine.closest(
        eng._scene, torch.from_numpy(o), torch.from_numpy(d)))
    occ = mine.occluded(eng._scene, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(dist)).numpy()
    ref = j_isect.FACTORIES["tlas"](j_cfg)
    t_j, prim_j, _, _ = (np.asarray(x) for x in ref.closest(
        j_eng._scene, jnp.asarray(o), jnp.asarray(d)))
    occ_j = np.asarray(ref.occluded(j_eng._scene, jnp.asarray(o),
                                    jnp.asarray(d), jnp.asarray(dist)))
    _agree(t, prim, t_j, prim_j, prim >= 0, prim_j >= 0)
    assert np.array_equal(occ, occ_j) and occ.any() and not occ.all()
    assert (t[prim < 0] == traverse.BIG_T).all()
    flat = intersectors.make_intersector("bvh", cfg)
    t_b, prim_b, _, _ = (x.numpy() for x in flat.closest(
        eng._scene, torch.from_numpy(o), torch.from_numpy(d)))
    _agree(t, prim, t_b, prim_b, prim >= 0, prim_b >= 0)


# -- engines -------------------------------------------------------------------

def _quad_scene(eng, mods, moved=None):
    """tests/test_tlas.py's engine scene: a floor, one block mesh twice
    (one rotated and scaled) and a lamp, through a package's modules."""
    quad, mats, hmat, lights = mods
    ml = mats()
    ml.add(hmat(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    ml.add(hmat(color=np.array([6.0, 5.0, 4.0])))
    eng.set_mesh(0, quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0).triangles())
    eng.set_mesh(2, quad([0, -1, 0], [0, 4, 0], 2, 2, 1).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, _xform([-2.0, 0.0, 0.5]) if moved is None
                     else moved)
    eng.set_instance(2, 1, _xform([2.0, 0.3, 0.0], s=0.8, angle=0.6))
    eng.set_instance(3, 2, np.eye(4, dtype=np.float32))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(lights([], [], [], []))


_P_MODS = (make_quad, MaterialList, HostMaterial, pack_lights)
_J_MODS = (j_make_quad, JMaterialList, JHostMaterial, j_pack_lights)
_FRAME_CFG = dict(blue_noise=False, max_path_length=1,
                  russian_roulette=False)


def _view(camera_cls, size=40):
    cam = camera_cls()
    cam.resize(size, size)
    cam.fov = 55
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    return cam.get_view().as_pytree()


def _port_engine(engine, intersector, moved=None, **cfg):
    eng = create_engine(engine, RenderConfig(**_FRAME_CFG, **cfg),
                        device="cpu")
    _quad_scene(eng, _P_MODS, moved)
    eng.set_setting("intersector", intersector)
    eng.resize(40, 40)
    return eng


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_tlas_frames_match_bvh_and_rfw_tpu(engine):
    # 400-ray chunks: the wavefront engine runs its compacted driver
    cfg = dict(max_rays_per_pass=400) if engine == "wavefront" else {}
    view = _view(rfw_tpu_torch.Camera)
    frames = {}
    for name in ("bvh", "tlas"):
        eng = _port_engine(engine, name, **cfg)
        frames[name] = eng.render_frame(view, RenderStatus.RESET, samples=4)
        assert (eng._driver is not None) == (engine == "wavefront")
    assert frames["tlas"].mean() > 1e-4 and np.isfinite(frames["tlas"]).all()
    assert np.abs(frames["tlas"] - frames["bvh"]).max() < 1e-4
    j_eng = j_create_engine(engine, JConfig(**_FRAME_CFG, use_tlas=True,
                                            **cfg))
    _quad_scene(j_eng, _J_MODS)
    j_eng.set_setting("intersector", "tlas")
    j_eng.resize(40, 40)
    ref = np.asarray(j_eng.render_frame(_view(rfw_tpu.Camera),
                                        RenderStatus.RESET, samples=4))
    assert _rmse(frames["tlas"], ref) < 2e-3


def test_switch_to_tlas_after_build_rebuilds(monkeypatch):
    eng = _port_engine("megakernel", "bvh")
    view = _view(rfw_tpu_torch.Camera)
    a = eng.render_frame(view, RenderStatus.RESET, samples=1)
    assert "tlas" not in eng._scene and not eng.config.use_tlas
    builds = _count_builds(monkeypatch)
    eng.set_setting("intersector", "tlas")
    b = eng.render_frame(view, RenderStatus.RESET, samples=1)
    assert builds["n"] == 1 and "tlas" in eng._scene
    assert np.abs(a - b).max() < 1e-4
    eng.validate()
    blas = dict(eng._scene["tlas"]["blas"][1])
    blas["child"] = torch.where(blas["count"] > 0, blas["child"] + 99,
                                blas["child"])
    eng._scene["tlas"] = {**eng._scene["tlas"], "blas": (
        eng._scene["tlas"]["blas"][0], blas,
        *eng._scene["tlas"]["blas"][2:])}
    with pytest.raises(ValueError, match="BLAS 1 leaf range"):
        eng.validate()


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


def test_instance_move_refreshes_instance_tables_only(monkeypatch):
    eng = _port_engine("megakernel", "tlas")
    view = _view(rfw_tpu_torch.Camera)
    eng.render_frame(view, RenderStatus.RESET, samples=2)
    blas_nodes = [b["nodes"] for b in eng._scene["tlas"]["blas"]]
    pack_host = eng._pack_host
    builds = _count_builds(monkeypatch)
    moves = _count_calls(monkeypatch, "move_instances_device")
    host = _count_calls(monkeypatch, "retransform_instances")
    target = _xform([1.5, 0.3, 0.0])
    eng.set_instance(1, 1, target)
    tracing.clear()
    with tracing.recording():
        eng.update()
    counters = tracing.snapshot().counters
    moved = eng.render_frame(view, RenderStatus.RESET, samples=2)
    assert builds["n"] == 0 and moves["n"] == 1 and host["n"] == 0
    assert counters["device_moves"] == counters["updates"] == 1
    assert eng._pack_host is pack_host          # the build's, kept
    assert all(a is b["nodes"] for a, b in zip(
        blas_nodes, eng._scene["tlas"]["blas"]))
    fresh = _port_engine("megakernel", "tlas", moved=target).render_frame(
        view, RenderStatus.RESET, samples=2)
    assert np.abs(moved - fresh).max() < 1e-4


def test_move_then_deformation_under_tlas_builds_in_full(monkeypatch):
    """A deformation after a device update builds in full, and renders as a
    fresh build of both changes."""
    eng = _port_engine("megakernel", "tlas")
    view = _view(rfw_tpu_torch.Camera)
    eng.render_frame(view, RenderStatus.RESET, samples=1)
    target = _xform([1.5, 0.3, 0.0])
    eng.set_instance(1, 1, target)
    eng.render_frame(view, RenderStatus.RESET, samples=1)
    builds = _count_builds(monkeypatch)
    moves = _count_calls(monkeypatch, "move_instances_device")
    bent = make_quad([0, 0, -1], [0, 1.2, 1.5], 2, 2.4, 0).triangles()
    eng.set_mesh(1, bent)
    tracing.clear()
    with tracing.recording():
        deformed = eng.render_frame(view, RenderStatus.RESET, samples=1)
    assert builds["n"] == 1 and moves["n"] == 0
    assert "device_moves" not in tracing.snapshot().counters
    assert eng._pack_host is not None
    fresh = _port_engine("megakernel", "tlas", moved=target)
    fresh.set_mesh(1, bent)
    want = fresh.render_frame(view, RenderStatus.RESET, samples=1)
    assert np.abs(deformed - want).max() < 1e-4


@pytest.mark.parametrize("engine,intersector,use_tlas", [
    ("megakernel", "bvh", False), ("wavefront", "visit", True)])
def test_move_under_bvh_takes_the_host_refit(monkeypatch, engine,
                                             intersector, use_tlas):
    """Under ``bvh`` a move is the host refit's: it goes through
    ``retransform_instances``, never the device update. In a scene with
    TLAS tables under another intersector than ``tlas`` (``visit`` here)
    a move builds in full: the host refit would leave the TLAS tables
    stale, and the device update re-cells only scenes without them."""
    eng = _port_engine(engine, intersector, use_tlas=use_tlas)
    view = _view(rfw_tpu_torch.Camera)
    eng.render_frame(view, RenderStatus.RESET, samples=1)
    assert ("tlas" in eng._scene) == use_tlas
    builds = _count_builds(monkeypatch)
    moves = _count_calls(monkeypatch, "move_instances_device")
    host = _count_calls(monkeypatch, "retransform_instances")
    target = _xform([1.5, 0.3, 0.0])
    eng.set_instance(1, 1, target)
    tracing.clear()
    with tracing.recording():
        moved = eng.render_frame(view, RenderStatus.RESET, samples=1)
    assert moves["n"] == 0
    assert (builds["n"], host["n"]) == ((1, 0) if use_tlas else (0, 1))
    assert "device_moves" not in tracing.snapshot().counters
    fresh = _port_engine(engine, intersector, moved=target,
                         use_tlas=use_tlas).render_frame(
        view, RenderStatus.RESET, samples=1)
    assert np.abs(moved - fresh).max() < 1e-4


def test_deformation_under_tlas_builds_in_full(monkeypatch):
    eng = _port_engine("megakernel", "tlas")
    view = _view(rfw_tpu_torch.Camera)
    eng.render_frame(view, RenderStatus.RESET, samples=1)
    builds = _count_builds(monkeypatch)
    bent = make_quad([0, 0, -1], [0, 1.2, 1.5], 2, 2.4, 0).triangles()
    eng.set_mesh(1, bent)         # the same topology, other vertices
    deformed = eng.render_frame(view, RenderStatus.RESET, samples=1)
    assert builds["n"] == 1
    fresh = _port_engine("megakernel", "tlas")
    fresh.set_mesh(1, bent)
    want = fresh.render_frame(view, RenderStatus.RESET, samples=1)
    assert np.abs(deformed - want).max() < 1e-4


def test_disk_cache_round_trips_the_tlas_tables(monkeypatch, tmp_path):
    monkeypatch.delenv("RFW_NO_SCENE_CACHE")
    monkeypatch.setenv("RFW_SCENE_CACHE_DIR", str(tmp_path))
    instances = _shared_instances(scene_data, build_triangles)
    mats = MaterialList().generate_device_materials()
    args = (instances, mats, pack_lights([], [], [], []), None, None,
            RenderConfig(use_tlas=True))
    built = scene_data.build_device_scene_cached(*args)
    builds = _count_builds(monkeypatch)
    loaded = scene_data.build_device_scene_cached(*args)
    assert builds["n"] == 0 and len(os.listdir(tmp_path)) == 1
    assert isinstance(loaded["tlas"]["blas"], tuple)
    for a, b in zip(built["tlas"]["blas"], loaded["tlas"]["blas"]):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert np.array_equal(built["tlas"]["orig_to_perm"],
                          loaded["tlas"]["orig_to_perm"])
    on_dev = scene_data.scene_to_torch(loaded, "cpu")["tlas"]["blas"][0]
    assert torch.equal(on_dev["nodes"].view(torch.int32),
                       traverse.node_table(on_dev).view(torch.int32))
