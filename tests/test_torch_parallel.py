"""The port's tiles (``rfw_tpu_torch/parallel/``, ``RenderConfig.n_devices``)
on the CPU: the counterparts of tests/test_parallel.py, each held to the
port's single-device frame (max abs difference < 1e-5) and to rfw_tpu's
tiled frame on the 8 virtual XLA host devices of tests/conftest.py (RMSE
< 2e-3, the engines' bar). A CPU mesh is ``n`` copies of the CPU device,
so the tiles run one after another on one device, through the same code
as tiles on several cards.

Also: the single-device fused frame's chunks through the same tile
loop, the chunk count, the compacted driver over a tile's row block
against the whole-frame driver, ``make_tile_mesh``'s round-robin
placement with a patched card count, a scene replica dropped after an
instance move, and tiles that raise where a kernel cannot launch.
"""

import importlib

import numpy as np
import pytest
import torch

import rfw_tpu
import rfw_tpu.parallel as j_parallel
from rfw_tpu.config import RenderConfig as JConfig
from rfw_tpu.render.intersectors import FACTORIES as J_FACTORIES

import rfw_tpu_torch
import rfw_tpu_torch.parallel.tiles as tiles_mod
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.parallel import (make_tile_mesh, make_tiled_renderer,
                                    render_tiled, replicate, row_block)
from rfw_tpu_torch.render import RenderStatus, create_engine
from rfw_tpu_torch.render.integrator import trace_sample
from rfw_tpu_torch.render.intersectors import FACTORIES
from rfw_tpu_torch.render.wavefront_driver import WavefrontDriver
from rfw_tpu_torch.system import RenderSystem


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rmse(a, b):
    return float(np.sqrt(((np.asarray(a) - np.asarray(b)) ** 2).mean()))


def _tiny(pkg, width, height, config):
    """__graft_entry__._tiny_scene's engine (a textured floor, a red quad,
    an area lamp, a point light, the test sky) built in ``pkg``, with its
    camera."""
    scene = importlib.import_module(f"{pkg}.scene")
    lights = importlib.import_module(f"{pkg}.scene.lights")
    render = importlib.import_module(f"{pkg}.render")
    ml = scene.MaterialList()
    checker = np.indices((16, 16)).sum(0) % 2
    tid = ml.add_texture(scene.Texture.from_array(
        np.stack([checker * 0.8 + 0.1] * 3 + [np.ones((16, 16))],
                 -1).astype(np.float32)))
    floor_mat = scene.HostMaterial(name="floor", roughness=0.8)
    floor_mat.maps[0].texture_id = tid
    floor = ml.add(floor_mat)
    red = ml.add(scene.HostMaterial(color=np.array([0.7, 0.1, 0.1]),
                                    roughness=0.4))
    lamp = ml.add(scene.HostMaterial(color=np.array([25.0, 25.0, 25.0])))
    quads = [scene.make_quad([0, 1, 0], [0, 0, 0], 8, 8, floor),
             scene.make_quad([0, 0, -1], [0, 1.0, 2.0], 2, 2, red),
             scene.make_quad([0, -1, 0], [0, 4.0, 0], 1.5, 1.5, lamp)]
    kw = {"device": "cpu"} if pkg == "rfw_tpu_torch" else {}
    engine = render.create_engine("megakernel", config, **kw)
    for slot, q in enumerate(quads):
        engine.set_mesh(slot, q.triangles())
        engine.set_instance(slot, slot, np.eye(4, dtype=np.float32))
    lamp_tris = quads[-1].triangles()
    area, overrides = [], {}
    for i in range(lamp_tris.count):
        v = lamp_tris.vertices[i]
        area.append(lights.AreaLight(
            vertex0=v[0], vertex1=v[1], vertex2=v[2],
            normal=lamp_tris.gnormal[i],
            radiance=np.array([25.0, 25.0, 25.0], np.float32),
            area=float(lamp_tris.area[i]), tri_idx=i, inst_idx=2))
        overrides[(2, i)] = i
    engine.set_materials(ml.generate_device_materials())
    engine.set_textures(scene.build_texture_atlas(ml.textures))
    engine.set_lights(lights.pack_lights(area, [lights.PointLight(
        np.array([2.0, 3.0, -1.0], np.float32),
        np.array([8.0, 7.0, 6.0], np.float32))], [], []),
        overrides=overrides)
    engine.set_sky(scene.Skybox.test_sky(64, 32).pixels)
    engine.resize(width, height)
    engine.update()
    cam = importlib.import_module(pkg).Camera()
    cam.resize(width, height)
    cam.look_at([0.0, 2.5, -5.0], [0.0, 1.0, 0.0])
    return engine._scene, cam.get_view().as_pytree()


def _port_scene(width, height, config):
    scene, view = _tiny("rfw_tpu_torch", width, height, config)
    return scene, {k: torch.as_tensor(np.asarray(v, np.float32))
                   for k, v in view.items()}


@pytest.mark.parametrize("width,height,n_tiles,samples",
                         [(32, 32, 8, 1), (32, 16, 4, 3)])
def test_render_tiled_matches_single_device(width, height, n_tiles, samples):
    config = RenderConfig()
    scene, view = _port_scene(width, height, config)
    intersector = FACTORIES["bvh"](config)
    acc = 0.0
    for s in range(samples):
        radiance, _, _, _ = trace_sample(scene, view, width, height, s, 0,
                                         config, intersector)
        acc = acc + radiance
    single = (acc / float(samples)).numpy()
    mesh = make_tile_mesh(n_tiles, "cpu")
    # one gathered step adds the last sample to the tiles' rows
    n_local = row_block(width * height, n_tiles)
    rows = tuple(torch.ones((n_local, 3)) for _ in mesh)
    gathered, _ = make_tiled_renderer(mesh, width, height, config,
                                      intersector)(scene, rows, view,
                                                   samples - 1)
    assert float((gathered - 1.0 - radiance).abs().max()) < 1e-5
    frame, stats = render_tiled(scene, view, width, height, config,
                                intersector, samples=samples, mesh=mesh)
    tiled = frame.numpy().reshape(-1, 3)
    assert frame.shape == (height, width, 3)
    assert np.isfinite(tiled).all() and tiled.mean() > 0
    assert np.abs(single - tiled).max() < 1e-5
    assert int(stats["ray_count_0"]) == width * height     # the psum

    j_scene, j_view = _tiny("rfw_tpu", width, height, JConfig())
    j_frame, _ = j_parallel.render_tiled(
        j_scene, j_view, width, height, JConfig(), J_FACTORIES["bvh"](
            JConfig()), samples=samples,
        mesh=j_parallel.make_tile_mesh(n_tiles))
    assert _rmse(frame.numpy(), j_frame) < 2e-3


def _build_engine_scene(eng, pkg):
    """tests/test_parallel.py's engine scene: a quad under a point light."""
    scene = importlib.import_module(f"{pkg}.scene")
    lights = importlib.import_module(f"{pkg}.scene.lights")
    ml = scene.MaterialList()
    ml.add(scene.HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(lights.pack_lights(
        [], [lights.PointLight(position=np.array([1.0, 4.0, -1.0], np.float32),
                               radiance=np.array([30.0, 30.0, 30.0],
                                                 np.float32))], [], []))
    eng.set_mesh(0, scene.make_quad([0, 1, 0], [0, 0, 0], 8, 8,
                                    0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))


def _render_engine(pkg, name, cfg, size, intersector=None, samples=2):
    if pkg == "rfw_tpu_torch":
        eng = create_engine(name, cfg, device="cpu")
        camera, reset = rfw_tpu_torch.Camera(), RenderStatus.RESET
    else:
        from rfw_tpu.render import RenderStatus as JStatus
        from rfw_tpu.render import create_engine as j_create_engine
        eng = j_create_engine(name, cfg)
        camera, reset = rfw_tpu.Camera(), JStatus.RESET
    _build_engine_scene(eng, pkg)
    if intersector:
        eng.set_setting("intersector", intersector)
    camera.resize(*size)
    camera.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    eng.resize(*size)
    eng.set_probe_index((20, 10))
    img = np.asarray(eng.render_frame(camera.get_view().as_pytree(), reset,
                                      samples=samples))
    return img, eng


@pytest.mark.parametrize("intersector,size,samples", [
    (None, (64, 48), 2),
    # per-tile streams of >= 8 visit blocks, as
    # test_n_devices_large_shard_bitwise
    ("visit", (160, 104), 1)])
def test_n_devices_through_engine_abi(intersector, size, samples):
    kw = dict(blue_noise=False, max_path_length=1)
    img1, e1 = _render_engine("rfw_tpu_torch", "megakernel",
                              RenderConfig(**kw), size, intersector, samples)
    img8, e8 = _render_engine("rfw_tpu_torch", "megakernel",
                              RenderConfig(**kw, n_devices=8), size,
                              intersector, samples)
    assert np.abs(img1 - img8).max() < 1e-5 and img8.mean() > 0.01
    assert e8.stats.primary_count == size[0] * size[1]
    assert e8.stats.shadow_count > 0
    assert e1.get_probe_results() == e8.get_probe_results()
    assert e8._driver is None
    j8, _ = _render_engine("rfw_tpu", "megakernel",
                           JConfig(**kw, n_devices=8), size, intersector,
                           samples)
    assert _rmse(img8, j8) < 2e-3


@pytest.mark.parametrize("n_total,max_lanes,height,want", [
    (1920 * 1080, 1 << 19, 1080, 4),     # 1080p: four row blocks
    (64 * 48, 256, 48, 12),
    (100 * 7, 64, 7, 14),                # no count divides 7 rows
    (518400, 1 << 19, None, 1),
    (10, 3, None, 5)])
def test_chunk_count(n_total, max_lanes, height, want):
    n = tiles_mod.chunk_count(n_total, max_lanes, height)
    assert n == want
    assert n_total % n == 0 and n_total // n <= max_lanes


def test_fused_chunks_run_the_tile_loop(monkeypatch):
    """A single-device fused frame of several chunks runs the tiles' one
    loop over a mesh of one copy of the engine's device a chunk, and
    equals the one-chunk frame bit for bit, the probe too."""
    meshes = []
    orig = tiles_mod.make_step
    monkeypatch.setattr(tiles_mod, "make_step",
                        lambda mesh, *a, **k: meshes.append(mesh)
                        or orig(mesh, *a, **k))

    def cfg(max_rays):
        return RenderConfig(blue_noise=False, max_path_length=2,
                            max_rays_per_pass=max_rays)

    img3, e3 = _render_engine("rfw_tpu_torch", "megakernel", cfg(1024),
                              (64, 48))
    img1, e1 = _render_engine("rfw_tpu_torch", "megakernel", cfg(1 << 19),
                              (64, 48))
    cpu = torch.device("cpu")
    assert meshes == [(cpu,) * 3, (cpu,)]
    assert np.array_equal(img3, img1) and img1.mean() > 0.01
    assert e3.stats.primary_count == 64 * 48
    assert e3.get_probe_results() == e1.get_probe_results()


def test_n_devices_driver_route(monkeypatch):
    """A compacting engine under n_devices > 1 runs one compacted driver
    a tile, here with 3 chunks a tile (768 lanes, max_rays_per_pass
    256)."""
    calls = []
    orig = tiles_mod.make_driver_engine_step
    monkeypatch.setattr(tiles_mod, "make_driver_engine_step",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    drivers = []
    orig_init = WavefrontDriver.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        drivers.append((self.n, self.chunk, self.pixel_offset))

    monkeypatch.setattr(WavefrontDriver, "__init__", init)

    def cfg(mod, n_dev):
        return mod(blue_noise=False, max_path_length=2, n_devices=n_dev,
                   max_rays_per_pass=256)

    img4, e4 = _render_engine("rfw_tpu_torch", "wavefront",
                              cfg(RenderConfig, 4), (64, 48), "bvh")
    assert calls, "n_devices did not route through the driver step"
    assert drivers == [(768, 256, i * 768) for i in range(4)]
    img1, e1 = _render_engine("rfw_tpu_torch", "wavefront",
                              cfg(RenderConfig, 0), (64, 48), "bvh")
    assert e1._driver is not None and e4._driver is None
    assert np.abs(img1 - img4).max() < 1e-5 and img4.mean() > 0.01
    assert e4.stats.primary_count == 64 * 48
    assert e4.stats.shadow_count > 0
    assert e1.get_probe_results() == e4.get_probe_results()
    j4, _ = _render_engine("rfw_tpu", "wavefront", cfg(JConfig, 4),
                           (64, 48), "bvh")
    assert _rmse(img4, j4) < 2e-3


def test_driver_pixel_range():
    """The driver's defaults are the whole frame from pixel 0: the same
    pixel ids and frame as an explicit range, within 1e-5 of the fused
    trace_sample; two tile drivers' rows make the same frame."""
    w, h = 48, 32
    config = RenderConfig(max_path_length=2)
    scene, view = _port_scene(w, h, config)
    inter = FACTORIES["bvh"](config)
    zeros = torch.zeros((w * h, 3))
    whole = WavefrontDriver(w, h, config, inter, None, 512, "cpu")
    explicit = WavefrontDriver(w, h, config, inter, None, 512, "cpu",
                               n_pixels=w * h, pixel_offset=0)
    assert torch.equal(whole._pid, explicit._pid)
    a = whole.step(scene, zeros, view, 0, 100)
    b = explicit.step(scene, zeros, view, 0, 100)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    fused, probe, _, _ = trace_sample(scene, view, w, h, 0, 100, config,
                                      inter)
    assert float((a[0] - fused).abs().max()) < 1e-5
    assert torch.equal(a[1], probe)
    half = w * h // 2
    rows = [WavefrontDriver(w, h, config, inter, None, 256, "cpu",
                            n_pixels=half, pixel_offset=i * half).step(
        scene, zeros[:half], view, 0, 0)[0] for i in range(2)]
    assert float((torch.cat(rows) - a[0]).abs().max()) < 1e-5


def test_make_tile_mesh(monkeypatch, capsys):
    assert make_tile_mesh(8, "cpu") == (torch.device("cpu"),) * 8
    assert make_tile_mesh(None, "cpu") == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_tile_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card{i}")
    capsys.readouterr()
    assert make_tile_mesh() == (torch.device("cuda", 0),
                                torch.device("cuda", 1))
    assert make_tile_mesh(2) == make_tile_mesh()
    assert capsys.readouterr().err == ""
    mesh = make_tile_mesh(5)
    assert [d.index for d in mesh] == [0, 1, 0, 1, 0]
    assert all(d.type == "cuda" for d in mesh)
    err = capsys.readouterr().err
    assert err.count("WARNING") == 1
    assert "cuda:0 (card0)" in err and "cuda:1 (card1)" in err
    with pytest.raises(ValueError, match="must divide by 7 tiles"):
        row_block(64 * 48, 7)
    assert row_block(64 * 48, 8) == 384


def test_indivisible_tiles_raise():
    rs = RenderSystem("megakernel", RenderConfig(n_devices=7), device="cpu")
    m = rs.add_material([0.7, 0.6, 0.5])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 6, 6, m))
    rs.camera.resize(64, 48)
    with pytest.raises(ValueError, match="must divide by 7 tiles"):
        rs.render_frame()


def test_replicate_cache():
    scene = {"a": torch.ones(3), "b": [torch.zeros(2), (torch.ones(1),)],
             "n": None}
    cache = {}
    rep = replicate(scene, "cpu", cache)
    assert rep is not scene and rep["a"] is scene["a"]      # no copy
    assert rep["b"][1][0] is scene["b"][1][0] and rep["n"] is None
    assert replicate(scene, "cpu", cache) is rep
    other = dict(scene)
    assert replicate(other, "cpu", cache) is not rep


def _moved_system(n_devices):
    rs = RenderSystem("wavefront", RenderConfig(n_devices=n_devices,
                                                max_rays_per_pass=512),
                      device="cpu")
    m = rs.add_material([0.7, 0.6, 0.5])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 6, 6, m))
    box = rs.add_instance(rs.add_quad([0, 0, -1], [0, 1.0, 1.0], 1.5, 1.5,
                                      m))
    lamp = rs.add_material([20.0, 20.0, 20.0])
    rs.add_instance(rs.add_quad([0, -1, 0], [0, 4.0, 0], 1, 1, lamp))
    rs.camera.resize(32, 32)
    rs.camera.look_at([0, 2.0, -5.0], [0, 0.5, 0])
    return rs, box


def test_replica_dropped_after_instance_move():
    rs, box = _moved_system(4)
    ctx = rs.context
    rs.render_frame(samples=1)
    scene0 = ctx._scene
    assert [ent[0] for ent in ctx._replicas.values()] == [scene0]
    box.translate([1.0, 0.5, 0.0])
    rs.synchronize()
    assert ctx._replicas == {}                  # dropped by the update
    moved = rs.render_frame(samples=2)
    assert ctx._scene is not scene0
    assert [ent[0] for ent in ctx._replicas.values()] == [ctx._scene]
    ref, ref_box = _moved_system(0)
    ref_box.translate([1.0, 0.5, 0.0])
    want = ref.render_frame(samples=2)
    assert np.abs(moved - want).max() < 1e-5
    assert moved.mean() > 0.01


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_tiles_raise_when_a_kernel_cannot_launch(monkeypatch, engine):
    """On a device whose kernels cannot launch the tiles raise; they never
    fall back to the plain versions (here the "CUDA" tensors are CPU
    tensors and the kernel library fails to build)."""
    from rfw_tpu_torch.ops import cuda_lib
    rs, _ = _moved_system(2)
    rs.set_context(engine)
    rs.synchronize()

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "kernel_device", lambda t, family: True)
    monkeypatch.setattr(cuda_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rs.render_frame()
