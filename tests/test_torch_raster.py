"""The port's raster preview engine (``rfw_tpu_torch/render/raster.py``)
on the CPU against rfw_tpu's.

* ``_eval_lights`` equals rfw_tpu's on seeded inputs of all four light
  types, a spot light with ``cos_inner == cos_outer`` among them (rtol
  1e-5, atol 1e-6).
* The ``raster`` frame lies within RMSE 2e-3 of rfw_tpu's, with at least
  99.9 % of the pixels within 1e-4, on the Cornell scene and on a scene
  lit by point, spot and directional lights under the test sky, through
  ``bvh`` and ``visit``; the probe is rfw_tpu's.
* Every path gives the 1-spp frame: async CONVERGE and ``samples=2``
  equal the sync frame. Through rfw_tpu's async path the same frames
  come out at half the brightness, the reference's fault the port
  repairs.
* A frame of more lanes than ``max_rays_per_pass`` runs in equal chunks
  of at most that many lanes and equals the one-chunk frame bit for bit,
  the probe too.
* Where its kernel cannot launch, the raster step raises; it does not
  fall back to the plain version.
"""

import numpy as np
import pytest
import torch

from chip_smoke import make_cornell
from rfw_tpu.config import RenderConfig as JConfig
from rfw_tpu.render import RenderStatus as JStatus
from rfw_tpu.render import raster as j_raster
from rfw_tpu.scene import Skybox as JSkybox
from rfw_tpu.system import RenderSystem as JSystem
from test_integrator import make_cornell as j_cornell

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.render import RenderStatus, create_engine, raster
from rfw_tpu_torch.scene import Skybox
from rfw_tpu_torch.system import RenderSystem

SEED = 20261017


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _lights(rng):
    """Three lights of each type; spot light 2 has cos_inner ==
    cos_outer, and the third area light faces away."""
    f32 = np.float32
    lights = {
        "area_position": rng.uniform(-3, 3, (3, 3)).astype(f32),
        "area_normal": _unit(rng, 3),
        "area_area": rng.uniform(0.1, 2.0, 3).astype(f32),
        "area_radiance": rng.uniform(0, 20, (3, 3)).astype(f32),
        "point_position": rng.uniform(-3, 3, (3, 3)).astype(f32),
        "point_radiance": rng.uniform(0, 20, (3, 3)).astype(f32),
        "spot_position": rng.uniform(-3, 3, (3, 3)).astype(f32),
        "spot_direction": _unit(rng, 3),
        "spot_radiance": rng.uniform(0, 20, (3, 3)).astype(f32),
        "spot_cos_inner": np.array([0.95, 0.9, 0.8], f32),
        "spot_cos_outer": np.array([0.7, 0.5, 0.8], f32),
        "dir_direction": _unit(rng, 3),
        "dir_radiance": rng.uniform(0, 5, (3, 3)).astype(f32),
    }
    lights["area_normal"][2] = -lights["area_normal"][2]
    return lights


def test_eval_lights_matches_rfw_tpu():
    import jax.numpy as jnp
    rng = np.random.default_rng(SEED)
    lights = _lights(rng)
    n = 513
    p = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    nrm = _unit(rng, n)
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ref = np.asarray(j_raster._eval_lights(
        {k: jnp.asarray(v) for k, v in lights.items()}, jnp.asarray(p),
        jnp.asarray(nrm), jnp.asarray(albedo)))
    out = raster._eval_lights(
        {k: torch.from_numpy(v) for k, v in lights.items()},
        torch.from_numpy(p), torch.from_numpy(nrm),
        torch.from_numpy(albedo)).numpy()
    assert np.isfinite(out).all() and (out > 0).mean() > 0.5
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def make_lit(rs, skybox_cls):
    """A floor and a wall lit by a point, a spot and a directional light
    (no emissive surface), under the test sky; 64x48."""
    floor = rs.add_material([0.7, 0.6, 0.5])
    wall = rs.add_material([0.2, 0.5, 0.8])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 8, 8, floor))
    rs.add_instance(rs.add_quad([0, 0, -1], [0, 1.5, 2.0], 3, 3, wall))
    rs.add_point_light([1.5, 3.0, -1.0], [20.0, 18.0, 15.0])
    rs.add_spot_light([-1.5, 4.0, 0.0], 0.9, [40.0, 40.0, 60.0], 0.7,
                      [0.3, -1.0, 0.2])
    rs.add_directional_light([0.4, -1.0, 0.6], [0.8, 0.7, 0.6])
    rs.set_skybox(skybox_cls.test_sky(128, 64))
    rs.camera.resize(64, 48)
    rs.camera.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    return rs


def _pair(scene, intersector):
    """The port's and rfw_tpu's raster systems on one scene."""
    if scene == "cornell":
        port = make_cornell(RenderSystem("raster", RenderConfig(),
                                         device="cpu"), 64)
        ref = j_cornell("raster", JConfig(), size=64)
    else:
        port = make_lit(RenderSystem("raster", RenderConfig(), device="cpu"),
                        Skybox)
        ref = make_lit(JSystem("raster", JConfig()), JSkybox)
    for rs in (port, ref):
        rs.set_setting("intersector", intersector)
        rs.set_probe_index((30, 20))
    return port, ref


@pytest.mark.parametrize("intersector", ["bvh", "visit"])
@pytest.mark.parametrize("scene", ["cornell", "lit"])
def test_raster_frame_matches_rfw_tpu(scene, intersector):
    port, ref = _pair(scene, intersector)
    img = port.render_frame()
    want = np.asarray(ref.render_frame())
    assert img.shape == want.shape and np.isfinite(img).all()
    assert img.mean() > 0.01
    diff = np.abs(img - want)
    assert float(np.sqrt((diff ** 2).mean())) < 2e-3
    assert (diff.max(axis=-1) <= 1e-4).mean() >= 0.999
    got, exp = port.get_probe_results(), ref.get_probe_results()
    assert got[:2] == exp[:2] and got[0] >= 0
    assert got[2] == pytest.approx(exp[2], rel=1e-6)
    assert port.get_render_stats().primary_count == img.shape[0] * img.shape[1]


def _ratios(rs, status_cls):
    """Mean brightness of async CONVERGE and async samples=2 frames over
    the sync RESET frame's."""
    base = np.asarray(rs.render_frame(status=status_cls.RESET))
    out = []
    for status, samples in ((status_cls.CONVERGE, 1),
                            (status_cls.RESET, 2)):
        rs.render_frame_async(status=status, samples=samples)
        out.append(np.asarray(rs.finish_frame()))
    return base, out


def test_raster_async_frames_are_the_1spp_frame():
    port, ref = _pair("lit", "bvh")
    base, frames = _ratios(port, RenderStatus)
    for f in frames:
        assert np.array_equal(f, base)
    assert np.array_equal(port.render_frame(status=RenderStatus.CONVERGE,
                                            samples=3), base)
    # rfw_tpu's async path divides the overwritten radiance by the count
    base_j, frames_j = _ratios(ref, JStatus)
    for f in frames_j:
        assert f.mean() / base_j.mean() == pytest.approx(0.5, rel=1e-4)


def test_raster_engine_surface():
    eng = create_engine("raster", device="cpu")
    assert eng.get_available_settings()[0].value == "bvh"
    # no aux planes: the denoise setting leaves the frame as it is
    rs = make_lit(RenderSystem("raster", RenderConfig(), device="cpu"),
                  Skybox)
    raw = rs.render_frame()
    rs.set_setting("denoise", "1")
    assert np.array_equal(rs.render_frame(), raw)
    tiled = make_lit(RenderSystem("raster", RenderConfig(n_devices=2),
                                  device="cpu"), Skybox)
    with pytest.raises(ValueError, match="one device"):
        tiled.render_frame()


def test_raster_runs_in_chunks_of_max_rays_per_pass(monkeypatch):
    from rfw_tpu_torch.render.integrator import Intersector
    lanes = []
    make = raster.make_intersector

    def counting(name, cfg):
        inter = make(name, cfg)

        def closest(scene, o, d, *a, **kw):
            lanes.append(o.shape[0])
            return inter.closest(scene, o, d, *a, **kw)

        return Intersector(closest, inter.occluded)

    monkeypatch.setattr(raster, "make_intersector", counting)
    frames, probes, calls = [], [], []
    for max_rays in (1 << 19, 1024):
        rs = make_lit(RenderSystem("raster", RenderConfig(
            max_rays_per_pass=max_rays), device="cpu"), Skybox)
        rs.set_probe_index((40, 30))
        lanes.clear()
        frames.append(rs.render_frame())
        calls.append(list(lanes))
        probes.append(rs.get_probe_results())
    # 64x48: one chunk of 3,072 lanes, then three of 1,024
    assert calls == [[64 * 48], [1024] * 3]
    assert np.array_equal(frames[0], frames[1]) and frames[0].mean() > 0.01
    assert probes[0] == probes[1] and probes[0][1] >= 0


def test_raster_raises_when_its_kernel_cannot_launch(monkeypatch):
    """On a device whose kernel cannot launch the raster step raises; it
    never falls back to the plain version (here the "CUDA" tensors are
    CPU tensors and the kernel library fails to build)."""
    from rfw_tpu_torch.ops import cuda_lib
    rs = make_lit(RenderSystem("raster", RenderConfig(), device="cpu"),
                  Skybox)
    rs.synchronize()

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "kernel_device", lambda t, family: True)
    monkeypatch.setattr(cuda_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rs.render_frame()
