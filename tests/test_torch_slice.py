"""The port's main path as a whole: RenderSystem("wavefront") on config 2
(Cornell walls, mirror panel, area lamp and point light, 3 bounces).

* The compacted driver with the plain kernels lands on the reference's
  golden frame, to the golden matrix's bar (RMSE < 2e-3: fp16 storage
  plus a few paths that a last-bit difference sends another way).
* It agrees with rfw_tpu's own wavefront engine on the visit intersector
  to the same bar, at the golden's 64² and 8 spp. At 32² and 2 spp the
  reference disagrees with itself too much for that bar: its fused
  program and its per-depth stages (which the port matches there) part
  on one lamp-grazing shadow ray, whose 1/2-weighted sample alone puts
  the RMSE at 2.7e-3.
* Config 3 (microfacet BSDF, a checker-textured floor through the
  merged material atlas and its stochastic fetch, envmap importance
  sampling at every depth) lands on its golden and on rfw_tpu's own
  wavefront frame to the same bar.
* Inside the port, the compacted frame equals the fused one, a
  multi-sample step equals the looped single-sample step, and a frame
  whose last sample runs the per-depth profiled step equals the
  unprofiled frame.
"""

import os

import numpy as np
import torch

import golden_scenes
from chip_smoke import config3, make_config2, make_config3
from rfw_tpu_torch import Camera
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.render import RenderStatus, create_engine
from rfw_tpu_torch.scene import HostMaterial, MaterialList, make_quad
from rfw_tpu_torch.scene.lights import PointLight, pack_lights
from rfw_tpu_torch.system import RenderSystem

GOLDEN = os.path.join(golden_scenes.GOLDEN_DIR, "config2_64_8spp.npy")
GOLDEN3 = os.path.join(golden_scenes.GOLDEN_DIR, "config3_64_8spp.npy")


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def _port_frame():
    cfg = RenderConfig(blue_noise=True, max_path_length=3,
                       max_rays_per_pass=1024)
    rs = make_config2(RenderSystem("wavefront", cfg, device="cpu"))
    img = rs.render_frame(samples=8)
    assert rs.context._driver is not None    # 4 chunks: compacted driver
    return img, rs


def test_config2_golden_and_reference():
    img, rs = _port_frame()
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    golden = np.load(GOLDEN).astype(np.float32)
    assert _rmse(img, golden) < 2e-3
    st = rs.get_render_stats()
    assert st.primary_count == 64 * 64 and st.shadow_count > 0

    ref = golden_scenes.make_config2(engine="wavefront")
    ref.set_setting("intersector", "visit")
    ref_img = np.asarray(ref.render_frame(samples=8))
    assert _rmse(img, ref_img) < 2e-3


def _scene(eng):
    """tests/test_wavefront_driver.py's two-quad scene."""
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    ml.add(HostMaterial(color=np.array([0.3, 0.4, 0.8]), roughness=0.2))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights(
        [], [PointLight(position=np.array([1.0, 4.0, -1.0], np.float32),
                        radiance=np.array([30.0, 30.0, 30.0], np.float32))],
        [], []))
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 1).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, np.eye(4, dtype=np.float32))


def _view():
    cam = Camera()
    cam.resize(64, 48)
    cam.fov = 55
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    return cam.get_view().as_pytree()


def test_compacted_equals_fused():
    """Pixel-keyed RNG makes lane compaction invisible in the frame."""
    frames = []
    for compaction in (True, False):
        cfg = RenderConfig(max_path_length=2, blue_noise=False,
                           max_rays_per_pass=1024, compaction=compaction)
        eng = create_engine("wavefront", cfg, device="cpu")
        _scene(eng)
        eng.resize(64, 48)
        frames.append(eng.render_frame(_view(), RenderStatus.RESET,
                                       samples=3))
        assert (eng._driver is not None) == compaction
    assert np.isfinite(frames[0]).all() and frames[0].mean() > 1e-5
    assert np.abs(frames[0] - frames[1]).max() < 1e-5


def test_step_multi_equals_looped_step():
    cfg = RenderConfig(max_path_length=2, blue_noise=True,
                       max_rays_per_pass=1024)
    eng = create_engine("wavefront", cfg, device="cpu")
    _scene(eng)
    eng.resize(64, 48)
    eng.update()
    eng._get_step(64, 48)
    drv = eng._driver
    view = {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in _view().items()}
    acc_m, probe_m, stats_m, aux_m = drv.step_multi(
        eng._scene, torch.zeros((64 * 48, 3)), view, 0, 100, 3)
    acc = torch.zeros((64 * 48, 3))
    for s in range(3):
        acc, probe, stats, aux = drv.step(eng._scene, acc, view, s, 100)
    assert torch.equal(acc_m, acc) and torch.equal(probe_m, probe)
    assert all(torch.equal(aux_m[k], aux[k]) for k in aux)
    assert stats_m.keys() == stats.keys()
    for k in stats:
        assert int(stats_m[k]) == int(stats[k]), k


def test_config3_golden_and_reference(monkeypatch):
    monkeypatch.setenv("RFW_NO_TEX_CACHE", "1")
    rs = make_config3(RenderSystem("wavefront",
                                   config3(max_rays_per_pass=1024),
                                   device="cpu"))
    img = rs.render_frame(samples=8)
    eng = rs.context
    assert eng._driver is not None                # 4 chunks
    assert eng._scene["matlas"].dtype == torch.int32   # the merged atlas
    assert eng._scene["atlas"].shape == (1, 4)         # and its stub
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert _rmse(img, np.load(GOLDEN3).astype(np.float32)) < 2e-3

    ref = golden_scenes.make_config3(engine="wavefront")
    ref.set_setting("intersector", "visit")
    assert _rmse(img, np.asarray(ref.render_frame(samples=8))) < 2e-3


def test_profile_stages_frame_equals_unprofiled():
    frames, stats = [], []
    for profile in (False, True):
        cfg = RenderConfig(max_path_length=2, blue_noise=True,
                           max_rays_per_pass=1024, profile_stages=profile)
        eng = create_engine("wavefront", cfg, device="cpu")
        _scene(eng)
        eng.resize(64, 48)
        frames.append(eng.render_frame(_view(), RenderStatus.RESET,
                                       samples=3))
        stats.append(eng.get_stats())
    assert np.abs(frames[0] - frames[1]).max() <= 1e-6
    assert stats[0].primary_time == 0.0
    st = stats[1]
    assert st.primary_time > 0 and st.secondary_time > 0
    assert st.deep_time > 0 and st.primary_count == stats[0].primary_count
    assert st.primary_time + st.secondary_time + st.deep_time \
        <= st.render_time
