"""The port's denoiser, FXAA and the rest of the engine and system ABI
(``ops/denoise.py``, ``ops/tonemap.py::fxaa``, the depth-0 aux planes of
``render/integrator.py`` and ``render/wavefront_driver.py``, the
``denoise`` setting, ``RenderSystem.set_context`` and the render-state
checkpoint) against rfw_tpu, on the CPU.

Tolerances: the filters on the same inputs max abs < 1e-5 (float32
sums in another order, and exp/pow by other libraries); the aux planes
as tests/test_wavefront_driver.py holds them (normals < 1e-5, depths <
1e-4); a denoised frame against rfw_tpu's RMSE < 2e-3 (the goldens'
bar); a resumed render against a continuous one max abs < 1e-5, as
tests/test_camera.py holds rfw_tpu's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rfw_tpu
from rfw_tpu.config import RenderConfig as JConfig
from rfw_tpu.ops import denoise as j_denoise
from rfw_tpu.ops import tonemap as j_tonemap
from rfw_tpu.render import RenderStatus as JRenderStatus
from rfw_tpu.render import create_engine as j_create_engine
from rfw_tpu.render import intersectors as j_isect
from rfw_tpu.render.integrator import trace_sample as j_trace_sample
from test_torch_slice import _scene, _view
from test_wavefront_driver import _scene as j_scene

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import denoise, tonemap
from rfw_tpu_torch.render import RenderStatus, create_engine
from rfw_tpu_torch.render.engines import MegakernelEngine, WavefrontEngine
from rfw_tpu_torch.render.integrator import trace_sample
from rfw_tpu_torch.render.intersectors import make_intersector
from rfw_tpu_torch.system import RenderSystem

H, W = 37, 53
# 1024-lane chunks: the 64x48 frame runs the compacted driver
DRIVER_CFG = dict(max_path_length=2, blue_noise=False,
                  max_rays_per_pass=1024)


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


def _planes(seed=5):
    """Seeded 37x53 color (HDR, with edges), unit normals and depths."""
    rng = np.random.default_rng(seed)
    color = rng.gamma(1.5, 0.4, (H, W, 3)).astype(np.float32)
    color[:, W // 2:] *= 3.0
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n[H // 3:] += np.float32([0, 4, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rng.uniform(1.0, 6.0, (H, W)).astype(np.float32)
    depth[:, :W // 3] = 0.0                     # misses
    return color, n, depth


@pytest.mark.parametrize("guided", [True, False])
def test_atrous_denoise_matches_rfw_tpu(guided):
    color, n, depth = _planes()
    guides = (n, depth) if guided else (None, None)
    got = denoise.atrous_denoise(
        torch.from_numpy(color),
        *(None if g is None else torch.from_numpy(g) for g in guides))
    want = np.asarray(j_denoise.atrous_denoise(
        jnp.asarray(color),
        *(None if g is None else jnp.asarray(g) for g in guides)))
    assert np.abs(got.numpy() - want).max() < 1e-5
    # the filter smooths: the image's own variance drops
    assert got.numpy().var() < color.var()


def test_shift2d_clamps_at_the_edges():
    img = torch.arange(H * W, dtype=torch.float32).reshape(H, W)
    ref = np.asarray(j_denoise._shift2d(jnp.asarray(img.numpy()), -8, 13))
    assert np.array_equal(denoise._shift2d(img, -8, 13).numpy(), ref)
    assert denoise._shift2d(img, -8, 13)[0, W - 1] == img[0, W - 1]


def test_fxaa_matches_rfw_tpu():
    rng = np.random.default_rng(9)
    ldr = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    ldr[::4] = 0.0                              # hard edges: long steps
    ldr[:, ::7] = 1.0
    got = tonemap.fxaa(torch.from_numpy(ldr)).numpy()
    want = np.asarray(j_tonemap.fxaa(jnp.asarray(ldr)))
    assert np.abs(got - want).max() < 1e-5
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1


def _j_view():
    cam = rfw_tpu.Camera()
    cam.resize(64, 48)
    cam.fov = 55
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    return cam.get_view().as_pytree()


def test_aux_planes_match_fused_driver_and_rfw_tpu():
    cfg = RenderConfig(**DRIVER_CFG)
    view = {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in _view().items()}
    comp = create_engine("wavefront", cfg, device="cpu")
    _scene(comp)
    comp.set_setting("intersector", "bvh")
    comp.resize(64, 48)
    comp.update()
    comp._get_step(64, 48)
    drv = comp._driver
    assert drv is not None
    _, _, _, aux = drv.step(comp._scene, torch.zeros((64 * 48, 3)), view,
                            0, 0)
    aux_px = drv.aux_inverse(aux)
    assert not torch.equal(aux["depth"], aux_px["depth"])  # tiles reordered

    fused = create_engine("megakernel", cfg, device="cpu")
    _scene(fused)
    fused.resize(64, 48)
    fused.update()
    _, _, _, aux_f = trace_sample(fused._scene, view, 64, 48, 0, 0, cfg,
                                  make_intersector("bvh", cfg))
    assert (aux_f["depth"] > 0).any() and (aux_f["depth"] == 0).any()
    for k, tol in (("normal", 1e-5), ("depth", 1e-4)):
        assert (aux_px[k] - aux_f[k]).abs().max() < tol, k

    j_cfg = JConfig(**DRIVER_CFG)
    j_eng = j_create_engine("megakernel", j_cfg)
    j_scene(j_eng)
    j_eng.resize(64, 48)
    j_eng.update()
    _, _, _, aux_j = j_trace_sample(j_eng._scene, _j_view(), 64, 48, 0, 0,
                                    j_cfg, j_isect.FACTORIES["bvh"](j_cfg))
    for k, tol in (("normal", 1e-5), ("depth", 1e-4)):
        assert np.abs(aux_f[k].numpy() - np.asarray(aux_j[k])).max() < tol, k


def test_denoised_wavefront_frame_matches_rfw_tpu():
    eng = create_engine("wavefront", RenderConfig(**DRIVER_CFG),
                        device="cpu")
    _scene(eng)
    eng.set_setting("intersector", "bvh")
    eng.set_setting("denoise", "1")
    assert eng.get_available_settings()[1].value == "1"
    eng.resize(64, 48)
    img = eng.render_frame(_view(), RenderStatus.RESET, samples=2)
    assert eng._driver is not None
    j_eng = j_create_engine("megakernel", JConfig(**DRIVER_CFG))
    j_eng.use_wavefront_driver = True
    j_scene(j_eng)
    j_eng.set_setting("denoise", "1")
    j_eng.resize(64, 48)
    ref = np.asarray(j_eng.render_frame(_j_view(), JRenderStatus.RESET,
                                        samples=2))
    assert np.isfinite(img).all() and img.mean() > 1e-5
    assert _rmse(img, ref) < 2e-3
    eng.set_setting("denoise", "0")
    raw = eng.render_frame(_view(), RenderStatus.RESET, samples=2)
    assert np.abs(raw - img).max() > 1e-3        # the filter ran


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_aux_planes_only_while_denoising(engine):
    """With ``denoise`` off a frame builds no guide planes, and the frame
    is the same; on, the last sample's planes are kept for the filter."""
    eng = create_engine(engine, RenderConfig(**DRIVER_CFG), device="cpu")
    _scene(eng)
    eng.set_setting("intersector", "bvh")
    eng.resize(64, 48)
    frames = []
    for on in ("0", "1"):
        eng.set_setting("denoise", on)
        eng.render_frame_async(_view(), RenderStatus.RESET, samples=2)
        aux = eng._pending[2]
        assert (eng._driver is not None) == (engine == "wavefront")
        if on == "0":
            assert aux is None
        else:
            assert aux["normal"].shape == (64 * 48, 3)
            assert aux["depth"].shape == (64 * 48,)
        eng.finish_frame()
        frames.append(eng._accumulator.clone())
    assert torch.equal(frames[0], frames[1])


def _system(engine="megakernel"):
    """tests/test_camera.py's checkpoint scene, through the port."""
    rs = RenderSystem(engine, RenderConfig(blue_noise=False,
                                           max_path_length=1),
                      device="cpu")
    m = rs.add_material([0.6, 0.6, 0.6])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 8, 8, m))
    rs.add_point_light([0, 3.0, 0], [20.0] * 3)
    rs.camera.resize(32, 24)
    rs.camera.look_at([0, 2.0, -3.0], [0, 0, 0])
    return rs


def test_render_state_checkpoint(tmp_path):
    ref = _system().render_frame(samples=8)
    rs_b = _system()
    rs_b.render_frame(samples=4)
    p = str(tmp_path / "render_state")            # ".npz" appended
    assert rs_b.save_render_state(p)
    rs_c = _system()
    rs_c.camera.resize(16, 16)                    # the file's size wins
    assert rs_c.load_render_state(p)
    assert rs_c.camera.pixel_count == (32, 24)
    out = rs_c.render_frame(status=RenderStatus.CONVERGE, samples=4)
    assert np.abs(out - ref).max() < 1e-5
    assert not _system().save_render_state(str(tmp_path / "nothing"))


@pytest.mark.parametrize("bad", ["missing", "garbage", "truncated",
                                 "npy", "shape"])
def test_bad_render_state_returns_false(tmp_path, bad):
    rs = _system()
    rs.render_frame(samples=1)
    good = str(tmp_path / "good.npz")
    assert rs.save_render_state(good)
    p = tmp_path / "bad.npz"
    if bad == "garbage":
        p.write_bytes(b"not a zip file at all")
    elif bad == "truncated":
        p.write_bytes(open(good, "rb").read()[:200])
    elif bad == "npy":
        np.save(p, np.zeros(3))
        p = tmp_path / "bad.npz.npy"
    elif bad == "shape":
        np.savez(p, accumulator=np.zeros((5, 3), np.float32),
                 sample_count=1, width=32, height=24)
    fresh = _system()
    assert fresh.load_render_state(str(p)) is False
    assert fresh.context.get_render_state() is None


def test_set_context_swaps_engines_and_uploads_the_scene():
    rs = _system()
    assert isinstance(rs.context, MegakernelEngine)
    rs.render_frame(samples=1)
    rs.set_context("wavefront")
    assert isinstance(rs.context, WavefrontEngine)
    assert rs.context.device == rs.device
    img = rs.render_frame(samples=2)
    want = _system("wavefront").render_frame(samples=2)
    assert np.abs(img - want).max() < 1e-5 and img.mean() > 1e-3
    ldr = rs.tonemap_frame(img, fxaa=True)
    assert np.array_equal(ldr, tonemap.fxaa(tonemap.tonemap(
        torch.from_numpy(img), rs.camera.brightness,
        rs.camera.contrast)).numpy())
    assert rs.render_tonemapped(samples=1, fxaa=True).shape == (24, 32, 3)
