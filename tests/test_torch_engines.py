"""The port's fused engines (``rfw_tpu_torch/render/engines.py``):
``megakernel`` on the ``bvh`` intersector, ``bruteforce`` and ``direct``,
on the CPU against the goldens and against rfw_tpu.

* ``megakernel`` lands on the Cornell golden (tests/test_golden.py) and
  on the config-2 and config-3 goldens (tests/golden_scenes.py renders
  them through rfw_tpu's ``megakernel``), each within RMSE 2e-3 (the
  goldens' fp16 storage plus a few paths a last bit sends elsewhere).
* ``bruteforce`` equals ``megakernel`` bit for bit, as
  tests/test_integrator.py asserts in rfw_tpu: both intersectors make the
  same triangle tests in the same arithmetic.
* ``direct`` lies within RMSE 2e-3 of rfw_tpu's ``direct`` frame and is
  darker than ``megakernel``'s.
* The ``dense`` intersector agrees with ``bvh`` to
  tests/test_integrator.py's bar.
* ``validate()`` raises on the broken scenes rfw_tpu's raises on; the
  engine list is rfw_tpu's, and the settings (every intersector,
  ``tlas`` included, and ``denoise``) are rfw_tpu's.
"""

import os

import numpy as np
import pytest
import torch

import golden_scenes
from chip_smoke import config3, make_config2, make_config3, make_cornell
from rfw_tpu.config import RenderConfig as JConfig
from rfw_tpu.render import context as j_context
from rfw_tpu.render import create_engine as j_create_engine
from test_integrator import _FAST
from test_integrator import make_cornell as j_cornell

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.render import RenderStatus, context, create_engine
from rfw_tpu_torch.render.intersectors import FACTORIES
from rfw_tpu_torch.system import RenderSystem

CORNELL = os.path.join(golden_scenes.GOLDEN_DIR, "cornell_64_8spp.npy")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def cornell(engine="megakernel", cfg=None, size=64):
    """tests/test_integrator.py::make_cornell's scene, through the port."""
    return make_cornell(RenderSystem(engine, cfg or RenderConfig(),
                                     device="cpu"), size)


def test_megakernel_cornell_golden():
    rs = cornell("megakernel", RenderConfig(blue_noise=True))
    img = rs.render_frame(samples=8)
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert _rmse(img, np.load(CORNELL).astype(np.float32)) < 2e-3
    assert rs.context._intersector_name == "bvh"
    assert rs.context._driver is None                  # the fused path


@pytest.mark.parametrize("label", ["config2", "config3"])
def test_megakernel_config_goldens(label):
    if label == "config2":
        cfg = RenderConfig(blue_noise=True, max_path_length=3)
        rs = make_config2(RenderSystem("megakernel", cfg, device="cpu"))
    else:
        rs = make_config3(RenderSystem("megakernel", config3(),
                                       device="cpu"))
    img = rs.render_frame(samples=8)
    golden = np.load(os.path.join(golden_scenes.GOLDEN_DIR,
                                  f"{label}_64_8spp.npy")).astype(np.float32)
    assert np.isfinite(img).all()
    assert _rmse(img, golden) < 2e-3


def test_bruteforce_equals_megakernel():
    imgs = {name: cornell(name, RenderConfig(**_FAST, max_path_length=2),
                          size=32).render_frame(samples=4)
            for name in ("bruteforce", "megakernel")}
    assert imgs["megakernel"].mean() > 0.01
    assert np.array_equal(imgs["bruteforce"], imgs["megakernel"])


def test_direct_matches_rfw_tpu_and_is_darker():
    img = cornell("direct", RenderConfig(**_FAST), size=32).render_frame(
        samples=8)
    ref = np.asarray(j_cornell("direct", JConfig(**_FAST),
                               size=32).render_frame(samples=8))
    assert _rmse(img, ref) < 2e-3
    full = cornell("megakernel", RenderConfig(**_FAST), size=32).render_frame(
        samples=8)
    assert full.mean() > img.mean() > 0.01


def test_dense_intersector_matches_bvh():
    rs = cornell("megakernel", RenderConfig(**_FAST), size=32)
    img_a = rs.render_frame(status=RenderStatus.RESET, samples=2)
    rs.context.set_setting("intersector", "dense")
    img_b = rs.render_frame(status=RenderStatus.RESET, samples=2)
    assert _rmse(img_a, img_b) < 0.02 * max(img_a.mean(), 1e-6) + 1e-4


def _break(scene, how, asarray):
    """One of validate()'s faults, made in a built scene's tables."""
    if how == "nan_vertex":
        v = np.array(asarray(scene["tri_vertices"]))
        v[3, 1, 2] = np.nan
        scene["tri_vertices"] = v
    elif how == "material":
        m = np.array(asarray(scene["tri_material"]))
        m[0] = 99
        scene["tri_material"] = m
    else:
        bvh = dict(scene["bvh"])
        count = np.asarray(asarray(bvh["count"]))
        child = np.array(asarray(bvh["child"]))
        if how == "leaf_range":
            child[count > 0] += 1000
        else:                                        # an internal child
            child[(count < 0) & (child >= 0)] = 1 << 20
        bvh["child"] = child
        scene["bvh"] = bvh


@pytest.mark.parametrize("how,match", [
    (None, None),
    ("nan_vertex", "non-finite"),
    ("material", "material id out of range"),
    ("leaf_range", "leaf range"),
    ("child_index", "child index"),
])
def test_validate_raises_as_rfw_tpu(how, match):
    ref = j_cornell("megakernel", JConfig(**_FAST), size=8)
    port = cornell("megakernel", RenderConfig(**_FAST), size=8)
    # an internal child needs more triangles than one wide node holds
    for rs in (ref, port):
        m = rs.add_material([0.5] * 3)
        for i in range(8):
            rs.add_instance(rs.add_quad([0, 1, 0], [i * 0.1, 1.0, 0], 0.05,
                                        0.05, m))
        rs.synchronize()
    engines = ((ref.context, np.asarray),
               (port.context, lambda x: x.cpu().numpy()))
    for eng, asarray in engines:
        eng.update()
        if how is None:
            eng.validate()
            continue
        scene = dict(eng._scene)
        _break(scene, how, asarray)
        if eng is port.context:
            scene = {k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                     else v for k, v in scene.items()}
            if how in ("leaf_range", "child_index"):
                scene["bvh"] = {k: torch.as_tensor(v)
                                for k, v in scene["bvh"].items()}
        eng._scene = scene
        with pytest.raises(ValueError, match=match):
            eng.validate()


def test_engine_list_and_settings():
    ported = j_context.available_engines()
    assert context.available_engines() == ported
    for name in ported:
        eng = create_engine(name, device="cpu")
        ref = j_create_engine(name)
        settings = eng.get_available_settings()
        assert [s.name for s in settings] == ["intersector", "denoise"]
        want = {s.name: s for s in ref.get_available_settings()}
        setting = settings[0]
        assert setting.options == want["intersector"].options
        assert setting.options == sorted(FACTORIES)
        # rfw_tpu's wavefront takes bvh off the TPU; the port's takes the
        # visit kernels on every device
        expect = ("visit" if name == "wavefront"
                  else want["intersector"].value)
        assert setting.value == expect
        assert (settings[1].value, settings[1].options) == (
            want["denoise"].value, want["denoise"].options)
    eng = create_engine("megakernel", device="cpu")
    eng.set_setting("intersector", "tlas")
    assert eng.config.use_tlas
    assert eng.get_available_settings()[0].value == "tlas"
    with pytest.raises(ValueError, match="unknown intersector"):
        eng.set_setting("intersector", "nope")
