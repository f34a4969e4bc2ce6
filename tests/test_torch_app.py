"""The port's application layer on the CPU: ``rfw_tpu_torch/app.py``,
``rfw_tpu_torch/viewer.py`` and ``rfw_tpu_torch/render/template.py``.

* App's pipelined loop gives the sequential loop's frames bit for bit
  (tests/test_async.py's orbit-and-brightness update), and the port's
  App frames lie within RMSE 2e-3 of rfw_tpu's App frames.
* An ``update`` that raises surfaces as itself, also when retiring the
  in-flight frame fails too, and leaves no frame in flight; rfw_tpu's
  ``finally`` block lets the second exception hide the first.
* The live viewer's endpoints, camera keys (which restart the
  accumulation), probe, settings and material edits, as
  tests/test_viewer.py drives rfw_tpu's.
* TemplateEngine's ABI, alone and behind a RenderSystem.
"""

import importlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.render import RenderStatus
from rfw_tpu_torch.render.template import TemplateEngine
from rfw_tpu_torch.system import RenderSystem
from rfw_tpu_torch.viewer import LiveViewer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _orbit_app(pkg, tmp_path, tag, fail_at=None, move=False):
    """tests/test_async.py's Orbit app in ``pkg``; its ``update`` raises
    ValueError on call ``fail_at``, and with ``move`` also lifts the lamp
    (a scene update: ``update_instance`` and ``synchronize``, as
    examples/instances.py does)."""
    base = importlib.import_module(f"{pkg}.app").App
    config = importlib.import_module(f"{pkg}.config").RenderConfig
    kw = {"device": "cpu"} if pkg == "rfw_tpu_torch" else {}

    class Orbit(base):
        def __init__(self):
            super().__init__(width=48, height=48, engine="megakernel",
                             config=config(blue_noise=False),
                             camera_file=str(tmp_path / f"cam_{tag}.bin"),
                             fxaa=True, **kw)
            self.frames = []
            self.ticks = 0

        def init(self, rs):
            if rs.materials.materials:          # a second run
                return
            m = rs.add_material([0.7, 0.6, 0.5])
            rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 6, 6, m))
            lamp = rs.add_material([20.0, 20.0, 20.0])
            rs.add_instance(rs.add_quad([0, -1, 0], [0, 4.0, 0], 1, 1,
                                        lamp))
            rs.camera.look_at([0, 2.0, -5.0], [0, 0.5, 0])

        def update(self, rs, dt):
            self.ticks += 1
            if self.ticks == fail_at:
                raise ValueError("update failed")
            ang = 0.4 * self.ticks
            rs.camera.look_at([5 * np.sin(ang), 2.0, -5 * np.cos(ang)],
                              [0, 0.5, 0])
            rs.camera.brightness = 0.05 * self.ticks
            if move:
                m = np.eye(4, dtype=np.float32)
                m[1, 3] = 0.2 * self.ticks
                rs.update_instance(1, m)
                rs.synchronize()
            return True

        def post_render(self, frame, frame_index):
            self.frames.append(np.asarray(frame))

    return Orbit()


def test_app_pipeline_matches_sequential(tmp_path):
    seq = _orbit_app("rfw_tpu_torch", tmp_path, "seq")
    seq.run(frames=3, samples_per_frame=2, pipeline=False)
    pipe = _orbit_app("rfw_tpu_torch", tmp_path, "pipe")
    pipe.run(frames=3, samples_per_frame=2, pipeline=True)
    assert seq.ticks == pipe.ticks == 3
    assert len(seq.frames) == len(pipe.frames) == 3
    for a, b in zip(seq.frames, pipe.frames):
        assert np.array_equal(a, b)
    assert not np.array_equal(pipe.frames[0], pipe.frames[1])
    ref = _orbit_app("rfw_tpu", tmp_path, "ref")
    ref.run(frames=3, samples_per_frame=2, pipeline=True)
    for a, b in zip(pipe.frames, ref.frames):
        assert float(np.sqrt(((a - b) ** 2).mean())) < 2e-3


def test_app_scene_update_keeps_the_frame_in_flight(tmp_path):
    """An ``update`` that changes the scene while a frame is in flight
    restarts the accumulation for the next frame; the frame in flight
    keeps its own accumulator and sample count, so the pipelined frames
    equal the sequential ones bit for bit. The reference resets the
    in-flight frame's count, and its pipelined frames come out
    ``samples`` times too bright (its sequential frames are right)."""
    seq = _orbit_app("rfw_tpu_torch", tmp_path, "mseq", move=True)
    seq.run(frames=3, samples_per_frame=2, pipeline=False)
    pipe = _orbit_app("rfw_tpu_torch", tmp_path, "mpipe", move=True)
    pipe.run(frames=3, samples_per_frame=2, pipeline=True)
    assert len(seq.frames) == len(pipe.frames) == 3
    for a, b in zip(seq.frames, pipe.frames):
        assert np.array_equal(a, b)
    ref = {}
    for pipeline in (False, True):
        app = _orbit_app("rfw_tpu", tmp_path, f"mref{pipeline}", move=True)
        app.run(frames=3, samples_per_frame=2, pipeline=pipeline)
        ref[pipeline] = app.frames
    for a, b, c in zip(pipe.frames, ref[False], ref[True]):
        assert float(np.sqrt(((a - b) ** 2).mean())) < 2e-3
        assert float(c.mean()) > float(b.mean()) + 0.02


def _failing_retirement(rs, on_call):
    """``rs.finish_frame`` retires the frame, then raises on call
    ``on_call``."""
    orig = rs.finish_frame
    calls = []

    def finish_frame():
        frame = orig()
        calls.append(1)
        if len(calls) == on_call:
            raise RuntimeError("retirement failed")
        return frame

    rs.finish_frame = finish_frame
    return orig


@pytest.mark.parametrize("retire_fails", [False, True])
def test_app_update_error_surfaces(tmp_path, capsys, retire_fails):
    app = _orbit_app("rfw_tpu_torch", tmp_path, "fail", fail_at=2)
    orig = _failing_retirement(app.rs, 2) if retire_fails else None
    with pytest.raises(ValueError, match="update failed"):
        app.run(frames=3, pipeline=True)
    assert app.rs.context._pending is None      # nothing left in flight
    assert len(app.frames) == 1
    assert ("retiring the frame" in capsys.readouterr().err) == retire_fails
    if orig is not None:
        app.rs.finish_frame = orig
    app.run(frames=2, pipeline=True)            # the next run works
    assert len(app.frames) == 3 and app.ticks == 4


def test_rfw_tpu_app_hides_the_update_error(tmp_path):
    """The reference's fault the port repairs: its ``finally`` block's
    exception replaces update's."""
    app = _orbit_app("rfw_tpu", tmp_path, "ref_fail", fail_at=1)
    _failing_retirement(app.rs, 1)
    with pytest.raises(RuntimeError, match="retirement failed"):
        app.run(frames=2, pipeline=True)


def _viewer_rs():
    rs = RenderSystem("megakernel",
                      RenderConfig(blue_noise=False, max_path_length=1),
                      device="cpu")
    floor = rs.add_material([0.6, 0.6, 0.65])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 10, 10, floor))
    lamp = rs.add_material([30.0, 30.0, 30.0])
    rs.add_instance(rs.add_quad([0, -1, 0], [0, 6.0, 0], 2, 2, lamp))
    rs.camera.look_at([0, 2.5, -5.0], [0, 1.0, 0.0])
    return rs


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read()


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/input",
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _wait(pred, what, tries=200):
    for _ in range(tries):
        out = pred()
        if out:
            return out
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


STATS_KEYS = {"Mrays/s", "render ms", "primary ms", "secondary ms",
              "deep ms", "rays primary", "rays shadow", "spp"}


def test_viewer_endpoints_and_camera():
    rs = _viewer_rs()
    viewer = LiveViewer(rs, 64, 48, port=0, samples_per_frame=1)
    pos0 = rs.camera.position.copy()
    t = threading.Thread(target=viewer.run, kwargs={"max_frames": 400})
    t.start()
    try:
        png = _wait(lambda: (lambda p: p if p.startswith(b"\x89PNG")
                             else None)(_get(viewer.port, "/frame.png")),
                    "the first frame")
        from PIL import Image
        import io
        assert Image.open(io.BytesIO(png)).size == (64, 48)
        page = _get(viewer.port, "/").decode()
        assert "rfw_tpu" in page and "canvas" in page
        stats = json.loads(_get(viewer.port, "/stats"))
        assert set(stats["stats"]) == STATS_KEYS
        assert [s["name"] for s in stats["settings"]] == ["intersector",
                                                          "denoise"]
        assert len(stats["materials"]) == 2
        assert abs(stats["materials"][0]["color"][0] - 0.6) < 1e-5

        _wait(lambda: json.loads(_get(viewer.port, "/stats"))["stats"]
              ["spp"] >= 4, "4 accumulated samples")
        _post(viewer.port, {"action": "keys", "keys": ["w"]})
        assert not np.allclose(rs.camera.position, pos0)
        # the move restarts the accumulation
        _wait(lambda: json.loads(_get(viewer.port, "/stats"))["stats"]
              ["spp"] <= 2, "the accumulation to restart")
        _post(viewer.port, {"action": "probe", "x": 32, "y": 24})
        _post(viewer.port, {"action": "set", "name": "denoise",
                            "value": "1"})
        _post(viewer.port, {"action": "set", "name": "nope", "value": "1"})
        _post(viewer.port, {"action": "material", "index": 0,
                            "color": [0.9, 0.1, 0.1], "roughness": 0.25})
        m0 = rs.get_material(0)
        assert abs(float(m0.roughness) - 0.25) < 1e-6
        assert abs(float(np.asarray(m0.color)[0]) - 0.9) < 1e-6
        # the default probe pixel (0, 0) sees the sky; the probed one
        # sees the floor
        stats = _wait(lambda: (lambda s: s if s["probe"][2] > 0 else None)(
            json.loads(_get(viewer.port, "/stats"))), "the probe")
        assert stats["stats"]["rays primary"] == 64 * 48
        assert stats["probe"][:2] == [0, 0]
        assert stats["settings"][1]["value"] == "1"
        assert abs(stats["materials"][0]["roughness"] - 0.25) < 1e-6
    finally:
        viewer.stop()
        t.join(timeout=60)
    assert not t.is_alive()


def test_template_engine_abi():
    eng = TemplateEngine(device="cpu")
    assert eng.device.type == "cpu"
    for call in (lambda: eng.set_mesh(0, None),
                 lambda: eng.set_instance(0, 0, np.eye(4)),
                 lambda: eng.remove_instance(0),
                 lambda: eng.set_materials({}), lambda: eng.set_textures({}),
                 lambda: eng.set_lights({}), lambda: eng.set_sky(None),
                 eng.update):
        assert call() is None
    eng.resize(4, 3)
    frame = eng.render_frame({}, RenderStatus.RESET, samples=2)
    assert frame.shape == (3, 4, 3) and not frame.any()
    with pytest.raises(RuntimeError, match="without a frame in flight"):
        eng.finish_frame()
    assert eng.get_probe_results() == (-1, -1, -1.0)
    # behind a RenderSystem: the whole upload path, black frames
    rs = RenderSystem(TemplateEngine(device="cpu"), device="cpu")
    m = rs.add_material([0.5, 0.5, 0.5])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 2, 2, m))
    rs.add_point_light([0, 2, 0], [1, 1, 1])
    rs.camera.resize(8, 6)
    img = rs.render_frame(samples=3)
    assert img.shape == (6, 8, 3) and not img.any()
    assert rs.get_probe_results() == (-1, -1, -1.0)
