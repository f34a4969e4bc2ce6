"""The port's bench, ``bench_torch.py``, on the CPU at a tiny size.

* Its quad scene is ``bench.py``'s fallback scene: both packages' scene
  builds (triangles, BVH and cell tables, materials, lights), cameras and
  sky tables are equal. Importing ``bench`` probes no TPU and loads no
  JAX.
* ``run`` returns the line's schema, with its median and Mrays/s as the
  protocol defines them, and a per-depth split. At 32x18 a frame is one
  chunk of the default ``max_rays_per_pass``, which runs the fused
  program and has no split (``bench.py`` leaves ``stage_ms`` out there
  too), so the runs here build their configs with chunks of 288 lanes:
  two chunks, the compacted driver.
* Its rays a sample equal those of rfw_tpu's ``wavefront`` engine (visit
  intersector) on the same scene, size, chunking and samples, exactly:
  every random draw is keyed by the pixel and the sample index in both.
* ``python bench_torch.py --device cpu ...`` exits 0 and prints the line
  last; without ``--device cpu`` and without a card it raises and prints
  no line.
* The slice's scene builder, moved from ``chip_smoke.py`` into
  ``rfw_tpu_torch/utils/synthetic.py``, builds the same 316,802
  triangles: the checksum of its vertex positions is the one
  ``chip_smoke.py``'s own copy gave before the move.
"""

import functools
import hashlib
import inspect
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from rfw_tpu import config as j_config
from rfw_tpu.render import RenderStatus as JRenderStatus
from rfw_tpu.render import scene_data as jax_sd
from rfw_tpu.system import RenderSystem as JRenderSystem

import bench
import bench_torch
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.system import RenderSystem
from rfw_tpu_torch.utils import synthetic

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H, CHUNK = 32, 18, 288
KEYS = {"metric", "value", "unit", "ms_per_sample_median",
        "ms_per_sample_windows", "rays_per_sample", "cache_state",
        "setup_compile_s", "scene_build_s", "warm_session_ttfp_s",
        "stage_ms", "device", "launches"}
# sha256 of the slice's vertex positions (float32, object by object),
# from chip_smoke.py's build_slice_scene before it moved
SLICE_POSITIONS_SHA256 = (
    "7d1bb71d9d738e55eb1f063e3b825e3abea0919f024d0c5d2d2ef451f784f39e")


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _bench_fallback(monkeypatch, config=None):
    """bench.py's scene on rfw_tpu's RenderSystem, without pica's glTF:
    its procedural fallback."""
    monkeypatch.setattr(bench, "PICA", str(ROOT / "no_such_scene.gltf"))
    return bench.build_scene(JRenderSystem("wavefront", config))


def _quad_systems(monkeypatch):
    """bench.py's fallback scene on rfw_tpu and the port's quad scene, each
    resized as the benches resize them and synchronized."""
    ref = _bench_fallback(monkeypatch)
    port = RenderSystem("wavefront", device="cpu")
    assert bench_torch.build_scene(port, "quad") == 4
    for rs in (ref, port):
        rs.camera.resize(W, H)
        rs.camera.fov = 60.0
        rs.synchronize()
    return ref, port


def test_bench_import_runs_no_probe():
    code = ("import subprocess, sys\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError('bench ran a process at import')\n"
            "subprocess.run = subprocess.Popen = refuse\n"
            "import bench\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'rfw_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_quad_scene_equals_bench_fallback(monkeypatch):
    ref, port = _quad_systems(monkeypatch)
    j_eng, p_eng = ref.context, port.context
    want = dict(_leaves(jax_sd.build_device_scene(
        j_eng._instance_list(), j_eng._materials, j_eng._lights, None, None,
        j_config.RenderConfig(),
        area_light_overrides=j_eng._light_overrides)))
    got = scene_data.build_device_scene(
        p_eng._instance_list(), p_eng._materials, p_eng._lights, None, None,
        RenderConfig(), area_light_overrides=p_eng._light_overrides)
    n = 0
    for key, val in _leaves(got):
        if isinstance(val, np.ndarray):
            assert val.dtype == want[key].dtype, key
            assert np.array_equal(val, want[key]), key
            n += 1
        elif key not in ("materials", "lights"):
            assert val == want[key], key
    assert n >= 20                  # triangle, cell and BVH tables
    for table in ("materials", "lights"):
        w = getattr(j_eng, f"_{table}")
        for key, val in _leaves(getattr(p_eng, f"_{table}")):
            assert np.array_equal(np.asarray(val),
                                  np.asarray(dict(_leaves(w))[key])), key
    assert p_eng._light_overrides == j_eng._light_overrides
    for key, val in ref.camera.get_view().as_pytree().items():
        assert np.array_equal(
            np.asarray(val),
            port.camera.get_view().as_pytree()[key]), key
    assert {"pixels", "pdf", "pixpdf"} <= set(p_eng._skybox)
    for key, val in p_eng._skybox.items():
        assert np.array_equal(val, np.asarray(j_eng._skybox[key])), key


def _run(monkeypatch):
    monkeypatch.setattr(bench_torch, "RenderConfig", functools.partial(
        RenderConfig, max_rays_per_pass=CHUNK))
    return bench_torch.run(device="cpu", width=W, height=H, samples=1,
                           windows=2, scene="quad")


def test_run_schema(monkeypatch):
    out = _run(monkeypatch)
    assert KEYS <= set(out)
    assert "vs_baseline" not in out
    assert out["metric"].startswith("Mrays/sec/chip (procedural quad, 4 tris")
    assert out["unit"] == "Mrays/s" and out["device"] == {"name": "cpu"}
    rays = out["rays_per_sample"]
    assert rays["primary"] == W * H
    assert rays["total"] == (rays["primary"] + rays["secondary"]
                             + rays["deep"] + rays["shadow"])
    win = out["ms_per_sample_windows"]
    assert len(win) == 2 and win == sorted(win)
    med = out["ms_per_sample_median"]
    assert med == 0.5 * (win[0] + win[1])
    samples = out["samples_per_window"]
    assert samples == 1
    assert math.isclose(out["value"], rays["total"] * samples
                        / (med * samples / 1000.0) / 1e6, rel_tol=1e-12)
    assert out["value"] > 0
    assert set(out["stage_ms"]) == {"primary", "secondary", "deep"}
    assert out["stage_ms"]["primary"] > 0
    assert {"kernel_library", "scene_cache",
            "texture_cache"} <= set(out["cache_state"])
    # the CPU runs the plain versions, which count no launch
    assert set(out["launches"]) >= {"enum", "visit"}
    assert all(v == 0 for v in out["launches"].values())
    for key in ("setup_compile_s", "scene_build_s", "warm_session_ttfp_s"):
        assert out[key] > 0, key
    json.dumps(out)                 # one JSON line


def test_rays_per_sample_equal_rfw_tpu(monkeypatch):
    """The bench protocol's counts on rfw_tpu: a 2-sample warm-up, then
    two CONVERGE windows of one sample, the last window's stats."""
    jrs = _bench_fallback(monkeypatch,
                          j_config.RenderConfig(max_rays_per_pass=CHUNK))
    jrs.set_setting("intersector", "visit")
    jrs.camera.resize(W, H)
    jrs.camera.fov = 60.0
    jrs.synchronize()
    jrs.render_frame(samples=2)
    for _ in range(2):
        jrs.render_frame_async(status=JRenderStatus.CONVERGE, samples=1)
        jrs.finish_frame()
    st = jrs.get_render_stats()
    want = {"primary": st.primary_count, "secondary": st.secondary_count,
            "deep": st.deep_count, "shadow": st.shadow_count}
    got = _run(monkeypatch)["rays_per_sample"]
    assert {k: got[k] for k in want} == want
    assert want["secondary"] > 0 and want["shadow"] > 0


def test_script_prints_the_line_last():
    argv = [sys.executable, "bench_torch.py", "--device", "cpu", "--width",
            str(W), "--height", str(H), "--samples", "1", "--windows", "2",
            "--scene", "quad"]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert KEYS <= set(line)
    assert line["rays_per_sample"]["primary"] == W * H
    assert "# setup+compile" in out.stderr
    # the default device is the card: without one it raises, no line
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['bench_torch.py', '--scene', 'quad']\n"
            "import bench_torch\n"
            "bench_torch.main()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and out.stdout.strip() == ""


def test_moved_slice_scene_is_unchanged(tmp_path):
    rs = RenderSystem("wavefront", device="cpu")
    assert synthetic.build_slice_scene(rs, str(tmp_path)) == 316_802
    h = hashlib.sha256()
    for obj in rs._objects:
        for mesh in obj.meshes:
            h.update(np.ascontiguousarray(mesh.positions,
                                          np.float32).tobytes())
    assert h.hexdigest() == SLICE_POSITIONS_SHA256
    assert rs.camera.pixel_count == (1920, 1080)


def test_default_scene_is_the_standin():
    """The bench renders the generated stand-in unless told otherwise,
    whatever lies around the checkout: pica's glTF is not in this
    repository, and the bench reads no path outside it."""
    run = inspect.signature(bench_torch.run).parameters
    assert run["scene"].default == "standin"
    assert bench_torch.SCENES == ("standin", "quad")
    with pytest.raises(ValueError, match="unknown scene"):
        bench_torch.build_scene(RenderSystem("wavefront", device="cpu"),
                                "pica")
