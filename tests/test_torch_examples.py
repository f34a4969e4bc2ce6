"""The port's examples (``rfw_tpu_torch/examples/``) on the CPU, at tiny
sizes.

* Each example's ``main([..., "--device", "cpu"])`` runs and writes its
  outputs; the viewer serves a frame over HTTP on a free port while its
  ``--duration`` runs.
* Without a card, each example's default ``--device cuda`` raises
  ``RuntimeError``: nothing falls back to the CPU.
* The port's Cornell box against ``examples/cornell.py``'s (rfw_tpu, JAX
  on the CPU) on ``megakernel`` at the golden size, 64x64 and 8 spp
  (RMSE < 2e-3, the golden matrix's bar). At 32x32 and 2 spp the
  reference's own fused and staged paths part (ROADMAP Queue 3).
"""

import importlib
import importlib.util
import io
import os
import pathlib
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from rfw_tpu_torch.render import RenderStatus, create_engine
from rfw_tpu_torch.viewer import LiveViewer

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("cornell", "textured_env", "instances", "animation", "viewer")


def _example(name):
    return importlib.import_module(f"rfw_tpu_torch.examples.{name}")


def _png_size(path):
    with Image.open(path) as im:
        return im.size


def _frames(out_dir):
    return sorted(p for p in os.listdir(out_dir) if p.endswith(".png"))


# (example, argv at a tiny size, the PNGs it must write under tmp_path)
RUNS = {
    "cornell": (["--size", "32", "--spp", "2", "--out", "{tmp}/c.png"],
                ["c.png"]),
    "textured_env": (["--size", "32", "--spp", "2", "--out",
                      "{tmp}/t.png"], ["t.png"]),
    "instances": (["--frames", "2", "--size", "32", "--spp", "1", "--out",
                   "{tmp}/inst"], ["inst/frame_00000.png",
                                   "inst/frame_00001.png"]),
    "instances --tlas": (["--tlas", "--frames", "2", "--size", "32", "--spp",
                          "1", "--out", "{tmp}/inst"],
                         ["inst/frame_00000.png", "inst/frame_00001.png"]),
    "animation": (["--frames", "2", "--size", "32", "--spp", "1", "--out",
                   "{tmp}/anim"], ["anim/frame_00000.png",
                                   "anim/frame_00001.png"]),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_example_runs_on_the_cpu(run, tmp_path, capsys):
    argv, pngs = RUNS[run]
    argv = [a.format(tmp=tmp_path) for a in argv] + ["--device", "cpu"]
    assert _example(run.split()[0]).main(argv) == 0
    for png in pngs:
        assert _png_size(tmp_path / png) == (32, 32)
    out = capsys.readouterr().out
    assert "device cpu" in out or "device=cpu" in out
    if run.startswith("instances"):
        assert _frames(tmp_path / "inst") == [os.path.basename(p)
                                              for p in pngs]
        assert (tmp_path / "inst" / "camera.bin").exists()
    if run == "animation":
        assert "model: a generated skinned tube (65536 triangles" in out
    if run == "textured_env":
        assert "sphere: a generated level-4 icosphere (5120 triangles)" in out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_viewer_example_serves_a_frame(monkeypatch, capsys):
    """The viewer for 0.5 s on a free port: one frame fetched over HTTP
    while it runs. Its ``stop`` waits (at most 60 s) until the frame has
    been fetched, so a slow first frame cannot close the server first."""
    port = _free_port()
    fetched = threading.Event()
    stop = LiveViewer.stop

    def stop_after_the_fetch(self):
        fetched.wait(timeout=60)
        stop(self)

    monkeypatch.setattr(LiveViewer, "stop", stop_after_the_fetch)
    result = []
    thread = threading.Thread(target=lambda: result.append(
        _example("viewer").main(["--size", "32", "--port", str(port),
                                 "--duration", "0.5", "--device", "cpu"])))
    thread.start()
    png = b""
    try:
        for _ in range(2400):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/frame.png",
                        timeout=30) as r:
                    png = r.read()
            except OSError:
                png = b""
            if png:
                break
            time.sleep(0.025)
    finally:
        fetched.set()
        thread.join(timeout=120)
    assert not thread.is_alive()
    assert result == [0]
    assert Image.open(io.BytesIO(png)).size == (32, 32)
    assert (f"live viewer on http://127.0.0.1:{port}: the quad scene, "
            "wavefront on cpu") in capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_the_card(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
    assert not [p for p in tmp_path.rglob("*.png")]


def _reference_cornell():
    """examples/cornell.py (rfw_tpu), imported by path."""
    spec = importlib.util.spec_from_file_location(
        "rfw_tpu_cornell_example", ROOT / "examples" / "cornell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cornell_matches_rfw_tpu():
    size, spp = 64, 8
    ref_mod = _reference_cornell()
    j_eng = ref_mod.create_engine("megakernel")
    ref_mod.build_cornell(j_eng)
    j_eng.resize(size, size)
    ref = np.asarray(j_eng.render_frame(
        ref_mod.default_camera(size).get_view().as_pytree(),
        ref_mod.RenderStatus.RESET, samples=spp))

    cornell = _example("cornell")
    eng = create_engine("megakernel", device="cpu")
    cornell.build_cornell(eng)
    eng.resize(size, size)
    frame = eng.render_frame(cornell.default_camera(size).get_view()
                             .as_pytree(), RenderStatus.RESET, samples=spp)
    assert frame.shape == ref.shape == (size, size, 3)
    assert np.isfinite(frame).all() and float(frame.mean()) > 0.01
    rmse = float(np.sqrt(((frame - ref) ** 2).mean()))
    assert rmse < 2e-3, rmse
