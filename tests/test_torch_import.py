"""The port's package surface: it imports nothing of rfw_tpu and no JAX
(the machine with the card has no JAX, and the port keeps its own copies
of rfw_tpu's host modules), and its entry points run on the card unless
the caller asks for the CPU.

The sys.modules check runs in a fresh interpreter, since this test
process has JAX and rfw_tpu loaded."""

import ast
import inspect
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import bench_torch
from rfw_tpu_torch.app import App
from rfw_tpu_torch.parallel import make_tile_mesh
from rfw_tpu_torch.render import context, engines
from rfw_tpu_torch.render.template import TemplateEngine
from rfw_tpu_torch.system import RenderSystem

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "rfw_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_imports_no_jax_or_rfw_tpu():
    """Every module of rfw_tpu_torch (walked with pkgutil), chip_smoke and
    bench_torch import, and leave no jax, rfw_tpu or rfw_tpu.* module (nor
    bench, the JAX package's bench) in sys.modules."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import rfw_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    rfw_tpu_torch.__path__, 'rfw_tpu_torch.')]\n"
        "for m in names + ['chip_smoke', 'bench_torch']:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps({'names': names, 'loaded': sorted(sys.modules)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["names"]) >= 50, res["names"]   # the walk found it all
    for sub in ("scene.ply", "scene.gltf", "native", "utils.image",
                "ops.visit_intersect", "bvh.tlas", "system"):
        assert f"rfw_tpu_torch.{sub}" in res["names"], sub
    assert [m for m in res["loaded"] if _forbidden(m)] == []
    assert "bench_torch" in res["loaded"] and "bench" not in res["loaded"]


def _imports(path: pathlib.Path):
    """(line, module) of every absolute import in a file, at any depth
    (inside functions too)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_source_names_rfw_tpu_or_jax():
    files = sorted((ROOT / "rfw_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    assert len(files) >= 50
    bad = [f"{p.relative_to(ROOT)}:{line}: {name}" for p in files
           for line, name in _imports(p)
           if _forbidden(name) or name.split(".")[0] == "bench"]
    assert bad == []


def test_entry_points_default_to_the_card(monkeypatch):
    """RenderSystem, create_engine, the engines, App, make_tile_mesh,
    TemplateEngine and bench_torch.run default to "cuda" and raise
    RuntimeError without a card; "cpu" must be asked for."""
    for fn in (RenderSystem.__init__, context.create_engine,
               engines.PathTracerEngine.__init__, App.__init__,
               make_tile_mesh, TemplateEngine.__init__, bench_torch.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: RenderSystem("wavefront"),
                 lambda: context.create_engine("wavefront"),
                 lambda: engines.WavefrontEngine(),
                 lambda: context.create_engine("raster"), App,
                 lambda: make_tile_mesh(2), TemplateEngine,
                 lambda: bench_torch.run(scene="quad")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    rs = RenderSystem("wavefront", device="cpu")
    assert rs.device.type == "cpu" and rs.context.device.type == "cpu"
