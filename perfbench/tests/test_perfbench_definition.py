"""The benchmark's definition: BENCHMARK.json's form, every file its
names need, the frozen scenes, and what the harness and the reference may
import."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from perfbench.lib import bench, geometry

ROOT = bench.ROOT
HERE = bench.HERE
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"]
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def definition():
    return bench.load()


def test_top_level_keys(definition):
    assert list(definition) == TOP_KEYS
    assert definition["command"] == ["python3", "perfbench/run.py"]
    assert definition["paths"] == ["perfbench"]
    assert 1 <= definition["run_seconds"] <= 51


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entry_keys(definition, kind):
    for entry in definition[kind]:
        keys = set(entry) - {"workloads"} if kind in (
            "end_to_end", "per_layer") else set(entry)
        assert keys == ENTRY_KEYS[kind], entry["name"]


def test_names_units_and_files(definition):
    assert bench.problems(definition) == []


@pytest.mark.parametrize("name,ok", [
    ("tetra-visit.converge", True), ("_a", True), ("a b", False),
    ("a,b", False), ("a/b", False), (".a", False), ("x" * 65, False)])
def test_name_rule(name, ok):
    assert bool(bench.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("ms", True), ("tokens/s", True), ("%", True), ("GiB", True),
    ("launches", True), ("per second", False), ("x" * 17, False),
    ("µs", False)])
def test_unit_rule(unit, ok):
    assert bool(bench.UNIT.match(unit)) is ok


def test_every_cell_resolves(definition):
    for w in definition["workloads"]:
        spec = bench.cell(definition, w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert spec["per_layer"], w["name"]
        assert set(spec["limits"]) >= {"closest_mismatch", "frame_l1"}
        loop = bench.plugin("loops", spec["traffic"]["loop"])
        assert hasattr(loop.Loop, "iteration")


def test_end_to_end_readers(definition):
    """Each cell's end-to-end readers read their own loop's work only."""
    from types import SimpleNamespace
    run = SimpleNamespace(setup_s=9.5, measured_s=30.0, done=60,
                          unit="samples", peak_bytes=2 ** 31)
    got = {m["name"]: bench.reader(m["name"], "e2e")(run)
           for m in definition["end_to_end"]}
    assert got == {"setup_s": 9.5, "ms_per_sample": 500.0, "edit_ms": None,
                   "peak_mem_gib": 2.0}


def test_metric_readers_read_nothing_without_a_trace(definition):
    from types import SimpleNamespace
    empty = SimpleNamespace(trace=None, window=None, work_traced=0,
                            live_rays=[], calls_traced=0, busy_s=0.0,
                            window_s=0.0, update_s=[], config={}, mix={})
    for m in definition["per_layer"]:
        assert bench.reader(m["name"])(empty) is None, m["name"]


def test_per_layer_moves_a_reported_metric(definition):
    e2e = {m["name"]: m for m in definition["end_to_end"]}
    for m in definition["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", []):
            assert w in target.get("workloads", [w]), (m["name"], w)


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_every_config_names_a_generator_and_a_test_size(definition):
    for c in definition["configs"]:
        conf = _config(c["name"])
        assert os.path.exists(os.path.join(
            HERE, "scenes", f"{conf['scene']['generator']}.py"))
        assert set(conf["test_scene"]) <= set(conf["scene"])
        assert set(conf["reduced"]) == set(c["reduced"])
        for inst in bench.layout(conf)[-1:]:
            assert inst["material"] in conf["materials"]


def test_tetra_scene_counts():
    layout = bench.layout(_config("tetra-visit"))
    assert [i["mesh"] for i in layout] == ["tetra", "lamp"]
    assert len(layout[0]["faces"]) == 4 ** 9 == 262_144
    assert 262_144 % layout[0]["group"] == 0


def test_tetra_faces_point_outward():
    tetra = bench.plugin("scenes", "spd_tetra")
    layout = tetra.layout({"size_factor": 2, "group": 16, "material": "m"})
    v = layout[0]["pos"][layout[0]["faces"]].astype(np.float64)
    centres, _ = tetra.tetrahedra(2)
    centres = centres @ tetra.up_rotation().T
    g = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    mid = v.mean(1) - np.repeat(centres, 4, axis=0)
    assert ((g * mid).sum(-1) > 0).all()
    # the apex is up: the top vertex sits on the y axis
    top = v.reshape(-1, 3)[v.reshape(-1, 3)[:, 1].argmax()]
    assert abs(top[0]) < 1e-5 and abs(top[2]) < 1e-5


def test_sphereflake_scene_counts():
    layout = bench.layout(_config("sphereflake-tlas"))
    meshes = [i["mesh"] for i in layout]
    assert len(layout) == 824 and meshes.count("sphere") == 820
    assert set(meshes) == {"sphere", "ground", "lamp0", "lamp1", "lamp2"}
    assert geometry.triangle_count(layout) == 820 * 1280 + 2 + 3 * 2
    assert sum(i["movable"] for i in layout) == 10


def test_sphereflake_children_touch_their_parents():
    flake = bench.plugin("scenes", "spd_sphereflake")
    spheres = flake.spheres(2)
    assert len(spheres) == 1 + 9 + 81
    dirs = flake.child_directions()
    assert np.allclose(np.linalg.norm(dirs, axis=1), 1.0)
    assert sorted(np.round(dirs[:, 2], 4).tolist()).count(0.0) == 6
    root_c, root_r, _ = spheres[0]
    for c, r, g in spheres[1:10]:
        assert g == 1 and r == pytest.approx(root_r / 3)
        assert np.linalg.norm(c - root_c) == pytest.approx(root_r + r)


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def _imports(path):
    """Top-level names of the modules ``path`` imports (absolute ones;
    relative imports as ``.``)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


def _sources(*parts):
    base = os.path.join(HERE, *parts)
    for dirpath, _, files in os.walk(base):
        if ".cache" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & {"jax", "jaxlib", "flax", "rfw_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_no_program():
    """The reference and the benchmark modules it imports name none of
    jax, rfw_tpu or rfw_tpu_torch."""
    paths = list(_sources("reference")) + list(_sources("scenes")) + [
        os.path.join(HERE, "lib", "geometry.py")]
    for path in paths:
        bad = _imports(path) & {"jax", "jaxlib", "flax", "rfw_tpu",
                                "rfw_tpu_torch"}
        assert not bad, (path, bad)


def test_import_rule_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import rfw_tpu_torch.system\nfrom rfw_tpu.ops import x\n")
    assert _imports(str(p)) == {"rfw_tpu_torch", "rfw_tpu"}


def test_run_refuses_without_a_card():
    """Without a CUDA card run.py exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "tetra-visit.converge", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_json_is_small():
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        json.load(f)
