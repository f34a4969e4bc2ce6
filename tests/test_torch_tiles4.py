"""The benchmark's four-card deployment ``tetra-tiles4`` (BASELINE config 5:
four row-block tiles, one card a tile, the frame gathered on the home
card) on the CPU, at the configuration's ``test_scene`` size and 32 x 18
pixels: the definition takes the cell, a small run of
``tetra-tiles4.converge`` through the harness is correct against the
plain reference and fails with the bfloat16 control or a tile traced at
another tile's pixels, the tile layer's and the driver's counters, and
the readers of ``lane_fill`` and ``cards_busy_at_once``."""

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.lib import bench, program
from perfbench.lib.trace import Trace
from perfbench.tests import small

CELL = "tetra-tiles4.converge"


@pytest.fixture(scope="module")
def spec():
    return bench.cell(bench.load(), CELL)


def test_the_definition_takes_the_cell(spec):
    assert bench.problems(bench.load()) == []
    assert spec["workload"]["chips"] == 4
    assert spec["config"]["render"]["n_devices"] == 4
    names = {m["name"] for m in spec["per_layer"]}
    assert {"lane_fill", "cards_busy_at_once", "intersect_roofline",
            "launches_per_sample", "device_idle.converge",
            "host_syncs_per_sample", "dispatch_ms_per_sample"} <= names
    assert {m["name"] for m in spec["end_to_end"]} == {
        "setup_s", "ms_per_sample", "peak_mem_gib"}
    one_card = bench.cell(bench.load(), "tetra-visit.converge")
    for key in ("scene", "materials", "lamps", "sky", "camera", "engine",
                "intersector", "width", "height", "test_scene"):
        assert spec["config"][key] == one_card["config"][key], key
    assert spec["config"]["render"] == dict(one_card["config"]["render"],
                                            n_devices=4)


# the harness refuses a process that loaded JAX, as this one has (the
# tests' conftest imports it): each run is a fresh process
RUN = """
import json, sys
from perfbench.tests import small
if sys.argv[1] == "tile_offset":
    from rfw_tpu_torch.parallel import tiles
    Driver = tiles.WavefrontDriver

    def shifted(*a, n_pixels=None, pixel_offset=0, **kw):
        if pixel_offset == n_pixels:       # tile 1 at tile 0's pixels
            pixel_offset = 0
        return Driver(*a, n_pixels=n_pixels, pixel_offset=pixel_offset, **kw)

    tiles.WavefrontDriver = shifted
line = small.run("%s", control=sys.argv[1] == "control")
print(json.dumps(line["checks"]))
print(json.dumps(line["correct"]))
""" % CELL


def _small_run(what):
    out = subprocess.run([sys.executable, "-c", RUN, what],
                         capture_output=True, text=True, timeout=600,
                         cwd=bench.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    checks, correct = out.stdout.strip().splitlines()[-2:]
    return json.loads(checks), json.loads(correct)


def test_small_run_is_correct():
    checks, correct = _small_run("program")
    assert correct is True
    assert set(checks) == {"closest_mismatch", "anyhit_mismatch", "frame_l1"}
    assert checks["frame_l1"]["value"] == 0.0
    for name, c in checks.items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("fault", ["control", "tile_offset"])
def test_the_check_fails_a_fault(fault):
    """The reference in bfloat16 in the program's place, and tile 1 traced
    with tile 0's ``pixel_offset`` (tile 0's pixels in tile 1's rows),
    each come out not correct, by the frame."""
    checks, correct = _small_run(fault)
    assert correct is False
    assert checks["frame_l1"]["value"] > checks["frame_l1"]["limit"]


# ---------------------------------------------------------------------------
# the counters, from a render through the port's API
# ---------------------------------------------------------------------------

SAMPLES = 2


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _render(spec, tmp_path, n_devices):
    """A RESET frame of ``SAMPLES`` samples of the cell's small scene with
    ``n_devices`` tiles, its spans and counters recorded: (counters, the
    system, the view's bytes)."""
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.system import RenderSystem
    from rfw_tpu_torch.utils import tracing
    conf = {**spec["config"], **small.overrides(spec)["config"]}
    conf["render"] = dict(conf["render"], n_devices=n_devices)
    rs = RenderSystem(conf["engine"], RenderConfig(**conf["render"]),
                      device="cpu")
    rs.set_setting("intersector", conf["intersector"])
    program.build(rs, conf, bench.layout(conf), str(tmp_path))
    program.place_camera(rs, conf, conf["camera"]["eye"])
    rs.synchronize()
    view = rs.camera.get_view().as_pytree()
    tracing.clear()
    try:
        with tracing.recording():
            rs.render_frame(samples=SAMPLES)
        counters = tracing.snapshot().counters
    finally:
        tracing.clear()
    return counters, rs, sum(np.asarray(v, np.float32).nbytes
                             for v in view.values())


@pytest.fixture
def no_cache(monkeypatch):
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")


def test_tile_counters_on_one_device(spec, tmp_path, no_cache):
    """Four tiles on the CPU: each tile counted once a sample, and no byte
    moves (every tile is on the home device)."""
    counters, _, _ = _render(spec, tmp_path, 4)
    assert counters["tiles.tiles"] == 4 * SAMPLES
    assert counters["tiles.scatter_bytes"] == 0
    assert counters["tiles.gather_bytes"] == 0
    assert counters.get("tiles.replica_bytes", 0) == 0


def test_tile_bytes_over_four_devices(spec, tmp_path, no_cache, monkeypatch):
    """Four tiles on four devices none of which is the home device (CPU
    devices of their own index: ``.to`` copies to each): the bytes are
    what the shapes give. Each sample sends every tile its rows (n_local
    x 3 float32) and the view, and brings back every tile's rows and the
    probe (3 float32; no aux planes without the denoiser); the scene goes
    to each device once."""
    from rfw_tpu_torch.render import engines
    monkeypatch.setattr(engines, "make_tile_mesh", lambda n, device: tuple(
        torch.device("cpu", i) for i in range(n)))
    counters, rs, view_bytes = _render(spec, tmp_path, 4)
    n_local = 32 * 18 // 4
    rows = n_local * 3 * 4
    assert counters["tiles.tiles"] == 4 * SAMPLES
    assert counters["tiles.scatter_bytes"] == SAMPLES * 4 * (rows
                                                             + view_bytes)
    assert counters["tiles.gather_bytes"] == SAMPLES * (4 * rows + 3 * 4)
    scene_bytes = sum(t.nbytes for t in _tensors(rs._context._scene))
    assert scene_bytes > 0
    assert counters["tiles.replica_bytes"] == 4 * scene_bytes


def test_lane_counters_tiled_and_untiled(spec, tmp_path, no_cache):
    """The live set is keyed by pixel, so the four tiles' live lanes add up
    to the one-driver frame's; each tile pads its own live lanes to whole
    chunks, so it runs at least as many."""
    tiled, _, _ = _render(spec, tmp_path, 4)
    untiled, _, _ = _render(spec, tmp_path, 0)
    assert "tiles.tiles" not in untiled
    assert tiled["driver.lanes_live"] == untiled["driver.lanes_live"] > 0
    assert tiled["driver.lanes_run"] >= untiled["driver.lanes_run"]
    assert untiled["driver.lanes_run"] >= untiled["driver.lanes_live"]


# ---------------------------------------------------------------------------
# the readers of the two metrics
# ---------------------------------------------------------------------------

def _kernel(ts, dur, card):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {"device": card}}


def _traced(events, n_devices):
    tr = Trace([{"ph": "X", "cat": "user_annotation",
                 "name": "perfbench::iteration", "ts": 0, "dur": 1000}]
               + events)
    return SimpleNamespace(trace=tr, window=tr.window("iteration"),
                           config={"render": {"n_devices": n_devices}})


@pytest.mark.parametrize("events,n_devices,want", [
    # four cards in turn, 100 us each
    ([_kernel(100 * i, 100, i) for i in range(4)], 4, 1.0),
    # four cards at once: 400 busy seconds over 100
    ([_kernel(100, 100, i) for i in range(4)], 4, 4.0),
    # two overlapping kernels of one card: its merged time over itself
    ([_kernel(100, 200, 0), _kernel(250, 150, 0)], None, 1.0),
    # half overlapped: 200 + 200 us of card time over 300 us
    ([_kernel(0, 200, 0), _kernel(100, 200, 1)], 4, 4.0 / 3.0),
    # ops of a card outside the set are not read
    ([_kernel(0, 200, 0), _kernel(0, 200, 1)], 1, 1.0),
])
def test_cards_busy_at_once(events, n_devices, want):
    got = bench.reader("cards_busy_at_once")(_traced(events, n_devices))
    assert got == pytest.approx(want)
    if want == 1.0:
        assert got == 1.0


def test_cards_busy_at_once_reads_nothing_untraced():
    read = bench.reader("cards_busy_at_once")
    assert read(SimpleNamespace(config={"render": {}})) is None
    assert read(_traced([], 4)) is None


@pytest.mark.parametrize("counters,want", [
    ({"driver.lanes_run": 1000, "driver.lanes_live": 250}, 25.0),
    ({"driver.lanes_run": 144, "driver.lanes_live": 144}, 100.0),
    ({"samples": 4}, None),
    ({"driver.lanes_run": 0, "driver.lanes_live": 0}, None),
])
def test_lane_fill(monkeypatch, counters, want):
    from perfbench.lib import spans
    from rfw_tpu_torch.utils.tracing import Snapshot
    monkeypatch.setattr(spans, "snapshot",
                        lambda run: Snapshot([], counters))
    assert bench.reader("lane_fill")(SimpleNamespace(trace=object())) == want


def test_lane_fill_reads_nothing_untraced():
    assert bench.reader("lane_fill")(SimpleNamespace()) is None
