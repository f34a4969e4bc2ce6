"""Runs of the harness at a test's size on the CPU: the result line's
form, the window's totals, the traced reductions, and the check, which
the control and every planted fault have to fail."""

import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.lib import bench, loop as loop_lib
from perfbench.lib.trace import Trace

from . import small

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line_has_the_contract_keys():
    line = small.run("tetra-visit.converge")
    assert list(line) == LINE_KEYS + ["checks"]
    assert set(line["metrics"]) == {"setup_s", "ms_per_sample",
                                    "peak_mem_gib"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"] is True
    json.dumps(line)


def test_traced_line_has_the_contract_keys():
    line = small.run("sphereflake-tlas.converge", trace=True)
    assert list(line) == LINE_KEYS + ["breakdown", "checks"]
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["correct"] is True


def test_window_is_every_iteration_over_all_the_work():
    """``window`` runs whole iterations until the time is up and returns
    all of the time and all of the work: the metric is their ratio."""
    class Stub(loop_lib.Loop):
        def iteration(self):
            time.sleep(0.03)
            return 4

    loop = Stub(None, None, None, {}, 0, torch.device("cpu"), None)
    elapsed, done = loop.window(0.1)
    assert done % 4 == 0 and done >= 16
    assert elapsed >= 0.1
    assert elapsed * 1000.0 / done == pytest.approx(7.5, rel=0.3)


def test_ms_per_sample_covers_the_window():
    line = small.run("tetra-visit.converge", seconds=2.0)
    ms = line["metrics"]["ms_per_sample"]["value"]
    assert ms * line["attempted"] / 1000.0 >= 2.0
    assert line["attempted"] % 4 == 0


def test_edit_ms_covers_the_window():
    line = small.run("sphereflake-tlas.edit", seconds=1.0)
    ms = line["metrics"]["edit_ms"]["value"]
    assert ms * line["attempted"] / 1000.0 >= 1.0
    assert line["checks"]["update_gap"]["value"] == 0.0
    assert {"moved_ray_mismatch", "moved_frame_l1"} <= set(line["checks"])
    assert line["correct"] is True


@pytest.mark.parametrize("count", [1, 2, 3, 4, 7, 40])
def test_edits_leave_every_touched_instance_moved(count):
    """Whatever the number of edits, each instance an edit touched ends
    away from its place: at least ``min_offset`` times its scale."""
    from perfbench.lib import check
    spec = bench.cell(bench.load(), "sphereflake-tlas.edit")
    conf = dict(spec["config"])
    conf["scene"] = {**conf["scene"], **conf["test_scene"]}
    layout = bench.layout(conf)
    edit = bench.plugin("loops", "edit").Loop(
        None, None, layout, spec["traffic"], small.SEED + count,
        torch.device("cpu"), None)
    offset: dict = {}
    moves = [edit.move(i, offset) for i in range(count)]
    final = check.translations_at(layout, moves, count)
    assert final
    for inst, tr in final.items():
        gap = np.linalg.norm(tr - layout[inst]["translation"])
        assert gap >= 0.999 * spec["traffic"]["min_offset"] \
            * layout[inst]["scale"][0]


def _event(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_intersect_roofline_byte_floor():
    """Two calls on the flat slice (1,000 closest rays, 500 any-hit rays):
    the floor is 1,000 x 44 + 500 x 29 bytes plus two calls of the
    scene's triangles at 36 B, over 3.35 TB/s; the time is that of the
    kernels launched inside the ranges only."""
    events = [
        _event("user_annotation", "perfbench::intersect", 0, 100),
        _event("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        _event("kernel", "visit_kernel", 20, 400, corr=1),
        _event("user_annotation", "perfbench::intersect", 1000, 100),
        _event("cuda_runtime", "cudaLaunchKernel", 1050, 2, corr=2),
        _event("kernel", "visit_kernel", 1100, 600, corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 2000, 2, corr=3),
        _event("kernel", "mul", 2010, 5000, corr=3),
    ]
    conf = {"intersector": "visit"}
    layout = [{"mesh": "a", "faces": np.zeros((300, 3))},
              {"mesh": "lamp", "faces": np.zeros((2, 3))}]
    run = SimpleNamespace(trace=Trace(events),
                          live_rays=[("closest", 1000), ("any", 500)],
                          calls_traced=2, config=conf, layout=layout)
    got = bench.reader("intersect_roofline")(run)
    nbytes = 1000 * 44 + 500 * 29 + 2 * 36 * 302
    assert got == pytest.approx(100.0 * nbytes / 3.35e12 / 1000e-6)


def test_intersect_roofline_tlas_floor_counts_each_mesh_once():
    read = bench.reader("intersect_roofline")
    events = [_event("user_annotation", "perfbench::intersect", 0, 10),
              _event("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=7),
              _event("kernel", "tlas_walk_kernel", 5, 100, corr=7)]
    layout = ([{"mesh": "sphere", "faces": np.zeros((80, 3))}] * 60
              + [{"mesh": "ground", "faces": np.zeros((2, 3))}])
    run = SimpleNamespace(trace=Trace(events), live_rays=[("closest", 10)],
                          calls_traced=1, config={"intersector": "tlas"},
                          layout=layout)
    nbytes = 10 * 44 + 36 * (80 + 2) + 72 * 61
    assert read(run) == pytest.approx(100.0 * nbytes / 3.35e12 / 100e-6)


def test_idle_and_launches_from_a_trace():
    events = [_event("user_annotation", "perfbench::iteration", 0, 1000),
              _event("kernel", "a", 100, 200, corr=1),
              _event("kernel", "b", 250, 150, corr=2),
              _event("gpu_memcpy", "Memcpy DtoH", 600, 100),
              _event("user_annotation", "perfbench::dispatch", 0, 1000),
              _event("user_annotation", "perfbench::update", 420, 170),
              _event("cpu_op", "aten::copy_", 410, 190),
              _event("cpu_op", "aten::add", 0, 90)]
    tr = Trace(events)
    window = tr.window("iteration")
    busy = tr.busy(window)
    assert busy == [[100, 400], [600, 700]]
    run = SimpleNamespace(trace=tr, window=window, work_traced=4,
                          busy_s=400e-6, window_s=1000e-6)
    assert bench.reader("device_idle.converge")(run) == pytest.approx(60.0)
    assert bench.reader("launches_per_sample")(run) == 0.5
    gaps = tr.breakdown(window)["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 200e-6, 100e-6])
    assert [g[0] for g in gaps] == ["dispatch/python", "update/aten::copy_",
                                    "dispatch/aten::add"]


# ---------------------------------------------------------------------------
# the check: the control and the planted faults come out not correct
# ---------------------------------------------------------------------------

def _fails(line):
    return line["correct"] is False


@pytest.mark.parametrize("workload", ["tetra-visit.converge",
                                      "sphereflake-tlas.edit"])
def test_control_is_not_correct(workload):
    """The reference in bfloat16, in the program's place, comes out not
    correct through the harness's own verdict."""
    assert _fails(small.run(workload, control=True))


def test_fault_state_unchanged(monkeypatch):
    """A sample step that hands back the accumulator it was given."""
    from rfw_tpu_torch.render import wavefront_driver
    orig = wavefront_driver.WavefrontDriver.step_multi

    def stale(self, scene, accumulator, *a, **kw):
        out = orig(self, scene, accumulator.clone(), *a, **kw)
        return (accumulator,) + tuple(out[1:])

    monkeypatch.setattr(wavefront_driver.WavefrontDriver, "step_multi", stale)
    assert _fails(small.run("tetra-visit.converge"))


def _wrap_closest(monkeypatch, fn):
    from rfw_tpu_torch.render import intersectors
    orig = intersectors.make_intersector

    def make(name, cfg):
        isect = orig(name, cfg)

        def closest(scene, o, d, t_max=None, sort=True, coherent=False):
            return fn(*isect.closest(scene, o, d, t_max, sort=sort,
                                     coherent=coherent))
        return type(isect)(closest, isect.occluded)

    from rfw_tpu_torch.render import engines
    monkeypatch.setattr(engines, "make_intersector", make)


def test_fault_half_the_batch_left_out(monkeypatch):
    """The intersector answers only the first half of each call's rays."""
    def half(t, prim, u, v):
        n = t.shape[0] // 2
        t, prim = t.clone(), prim.clone()
        t[n:], prim[n:] = 1e30, -1
        return t, prim, u, v
    _wrap_closest(monkeypatch, half)
    assert _fails(small.run("sphereflake-tlas.converge"))


def test_fault_answer_altered(monkeypatch):
    """Every closest hit moved 1 % further out where it is produced."""
    _wrap_closest(monkeypatch,
                  lambda t, prim, u, v: (t * 1.01, prim, u, v))
    assert _fails(small.run("tetra-visit.converge"))


@pytest.mark.parametrize("seconds", [1.0, 2.0])
def test_fault_edit_lost(monkeypatch, seconds):
    """An instance move that never reaches the scene, whatever the number
    of edits in the window."""
    from rfw_tpu_torch import refs
    monkeypatch.setattr(refs.InstanceRef, "translate", lambda self, off: None)
    assert _fails(small.run("sphereflake-tlas.edit", seconds=seconds))


def test_fault_tlas_left_stale(monkeypatch):
    """A move that updates the world triangles but leaves the TLAS's
    instance tables as they were: the device update takes the scene's
    TLAS tables in place of those ``_moved_tlas`` makes again."""
    from rfw_tpu_torch.render import scene_data
    monkeypatch.setattr(scene_data, "_moved_tlas",
                        lambda scene, instances: scene["tlas"])
    line = small.run("sphereflake-tlas.edit")
    assert line["checks"]["update_gap"]["value"] == 0.0
    assert _fails(line)


@pytest.mark.card
@pytest.mark.parametrize("workload", bench.load()["workloads"],
                         ids=lambda w: w["name"])
def test_a_cell_on_the_card(workload):
    """One short run of each cell through run.py on the card: exit 0, a
    correct line, one card counted a card of the cell. A cell that asks
    for more cards than the machine has skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < workload["chips"]:
        pytest.skip(f"{workload['name']} needs {workload['chips']} cards; "
                    f"this machine has {torch.cuda.device_count()}")
    out = subprocess.run(
        [sys.executable, os.path.join(bench.HERE, "run.py"),
         "--workload", workload["name"], "--seed", str(small.SEED),
         "--seconds", "2", "--trace", "0"], capture_output=True,
        text=True, timeout=1200, cwd=bench.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert math.isfinite(line["metrics"]["setup_s"]["value"])
    assert np.isfinite(line["device"]["memory_peak_bytes"])
    assert line["device"]["count"] == workload["chips"]
