"""The port's spans and counters (``rfw_tpu_torch/utils/tracing.py``) on
the CPU: off they do nothing a frame could show, on they nest as the
layers do, in memory and in a profiler's trace, and the counters count
what the program holds on the host.

The scene is the Cornell box of ``chip_smoke.make_cornell`` at 64 × 32
pixels with ``max_rays_per_pass`` 1024: two chunks, so that the
``wavefront`` engine runs the compacted driver."""

import collections
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from chip_smoke import make_cornell

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.system import RenderSystem
from rfw_tpu_torch.utils import tracing

W, H = 64, 32


@pytest.fixture(autouse=True)
def _fresh():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_scene_cache(monkeypatch):
    monkeypatch.setenv("RFW_NO_SCENE_CACHE", "1")


def cornell(intersector="visit", **cfg):
    rs = make_cornell(RenderSystem(
        "wavefront", RenderConfig(max_rays_per_pass=1024, **cfg),
        device="cpu"), W)
    rs.camera.resize(W, H)
    rs.set_setting("intersector", intersector)
    return rs


def names(snap):
    return [s.name for s in snap.spans]


def lanes_run(snap):
    """What ``driver.lanes_run`` should read: one chunk of 1024 lanes for
    each ``driver.stage`` of a depth from 1 on."""
    n = RenderConfig().max_path_length + 1
    depths = [i for i, s in enumerate(snap.spans) if s.name == "driver.depth"]
    level = {i: k % n for k, i in enumerate(depths)}
    return 1024 * sum(level[s.parent] > 0 for s in snap.spans
                      if s.name == "driver.stage")


def parent_name(snap, s):
    return snap.spans[s.parent].name if s.parent >= 0 else None


def test_spans_nest_and_counters_add_under_recording():
    with tracing.recording():
        with tracing.span("a"):
            with tracing.span("b"):
                tracing.count("n", 3)
            tracing.count("n")
        with tracing.span("c"):
            pass
    tracing.count("n", 100)                      # off again
    snap = tracing.snapshot()
    assert names(snap) == ["a", "b", "c"]
    assert [s.parent for s in snap.spans] == [-1, 0, -1]
    assert all(s.start_ns <= s.end_ns for s in snap.spans)
    a, b, _ = snap.spans
    assert a.start_ns <= b.start_ns and b.end_ns <= a.end_ns
    assert snap.counters == {"n": 4}
    tracing.clear()
    assert tracing.snapshot() == ([], {})


def test_threads_record_their_own_nesting_and_lose_no_count():
    n_threads, n = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for _ in range(n):
            with tracing.span(f"t{k}"):
                with tracing.span(f"t{k}.inner"):
                    tracing.count("n")

    try:
        with tracing.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = tracing.snapshot()
    assert snap.counters == {"n": n_threads * n}
    assert len(snap.spans) == 2 * n_threads * n
    for s in snap.spans:
        if s.name.endswith(".inner"):
            assert parent_name(snap, s) == s.name[:-len(".inner")]
        else:
            assert s.parent == -1


def test_off_is_one_shared_null_context_and_a_timed_span_still_times():
    assert tracing.span("a") is tracing.span("b")
    assert tracing.count("a", 5) is None
    with tracing.span("t", timed=True) as sp:
        pass
    assert sp.seconds >= 0.0 and sp.end_ns >= sp.start_ns > 0
    assert tracing.snapshot() == ([], {})


def test_off_enters_no_record_function_and_changes_no_frame(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("record_function entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    off = cornell().render_frame(samples=2)
    assert tracing.snapshot() == ([], {})
    with tracing.recording():
        on = cornell().render_frame(samples=2)
    assert "engine.render" in names(tracing.snapshot())
    assert np.array_equal(off, on)


def _ranges(path):
    """(name, tid, start, end) of every ``rfw::`` range in a Chrome
    trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][len(tracing.PREFIX):], e["tid"], e["ts"],
             e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X"
            and e.get("name", "").startswith(tracing.PREFIX)]


def _nested(ranges, inner, outer):
    """Whether some range ``inner`` lies inside some range ``outer``."""
    return any(o[1] == i[1] and o[2] <= i[2] and i[3] <= o[3]
               for i in ranges if i[0].startswith(inner)
               for o in ranges if o[0] == outer)


def test_profiler_trace_holds_the_spans_nested(tmp_path):
    rs = cornell()
    rs.render_frame(samples=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rs.render_frame(samples=2)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ranges = _ranges(path)
    assert _nested(ranges, "driver.depth", "engine.render")
    assert _nested(ranges, "sync.", "driver.compact")
    assert _nested(ranges, "isect.closest", "driver.stage")
    assert _nested(ranges, "sync.stats", "engine.finish_frame")
    # the in-memory spans are the trace's ranges
    snap = tracing.snapshot()
    assert sorted(names(snap)) == sorted(r[0] for r in ranges)
    assert snap.counters["samples"] == 2


def test_profiler_warm_up_step_records_nothing():
    rs = cornell()
    rs.render_frame(samples=1)
    seen = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            rs.render_frame(samples=1)
            seen.append(tracing.snapshot())
            prof.step()
    assert seen[0] == ([], {})
    assert "engine.render" in names(seen[1])
    # on the CPU each NEE and extension step of the frame runs the plain
    # version; the driver counts the lanes of depths 1 and up, and the
    # live ones among them
    live = seen[1].counters.get("driver.lanes_live", 0)
    assert seen[1].counters == {
        "samples": 1, "nee.plain": names(seen[1]).count("stage.nee"),
        "extend.plain": names(seen[1]).count("stage.extend"),
        "driver.lanes_run": lanes_run(seen[1]), "driver.lanes_live": live}
    assert 0 < live <= lanes_run(seen[1])


@pytest.mark.parametrize("samples", [1, 3])
def test_sync_sites_of_a_wavefront_frame(samples):
    """With the brute-force intersector (no host read of its own), a
    frame waits for the device at: the view's upload, one live count a
    compaction (``max_path_length`` a sample: the box keeps live lanes at
    every depth), the probe's read in each chunk of depth 0, the Disney
    BSDF's constant in each chunk that samples an extension (every depth
    but the last; the plain extension, which CPU lanes take), and the
    frame's three (the wait, the stats and probe, the frame)."""
    rs = cornell("brute")
    rs.render_frame(samples=1)
    tracing.clear()
    with tracing.recording():
        rs.render_frame(samples=samples)
    snap = tracing.snapshot()
    depth = RenderConfig().max_path_length
    chunks = W * H // 1024
    depths = [i for i, s in enumerate(snap.spans) if s.name == "driver.depth"]
    assert len(depths) == samples * (depth + 1)
    level = {i: k % (depth + 1) for k, i in enumerate(depths)}
    stages = [level[s.parent] for s in snap.spans if s.name == "driver.stage"]
    assert stages.count(0) == samples * chunks
    want = {"sync.view": 1, "sync.finish": 1, "sync.stats": 1,
            "sync.frame": 1, "sync.compact": samples * depth,
            "sync.probe": samples * chunks,
            "sync.disney_const": sum(d < depth for d in stages)}
    got = collections.Counter(s.name for s in snap.spans
                              if s.name.startswith("sync."))
    assert got == want
    live = snap.counters.get("driver.lanes_live", 0)
    assert snap.counters == {"samples": samples,
                             "nee.plain": names(snap).count("stage.nee"),
                             "extend.plain": names(snap).count("stage.extend"),
                             "driver.lanes_run": 1024 * sum(d > 0
                                                            for d in stages),
                             "driver.lanes_live": live}
    assert 0 < live <= snap.counters["driver.lanes_run"]
    assert lanes_run(snap) == snap.counters["driver.lanes_run"]
    # on the CPU the plain extension makes the Disney constant: one wait a
    # stage.extend span
    assert names(snap).count("stage.extend") == want["sync.disney_const"]
    assert all(parent_name(snap, s) == "driver.compact" for s in snap.spans
               if s.name == "sync.compact")
    assert names(snap).count("isect.closest") == len(stages)


def test_visit_passes_read_inside_the_intersector():
    rs = cornell("visit")
    rs.render_frame(samples=1)
    tracing.clear()
    with tracing.recording():
        rs.render_frame(samples=1)
    snap = tracing.snapshot()
    passes = [s for s in snap.spans if s.name == "sync.visit_pass"]
    calls = [i for i, s in enumerate(snap.spans)
             if s.name.startswith("isect.")]
    assert {parent_name(snap, s) for s in passes} == {
        "isect.closest", "isect.occluded"}
    # every call reads at least once: the all-finished test of its first
    # pass
    assert {s.parent for s in passes} == set(calls)



def test_tvisit_route_span_and_counters(monkeypatch):
    """Under ``tvisit`` each scattered call's route is one
    ``isect.tvisit`` span in its ``isect.closest`` or ``isect.occluded``
    span, counted by ``tvisit.calls``, with the rays handed to it in
    ``tvisit_rays.<kind>``; coherent calls (the primary rays) take
    ``visit`` and neither. ``tvisit.passes`` counts the route's passes:
    one ``sync.visit_pass`` read each, and one more where a call ends by
    that read."""
    from rfw_tpu_torch.ops import tvisit_intersect
    handed = collections.Counter()
    for fn, kind in (("closest_hit", "closest"), ("any_hit", "any")):
        orig = getattr(tvisit_intersect, fn)

        def spy(scene, o, *a, _orig=orig, _kind=kind, **kw):
            handed[_kind] += o.shape[0]
            return _orig(scene, o, *a, **kw)

        monkeypatch.setattr(tvisit_intersect, fn, spy)
    rs = cornell("tvisit")
    rs.render_frame(samples=1)
    tracing.clear()
    handed.clear()
    with tracing.recording():
        rs.render_frame(samples=1)
    snap = tracing.snapshot()
    route = [i for i, s in enumerate(snap.spans) if s.name == "isect.tvisit"]
    assert route
    assert {parent_name(snap, snap.spans[i]) for i in route} == {
        "isect.closest", "isect.occluded"}
    calls = [i for i, s in enumerate(snap.spans)
             if s.name in ("isect.closest", "isect.occluded")]
    assert len(route) < len(calls)          # the coherent calls
    c = snap.counters
    assert c["tvisit.calls"] == len(route)
    assert (c["tvisit_rays.closest"], c["tvisit_rays.any"]) == (
        handed["closest"], handed["any"])
    reads = [s for s in snap.spans if s.name == "sync.visit_pass"
             and s.parent in route]
    assert c["tvisit.passes"] <= len(reads) <= c["tvisit.passes"] + len(route)
    assert c["tvisit.passes"] >= 1

def _tlas_scene():
    rs = RenderSystem("wavefront", RenderConfig(max_rays_per_pass=1024),
                      device="cpu")
    rs.set_setting("intersector", "tlas")
    white = rs.add_material([0.7] * 3)
    lamp = rs.add_material([15.0] * 3)
    floor = rs.add_quad([0, 1, 0], [0, 0, 0], 6.0, 6.0, white)
    box = rs.add_quad([0, 0, -1], [0, 1, 0], 1.0, 1.0, white)
    rs.add_instance(floor)
    refs = [rs.add_instance(box, translation=(x, 0.0, 0.0))
            for x in (-1.5, 1.5)]
    rs.add_instance(rs.add_quad([0, -1, 0], [0, 4, 0], 1.0, 1.0, lamp))
    rs.camera.resize(W, H)
    rs.camera.look_at([0, 2.0, -6.0], [0, 0.5, 0])
    return rs, refs


def test_an_instance_move_counts_one_update_and_its_upload(monkeypatch):
    rs, refs = _tlas_scene()
    rs.render_frame(samples=1)
    refs[0].translate([0.0, 0.1, 0.0])       # the first move's planes
    rs.synchronize()
    handed = []
    upload = scene_data.scene_to_torch

    def spy(scene_np, device):
        handed.append(scene_np)
        return upload(scene_np, device)

    monkeypatch.setattr(scene_data, "scene_to_torch", spy)
    tracing.clear()
    with tracing.recording():
        refs[0].translate([0.0, 0.25, 0.0])
        rs.synchronize()
    snap = tracing.snapshot()
    assert names(snap).count("scene.retransform") == 1
    assert names(snap).count("engine.update") == 1
    assert snap.counters["updates"] == snap.counters["device_moves"] == 1
    for child in ("scene.instance_tables", "scene.upload",
                  "scene.transform"):
        (s,) = [s for s in snap.spans if s.name == child]
        assert parent_name(snap, s) == "scene.retransform"
    (rt,) = [s for s in snap.spans if s.name == "scene.retransform"]
    assert parent_name(snap, rt) == "engine.update"
    assert names(snap).count("system.synchronize") == 1
    assert parent_name(snap, snap.spans[rt.parent]) == "system.synchronize"

    def arrays(x, key=""):
        if key.startswith("_"):
            return
        if isinstance(x, dict):
            for k, v in x.items():
                yield from arrays(v, k)
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from arrays(v)
        elif isinstance(x, np.ndarray):
            yield x

    (moved,) = handed                    # move_instances_device's one
    sent = list(arrays(moved))
    assert {a.dtype.itemsize for a in sent} == {4}
    assert snap.counters["upload_bytes"] == sum(a.nbytes for a in sent)
    # an instance's transform row (21 floats) and its instance tables
    # (inverse, world box, triangle offset: 23 more), no plane
    n_inst = len(rs.context._instances)
    assert moved["xf"].shape == (n_inst, 21)
    assert snap.counters["upload_bytes"] == (21 + 16 + 6 + 1) * 4 * n_inst
