"""The harness over a card set of several cards, on the CPU: a tiled
configuration (``render.n_devices``) through the harness and the
reference, the per-card trace reduction, the capture's generators, the
peak memory over the cards, the waits, and the rule that ties a cell's
``chips`` to its configuration's tiles."""

import json

import numpy as np
import pytest
import torch

from perfbench.lib import bench, harness, loop as loop_lib, peaks
from perfbench.lib.trace import Trace
from perfbench.reference import tracer

from . import small

TILES = {"n_devices": 4}


# ---------------------------------------------------------------------------
# a tiled configuration through the harness and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_tiled_run_is_correct(trace):
    """Four row-block tiles on the CPU mesh: the frame and the rays equal
    the reference's, which takes ``n_devices`` as a schedule."""
    line = small.run("tetra-visit.converge", trace=trace, render=TILES)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["frame_l1"]["value"] == 0.0
    assert line["device"]["count"] == 1


def test_tiled_run_with_a_tile_zeroed_fails(monkeypatch):
    """The gather takes tile 1's rows as zeros: the check fails."""
    from rfw_tpu_torch.parallel import tiles
    orig = tiles._gather

    def zeroed(parts, device):
        parts = list(parts)
        parts[1] = torch.zeros_like(parts[1])
        return orig(parts, device)

    monkeypatch.setattr(tiles, "_gather", zeroed)
    line = small.run("tetra-visit.converge", render=TILES)
    assert line["correct"] is False


@pytest.mark.parametrize("render,ok", [
    ({"n_devices": 4}, True), ({"n_devices": 4, "max_rays_per_pass": 144},
                               True),
    ({"n_devices": 4, "no_such_setting": 1}, False)])
def test_reference_takes_the_tiles_as_a_schedule(render, ok):
    spec = bench.cell(bench.load(), "tetra-visit.converge")
    conf = {**spec["config"], **small.overrides(spec)["config"]}
    conf["render"] = dict(conf["render"], **render)
    layout = bench.layout(conf)
    eye = conf["camera"]["eye"]
    if ok:
        sc = tracer.Scene(conf, layout, {}, eye, "cpu")
        assert sc.settings["n_devices"] == 4
    else:
        with pytest.raises(ValueError, match="no_such_setting"):
            tracer.Scene(conf, layout, {}, eye, "cpu")


# ---------------------------------------------------------------------------
# the trace over several cards
# ---------------------------------------------------------------------------

def _ev(cat, name, ts, dur, device=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if device is not None:
        ev["args"] = {"device": device}
    return ev


def test_busy_per_card_and_the_mean():
    """Card 0 busy 100-400 (two overlapping kernels) and 600-700; card 1
    busy 300-800 (a kernel and an overlapping copy): 400 and 500 us, a
    mean of 450. The union over the cards would read 700."""
    tr = Trace([_ev("user_annotation", "perfbench::iteration", 0, 1000),
                _ev("kernel", "a", 100, 200, 0),
                _ev("kernel", "b", 250, 150),
                _ev("gpu_memcpy", "Memcpy DtoH", 600, 100, 0),
                _ev("kernel", "a", 300, 400, 1),
                _ev("gpu_memcpy", "Memcpy PtoP", 650, 150, 1)])
    window = tr.window("iteration")
    assert tr.busy(window, 0) == [[100, 400], [600, 700]]
    assert tr.busy(window, 1) == [[300, 800]]
    assert tr.busy_s(window, [0]) == pytest.approx(400e-6)
    assert tr.busy_s(window, [0, 1]) == pytest.approx(450e-6)
    assert tr.busy_s(window, [0, 1, 2, 3]) == pytest.approx(225e-6)
    bd = tr.breakdown(window, [0, 1])
    assert dict((n, d) for n, d in bd["device_ops"]) == pytest.approx(
        {"a": 600e-6, "b": 150e-6, "Memcpy DtoH": 100e-6,
         "Memcpy PtoP": 150e-6})
    assert [g[0] for g in bd["idle_gaps"]] == [
        "cuda:0 harness/python", "cuda:1 harness/python",
        "cuda:0 harness/python", "cuda:1 harness/python",
        "cuda:0 harness/python"]
    assert [g[1] for g in bd["idle_gaps"]] == pytest.approx(
        [300e-6, 300e-6, 200e-6, 200e-6, 100e-6])


def test_one_card_trace_reads_as_before():
    """With one card every reading is the union of every device op, and
    the gaps carry no card: the arithmetic of a one-card run."""
    events = [_ev("user_annotation", "perfbench::iteration", 0, 1000),
              _ev("kernel", "a", 100, 200, 0),
              _ev("kernel", "b", 250, 150),
              _ev("gpu_memcpy", "Memcpy DtoH", 600, 100),
              _ev("user_annotation", "perfbench::dispatch", 0, 1000),
              _ev("user_annotation", "perfbench::update", 420, 170),
              _ev("cpu_op", "aten::copy_", 410, 190),
              _ev("cpu_op", "aten::add", 0, 90)]
    tr = Trace(events)
    window = tr.window("iteration")
    busy = tr.busy(window)
    assert busy == [[100, 400], [600, 700]]
    assert tr.busy_s(window) == sum(e - s for s, e in busy) * 1e-6
    assert tr.breakdown(window) == tr.breakdown(window, [0])
    assert tr.breakdown(window) == {
        "device_ops": [["a", 200.0 * 1e-6], ["b", 150.0 * 1e-6],
                       ["Memcpy DtoH", 100.0 * 1e-6]],
        "idle_gaps": [["dispatch/python", 300.0 * 1e-6],
                      ["update/aten::copy_", 200.0 * 1e-6],
                      ["dispatch/aten::add", 100.0 * 1e-6]]}


# ---------------------------------------------------------------------------
# the capture, the peaks and the waits
# ---------------------------------------------------------------------------

def test_capture_picks_on_one_device_are_the_seeds():
    """On one device the picks come from a generator seeded with the run's
    seed alone, call after call."""
    seed, k = small.SEED, 5
    cap = harness.Capture(k, seed, torch.device("cpu"))
    cap.on = True
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(seed)
    for n in (40, 17, 3):
        o = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
        d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
        tm = torch.from_numpy(rng.uniform(-1, 5, n).astype(np.float32))
        ans = torch.arange(n, dtype=torch.float32)
        cap.keep("closest", o, d, tm, ans)
        key = torch.rand(n, generator=gen) + (tm <= 0).float() * 2.0
        idx = torch.topk(key, min(k, n), largest=False).indices
        assert torch.equal(cap.calls[-1][6], ans[idx])


def test_card_seeds():
    seed = 2 ** 31 + 12345
    assert harness.card_seed(seed, 0) == seed
    others = [harness.card_seed(seed, i) for i in (1, 2, 3)]
    assert len({seed, *others}) == 4
    assert others == [harness.card_seed(seed, i) for i in (1, 2, 3)]
    assert all(0 <= s < 2 ** 64 for s in others)


def test_card_set():
    assert harness.card_set("cpu", 4) == (torch.device("cpu"),)
    assert harness.card_set("cuda", 1) == (torch.device("cuda", 0),)
    assert harness.card_set("cuda", 4) == tuple(
        torch.device("cuda", i) for i in range(4))


@pytest.fixture
def four_cards(monkeypatch):
    """Four stub cards whose peaks read 3, 9, 5 and 7 GB."""
    reset = []
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda dev: reset.append(dev.index))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda dev: [3, 9, 5, 7][dev.index] * 10 ** 9)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "Stub H100")
    monkeypatch.setattr(peaks, "power_limit",
                        lambda indices: "; ".join("700.00 W" for _ in indices))
    return reset


def test_peak_is_the_fullest_card(four_cards):
    cards = harness.card_set("cuda", 4)
    peaks.reset(cards)
    assert four_cards == [0, 1, 2, 3]
    per_card = peaks.read(cards)
    assert per_card == [3e9, 9e9, 5e9, 7e9]
    dev = peaks.device(cards, per_card)
    assert dev["count"] == 4
    assert dev["memory_peak_bytes"] == 9 * 10 ** 9
    assert dev["memory_peak_bytes_per_card"] == [3e9, 9e9, 5e9, 7e9]
    assert dev["power_limit"] == "; ".join(["700.00 W"] * 4)
    json.dumps(dev)


def test_one_card_device_object_has_the_one_card_keys(four_cards):
    cards = harness.card_set("cuda", 1)
    dev = peaks.device(cards, peaks.read(cards))
    assert list(dev) == ["platform", "kind", "count", "memory_peak_bytes",
                         "power_limit"]
    assert dev["count"] == 1 and dev["memory_peak_bytes"] == 3 * 10 ** 9
    assert peaks.device((torch.device("cpu"),), [0]) == {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def test_sync_waits_for_every_card(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev: waited.append(dev.index))
    loop_lib.sync(harness.card_set("cuda", 4))
    assert waited == [0, 1, 2, 3]
    loop = loop_lib.Loop(None, None, None, {}, 0, torch.device("cpu"), None)
    assert loop.cards == (torch.device("cpu"),)


# ---------------------------------------------------------------------------
# the rule that ties chips to the tiles
# ---------------------------------------------------------------------------

def _with(tmp_path, chips, render):
    """The accepted definition with one more configuration (tetra-visit's
    file with ``render``) and a cell of ``chips`` on it."""
    definition = bench.load()
    base = next(c for c in definition["configs"] if c["name"] == "tetra-visit")
    with open(f"{bench.ROOT}/{base['file']}") as f:
        conf = json.load(f)
    conf["render"] = render
    path = tmp_path / "tiled.json"
    path.write_text(json.dumps(conf))
    definition["configs"].append({**base, "name": "tiled",
                                  "file": str(path)})
    definition["workloads"].append({"name": "tiled.converge",
                                    "config": "tiled", "traffic": "converge",
                                    "chips": chips, "why": "test"})
    return definition


@pytest.mark.parametrize("chips,render,flagged", [
    (4, {}, True), (4, {"n_devices": 2}, True), (4, {"n_devices": 4}, False),
    (1, {"n_devices": 4}, True), (1, {"n_devices": 1}, False),
    (1, {}, False)])
def test_chips_match_the_tiles(tmp_path, chips, render, flagged):
    got = [p for p in bench.problems(_with(tmp_path, chips, render))
           if not p.startswith("missing limits/tiled")]
    assert bool(got) is flagged, got
    if flagged:
        assert got == [f"workload tiled.converge chips {chips} n_devices "
                       f"{render.get('n_devices', 0)}"]
