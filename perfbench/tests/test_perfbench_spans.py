"""The per-layer metrics that read the program's own spans and counters
(``lib/spans.py``): nothing without a trace or without the program's
tracing module, and the expected number from a hand-built snapshot."""

import sys
from types import SimpleNamespace

import pytest

from perfbench.lib import bench

from rfw_tpu_torch.utils import tracing

READERS = ["host_syncs_per_sample", "dispatch_ms_per_sample",
           "retransform_ms", "upload_mib_per_edit"]
MS = 1_000_000


def _span(name, parent, start_ms, end_ms):
    return tracing.SpanRecord(name, parent, start_ms * MS, end_ms * MS)


def _converge():
    """Two samples in one ``engine.render`` of 10 ms (two compactions
    of 1 ms each, one inside a stage) and a ``finish_frame`` of 5 ms
    with two reads; a read outside both spans does not count."""
    spans = [
        _span("engine.render", -1, 0, 10),          # 0
        _span("driver.depth", 0, 0, 6),             # 1
        _span("driver.compact", 1, 4, 6),           # 2
        _span("sync.compact", 2, 5, 6),             # 3
        _span("driver.stage", 1, 0, 3),             # 4
        _span("sync.visit_pass", 4, 1, 2),          # 5
        _span("engine.finish_frame", -1, 10, 15),   # 6
        _span("sync.finish", 6, 10, 14),            # 7
        _span("sync.frame", 6, 14, 15),             # 8
        _span("sync.tonemap", -1, 15, 16),          # 9
    ]
    return tracing.Snapshot(spans, {"samples": 2})


def _edits():
    spans = [
        _span("system.synchronize", -1, 0, 40),
        _span("engine.update", 0, 1, 40),
        _span("scene.retransform", 1, 1, 31),
        _span("scene.upload", 1, 31, 40),
        _span("system.synchronize", -1, 50, 80),
        _span("engine.update", 4, 51, 80),
        _span("scene.retransform", 5, 51, 61),
    ]
    return tracing.Snapshot(spans, {"updates": 2, "samples": 2,
                                    "upload_bytes": 3 * 2 ** 20})


@pytest.fixture
def traced(monkeypatch):
    """A traced run whose program snapshot the test sets."""
    def use(snap):
        monkeypatch.setattr(tracing, "snapshot", lambda: snap)
        return SimpleNamespace(trace=object())
    return use


@pytest.mark.parametrize("name", READERS)
def test_reads_nothing_without_a_trace(name, monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", _converge)
    assert bench.reader(name)(SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_reads_nothing_from_a_program_without_tracing(name, monkeypatch):
    import rfw_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "rfw_tpu_torch.utils.tracing", None)
    assert bench.reader(name)(SimpleNamespace(trace=object())) is None


@pytest.mark.parametrize("name", READERS)
def test_reads_nothing_from_an_empty_snapshot(name, traced):
    assert bench.reader(name)(traced(tracing.Snapshot([], {}))) is None


@pytest.mark.parametrize("name,snap,want", [
    # sync.compact, sync.visit_pass, sync.finish, sync.frame over 2
    ("host_syncs_per_sample", _converge, 4 / 2),
    # 10 ms of render less its 2 ms of reads, over 2 samples
    ("dispatch_ms_per_sample", _converge, (10 - 2) / 2),
    ("retransform_ms", _converge, None),
    ("upload_mib_per_edit", _converge, None),
    ("host_syncs_per_sample", _edits, 0.0),
    ("dispatch_ms_per_sample", _edits, None),
    ("retransform_ms", _edits, (30 + 10) / 2),
    ("upload_mib_per_edit", _edits, 3 / 2),
])
def test_reads_the_expected_number(name, snap, want, traced):
    got = bench.reader(name)(traced(snap()))
    assert got == (None if want is None else pytest.approx(want))


def test_a_read_nested_in_a_read_counts_once(traced):
    spans = [_span("engine.render", -1, 0, 10),
             _span("sync.compact", 0, 2, 6),
             _span("sync.inner", 1, 3, 4)]
    run = traced(tracing.Snapshot(spans, {"samples": 1}))
    assert bench.reader("host_syncs_per_sample")(run) == 1
    assert bench.reader("dispatch_ms_per_sample")(run) == pytest.approx(6)
