"""Spans and counters at the boundaries of the port's layers.

A span names a stretch of host time (``span("driver.depth")``), a
counter adds up a quantity the code already holds on the host
(``count("samples", n)``). Recording is on while a torch profiler
records, read from torch's own flag (so not during a profiler
schedule's warm-up steps), or while a ``recording()`` block is open;
nothing else turns it on.

* Off, ``span`` hands back one shared null context and ``count``
  returns at once, after reading the two flags: no
  ``record_function``, no allocation, no device op.
* On, each span is kept in an in-memory list with its parent (the span
  open around it on the same thread) and its start and end in ns, read
  from ``time.time_ns()``, the Unix clock that a profiler's trace is
  converted to (an event's ``ts`` is in µs after the trace's
  ``baseTimeNanoseconds``). While a profiler records, the span also
  opens ``torch.profiler.record_function("rfw::" + name)``, so it lands
  in the trace nested with the torch ops and kernel launches inside it.

A span or counter never reads a device value, and nothing is written to
disk: ``snapshot()`` hands out what was recorded since ``clear()``.

The counters the port records: ``samples``, ``updates``, ``device_moves``
(the updates that took the device update, ``move_instances_device``) and
``upload_bytes`` (``render/engines.py``, ``render/scene_data.py``);
``tvisit.calls``, ``tvisit_rays.closest``, ``tvisit_rays.any`` and
``tvisit.passes`` (``render/intersectors.py``, ``ops/tvisit_intersect.py``);
``nee.kernel`` and ``nee.plain`` (``ops/nee.py``: each NEE step of a
depth through the CUDA kernel, or through its plain PyTorch version);
``extend.kernel`` and ``extend.plain`` (``ops/extension.py``: the same for
each BSDF extension step); ``driver.lanes_run`` and ``driver.lanes_live``
(``render/wavefront_driver.py``: the lanes each depth from 1 on runs,
and the live ones among them); ``tiles.tiles``, ``tiles.scatter_bytes``,
``tiles.gather_bytes`` and ``tiles.replica_bytes``
(``parallel/tiles.py``, ``parallel/mesh.py``: the tiles traced, and the
bytes copied between cards to the tiles, back to the home card and into
scene replicas).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "rfw::"


class SpanRecord(NamedTuple):
    """One recorded span: ``parent`` is the index in ``Snapshot.spans`` of
    the span open around it, -1 at the top; ``end_ns`` is None while it
    is open."""

    name: str
    parent: int
    start_ns: int
    end_ns: int | None


class Snapshot(NamedTuple):
    """``spans``: ``SpanRecord``s in the order they opened; ``counters``:
    each counter's total."""

    spans: list
    counters: dict


_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_recording = 0
_spans: list = []
_counters: dict = {}


class Span:
    """A span being recorded, or timed alone (``span(..., timed=True)``
    while recording is off): its own start and end in ns."""

    __slots__ = ("name", "index", "start_ns", "end_ns", "_row", "_range",
                 "_stack")

    def __init__(self, name: str):
        self.name = name
        self.index = -1
        self.start_ns = self.end_ns = 0
        self._row = self._range = self._stack = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        if _recording or _profiler._is_profiler_enabled:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            self._row = [self.name, stack[-1].index if stack else -1, 0, None]
            with _lock:
                self.index = len(_spans)
                _spans.append(self._row)
            stack.append(self)
            self._stack = stack
            if _profiler._is_profiler_enabled:
                self._range = torch.profiler.record_function(
                    PREFIX + self.name)
                self._range.__enter__()
        self.start_ns = time.time_ns()
        if self._row is not None:
            self._row[2] = self.start_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._row is not None:
            self._row[3] = self.end_ns
            self._stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, timed: bool = False):
    """A context manager that records the span ``name`` while recording
    is on. With ``timed`` it is a ``Span`` whose ``seconds`` the caller
    reads afterwards, recorded or not; otherwise, off, the shared null
    context."""
    if not (timed or _recording or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if not (_recording or _profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, profiler or not."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def snapshot() -> Snapshot:
    """A copy of the spans and counters recorded since ``clear()``."""
    with _lock:
        return Snapshot([SpanRecord(*s) for s in _spans], dict(_counters))


def clear() -> None:
    """Forget every span and counter recorded so far (with no span
    open: a span open across it keeps a stale parent index)."""
    with _lock:
        _spans.clear()
        _counters.clear()
