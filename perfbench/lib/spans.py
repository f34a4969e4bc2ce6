"""The program's own spans and counters (``rfw_tpu_torch.utils.tracing``),
which it records while a profiler records: in a traced run, the traced
iterations'. A run without a trace gives nothing, and so does a program
without them (one older than its tracing module) or one that recorded
nothing. Readers take ratios of totals (over the program's ``samples``
and ``updates`` counters), so they do not depend on which iterations
were recorded."""

from __future__ import annotations

SYNC = "sync."


def snapshot(run):
    """The program's snapshot (spans, counters) in a traced run, or
    None."""
    if getattr(run, "trace", None) is None:
        return None
    try:
        from rfw_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    if not snap.spans and not snap.counters:
        return None
    return snap


def closed(spans):
    """(index, span) of every span that ended."""
    return [(i, s) for i, s in enumerate(spans) if s.end_ns is not None]


def _ancestors(spans, i):
    p = spans[i].parent
    while p >= 0:
        yield spans[p]
        p = spans[p].parent


def inside(spans, i, names) -> bool:
    """Whether span ``i`` is nested, at any depth, in a span named in
    ``names``."""
    return any(s.name in names for s in _ancestors(spans, i))


def host_syncs(spans, names):
    """(index, span) of the outermost ``sync.*`` spans nested in spans
    named in ``names``."""
    return [(i, s) for i, s in closed(spans)
            if s.name.startswith(SYNC) and inside(spans, i, names)
            and not any(a.name.startswith(SYNC)
                        for a in _ancestors(spans, i))]
