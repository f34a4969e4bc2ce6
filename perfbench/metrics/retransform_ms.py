"""retransform_ms (ms): the mean of the program's ``scene.retransform``
spans in the traced iterations: the host re-transform of an instance
move (the world planes, the triangle table, the pack and the instance
tables, in numpy), before its upload."""

from perfbench.lib import spans


def read(run):
    snap = spans.snapshot(run)
    if snap is None:
        return None
    times = [s.end_ns - s.start_ns for _, s in spans.closed(snap.spans)
             if s.name == "scene.retransform"]
    if not times:
        return None
    return sum(times) * 1e-6 / len(times)
