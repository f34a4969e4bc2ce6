"""retransform_ms (ms): the mean of the program's ``scene.retransform``
spans in the traced iterations: the device update of an instance move
(``move_instances_device``): the transform table and, in a TLAS scene,
the instances' tables made on the host, their upload, and the enqueue
of the ``retransform`` kernel that writes the world planes, the triangle
table and the pack on the card."""

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
