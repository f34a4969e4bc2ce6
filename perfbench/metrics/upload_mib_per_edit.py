"""upload_mib_per_edit (MiB): the bytes the program copied from host
arrays to the card (its ``upload_bytes`` counter) over its updates that
changed the geometry (its ``updates`` counter), in the traced
iterations."""

from perfbench.lib import spans


def read(run):
    snap = spans.snapshot(run)
    if snap is None or not snap.counters.get("updates"):
        return None
    return snap.counters.get("upload_bytes", 0) / snap.counters["updates"] \
        / 2 ** 20
