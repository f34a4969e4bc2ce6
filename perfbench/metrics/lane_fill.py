"""lane_fill (%): the share of the lanes the wavefront driver ran at depths
1 and up that were alive, 100 x the program's ``driver.lanes_live``
counter over its ``driver.lanes_run`` counter, in the traced iterations.
A depth runs whole chunks of lanes; after the compaction the live lanes
fill a prefix of them, and each tile of a tiled frame compacts and pads
its own. Reads nothing without a trace, or from a program without the
counters."""

from perfbench.lib import spans


def read(run):
    snap = spans.snapshot(run)
    if snap is None or not snap.counters.get("driver.lanes_run"):
        return None
    return (100.0 * snap.counters.get("driver.lanes_live", 0)
            / snap.counters["driver.lanes_run"])
