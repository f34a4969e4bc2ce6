"""intersect_roofline (%): the intersectors' share of their memory
roofline over the traced iterations.

The floor is the bytes the work needs, whatever implements it: each
live ray read once (origin, direction and bound: 28 B) and its answer
written once (closest hit: t, prim, u, v, 16 B; any hit: one byte),
plus the scene's triangles once a call (36 B a triangle of the tables
the intersector walks: every world triangle for a flat intersector,
each distinct mesh once and 72 B an instance for ``tlas``), over the
card's HBM bandwidth. The time is the device time of every kernel
launched inside the harness's ``intersect`` ranges, so renamed or fused
kernels still count. Reads nothing without a trace or such kernels."""

from perfbench.lib import geometry, peaks

RAY_BYTES = {"closest": 28 + 16, "any": 28 + 1}


def scene_bytes(config, layout) -> float:
    if config["intersector"] == "tlas":
        meshes = {inst["mesh"]: len(inst["faces"]) for inst in layout}
        return 36.0 * sum(meshes.values()) + 72.0 * len(layout)
    return 36.0 * geometry.triangle_count(layout)


def read(run):
    if getattr(run, "trace", None) is None or not run.live_rays:
        return None
    kernels = run.trace.kernels_launched_in("intersect")
    device_s = sum(k[2] for k in kernels) * 1e-6
    if device_s <= 0:
        return None
    nbytes = (sum(RAY_BYTES[kind] * n for kind, n in run.live_rays)
              + run.calls_traced * scene_bytes(run.config, run.layout))
    return 100.0 * nbytes / peaks.PEAK_HBM_BYTES / device_s
