"""dispatch_ms_per_sample (ms): the host time inside the program's
``engine.render`` spans less the ``sync.*`` spans nested in them, over
the samples it rendered (its ``samples`` counter), in the traced
iterations: the host's enqueue work, which the card waits for while it
idles."""

from perfbench.lib import spans

RENDER = ("engine.render",)


def read(run):
    snap = spans.snapshot(run)
    if snap is None or not snap.counters.get("samples"):
        return None
    render = [s.end_ns - s.start_ns for _, s in spans.closed(snap.spans)
              if s.name in RENDER]
    if not render:
        return None
    waits = sum(s.end_ns - s.start_ns
                for _, s in spans.host_syncs(snap.spans, RENDER))
    return (sum(render) - waits) * 1e-6 / snap.counters["samples"]
