"""host_syncs_per_sample (syncs): the program's device-to-host reads
(its ``sync.*`` spans) inside its ``engine.render`` and
``engine.finish_frame`` spans, over the samples it rendered (its
``samples`` counter), in the traced iterations. Each read stalls the
host until the card has drained what was queued before it."""

from perfbench.lib import spans

RENDER = ("engine.render", "engine.finish_frame")


def read(run):
    snap = spans.snapshot(run)
    if snap is None or not snap.counters.get("samples"):
        return None
    return (len(spans.host_syncs(snap.spans, RENDER))
            / snap.counters["samples"])
