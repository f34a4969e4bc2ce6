"""A cell run at a test's size on the CPU: the configuration's
``test_scene`` sizes, 32 x 18 pixels in four chunks (so the wavefront
driver runs), a short window."""

import sys
import time

SEED = 2 ** 31 + 977


def overrides(spec, render=None, **traffic):
    """The small run's overrides; ``render`` adds renderer settings."""
    conf = spec["config"]
    render = dict(conf["render"], max_rays_per_pass=144, **(render or {}))
    chk = dict(spec["traffic"]["check"], pixels=128)
    if "moved_pixels" in chk:
        chk["moved_pixels"] = 64
    return {"config": {"scene": {**conf["scene"], **conf["test_scene"]},
                       "width": 32, "height": 18, "render": render},
            "traffic": {"check": chk, **traffic}}


def run(workload, seconds=1.0, trace=False, control=False, seed=SEED,
        render=None):
    """The result line of one small run of ``workload`` on the CPU, with
    the renderer settings ``render`` besides the small ones."""
    from perfbench import run as runner
    runner.caches()
    from perfbench.lib import bench, harness
    spec = bench.cell(bench.load(), workload)
    return harness.run(workload, seed, seconds, trace, time.perf_counter(),
                       device="cpu", overrides=overrides(spec, render),
                       log=lambda m: print(m, file=sys.stderr),
                       control=control)
