"""One run of one cell: set-up, the measured window, the traced
iterations (``--trace 1``), and the check of what the window produced.

A run's card set is ``cuda:0`` to ``cuda:{chips - 1}``, ``chips`` from
the cell's entry in ``BENCHMARK.json`` (the one CPU device off the card).
The waits of set-up and of the loop, the peak memory and the trace's
busy time span every card of it.

The system under test is ``rfw_tpu_torch``. The harness reaches it only
through its public API (``RenderSystem``), and wraps two of its calls
from outside: the intersector the engine makes (to keep a seeded sample
of every call's rays and answers for the check, and, in a traced run,
to mark the call with a profiler range) and, in a traced run, the
wavefront driver's depth stage and compaction (profiler ranges only).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import bench, check, peaks, program
from .loop import marked, sync
from .trace import Trace

BIG_T = 1e30
FORBIDDEN = ("jax", "jaxlib", "flax", "rfw_tpu")


def card_set(device, chips: int) -> tuple:
    """The run's cards: ``cuda:0`` to ``cuda:{chips - 1}`` on the card,
    else ``device`` alone."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (dev,)
    return tuple(torch.device("cuda", i) for i in range(chips))


def card_seed(seed: int, card: int) -> int:
    """The seed of card ``card``'s generator of picks: ``seed`` itself on
    card 0, one drawn from (``seed``, ``card``) on the others."""
    if card == 0:
        return seed
    return int(np.random.SeedSequence([seed & (2 ** 64 - 1), card])
               .generate_state(1, np.uint64)[0])


class Capture:
    """A seeded sample of ``k`` live lanes of every intersector call made
    while ``on``: rays, bounds and answers, kept on the call's card and
    read after the window. Each card's picks come from a generator of
    its own (``card_seed``). ``version`` tags each call with the scene's
    state (the number of edits applied). After ``set_focus``, up to ``k``
    more live lanes a call are kept among those whose ray meets one of
    the focus spheres (the instance an edit moved, before and after),
    tagged as focused. While ``tracing``, each call is marked with a
    profiler range and its live lanes are counted."""

    def __init__(self, k: int, seed: int, device):
        self.k = k
        self.seed = seed
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.gens = {0: gen}         # card index -> generator of picks
        self.device = device
        self.on = False
        self.tracing = False
        self.version = 0
        self.focus = None            # device -> (centres, radii)
        self.calls = []
        self.live = []

    def _gen(self, dev):
        card = dev.index or 0
        if card not in self.gens:
            gen = torch.Generator(device=dev)
            gen.manual_seed(card_seed(self.seed, card))
            self.gens[card] = gen
        return self.gens[card]

    def set_focus(self, version: int, spheres):
        """Scene version ``version``, and the (centre, radius) spheres
        whose rays are kept besides the sample."""
        self.version = version
        self.focus = {self.device: (
            torch.tensor(np.array([c for c, _ in spheres]),
                         dtype=torch.float32, device=self.device),
            torch.tensor([r for _, r in spheres], dtype=torch.float32,
                         device=self.device))}

    def _meets_focus(self, o, d, tm):
        if o.device not in self.focus:     # a copy on the call's card
            c, r = next(iter(self.focus.values()))
            self.focus[o.device] = (c.to(o.device), r.to(o.device))
        c, r = self.focus[o.device]
        oc = c[None] - o[:, None, :]                       # (n, s, 3)
        dd = (d * d).sum(-1)[:, None]
        t = (oc * d[:, None, :]).sum(-1) / dd              # closest approach
        t = torch.minimum(torch.clamp(t, min=0.0), tm[:, None])
        p = o[:, None, :] + t[..., None] * d[:, None, :]
        return (((p - c[None]) ** 2).sum(-1) <= (r * 1.01) ** 2).any(-1)

    def _pick(self, n, bad, kind, o, d, tm, answer, focused):
        key = torch.rand(n, generator=self._gen(o.device), device=o.device) \
            + bad.float() * 2.0
        idx = torch.topk(key, min(self.k, n), largest=False).indices
        # rows a focused sample keeps: read after the window, so that no
        # call waits for the device
        valid = ~bad[idx] if focused else None
        self.calls.append((kind, self.version, focused, o[idx], d[idx],
                           tm[idx], answer[idx], valid))

    def keep(self, kind, o, d, t_max, answer):
        if not (self.on or self.tracing):
            return
        n = o.shape[0]
        tm = (t_max if torch.is_tensor(t_max)
              else torch.full((n,), BIG_T, device=o.device))
        live = tm > 0
        if self.tracing:
            self.live.append((kind, live.sum()))
        if not self.on or n == 0:
            return
        self._pick(n, ~live, kind, o, d, tm, answer, False)
        if self.focus is not None:
            near = live & self._meets_focus(o, d, tm)
            self._pick(n, ~near, kind, o, d, tm, answer, True)


def wrap_intersector(isect, cap: Capture):
    """The engine's intersector with each call kept by ``cap``."""
    def closest(scene, o, d, t_max=None, sort=True, coherent=False):
        with marked(cap.tracing, "intersect"):
            out = isect.closest(scene, o, d, t_max, sort=sort,
                                coherent=coherent)
        cap.keep("closest", o, d, t_max, out[0])
        return out

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        with marked(cap.tracing, "intersect"):
            out = isect.occluded(scene, o, d, dist, sort=sort,
                                 coherent=coherent)
        cap.keep("any", o, d, dist, out)
        return out

    return type(isect)(closest, occluded)


def _install(cap: Capture):
    """Wrap the engine's intersector factory and, for traced runs, the
    driver's depth stage and compaction. Returns an undo function."""
    from rfw_tpu_torch.render import engines, wavefront_driver
    saved = (engines.make_intersector, wavefront_driver.depth_stage,
             wavefront_driver._compact_prefix)
    make, stage, compact = saved

    def make_wrapped(name, cfg):
        return wrap_intersector(make(name, cfg), cap)

    def stage_wrapped(*a, **kw):
        with marked(cap.tracing, "depth_stage"):
            return stage(*a, **kw)

    def compact_wrapped(*a, **kw):
        with marked(cap.tracing, "compact"):
            return compact(*a, **kw)

    engines.make_intersector = make_wrapped
    wavefront_driver.depth_stage = stage_wrapped
    wavefront_driver._compact_prefix = compact_wrapped

    def undo():
        (engines.make_intersector, wavefront_driver.depth_stage,
         wavefront_driver._compact_prefix) = saved
    return undo


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", overrides=None, log=print,
        control=False) -> dict:
    """One run of cell ``workload``; returns the result line as a dict
    (the ``checks`` key last). ``overrides`` changes configuration and
    traffic keys (tests run small scenes on the CPU). With ``control``
    the check puts the control (the reference in bfloat16) in the
    program's place, and ``correct`` is the control's: the study of the
    limits, never the benchmark's own runs."""
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.system import RenderSystem

    spec = bench.cell(bench.load(), workload)
    conf = {**spec["config"], **(overrides or {}).get("config", {})}
    mix = {**spec["traffic"], **(overrides or {}).get("traffic", {})}
    dev = torch.device(device)
    cards = card_set(dev, spec["workload"]["chips"])
    cap = Capture(mix["check"]["rays_per_call"], seed, dev)
    undo = _install(cap)
    work = tempfile.mkdtemp(prefix="perfbench-")
    try:
        def mark(what):
            log(f"# {what} at {time.perf_counter() - t_start:.2f} s")

        mark("imports")
        rs = RenderSystem(conf["engine"], RenderConfig(**conf["render"]),
                          device=dev)
        rs.set_setting("intersector", conf["intersector"])
        layout = bench.layout(conf)
        refs = program.build(rs, conf, layout, work)
        eye = program.camera_eye(conf, mix["orbit"], seed)
        program.place_camera(rs, conf, eye)
        mark("scene added")
        rs.synchronize()
        sync(cards)
        mark("scene built")
        loop = bench.plugin("loops", mix["loop"]).Loop(
            rs, refs, layout, mix, seed, dev, cap, sync_update=trace,
            cards=cards)
        loop.warm_up()
        sync(cards)
        setup_s = time.perf_counter() - t_start
        log(f"# setup {setup_s:.2f} s")

        peaks.reset(cards)
        cap.on = True
        window_s, done = loop.window(seconds)
        cap.on = False
        peak_per_card = peaks.read(cards)
        log(f"# window {window_s:.3f} s, {done} {loop.unit}")

        traced = None
        if trace:
            traced = _traced(loop, mix, cap, cards, work)
        state = loop.final_state()
        del rs, refs
        loop.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks = check.run(conf, mix, spec["limits"], layout, eye, state,
                           cap, seed, dev, control=control, log=log)
    finally:
        undo()
        shutil.rmtree(work, ignore_errors=True)

    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if found:
        raise RuntimeError(f"the run loaded {found}")
    line = {"correct": check.verdict(checks), "attempted": done, "failed": 0}
    run_ns = SimpleNamespace(**(traced or {}), config=conf, mix=mix,
                             layout=layout, update_s=loop.update_s,
                             setup_s=setup_s, measured_s=window_s, done=done,
                             unit=loop.unit, peak_bytes=max(peak_per_card))
    metrics = {}
    kind = "metrics" if trace else "e2e"
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = bench.reader(m["name"], kind)(run_ns)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = peaks.device(cards, peak_per_card)
    if trace:
        line["device"]["busy_s"] = traced["busy_s"]
        line["device"]["window_s"] = traced["window_s"]
        line["breakdown"] = traced["breakdown"]
    line["checks"] = checks
    return line


def _traced(loop, mix, cap, cards, work) -> dict:
    """``mix["trace_iterations"]`` more iterations of the loop under the
    profiler (after one iteration it discards), reduced to what the
    per-layer metrics read: ``busy_s`` is the mean over ``cards`` of each
    card's busy time."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if cards[0].type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = int(mix["trace_iterations"])
    path = os.path.join(work, "trace.json")
    cap.tracing = True
    loop.traced = True
    counted = []
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=n, repeat=1)) as prof:
        for i in range(n + 1):
            if i == 1:          # the discarded iteration's calls go
                cap.live = []
            with torch.profiler.record_function("perfbench::iteration"):
                counted.append(loop.iteration())
            prof.step()
    cap.tracing = False
    loop.traced = False
    prof.export_chrome_trace(path)
    tr = Trace.load(path)
    os.remove(path)
    live = [(k, int(v)) for k, v in cap.live]
    window = tr.window("iteration")
    idx = [d.index or 0 for d in cards]
    return {"trace": tr, "window": window,
            "work_traced": sum(counted[1:]),
            "live_rays": live, "calls_traced": len(live),
            "busy_s": tr.busy_s(window, idx) if window else 0.0,
            "window_s": (window[1] - window[0]) * 1e-6 if window else 0.0,
            "breakdown": tr.breakdown(window, idx) if window else None}
