"""Reduction of a profiler trace (the Chrome trace JSON that
``torch.profiler`` exports) to what the per-layer metrics read: the
device's operations, the harness's ranges on the host, and which
kernels each range launched.

A kernel belongs to a range when the runtime call that launched it
(same ``correlation``) started inside the range on the host. A card's
busy time is the union of its kernel, copy and memset intervals; each
device operation belongs to the card its event names (``args.device``;
card 0 when it names none). A run's card set is given as card indices.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "perfbench::"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The events of one exported trace (times in microseconds)."""

    def __init__(self, events: list[dict]):
        self.kernels = []          # (name, ts, dur, correlation)
        self.device_ops = []       # (name, ts, dur, card) of every device op
        self.ranges = defaultdict(list)   # harness range -> [(ts, end)]
        self.cpu_ops = []          # (ts, end, name) of host operators
        launch_ts = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            if cat in DEVICE_CATS:
                args = ev.get("args", {})
                self.device_ops.append((name, ts, dur,
                                        int(args.get("device") or 0)))
                if cat == "kernel":
                    self.kernels.append((name, ts, dur,
                                         args.get("correlation")))
            elif cat == "user_annotation" and name.startswith(PREFIX):
                self.ranges[name[len(PREFIX):]].append((ts, ts + dur))
            elif cat == "cuda_runtime":
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = ts
            elif cat == "cpu_op":
                self.cpu_ops.append((ts, ts + dur, name))
        self.launch_ts = launch_ts
        for v in self.ranges.values():
            v.sort()

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            doc = json.load(f)
        return cls(doc["traceEvents"] if isinstance(doc, dict) else doc)

    def window(self, name: str = "iteration"):
        """(start, end) from the first to the last range ``name``."""
        spans = self.ranges.get(name, [])
        if not spans:
            return None
        return spans[0][0], max(e for _, e in spans)

    def busy(self, window, card: int = 0) -> list:
        """Card ``card``'s merged busy intervals clipped to ``window``."""
        lo, hi = window
        return [[max(s, lo), min(e, hi)] for s, e in _merge(
            (ts, ts + dur) for _, ts, dur, c in self.device_ops if c == card)
            if e > lo and s < hi]

    def busy_s(self, window, cards=(0,)) -> float:
        """The mean over the cards ``cards`` of each card's busy seconds
        in ``window``."""
        return sum(e - s for c in cards for s, e in self.busy(window, c)) \
            * 1e-6 / len(cards)

    def kernels_in(self, window) -> list:
        lo, hi = window
        return [k for k in self.kernels if lo <= k[1] < hi]

    def kernels_launched_in(self, name: str) -> list:
        """Kernels whose launch started inside a range ``name``."""
        spans = self.ranges.get(name, [])
        if not spans:
            return []
        starts = [s for s, _ in spans]
        out = []
        for k in self.kernels:
            t = self.launch_ts.get(k[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(k)
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost (latest started)
        harness range and host operator open then."""
        rng = [(s, n) for n, v in self.ranges.items() if n != "iteration"
               for s, e in v if s <= t <= e]
        ops = [(s, n) for s, e, n in self.cpu_ops if s <= t <= e]
        where = max(rng)[1] if rng else "harness"
        return f"{where}/{max(ops)[1] if ops else 'python'}"

    def breakdown(self, window, cards=(0,), top: int = 10) -> dict:
        """The device operations that took most time, summed over the
        cards, and the longest idle gaps of each card of ``cards``, named
        by what the host was doing halfway through each, after the card
        (``cuda:1 ...``) when there are several (seconds, unrounded)."""
        lo, hi = window
        by_name = defaultdict(float)
        for name, ts, dur, _ in self.device_ops:
            if lo <= ts < hi:
                by_name[name] += dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for card in cards:
            prev = lo
            for s, e in self.busy(window, card):
                if s > prev:
                    gaps.append((card, prev, s))
                prev = max(prev, e)
            if hi > prev:
                gaps.append((card, prev, hi))
        gaps.sort(key=lambda g: g[1] - g[2])

        def name(card, t):
            where = self.host_at(t)
            return f"cuda:{card} {where}" if len(cards) > 1 else where
        return {"device_ops": [[n, d * 1e-6] for n, d in ops],
                "idle_gaps": [[name(c, 0.5 * (s + e)), (e - s) * 1e-6]
                              for c, s, e in gaps[:top]]}


def idle_percent(run):
    """The mean card's idle share (%) of a traced run's window (``busy_s``
    is the mean over the card set), or None."""
    if run.trace is None or not run.window_s or not run.busy_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
