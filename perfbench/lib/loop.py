"""What every closed loop of traffic shares (``loops/<loop>.py`` holds
one loop each, named by a traffic mix's ``loop``): the measured window,
the wait for the run's cards and the profiler ranges the traced run
marks."""

from __future__ import annotations

import contextlib
import time

import torch


def sync(cards):
    """Wait until every card of ``cards`` (the run's card set) has
    finished its queued work."""
    for dev in cards:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def marked(on: bool, name: str):
    """A profiler range ``perfbench::<name>`` while ``on``."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"perfbench::{name}")


class Loop:
    """A closed loop over the program ``rs``. A loop defines ``unit``,
    ``warm_up()``, ``iteration()`` (returns the units of work it
    completed) and ``final_state()`` (what the check compares: ``frame``,
    ``samples`` and, after edits, ``moves`` and ``tables``). Its waits
    (``sync(self.cards)``) cover ``cards``, the run's card set (``dev``
    alone when not given)."""

    unit = "iterations"

    def __init__(self, rs, refs, layout, mix, seed, dev, cap,
                 sync_update=False, cards=None):
        self.rs, self.refs, self.layout, self.mix = rs, refs, layout, mix
        self.seed, self.dev, self.cap = seed, dev, cap
        self.cards = cards or (dev,)
        self.sync_update = sync_update
        self.traced = False
        self.frame = None
        self.update_s = []

    def window(self, seconds: float):
        """Iterations until ``seconds`` have passed: (seconds taken, units
        of work completed), every iteration's time included."""
        done = 0
        t0 = time.perf_counter()
        while True:
            done += self.iteration()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                return elapsed, done

    def release(self):
        self.rs = self.refs = None
