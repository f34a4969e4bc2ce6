"""device_idle.converge (%): the share of the traced iterations' window in
which no kernel, copy or memset runs on a card (the profiler's device
intervals of each card merged), the mean over the run's card set, in the
converge cells."""

from perfbench.lib import trace


def read(run):
    return trace.idle_percent(run)
