"""device_idle.edit (%): the share of the traced edits' window in which
no kernel, copy or memset runs on the card (the profiler's device
intervals merged), in the edit cell."""

from perfbench.lib import trace


def read(run):
    return trace.idle_percent(run)
