"""The cases of ``perfbench/tests/test_perfbench_cards.py`` (the harness over
a card set of several cards, on the CPU) in the tier-1 suite. The cases
that read the trace, the capture, the peaks, the waits and the rule that
ties ``chips`` to the tiles run here as they are; the three that run a
cell through the harness run in a process of their own, since the
harness refuses a process that loaded JAX, as this one has (the tests'
conftest imports it)."""

import subprocess
import sys

import pytest

from perfbench.lib import bench
from perfbench.tests.test_perfbench_cards import (  # noqa: F401
    four_cards,
    test_busy_per_card_and_the_mean,
    test_capture_picks_on_one_device_are_the_seeds,
    test_card_seeds,
    test_card_set,
    test_chips_match_the_tiles,
    test_one_card_device_object_has_the_one_card_keys,
    test_one_card_trace_reads_as_before,
    test_peak_is_the_fullest_card,
    test_reference_takes_the_tiles_as_a_schedule,
    test_sync_waits_for_every_card,
)

CASES = "perfbench/tests/test_perfbench_cards.py"


def _in_own_process(case):
    """The case ``case`` of the benchmark's file, run by pytest in a fresh
    process."""
    out = subprocess.run(
        [sys.executable, "-m", "pytest", f"{CASES}::{case}", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        capture_output=True, text=True, timeout=600, cwd=bench.ROOT)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    assert "1 passed" in out.stdout, out.stdout[-3000:]


@pytest.mark.parametrize("trace", [False, True])
def test_tiled_run_is_correct(trace):
    _in_own_process(f"test_tiled_run_is_correct[{trace}]")


def test_tiled_run_with_a_tile_zeroed_fails():
    _in_own_process("test_tiled_run_with_a_tile_zeroed_fails")
