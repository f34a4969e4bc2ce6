"""The benchmark's own tests: ``python -m pytest perfbench/tests``.

Tests that need a CUDA card carry the ``card`` marker and skip without
one; each decides inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")
