"""pytest settings of the benchmark's own tests (``perfbench/tests``): the
checkout's root on the path, and the ``card`` marker for tests that need a
CUDA card (they skip without one)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
