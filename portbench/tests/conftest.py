"""The benchmark's own tests: on the CPU, at sizes a test run holds.
Tests that need a CUDA card carry the ``cuda`` marker and skip, deciding
inside the test, where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test decides inside itself "
        "whether there is one")
