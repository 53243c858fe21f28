"""The benchmark's CPU tests: the checkout root on the path, and the
``cuda`` marker of tests that need a card (they decide inside the test)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
