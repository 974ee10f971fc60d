"""The benchmark's own tests: on the CPU at tiny sizes; those marked
``cuda`` run the cells' controls on the card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips itself when torch sees "
        "none")
