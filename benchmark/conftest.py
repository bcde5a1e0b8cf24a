"""pytest settings of the benchmark's own tests (``pytest benchmark/tests``).

Registers the repository's ``gpu`` marker: a test that needs a CUDA card
carries it and decides inside the test, never at import, whether a card
is there (it skips with a reason where none is)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where torch.cuda.is_available() is false")
