"""stash_ms.mip: device milliseconds a mip-NeRF step in the split step's forward
sweeps (the render kernel compiled with STASH), the cone K4's and K2's
calls together.  The reading of
``stash_ms.train`` (metrics/stash_ms.train.py, loaded from beside this file), on
the mip-train cell."""

import os

from benchmark import harness

_TRAIN = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "stash_ms.train.py"),
    "benchmark_metric_stash_ms_train")
SPANS, read = _TRAIN.SPANS, _TRAIN.read
