"""walk_ms.mip: device milliseconds a mip-NeRF step in the split step's reverse
walks (fused_train.cu), the cone K4's and K2's calls together.  The reading of
``walk_ms.train`` (metrics/walk_ms.train.py, loaded from beside this file), on
the mip-train cell."""

import os

from benchmark import harness

_TRAIN = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "walk_ms.train.py"),
    "benchmark_metric_walk_ms_train")
SPANS, read = _TRAIN.SPANS, _TRAIN.read
