"""host_ms.mip: host milliseconds a mip-NeRF step spends in the program's own
``train.step`` span, the profiler's own host cost in it.  The reading of
``host_ms.train`` (metrics/host_ms.train.py, loaded from beside this file), on
the mip-train cell."""

import os

from benchmark import harness

_TRAIN = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_ms.train.py"),
    "benchmark_metric_host_ms_train")
SPANS, read = _TRAIN.SPANS, _TRAIN.read
