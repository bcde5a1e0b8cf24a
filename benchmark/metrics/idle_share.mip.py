"""idle_share.mip: the share of the traced slice of mip-NeRF steps in which the
device ran no kernel and no copy, in %.  The reading of
``idle_share.train`` (metrics/idle_share.train.py, loaded from beside this file), on
the mip-train cell."""

import os

from benchmark import harness

_TRAIN = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "idle_share.train.py"),
    "benchmark_metric_idle_share_train")
SPANS, read = _TRAIN.SPANS, _TRAIN.read
