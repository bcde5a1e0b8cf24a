"""gemm_bytes.mip: bytes the split step's weight GEMM fetches from the stashes
a mip-NeRF step, the cone K4's and K2's together.  The reading of
``gemm_bytes.train`` (metrics/gemm_bytes.train.py, loaded from beside this
file), on the mip-train cell."""

import os

from benchmark import harness

_TRAIN = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "gemm_bytes.train.py"),
    "benchmark_metric_gemm_bytes_train")
SPANS, read = _TRAIN.SPANS, _TRAIN.read
