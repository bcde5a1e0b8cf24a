"""gemm_ms.mip: device milliseconds a mip-NeRF step in the split step's weight
GEMM (grad_gemm.cu) and the reduction of its partials, the cone K4's
and K2's calls together.  The reading of
``gemm_ms.train`` (metrics/gemm_ms.train.py, loaded from beside this file), on
the mip-train cell."""

import os

from benchmark import harness

_TRAIN = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "gemm_ms.train.py"),
    "benchmark_metric_gemm_ms_train")
SPANS, read = _TRAIN.SPANS, _TRAIN.read
