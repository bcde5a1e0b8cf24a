"""upload_bytes.mip: bytes a mip-NeRF step copies from host arrays to the device at
the program's explicit upload sites.  The reading of
``upload_bytes.train`` (metrics/upload_bytes.train.py, loaded from beside this file), on
the mip-train cell."""

import os

from benchmark import harness

_TRAIN = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "upload_bytes.train.py"),
    "benchmark_metric_upload_bytes_train")
SPANS, read = _TRAIN.SPANS, _TRAIN.read
