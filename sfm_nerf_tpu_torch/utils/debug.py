"""Numerics debugging, the counterpart of sfm_nerf_tpu/utils/debug.py: the
reference's always-on ``torch.autograd.set_detect_anomaly(True)``
(Phase2/train.py:390), here behind a switch because it costs throughput,
and a finite check over a tree of tensors.

Anomaly mode watches autograd's backward only.  The fused step kernels
(K2 ``fused_mse_loss``, K4, and K3's backward) compute their grads outside
autograd and hand them back ready-made from a ``torch.autograd.Function``,
so on the fused route a NaN made inside a kernel is caught only by
``assert_all_finite`` over the grads or parameters.  ``TrainConfig.debug_nans``
stays unwired, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch


def enable_nan_debugging(enable: bool = True) -> None:
    """Process-wide: a backward that produces a NaN raises, naming the
    forward op that made it."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def nan_debugging() -> Iterator[None]:
    """Anomaly mode inside the block; the previous setting after it."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def _leaves(tree, path: str):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree, name: str = "tree") -> None:
    """Host-side finite check over nested dicts, lists and tuples of
    tensors, arrays and numbers (use at checkpoint boundaries); raises
    ``FloatingPointError`` naming the first leaf's path, in the JAX
    function's ``keystr`` form (``['fc1']['w']``)."""
    for path, leaf in _leaves(tree, ""):
        if isinstance(leaf, torch.Tensor):
            ok = bool(torch.isfinite(leaf.detach()).all()) if leaf.is_floating_point() else True
        else:
            a = np.asarray(leaf)
            ok = bool(np.all(np.isfinite(a))) if a.dtype.kind in "fc" else True
        if not ok:
            raise FloatingPointError(f"non-finite values in {name} at {path}")
