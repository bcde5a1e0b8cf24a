"""The numbers that decide ``correct``: what the program produced against
what the plain reference produced from the same inputs.

Training (the first three steps of the object the window drives):

- ``loss_gap``: the worst step's |loss - reference loss| / reference loss;
- ``grad_gap``: the first gradient, as Adam holds it after one step, by
  the worst leaf: |norm - reference norm| over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same of each parameter's change over the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a leaf with none moves under Adam by round-off);
- ``update_mean``: the mean over those leaves of the same gap, steady from
  seed to seed where the worst leaf swings with one small leaf's rounding
  (the density head's, rgb1's bias), and the number a lower precision
  than the configuration's moves most.

Frames: ``rgb_rmse`` and ``rgb_max_abs`` of the worst frame checked.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

KEEP_GRAD_SHARE = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _median(xs: Sequence[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> List[float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's; all infinite if any is not finite."""
    med = _median([ref[k] for k in keys])
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]
    return gaps if all(math.isfinite(g) for g in gaps) else [math.inf] * len(gaps)


def train_numbers(prog, ref) -> Dict[str, float]:
    """``prog`` and ``ref``: (losses, first grads, changes), leaves by the
    reference's names."""
    (lp, gp, dp), (lr, gr, dr) = prog, ref
    if set(gp) != set(gr) or len(lp) != len(lr):
        raise ValueError(f"program leaves {sorted(gp)} against reference {sorted(gr)}")
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))
    if not all(math.isfinite(a) for a in lp):
        loss_gap = math.inf
    gn_r = _norms(gr)
    med = _median(list(gn_r.values()))
    kept = [k for k in gr if gn_r[k] >= KEEP_GRAD_SHARE * med]
    updates = _leaf_gaps(_norms(dp), _norms(dr), kept)
    return {"loss_gap": loss_gap,
            "grad_gap": max(_leaf_gaps(_norms(gp), gn_r, list(gr))),
            "update_gap": max(updates), "update_mean": sum(updates) / len(updates)}


def frame_numbers(pairs: List) -> Dict[str, float]:
    """``pairs``: [(program frame, reference frame)], any devices."""
    rmse = max_abs = 0.0
    for p, r in pairs:
        diff = p.to(r.device, torch.float64) - r.double()
        rmse = max(rmse, float(diff.pow(2).mean().sqrt()))
        max_abs = max(max_abs, float(diff.abs().max()))
        if not torch.isfinite(diff).all():
            rmse = max_abs = math.inf
    return {"rgb_rmse": rmse, "rgb_max_abs": max_abs}
