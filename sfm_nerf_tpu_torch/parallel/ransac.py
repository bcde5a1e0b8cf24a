"""Hypothesis-sharded F-RANSAC over a list of devices
(sfm_nerf_tpu/parallel/ransac.py).

RANSAC is parallel over hypotheses: each device scores a contiguous share
of the minimal samples against the whole match set, and only the scores
cross devices (``n_hyp`` float64s onto the first device, in device order).
The draws, the scoring (``ops.epipolar.score_hypotheses``) and the winner's
re-estimation (``_ransac_winner``) are the single-device path's, so a
sharded call returns the single-device result whenever both score the same
samples: the chunk count ceil(n_iters / chunk) is rounded up to a multiple
of the device count, so with a device count that divides it the draws are
exactly the single-device call's.  One process drives every device, as the
JAX package shards SfM over its local devices; the list may name one
device more than once (the CPU, or a card standing in for several).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sfm_nerf_tpu_torch.ops.epipolar import (
    RansacResult, _ransac_prep, _ransac_winner, draw_minimal_samples, pad_rows,
    score_hypotheses,
)


def sharded_iters(n_iters: int, chunk: int, n_dev: int) -> int:
    """Hypotheses a call over ``n_dev`` devices scores: the chunk count
    rounded up to a device multiple."""
    n_chunks = -(-n_iters // chunk)
    return -(-n_chunks // n_dev) * n_dev * chunk


def ransac_fundamental_sharded(
    pts1: torch.Tensor,        # (N, 2) pixel coords
    pts2: torch.Tensor,
    devices: Sequence,
    n_iters: int = 50000,
    threshold: float = 5e-4,
    normalize: bool = True,
    chunk: int = 1024,
    n_valid: Optional[int] = None,
    scoring: str = "msac",
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> RansacResult:
    """``ransac_fundamental`` with its hypotheses cut by chunk over
    ``devices``.  ``sharded_iters(n_iters, chunk, len(devices))`` hypotheses,
    drawn on the first device from ``generator`` as the single-device call
    draws that many, unless ``samples`` (that many rows of 8) is given.  The
    result lies on the first device."""
    devices = [torch.device(d) for d in devices]
    home = devices[0]
    pts1, pts2 = pts1.to(home), pts2.to(home)
    n_pts = pts1.shape[0]
    nv = n_pts if n_valid is None else int(n_valid)
    if n_pts < 8:
        # draws reach rows [0, 8): pad and mask, as ransac_fundamental does
        pts1, pts2 = pad_rows(pts1, 8), pad_rows(pts2, 8)
        n_valid = nv
    total = sharded_iters(n_iters, chunk, len(devices))
    if samples is None:
        samples = draw_minimal_samples(total, 8, nv, generator, home)
    if tuple(samples.shape) != (total, 8):
        raise ValueError(f"samples {tuple(samples.shape)}: {len(devices)} devices score "
                         f"{total} hypotheses of 8")
    samples = samples.to(home)
    valid = None
    if n_valid is not None:
        valid = torch.arange(pts1.shape[0], device=home)[None, :] < nv
    T1, T2, p1, p2, h1, h2 = _ransac_prep(pts1[None], pts2[None], normalize, valid)
    share = total // len(devices)
    scores = []
    for k, dev in enumerate(devices):
        rows = [t.to(dev) for t in (p1, p2, h1, h2)]
        scores.append(score_hypotheses(
            *rows, None if valid is None else valid.to(dev),
            samples[None, k * share:(k + 1) * share].to(dev), threshold, chunk, scoring))
    best = torch.argmax(torch.cat([s.to(home) for s in scores], dim=1), dim=1)
    F, inliers = _ransac_winner(samples[best], T1, T2, p1, p2, h1, h2, threshold,
                                normalize, valid)
    return RansacResult(F[0], inliers[0, :n_pts], inliers.sum(), best[0])
