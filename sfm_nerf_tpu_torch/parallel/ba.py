"""Point-sharded bundle adjustment over a list of devices
(sfm_nerf_tpu/parallel/ba.py).

BA's Schur structure is a sharding structure: every per-point quantity (the
3x3 blocks W and their inverses, the coupling blocks Y, the point
gradients and updates) is independent across points, while the camera
system everything reduces into is small ((6N)², plus the intrinsics'
block).  So each device holds a contiguous block of points, the point-axis
sums (U, g_cam, the Schur product and right-hand side, the cost) are
completed onto the first device in device order, the camera step is solved
there once and sent back.  The traffic per LM step is O(N² · 36) floats,
independent of the point count.  The math and the LM schedule are
``ops.ba.bundle_adjust_blocks``'; the result matches the single-device
call up to the reassociated sums: costs to rounding, and a near-flat step
may flip its accept/reject decision, so the geometry is held to 1e-5, not
bit for bit.  One process drives every device; the list may repeat one.
"""

from __future__ import annotations

from typing import Sequence

import torch

from sfm_nerf_tpu_torch.ops.ba import BAResult, bundle_adjust_blocks


def bundle_adjust_sharded(
    K: torch.Tensor,              # (3, 3)
    camera_params: torch.Tensor,  # (N, 6) [rvec, tvec] world->cam
    points: torch.Tensor,         # (M, 3)
    observations: torch.Tensor,   # (N, M, 2)
    visibility: torch.Tensor,     # (N, M) 1/0
    devices: Sequence,
    n_iters: int = 50,
    lambda0: float = 1e-3,
    loss: str = "linear",
    huber_delta: float = 3.0,
    refine_intrinsics: str = "",
) -> BAResult:
    """``bundle_adjust`` with the point axis cut over ``devices``.  The
    point count is padded to a device multiple with points of zero
    visibility, which add nothing to any sum (their damped blocks are
    lam·I), and trimmed from the returned cloud.  Cameras, K and the result
    live on the first device."""
    devices = [torch.device(d) for d in devices]
    home = devices[0]
    n_dev, n_pts = len(devices), points.shape[0]
    pad = (-n_pts) % n_dev
    if pad:
        points = torch.cat([points, points.new_zeros(pad, 3)])
        observations = torch.cat(
            [observations, observations.new_full((observations.shape[0], pad, 2), -1.0)], 1)
        visibility = torch.cat(
            [visibility, visibility.new_zeros(visibility.shape[0], pad)], 1)
    m = points.shape[0] // n_dev
    blocks = [(points[k * m:(k + 1) * m].to(dev),
               observations[:, k * m:(k + 1) * m].to(dev),
               visibility[:, k * m:(k + 1) * m].to(dev))
              for k, dev in enumerate(devices)]
    res = bundle_adjust_blocks(
        K.to(home), camera_params.to(home), blocks, n_iters=n_iters, lambda0=lambda0,
        loss=loss, huber_delta=huber_delta, refine_intrinsics=refine_intrinsics)
    return res._replace(points=res.points[:n_pts])
