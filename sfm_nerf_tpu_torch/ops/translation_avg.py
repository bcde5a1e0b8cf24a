"""Global translation averaging from pairwise baseline directions.

Same method as sfm_nerf_tpu/ops/translation_avg.py (numpy there), in
float64 on the device of its inputs.  With global rotations known, each
pair (i, j) gives a unit world-frame direction u_m of C_j - C_i; the
centres minimize

    sum_m w_m || (I - u_m u_mᵀ)(C_j - C_i) ||²

subject to C_anchor = 0 and sum_m u_m · (C_j - C_i) = M (the scale gauge),
JAX's (3N - 2)-unknown KKT system per IRLS round, solved in its
null-space form by one QR (``_solve``).  Five rounds reweight each edge toward the direction angle
(w = 1 / (max(|r|, h) max(|d|, hb))), then edges more than
max(10°, 5 × the median) off are dropped and the rest re-solved, as long
as they still span every camera.  The medians, the gate and the spanning
check read back to the host; the rest stays on the device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from sfm_nerf_tpu_torch.ops.graph import spans

F64 = torch.float64


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median (the mean of the two middle values), on the device."""
    return torch.quantile(x, 0.5)


def translation_averaging(pairs: Sequence[Tuple[int, int]], u_world: torch.Tensor,
                          n_cams: int, anchor: int = 0, weights=None,
                          n_irls: int = 5, reject_deg: float = 10.0) -> torch.Tensor:
    """Camera centres (n_cams, 3) from direction measurements
    (sfm_nerf_tpu/ops/translation_avg.py:37).

    ``pairs``: M host (i, j) pairs (0-based); ``u_world`` (M, 3): the
    world-frame direction of C_j - C_i, on the device that computes;
    ``weights``: optional per-edge confidences (inlier counts).  Returns
    centres with C_anchor = 0 and the scale gauge above.  Raises
    ValueError when M < n_cams - 1."""
    pairs_all = np.asarray(pairs, np.int64).reshape(-1, 2)
    u_all = torch.as_tensor(u_world, dtype=F64)
    dev = u_all.device
    u_all = u_all / torch.clamp(torch.linalg.norm(u_all, dim=-1, keepdim=True), min=1e-12)
    w_all = (torch.ones(len(pairs_all), dtype=F64, device=dev) if weights is None
             else torch.as_tensor(weights, dtype=F64, device=dev))
    N = n_cams
    if len(pairs_all) < N - 1:
        raise ValueError(
            f"{len(pairs_all)} direction measurements cannot constrain "
            f"{N} cameras (need >= N-1 on a spanning tree)")

    C = _solve(pairs_all, u_all, w_all, N, anchor, n_irls)
    # an edge whose direction disagrees with the IRLS solution by a large
    # angle is a wrong two-view geometry: drop it and re-solve, as long as
    # the pruned graph still spans every camera
    res = direction_residuals_deg(pairs_all, u_all, C)
    thresh = max(reject_deg, 5.0 * float(_median(res)))
    keep = (res <= thresh).cpu().numpy()
    if (keep.sum() >= N - 1 and 0 < (~keep).sum() < 0.3 * len(pairs_all)
            and spans(pairs_all[keep], N)):
        kt = torch.as_tensor(keep, device=dev)
        C = _solve(pairs_all[keep], u_all[kt], w_all[kt], N, anchor, n_irls)
    return C


def _solve(pairs, u, w_edge, N, anchor, n_irls):
    """The IRLS rounds of sfm_nerf_tpu/ops/translation_avg.py:92.  Each
    round's KKT system (2A + εI with the gauge row b, ε = 1e-12) is solved
    in its null-space form: one Householder reflection H maps b onto e1,
    which fixes the first unknown, and the rest are the least-squares
    solution of the stacked rows J = [sqrt(w_m) P_m S_m; sqrt(ε/2) I] by
    QR.  A = JᵀJ squares J's condition number, which a long ring's bending
    modes make large: solved as the KKT matrix, the rounding of A moved
    the centres far more than a rounding of their inputs does.  (JAX's ε
    on the multiplier's diagonal is left out: it rescales c by 1 + O(ε).)"""
    dev = u.device
    M = len(pairs)
    i0 = torch.as_tensor(pairs[:, 0], device=dev)
    i1 = torch.as_tensor(pairs[:, 1], device=dev)
    rows = torch.arange(M, device=dev)
    w_edge = w_edge / w_edge.mean()
    P = torch.eye(3, dtype=F64, device=dev)[None] - u[:, :, None] * u[:, None, :]
    # the unknowns without the anchor's three (the translation gauge)
    keep = torch.ones(3 * N, dtype=torch.bool, device=dev)
    keep[3 * anchor:3 * anchor + 3] = False
    kidx = torch.nonzero(keep)[:, 0]
    n = 3 * N - 3
    ridge = (0.5 * 1e-12) ** 0.5 * torch.eye(n, dtype=F64, device=dev)
    w_irls = torch.ones(M, dtype=F64, device=dev)
    C = torch.zeros(N, 3, dtype=F64, device=dev)
    for _ in range(max(1, n_irls)):
        wm = w_edge * w_irls
        # J's rows: sqrt(wm) P_m (C_j - C_i), one 3-row block an edge
        J = torch.zeros(M, N, 3, 3, dtype=F64, device=dev)
        block = wm.sqrt()[:, None, None] * P
        J.index_put_((rows, i1), block, accumulate=True)
        J.index_put_((rows, i0), -block, accumulate=True)
        J = torch.cat([J.permute(0, 2, 1, 3).reshape(3 * M, 3 * N)[:, kidx], ridge])
        # the scale gauge bᵀc = M, b accumulating ±wm u
        s = torch.zeros(N, 3, dtype=F64, device=dev)
        s.index_add_(0, i1, wm[:, None] * u)
        s.index_add_(0, i0, -wm[:, None] * u)
        b = s.reshape(-1)[kidx]
        # H = I - 2 v vᵀ / vᵀv with H b = -sign(b0) |b| e1; c = H x
        bn = torch.linalg.norm(b)
        sgn = torch.where(b[0] >= 0, 1.0, -1.0).to(F64)
        v = b.clone()
        v[0] = v[0] + sgn * bn
        vv = torch.dot(v, v)
        G = J - (2.0 / vv) * (J @ v)[:, None] * v[None, :]
        x0 = -sgn * float(M) / bn
        Qr, R = torch.linalg.qr(G[:, 1:])
        z = torch.linalg.solve_triangular(R, -(Qr.T @ (G[:, 0] * x0))[:, None], upper=True)
        x = torch.cat([x0.reshape(1), z[:, 0]])
        sol = x - (2.0 / vv) * torch.dot(v, x) * v
        C = torch.zeros(3 * N, dtype=F64, device=dev).index_copy(0, kidx, sol).reshape(N, 3)

        # IRLS toward the direction angle: the metric residual scales with
        # the baseline, so w = 1 / (max(|r|, h) max(|d|, hb)) keeps the
        # weighted residual ~ |d| sin(angle), with the LUD 1/|r| outlier
        # down-weighting
        d = C[i1] - C[i0]
        r = torch.einsum("mab,mb->ma", P, d)
        rn = torch.linalg.norm(r, dim=-1)
        dn = torch.linalg.norm(d, dim=-1)
        h = torch.clamp(_median(rn) * 0.1 + 1e-12, min=1e-6)
        hb = torch.clamp(_median(dn) * 1e-3, min=1e-6)
        w_irls = 1.0 / (torch.maximum(rn, h) * torch.maximum(dn, hb))
        w_irls = w_irls / w_irls.mean()
    return C


def direction_residuals_deg(pairs, u_world: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Per-edge angle (degrees) between the measured direction and the
    solved baseline."""
    p = torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2), device=C.device)
    u = torch.as_tensor(u_world, dtype=F64, device=C.device)
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-12)
    d = C[p[:, 1]] - C[p[:, 0]]
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    cos = torch.clamp(torch.sum(u * dn, dim=-1), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def pair_direction_world(R_i: torch.Tensor, c_rel: torch.Tensor) -> torch.Tensor:
    """World-frame unit direction of C_j - C_i from camera j's centre
    ``c_rel`` in camera i's frame: C_j - C_i = R_iᵀ c_rel.  R_i (..., 3, 3),
    c_rel (..., 3) -> (..., 3)."""
    d = (R_i.transpose(-1, -2) @ c_rel[..., None])[..., 0]
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
