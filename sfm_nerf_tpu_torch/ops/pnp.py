"""Perspective-n-Point: linear DLT, fixed-iteration RANSAC, quaternion LM.

Same functions as sfm_nerf_tpu/ops/pnp.py (the reference's Phase1/PnP.py),
in float64 on any device:

- LinearPnP: K⁻¹-normalized 2-D points, Hartley-conditioned 3-D points,
  the 2N x 12 DLT, R orthonormalized (R = U Vᵀ, flipped when det < 0: R
  only, as the reference), T = p4 / sigma_0, C = -Rᵀ T, the sign fixed by
  the majority depth of the sample;
- PnP RANSAC: 6-point duplicate-free samples, scored in chunks of 512 by
  squared-pixel error (threshold 10), the hypothesis solve on the Jacobi
  path in blocks of ``SOLVE_BLOCK`` hypotheses, the winner re-solved
  LAPACK-grade;
- NonlinearPnP: quaternion [x, y, z, w] + centre LM, rows weighted 0/1;
- the adaptive driver (``confidence > 0``) stops on the confidence bound
  (ops/epipolar.py:adaptive_drive); the rescue ``pnp_ransac_f64_host``
  re-runs a failed camera on numpy draws of its own seed, LAPACK-grade.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sfm_nerf_tpu_torch.ops.epipolar import (
    _chunk_best,
    _ransac_score,
    adaptive_drive,
    block_solver,
    draw_minimal_samples,
    pad_rows,
    solve_block,
)
from sfm_nerf_tpu_torch.ops.linalg import (
    homogenize,
    jacobi_eigh_small,
    matrix_to_quat,
    quat_to_matrix,
    smallest_eigvec_of_normal,
    smallest_eigvec_of_normal_fast,
)
from sfm_nerf_tpu_torch.ops.lm import levenberg_marquardt
from sfm_nerf_tpu_torch.ops.triangulation import (
    project,
    projection_matrix_RC,
    reprojection_errors,
)


def _dlt_projection(X3d, x2d, K, null_vec_fn):
    """The DLT both linear paths share (sfm_nerf_tpu/ops/pnp.py:44): the
    projective (..., 3, 4) P, denormalized, its sign fixed so that most of
    the sample lies in front of the camera."""
    xn = homogenize(x2d) @ torch.linalg.inv(K).T
    x, y = xn[..., 0], xn[..., 1]
    cen = torch.mean(X3d, dim=-2, keepdim=True)
    scale = torch.sqrt(torch.mean(torch.sum((X3d - cen) ** 2, -1), -1, keepdim=True))
    scale = torch.clamp(scale, min=1e-12)
    Xn = (X3d - cen) / scale[..., None]
    X, Y, Z = Xn[..., 0], Xn[..., 1], Xn[..., 2]
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    row1 = torch.stack(
        [X, Y, Z, one, zero, zero, zero, zero, -x * X, -x * Y, -x * Z, -x], -1)
    row2 = torch.stack(
        [zero, zero, zero, zero, X, Y, Z, one, -y * X, -y * Y, -y * Z, -y], -1)
    p = null_vec_fn(torch.cat([row1, row2], dim=-2))       # (..., 12)
    P = p.reshape(*p.shape[:-1], 3, 4)
    # denormalize: P @ [[I/s, -c/s], [0, 1]]
    Pl = P[..., :, :3] / scale[..., None, :]
    P = torch.cat([Pl, (P[..., :, 3] - (Pl @ cen[..., 0, :, None])[..., 0])[..., None]],
                  dim=-1)
    depth = (homogenize(X3d) @ P[..., 2, :, None])[..., 0]
    flip = torch.sum(torch.sign(depth), -1) < 0
    return torch.where(flip[..., None, None], -P, P)


def linear_pnp(X3d, x2d, K, null_vec_fn=smallest_eigvec_of_normal
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DLT pose -> (C (..., 3), R (..., 3, 3)), batched over leading dims;
    the DLT's null vector from ``null_vec_fn``."""
    P = _dlt_projection(X3d, x2d, K, null_vec_fn)
    U, D, Vh = torch.linalg.svd(P[..., :, :3])
    R = U @ Vh
    neg = torch.linalg.det(R) < 0
    R = torch.where(neg[..., None, None], -R, R)
    T = P[..., :, 3] / D[..., 0:1]
    C = -(R.transpose(-1, -2) @ T[..., None])[..., 0]
    return C, R


def _det3(R):
    return (R[..., 0, 0] * (R[..., 1, 1] * R[..., 2, 2] - R[..., 1, 2] * R[..., 2, 1])
            - R[..., 0, 1] * (R[..., 1, 0] * R[..., 2, 2] - R[..., 1, 2] * R[..., 2, 0])
            + R[..., 0, 2] * (R[..., 1, 0] * R[..., 2, 1] - R[..., 1, 1] * R[..., 2, 0]))


def linear_pnp_fast(X3d, x2d, K) -> Tuple[torch.Tensor, torch.Tensor]:
    """``linear_pnp`` on the Jacobi path, for hypothesis scoring: the 12x12
    null vector from ``jacobi_eigh_small``, R as the polar factor
    R_est V diag(1/sigma) Vᵀ from Jacobi on R_estᵀ R_est."""
    P = _dlt_projection(X3d, x2d, K, smallest_eigvec_of_normal_fast)
    R_est = P[..., :, :3]
    evals, V = jacobi_eigh_small(R_est.transpose(-1, -2) @ R_est, sweeps=6)
    sigma = torch.sqrt(torch.clamp(evals, min=0.0))
    # a singular hypothesis gives inf/nan here and is dropped as non-finite
    Vs = V / torch.clamp(sigma[..., None, :], min=1e-30)
    Rp = R_est @ Vs @ V.transpose(-1, -2)
    R = torch.where((_det3(Rp) < 0)[..., None, None], -Rp, Rp)
    T = P[..., :, 3] / torch.amax(sigma, dim=-1)[..., None]
    C = -(R.transpose(-1, -2) @ T[..., None])[..., 0]
    return C, R


class PnPRansacResult(NamedTuple):
    R: torch.Tensor
    C: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def pnp_ransac(
    X3d: torch.Tensor,        # (N, 3)
    x2d: torch.Tensor,        # (N, 2)
    K: torch.Tensor,
    n_iters: int = 10000,
    threshold: float = 10.0,
    chunk: int = 512,
    n_valid: Optional[int] = None,
    scoring: str = "msac",
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> PnPRansacResult:
    """PnP RANSAC (sfm_nerf_tpu/ops/pnp.py:289; PnP.py:160-196):
    ``ceil(n_iters / chunk) * chunk`` hypotheses from ``generator``, or
    the rows of ``samples`` (6 indices each), scored in chunks, the scores
    kept on the device; ties go to the first maximum."""
    n_pts = X3d.shape[0]
    nv = n_pts if n_valid is None else int(n_valid)
    # fewer rows than a sample: draws reach rows [0, 6), so pad and mask
    X3d, x2d = pad_rows(X3d, 6), pad_rows(x2d, 6)
    valid = torch.arange(X3d.shape[0], device=X3d.device) < nv
    if samples is None:
        total = -(-n_iters // chunk) * chunk
        samples = draw_minimal_samples(total, 6, nv, generator, X3d.device)
    samples = samples.to(X3d.device)
    if samples.shape[0] % chunk:
        raise ValueError(f"{samples.shape[0]} samples are not whole chunks of {chunk}")
    scores = []
    for b in range(0, samples.shape[0], solve_block(chunk)):
        idx = samples[b:b + solve_block(chunk)]
        C_block, R_block = linear_pnp_fast(X3d[idx], x2d[idx], K)
        for c in range(0, idx.shape[0], chunk):
            scores.append(_score_poses(K, R_block[c:c + chunk], C_block[c:c + chunk],
                                       X3d, x2d, valid, threshold, scoring)[0])
    best = torch.argmax(torch.cat(scores))
    R, C, inliers = _pnp_winner(samples[best], X3d, x2d, K, threshold, valid)
    inliers = inliers[:n_pts]
    return PnPRansacResult(R, C, inliers, torch.sum(inliers))


def _score_poses(K, R, C, X3d, x2d, valid, threshold, scoring):
    """Scores (H,) and gated squared pixel errors (H, N) of poses R (H, 3, 3),
    C (H, 3); a non-finite pose scores -inf."""
    e = reprojection_errors(K, R, C, X3d, x2d)
    e = torch.where(valid, e, torch.inf)
    score = _ransac_score(e, threshold, scoring)
    ok = (torch.all(torch.isfinite(C), dim=-1)
          & torch.all(torch.isfinite(R.flatten(-2)), dim=-1))
    return torch.where(ok, score, -torch.inf), e


def _pnp_winner(idx_best, X3d, x2d, K, threshold, valid):
    """LAPACK-grade re-solve of the winning sample, its inlier set."""
    C, R = linear_pnp(X3d[idx_best], x2d[idx_best], K)
    inliers = (reprojection_errors(K, R, C, X3d, x2d) < threshold) & valid
    return R, C, inliers


def pnp_ransac_adaptive(
    X3d: torch.Tensor,
    x2d: torch.Tensor,
    K: torch.Tensor,
    confidence: float = 0.999,
    max_iters: int = 10000,
    threshold: float = 10.0,
    chunk: int = 512,
    n_valid: Optional[int] = None,
    scoring: str = "msac",
    min_iters: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> Tuple[PnPRansacResult, int]:
    """PnP RANSAC with the confidence exit (sfm_nerf_tpu/ops/pnp.py:289):
    the fixed run's draws (``generator`` or ``samples``, ``ceil(max_iters /
    chunk) * chunk`` rows of 6), chunk by chunk, until the bound for
    6-point samples is met (ops/epipolar.py:adaptive_drive).  Returns
    (result, hypotheses scored)."""
    n_pts = X3d.shape[0]
    nv = n_pts if n_valid is None else int(n_valid)
    X3d, x2d = pad_rows(X3d, 6), pad_rows(x2d, 6)
    valid = torch.arange(X3d.shape[0], device=X3d.device) < nv
    n_chunks = max(1, -(-max_iters // chunk))
    if samples is None:
        samples = draw_minimal_samples(n_chunks * chunk, 6, nv, generator, X3d.device)
    samples = samples.to(X3d.device)

    solve = block_solver(lambda idx: linear_pnp_fast(X3d[idx], x2d[idx], K),
                         samples[:n_chunks * chunk], chunk, X3d.device)

    def score_chunk(c):
        C, R = solve(c)
        score, e = _score_poses(K, R, C, X3d, x2d, valid, threshold, scoring)
        return _chunk_best(score[None], e[None], threshold)

    best, used = adaptive_drive(
        score_chunk, n_chunks, chunk, torch.tensor([nv], device=X3d.device),
        confidence, 6, max_iters, min_iters)
    R, C, inliers = _pnp_winner(samples[best[0]], X3d, x2d, K, threshold, valid)
    inliers = inliers[:n_pts]
    return PnPRansacResult(R, C, inliers, torch.sum(inliers)), used


def _host_pnp(res: PnPRansacResult) -> PnPRansacResult:
    """One copy of a PnP RANSAC result to the host, numpy out."""
    host = torch.cat([res.R.reshape(9), res.C.reshape(3), res.inliers.to(torch.float64),
                      res.n_inliers.reshape(1).to(torch.float64)]).cpu().numpy()
    return PnPRansacResult(host[:9].reshape(3, 3), host[9:12], host[12:-1] > 0.5,
                           np.int64(host[-1]))


def pnp_ransac_bucketed(X3d_np, x2d_np, K, n_iters: int = 10000,
                        threshold: float = 10.0, chunk: int = 512,
                        scoring: str = "msac",
                        generator: Optional[torch.Generator] = None,
                        device=None, confidence: float = 0.0,
                        iters_out: Optional[list] = None) -> PnPRansacResult:
    """Host wrapper of ``pnp_ransac`` (the JAX name; no shape bucket here):
    numpy in, one copy back, numpy out.  ``confidence > 0`` routes to
    ``pnp_ransac_adaptive`` with ``n_iters`` as the cap; ``iters_out`` gets
    the count scored."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    args = (t(X3d_np), t(x2d_np), t(K))
    kw = dict(threshold=threshold, chunk=chunk, scoring=scoring, generator=generator)
    if confidence > 0.0:
        res, used = pnp_ransac_adaptive(
            *args, confidence=confidence, max_iters=n_iters, **kw)
        if iters_out is not None:
            iters_out.append(used)
    else:
        res = pnp_ransac(*args, n_iters=n_iters, **kw)
    return _host_pnp(res)


def _svd_null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of A's smallest singular value."""
    return torch.linalg.svd(A).Vh[..., -1, :]


def pnp_ransac_f64_host(seed: int, X3d_np, x2d_np, K, n_iters: int = 10000,
                        threshold: float = 10.0, scoring: str = "msac",
                        chunk: int = 2048, device=None) -> PnPRansacResult:
    """The PnP rescue (sfm_nerf_tpu/ops/pnp.py:545; JAX's name): PnP RANSAC
    of one camera on its own numpy draws, every hypothesis LAPACK-grade
    (the DLT's null vector by SVD, as JAX's numpy twin), in float64 on
    ``device``.  The 6-point samples come from ``default_rng(seed)`` chunk
    by chunk, ``argpartition`` of ``rng.random((chunk, n))``: the rows of
    JAX's one (n_iters, n) draw without holding it.  A point at zero depth
    scores +inf (JAX: a finite error at pixel (0, 0)), a NaN +inf.  The
    first of the highest scores wins.  Returns numpy, as
    ``pnp_ransac_bucketed``."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    X, x, Kt = t(X3d_np), t(x2d_np), t(K)
    n = X.shape[0]
    if n < 6:
        return PnPRansacResult(np.eye(3), np.zeros(3), np.zeros(n, bool), np.int64(0))
    rng = np.random.default_rng(seed)
    idx_all, scores = [], []
    for s in range(0, n_iters if n > 6 else 1, chunk):
        if n == 6:
            idx = np.arange(6)[None]
        else:
            rows = min(chunk, n_iters - s)
            idx = np.argpartition(rng.random((rows, n)), 6, axis=1)[:, :6]
        idx = torch.as_tensor(idx, device=X.device)
        C, R = linear_pnp(X[idx], x[idx], Kt, _svd_null_vector)
        e = _reproj_sq_finite(Kt, R, C, X, x)
        score = (-torch.clamp(e, max=threshold).sum(-1) if scoring == "msac"
                 else (e < threshold).sum(-1).to(torch.float64))
        ok = (torch.all(torch.isfinite(C), -1)
              & torch.all(torch.isfinite(R.flatten(-2)), -1))
        scores.append(torch.where(ok, score, -torch.inf))
        idx_all.append(idx)
    best = torch.argmax(torch.cat(scores))
    idx_best = torch.cat(idx_all)[best]
    Cw, Rw = linear_pnp(X[idx_best], x[idx_best], Kt, _svd_null_vector)
    inl = _reproj_sq_finite(Kt, Rw, Cw, X, x) < threshold
    return _host_pnp(PnPRansacResult(Rw, Cw, inl, inl.sum()))


def _reproj_sq_finite(K, R, C, X3d, x2d) -> torch.Tensor:
    """Squared pixel errors (..., N) under K R [I | -C]; +inf where a point
    lies at zero depth or the error is NaN."""
    xc = (X3d - C[..., None, :]) @ R.transpose(-1, -2)
    z = xc[..., 2]
    proj = xc @ K.T
    uv = proj[..., :2] / proj[..., 2:3]
    e = torch.sum((uv - x2d) ** 2, dim=-1)
    return torch.where((torch.abs(z) > 1e-300) & ~torch.isnan(e), e, torch.inf)


def reprojection_error_mean_px(K, R, C, X3d, x2d, weights=None) -> torch.Tensor:
    """Mean Euclidean pixel error (PnP.py:132-158), optionally weighted."""
    err = torch.linalg.norm(project(projection_matrix_RC(K, R, C), X3d) - x2d, dim=-1)
    if weights is None:
        return torch.mean(err)
    w = weights.to(err.dtype)
    return torch.sum(err * w) / torch.clamp(torch.sum(w), min=1.0)


def nonlinear_pnp(K, R_init, C_init, X3d, x2d, weights=None, n_iters: int = 50):
    """Quaternion + centre LM pose refinement -> (C, R, rms_px).
    ``weights`` (N,) 0/1 keeps the RANSAC inliers in the residual."""
    if weights is None:
        weights = torch.ones(X3d.shape[0], dtype=X3d.dtype, device=X3d.device)
    params0 = torch.cat([matrix_to_quat(R_init), C_init.reshape(3)])

    def residual(params):
        R = quat_to_matrix(params[:4])               # renormalizes q
        proj = project(projection_matrix_RC(K, R, params[4:]), X3d)
        return ((proj - x2d) * weights[:, None]).reshape(-1)

    params, _, final_cost = levenberg_marquardt(residual, params0[None],
                                                n_iters=n_iters)
    params, final_cost = params[0], final_cost[0]
    C, R = params[4:], quat_to_matrix(params[:4])
    n_eff = torch.clamp(torch.sum(weights), min=1.0)
    return C, R, torch.sqrt(final_cost / (2.0 * n_eff))


def nonlinear_pnp_bucketed(K, R_init, C_init, X3d_np, x2d_np, weights_np,
                           n_iters: int = 50, device=None):
    """Host wrapper of ``nonlinear_pnp``: numpy in, numpy (C, R, rms) out."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    C, R, rms = nonlinear_pnp(t(K), t(R_init), t(C_init), t(X3d_np), t(x2d_np),
                              weights=t(weights_np), n_iters=n_iters)
    host = torch.cat([C, R.reshape(9), rms.reshape(1)]).cpu().numpy()
    return host[:3], host[3:12].reshape(3, 3), float(host[12])
