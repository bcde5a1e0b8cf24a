"""Triangulation: batched DLT, midpoint, cheirality vote, batched nonlinear
refinement.

Same functions as sfm_nerf_tpu/ops/triangulation.py (the reference's
Phase1/Triangulation.py and Utils.py), in float64 on any device:

- both projection conventions are kept: ``P = K [R|T]`` with T a
  translation, and ``P = K R [I|-C]`` with C the camera centre;
- the DLT takes each point's null vector from the fixed-sweep Jacobi
  solver, all points at once;
- the nonlinear refinement is one batched Levenberg-Marquardt over all
  points (ops/lm.py), residuals in the camera-centre convention.

``relative_pose_pairs`` (the global initialisation's pose graph) is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_nerf_tpu_torch.ops.linalg import (
    homogenize,
    skew,
    smallest_eigvec_of_normal_fast,
)
from sfm_nerf_tpu_torch.ops.lm import levenberg_marquardt


def projection_matrix_RT(K, R, T):
    """P = K [R | T] with T a translation vector; R (..., 3, 3), T (..., 3)
    -> (..., 3, 4)."""
    return K @ torch.cat([R, T[..., None]], dim=-1)


def projection_matrix_RC(K, R, C):
    """P = K R [I | -C] with C the camera centre; R (..., 3, 3),
    C (..., 3) -> (..., 3, 4)."""
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(*R.shape[:-2], 3, 3)
    return K @ (R @ torch.cat([eye, -C[..., :, None]], dim=-1))


def project(P: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """World points ``X[..., 3]`` through ``P (3, 4)`` -> pixels [..., 2]."""
    x = homogenize(X) @ P.T
    return x[..., :2] / x[..., 2:3]


def triangulate_linear(K, R1, T1, R2, T2, pts1, pts2) -> torch.Tensor:
    """Batched DLT -> (N, 3).  T1/T2 are translations (P = K[R|T]); the
    cameras are shared by every row or given per row ((N, 3, 3), (N, 3))."""
    P1 = projection_matrix_RT(K, R1, T1)
    P2 = projection_matrix_RT(K, R2, T2)
    A = torch.cat([skew(homogenize(pts1)) @ P1,
                   skew(homogenize(pts2)) @ P2], dim=-2)   # (N, 6, 4)
    X = smallest_eigvec_of_normal_fast(A)
    return X[..., :3] / X[..., 3:4]


def _rows_times(x, R):
    """Each row of x (N, 3) times R: one shared (3, 3) or one per row."""
    return x @ R if R.dim() == 2 else (x[:, None, :] @ R)[:, 0]


def triangulate_midpoint(K, R1, C1, R2, C2, pts1, pts2) -> torch.Tensor:
    """Closed-form two-ray midpoint -> (N, 3): the second init of the
    best-of-two refinement (sfm_nerf_tpu/ops/triangulation.py:88).  The
    cameras are shared or per row, as in ``triangulate_linear``."""
    Ki = torch.linalg.inv(K)
    d1 = _rows_times(homogenize(pts1) @ Ki.T, R1)    # rows: Rᵀ K⁻¹ [u, v, 1]
    d2 = _rows_times(homogenize(pts2) @ Ki.T, R2)
    b = (C2 - C1).reshape(-1, 3)
    a11 = torch.sum(d1 * d1, dim=1)
    a12 = torch.sum(d1 * d2, dim=1)
    a22 = torch.sum(d2 * d2, dim=1)
    b1 = torch.sum(d1 * b, dim=1)
    b2 = torch.sum(d2 * b, dim=1)
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    t1 = (a22 * b1 - a12 * b2) / det
    t2 = (a12 * b1 - a11 * b2) / det
    return 0.5 * ((C1.reshape(-1, 3) + t1[:, None] * d1)
                  + (C2.reshape(-1, 3) + t2[:, None] * d2))


def cheirality_counts(points, Cs, Rs, R1=None, C1=None, n_valid=None):
    """Points in front of both cameras per candidate (Triangulation.py:
    372-401).  points (4, N, 3); camera 1 defaults to the identity at the
    origin, whose depth is world z; rows at or past ``n_valid`` do not
    vote."""
    if R1 is None:
        z1_ok = points[..., 2] > 0
    else:
        c1 = torch.zeros(3, dtype=points.dtype, device=points.device) \
            if C1 is None else C1.reshape(3)
        z1_ok = (points - c1) @ R1[2] > 0
    v = points - Cs[:, None, :]
    z2_ok = torch.einsum("pj,pnj->pn", Rs[:, 2, :], v) > 0
    ok = z1_ok & z2_ok
    if n_valid is not None:
        ok = ok & (torch.arange(points.shape[1], device=points.device) < n_valid)[None]
    return torch.sum(ok, dim=-1)


def disambiguate_pose(K, Cs, Rs, pts1, pts2, R1=None, T1=None, n_valid=None):
    """Triangulate under all four candidates (camera 1 at R1/T1) and pick
    the cheirality winner.  Returns (X (N, 3), C, R, all_points (4, N, 3),
    idx)."""
    if R1 is None:
        R1 = torch.eye(3, dtype=K.dtype, device=K.device)
    if T1 is None:
        T1 = torch.zeros(3, dtype=K.dtype, device=K.device)
    all_points = torch.stack([
        triangulate_linear(K, R1, T1, Rs[c], -(Rs[c] @ Cs[c]), pts1, pts2)
        for c in range(4)])
    C1 = -(R1.T @ T1.reshape(3))
    counts = cheirality_counts(all_points, Cs, Rs, R1=R1, C1=C1, n_valid=n_valid)
    best = torch.argmax(counts)
    return all_points[best], Cs[best], Rs[best], all_points, best


def triangulate_nonlinear(K, R1, C1, R2, C2, pts1, pts2, X0, n_iters: int = 20):
    """Per-point LM, all points in one batch: minimizes the 4-vector
    reprojection residual in both views (Triangulation.py:270-304).  The
    cameras are shared or per row (R (N, 3, 3), C (N, 3)).  Returns
    (X_opt (N, 3), initial squared errors (N,), final (N,))."""
    P1 = projection_matrix_RC(K, R1, C1.reshape(R1.shape[:-2] + (3,)))
    P2 = projection_matrix_RC(K, R2, C2.reshape(R2.shape[:-2] + (3,)))

    def residual(X, pt1, pt2, Pa=P1, Pb=P2):
        return torch.cat([project(Pa, X) - pt1, project(Pb, X) - pt2])

    if P1.dim() == 2:
        return levenberg_marquardt(residual, X0, pts1, pts2, n_iters=n_iters)
    return levenberg_marquardt(residual, X0, pts1, pts2, P1, P2, n_iters=n_iters)


def triangulate_pair_bucketed(K, R1, C1, R2, C2, pts1_np, pts2_np,
                              n_iters: int = 20, device=None):
    """Host wrapper (the JAX name; no shape bucket here): DLT and midpoint
    inits, an LM from each, and a per-point pick between them, as
    sfm_nerf_tpu/ops/triangulation.py:230-305:

    - the midpoint-init result wins when its final residual is at least 1%
      lower, so healthy points keep the DLT-init result;
    - it also wins when the DLT-init point lies more than 100x farther from
      camera 1 at a residual within 4x: the flat valley at infinity.

    C1/C2 are camera centres; the two cameras are shared by every point
    (R (3, 3), C (3,)) or given per point (R (n, 3, 3), C (n, 3)), so
    points of many view pairs go through one batch.  Returns numpy
    (X_linear (n, 3), X (n, 3))."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    Kt, R1t, R2t = t(K), t(R1), t(R2)
    C1n = np.asarray(C1, np.float64).reshape(R1t.shape[:-2] + (3,))
    C2n = np.asarray(C2, np.float64).reshape(R2t.shape[:-2] + (3,))
    C1t, C2t = t(C1n), t(C2n)
    p1, p2 = t(pts1_np), t(pts2_np)
    T1 = -(R1t @ C1t[..., None])[..., 0]
    T2 = -(R2t @ C2t[..., None])[..., 0]
    X_lin = triangulate_linear(Kt, R1t, T1, R2t, T2, p1, p2)
    X_mid = triangulate_midpoint(Kt, R1t, C1t, R2t, C2t, p1, p2)
    # both inits in one batch: the LM is independent per row
    two = (lambda a: a) if R1t.dim() == 2 else (lambda a: torch.cat([a, a]))
    X, _, fin = triangulate_nonlinear(Kt, two(R1t), two(C1t), two(R2t), two(C2t),
                                      torch.cat([p1, p1]), torch.cat([p2, p2]),
                                      torch.cat([X_lin, X_mid]), n_iters=n_iters)
    n = p1.shape[0]
    host = torch.cat([X_lin, X[:n], X[n:], fin[:n, None], fin[n:, None]],
                     dim=1).cpu().numpy()
    Xl, Xa, Xb, fa, fb = (host[:, 0:3], host[:, 3:6], host[:, 6:9],
                          host[:, 9], host[:, 10])
    fa = np.where(np.isfinite(fa) & np.isfinite(Xa).all(axis=1), fa, np.inf)
    fb = np.where(np.isfinite(fb) & np.isfinite(Xb).all(axis=1), fb, np.inf)
    da = np.linalg.norm(Xa - C1n, axis=1)
    db = np.linalg.norm(Xb - C1n, axis=1)
    da = np.where(np.isfinite(da), da, np.inf)
    implausible_a = (da > 100.0 * np.maximum(db, 1e-9)) & (fb <= 4.0 * fa)
    pick_b = (fb < 0.99 * fa) | implausible_a
    return Xl, np.where(pick_b[:, None], Xb, Xa)


def reprojection_errors(K, R, C, X, pts) -> torch.Tensor:
    """Per-point squared reprojection error, camera-centre convention.
    R (..., 3, 3), C (..., 3): every pose against X (N, 3) and pts (N, 2)
    -> (..., N)."""
    P = projection_matrix_RC(K, R, C)
    x = homogenize(X) @ P.transpose(-1, -2)         # (..., N, 3)
    proj = x[..., :2] / x[..., 2:3]
    return torch.sum((proj - pts) ** 2, dim=-1)


def relative_pose_pairs(K, F, pts1, pts2, n_valid, cleanup: bool = True,
                        convention: str = "hz"):
    """Relative pose of P pairs at once (sfm_nerf_tpu/ops/triangulation.py:
    317): E = Kᵀ F K, the optional cleanup, the four-way decomposition and
    the cheirality vote, camera 1 at the identity.  F (P, 3, 3), pts1/pts2
    (P, B, 2) padded per pair; rows at or past ``n_valid`` (P,) do not
    vote.  The same arithmetic as ``disambiguate_pose`` pair by pair, every
    candidate's DLT in one batch.  Returns (C_rel (P, 3), R_rel (P, 3, 3))."""
    from sfm_nerf_tpu_torch.ops.epipolar import (
        cleanup_essential,
        decompose_essential,
        essential_from_fundamental,
    )

    E = essential_from_fundamental(K, F)
    if cleanup:
        E = cleanup_essential(E)
    Cs, Rs = decompose_essential(E, convention)              # (P, 4, 3), (P, 4, 3, 3)
    P, B = pts1.shape[:2]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    P1 = projection_matrix_RT(K, eye, torch.zeros(3, dtype=K.dtype, device=K.device))
    T2 = -(Rs @ Cs[..., None])                               # (P, 4, 3, 1)
    P2 = K @ torch.cat([Rs, T2], dim=-1)                     # (P, 4, 3, 4)
    rows1 = (skew(homogenize(pts1)) @ P1)[:, None].expand(P, 4, B, 3, 4)
    rows2 = skew(homogenize(pts2))[:, None] @ P2[:, :, None]  # (P, 4, B, 3, 4)
    X = smallest_eigvec_of_normal_fast(torch.cat([rows1, rows2], dim=-2))
    X = X[..., :3] / X[..., 3:4]                             # (P, 4, B, 3)
    z1_ok = X[..., 2] > 0
    z2_ok = torch.einsum("pcj,pcnj->pcn", Rs[..., 2, :], X - Cs[:, :, None, :]) > 0
    vote = torch.arange(B, device=pts1.device)[None, :] < n_valid.to(pts1.device)[:, None]
    counts = torch.sum(z1_ok & z2_ok & vote[:, None, :], dim=-1)   # (P, 4)
    best = torch.argmax(counts, dim=-1)
    C = torch.gather(Cs, 1, best[:, None, None].expand(P, 1, 3))[:, 0]
    R = torch.gather(Rs, 1, best[:, None, None, None].expand(P, 1, 3, 3))[:, 0]
    return C, R
