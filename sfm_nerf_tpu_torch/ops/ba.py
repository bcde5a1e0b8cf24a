"""Bundle adjustment: Schur-complement Levenberg-Marquardt on the device.

Same solver as sfm_nerf_tpu/ops/ba.py, in float64:

- residuals r_ij (2 per camera i and point j) and their Jacobians
  A_ij = dr/dcam (2x6), B_ij = dr/dpoint (2x3) for every (i, j) lane of
  the dense (N_cam, M_pt) layout, from ``torch.func.jacfwd`` under two
  ``vmap``s, gated by the visibility mask and the cheirality mask frozen at
  the initial geometry;
- the damped normal system reduced onto the cameras by the Schur
  complement S = U - Y W⁻¹ Yᵀ, the point blocks inverted in closed form;
  every sum over points is a plain reduction over one axis of the dense
  layout (deterministic: no float64 scatter-add or atomics);
- a fixed number of accept/reject LM steps with no host read;
- optionally the shared intrinsics [fx, fy, cx, cy, k1, k2] as one more
  6-wide block of the Schur system (``refine_intrinsics``).

cam = [rvec (Rodrigues, world->cam), tvec]; the cost is scipy's
0.5 * sum(r²).  The point-sharded form (``axis_name``) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from sfm_nerf_tpu_torch.ops.linalg import rodrigues, rotation_to_rvec


def _observe(cam: torch.Tensor, X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel (2,) of one point through one camera.  The depth is floored at
    +1e-6 (one-sided), so a point behind the camera projects far off: the
    cost itself is a cheirality barrier."""
    xc = rodrigues(cam[:3]) @ X + cam[3:]
    z = torch.clamp(xc[2], min=1e-6)
    u = K[0, 0] * xc[0] / z + K[0, 2]
    v = K[1, 1] * xc[1] / z + K[1, 2]
    return torch.stack([u, v])


def _depth(cam: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return (rodrigues(cam[:3]) @ X + cam[3:])[2]


_INTR_TOKENS = {
    "f": (0, 1), "fx": (0,), "fy": (1,),
    "pp": (2, 3), "cx": (2,), "cy": (3,),
    "k1": (4,), "k2": (5,),
}


def intrinsics_free_mask(refine_intrinsics: str) -> Tuple[bool, ...]:
    """'f,pp,k1' -> 6-tuple of free flags over [fx, fy, cx, cy, k1, k2]."""
    free = [False] * 6
    for tok in filter(None, (t.strip() for t in refine_intrinsics.split(","))):
        if tok not in _INTR_TOKENS:
            raise ValueError(
                f"unknown intrinsics token {tok!r}; valid: {sorted(_INTR_TOKENS)}")
        for i in _INTR_TOKENS[tok]:
            free[i] = True
    return tuple(free)


def theta_from_K(K: torch.Tensor) -> torch.Tensor:
    """(3, 3) pinhole K -> theta = [fx, fy, cx, cy, k1=0, k2=0]."""
    z = torch.zeros((), dtype=K.dtype, device=K.device)
    return torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2], z, z])


def K_from_theta(theta: torch.Tensor) -> torch.Tensor:
    """theta -> (3, 3) pinhole K (the radial terms are not representable)."""
    fx, fy, cx, cy = theta[0], theta[1], theta[2], theta[3]
    o, i = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, o, cx]), torch.stack([o, fy, cy]),
                        torch.stack([o, o, i])])


def _observe_theta(cam: torch.Tensor, X: torch.Tensor,
                   theta: torch.Tensor) -> torch.Tensor:
    """``_observe`` through the intrinsics vector and the radial polynomial
    1 + k1 r² + k2 r⁴ on normalized coordinates."""
    xc = rodrigues(cam[:3]) @ X + cam[3:]
    z = torch.clamp(xc[2], min=1e-6)
    x, y = xc[0] / z, xc[1] / z
    r2 = x * x + y * y
    d = 1.0 + r2 * (theta[4] + theta[5] * r2)
    return torch.stack([theta[0] * (x * d) + theta[2], theta[1] * (y * d) + theta[3]])


def _inv3x3_lanes(W: torch.Tensor, lam) -> torch.Tensor:
    """Closed-form inverse of (W + lam I) for symmetric W (3, 3, M), the
    batch axis last; det >= lam³ > 0."""
    a = W[0, 0] + lam
    b, c = W[0, 1], W[0, 2]
    d = W[1, 1] + lam
    e = W[1, 2]
    f = W[2, 2] + lam
    A00 = d * f - e * e
    A01 = c * e - b * f
    A02 = b * e - c * d
    A11 = a * f - c * c
    A12 = b * c - a * e
    A22 = a * d - b * b
    inv = 1.0 / (a * A00 + b * A01 + c * A02)
    return torch.stack([torch.stack([A00, A01, A02]), torch.stack([A01, A11, A12]),
                        torch.stack([A02, A12, A22])]) * inv


class BAResult(NamedTuple):
    camera_params: torch.Tensor   # (N, 6) refined [rvec, tvec]
    points: torch.Tensor          # (M, 3) refined
    cost: torch.Tensor            # 0.5 * sum(r²) at the optimum
    initial_cost: torch.Tensor
    n_accepted: torch.Tensor      # accepted LM steps
    n_residuals: torch.Tensor     # observations active in the cost
    intrinsics: torch.Tensor      # (6,) [fx, fy, cx, cy, k1, k2]


def _lanes(fn, cams, pts, k):
    """fn(cam, X, k) over every (camera, point) lane -> (N, M, ...)."""
    return vmap(vmap(fn, (None, 0, None)), (0, None, None))(cams, pts, k)


def bundle_adjust(
    K: torch.Tensor,              # (3, 3)
    camera_params: torch.Tensor,  # (N, 6) [rvec, tvec] world->cam
    points: torch.Tensor,         # (M, 3)
    observations: torch.Tensor,   # (N, M, 2) pixels (any value where unseen)
    visibility: torch.Tensor,     # (N, M) 1/0
    n_iters: int = 50,
    lambda0: float = 1e-3,
    loss: str = "linear",         # 'linear' | 'huber'
    huber_delta: float = 3.0,
    refine_intrinsics: str = "",
) -> BAResult:
    """Bundle adjustment of (N, 6) cameras and (M, 3) points
    (sfm_nerf_tpu/ops/ba.py:172).  ``refine_intrinsics``: comma-set of
    {f, fx, fy, pp, cx, cy, k1, k2} freed as one shared 6-wide block
    ('' keeps K fixed); frozen coordinates move by exactly 0."""
    if loss not in ("linear", "huber"):
        raise ValueError(f"unknown loss {loss!r}")
    n_cam = camera_params.shape[0]
    dt, dev = K.dtype, K.device
    vis = visibility.to(dt)
    free = intrinsics_free_mask(refine_intrinsics)
    refining = any(free)
    theta0 = theta_from_K(K)
    free_v = torch.tensor(free, dtype=dt, device=dev)

    # cheirality mask frozen at the initial geometry (ops/ba.py:82-92)
    z0 = _lanes(lambda cam, X, _: _depth(cam, X), camera_params, points, K)
    mask0 = vis * (z0 > 1e-8).to(dt)
    one = _observe_theta if refining else _observe

    def residual(cams, pts, theta):
        proj = _lanes(one, cams, pts, theta if refining else K)
        return (proj - observations) * mask0[..., None]

    def irls_weights(r):
        if loss == "linear":
            return torch.ones_like(r[..., 0])
        norm = torch.linalg.norm(r, dim=-1)
        return torch.sqrt(torch.clamp(huber_delta / (norm + 1e-12), max=1.0))

    def cost_of(cams, pts, theta):
        r = residual(cams, pts, theta)
        if loss == "linear":
            return 0.5 * torch.sum(r * r)
        norm = torch.linalg.norm(r, dim=-1) * (mask0 > 0)
        return torch.sum(torch.where(norm <= huber_delta, 0.5 * norm ** 2,
                                     huber_delta * (norm - 0.5 * huber_delta)))

    jac_cam = jacfwd(one, argnums=0)
    jac_pt = jacfwd(one, argnums=1)
    jac_th = jacfwd(_observe_theta, argnums=2)
    I6 = torch.eye(6, dtype=dt, device=dev)
    diag = torch.arange(n_cam, device=dev)

    def blocks(jac, cams, pts, k, wmask):
        # (N, M, 2, c) -> (2, N, c, M): the point axis minor, as ops/ba.py
        return _lanes(jac, cams, pts, k).permute(2, 0, 3, 1) * wmask[None, :, None, :]

    cams, pts, theta = camera_params, points, theta0
    lam = torch.tensor(lambda0, dtype=dt, device=dev)
    cost = c0 = cost_of(cams, pts, theta)
    n_accepted = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(n_iters):
        kparam = theta if refining else K
        r = residual(cams, pts, theta)                       # (N, M, 2)
        w = irls_weights(r)
        rt = (r * w[..., None]).permute(2, 0, 1)             # (2, N, M)
        wmask = mask0 * w
        A = blocks(jac_cam, cams, pts, kparam, wmask)        # (2, N, 6, M)
        B = blocks(jac_pt, cams, pts, kparam, wmask)         # (2, N, 3, M)

        U = (A[:, :, :, None] * A[:, :, None]).sum((0, 4))   # (N, 6, 6)
        W = (B[:, :, :, None] * B[:, :, None]).sum((0, 1))   # (3, 3, M)
        Y = (A[:, :, :, None] * B[:, :, None]).sum(0)        # (N, 6, 3, M)
        g_cam = (A * rt[:, :, None]).sum((0, 3))             # (N, 6)
        g_pt = (B * rt[:, :, None]).sum((0, 1))              # (3, M)
        if refining:
            D = blocks(jac_th, cams, pts, theta, wmask) * free_v[:, None]  # (2, N, 6, M)
            Z = (D[:, :, :, None] * B[:, :, None]).sum((0, 1))   # (6, 3, M)
            Q = (D[:, :, :, None] * D[:, :, None]).sum((0, 1, 4))  # (6, 6)
            Yc = (A[:, :, :, None] * D[:, :, None]).sum((0, 4))  # (N, 6, 6)
            g_th = (D * rt[:, :, None]).sum((0, 1, 3))           # (6,)

        W_inv = _inv3x3_lanes(W, lam)                        # (3, 3, M)
        YWi = (Y[:, :, :, None] * W_inv[None, None]).sum(2)  # (N, 6, 3, M)
        Y_r = Y.reshape(6 * n_cam, -1)
        YWi_r = YWi.reshape(6 * n_cam, -1)
        S_off = (YWi_r @ Y_r.T).reshape(n_cam, 6, n_cam, 6).permute(0, 2, 1, 3)
        rhs2 = (YWi_r @ g_pt.reshape(-1)).reshape(n_cam, 6)
        S = -S_off
        S[diag, diag] = S[diag, diag] + (U + lam * I6)
        rhs = g_cam - rhs2
        S_flat = S.permute(0, 2, 1, 3).reshape(6 * n_cam, 6 * n_cam)
        if refining:
            ZWi = (Z[:, :, None] * W_inv[None]).sum(1)       # (6, 3, M)
            S_cth = (Yc - (YWi_r @ Z.reshape(6, -1).T).reshape(n_cam, 6, 6)
                     ).reshape(6 * n_cam, 6)
            S_thth = Q - ZWi.reshape(6, -1) @ Z.reshape(6, -1).T
            rhs_th = g_th - ZWi.reshape(6, -1) @ g_pt.reshape(-1)
            S_aug = torch.cat([torch.cat([S_flat, S_cth], 1),
                               torch.cat([S_cth.T, S_thth + lam * I6], 1)], 0)
            d = -torch.linalg.solve_ex(S_aug, torch.cat([rhs.reshape(-1), rhs_th]))[0]
            d_cam = d[:6 * n_cam].reshape(n_cam, 6)
            d_th = d[6 * n_cam:] * free_v
        else:
            d_cam = -torch.linalg.solve_ex(S_flat, rhs.reshape(-1))[0].reshape(n_cam, 6)
            d_th = torch.zeros_like(theta)
        rhs_pt = g_pt + (Y_r.T @ d_cam.reshape(-1)).reshape(3, -1)   # (3, M)
        if refining:
            rhs_pt = rhs_pt + (Z * d_th[:, None, None]).sum(0)
        d_pt = -(W_inv * rhs_pt[None]).sum(1).T              # (M, 3)

        cams_new, pts_new, theta_new = cams + d_cam, pts + d_pt, theta + d_th
        cost_new = cost_of(cams_new, pts_new, theta_new)
        ok = torch.isfinite(cost_new) & (cost_new < cost)
        cams = torch.where(ok, cams_new, cams)
        pts = torch.where(ok, pts_new, pts)
        theta = torch.where(ok, theta_new, theta)
        cost = torch.where(ok, cost_new, cost)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-10, 1e10)
        n_accepted = n_accepted + ok.long()
    return BAResult(cams, pts, cost, c0, n_accepted, torch.sum(mask0), theta)


def fix_gauge_to_first_camera(camera_params, points):
    """Re-express a BA solution in camera 0's frame (R0 = I, t0 = 0):
    cams (R_i, t_i) -> (R_i R0ᵀ, t_i - R_i R0ᵀ t0), X -> R0 X + t0."""
    R0 = rodrigues(camera_params[0, :3])
    t0 = camera_params[0, 3:]
    Rs_new = rodrigues(camera_params[:, :3]) @ R0.T
    ts_new = camera_params[:, 3:] - (Rs_new @ t0)
    cams_new = torch.cat([rotation_to_rvec(Rs_new), ts_new], dim=-1)
    return cams_new, points @ R0.T + t0


def camera_params_from_RC(Rs: torch.Tensor, Cs: torch.Tensor) -> torch.Tensor:
    """(R world->cam, C centre) -> packed [rvec, tvec = -R C] (N, 6)."""
    tvecs = -(Rs @ Cs[..., None])[..., 0]
    return torch.cat([rotation_to_rvec(Rs), tvecs], dim=-1)


def RC_from_camera_params(cams: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed (N, 6) -> (R (N, 3, 3), C (N, 3)); C = -Rᵀ t."""
    Rs = rodrigues(cams[:, :3])
    Cs = -(Rs.transpose(-1, -2) @ cams[:, 3:, None])[..., 0]
    return Rs, Cs
