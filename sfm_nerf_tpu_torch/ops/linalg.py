"""Small-matrix linear algebra for the SfM ops, batched, on any device.

Same functions as sfm_nerf_tpu/ops/linalg.py.  Every null-space problem is the
smallest eigenvector of the normal matrix AᵀA.  The RANSAC hypothesis loops
take it from ``jacobi_eigh_small``, a fixed-sweep parallel Jacobi solver whose
every step is an elementwise operation over the hypothesis batch; the winner
re-estimation takes it from ``torch.linalg.eigh``.  The functions keep their
inputs' dtype and device; the SfM path feeds them float64.
"""

from __future__ import annotations

import functools

import torch


def smallest_eigvec_of_normal(A: torch.Tensor) -> torch.Tensor:
    """Unit vector v minimizing ||A v|| for ``A[..., m, n]`` -> ``[..., n]``."""
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)          # ascending eigenvalues
    return vecs[..., :, 0]


def _round_robin_rounds(n: int):
    """Tournament schedule: each round is a set of disjoint index pairs;
    over the rounds every unordered pair appears exactly once.  Odd n gets
    a bye slot (circle method on n+1 with a phantom)."""
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = players[k], players[m - 1 - k]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _round_indices(n: int, device: torch.device):
    """The tournament rounds as (p, q) index tensors on ``device``, made
    once per (n, device) so the sweeps copy nothing from the host."""
    return [
        (torch.tensor([p for p, _ in pairs], device=device),
         torch.tensor([q for _, q in pairs], device=device))
        for pairs in _round_robin_rounds(n)
    ]


def _rotate_rows(B, p, q, c, s):
    # (Gᵀ B)[p] = c B[p] - s B[q];  (Gᵀ B)[q] = s B[p] + c B[q]
    rp, rq = B[..., p, :], B[..., q, :]
    c, s = c[..., None], s[..., None]
    out = B.clone()
    out[..., p, :] = c * rp - s * rq
    out[..., q, :] = s * rp + c * rq
    return out


def _rotate_cols(B, p, q, c, s):
    # (B G)[:, p] = c B[:, p] - s B[:, q];  (B G)[:, q] = s B[:, p] + c B[:, q]
    cp, cq = B[..., :, p], B[..., :, q]
    c, s = c[..., None, :], s[..., None, :]
    out = B.clone()
    out[..., :, p] = c * cp - s * cq
    out[..., :, q] = s * cp + c * cq
    return out


def jacobi_eigh_small(M: torch.Tensor, sweeps: int = 10):
    """Batched symmetric eigendecomposition for small n by parallel-ordered
    cyclic Jacobi with a fixed sweep count (sfm_nerf_tpu/ops/linalg.py:49).

    Each tournament round rotates all its disjoint (p, q) pairs at once:
    rows, then columns of A, then columns of V, each as elementwise
    products over the batch.  No branch depends on the data.

    Returns ``(eigvals (..., n), V (..., n, n))`` with ``M ~ V diag Vᵀ``;
    the eigenvalues are not sorted.
    """
    n = M.shape[-1]
    A = M
    V = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape).clone()
    rounds = _round_indices(n, M.device)
    for _ in range(sweeps):
        for p, q in rounds:
            app = A[..., p, p]
            aqq = A[..., q, q]
            apq = A[..., p, q]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c, s = torch.cos(theta), torch.sin(theta)
            A = _rotate_cols(_rotate_rows(A, p, q, c, s), p, q, c, s)
            V = _rotate_cols(V, p, q, c, s)
    evals = torch.diagonal(A, dim1=-2, dim2=-1)
    return evals, V


def column_at_argmin(evals: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the smallest eigenvalue: column argmin(evals) of V."""
    idx = torch.argmin(evals, -1)[..., None, None].expand(*V.shape[:-1], 1)
    return torch.gather(V, -1, idx).squeeze(-1)


def smallest_eigvec_of_normal_fast(A: torch.Tensor,
                                   sweeps: int = 10) -> torch.Tensor:
    """``smallest_eigvec_of_normal`` through ``jacobi_eigh_small``: the
    hypothesis loops' path."""
    AtA = A.transpose(-1, -2) @ A
    evals, V = jacobi_eigh_small(AtA, sweeps=sweeps)
    return column_at_argmin(evals, V)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [v]_x for ``v[..., 3]``."""
    zero = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ]
    return torch.stack(rows, -2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), stable at
    theta -> 0: R = I + sin(t)/t [r]_x + (1-cos t)/t² [r]_x²."""
    theta2 = torch.sum(rvec ** 2, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = skew(rvec)
    K2 = K @ K
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def rotation_to_rvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).  Near theta = pi
    the axis comes from the symmetric part (R + I ~ 2 a aᵀ there)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    sin_t = torch.sin(theta)
    scale = torch.where(theta < 1e-6, 0.5 + theta ** 2 / 12.0,
                        theta / (2.0 * sin_t + 1e-32))
    rvec_generic = w * scale[..., None]

    # near pi: |axis| from diag(R + I) / 2; signs from the row of the
    # largest component (a_i a_j = S_ij / 2 with a_k > 0)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    S = R + eye
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    axis_abs = torch.sqrt(torch.clamp(diag * 0.5, min=0.0))
    k = torch.argmax(axis_abs, dim=-1)
    row = torch.gather(R, -2, k[..., None, None].expand(*R.shape[:-2], 1, 3))[..., 0, :]
    row = row + eye[k]
    signs = torch.where(row >= 0, 1.0, -1.0).to(R.dtype)
    ax = axis_abs * signs
    axis_pi = ax / (torch.linalg.norm(ax, dim=-1, keepdim=True) + 1e-32)
    rvec_pi = axis_pi * theta[..., None]
    near_pi = (torch.pi - theta) < 5e-7
    return torch.where(near_pi[..., None], rvec_pi, rvec_generic)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [x, y, z, w] (scipy order) -> R (..., 3, 3); normalizes q."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y ** 2 + z ** 2), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x ** 2 + z ** 2), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x ** 2 + y ** 2)], -1),
    ]
    return torch.stack(rows, -2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """R (3, 3) -> quaternion [x, y, z, w]: Shepperd's method, the
    construction with the largest pivot."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2

    s = root(tr + 1.0)
    from_w = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s])
    s = root(1.0 + m00 - m11 - m22)
    from_x = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s])
    s = root(1.0 - m00 + m11 - m22)
    from_y = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s])
    s = root(1.0 - m00 - m11 + m22)
    from_z = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s])
    cands = torch.stack([from_w, from_x, from_y, from_z])
    q = cands[torch.argmax(torch.stack([tr, m00, m11, m22]))]
    return q / torch.linalg.norm(q)


def homogenize(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
