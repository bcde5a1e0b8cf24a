"""Five-point essential matrix: Stewenius' action-matrix solver and its
RANSAC.

Same method as sfm_nerf_tpu/ops/essential5.py (numpy there), in float64 on
the device of its inputs, batched over samples:

1. E lies in the 4-dim null space of the 5 x 9 epipolar rows:
   E = x E1 + y E2 + z E3 + E4 (``torch.linalg.svd``);
2. det(E) = 0 and 2 E Eᵀ E - tr(E Eᵀ) E = 0 are 10 cubics in (x, y, z).
   A polynomial is a (..., 20) coefficient tensor over the monomials of
   degree <= 3, ordered as the JAX module's ``_DEG3 + _BASIS``; a product
   is one outer product scattered by a fixed index table;
3. Gauss-Jordan on the (10, 20) system writes each cubic monomial in the
   quotient basis B = {x², xy, xz, y², yz, z², x, y, z, 1}; the action
   matrix of multiplication by x has v = B(root) as eigenvector at every
   root.  ``torch.linalg.eig`` (nonsymmetric) gives them all; on a card it
   synchronises and computes through the host (MAGMA);
4. each real root takes two Gauss-Newton steps on the 10 cubics, each kept
   only where it lowers their residual.  JAX stops at step 3: the null
   space's basis is the LAPACK build's choice, and on an ill-conditioned
   sample a basis leaves its roots ~1e-8 off; polished, the port's roots
   sit at rounding and differ from JAX's by JAX's own error.

``ransac_essential_5pt`` draws its 5-tuples as JAX's does (numpy's
``default_rng(seed)`` and ``argpartition``, on the host), so the samples
are the same; the solve, the Sampson scoring in pixels and the three
rounds of linear re-fit run on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

F64 = torch.float64

_DEG3 = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
    (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
]
_BASIS = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_MONO = _DEG3 + _BASIS
_COLS = {m: i for i, m in enumerate(_MONO)}


def _product_table():
    """(source, target): outer-product entries a_p b_q whose monomial
    product has degree <= 3, and that product's column."""
    src, tgt = [], []
    for p, ea in enumerate(_MONO):
        for q, eb in enumerate(_MONO):
            e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            if sum(e) <= 3:
                src.append(p * 20 + q)
                tgt.append(_COLS[e])
    return src, tgt


_SRC, _TGT = _product_table()


def _pmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of polynomials (..., 20) whose product has degree <= 3."""
    src = torch.as_tensor(_SRC, device=a.device)
    tgt = torch.as_tensor(_TGT, device=a.device)
    outer = (a[..., :, None] * b[..., None, :]).flatten(-2)[..., src]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return torch.zeros(shape, dtype=a.dtype, device=a.device).index_add_(-1, tgt, outer)


def _action_rows():
    """For each basis monomial b: ('shift', column of x·b in B) when x·b has
    degree <= 2, else ('reduce', row of x·b among the cubics)."""
    rows = []
    for b in _BASIS:
        xb = (b[0] + 1, b[1], b[2])
        rows.append(("shift", _COLS[xb] - 10) if _COLS[xb] >= 10
                    else ("reduce", _DEG3.index(xb)))
    return rows


def _monomials(xyz: torch.Tensor):
    """The 20 monomials at points xyz (..., 3): values (..., 20) and their
    gradients (..., 20, 3)."""
    e = torch.as_tensor(_MONO, dtype=xyz.dtype, device=xyz.device)        # (20, 3)
    pw = xyz[..., None, :] ** e                                           # (..., 20, 3)
    val = pw.prod(-1)
    grads = []
    for v in range(3):
        dv = torch.where(e[:, v] > 0, e[:, v] * xyz[..., None, v] ** (e[:, v] - 1), 0.0)
        others = [pw[..., u] for u in range(3) if u != v]
        grads.append(dv * others[0] * others[1])
    return val, torch.stack(grads, -1)


def _polish(M: torch.Tensor, xyz: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """Gauss-Newton on the cubics M (B, 10, 20) from roots xyz (B, R, 3);
    a step is kept only where it lowers the residual norm."""
    def residual(p):
        val, grad = _monomials(p)
        return (torch.einsum("bqk,brk->brq", M, val),
                torch.einsum("bqk,brkv->brqv", M, grad))

    r, Jm = residual(xyz)
    for _ in range(steps):
        JtJ = Jm.transpose(-1, -2) @ Jm
        step = torch.linalg.solve_ex(JtJ, (Jm.transpose(-1, -2) @ r[..., None]))[0][..., 0]
        cand = xyz - step
        r_new, J_new = residual(cand)
        better = (torch.linalg.norm(r_new, dim=-1) < torch.linalg.norm(r, dim=-1)) \
            & torch.isfinite(cand).all(-1)
        xyz = torch.where(better[..., None], cand, xyz)
        r = torch.where(better[..., None], r_new, r)
        Jm = torch.where(better[..., None, None], J_new, Jm)
    return xyz


def five_point_essential(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """All real essential matrices of batches of 5 normalized (K⁻¹ px)
    correspondences (sfm_nerf_tpu/ops/essential5.py:66).  pts1, pts2
    (B, 5, 2) -> (B, 10, 3, 3) unit-norm candidates, NaN where a slot holds
    no real solution (a degenerate sample gives all NaN)."""
    B = pts1.shape[0]
    dev = pts1.device
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], -1)
    # the null space: the four smallest right singular vectors, E4 last
    Vh = torch.linalg.svd(A, full_matrices=True).Vh            # (B, 9, 9)
    Ebasis = Vh[:, 5:9, :].flip(1).reshape(B, 4, 3, 3)

    # E's entries as degree-1 polynomials: (B, 3, 3, 20)
    E = torch.zeros(B, 3, 3, 20, dtype=F64, device=dev)
    for k, m in enumerate([(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]):
        E[..., _COLS[m]] = Ebasis[:, k]

    det = torch.zeros(B, 20, dtype=F64, device=dev)
    for (i, j, k), s in (((0, 1, 2), 1), ((1, 2, 0), 1), ((2, 0, 1), 1),
                         ((2, 1, 0), -1), ((1, 0, 2), -1), ((0, 2, 1), -1)):
        det = det + s * _pmul(_pmul(E[:, 0, i], E[:, 1, j]), E[:, 2, k])
    # EEt[r, c] = sum_k E[r, k] E[c, k]; then 2 E Eᵀ E - tr(E Eᵀ) E
    EEt = _pmul(E[:, :, None], E[:, None, :]).sum(3)           # (B, 3, 3, 20)
    trace = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    EEtE = _pmul(EEt[:, :, :, None], E[:, None, :, :]).sum(2)  # (B, 3, 3, 20)
    cubics = 2.0 * EEtE - _pmul(trace[:, None, None], E)
    M = torch.cat([det[:, None], cubics.reshape(B, 9, 20)], dim=1)   # (B, 10, 20)

    # Gauss-Jordan: the cubic block becomes I; a singular one is degenerate
    M1, M2 = M[:, :, :10], M[:, :, 10:]
    ok = torch.abs(torch.linalg.det(M1)) > 1e-18
    eye10 = torch.eye(10, dtype=F64, device=dev)
    Ared = torch.linalg.solve(torch.where(ok[:, None, None], M1, eye10), M2)

    T = torch.zeros(B, 10, 10, dtype=F64, device=dev)
    for i, (kind, col) in enumerate(_action_rows()):
        if kind == "shift":
            T[:, i, col] = 1.0
        else:
            T[:, i, :] = -Ared[:, col, :]

    lam, V = torch.linalg.eig(T)
    realish = (torch.abs(lam.imag) < 1e-6) & ok[:, None]
    Vr = V.real
    denom = Vr[:, 9, :]
    safe = torch.abs(denom) > 1e-12
    denom = torch.where(safe, denom, 1.0)
    valid = realish & safe                                      # (B, 10)
    xyz = torch.stack([Vr[:, r, :] / denom for r in (6, 7, 8)], -1)   # (B, 10, 3)
    xyz = _polish(M, torch.where(valid[..., None], xyz, 0.0))
    xs, ys, zs = xyz.unbind(-1)
    Es = (xs[..., None, None] * Ebasis[:, None, 0] + ys[..., None, None] * Ebasis[:, None, 1]
          + zs[..., None, None] * Ebasis[:, None, 2] + Ebasis[:, None, 3])
    norm = torch.linalg.norm(Es, dim=(-2, -1), keepdim=True)
    Es = Es / torch.where(norm > 1e-12, norm, 1.0)
    return torch.where(valid[..., None, None], Es, torch.nan)


def _sampson_px(E, Kinv, p1, p2):
    """Sampson distances (H, N) in squared pixels of essentials E (H, 3, 3)
    through F = K⁻ᵀ E K⁻¹ on homogeneous pixels p1, p2 (N, 3)."""
    F = Kinv.T @ E @ Kinv
    Fx1 = p1 @ F.transpose(-1, -2)                              # (H, N, 3)
    Ftx2 = p2 @ F
    num = torch.sum(p2 * Fx1, dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-18)


def ransac_essential_5pt(pts1, pts2, K, n_iters: int = 1000, threshold_px: float = 1.0,
                         seed: int = 0, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC over 5-point minimal samples, MSAC in squared pixels
    (sfm_nerf_tpu/ops/essential5.py:169).  pts1, pts2 (N, 2) pixels, K
    (3, 3); numpy or tensors, computed on ``device`` (default: that of a
    tensor ``pts1``).  The winner (first of the highest scores) is
    re-fitted linearly on its inliers up to three times, each re-fit kept
    only where its score does not fall.  Returns (E (3, 3) unit norm,
    inlier mask (N,)) on the device."""
    if device is None:
        device = pts1.device if isinstance(pts1, torch.Tensor) else "cpu"
    pts1, pts2, K = (torch.as_tensor(a, dtype=F64, device=device) for a in (pts1, pts2, K))
    n = pts1.shape[0]
    if n < 5:
        raise ValueError("need >= 5 correspondences")
    Kinv = torch.linalg.inv(K)
    ones = torch.ones(n, 1, dtype=F64, device=pts1.device)
    p1 = torch.cat([pts1, ones], 1)
    p2 = torch.cat([pts2, ones], 1)
    h1, h2 = p1 @ Kinv.T, p2 @ Kinv.T
    # duplicate-free samples, drawn as the JAX function draws them
    if n == 5:
        idx = np.tile(np.arange(5), (n_iters, 1))
    else:
        rng = np.random.default_rng(seed)
        idx = np.argpartition(rng.random((n_iters, n)), 5, axis=1)[:, :5]
    idx = torch.as_tensor(idx, device=pts1.device)
    cands = five_point_essential(h1[idx][..., :2] / h1[idx][..., 2:],
                                 h2[idx][..., :2] / h2[idx][..., 2:]).reshape(-1, 3, 3)
    cands = cands[torch.isfinite(cands[:, 0, 0])]
    if cands.shape[0] == 0:
        raise RuntimeError("5-point solver produced no candidates")

    thr2 = threshold_px ** 2
    chunk = max(1, int(2 ** 22 // max(n, 1)))    # ~100 MB of float64 temporaries
    scores = torch.cat([-torch.clamp(_sampson_px(cands[s:s + chunk], Kinv, p1, p2),
                                     max=thr2).sum(1)
                        for s in range(0, cands.shape[0], chunk)])
    b = int(torch.argmax(scores))
    best_E, best_score = cands[b], float(scores[b])
    best_inl = _sampson_px(best_E[None], Kinv, p1, p2)[0] < thr2

    # linear re-fit on the inliers, projected to the essential manifold,
    # judged by the MSAC score that ranked the hypotheses
    for _ in range(3):
        if int(best_inl.sum()) < 8:
            break
        a1, a2 = h1[best_inl], h2[best_inl]
        A = torch.stack([a2[:, 0] * a1[:, 0], a2[:, 0] * a1[:, 1], a2[:, 0],
                         a2[:, 1] * a1[:, 0], a2[:, 1] * a1[:, 1], a2[:, 1],
                         a1[:, 0], a1[:, 1], torch.ones_like(a1[:, 0])], dim=1)
        E_lin = torch.linalg.svd(A, full_matrices=False).Vh[-1].reshape(3, 3)
        U, s, Vh = torch.linalg.svd(E_lin)
        sm = (s[0] + s[1]) / 2.0
        E_new = (U * torch.stack([sm, sm, torch.zeros_like(sm)])) @ Vh
        E_new = E_new / torch.linalg.norm(E_new)
        d_new = _sampson_px(E_new[None], Kinv, p1, p2)[0]
        inl_new = d_new < thr2
        score_new = -float(torch.clamp(d_new, max=thr2).sum())
        if score_new < best_score:
            break
        if score_new == best_score and torch.equal(inl_new, best_inl):
            best_E = E_new
            break
        best_E, best_inl, best_score = E_new, inl_new, score_new
    return best_E, best_inl
