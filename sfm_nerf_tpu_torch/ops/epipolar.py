"""Epipolar geometry: 8-point F, Sampson scoring, fixed-iteration RANSAC,
the essential matrix and its decomposition.

Same algorithms as sfm_nerf_tpu/ops/epipolar.py (the reference's
Phase1/Fundamental.py reshaped for an accelerator), in float64:

- minimal samples are drawn without replacement by a sparse Fisher-Yates
  on the device (``draw_minimal_samples``), or passed in as an explicit
  ``(n_chunks * chunk, 8)`` index tensor;
- hypotheses are scored in chunks of ``chunk`` (1,024), so a launch holds
  chunk x N residuals, not n_iters x N; the hypothesis solve is the
  fixed-sweep Jacobi path over blocks of ``SOLVE_BLOCK`` hypotheses, the
  winner's re-solve LAPACK-grade;
- ties go to the first maximum (``torch.argmax``);
- every pair of a launch is scored together: pairs are padded to the
  launch's largest match count and a valid mask stands for each pair's
  count (``ransac_fundamental_pairs``).

The adaptive (confidence-driven) drivers of the JAX package are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sfm_nerf_tpu_torch.ops.linalg import (
    column_at_argmin,
    homogenize,
    jacobi_eigh_small,
    smallest_eigvec_of_normal,
    smallest_eigvec_of_normal_fast,
)

F64 = torch.float64


# Hypotheses per minimal-solve batch: the solves are elementwise over the
# batch, so this many go through one sequence of launches (a few thousand
# small ones for the Jacobi sweeps) before they are scored chunk by chunk.
SOLVE_BLOCK = 8192


def solve_block(chunk: int) -> int:
    """SOLVE_BLOCK rounded down to whole chunks (at least one)."""
    return max(chunk, SOLVE_BLOCK // chunk * chunk)


def draw_minimal_samples(n_hyp: int, k: int, n_valid: int,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> torch.Tensor:
    """(n_hyp, k) duplicate-free minimal samples of rows ``[0, n_valid)``.

    Sparse Fisher-Yates, as sfm_nerf_tpu/ops/epipolar.py:40: per hypothesis
    k draws ``j_i ~ U[i, n_valid)`` and a k-slot virtual-swap map resolved
    by compare/select, so every k-permutation is equally likely and the
    cost is independent of the row count.  The uniforms come from
    ``generator`` on ``device``.  ``n_valid < k`` draws from the first k
    rows."""
    nv = max(int(n_valid), k)
    u = torch.rand((n_hyp, k), generator=generator, dtype=F64, device=device)
    lo = torch.arange(k, device=device)
    j = lo + torch.floor(u * (nv - lo).to(F64)).long()
    j = torch.minimum(j, torch.full_like(j, nv - 1))

    mpos = torch.full((n_hyp, k), -1, dtype=torch.long, device=device)
    mval = torch.zeros((n_hyp, k), dtype=torch.long, device=device)

    def lookup(pos, upto):
        # a[pos] under the swaps recorded so far; later slots win
        v = pos
        for t in range(upto):
            v = torch.where(mpos[:, t] == pos, mval[:, t], v)
        return v

    outs = []
    for i in range(k):
        ji = j[:, i]
        outs.append(lookup(ji, i))                       # out[i] = a[j]
        mval[:, i] = lookup(torch.full_like(ji, i), i)   # a[j] = a[i]
        mpos[:, i] = ji
    return torch.stack(outs, dim=-1)


def normalization_matrix(points: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Similarity transform: centroid -> origin, RMS distance -> sqrt(2).
    ``points[..., N, 2]`` -> ``[..., 3, 3]``; ``mask[..., N]`` restricts the
    statistics to valid rows."""
    if mask is None:
        centroid = torch.mean(points, dim=-2)
        d2 = torch.sum((points - centroid[..., None, :]) ** 2, dim=-1)
        rms = torch.sqrt(torch.mean(d2, dim=-1))
    else:
        w = mask.to(points.dtype)
        n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        centroid = torch.sum(points * w[..., None], dim=-2) / n[..., None]
        d2 = torch.sum((points - centroid[..., None, :]) ** 2, dim=-1) * w
        rms = torch.sqrt(torch.sum(d2, dim=-1) / n)
    s = np.sqrt(2.0) / rms
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * centroid[..., 0]], -1),
        torch.stack([zero, s, -s * centroid[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def _constraint_rows(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """(..., N, 9) rows fitting h2ᵀ F h1 = 0:
    [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1] (the JAX package's layout,
    not the reference's transposed one; see its _constraint_rows)."""
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], -1)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = (U * S[..., None, :]) @ Vh
    return F / F[..., 2:3, 2:3]


def eight_point(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """Least-squares F from ``pts[..., N, 2]``, rank 2, F[2,2] = 1."""
    f = smallest_eigvec_of_normal(_constraint_rows(pts1, pts2))
    return _rank2(f.reshape(*f.shape[:-1], 3, 3))


def eight_point_fast(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """``eight_point`` on the fixed-sweep Jacobi path: the 9x9 null vector,
    and rank 2 as F - (F v3) v3ᵀ with v3 the smallest right-singular
    vector from Jacobi on FᵀF."""
    f = smallest_eigvec_of_normal_fast(_constraint_rows(pts1, pts2))
    F = f.reshape(*f.shape[:-1], 3, 3)
    evals, V = jacobi_eigh_small(F.transpose(-1, -2) @ F, sweeps=6)
    v3 = column_at_argmin(evals, V)
    Fv3 = (F @ v3[..., None])[..., 0]
    F = F - Fv3[..., :, None] * v3[..., None, :]
    return F / F[..., 2:3, 2:3]


def weighted_eight_point(pts1: torch.Tensor, pts2: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """F from a weighted point set: 0/1 weights select the RANSAC inliers."""
    A = _constraint_rows(pts1, pts2) * weights[..., None]
    f = smallest_eigvec_of_normal(A)
    return _rank2(f.reshape(*f.shape[:-1], 3, 3))


def _lines(F, h):
    """The three components of the lines F h for every hypothesis and row:
    F (..., H, 3, 3), h (..., N, 3) -> three (..., H, N) tensors."""
    hx, hy, hw = (h[..., None, :, i] for i in range(3))
    return [F[..., i, 0, None] * hx + F[..., i, 1, None] * hy
            + F[..., i, 2, None] * hw for i in range(3)]


def sampson_distance(F: torch.Tensor, h1: torch.Tensor,
                     h2: torch.Tensor) -> torch.Tensor:
    """The reference's Sampson variant (Fundamental.py:104-116): the lines
    F h1 and F h2 are normalized over their first two components, then
    d = (h2 . F h1)² / (l1_0² + l1_1² + l2_0² + l2_1²).

    ``F[..., H, 3, 3]`` hypotheses, ``h1/h2[..., N, 3]`` with F's leading
    dims but H -> ``[..., H, N]``.  Each line component is its own (H, N)
    tensor, so no (H, N, 3) intermediate is held."""
    a1, b1, c1 = _lines(F, h1)
    a2, b2, _ = _lines(F, h2)
    n1 = torch.sqrt(a1 * a1 + b1 * b1) + 1e-32
    n2 = torch.sqrt(a2 * a2 + b2 * b2) + 1e-32
    a1, b1, c1 = a1 / n1, b1 / n1, c1 / n1
    a2, b2 = a2 / n2, b2 / n2
    num = (h2[..., None, :, 0] * a1 + h2[..., None, :, 1] * b1
           + h2[..., None, :, 2] * c1) ** 2
    return num / (a1 ** 2 + b1 ** 2 + a2 ** 2 + b2 ** 2)


def _ransac_score(d: torch.Tensor, threshold: float, scoring: str) -> torch.Tensor:
    """Per-hypothesis score (higher is better) from gated residuals
    ``d[..., N]``: 'msac' the negative sum of threshold-truncated residuals
    (NaN counts as an outlier), 'count' the raw inlier count."""
    if scoring == "msac":
        d = torch.where(torch.isnan(d), torch.inf, d)
        return -torch.sum(torch.clamp(d, max=threshold), dim=-1)
    if scoring == "count":
        return torch.sum(d < threshold, dim=-1).to(d.dtype)
    raise ValueError(f"unknown RANSAC scoring '{scoring}'")


class RansacResult(NamedTuple):
    F: torch.Tensor            # (..., 3, 3) denormalized fundamental matrix
    inliers: torch.Tensor      # (..., N) bool mask
    n_inliers: torch.Tensor    # (...) int
    best_iter: torch.Tensor    # (...) int (winning hypothesis index)


def _ransac_prep(pts1, pts2, normalize, valid):
    """Hartley-normalize (or not) and homogenize; pts (..., N, 2).
    Returns (T1, T2, p1, p2, h1, h2)."""
    if normalize:
        T1 = normalization_matrix(pts1, valid)
        T2 = normalization_matrix(pts2, valid)
        h1 = homogenize(pts1) @ T1.transpose(-1, -2)
        h2 = homogenize(pts2) @ T2.transpose(-1, -2)
        p1, p2 = h1[..., :2], h2[..., :2]
    else:
        eye = torch.eye(3, dtype=pts1.dtype, device=pts1.device)
        T1 = T2 = eye.expand(*pts1.shape[:-2], 3, 3)
        p1, p2 = pts1, pts2
        h1, h2 = homogenize(pts1), homogenize(pts2)
    return T1, T2, p1, p2, h1, h2


def _take_rows(p, idx):
    """p (P, N, c), idx (P, ..., k) -> (P, ..., k, c)."""
    P = p.shape[0]
    b = torch.arange(P, device=p.device).reshape(P, *([1] * (idx.dim() - 1)))
    return p[b, idx]


def ransac_fundamental_pairs(
    pts1: torch.Tensor,        # (P, N, 2) pixel coords, padded per pair
    pts2: torch.Tensor,        # (P, N, 2)
    samples: torch.Tensor,     # (P, n_chunks * chunk, 8) minimal samples
    n_valid: Optional[torch.Tensor] = None,   # (P,) true match counts
    threshold: float = 5e-4,
    normalize: bool = True,
    chunk: int = 1024,
    scoring: str = "msac",
) -> RansacResult:
    """Fixed-iteration F-RANSAC over a pair axis in one launch sequence
    (sfm_nerf_tpu/ops/epipolar.py:695).  Rows at or past a pair's
    ``n_valid`` are padding: they never score and never count as inliers.
    Each chunk scores ``chunk`` hypotheses of every pair; the scores stay
    on the device, and the winner's sample is re-solved LAPACK-grade
    (eigh and SVD), its inliers re-estimated and denormalized
    (Fundamental.py:133-137)."""
    P, N = pts1.shape[:2]
    valid = None
    if n_valid is not None:
        valid = torch.arange(N, device=pts1.device)[None, :] < n_valid[:, None]
    T1, T2, p1, p2, h1, h2 = _ransac_prep(pts1, pts2, normalize, valid)
    total = samples.shape[1]
    if total % chunk:
        raise ValueError(f"{total} samples are not whole chunks of {chunk}")
    scores = []
    for b in range(0, total, solve_block(chunk)):
        idx = samples[:, b:b + solve_block(chunk)]              # (P, block, 8)
        F_block = eight_point_fast(_take_rows(p1, idx), _take_rows(p2, idx))
        for c in range(0, idx.shape[1], chunk):
            F = F_block[:, c:c + chunk]
            d = sampson_distance(F, h1, h2)                     # (P, chunk, N)
            if valid is not None:
                d = torch.where(valid[:, None, :], d, torch.inf)
            score = _ransac_score(d, threshold, scoring)
            # draws are duplicate-free; other degeneracies can still give a
            # non-finite F
            ok = torch.all(torch.isfinite(F.flatten(-2)), dim=-1)
            scores.append(torch.where(ok, score, -torch.inf))
    best = torch.argmax(torch.cat(scores, dim=1), dim=1)       # (P,)
    idx_best = torch.gather(samples, 1, best[:, None, None].expand(P, 1, 8))[:, 0]
    F, inliers = _ransac_winner(idx_best, T1, T2, p1, p2, h1, h2, threshold,
                                normalize, valid)
    return RansacResult(F, inliers, inliers.sum(-1), best)


def _ransac_winner(idx_best, T1, T2, p1, p2, h1, h2, threshold, normalize,
                   valid):
    """LAPACK-grade re-solve of each pair's winning sample (P, 8), its
    inlier set, the all-inlier re-estimation, denormalization."""
    Fb = eight_point(_take_rows(p1, idx_best), _take_rows(p2, idx_best))
    d = sampson_distance(Fb[:, None], h1, h2)[:, 0]
    if valid is not None:
        d = torch.where(valid, d, torch.inf)
    inliers = d < threshold
    F = weighted_eight_point(p1, p2, inliers.to(p1.dtype))
    if normalize:
        F = T2.transpose(-1, -2) @ F @ T1
    return F, inliers


def ransac_fundamental(
    pts1: torch.Tensor,        # (N, 2)
    pts2: torch.Tensor,
    n_iters: int = 50000,
    threshold: float = 5e-4,
    normalize: bool = True,
    chunk: int = 1024,
    n_valid: Optional[int] = None,
    scoring: str = "msac",
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> RansacResult:
    """RANSAC F-estimation of one pair (sfm_nerf_tpu/ops/epipolar.py:302):
    ``ceil(n_iters / chunk) * chunk`` hypotheses, drawn from ``generator``
    unless ``samples`` (that many rows of 8 indices) is given."""
    n_pts = pts1.shape[0]
    nv = n_pts if n_valid is None else int(n_valid)
    if n_pts < 8:
        # fewer rows than a sample: draws reach rows [0, 8), so pad to 8
        # and mask the padding out
        pts1, pts2 = pad_rows(pts1, 8), pad_rows(pts2, 8)
        n_valid = nv
    if samples is None:
        total = -(-n_iters // chunk) * chunk
        samples = draw_minimal_samples(total, 8, nv, generator, pts1.device)
    res = ransac_fundamental_pairs(
        pts1[None], pts2[None], samples[None].to(pts1.device),
        None if n_valid is None else torch.tensor([nv], device=pts1.device),
        threshold=threshold, normalize=normalize, chunk=chunk,
        scoring=scoring)
    return RansacResult(res.F[0], res.inliers[0, :n_pts], res.n_inliers[0],
                        res.best_iter[0])


def pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``n`` rows."""
    return torch.cat([t, t.new_zeros(n - t.shape[0], *t.shape[1:])]) \
        if t.shape[0] < n else t


def _host_result(res: RansacResult, n: Sequence[int]):
    """One copy of a launch's results to the host, split per pair."""
    P = res.F.shape[0]
    packed = torch.cat([res.F.reshape(P, 9), res.inliers.to(F64),
                        res.n_inliers[:, None].to(F64),
                        res.best_iter[:, None].to(F64)], dim=1).cpu().numpy()
    return [RansacResult(packed[m, :9].reshape(3, 3),
                         packed[m, 9:9 + n[m]] > 0.5,
                         np.int64(packed[m, -2]), np.int64(packed[m, -1]))
            for m in range(len(n))]


def ransac_fundamental_bucketed(
    pts1_np, pts2_np,
    n_iters: int = 50000,
    threshold: float = 5e-4,
    normalize: bool = True,
    chunk: int = 1024,
    scoring: str = "msac",
    generator: Optional[torch.Generator] = None,
    device=None,
) -> RansacResult:
    """Host wrapper of ``ransac_fundamental`` (the JAX name; there is no
    shape bucket here): numpy in, numpy out, one copy back."""
    p1 = torch.as_tensor(np.asarray(pts1_np, np.float64), device=device)
    p2 = torch.as_tensor(np.asarray(pts2_np, np.float64), device=device)
    res = ransac_fundamental(p1, p2, n_iters=n_iters, threshold=threshold,
                             normalize=normalize, chunk=chunk,
                             scoring=scoring, generator=generator)
    return _host_result(RansacResult(*(t[None] for t in res)), [len(pts1_np)])[0]


def launch_groups(sizes: Sequence[int], max_pairs_per_launch: int = 64):
    """Pair positions grouped into launches: sorted by match count, each
    launch padded to its largest count, at most
    ``max_pairs_per_launch * 1024 / max(count, 1024)`` pairs a launch, so
    one launch's pairs x chunk x rows stays at the JAX package's cap
    (epipolar.py:926-930; 0.5 GB of float64 residuals at chunk 1,024)."""
    order = sorted(range(len(sizes)), key=lambda m: sizes[m])
    groups, cur = [], []
    for m in order:
        n_max = max(sizes[m], 1024)
        if cur and len(cur) + 1 > max(1, (max_pairs_per_launch * 1024) // n_max):
            groups.append(cur)
            cur = []
        cur.append(m)
    if cur:
        groups.append(cur)
    return groups


def ransac_fundamental_pairs_bucketed(
    items,                    # sequence of (pts1_np, pts2_np)
    n_iters: int = 50000,
    threshold: float = 5e-4,
    normalize: bool = True,
    chunk: int = 1024,
    scoring: str = "msac",
    max_pairs_per_launch: int = 64,
    generator: Optional[torch.Generator] = None,
    device=None,
    samples: Optional[Sequence[torch.Tensor]] = None,
):
    """Host wrapper for the whole refine stage (epipolar.py:883): every
    pair's samples drawn in input order, pairs grouped into launches by
    ``launch_groups``, one copy back per launch; per-item numpy
    ``RansacResult``s in input order.  ``samples`` (one index tensor per
    item) replaces the draws."""
    items = list(items)
    total = -(-n_iters // chunk) * chunk
    if samples is None:
        samples = [draw_minimal_samples(total, 8, len(a), generator, device)
                   for a, _ in items]
    out = [None] * len(items)
    for group in launch_groups([len(a) for a, _ in items], max_pairs_per_launch):
        n = [len(items[m][0]) for m in group]
        width = max(max(n), 8)          # draws reach rows [0, 8)
        p1 = np.zeros((len(group), width, 2))
        p2 = np.zeros((len(group), width, 2))
        for r, m in enumerate(group):
            p1[r, :n[r]] = np.asarray(items[m][0], np.float64)
            p2[r, :n[r]] = np.asarray(items[m][1], np.float64)
        res = ransac_fundamental_pairs(
            torch.as_tensor(p1, device=device), torch.as_tensor(p2, device=device),
            torch.stack([samples[m].to(device) for m in group]),
            torch.as_tensor(n, device=device), threshold=threshold,
            normalize=normalize, chunk=chunk, scoring=scoring)
        for m, r in zip(group, _host_result(res, n)):
            out[m] = r
    return out


def essential_from_fundamental(K: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """E = Kᵀ F K (Fundamental.py:141-147)."""
    return K.T @ F @ K


def cleanup_essential(E: torch.Tensor) -> torch.Tensor:
    """Project E onto the essential manifold: singular values -> (1, 1, 0)."""
    U, _, Vh = torch.linalg.svd(E)
    S = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * S) @ Vh


def decompose_essential(
    E: torch.Tensor, center_convention: str = "reference"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Four candidate (C, R) pairs from E (Fundamental.py:149-173), in the
    reference's order [(C,+W), (-C,+W), (C,+Wᵀ), (-C,+Wᵀ)], each with
    det(R) > 0 (C and R negated together).  ``'reference'`` takes U[:,2]
    as the centre (the reference's quirk); ``'hz'`` gives C = -Rᵀ(±U[:,2]).
    Returns (Cs (4, 3), Rs (4, 3, 3))."""
    if center_convention not in ("hz", "reference"):
        raise ValueError(f"unknown center convention {center_convention!r}")
    U, _, Vh = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    C = U[:, 2]
    R_a = U @ W @ Vh
    R_b = U @ W.T @ Vh
    Cs = torch.stack([C, -C, C, -C])
    Rs = torch.stack([R_a, R_a, R_b, R_b])
    neg = torch.linalg.det(Rs) < 0
    Cs = torch.where(neg[:, None], -Cs, Cs)
    Rs = torch.where(neg[:, None, None], -Rs, Rs)
    if center_convention == "hz":
        Cs = -torch.einsum("nji,nj->ni", Rs, Cs)
    return Cs, Rs
