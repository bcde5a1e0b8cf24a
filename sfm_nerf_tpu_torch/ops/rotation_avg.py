"""Global rotation averaging: the spectral (chordal) relaxation.

Same method as sfm_nerf_tpu/ops/rotation_avg.py, in float64 on the device
of its inputs.  World-to-camera rotations (projection K R [I | -C]); the
relative rotation of a pair (i, j) is R_ij = R_j R_iᵀ.  For consistent
rotations the (3N, 3N) block matrix S with S_ij = R_i R_jᵀ = R_ijᵀ is
R̂ R̂ᵀ for the (3N, 3) stack R̂ of the R_i: rank 3.  The measured blocks
(identity diagonal, duplicate edges added) are degree-normalized, the top
three eigenvectors (``torch.linalg.eigh``) give each camera's block up to
one global Q in O(3), the anchor block's transpose cancels Q and fixes the
gauge, and each block is projected to SO(3).  float32 costs about 5
degrees here (the top eigenvalue is triple): keep float64.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from sfm_nerf_tpu_torch.ops.graph import component_labels


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation(s) to ``M (..., 3, 3)`` in the Frobenius norm."""
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    D = torch.cat([torch.ones(*M.shape[:-2], 2, dtype=M.dtype, device=M.device),
                   det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vh


def rotation_averaging(pairs: Sequence[Tuple[int, int]], R_rel: torch.Tensor,
                       n_cams: int, anchor: int = 0) -> torch.Tensor:
    """Global rotations (n_cams, 3, 3) from pairwise ones, the anchor at the
    identity (sfm_nerf_tpu/ops/rotation_avg.py:42).

    ``pairs``: M host (i, j) index pairs (0-based); ``R_rel`` (M, 3, 3)
    with R_rel[m] = R_j R_iᵀ, on the device that computes.  The solve is
    restricted to the anchor's connected component: an isolated camera's
    exact eigenvalue-1 identity block would displace the component's top
    eigenvectors.  Cameras outside it come back as the identity."""
    pairs_np = np.asarray(pairs, np.int64).reshape(-1, 2)
    dev, dtype = R_rel.device, R_rel.dtype
    labels = component_labels(pairs_np, n_cams)
    comp = labels == labels[anchor]
    if not comp.all():
        keep = np.nonzero(comp)[0]
        remap = -np.ones(n_cams, np.int64)
        remap[keep] = np.arange(len(keep))
        edge_in = comp[pairs_np[:, 0]] & comp[pairs_np[:, 1]]
        R_sub = rotation_averaging(remap[pairs_np[edge_in]],
                                   R_rel[torch.as_tensor(edge_in, device=dev)],
                                   len(keep), anchor=int(remap[anchor]))
        out = torch.eye(3, dtype=dtype, device=dev).repeat(n_cams, 1, 1)
        out[torch.as_tensor(keep, device=dev)] = R_sub
        return out

    N = n_cams
    i0 = torch.as_tensor(pairs_np[:, 0], device=dev)
    i1 = torch.as_tensor(pairs_np[:, 1], device=dev)
    S = torch.zeros(3 * N, 3 * N, dtype=dtype, device=dev)
    ar = torch.arange(N, device=dev)
    S = _scatter_blocks(S, ar, ar, torch.eye(3, dtype=dtype, device=dev).expand(N, 3, 3))
    # S_ij = R_ijᵀ, S_ji = R_ij, ADDED: a pair measured twice contributes
    # both measurements, as the degrees below count both
    S = _scatter_blocks(S, i0, i1, R_rel.transpose(-1, -2), add=True)
    S = _scatter_blocks(S, i1, i0, R_rel, add=True)

    ones = torch.ones(len(pairs_np), dtype=dtype, device=dev)
    deg = torch.ones(N, dtype=dtype, device=dev).index_add(0, i0, ones).index_add(0, i1, ones)
    d = torch.repeat_interleave(1.0 / torch.sqrt(deg), 3)
    Sn = S * d[:, None] * d[None, :]

    _, vecs = torch.linalg.eigh(Sn)                # ascending eigenvalues
    blocks = vecs[:, -3:].reshape(N, 3, 3)
    # blocks_i ~ R_i Qᵀ for one global Q in O(3); blocks_i blocks_aᵀ =
    # R_i R_aᵀ cancels it and puts the anchor at the identity; project after
    R = blocks @ blocks[anchor].T[None]
    return project_to_so3(R)


def _scatter_blocks(S, rows, cols, blocks, add: bool = False):
    """S[3r:3r+3, 3c:3c+3] = (or +=) each block; ``add`` accumulates
    duplicate (row, col) pairs."""
    k = torch.arange(3, device=S.device)
    ri = (3 * rows[:, None, None] + k[None, :, None]).expand(blocks.shape)
    ci = (3 * cols[:, None, None] + k[None, None, :]).expand(blocks.shape)
    return S.index_put((ri, ci), blocks, accumulate=add)


def relative_rotation_residuals(pairs, R_rel: torch.Tensor,
                                R_glob: torch.Tensor) -> torch.Tensor:
    """Per-pair angle (radians) between the global rotations' relative
    rotation and the measured one."""
    p = torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2), device=R_glob.device)
    Ri, Rj = R_glob[p[:, 0]], R_glob[p[:, 1]]
    rel = (Rj @ Ri.transpose(-1, -2)) @ R_rel.transpose(-1, -2)
    cos = (torch.diagonal(rel, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))
