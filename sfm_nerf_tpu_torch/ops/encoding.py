"""Positional encoding.

Column order as sfm_nerf_tpu/ops/encoding.py: ``[x, sin(2^0 pi x),
cos(2^0 pi x), ..., sin(2^(L-1) pi x), cos(2^(L-1) pi x)]``, each a
3-vector.  Same arithmetic too: the phase is ``u = x * (pi * 2^l)`` with the
constant rounded once from float64, and cos is ``sin(u + pi/2)``; calling
``torch.cos`` instead differs by up to ~2e-4 at the top frequency.
"""

from __future__ import annotations

import numpy as np
import torch


def trig_constants(n_freqs: int):
    """(freqs (L,), half_pi) as float32 numpy: pi * 2^l and pi / 2, each
    rounded once from float64."""
    freqs = np.array([np.pi * 2.0**l for l in range(n_freqs)]).astype(np.float32)
    return freqs, np.float32(np.pi / 2)


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Encode ``x[..., D]`` into ``[..., D*(2*n_freqs+1)]``."""
    if n_freqs == 0:
        return x
    freqs, half_pi = trig_constants(n_freqs)
    f = torch.as_tensor(freqs, dtype=x.dtype, device=x.device)
    u = x[..., None, :] * f[:, None]                     # (..., L, D)
    enc = torch.stack([torch.sin(u), torch.sin(u + float(half_pi))], dim=-2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


# ---------------------------------------------------------------------------
# mip-NeRF: the conical frustum's Gaussian and its integrated encoding
# ---------------------------------------------------------------------------
#
# The arithmetic of the cone kernels (csrc/nerf_device.cuh), operation by
# operation: every product and sum rounded once, no fused multiply-add.


def octaves(n_freqs: int) -> np.ndarray:
    """2^l, l < n_freqs, float32: mip-NeRF's scales (no pi)."""
    return (2.0 ** np.arange(n_freqs)).astype(np.float32)


def frustum_gaussian(origins: torch.Tensor, directions: torch.Tensor, radii: torch.Tensor,
                     t0: torch.Tensor, t1: torch.Tensor):
    """(mean, cov) (n, S, 3) of the conical frustums [t0, t1] (n, S) of cones
    with apex ``origins`` (n, 3), axis ``directions`` (n, 3, not normalised)
    and radius ``radii`` (n,) at unit distance along the axis: mip-NeRF's
    stable ``conical_frustum_to_gaussian`` and ``lift_gaussian`` (diagonal
    covariance)."""
    mu = (t0 + t1) * 0.5
    hw = (t1 - t0) * 0.5
    mu2, hw2 = mu * mu, hw * hw
    hw4 = hw2 * hw2
    den = mu2 * 3.0 + hw2
    t_mean = mu + (mu * 2.0 * hw2) / den
    t_var = hw2 / 3.0 - ((hw4 * (mu2 * 12.0 - hw2)) / (den * den)) * float(np.float32(4 / 15))
    r2 = (radii * radii)[:, None]
    r_var = r2 * ((mu2 * 0.25 + hw2 * float(np.float32(5 / 12)))
                  - (hw4 / den) * float(np.float32(4 / 15)))
    dd = directions * directions                                        # (n, 3)
    mag = torch.clamp((dd[:, 0] + dd[:, 1]) + dd[:, 2], min=1e-10)
    null = 1.0 - dd / mag[:, None]
    mean = directions[:, None, :] * t_mean[..., None] + origins[:, None, :]
    cov = t_var[..., None] * dd[:, None, :] + r_var[..., None] * null[:, None, :]
    return mean, cov


def integrated_pos_enc(mean: torch.Tensor, cov: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """mip-NeRF's integrated positional encoding of Gaussians (..., 3):
    ``[e sin(y), e sin(y + pi/2)]`` with ``y = mean 2^l``, ``e =
    exp(-cov 4^l / 2)``, all the sines first, each octave a 3-vector:
    (..., 6 n_freqs)."""
    f = torch.as_tensor(octaves(n_freqs), dtype=mean.dtype, device=mean.device)
    y = (mean[..., None, :] * f[:, None]).reshape(*mean.shape[:-1], -1)
    e = torch.exp((cov[..., None, :] * (f * f)[:, None]).reshape(*cov.shape[:-1], -1) * -0.5)
    half_pi = float(trig_constants(0)[1])
    return torch.cat([e * torch.sin(y), e * torch.sin(y + half_pi)], -1)


def view_encoding(viewdirs: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """mip-NeRF's encoding of the view direction: ``[v, sin(v 2^l),
    sin(v 2^l + pi/2)]``, all the sines first: (..., 3 (2 n_freqs + 1))."""
    f = torch.as_tensor(octaves(n_freqs), dtype=viewdirs.dtype, device=viewdirs.device)
    y = (viewdirs[..., None, :] * f[:, None]).reshape(*viewdirs.shape[:-1], -1)
    half_pi = float(trig_constants(0)[1])
    return torch.cat([viewdirs, torch.sin(y), torch.sin(y + half_pi)], -1)
