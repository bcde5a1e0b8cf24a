"""Stratified sampling and volume rendering (flat path).

The two compositor variants of sfm_nerf_tpu/ops/render.py:

- ``'train'``: t in midpoint-jittered linspace(0, 1, S) bins, dists with
  1e-3 appended, exclusive transmittance
  ``T[:, 1:] = cumprod(1 - alpha + 1e-10)[:, :-1]``;
- ``'legacy'`` (gif path): ``t = (i + u) / S`` per-bin jitter, dists with
  1.0 appended, inclusive transmittance ``w = alpha * cumprod(...)``.

Random draws come from a ``torch.Generator``; a caller may pass the uniform
draw ``u`` itself (tests feed both packages the same numbers).  Without a
generator and without ``u`` the samples are deterministic, whatever
``cfg.perturb`` says, as the JAX functions are without a key.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sfm_nerf_tpu_torch.config import RenderConfig

ModelFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def stratified_samples(
    n_rays: int,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Depth values z (n_rays, n_sample) float32 along each ray."""
    S = cfg.n_sample
    perturb = cfg.perturb and (generator is not None or u is not None)
    if perturb and u is None:
        u = torch.rand((n_rays, S), generator=generator, device=device)

    def to_depth(t):
        if cfg.lindisp:
            if cfg.near <= 0:
                raise ValueError("lindisp requires near > 0")
            return 1.0 / (1.0 / cfg.near * (1.0 - t) + 1.0 / cfg.far * t)
        return cfg.near + (cfg.far - cfg.near) * t

    if cfg.variant == "legacy":
        idx = torch.arange(S, dtype=torch.float32, device=device)[None, :]
        if not perturb:
            u = torch.full((n_rays, S), 0.5, device=device)
        return to_depth((idx + u.to(device, torch.float32)) / S)

    t = torch.linspace(0.0, 1.0, S, device=device)[None, :].expand(n_rays, S)
    if perturb:
        mids = 0.5 * (t[..., 1:] + t[..., :-1])
        upper = torch.cat([mids, t[..., -1:]], -1)
        lower = torch.cat([t[..., :1], mids], -1)
        t = lower + (upper - lower) * u.to(device, torch.float32)
    return to_depth(t).contiguous()


def sample_dists(z_vals: torch.Tensor, variant: str) -> torch.Tensor:
    """diff(z) with the variant's tail distance appended."""
    tail = 1e-3 if variant == "train" else 1.0
    return torch.cat(
        [z_vals[..., 1:] - z_vals[..., :-1],
         torch.full_like(z_vals[..., :1], tail)], -1)


def composite(
    density: torch.Tensor,   # (N, S, 1)
    rgb: torch.Tensor,       # (N, S, 3)
    z_vals: torch.Tensor,    # (N, S)
    cfg: RenderConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alpha-composite samples: (rgb (N, 3), weights (N, S), acc (N,))."""
    dists = sample_dists(z_vals, cfg.variant)
    alpha = 1.0 - torch.exp(-density[..., 0] * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    if cfg.variant == "train":
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    weights = alpha * trans
    out = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    if cfg.white_background:
        out = out + (1.0 - acc[..., None])
    return out, weights, acc


def _points(origins, directions, z_vals):
    pts = origins[:, None, :] + directions[:, None, :] * z_vals[..., None]
    return pts, directions[:, None, :].expand(pts.shape)


def render_rays(
    model_fn: ModelFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    z_vals: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample (unless the depths ``z_vals`` are given) -> evaluate
    ``model_fn(points, dirs)`` -> composite: (N, 3)."""
    if z_vals is None:
        z_vals = stratified_samples(origins.shape[0], cfg, generator, origins.device)
    density, rgb = model_fn(*_points(origins, directions, z_vals))
    return composite(density, rgb, z_vals, cfg)[0]


def weight_maps(
    weights: torch.Tensor,   # (N, S)
    z_vals: torch.Tensor,    # (N, S)
    acc: torch.Tensor,       # (N,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth (N,), disparity (N,)): depth = sum(w z), un-normalised;
    disparity = 1 / max(1e-10, depth / max(acc, 1e-10))."""
    depth = torch.sum(weights * z_vals, dim=-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    return depth, disp


def render_rays_aux(
    model_fn: ModelFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
):
    """render_rays returning (rgb (N,3), depth (N,), disp (N,), acc (N,))."""
    z_vals = stratified_samples(origins.shape[0], cfg, generator, origins.device)
    density, rgb = model_fn(*_points(origins, directions, z_vals))
    out, weights, acc = composite(density, rgb, z_vals, cfg)
    depth, disp = weight_maps(weights, z_vals, acc)
    return out, depth, disp, acc


def render_rays_chunked(
    model_fn: ModelFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    chunk_rays: int = 2048,
) -> torch.Tensor:
    """Full-frame render in ray chunks, bounding the (rays, samples,
    hidden) activations to one chunk's worth."""
    return torch.cat([
        render_rays(model_fn, origins[i:i + chunk_rays],
                    directions[i:i + chunk_rays], cfg, generator)
        for i in range(0, origins.shape[0], chunk_rays)
    ])


def render_rays_chunked_aux(
    model_fn: ModelFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    chunk_rays: int = 2048,
):
    """Chunked render_rays_aux: (rgb (N,3), depth (N,), disp (N,), acc (N,))."""
    parts = [
        render_rays_aux(model_fn, origins[i:i + chunk_rays],
                        directions[i:i + chunk_rays], cfg, generator)
        for i in range(0, origins.shape[0], chunk_rays)
    ]
    return tuple(torch.cat(p) for p in zip(*parts))
