"""Stratified sampling, volume rendering and hierarchical (coarse/fine)
sampling.

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

Hierarchical sampling: a coarse pass gives per-sample weights, ``sample_pdf``
draws ``n_importance`` more depths from their histogram (inverse CDF,
weights detached), ``merge_sorted`` unites them with the coarse depths, and
a fine pass renders the union.  The JAX package writes the interval lookup
as one broadcast compare and the union as a bitonic roll network because
TPU gathers and sorts are slow; here they are ``torch.searchsorted`` +
``gather`` and ``torch.sort``, which select the same values.

Cone casting (mip-NeRF, a model of arch 'mip'): ``cone_edges``
gives the coarse level's ``n_sample + 1`` edges, ``render_cones`` turns
each interval into its conical frustum's Gaussian and composites over the
interval lengths (``composite_intervals``), and ``resample_edges`` draws
the fine level's edges from the coarse weights (mip-NeRF's
``resample_along_rays``), on the device, weights detached.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sfm_nerf_tpu_torch.config import RenderConfig
from sfm_nerf_tpu_torch.ops.encoding import frustum_gaussian
from sfm_nerf_tpu_torch.utils.profiling import count, span

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


# ---------------------------------------------------------------------------
# hierarchical sampling
# ---------------------------------------------------------------------------


def sample_pdf(
    bins: torch.Tensor,       # (N, S-1) bin edges (z midpoints)
    weights: torch.Tensor,    # (N, S-2) coarse weights over the interior bins
    n_importance: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF importance sampling over the coarse weight histogram:
    (N, n_importance) depths, ascending per ray.

    With a generator, or the jitter ``u`` (N, n_importance) in [0, 1) given,
    the draw is stratified per slot, ``(i + u_i) / n_importance``, so the
    outputs are non-decreasing by construction; with neither it is
    ``linspace(0, 1 - 1e-5, n_importance)``."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)          # (N, S-1)
    n, dev = cdf.shape[0], cdf.device
    slots = torch.arange(n_importance, dtype=cdf.dtype, device=dev)
    if u is None and generator is not None:
        u = torch.rand((n, n_importance), generator=generator, device=dev, dtype=cdf.dtype)
    if u is not None:
        u = (slots + u.to(dev, cdf.dtype)) / n_importance
    else:
        # stop * (i / (NI - 1)): the arithmetic of jnp.linspace from 0
        count("upload_bytes", cdf.element_size())
        with span("upload.pdf_top"):
            top = torch.tensor(1.0 - 1e-5, dtype=cdf.dtype, device=dev)
        u = (top * (slots / max(n_importance - 1, 1)))[None, :].expand(n, n_importance)
    u = u.contiguous()
    # bins aligned to the cdf's length: cut, or the last edge repeated
    Sc = cdf.shape[-1]
    if bins.shape[-1] >= Sc:
        bins = bins[..., :Sc]
    else:
        bins = torch.cat([bins, bins[..., -1:].expand(-1, Sc - bins.shape[-1])], -1)
    # below = last s with cdf[s] <= u (cdf[0] = 0, so it exists); above =
    # first s with cdf[s] > u, the last bin when u lies past the cdf's end
    # (a float32 cumsum may end a hair under 1)
    # (a full frame's index tensors are (N, NI) int64: freed as soon as used)
    idx = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=Sc - 1)
    del idx
    cdf_below, cdf_above = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_below, bins_above = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    del below, above
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two per-row ascending arrays (N, A), (N, B) -> (N, A + B) ascending,
    elementwise equal to sorting their concatenation.  Equal values are all
    kept."""
    return torch.sort(torch.cat([a, b.to(a.dtype)], -1), -1).values


def _hierarchical_body(coarse_fn, fine_fn, origins, directions, cfg, n_importance,
                       generator=None, u=None, u_pdf=None):
    """The coarse and the fine pass: (rgb_f, rgb_c, weights_f, z_all, acc_f).
    The depth jitter is drawn before the importance jitter."""
    z_coarse = stratified_samples(origins.shape[0], cfg, generator, origins.device, u)
    density_c, rgb_c = coarse_fn(*_points(origins, directions, z_coarse))
    out_c, weights, _ = composite(density_c, rgb_c, z_coarse, cfg)
    mids = 0.5 * (z_coarse[..., 1:] + z_coarse[..., :-1])                # (N, S-1)
    # the weights are detached into the importance sampler: the coarse
    # model learns from its own MSE only, as in the fused training step,
    # whose weights output has no backward
    z_fine = sample_pdf(mids, weights[..., 1:-1].detach(), n_importance, generator, u_pdf)
    z_all = merge_sorted(z_coarse, z_fine)                               # (N, S+I)
    density_f, rgb_f = fine_fn(*_points(origins, directions, z_all))
    out_f, weights_f, acc_f = composite(density_f, rgb_f, z_all, cfg)
    return out_f, out_c, weights_f, z_all, acc_f


def render_rays_hierarchical(
    coarse_fn: ModelFn,
    fine_fn: ModelFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: RenderConfig,
    n_importance: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    u_pdf: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass coarse/fine render: (rgb_fine (N, 3), rgb_coarse (N, 3)).
    The fine pass evaluates the union of the coarse and the importance
    depths, sorted per ray.  ``u`` (N, n_sample) and ``u_pdf``
    (N, n_importance) replace the generator's two draws."""
    out_f, out_c, _, _, _ = _hierarchical_body(
        coarse_fn, fine_fn, origins, directions, cfg, n_importance, generator, u, u_pdf)
    return out_f, out_c


def render_rays_hierarchical_aux(
    coarse_fn: ModelFn,
    fine_fn: ModelFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: RenderConfig,
    n_importance: int,
    generator: Optional[torch.Generator] = None,
):
    """Hierarchical render with the fine pass's maps:
    (rgb_fine (N,3), depth (N,), disp (N,), acc (N,))."""
    out_f, _, weights_f, z_all, acc_f = _hierarchical_body(
        coarse_fn, fine_fn, origins, directions, cfg, n_importance, generator)
    depth, disp = weight_maps(weights_f, z_all, acc_f)
    return out_f, depth, disp, acc_f


def render_rays_hierarchical_chunked(
    coarse_fn: ModelFn,
    fine_fn: ModelFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: RenderConfig,
    n_importance: int,
    generator: Optional[torch.Generator] = None,
    chunk_rays: int = 2048,
) -> torch.Tensor:
    """Full-frame hierarchical render in ray chunks: the fine rgb (N, 3)."""
    return torch.cat([
        render_rays_hierarchical(coarse_fn, fine_fn, origins[i:i + chunk_rays],
                                 directions[i:i + chunk_rays], cfg, n_importance, generator)[0]
        for i in range(0, origins.shape[0], chunk_rays)
    ])


def render_rays_hierarchical_chunked_aux(
    coarse_fn: ModelFn,
    fine_fn: ModelFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cfg: RenderConfig,
    n_importance: int,
    generator: Optional[torch.Generator] = None,
    chunk_rays: int = 2048,
):
    """Chunked render_rays_hierarchical_aux:
    (rgb (N,3), depth (N,), disp (N,), acc (N,))."""
    parts = [
        render_rays_hierarchical_aux(coarse_fn, fine_fn, origins[i:i + chunk_rays],
                                     directions[i:i + chunk_rays], cfg, n_importance, generator)
        for i in range(0, origins.shape[0], chunk_rays)
    ]
    return tuple(torch.cat(p) for p in zip(*parts))


# ---------------------------------------------------------------------------
# cone casting (mip-NeRF)
# ---------------------------------------------------------------------------

RESAMPLE_EPS = 1e-5     # sorted_piecewise_constant_pdf's eps: the weights' floor and u's margin
RESAMPLE_PADDING = 0.01     # mip-NeRF's floor under the blurred coarse weights


def cone_edges(
    n_rays: int,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    device="cpu",
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The coarse level's edges (n_rays, n_sample + 1): ``near (1 - s) + far
    s`` at ``s = k / n_sample``; with a generator (or the jitter ``u`` given,
    (n_rays, n_sample + 1)) each edge moves uniformly between the midpoints
    around it, the first and last edge toward their one neighbour only."""
    S = cfg.n_sample
    s = torch.arange(S + 1, dtype=torch.float32, device=device) / S
    t = (cfg.near * (1.0 - s) + cfg.far * s)[None, :].expand(n_rays, S + 1)
    if cfg.perturb and (u is not None or generator is not None):
        if u is None:
            u = torch.rand((n_rays, S + 1), generator=generator, device=device)
        mids = 0.5 * (t[..., 1:] + t[..., :-1])
        upper = torch.cat([mids, t[..., -1:]], -1)
        lower = torch.cat([t[..., :1], mids], -1)
        t = lower + (upper - lower) * u.to(device, torch.float32)
    return t.contiguous()


def composite_intervals(
    density: torch.Tensor,   # (N, S, 1)
    rgb: torch.Tensor,       # (N, S, 3)
    t: torch.Tensor,         # (N, S + 1) edges
    norms: torch.Tensor,     # (N,) |d|
    cfg: RenderConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mip-NeRF's compositing over the intervals: ``delta = (t1 - t0) |d|``,
    exclusive transmittance ``exp(-cumsum(sigma delta))``: (rgb (N, 3),
    weights (N, S), acc (N,))."""
    x = density[..., 0] * ((t[..., 1:] - t[..., :-1]) * norms[:, None])
    alpha = 1.0 - torch.exp(-x)
    trans = torch.exp(-torch.cat([torch.zeros_like(x[..., :1]),
                                  torch.cumsum(x[..., :-1], -1)], -1))
    weights = alpha * trans
    out = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    if cfg.white_background:
        out = out + (1.0 - acc[..., None])
    return out, weights, acc


def render_cones(
    model_fn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cones: torch.Tensor,
    t: torch.Tensor,
    cfg: RenderConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level of cone casting through ``model_fn(mean, viewdir, cov) ->
    (density, rgb)``: (rgb (N, 3), weights (N, S), acc (N,))."""
    mean, cov = frustum_gaussian(origins, directions, cones[:, 0], t[:, :-1], t[:, 1:])
    v = directions / cones[:, 1:2]
    density, rgb = model_fn(mean, v[:, None, :].expand(mean.shape), cov)
    return composite_intervals(density, rgb, t, cones[:, 1], cfg)


def resample_edges(
    t: torch.Tensor,          # (N, S + 1) coarse edges
    weights: torch.Tensor,    # (N, S) coarse weights
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fine level's S + 1 edges, sorted: the weights padded with their
    end values, a 2-tap max and a 2-tap mean, RESAMPLE_PADDING added,
    then inverse-CDF sampling of that piecewise-constant density over the
    coarse edges (mip-NeRF's ``sorted_piecewise_constant_pdf``) at ``u_k =
    k / (S + 1) + r_k (1 / (S + 1) - eps)`` capped at ``1 - eps``, with
    ``r`` (N, S + 1) uniform from the generator or given as ``u``; with
    neither, ``u = linspace(0, 1 - eps, S + 1)``.  No gradient; nothing is
    copied from the host."""
    eps = RESAMPLE_EPS
    w = weights.detach()
    wp = torch.cat([w[..., :1], w, w[..., -1:]], -1)
    wm = torch.maximum(wp[..., :-1], wp[..., 1:])
    w = 0.5 * (wm[..., :-1] + wm[..., 1:]) + RESAMPLE_PADDING
    wsum = torch.sum(w, -1, keepdim=True)
    pad = torch.clamp(eps - wsum, min=0.0)
    w = w + pad / w.shape[-1]
    pdf = w / (wsum + pad)
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1.0)
    n, m = t.shape
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], -1)
    if u is None and generator is not None:
        u = torch.rand((n, m), generator=generator, device=t.device)
    if u is not None:
        step = 1.0 / m
        q = torch.arange(m, dtype=torch.float32, device=t.device) * step + u * (step - eps)
        q = torch.clamp(q, max=1.0 - eps)
    else:
        q = torch.linspace(0.0, 1.0 - eps, m, device=t.device)[None, :].expand(n, m)
    q = q.contiguous()
    # cdf[0] = 0 <= q < 1 = cdf[-1]: the bin is [idx - 1, idx]
    idx = torch.searchsorted(cdf, q, right=True)
    lo, hi = idx - 1, idx.clamp(max=m - 1)
    c0, c1 = torch.gather(cdf, -1, lo), torch.gather(cdf, -1, hi)
    b0, b1 = torch.gather(t, -1, lo), torch.gather(t, -1, hi)
    frac = torch.clamp(torch.nan_to_num((q - c0) / (c1 - c0), 0.0), 0.0, 1.0)
    return (b0 + frac * (b1 - b0)).detach()
