"""The plain reference of mip-NeRF (Barron et al., "Mip-NeRF: A Multiscale
Representation for Anti-Aliasing Neural Radiance Fields", ICCV 2021,
arXiv:2103.13415; github.com/google/mip-nerf, ``internal/mip.py`` and
``internal/models.py``) in plain PyTorch, float32, TF32 off.  It imports
torch alone: nothing of JAX and nothing of the port.

- Rays: ``d = R [(x - cx)/fx, (y - cy)/fy, 1]`` (not normalised), origin
  the pose's translation, viewdir ``d / |d|``, radius ``2 / (sqrt(12)
  fx)`` (mip-NeRF's ``dx 2 / sqrt(12)``: for this camera neighbouring
  directions lie ``1 / fx`` apart).
- Edges: ``near (1 - s) + far s`` at ``s = k / S``, jittered as mip-NeRF's
  ``sample_along_rays``: each edge uniform between the midpoints around it.
- Each interval's conical frustum as a Gaussian (the stable
  ``conical_frustum_to_gaussian``, ``lift_gaussian`` with a diagonal
  covariance), its integrated positional encoding over 16 octaves, the
  view direction's positional encoding over 4 (identity first), no pi.
- The MLP: 8 ReLU layers of 256, the encoding concatenated back after the
  fifth; softplus density over a bias initialised at -1; a linear
  bottleneck; a 128-wide ReLU layer over [bottleneck, view encoding]; rgb
  ``sigmoid * 1.002 - 0.001``.
- ``volumetric_rendering``: ``delta = (t1 - t0) |d|``, exclusive
  transmittance, white background ``+ (1 - acc)``.
- ``resample_along_rays``: the weights padded, a 2-tap max, a 2-tap mean,
  ``+ 0.01``, then ``sorted_piecewise_constant_pdf`` over the coarse edges
  with ``eps = 1e-5`` (the repository takes this eps for the draws' margin
  too, where mip-NeRF's code takes float32's).
- The loss ``0.1 MSE(coarse) + MSE(fine)`` through one network, its
  gradients by autograd; Adam (0.9, 0.999, 1e-8) under the log-linear
  learning rate from 5e-4 to 5e-6 over 1,000,000 steps.

Weights are ``{layer: (W (in, out), b (out,))}`` under the port's layer
names.  Departures from the published code: the draws' margin (above),
and the initialisation, which is the caller's.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

RGB_PADDING = 0.001
DENSITY_BIAS = -1.0
RESAMPLE_PADDING = 0.01
EPS = 1e-5
COARSE_LOSS_MULT = 0.1
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def layer_shapes(hidden: int = 256, n_pos: int = 16, n_dir: int = 4) -> Dict[str, Tuple[int, int]]:
    p, v = 6 * n_pos, 3 * (2 * n_dir + 1)
    shapes = {"fc1": (p, hidden)}
    shapes.update({f"fc_{i}": (hidden, hidden) for i in range(4)})
    shapes["skip"] = (hidden + p, hidden)
    shapes.update({f"fc2_{i}": (hidden, hidden) for i in range(2)})
    shapes["density"] = (hidden, 1)
    shapes["feature"] = (hidden, hidden)
    shapes["rgb1"] = (hidden + v, 128)
    shapes["rgb2"] = (128, 3)
    return shapes


def init_params(generator: torch.Generator, hidden=256, n_pos=16, n_dir=4) -> Params:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases, the density
    bias raised by DENSITY_BIAS (mip-NeRF's ``softplus(raw - 1)``)."""
    out = {}
    for name, (fi, fo) in layer_shapes(hidden, n_pos, n_dir).items():
        bound = 1.0 / math.sqrt(fi)
        w = (2.0 * torch.rand(fi, fo, generator=generator) - 1.0) * bound
        b = (2.0 * torch.rand(fo, generator=generator) - 1.0) * bound
        out[name] = (w, b)
    out["density"] = (out["density"][0], out["density"][1] + DENSITY_BIAS)
    return out


def cone_rays(K, poses, img, px, py):
    """(origins, directions, viewdirs, radii) of pixels (px, py) of images img."""
    pose = poses[img]
    fx = K[0, 0]
    d_cam = torch.stack([(px.float() - K[0, 2]) / fx, (py.float() - K[1, 2]) / K[1, 1],
                         torch.ones_like(px, dtype=torch.float32)], -1)
    d = (pose[:, :3, :3] * d_cam[:, None, :]).sum(-1)
    viewdirs = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    radii = (2.0 / math.sqrt(12.0) / fx).expand(d.shape[0])
    return pose[:, :3, 3], d, viewdirs, radii


def sample_along_rays(n: int, n_samples: int, near: float, far: float, u=None):
    """(n, n_samples + 1) edges; ``u`` (n, n_samples + 1) the jitter, or None."""
    s = torch.arange(n_samples + 1, dtype=torch.float32) / n_samples
    t = (near * (1.0 - s) + far * s).expand(n, n_samples + 1)
    if u is not None:
        mids = 0.5 * (t[..., 1:] + t[..., :-1])
        upper = torch.cat([mids, t[..., -1:]], -1)
        lower = torch.cat([t[..., :1], mids], -1)
        t = lower + (upper - lower) * u
    return t


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2))
                                       / (3 * mu ** 2 + hw ** 2) ** 2)
    r_var = base_radius ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2
                                - 4 / 15 * (hw ** 4) / (3 * mu ** 2 + hw ** 2))
    return lift_gaussian(d, t_mean, t_var, r_var)


def lift_gaussian(d, t_mean, t_var, r_var):
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, -1, keepdim=True), min=1e-10)
    d_outer_diag = d ** 2
    null_outer_diag = 1 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def cast_rays(t, origins, directions, radii):
    """(means, covs) (n, S, 3) of the intervals between the edges t."""
    means, covs = conical_frustum_to_gaussian(directions, t[..., :-1], t[..., 1:],
                                              radii[:, None])
    return means + origins[..., None, :], covs


def integrated_pos_enc(means, covs, min_deg=0, max_deg=16):
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=means.dtype,
                          device=means.device)
    shape = list(means.shape[:-1]) + [-1]
    y = (means[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (covs[..., None, :] * scales[:, None] ** 2).reshape(shape)
    x, x_var = torch.cat([y, y + 0.5 * math.pi], -1), torch.cat([y_var, y_var], -1)
    return torch.exp(-0.5 * x_var) * torch.sin(x)


def pos_enc(x, min_deg=0, max_deg=4):
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=x.dtype,
                          device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(list(x.shape[:-1]) + [-1])
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1))
    return torch.cat([x, four_feat], -1)


def mlp(params: Params, enc, venc, lin=None):
    """(density (..., 1), rgb (..., 3)) of encoded Gaussians ``enc`` seen
    along encoded view directions ``venc``; ``lin(name, x)`` applies a
    layer (default: x @ W + b)."""
    lin = lin or (lambda name, x: x @ params[name][0] + params[name][1])
    h = enc
    names = ["fc1", "fc_0", "fc_1", "fc_2", "fc_3", "skip", "fc2_0", "fc2_1"]
    for i, name in enumerate(names):
        h = torch.relu(lin(name, h))
        if i == 4:
            h = torch.cat([h, enc], -1)
    density = torch.nn.functional.softplus(lin("density", h))
    bottleneck = lin("feature", h)
    x = torch.relu(lin("rgb1", torch.cat([bottleneck, venc], -1)))
    rgb = torch.sigmoid(lin("rgb2", x))
    return density, rgb * (1 + 2 * RGB_PADDING) - RGB_PADDING


def volumetric_rendering(rgb, density, t, dirs, white_bkgd: bool):
    """(comp_rgb (n, 3), weights (n, S))."""
    t_dists = t[..., 1:] - t[..., :-1]
    delta = t_dists * torch.linalg.vector_norm(dirs[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1], -1)], -1))
    weights = alpha * trans
    comp_rgb = (weights[..., None] * rgb).sum(-2)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - weights.sum(-1)[..., None])
    return comp_rgb, weights


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int, r=None):
    """mip-NeRF's inverse-CDF sampler; ``r`` (n, num_samples) uniform in
    [0, 1) scales each draw's jitter, or None for the even draws."""
    weight_sum = torch.sum(weights, -1, keepdim=True)
    padding = torch.clamp(EPS - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], -1)
    if r is not None:
        s = 1 / num_samples
        u = torch.arange(num_samples, dtype=torch.float32, device=bins.device) * s
        u = torch.clamp(u + r * (s - EPS), max=1.0 - EPS)
    else:
        u = torch.linspace(0.0, 1.0 - EPS, num_samples, device=bins.device).expand(
            bins.shape[0], num_samples)
    mask = u[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.max(torch.where(mask, x[..., None], x[..., :1, None]), -2).values
        x1 = torch.min(torch.where(~mask, x[..., None], x[..., -1:, None]), -2).values
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), 0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(t, weights, r=None, padding=RESAMPLE_PADDING):
    """The fine level's edges (n, S + 1) from the coarse ones and their
    weights, no gradient."""
    weights = weights.detach()
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    return sorted_piecewise_constant_pdf(t, weights_blur + padding, t.shape[-1], r).detach()


def render_level(params: Params, t, origins, directions, viewdirs, radii, white_bkgd: bool,
                 lin=None):
    means, covs = cast_rays(t, origins, directions, radii)
    enc = integrated_pos_enc(means, covs)
    venc = pos_enc(viewdirs)[:, None, :].expand(*means.shape[:-1], -1)
    density, rgb = mlp(params, enc, venc, lin)
    return volumetric_rendering(rgb, density, t, directions, white_bkgd)


def two_level(params: Params, origins, directions, viewdirs, radii, near, far, n_samples,
              white_bkgd: bool, u_edges=None, r_resample=None, lin=None):
    """(rgb_coarse, rgb_fine, coarse edges, coarse weights, fine edges)."""
    t_c = sample_along_rays(origins.shape[0], n_samples, near, far, u_edges)
    rgb_c, w_c = render_level(params, t_c, origins, directions, viewdirs, radii, white_bkgd,
                              lin)
    t_f = resample_along_rays(t_c, w_c, r_resample)
    rgb_f, _ = render_level(params, t_f, origins, directions, viewdirs, radii, white_bkgd, lin)
    return rgb_c, rgb_f, t_c, w_c, t_f


def loss(params: Params, target, *rays, **kw):
    """``COARSE_LOSS_MULT`` MSE(coarse) + MSE(fine)."""
    rgb_c, rgb_f = two_level(params, *rays, **kw)[:2]
    return (COARSE_LOSS_MULT * torch.mean((rgb_c - target) ** 2)
            + torch.mean((rgb_f - target) ** 2))


def learning_rate(step: int, lr_init=5e-4, lr_final=5e-6, max_steps=1_000_000) -> float:
    s = min(step / max_steps, 1.0)
    return math.exp(math.log(lr_init) * (1 - s) + math.log(lr_final) * s)


def adam_steps(params: Params, grad_fn, n_steps: int):
    """``n_steps`` Adam steps from ``params`` under ``learning_rate``;
    ``grad_fn(params, step)`` gives the step's grads ({layer: (gW, gb)})."""
    cur = {k: (w.clone(), b.clone()) for k, (w, b) in params.items()}
    m = {k: (torch.zeros_like(w), torch.zeros_like(b)) for k, (w, b) in cur.items()}
    v = {k: (torch.zeros_like(w), torch.zeros_like(b)) for k, (w, b) in cur.items()}
    for step in range(n_steps):
        grads = grad_fn(cur, step)
        lr = learning_rate(step)
        c1, c2 = 1 - BETAS[0] ** (step + 1), 1 - BETAS[1] ** (step + 1)
        nxt = {}
        for k in cur:
            pair = []
            for i in range(2):
                g = grads[k][i]
                m_i = BETAS[0] * m[k][i] + (1 - BETAS[0]) * g
                v_i = BETAS[1] * v[k][i] + (1 - BETAS[1]) * g * g
                m[k] = (m_i, m[k][1]) if i == 0 else (m[k][0], m_i)
                v[k] = (v_i, v[k][1]) if i == 0 else (v[k][0], v_i)
                pair.append(cur[k][i] - lr * (m_i / c1) / (torch.sqrt(v_i / c2) + ADAM_EPS))
            nxt[k] = tuple(pair)
        cur = nxt
    return cur


def grads(params: Params, target, *rays, **kw):
    """({layer: (dW, db)}, loss) of ``loss`` by autograd."""
    leaves = {k: (w.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True))
              for k, (w, b) in params.items()}
    value = loss(leaves, target, *rays, **kw)
    flat = [p for wb in leaves.values() for p in wb]
    g = torch.autograd.grad(value, flat)
    out, i = {}, 0
    for k in leaves:
        out[k] = (g[i], g[i + 1])
        i += 2
    return out, value.detach()
