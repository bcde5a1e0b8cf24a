"""The plain reference of mip-NeRF (Barron et al., ICCV 2021,
arXiv:2103.13415; github.com/google/mip-nerf ``internal/mip.py``,
``internal/models.py``), the benchmark's frozen copy of the repository's
``tests/mipnerf_reference.py``: plain PyTorch, float32 with TF32 off,
nothing of JAX and nothing of the program.

It is the configuration ``mipnerf-blender``'s network file (``reference``
key) and its method:

- the network file's interface (``reference/active.py`` says what each
  is): ``layer_shapes``, ``DENSITY_BIAS``, ``macs_per_point``,
  ``macs_per_ray``, and ``mlp`` over encoded Gaussians;
- rays as cones: ``d = R [(x - cx)/fx, (y - cy)/fy, 1]`` un-normalised,
  viewdir ``d / |d|``, radius ``2 / (sqrt(12) fx)``;
- ``n_sample + 1`` edges ``near (1 - s) + far s`` at ``s = k / n_sample``,
  jittered as mip-NeRF's ``sample_along_rays``;
- each interval's conical frustum as a Gaussian, its integrated
  positional encoding (``n_pos_freq`` octaves), the view direction's
  encoding (``n_dir_freq``, identity first), no pi;
- the MLP: 8 ReLU layers, the encoding concatenated back after the fifth,
  softplus density (its bias raised by the model group's
  ``density_bias_init``), a linear bottleneck, a 128-wide ReLU layer over
  [bottleneck, view encoding], rgb ``sigmoid * 1.002 - 0.001``;
- ``volumetric_rendering`` over ``(t1 - t0) |d|``, white background;
- ``resample_along_rays``: 2-tap max, 2-tap mean, ``+ resample_padding``,
  ``sorted_piecewise_constant_pdf`` with ``eps = 1e-5`` (also the draws'
  margin, where mip-NeRF's code takes float32's eps);
- ``coarse_loss_mult`` MSE(coarse) + MSE(fine) through one network,
  autograd, Adam (0.9, 0.999, 1e-8) under the log-linear learning rate
  from ``lrate`` to ``lrate_final`` over ``lr_anneal_steps``.

The step's draws, in the order the program makes them from the draw seed:
image, pixel x, pixel y, the edges' jitter (n, n_sample + 1), the
resampler's (n, n_sample + 1).  Training runs in blocks of rays (a block's
loss is its share of the batch mean, the grads add up); ``precision``
'fp8', 'tf32' and the fault 'half' as in ``reference/nerf.py``.

Counts: a point is one interval's Gaussian; ``cone_train_bytes`` is the
cone step's least bytes (rays, cones and edges in, rgb and grads out).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.nerf import (
    BETAS, BLOCK_RAYS, EPS, Params, _linear, matmul_precision,
)

RGB_HIDDEN = 128
DENSITY_BIAS = ("density", 0)
RGB_PADDING = 0.001
PDF_EPS = 1e-5


def pos_dim(m: Dict) -> int:
    return 6 * m["n_pos_freq"]


def dir_dim(m: Dict) -> int:
    return 3 * (2 * m["n_dir_freq"] + 1)


def layer_shapes(m: Dict) -> Dict[str, Tuple[int, int]]:
    h, p = m["hidden"], pos_dim(m)
    shapes = {"fc1": (p, h)}
    shapes.update({f"fc_{i}": (h, h) for i in range(4)})
    shapes["skip"] = (h + p, h)
    shapes.update({f"fc2_{i}": (h, h) for i in range(2)})
    shapes["density"] = (h, 1)
    shapes["feature"] = (h, h)
    shapes["rgb1"] = (h + dir_dim(m), RGB_HIDDEN)
    shapes["rgb2"] = (RGB_HIDDEN, 3)
    return shapes


def macs_per_point(m: Dict) -> int:
    """A point (one interval's Gaussian) counts rgb1's bottleneck rows only:
    its view rows run once a ray."""
    return sum((m["hidden"] if name == "rgb1" else fi) * fo
               for name, (fi, fo) in layer_shapes(m).items())


def macs_per_ray(m: Dict) -> int:
    return dir_dim(m) * RGB_HIDDEN


def cone_train_bytes(m: Dict, rays: int, intervals: int, weights_out: bool = False) -> int:
    """The cone step's least bytes: origins, directions, cones (radius,
    |d|), S + 1 edges and targets in, the bf16 weights and float32 biases
    in; rgb, every float32 grad (and the weights) out."""
    shapes = layer_shapes(m).values()
    n_w = sum(fi * fo for fi, fo in shapes)
    n_b = sum(fo for _, fo in shapes)
    inputs = rays * (24 + 8 + (intervals + 1) * 4 + 12) + 2 * n_w + 4 * n_b
    outputs = rays * 12 + 4 * (n_w + n_b) + (rays * intervals * 4 if weights_out else 0)
    return inputs + outputs


# ---------------------------------------------------------------------------
# the method
# ---------------------------------------------------------------------------


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


def sample_along_rays(n: int, n_samples: int, near: float, far: float, u=None, device=None):
    s = torch.arange(n_samples + 1, dtype=torch.float32, device=device) / n_samples
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
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, -1, keepdim=True), min=1e-10)
    d_outer_diag = d ** 2
    null_outer_diag = 1 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def integrated_pos_enc(means, covs, n_octaves: int):
    scales = torch.tensor([2.0 ** i for i in range(n_octaves)], dtype=means.dtype,
                          device=means.device)
    shape = list(means.shape[:-1]) + [-1]
    y = (means[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (covs[..., None, :] * scales[:, None] ** 2).reshape(shape)
    x, x_var = torch.cat([y, y + 0.5 * math.pi], -1), torch.cat([y_var, y_var], -1)
    return torch.exp(-0.5 * x_var) * torch.sin(x)


def pos_enc(x, n_octaves: int):
    scales = torch.tensor([2.0 ** i for i in range(n_octaves)], dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(list(x.shape[:-1]) + [-1])
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1))], -1)


def mlp(m: Dict, enc, venc, lin):
    """(density (..., 1), rgb (..., 3)) of encoded Gaussians seen along
    encoded view directions; ``lin(name, x)`` applies layer ``name``."""
    h = enc
    for i, name in enumerate(["fc1", "fc_0", "fc_1", "fc_2", "fc_3", "skip", "fc2_0", "fc2_1"]):
        h = torch.relu(lin(name, h))
        if i == 4:
            h = torch.cat([h, enc], -1)
    density = torch.nn.functional.softplus(lin("density", h))
    bottleneck = lin("feature", h)
    x = torch.relu(lin("rgb1", torch.cat([bottleneck, venc], -1)))
    return density, torch.sigmoid(lin("rgb2", x)) * (1 + 2 * RGB_PADDING) - RGB_PADDING


def volumetric_rendering(rgb, density, t, dirs, white_bkgd: bool):
    delta = (t[..., 1:] - t[..., :-1]) * torch.linalg.vector_norm(dirs[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1], -1)], -1))
    weights = alpha * trans
    comp_rgb = (weights[..., None] * rgb).sum(-2)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - weights.sum(-1)[..., None])
    return comp_rgb, weights


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int, r):
    weight_sum = torch.sum(weights, -1, keepdim=True)
    padding = torch.clamp(PDF_EPS - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], -1)
    s = 1 / num_samples
    u = torch.arange(num_samples, dtype=torch.float32, device=bins.device) * s
    u = torch.clamp(u + r * (s - PDF_EPS), max=1.0 - PDF_EPS)
    mask = u[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.max(torch.where(mask, x[..., None], x[..., :1, None]), -2).values
        x1 = torch.min(torch.where(~mask, x[..., None], x[..., -1:, None]), -2).values
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    frac = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), 0), 0, 1)
    return bins_g0 + frac * (bins_g1 - bins_g0)


def resample_along_rays(t, weights, r, padding: float):
    weights = weights.detach()
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    return sorted_piecewise_constant_pdf(t, weights_blur + padding, t.shape[-1], r).detach()


def render_level(m, r, lin, t, origins, directions, viewdirs, radii):
    means, covs = conical_frustum_to_gaussian(directions, t[..., :-1], t[..., 1:], radii[:, None])
    enc = integrated_pos_enc(means + origins[..., None, :], covs, m["n_pos_freq"])
    venc = pos_enc(viewdirs, m["n_dir_freq"])[:, None, :].expand(*means.shape[:-1], -1)
    density, rgb = mlp(m, enc, venc, lin)
    return volumetric_rendering(rgb, density, t, directions, r["white_background"])


# ---------------------------------------------------------------------------
# training: the first steps from the benchmark's weights and draw seed
# ---------------------------------------------------------------------------


def draw_batch(gen, n_img: int, height: int, width: int, n: int, r, device):
    img = torch.randint(0, n_img, (n,), generator=gen, device=device)
    px = torch.randint(0, width, (n,), generator=gen, device=device)
    py = torch.randint(0, height, (n,), generator=gen, device=device)
    S = r["n_sample"]
    u = torch.rand((n, S + 1), generator=gen, device=device) if r["perturb"] else None
    u_pdf = torch.rand((n, S + 1), generator=gen, device=device)
    return img, px, py, u, u_pdf


def learning_rate(t: Dict, step: int) -> float:
    s = min(step / t["lr_anneal_steps"], 1.0)
    return math.exp(math.log(t["lrate"]) * (1 - s) + math.log(t["lrate_final"]) * s)


def _block_loss(m, r, t, net, rays, target, u, u_pdf, precision):
    """Sum of squared errors of a block: coarse_loss_mult the coarse
    level's, plus the fine level's, one network."""
    o, d, viewdirs, radii = rays
    lin = lambda name, x: _linear(x, *net[name], precision)     # noqa: E731
    t_c = sample_along_rays(o.shape[0], r["n_sample"], r["near"], r["far"], u, o.device)
    rgb_c, w_c = render_level(m, r, lin, t_c, o, d, viewdirs, radii)
    t_f = resample_along_rays(t_c, w_c, u_pdf, r["resample_padding"])
    rgb_f, _ = render_level(m, r, lin, t_f, o, d, viewdirs, radii)
    return (t["coarse_loss_mult"] * ((rgb_c - target) ** 2).sum()
            + ((rgb_f - target) ** 2).sum())


def train_steps(nets0: List[Params], m, r, t, images, poses, K, draw_seed: int,
                n_steps: int = 3, precision: str = "f32"):
    """``n_steps`` Adam steps of the one network ``nets0[0]``: (losses, the
    first step's grads {leaf: tensor}, the change of every parameter
    {leaf: tensor}), leaves named ``0.<layer>.w|b``."""
    dev = images.device
    net = {k: (w.clone().requires_grad_(True), b.clone().requires_grad_(True))
           for k, (w, b) in nets0[0].items()}
    leaves = {f"0.{k}.{s}": p for k, wb in net.items() for s, p in zip("wb", wb)}
    start = {k: p.detach().clone() for k, p in leaves.items()}
    mom = {k: torch.zeros_like(p) for k, p in leaves.items()}
    vel = {k: torch.zeros_like(p) for k, p in leaves.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(draw_seed)
    n = t["n_rays_batch"]
    rows = n // 2 if precision == "half" else n
    prec = "f32" if precision == "half" else precision
    losses, first = [], None
    with matmul_precision(prec):
        for step in range(n_steps):
            img, px, py, u, u_pdf = draw_batch(gen, images.shape[0], images.shape[1],
                                               images.shape[2], n, r, dev)
            rays = cone_rays(K, poses, img, px, py)
            target = images[img, py, px]
            total = torch.zeros((), device=dev, dtype=torch.float64)
            for b0 in range(0, rows, BLOCK_RAYS):
                b1 = min(b0 + BLOCK_RAYS, rows)
                loss = _block_loss(m, r, t, net, tuple(x[b0:b1] for x in rays), target[b0:b1],
                                   u[b0:b1] if u is not None else None, u_pdf[b0:b1], prec)
                loss = loss / (rows * 3)
                loss.backward()
                total += loss.detach().double()
            losses.append(float(total))
            lr = learning_rate(t, step)
            with torch.no_grad():
                grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                         for k, p in leaves.items()}
                if first is None:
                    first = {k: g.clone() for k, g in grads.items()}
                for k, p in leaves.items():
                    g = grads[k]
                    mom[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    vel[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    c1, c2 = 1 - BETAS[0] ** (step + 1), 1 - BETAS[1] ** (step + 1)
                    denom = (vel[k] / c2).sqrt_().add_(EPS)
                    p.addcdiv_(mom[k] / c1, denom, value=-lr)
                    p.grad = None
    return losses, first, {k: p.detach() - start[k] for k, p in leaves.items()}
