"""The plain reference: the NeRF method of Mildenhall et al. 2020 as the
configurations state it, in plain PyTorch, float32 with TF32 off.

The network is the configuration's own: the module that its
``reference`` key names (``reference/active.py`` holds the active MLP and
says what such a module provides), passed here as ``arch``.  It imports
nothing of the program.  What the program derives from the
benchmark's inputs (ray draws, depths, importance samples, packed weights)
is worked out here again from the same inputs.  The arithmetic follows the
repository's own definition of the method (the reference trainer of
``Phase2/train.py``):

- rays: camera-frame direction ``[(x - cx)/fx, (y - cy)/fy, 1]`` rotated by
  the pose (three products a component, no matrix product) and normalised;
  origin the pose's translation;
- positional encoding ``[x, sin(u_0), cos(u_0), ...]`` with
  ``u_l = x * float32(pi 2^l)`` and ``cos(u) = sin(u + float32(pi / 2))``,
  or the raw inputs where the model group's ``pos_encoding`` is false;
- stratified depths, linear in depth or (``lindisp``) in inverse depth,
  ``sample_pdf`` (inverse CDF over the interior bins, stratified per
  slot) and the sorted union of the two depth sets;
- the 'train' and the legacy compositor, onto black or (``white_background``)
  onto white;
- MSE, autograd, Adam (betas 0.9 / 0.999, eps 1e-8) under a staircase
  StepLR.

Training and full frames run in blocks of rays, so that they fit beside
nothing: a block's loss is its share of the batch mean and the grads add
up.  ``precision`` puts a lower precision in place of float32 for the
controls: 'tf32' (matrix products on TF32) and 'fp8' (both operands of
every product rounded to float8 e4m3 under a per-tensor scale, float32
sums).  'half' is a fault, not a precision: the batch's second half is
left out and the mean taken over the rest.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

BETAS, EPS = (0.9, 0.999), 1e-8
BLOCK_RAYS = 2048
E4M3_MAX = 448.0

Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]   # layer -> (W (in, out), b (out,))


def init_params(arch, m, n_nets: int, generator: torch.Generator, device) -> List[Params]:
    """``n_nets`` networks of ``arch``, every weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn in one call on ``device``;
    the model group's ``density_bias_init`` added to the density bias."""
    shapes = arch.layer_shapes(m)
    per_net = sum(fi * fo + fo for fi, fo in shapes.values())
    u = torch.rand(n_nets * per_net, generator=generator, device=device)
    nets, off = [], 0
    for _ in range(n_nets):
        net = {}
        for name, (fi, fo) in shapes.items():
            bound = 1.0 / math.sqrt(fi)
            w = (2.0 * u[off:off + fi * fo] - 1.0).mul_(bound).view(fi, fo)
            off += fi * fo
            b = (2.0 * u[off:off + fo] - 1.0).mul_(bound)
            off += fo
            net[name] = (w, b)
        layer, i = arch.DENSITY_BIAS
        net[layer][1][i] += m.get("density_bias_init", 0.0)
        nets.append(net)
    return nets


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, gradient
    passed straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 off for 'f32' (and 'fp8', whose sums are float32), on for
    'tf32'; the previous settings are restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _linear(x, w, b, precision):
    if precision == "fp8":
        x, w = _fp8(x), _fp8(w)
    return x @ w + b


# ---------------------------------------------------------------------------
# the model, rays and sampling
# ---------------------------------------------------------------------------


def pos_dim(m) -> int:
    return 3 * (2 * m["n_pos_freq"] + 1) if m.get("pos_encoding", True) else 3


def dir_dim(m) -> int:
    return 3 * (2 * m["n_dir_freq"] + 1) if m.get("pos_encoding", True) else 3


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    freqs = torch.tensor(np.array([np.pi * 2.0 ** l for l in range(n_freqs)], np.float32),
                         device=x.device)
    half_pi = float(np.float32(np.pi / 2))
    u = x[..., None, :] * freqs[:, None]                       # (..., L, 3)
    enc = torch.stack([torch.sin(u), torch.sin(u + half_pi)], -2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], -1)


def embed(m, pts: torch.Tensor, dirs: torch.Tensor):
    """The network's inputs: (PE(pts), PE(dirs)), or the raw pair."""
    if not m.get("pos_encoding", True):
        return pts, dirs
    return encode(pts, m["n_pos_freq"]), encode(dirs, m["n_dir_freq"])


def mlp(arch, net: Params, m, pts: torch.Tensor, dirs: torch.Tensor, precision: str = "f32"):
    """(sigma (P,), rgb (P, 3)) of points (P, 3) seen along dirs (P, 3)."""
    return arch.mlp(m, pts, dirs, lambda name, x: _linear(x, *net[name], precision))


def pixel_rays(K, poses, img_idx, px, py):
    """(origins, directions) (n, 3) of pixels (px, py) of images img_idx."""
    pose = poses[img_idx]
    d_cam = torch.stack([(px.float() - K[0, 2]) / K[0, 0], (py.float() - K[1, 2]) / K[1, 1],
                         torch.ones_like(px, dtype=torch.float32)], -1)
    d = (pose[:, :3, :3] * d_cam[:, None, :]).sum(-1)
    return pose[:, :3, 3], d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def image_rays(K, pose, height: int, width: int):
    """All rays of a frame, y-major, pixel coordinates at integers."""
    ys, xs = torch.meshgrid(torch.arange(height, device=pose.device),
                            torch.arange(width, device=pose.device), indexing="ij")
    n = height * width
    return pixel_rays(K, pose[None].expand(1, 4, 4), torch.zeros(n, dtype=torch.long,
                                                                  device=pose.device),
                      xs.reshape(-1), ys.reshape(-1))


def stratified(n: int, r, u: Optional[torch.Tensor], device) -> torch.Tensor:
    """Depths (n, S): 'train' jitters within the bins around linspace(0, 1,
    S); 'legacy' is ``(i + u) / S``; no jitter (u None): the linspace
    points ('train') or the bin centres ('legacy').  The share t of the
    way maps to ``near + (far - near) t``, or with ``lindisp`` to
    ``1 / (1/near (1 - t) + 1/far t)``."""
    S, near, far = r["n_sample"], r["near"], r["far"]
    if r["variant"] == "legacy":
        i = torch.arange(S, dtype=torch.float32, device=device)
        t = (i + (u if u is not None else 0.5)) / S
    else:
        t = torch.linspace(0.0, 1.0, S, device=device).expand(n, S)
        if u is not None:
            mids = 0.5 * (t[:, 1:] + t[:, :-1])
            lower = torch.cat([t[:, :1], mids], -1)
            upper = torch.cat([mids, t[:, -1:]], -1)
            t = lower + (upper - lower) * u
    t = t.expand(n, S)
    if r.get("lindisp", False):
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near + (far - near) * t


def composite(sigma, rgb, z, r):
    """(rgb (n, 3), weights (n, S)) of the 'train' (exclusive
    transmittance, 1e-3 tail) or 'legacy' (inclusive, 1.0 tail) variant;
    with ``white_background`` the light the samples leave is white."""
    tail = 1e-3 if r["variant"] == "train" else 1.0
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], tail)], -1)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    if r["variant"] == "train":
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    w = alpha * trans
    out = (w[..., None] * rgb).sum(-2)
    if r["white_background"]:
        out = out + (1.0 - w.sum(-1, keepdim=True))
    return out, w


def render(arch, net, m, r, o, d, z, precision="f32"):
    n, S = z.shape
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d[:, None, :].expand(n, S, 3).reshape(-1, 3)
    sigma, rgb = mlp(arch, net, m, pts, dirs, precision)
    return composite(sigma.view(n, S), rgb.view(n, S, 3), z, r)


def sample_pdf(bins, weights, n_imp: int, u: torch.Tensor) -> torch.Tensor:
    """Inverse CDF over the histogram ``weights`` (n, B-1) on the edges
    ``bins`` (n, B), draws stratified per slot: ``(i + u_i) / n_imp``."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    q = (torch.arange(n_imp, device=u.device, dtype=torch.float32) + u) / n_imp
    idx = torch.searchsorted(cdf, q.contiguous(), right=True)
    lo = (idx - 1).clamp(min=0)
    hi = idx.clamp(max=cdf.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    den = c_hi - c_lo
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b_lo + (q - c_lo) / den * (b_hi - b_lo)


# ---------------------------------------------------------------------------
# training: the first steps from the benchmark's weights and draw seed
# ---------------------------------------------------------------------------


def draw_batch(gen, n_img: int, height: int, width: int, n: int, r, device):
    """The step's draws in the order the method makes them: image, pixel x,
    pixel y, the depth jitter (where ``perturb``), the importance jitter."""
    img = torch.randint(0, n_img, (n,), generator=gen, device=device)
    px = torch.randint(0, width, (n,), generator=gen, device=device)
    py = torch.randint(0, height, (n,), generator=gen, device=device)
    u = (torch.rand((n, r["n_sample"]), generator=gen, device=device)
         if r["perturb"] else None)
    u_pdf = (torch.rand((n, r["n_importance"]), generator=gen, device=device)
             if r["n_importance"] else None)
    return img, px, py, u, u_pdf


def _block_loss(arch, nets, m, r, o, d, target, u, u_pdf, precision):
    """Sum of squared errors of a block (coarse + fine when hierarchical)."""
    z = stratified(o.shape[0], r, u, o.device)
    rgb, w = render(arch, nets[0], m, r, o, d, z, precision)
    sse = ((rgb - target) ** 2).sum()
    if len(nets) == 1:
        return sse
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    z_fine = sample_pdf(mids, w[:, 1:-1].detach(), r["n_importance"], u_pdf)
    z_all = torch.sort(torch.cat([z, z_fine], -1), -1).values
    rgb_f, _ = render(arch, nets[1], m, r, o, d, z_all, precision)
    return sse + ((rgb_f - target) ** 2).sum()


def train_steps(arch, nets0: List[Params], m, r, t, images, poses, K, draw_seed: int,
                n_steps: int = 3, precision: str = "f32"):
    """``n_steps`` Adam steps from ``nets0``: (losses [n_steps], the first
    step's grads {leaf: tensor}, the change of every parameter {leaf:
    tensor}).  Leaves are named ``<net>.<layer>.w|b``."""
    dev = images.device
    nets = [{k: (w.clone().requires_grad_(True), b.clone().requires_grad_(True))
             for k, (w, b) in net.items()} for net in nets0]
    leaves = {f"{i}.{k}.{s}": p for i, net in enumerate(nets)
              for k, wb in net.items() for s, p in zip("wb", wb)}
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
            o, d = pixel_rays(K, poses, img, px, py)
            target = images[img, py, px]
            total = torch.zeros((), device=dev, dtype=torch.float64)
            for b0 in range(0, rows, BLOCK_RAYS):
                b1 = min(b0 + BLOCK_RAYS, rows)
                loss = _block_loss(arch, nets, m, r, o[b0:b1], d[b0:b1], target[b0:b1],
                                   u[b0:b1] if u is not None else None,
                                   u_pdf[b0:b1] if u_pdf is not None else None, prec)
                loss = loss / (rows * 3)
                loss.backward()
                total += loss.detach().double()
            losses.append(float(total))
            lr = t["lrate"] * t["lrate_decay"] ** (step // t["lrate_decay_steps"])
            with torch.no_grad():
                # a leaf the forward never reads has no grad: Adam leaves it
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


# ---------------------------------------------------------------------------
# full frames
# ---------------------------------------------------------------------------


@torch.no_grad()
def render_frame(arch, net: Params, m, r, K, pose, height: int, width: int,
                 precision: str = "f32", block: int = 4096) -> torch.Tensor:
    """(H, W, 3) through the un-jittered depths, in blocks of rays."""
    o, d = image_rays(K, pose, height, width)
    out = torch.empty(height * width, 3, device=pose.device)
    with matmul_precision(precision):
        for b0 in range(0, height * width, block):
            b1 = min(b0 + block, height * width)
            z = stratified(b1 - b0, r, None, pose.device)
            out[b0:b1] = render(arch, net, m, r, o[b0:b1], d[b0:b1], z, precision)[0]
    return out.view(height, width, 3)
