"""Fused NeRF training step: forward and hand-written backward in CUDA.

Counterpart of sfm_nerf_tpu/kernels/fused_train.py.  One CUDA source
(csrc/fused_train.cu, three modes of one kernel) behind three wrappers
named as in the JAX package:

- ``fused_mse_loss``: mean((render(rays) - target)^2) as a scalar.  One
  launch gives rgb and the grads of every packed weight and bias (the MSE
  cotangent is made in the kernel); backward only scales them.
- ``fused_mse_loss_weights``: the same loss and, from the same launch, the
  per-sample compositing weights (N, S) of the forward sweep, detached: the
  coarse pass of hierarchical training, whose weights feed ``sample_pdf``.
- ``fused_render_train``: rgb (N, 3), differentiable for any loss on it.
  Forward launches the forward kernel (rgb and the transmittance entering
  each 128-sample chunk); backward launches the backward kernel, which
  recomputes each chunk and applies the caller's cotangent.

All are ``torch.autograd.Function``s over the parameters of the module the
weights were packed from (``PackedNeRF.model``): the packed grads go back to
``nn.Module`` parameter grads through ``unpack_grads``, the exact transpose
of ``pack_nerf_params``, so ``loss.backward()`` fills ``.grad`` and the
optimizer is plain ``torch.optim.Adam``.  No library product and no
autograd graph computes anything on that path.

Beside them, ``fused_mse_loss_reference``,
``fused_mse_loss_weights_reference`` and ``fused_render_train_reference``
are the plain PyTorch versions: the chunked
forward of ``fused_render_rays_reference`` and a hand-written reverse walk
with the kernel's rounding points.  A wrapper given CPU tensors runs them;
given CUDA tensors it launches the kernel or raises.  Each wrapper counts
its kernel launches in ``LAUNCHES``.

Types.  Master weights stay float32 in the ``nn.Module``.  The kernel takes
them packed in bf16, as the render kernel does; products are bf16 x bf16 ->
f32, cotangents are rounded to bf16 where they enter a product, sums,
biases, heads and compositing are f32, and grads come out f32.  The TPU
kernel does the same at its default compute dtype: Mosaic runs a float32
dot as one bf16 pass.

Only the 'train' compositor trains through these kernels (white background
included); the sample axis is masked in the kernel, so any n_sample runs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sfm_nerf_tpu_torch.config import RenderConfig
from sfm_nerf_tpu_torch.kernels.fused_render import (
    CHUNK, REF_RAY_CHUNK, RGB_HIDDEN, PackedNeRF, _ext, _kernel_args, _softplus,
)
from sfm_nerf_tpu_torch.ops.render import sample_dists

MODE_STEP, MODE_FWD, MODE_BWD = 0, 1, 2

LAUNCHES: Dict[str, int] = {
    "fused_mse_loss": 0, "fused_mse_loss_weights": 0, "fused_render_train": 0,
    "fused_render_train_backward": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(rcfg: RenderConfig) -> None:
    if rcfg.variant != "train":
        raise NotImplementedError(
            "fused training covers the 'train' compositor only; the legacy "
            "variant trains through the nn.Module path")


# ---------------------------------------------------------------------------
# packed grads -> nn.Module parameter grads
# ---------------------------------------------------------------------------


def unpack_grads(packed: PackedNeRF, gw: torch.Tensor,
                 gb: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The transpose of ``pack_nerf_params``: flat grads in the packed
    layout (``gw`` like ``packed.weights``, ``gb`` like ``packed.biases``)
    to ``{parameter name: grad}`` for every parameter of ``packed.model``.
    Pad rows and columns are dropped, the merged density/feature head is
    split again, and ``nn.Linear``'s (out, in) layout is restored.  A
    parameter the forward pass never reads (legacy ``density_fc``) gets
    zeros."""
    h, pos = packed.hidden, packed.pos_dim
    out: Dict[str, torch.Tensor] = {}
    for s in packed.layers:
        w = gw[s.w_off:s.w_off + s.k_rows * s.n].view(s.k_rows, s.n)
        b = gb[s.b_off:s.b_off + s.n]
        if s.kind == "fc1":
            w = w[:pos]
        elif s.kind == "skip":
            w = torch.cat([w[:h], w[h:h + pos]])
        elif s.kind == "densfeat":
            if "feature" in packed.model.layers:
                out["layers.density.weight"] = w[:, h:h + 1].t()
                out["layers.density.bias"] = b[h:h + 1]
                out["layers.feature.weight"] = w[:, :h].t()
                out["layers.feature.bias"] = b[:h]
            else:
                out["layers.block2_2.weight"] = torch.cat([w[:, h:h + 1], w[:, :h]], 1).t()
                out["layers.block2_2.bias"] = torch.cat([b[h:h + 1], b[:h]])
            continue
        elif s.kind == "rgb2":
            w, b = w[:, :3], b[:3]
        out[f"layers.{s.name}.weight"] = w.t()
        out[f"layers.{s.name}.bias"] = b
    return {name: out[name] if name in out else torch.zeros_like(p)
            for name, p in packed.model.named_parameters()}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _reference_pass(packed: PackedNeRF, origins, directions, z_vals, rcfg: RenderConfig,
                    cotangent, chunk: int):
    """Forward and reverse walk of the plain version over all rays.

    ``cotangent(rgb, r0)`` -> g for the rays ``[r0, r0 + len(rgb))``, or
    None for a forward only.  Returns (rgb, tb, w, gw, gb): tb (N,
    n_chunks) is the transmittance entering each chunk, w (N, S) the
    compositing weights, gw / gb the flat grads in the packed layout (None
    without a cotangent)."""
    ft = torch.float64 if origins.dtype == torch.float64 else torch.float32
    wdt = packed.weights.dtype
    rnd = (lambda t: t.to(wdt).to(ft)) if wdt != torch.float32 else (lambda t: t)
    body = [s for s in packed.layers if s.kind in ("plain", "skip")]
    specs = {s.name: s for s in packed.layers}
    Wf = {s.name: packed.w(s).detach().to(ft) for s in packed.layers}
    Bf = {s.name: packed.b(s).detach().to(ft) for s in packed.layers}
    h, S = packed.hidden, z_vals.shape[1]
    dev = origins.device
    gW = {n: torch.zeros_like(w) for n, w in Wf.items()}
    gB = {n: torch.zeros_like(b) for n, b in Bf.items()}
    rgb_parts, tb_parts, w_parts = [], [], []

    for r0 in range(0, origins.shape[0], REF_RAY_CHUNK):
        o = origins[r0:r0 + REF_RAY_CHUNK].to(ft)
        d = directions[r0:r0 + REF_RAY_CHUNK].to(ft)
        z = z_vals[r0:r0 + REF_RAY_CHUNK].to(ft)
        n = o.shape[0]
        dists = sample_dists(z, rcfg.variant)
        extd = rnd(_ext(d, packed.n_dir_freq, packed.dir_dim))
        dir_part = extd @ Wf["rgb1"][h:]
        T = torch.ones(n, 1, device=dev, dtype=ft)
        acc = torch.zeros(n, 3, device=dev, dtype=ft)
        saved, tb, ws = [], [], []
        # ---- forward, chunk by chunk, transmittance carried -------------
        for c0 in range(0, S, chunk):
            zc, dc = z[:, c0:c0 + chunk], dists[:, c0:c0 + chunk]
            ch = zc.shape[1]
            pts = (o[:, None, :] + d[:, None, :] * zc[..., None]).reshape(-1, 3)
            ext = rnd(_ext(pts, packed.n_pos_freq, packed.pos_pad))
            hs = [rnd(torch.relu(ext @ Wf["fc1"] + Bf["fc1"]))]
            for s in body:
                inp = torch.cat([hs[-1], ext], -1) if s.kind == "skip" else hs[-1]
                hs.append(rnd(torch.relu(inp @ Wf[s.name] + Bf[s.name])))
            df = hs[-1] @ Wf["densfeat"] + Bf["densfeat"]
            feat = rnd(torch.relu(df[:, :h]))
            dens = df[:, h]
            dens = _softplus(dens) if packed.density_act == "softplus" else torch.relu(dens)
            fp = (feat @ Wf["rgb1"][:h]).reshape(n, ch, RGB_HIDDEN)
            rgb_h = rnd(torch.relu(fp + dir_part[:, None, :] + Bf["rgb1"])).reshape(n * ch, -1)
            rgb = torch.sigmoid((rgb_h @ Wf["rgb2"] + Bf["rgb2"])[:, :3]).reshape(n, ch, 3)
            xs = dens.reshape(n, ch) * dc
            csum = torch.cumsum(-xs, 1)
            Ti = T * torch.exp(csum + xs)
            w = (1.0 - torch.exp(-xs)) * Ti
            acc = acc + torch.sum(w[..., None] * rgb, 1)
            tb.append(T)
            ws.append(w)
            T = T * torch.exp(csum[:, -1:])
            if cotangent is not None:
                saved.append((ext, hs, feat, rgb_h, rgb, dens, dc, xs, Ti, w))
        rgb_out = acc + T if rcfg.white_background else acc
        rgb_parts.append(rgb_out)
        tb_parts.append(torch.cat(tb, 1))
        w_parts.append(torch.cat(ws, 1))
        if cotangent is None:
            continue
        # ---- reverse walk ----------------------------------------------
        g = cotangent(rgb_out, r0).to(ft)                                # (n, 3)
        gsum = g.sum(1, keepdim=True) if rcfg.white_background else 0.0
        carry = torch.zeros(n, 1, device=dev, dtype=ft)
        ddir = torch.zeros(n, RGB_HIDDEN, device=dev, dtype=ft)
        for ext, hs, feat, rgb_h, rgb, dens, dc, xs, Ti, w in reversed(saved):
            ch = xs.shape[1]
            # compositing: dL/dalpha = q T - R / one_m, R the strict suffix
            # sum of q w (this chunk's, plus the later chunks' carry)
            e = torch.exp(-xs)
            q = torch.sum(rgb * g[:, None, :], -1) - gsum
            qw = q * w
            incl = torch.flip(torch.cumsum(torch.flip(qw, [1]), 1), [1])
            R = torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], 1) + carry
            dalpha = q * Ti - R / (e + 1e-10)
            dsigma = dalpha * dc * e
            carry = carry + qw.sum(1, keepdim=True)
            dens2 = dens.reshape(n, ch)
            dact = (1.0 - torch.exp(-dens2) if packed.density_act == "softplus"
                    else (dens2 > 0).to(ft))
            ddens = (dsigma * dact).reshape(-1)
            drgb = ((w[..., None] * g[:, None, :]) * rgb * (1.0 - rgb)).reshape(-1, 3)

            def layer_back(name, A, D):
                """Adds dW and db of layer ``name`` from its input A (the
                weight's first rows) and output cotangent D; returns the
                input cotangent, masked by A > 0 and rounded."""
                k = A.shape[1]
                gW[name][:k] += A.t() @ D
                gB[name] += D.sum(0)
                return rnd((D @ Wf[name][:k].t()) * (A > 0))

            D = rnd(F.pad(drgb, (0, specs["rgb2"].n - 3)))
            D = layer_back("rgb2", rgb_h, D)
            ddir = ddir + D.reshape(n, ch, -1).sum(1)
            D = layer_back("rgb1", feat, D)
            D = torch.cat([D, rnd(ddens)[:, None],
                           torch.zeros(D.shape[0], specs["densfeat"].n - h - 1,
                                       device=dev, dtype=ft)], 1)
            D = layer_back("densfeat", hs[-1], D)
            for j in range(len(body) - 1, -1, -1):
                s = body[j]
                if s.kind == "skip":
                    gW[s.name][h:] += ext.t() @ D
                D = layer_back(s.name, hs[j], D)
            gW["fc1"] += ext.t() @ D
            gB["fc1"] += D.sum(0)
        # rgb1's direction rows, once per ray
        gW["rgb1"][h:] += extd.t() @ ddir

    rgb = torch.cat(rgb_parts)
    tb = torch.cat(tb_parts)
    weights = torch.cat(w_parts)
    if cotangent is None:
        return rgb, tb, weights, None, None
    gw = torch.zeros(packed.weights.numel(), device=dev, dtype=ft)
    gb = torch.zeros(packed.biases.numel(), device=dev, dtype=ft)
    for s in packed.layers:
        gw[s.w_off:s.w_off + s.k_rows * s.n] = gW[s.name].reshape(-1)
        gb[s.b_off:s.b_off + s.n] = gB[s.name]
    return rgb, tb, weights, gw, gb


def fused_mse_loss_reference(packed: PackedNeRF, origins, directions, z_vals, target,
                             rcfg: RenderConfig, chunk: int = CHUNK):
    """Plain PyTorch version of the step kernel: (rgb (N, 3), gw, gb) with
    gw / gb the grads of mean((rgb - target)^2) in the packed layout.

    It repeats the kernel's arithmetic step by step: the chunked forward of
    ``fused_render_rays_reference`` and a hand-written reverse walk (no
    autograd) with the kernel's rounding points, in float32, or in float64
    when given float64 rays."""
    rgb, _, gw, gb = fused_mse_loss_weights_reference(
        packed, origins, directions, z_vals, target, rcfg, chunk)
    return rgb, gw, gb


def fused_mse_loss_weights_reference(packed: PackedNeRF, origins, directions, z_vals, target,
                                     rcfg: RenderConfig, chunk: int = CHUNK):
    """Plain PyTorch version of the step kernel with its weights output:
    (rgb (N, 3), weights (N, S), gw, gb), the weights those the forward
    sweep composited with, at the caller's sample count."""
    _check(rcfg)
    scale = 2.0 / (3.0 * origins.shape[0])
    rgb, _, weights, gw, gb = _reference_pass(
        packed, origins, directions, z_vals, rcfg,
        lambda rgb, r0: (rgb - target[r0:r0 + rgb.shape[0]].to(rgb.dtype)) * scale, chunk)
    return rgb, weights, gw, gb


def fused_render_train_reference(packed: PackedNeRF, origins, directions, z_vals,
                                 rcfg: RenderConfig, g: Optional[torch.Tensor] = None,
                                 chunk: int = CHUNK):
    """Plain PyTorch version of the two-kernel route.  Without ``g``: the
    forward kernel's (rgb (N, 3), tb (N, n_chunks)).  With the cotangent
    ``g`` (N, 3): the backward kernel's (gw, gb) in the packed layout."""
    _check(rcfg)
    if g is None:
        rgb, tb, _, _, _ = _reference_pass(packed, origins, directions, z_vals, rcfg, None, chunk)
        return rgb, tb
    _, _, _, gw, gb = _reference_pass(
        packed, origins, directions, z_vals, rcfg,
        lambda rgb, r0: g[r0:r0 + rgb.shape[0]], chunk)
    return gw, gb


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C functions declared."""
    from sfm_nerf_tpu_torch.kernels import _build

    lib = _build.load("fused_train")
    lib.sfm_fused_train.restype = ctypes.c_int
    lib.sfm_fused_train.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    lib.sfm_cuda_error_string.restype = ctypes.c_char_p
    lib.sfm_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(mode: int, packed: PackedNeRF, origins, directions, z_vals, rcfg: RenderConfig,
            target=None, g=None, tb=None, keep: bool = True, emit_weights: bool = False):
    """Check the inputs, allocate outputs and scratch, launch one mode of
    the CUDA kernel.  Returns (rgb, tb, grads, w): grads is the flat float32
    (weights then biases) gradient in the packed layout, None for the
    forward mode; rgb is None for the backward mode; w (N, S) are the
    compositing weights of the step mode with ``emit_weights``, else None."""
    dev = origins.device
    n, S = z_vals.shape
    tensors = [("directions", directions), ("z_vals", z_vals),
               ("weights", packed.weights), ("biases", packed.biases)]
    for name, t in (("target", target), ("g", g)):
        if t is not None:
            tensors.append((name, t))
            if t.shape != (n, 3):
                raise ValueError(f"fused train: {name} {tuple(t.shape)}, expected {(n, 3)}")
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"fused train: {name} on {t.device}, origins on {dev}")
    if packed.weights.dtype != torch.bfloat16:
        raise ValueError("fused train kernel takes bf16-packed weights, got "
                         f"{packed.weights.dtype}")
    if packed.hidden > 256:
        raise ValueError(f"fused train kernel: hidden {packed.hidden} > 256")
    if origins.shape != (n, 3) or directions.shape != (n, 3):
        raise ValueError(f"fused train: origins {tuple(origins.shape)}, directions "
                         f"{tuple(directions.shape)}, z_vals {(n, S)}")
    w_total, b_total = packed.weights.numel(), packed.biases.numel()
    if sum(s.k_rows * s.n for s in packed.layers) != w_total:
        raise ValueError("fused train kernel: the packed weights hold pad elements "
                         "between layers, which the grad reduction would read")
    f32 = dict(device=dev, dtype=torch.float32)
    o = origins.float().contiguous()
    d = directions.float().contiguous()
    z = z_vals.float().contiguous()
    n_chunks = -(-S // CHUNK)
    n_blocks = min(torch.cuda.get_device_properties(dev).multi_processor_count, n)
    stash_w = max(packed.hidden, RGB_HIDDEN)
    rgb = torch.empty(n, 3, **f32) if mode != MODE_BWD else None
    if emit_weights and mode != MODE_STEP:
        raise ValueError("fused train: only the step mode writes weights")
    w = torch.empty(n, S, **f32) if emit_weights else None
    if mode == MODE_BWD:
        if tb is None or tb.shape != (n, n_chunks):
            raise ValueError("fused train backward: tb must be the forward's (N, n_chunks)")
        tb = tb.float().contiguous()
    else:
        tb = torch.empty(n, n_chunks, **f32)
    stash_act = stash_pt = partials = grads = None
    if mode != MODE_FWD:
        slots = n_chunks if (mode == MODE_STEP and keep) else 1
        stash_act = torch.empty(n_blocks, slots, len(packed.layers) - 1, CHUNK, stash_w,
                                device=dev, dtype=torch.bfloat16)
        stash_pt = torch.empty(n_blocks, slots, CHUNK, 4, **f32)
        partials = torch.zeros(n_blocks, w_total + b_total, **f32)
        grads = torch.empty(w_total + b_total, **f32)
    t = target.float().contiguous() if target is not None else None
    gc = g.float().contiguous() if g is not None else None
    ptr = lambda x: x.data_ptr() if x is not None else None
    lib = _kernel_lib()
    ip, fp_ptr, _fp_keep = _kernel_args(packed, rcfg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sfm_fused_train(
            mode, o.data_ptr(), d.data_ptr(), z.data_ptr(), ptr(t), ptr(gc), n, S,
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            ctypes.cast(ip, ctypes.c_void_p), fp_ptr,
            ptr(rgb), tb.data_ptr(), ptr(w), ptr(stash_act), ptr(stash_pt), ptr(partials), ptr(grads),
            n_blocks, int(keep), stash_w, w_total, w_total + b_total,
            2.0 / (3.0 * n), stream)
    if err != 0:
        raise RuntimeError("fused train kernel launch failed: "
                           + lib.sfm_cuda_error_string(err).decode())
    return rgb, tb, grads, w


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused train: no kernel for device {t.device}")
    return t.device.type


def fused_mse_loss_grads(packed: PackedNeRF, origins, directions, z_vals, target,
                         rcfg: RenderConfig, keep_activations: bool = True):
    """(rgb (N, 3), gw, gb): the step kernel's raw outputs, float32 grads of
    mean((rgb - target)^2) in the packed layout.  CUDA tensors launch the
    kernel (once), CPU tensors run the plain version.

    ``keep_activations``: the forward sweep stashes every chunk of a ray and
    the reverse walk consumes them (three forwards' worth of products);
    off, the reverse walk recomputes each chunk (four)."""
    _check(rcfg)
    if _device_kind(origins) == "cpu":
        return fused_mse_loss_reference(packed, origins, directions, z_vals, target, rcfg)
    rgb, _, grads, _ = _launch(MODE_STEP, packed, origins, directions, z_vals, rcfg,
                               target=target, keep=keep_activations)
    LAUNCHES["fused_mse_loss"] += 1
    n_w = packed.weights.numel()
    return rgb, grads[:n_w], grads[n_w:]


def fused_mse_loss_weights_grads(packed: PackedNeRF, origins, directions, z_vals, target,
                                 rcfg: RenderConfig):
    """(rgb (N, 3), weights (N, S), gw, gb): fused_mse_loss_grads plus the
    per-sample compositing weights of the forward sweep, from the same one
    launch (CUDA tensors) or the plain version (CPU tensors)."""
    _check(rcfg)
    if _device_kind(origins) == "cpu":
        return fused_mse_loss_weights_reference(packed, origins, directions, z_vals, target,
                                                rcfg)
    rgb, _, grads, w = _launch(MODE_STEP, packed, origins, directions, z_vals, rcfg,
                               target=target, emit_weights=True)
    LAUNCHES["fused_mse_loss_weights"] += 1
    n_w = packed.weights.numel()
    return rgb, w, grads[:n_w], grads[n_w:]


def _param_grads(packed: PackedNeRF, params, gw, gb) -> List[torch.Tensor]:
    named = unpack_grads(packed, gw, gb)
    by_param = {id(p): named[name] for name, p in packed.model.named_parameters()}
    return [by_param[id(p)].to(p.dtype) for p in params]


class _FusedMSELoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, origins, directions, z_vals, target, rcfg, *params):
        rgb, gw, gb = fused_mse_loss_grads(packed, origins, directions, z_vals, target, rcfg)
        ctx.grads = _param_grads(packed, params, gw, gb)
        return torch.mean((rgb - target.to(rgb.dtype)) ** 2)

    @staticmethod
    def backward(ctx, gbar):
        return (None,) * 6 + tuple(gbar * g for g in ctx.grads)


def fused_mse_loss(packed: PackedNeRF, origins, directions, z_vals, target,
                   rcfg: RenderConfig) -> torch.Tensor:
    """mean((render(rays) - target)^2), differentiable with respect to the
    parameters of ``packed.model``.  The forward already gives the exact
    parameter grads, so backward is a scalar rescale: value and grads cost
    one kernel launch."""
    if packed.model is None:
        raise ValueError("fused_mse_loss: pack with pack_nerf_params(model, ...)")
    return _FusedMSELoss.apply(packed, origins, directions, z_vals, target, rcfg,
                               *packed.model.parameters())


class _FusedMSELossWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, origins, directions, z_vals, target, rcfg, *params):
        rgb, w, gw, gb = fused_mse_loss_weights_grads(
            packed, origins, directions, z_vals, target, rcfg)
        ctx.grads = _param_grads(packed, params, gw, gb)
        ctx.mark_non_differentiable(w)
        return torch.mean((rgb - target.to(rgb.dtype)) ** 2), w

    @staticmethod
    def backward(ctx, gbar, _gw):
        return (None,) * 6 + tuple(gbar * g for g in ctx.grads)


def fused_mse_loss_weights(packed: PackedNeRF, origins, directions, z_vals, target,
                           rcfg: RenderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, weights (N, S)): fused_mse_loss and the per-sample compositing
    weights, the coarse pass of hierarchical training.  The weights carry no
    gradient (sample_pdf reads the histogram without differentiating through
    it), so backward is fused_mse_loss's scalar rescale."""
    if packed.model is None:
        raise ValueError("fused_mse_loss_weights: pack with pack_nerf_params(model, ...)")
    return _FusedMSELossWeights.apply(packed, origins, directions, z_vals, target, rcfg,
                                      *packed.model.parameters())


def fused_render_train_forward(packed: PackedNeRF, origins, directions, z_vals,
                               rcfg: RenderConfig):
    """(rgb (N, 3), tb (N, n_chunks)): the forward kernel's raw outputs, tb
    the transmittance entering each 128-sample chunk.  CUDA tensors launch
    the kernel (once), CPU tensors run the plain version."""
    _check(rcfg)
    if _device_kind(origins) == "cpu":
        return fused_render_train_reference(packed, origins, directions, z_vals, rcfg)
    rgb, tb, _, _ = _launch(MODE_FWD, packed, origins, directions, z_vals, rcfg)
    LAUNCHES["fused_render_train"] += 1
    return rgb, tb


def fused_render_train_backward(packed: PackedNeRF, origins, directions, z_vals,
                                rcfg: RenderConfig, tb, g):
    """(gw, gb): the backward kernel's raw outputs for the cotangent ``g``
    (N, 3) of rgb, float32 grads in the packed layout.  ``tb`` is the
    forward's.  CUDA tensors launch the kernel (once), CPU tensors run the
    plain version (which recomputes tb)."""
    _check(rcfg)
    if _device_kind(origins) == "cpu":
        return fused_render_train_reference(packed, origins, directions, z_vals, rcfg, g=g)
    _, _, grads, _ = _launch(MODE_BWD, packed, origins, directions, z_vals, rcfg, g=g, tb=tb)
    LAUNCHES["fused_render_train_backward"] += 1
    n_w = packed.weights.numel()
    return grads[:n_w], grads[n_w:]


class _FusedRenderTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, origins, directions, z_vals, rcfg, *params):
        rgb, tb = fused_render_train_forward(packed, origins, directions, z_vals, rcfg)
        ctx.packed, ctx.rcfg, ctx.params = packed, rcfg, params
        ctx.save_for_backward(origins, directions, z_vals, tb)
        return rgb

    @staticmethod
    def backward(ctx, g):
        origins, directions, z_vals, tb = ctx.saved_tensors
        gw, gb = fused_render_train_backward(ctx.packed, origins, directions, z_vals,
                                             ctx.rcfg, tb, g)
        return (None,) * 5 + tuple(_param_grads(ctx.packed, ctx.params, gw, gb))


def fused_render_train(packed: PackedNeRF, origins, directions, z_vals,
                       rcfg: RenderConfig) -> torch.Tensor:
    """rgb (N, 3), differentiable with respect to the parameters of
    ``packed.model`` for any loss on it: the forward kernel keeps the
    transmittance entering each chunk, the backward kernel recomputes each
    chunk's activations and applies the caller's cotangent."""
    if packed.model is None:
        raise ValueError("fused_render_train: pack with pack_nerf_params(model, ...)")
    return _FusedRenderTrain.apply(packed, origins, directions, z_vals, rcfg,
                                   *packed.model.parameters())
