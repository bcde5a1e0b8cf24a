"""Fused NeRF training step: forward and hand-written backward in CUDA.

Counterpart of sfm_nerf_tpu/kernels/fused_train.py.  Three wrappers named
as in the JAX package:

- ``fused_mse_loss``: mean((render(rays) - target)^2) as a scalar; the
  launches give rgb and the grads of every packed weight and bias (the MSE
  cotangent is made on the card); backward only scales them.
- ``fused_mse_loss_weights``: the same loss and, from the same launches,
  the per-sample compositing weights (N, S) of the forward sweep, detached:
  the coarse pass of hierarchical training, whose weights feed
  ``sample_pdf``.
- ``fused_render_train``: rgb (N, 3), differentiable for any loss on it.
  Forward launches the render kernel compiled with TB
  (csrc/fused_render.cu, K1's arithmetic: its rgb is K1's) once over all
  rays: rgb and tb, the transmittance entering each 128-sample chunk.
  Backward runs the split step under the caller's cotangent g, its forward
  sweep recomputing what JAX's backward kernel recomputes from tb.

All three run the split step (``_split_step``): per group of RAY_GROUP
rays, in ray order, (1) the render kernel compiled with STASH (K1's
arithmetic: its rgb and weights are K1's and K5's), which also writes every
layer input, the per-point density and colours and tb to a stash
(``stash_layout``); (2) the reverse walk (csrc/fused_train.cu), which
makes the cotangent (the MSE's from rgb and the target, or takes the
caller's g), writes every layer's output cotangent to a second stash and
keeps the bias and direction-row grads in per-warpgroup partials (its
products read the render tile image's weights as W^T, ``walk_plan``); (3) the
weight gradient, sum over points of A^T D per layer, a wgmma GEMM over both
stashes (csrc/grad_gemm.cu); then two fixed-order reductions add the
group's partials to the grads.  Under g = (rgb - target) * 2 / (3 N) the
backward of ``fused_render_train`` is the MSE step's launches, bit for bit.
The step's launch classes are spans of utils/profiling.py: ``k2.stash``
(1), ``k2.walk`` (2), ``k2.gemm`` (3 and its partials' reduction) and
``k2.reduce`` (the reverse walk's partials' reduction).

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
with the kernel's rounding points; ``split_forward_reference``,
``split_reverse_reference`` and ``grad_gemm_reference`` are the plain
versions of the split step's three launches on the stash layout
(``split_backward_reference`` chains the last two, ``split_step_reference``
all three), each under the MSE's cotangent or a given g.  A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernels or raises.
Each wrapper counts its calls that launch in ``LAUNCHES``, one per call.

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
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfm_nerf_tpu_torch.config import RenderConfig
from sfm_nerf_tpu_torch.kernels import fused_render as _fr
from sfm_nerf_tpu_torch.kernels.fused_render import (
    CHUNK, REF_RAY_CHUNK, RGB_HIDDEN, TILE_K, PackedNeRF, _ext, _kernel_args, _softplus,
    render_plan,
)
from sfm_nerf_tpu_torch.ops.render import sample_dists
from sfm_nerf_tpu_torch.utils.profiling import span

IMG_ROWS = 64                   # points per stash record: the render kernel's warpgroup tile
IMG_BLOCK = IMG_ROWS * TILE_K   # bf16 elements of one 64-row x 64-column stash block
# Rays per round of the split step (forward sweep, reverse walk, weight
# GEMM): the stashes of a round take about 11.4 KB a point at hidden 256,
# 3.0 GB at 1,024 x 256 samples.  Rounds run in ray order and their partial
# grads are summed in that order, so the grads do not depend on timing.
RAY_GROUP = 1024
# weight columns per ring slot of the reverse walk: a slot of 4 x WALK_KC x
# 128 bytes at hidden 256
WALK_KC = 32
_GEMM_TASK_INTS = 13            # grad_gemm.cu Task
_GEMM_MAX_TASKS = 64

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


def _rounding(packed: PackedNeRF, origins):
    """(ft, rnd): the plain versions' float type (float64 for float64 rays)
    and the rounding to the packing dtype where the kernels round."""
    ft = torch.float64 if origins.dtype == torch.float64 else torch.float32
    wdt = packed.weights.dtype
    rnd = (lambda t: t.to(wdt).to(ft)) if wdt != torch.float32 else (lambda t: t)
    return ft, rnd


def _reference_forward(packed: PackedNeRF, origins, directions, z_vals, rcfg: RenderConfig,
                       chunk: int, keep: bool, tc_order: bool = False):
    """The plain forward, REF_RAY_CHUNK rays at a time.  Yields (r0, rgb,
    tb, w, saved, extd) per ray chunk: tb the transmittance entering each
    ``chunk``-sample chunk, w the compositing weights, and with ``keep``
    ``saved`` the reverse walk's inputs of each chunk, (ext, hs, feat, rgb_h,
    rgb, dens, dists, x, Ti, w).

    With ``tc_order`` every product is summed in the order of the render
    kernel's wgmma chain: 16 rows of K at a time into a float32 accumulator
    that starts at the bias for a ReLU product (at the direction head plus
    the bias for rgb1) and at zero for the density and rgb heads, whose bias
    comes last; the direction head is one product at a time from zero."""
    ft, rnd = _rounding(packed, origins)
    body = [s for s in packed.layers if s.kind in ("plain", "skip")]
    Wf = {s.name: packed.w(s).detach().to(ft) for s in packed.layers}
    Bf = {s.name: packed.b(s).detach().to(ft) for s in packed.layers}
    h, S = packed.hidden, z_vals.shape[1]
    dev = origins.device

    def lin(x, W, b, bias_first=True):
        if not tc_order:
            return x @ W + b
        acc = (b.expand(x.shape[0], W.shape[1]).clone() if bias_first
               else torch.zeros(x.shape[0], W.shape[1], device=dev, dtype=ft))
        for k0 in range(0, W.shape[0], 16):
            acc = acc + x[:, k0:k0 + 16] @ W[k0:k0 + 16]
        return acc if bias_first else acc + b

    for r0 in range(0, origins.shape[0], REF_RAY_CHUNK):
        o = origins[r0:r0 + REF_RAY_CHUNK].to(ft)
        d = directions[r0:r0 + REF_RAY_CHUNK].to(ft)
        z = z_vals[r0:r0 + REF_RAY_CHUNK].to(ft)
        n = o.shape[0]
        dists = sample_dists(z, rcfg.variant)
        extd = rnd(_ext(d, packed.n_dir_freq, packed.dir_dim))
        if tc_order:
            dir_part = torch.zeros(n, RGB_HIDDEN, device=dev, dtype=ft)
            for k in range(extd.shape[1]):
                dir_part = dir_part + extd[:, k:k + 1] * Wf["rgb1"][h + k]
        else:
            dir_part = extd @ Wf["rgb1"][h:]
        T = torch.ones(n, 1, device=dev, dtype=ft)
        acc = torch.zeros(n, 3, device=dev, dtype=ft)
        saved, tb, ws = [], [], []
        for c0 in range(0, S, chunk):
            zc, dc = z[:, c0:c0 + chunk], dists[:, c0:c0 + chunk]
            ch = zc.shape[1]
            pts = (o[:, None, :] + d[:, None, :] * zc[..., None]).reshape(-1, 3)
            ext = rnd(_ext(pts, packed.n_pos_freq, packed.pos_pad))
            hs = [rnd(torch.relu(lin(ext, Wf["fc1"], Bf["fc1"])))]
            for s in body:
                inp = torch.cat([hs[-1], ext], -1) if s.kind == "skip" else hs[-1]
                hs.append(rnd(torch.relu(lin(inp, Wf[s.name], Bf[s.name]))))
            df = lin(hs[-1], Wf["densfeat"], Bf["densfeat"])
            feat = rnd(torch.relu(df[:, :h]))
            dens = (lin(hs[-1], Wf["densfeat"][:, h:h + 1], Bf["densfeat"][h:h + 1], False)[:, 0]
                    if tc_order else df[:, h])
            dens = _softplus(dens) if packed.density_act == "softplus" else torch.relu(dens)
            if tc_order:
                head = (dir_part[:, None, :] + Bf["rgb1"]).expand(n, ch, RGB_HIDDEN)
                pre = lin(feat, Wf["rgb1"][:h], head.reshape(n * ch, -1))
            else:
                pre = (feat @ Wf["rgb1"][:h]).reshape(n, ch, RGB_HIDDEN) + dir_part[:, None, :] \
                    + Bf["rgb1"]
            rgb_h = rnd(torch.relu(pre)).reshape(n * ch, -1)
            rgb = torch.sigmoid(lin(rgb_h, Wf["rgb2"], Bf["rgb2"], False)[:, :3]).reshape(n, ch, 3)
            xs = dens.reshape(n, ch) * dc
            csum = torch.cumsum(-xs, 1)
            Ti = T * torch.exp(csum + xs)
            w = (1.0 - torch.exp(-xs)) * Ti
            acc = acc + torch.sum(w[..., None] * rgb, 1)
            tb.append(T)
            ws.append(w)
            T = T * torch.exp(csum[:, -1:])
            if keep:
                saved.append((ext, hs, feat, rgb_h, rgb, dens, dc, xs, Ti, w))
        rgb_out = acc + T if rcfg.white_background else acc
        yield r0, rgb_out, torch.cat(tb, 1), torch.cat(ws, 1), saved, extd


def _walk_back(packed: PackedNeRF, item, g, gsum, carry, ddir, gB, on_layer):
    """The reverse walk of one chunk (``item`` as _reference_forward saves
    it) under the rgb cotangent ``g`` (n, 3).  Adds the bias grads to
    ``gB`` and calls ``on_layer(name, parts, D)`` once per layer with its
    output cotangent D and its input as [(first weight row, A)] (the skip
    layer's encoding rows a second part).  Returns the updated (carry,
    ddir)."""
    ext, hs, feat, rgb_h, rgb, dens, dc, xs, Ti, w = item
    ft, rnd = _rounding(packed, xs)
    body = [s for s in packed.layers if s.kind in ("plain", "skip")]
    specs = {s.name: s for s in packed.layers}
    h = packed.hidden
    n, ch = xs.shape
    dev = xs.device
    # compositing: dL/dalpha = q T - R / one_m, R the strict suffix sum of
    # q w (this chunk's, plus the later chunks' carry)
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

    def back(name, parts, D):
        """Layer ``name``'s grads from D; the input cotangent, masked by
        A > 0 and rounded."""
        on_layer(name, parts, D)
        gB[name] += D.sum(0)
        A = parts[0][1]
        k = A.shape[1]
        W = packed.w(specs[name]).detach().to(ft)
        return rnd((D @ W[:k].t()) * (A > 0))

    D = rnd(F.pad(drgb, (0, specs["rgb2"].n - 3)))
    D = back("rgb2", [(0, rgb_h)], D)
    ddir = ddir + D.reshape(n, ch, -1).sum(1)
    D = back("rgb1", [(0, feat)], D)
    D = torch.cat([D, rnd(ddens)[:, None],
                   torch.zeros(D.shape[0], specs["densfeat"].n - h - 1, device=dev, dtype=ft)], 1)
    D = back("densfeat", [(0, hs[-1])], D)
    for j in range(len(body) - 1, -1, -1):
        s = body[j]
        D = back(s.name, [(0, hs[j])] + ([(h, ext)] if s.kind == "skip" else []), D)
    on_layer("fc1", [(0, ext)], D)
    gB["fc1"] += D.sum(0)
    return carry, ddir


def _flat_grads(packed: PackedNeRF, gW, gB, like):
    gw = torch.zeros(packed.weights.numel(), device=like.device, dtype=like.dtype)
    gb = torch.zeros(packed.biases.numel(), device=like.device, dtype=like.dtype)
    for s in packed.layers:
        if s.name in gW:
            gw[s.w_off:s.w_off + s.k_rows * s.n] = gW[s.name].reshape(-1)
        gb[s.b_off:s.b_off + s.n] = gB[s.name]
    return gw, gb


def _reference_pass(packed: PackedNeRF, origins, directions, z_vals, rcfg: RenderConfig,
                    cotangent, chunk: int, tc_order: bool = False):
    """Forward and reverse walk of the plain version over all rays.

    ``cotangent(rgb, r0)`` -> g for the rays ``[r0, r0 + len(rgb))``, or
    None for a forward only.  Returns (rgb, tb, w, gw, gb): tb (N,
    n_chunks) is the transmittance entering each chunk, w (N, S) the
    compositing weights, gw / gb the flat grads in the packed layout (None
    without a cotangent)."""
    ft, _ = _rounding(packed, origins)
    h = packed.hidden
    dev = origins.device
    gW = {s.name: torch.zeros(s.k_rows, s.n, device=dev, dtype=ft) for s in packed.layers}
    gB = {s.name: torch.zeros(s.n, device=dev, dtype=ft) for s in packed.layers}

    def add_dw(name, parts, D):
        for row0, A in parts:
            gW[name][row0:row0 + A.shape[1]] += A.t() @ D

    rgb_parts, tb_parts, w_parts = [], [], []
    for r0, rgb_out, tb, ws, saved, extd in _reference_forward(
            packed, origins, directions, z_vals, rcfg, chunk, cotangent is not None,
            tc_order):
        rgb_parts.append(rgb_out)
        tb_parts.append(tb)
        w_parts.append(ws)
        if cotangent is None:
            continue
        g = cotangent(rgb_out, r0).to(ft)                                # (n, 3)
        gsum = g.sum(1, keepdim=True) if rcfg.white_background else 0.0
        carry = torch.zeros(g.shape[0], 1, device=dev, dtype=ft)
        ddir = torch.zeros(g.shape[0], RGB_HIDDEN, device=dev, dtype=ft)
        for item in reversed(saved):
            carry, ddir = _walk_back(packed, item, g, gsum, carry, ddir, gB, add_dw)
        # rgb1's direction rows, once per ray
        gW["rgb1"][h:] += extd.t() @ ddir

    rgb, tb, weights = torch.cat(rgb_parts), torch.cat(tb_parts), torch.cat(w_parts)
    if cotangent is None:
        return rgb, tb, weights, None, None
    gw, gb = _flat_grads(packed, gW, gB, rgb)
    return rgb, tb, weights, gw, gb


# ---------------------------------------------------------------------------
# the split step's stashes and the plain versions of its three launches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StashLayout:
    """Where the split step keeps a ray group's activations and cotangents.

    A record holds 64 consecutive samples of one ray: ray i's record j
    covers samples [64 j, 64 j + 64), j < 2 ceil(S / 128) (the forward sweep
    walks whole 128-sample chunks; rows past S hold finite values that
    every grad multiplies by a zero cotangent).  A record is a run of
    blocks, each 64 rows (points) x 64 columns of bf16 in the render
    kernel's 128-byte swizzle: element (r, c) of a block at r * 64 +
    ((c // 8) ^ (r % 8)) * 8 + c % 8 (``image_index``), which is the
    shared-memory image the forward's products read, copied out as it is.

    - activation record (``rec_act`` elements): the encoding in ``enc_kb``
      blocks, then slot j (the output of packed layer j, j < n_layers - 1)
      at block ``enc_kb + j act_kb``;
    - cotangent record (``rec_cot`` elements): layer l's output cotangent
      (its n columns) from block ``cot_off[l]``;
    - point record: (density, r, g, b) float32 per point."""
    enc_kb: int
    act_kb: int
    n_slots: int
    rec_act: int
    cot_off: Tuple[int, ...]
    rec_cot: int

    def slot_block(self, j: int) -> int:
        return self.enc_kb + j * self.act_kb

    def ints(self) -> List[int]:
        """The reverse walk's view (fused_train.cu)."""
        return [self.rec_act, self.enc_kb, self.act_kb, self.rec_cot, *self.cot_off]


def stash_layout(packed: PackedNeRF) -> StashLayout:
    plan = render_plan(packed)
    n_slots = len(packed.layers) - 1
    offs, b = [], 0
    for s in packed.layers:
        offs.append(b)
        b += -(-s.n // TILE_K)
    return StashLayout(plan.enc_kb, plan.act_kb, n_slots,
                       (plan.enc_kb + n_slots * plan.act_kb) * IMG_BLOCK, tuple(offs),
                       b * IMG_BLOCK)


def image_index(width: int, device=None) -> torch.Tensor:
    """(64, width) element offsets of a 64-row image of ceil(width / 64)
    blocks (StashLayout)."""
    r = torch.arange(IMG_ROWS, device=device)[:, None]
    c = torch.arange(width, device=device)[None, :]
    return (c // TILE_K) * IMG_BLOCK + r * TILE_K + ((c % TILE_K // 8) ^ (r % 8)) * 8 + c % 8


def from_image(records: torch.Tensor, block: int, width: int) -> torch.Tensor:
    """(n_rec * 64, width) rows of the image starting at ``block`` of every
    record of ``records`` (n_rec, rec)."""
    idx = image_index(width, records.device) + block * IMG_BLOCK
    return records[:, idx].reshape(-1, width)


def to_image(records: torch.Tensor, block: int, rows: torch.Tensor) -> None:
    """Writes ``rows`` (n_rec * 64, width) as the image at ``block`` of
    every record, in place."""
    width = rows.shape[1]
    idx = image_index(width, records.device) + block * IMG_BLOCK
    records[:, idx] = rows.reshape(records.shape[0], IMG_ROWS, width).to(records.dtype)


def _points(n: int, S: int, r0: int, c0: int, ch: int, device) -> torch.Tensor:
    """Record rows of rays [r0, r0 + n) x samples [c0, c0 + ch), ray-major,
    in a group of 2 ceil(S / 128) records a ray."""
    per_ray = 2 * -(-S // CHUNK) * IMG_ROWS
    ray = torch.arange(r0, r0 + n, device=device)[:, None]
    return (ray * per_ray + torch.arange(c0, c0 + ch, device=device)[None, :]).reshape(-1)


def _stash_dtype(packed: PackedNeRF, ft):
    return torch.bfloat16 if packed.weights.dtype == torch.bfloat16 else ft


def split_forward_reference(packed: PackedNeRF, origins, directions, z_vals,
                            rcfg: RenderConfig):
    """Plain version of the split step's forward sweep (fused_render.cu
    STASH) on one ray group: (rgb (n, 3), tb (n, ceil(S / 128)), weights (n,
    S), stash), stash = {"act": (n_rec, rec_act), "pt": (n_rec * 64, 4)}
    in the StashLayout (pad rows zero).  Activations are stored in bf16 for
    a bf16 packing (they are bf16 values: exact in float64 too), the point
    records in the float type."""
    _check(rcfg)
    ft, _ = _rounding(packed, origins)
    lay = stash_layout(packed)
    n, S = z_vals.shape
    dev = origins.device
    n_rec = n * 2 * -(-S // CHUNK)
    act = torch.zeros(n_rec, lay.rec_act, device=dev, dtype=_stash_dtype(packed, ft))
    pt = torch.zeros(n_rec * IMG_ROWS, 4, device=dev, dtype=ft)
    dense = {j: torch.zeros(n_rec * IMG_ROWS, w, device=dev, dtype=ft)
             for j, w in [(-1, packed.pos_pad)] + [
                 (j, RGB_HIDDEN if s.kind == "rgb1" else packed.hidden)
                 for j, s in enumerate(packed.layers[:-1])]}
    rgb_p, tb_p, w_p = [], [], []
    for r0, rgb_out, tb, ws, saved, _ in _reference_forward(
            packed, origins, directions, z_vals, rcfg, CHUNK, True):
        rgb_p.append(rgb_out)
        tb_p.append(tb)
        w_p.append(ws)
        for c, (ext, hs, feat, rgb_h, rgb, dens, *_rest) in enumerate(saved):
            m = rgb.shape[0]
            rows = _points(m, S, r0, c * CHUNK, rgb.shape[1], dev)
            for j, x in [(-1, ext)] + list(enumerate(hs + [feat, rgb_h])):
                dense[j][rows] = x
            pt[rows] = torch.cat([dens[:, None], rgb.reshape(-1, 3)], 1)
    for j, x in dense.items():
        to_image(act, 0 if j < 0 else lay.slot_block(j), x)
    return (torch.cat(rgb_p), torch.cat(tb_p), torch.cat(w_p), {"act": act, "pt": pt})


def split_reverse_reference(packed: PackedNeRF, directions, z_vals, rcfg: RenderConfig,
                            rgb, target, tb, stash, gscale: float,
                            g: Optional[torch.Tensor] = None):
    """Plain version of the split step's reverse walk (fused_train.cu) on
    one ray group: from the forward's tb and stash and the cotangent, ``g``
    (n, 3) or else (rgb - target) * gscale, (cot (n_rec, rec_cot) with every
    layer's output cotangent, gb (bias grads, packed layout), gdir (rgb1's
    direction-row grads, (dir_dim, 128)))."""
    _check(rcfg)
    ft = stash["pt"].dtype
    lay = stash_layout(packed)
    n, S = z_vals.shape
    dev = z_vals.device
    act = stash["act"]
    cot = torch.zeros(act.shape[0], lay.rec_cot, device=dev, dtype=act.dtype)
    specs = {s.name: (i, s) for i, s in enumerate(packed.layers)}
    body = [s for s in packed.layers if s.kind in ("plain", "skip")]
    dense_in = {j: from_image(act, 0 if j < 0 else lay.slot_block(j), w).to(ft)
                for j, w in [(-1, packed.pos_pad)] + [
                    (j, RGB_HIDDEN if s.kind == "rgb1" else packed.hidden)
                    for j, s in enumerate(packed.layers[:-1])]}
    dense_cot = {s.name: torch.zeros(act.shape[0] * IMG_ROWS, s.n, device=dev, dtype=ft)
                 for s in packed.layers}
    gB = {s.name: torch.zeros(s.n, device=dev, dtype=ft) for s in packed.layers}
    gdir = torch.zeros(packed.dir_dim, RGB_HIDDEN, device=dev, dtype=ft)
    dists_all = sample_dists(z_vals.to(ft), rcfg.variant)
    nc = -(-S // CHUNK)
    for r0 in range(0, n, REF_RAY_CHUNK):
        m = min(REF_RAY_CHUNK, n - r0)
        gr = (g[r0:r0 + m].to(ft) if g is not None
              else (rgb[r0:r0 + m].to(ft) - target[r0:r0 + m].to(ft)) * gscale)
        gsum = gr.sum(1, keepdim=True) if rcfg.white_background else 0.0
        carry = torch.zeros(m, 1, device=dev, dtype=ft)
        ddir = torch.zeros(m, RGB_HIDDEN, device=dev, dtype=ft)
        for c in range(nc - 1, -1, -1):
            ch = min(CHUNK, S - c * CHUNK)
            rows = _points(m, S, r0, c * CHUNK, ch, dev)
            dc = dists_all[r0:r0 + m, c * CHUNK:c * CHUNK + ch]
            p = stash["pt"][rows]
            dens, rgb_c = p[:, 0], p[:, 1:].reshape(m, ch, 3)
            xs = dens.reshape(m, ch) * dc
            Ti = tb[r0:r0 + m, c:c + 1].to(ft) * torch.exp(torch.cumsum(-xs, 1) + xs)
            w = (1.0 - torch.exp(-xs)) * Ti
            hs = [dense_in[j][rows] for j in range(len(body) + 1)]
            item = (dense_in[-1][rows], hs, dense_in[len(body) + 1][rows],
                    dense_in[len(body) + 2][rows], rgb_c, dens, dc, xs, Ti, w)

            def keep_d(name, parts, D, rows=rows):
                dense_cot[name][rows] = D

            carry, ddir = _walk_back(packed, item, gr, gsum, carry, ddir, gB, keep_d)
        extd = _rounding(packed, z_vals.to(ft))[1](
            _ext(directions[r0:r0 + m].to(ft), packed.n_dir_freq, packed.dir_dim))
        gdir += extd.t() @ ddir
    for name, (i, _) in specs.items():
        to_image(cot, lay.cot_off[i], dense_cot[name])
    gb = torch.zeros(packed.biases.numel(), device=dev, dtype=ft)
    for s in packed.layers:
        gb[s.b_off:s.b_off + s.n] = gB[s.name]
    return cot, gb, gdir


def _gemm_inputs(packed: PackedNeRF, lay: StashLayout, spec, li: int):
    """[(first weight row, rows, activation block)] of the segments layer
    ``li``'s weight rows read: fc1 the encoding, skip the previous output
    then the encoding, every other layer the previous output."""
    h, pad = packed.hidden, packed.pos_pad
    if spec.kind == "fc1":
        return [(0, pad, 0)]
    if spec.kind == "skip":
        return [(0, h, lay.slot_block(li - 1)), (h, pad, 0)]
    return [(0, spec.k, lay.slot_block(li - 1))]


def grad_gemm_reference(packed: PackedNeRF, act, cot, dtype=torch.float32):
    """Plain version of grad_gemm.cu: the flat weight grads (packed layout)
    sum over every record's points of A_l^T D_l, in ``dtype``; rgb1's
    direction rows (the reverse walk's) are zero."""
    lay = stash_layout(packed)
    gw = torch.zeros(packed.weights.numel(), device=act.device, dtype=dtype)
    for li, s in enumerate(packed.layers):
        D = from_image(cot, lay.cot_off[li], s.n).to(dtype)
        w = gw[s.w_off:s.w_off + s.k_rows * s.n].view(s.k_rows, s.n)
        for row0, rows, block in _gemm_inputs(packed, lay, s, li):
            w[row0:row0 + rows] = from_image(act, block, rows).to(dtype).t() @ D
    return gw


def split_backward_reference(packed: PackedNeRF, directions, z_vals, rcfg: RenderConfig,
                             rgb, target, tb, stash, gscale: float,
                             g: Optional[torch.Tensor] = None):
    """The plain versions of the reverse walk and the weight GEMM chained on
    one ray group's forward (rgb, tb, stash) under the cotangent of
    split_reverse_reference: (gw, gb), the group's flat grads in the packed
    layout, in the float type of ``stash["pt"]``."""
    ft = stash["pt"].dtype
    cot, gb, gdir = split_reverse_reference(packed, directions, z_vals, rcfg, rgb, target, tb,
                                            stash, gscale, g)
    gw = grad_gemm_reference(packed, stash["act"], cot, ft)
    spec = {s.name: s for s in packed.layers}["rgb1"]
    dir0 = spec.w_off + packed.hidden * spec.n
    gw[dir0:dir0 + gdir.numel()] = gdir.reshape(-1)
    return gw, gb


def split_step_reference(packed: PackedNeRF, origins, directions, z_vals, target,
                         rcfg: RenderConfig, group: int = None,
                         g: Optional[torch.Tensor] = None):
    """The three plain versions chained over ray groups of ``group`` rays
    (RAY_GROUP by default), grads summed over the groups in order: (rgb (N,
    3), weights (N, S), gw, gb).  Under the MSE's cotangent (``target``)
    the function of fused_mse_loss_weights_grads; given the cotangent ``g``
    (N, 3) (``target`` unused), rgb and weights and the grads of
    fused_render_train_backward."""
    _check(rcfg)
    group = group or RAY_GROUP
    n = origins.shape[0]
    ft, _ = _rounding(packed, origins)
    gw = torch.zeros(packed.weights.numel(), device=origins.device, dtype=ft)
    gb = torch.zeros(packed.biases.numel(), device=origins.device, dtype=ft)
    rgb_p, w_p = [], []
    for r0 in range(0, n, group):
        sl = slice(r0, r0 + group)
        rgb, tb, w, stash = split_forward_reference(
            packed, origins[sl], directions[sl], z_vals[sl], rcfg)
        gw_g, gb_g = split_backward_reference(
            packed, directions[sl], z_vals[sl], rcfg, rgb,
            target[sl] if g is None else None, tb, stash, 2.0 / (3.0 * n),
            g[sl] if g is not None else None)
        gw, gb = gw + gw_g, gb + gb_g
        rgb_p.append(rgb)
        w_p.append(w)
    return torch.cat(rgb_p), torch.cat(w_p), gw, gb


def fused_mse_loss_reference(packed: PackedNeRF, origins, directions, z_vals, target,
                             rcfg: RenderConfig, chunk: int = CHUNK,
                             tc_order: bool = False):
    """Plain PyTorch version of the step kernel: (rgb (N, 3), gw, gb) with
    gw / gb the grads of mean((rgb - target)^2) in the packed layout.

    It repeats the kernel's arithmetic step by step: the chunked forward of
    ``fused_render_rays_reference`` and a hand-written reverse walk (no
    autograd) with the kernel's rounding points, in float32, or in float64
    when given float64 rays.  With ``tc_order`` the forward's products are
    summed in the order of the split step's forward sweep (the render
    kernel's wgmma chain, _reference_forward): a witness of how far the
    grads move with the forward's summation order alone."""
    rgb, _, gw, gb = fused_mse_loss_weights_reference(
        packed, origins, directions, z_vals, target, rcfg, chunk, tc_order)
    return rgb, gw, gb


def fused_mse_loss_weights_reference(packed: PackedNeRF, origins, directions, z_vals, target,
                                     rcfg: RenderConfig, chunk: int = CHUNK,
                                     tc_order: bool = False):
    """Plain PyTorch version of the step kernel with its weights output:
    (rgb (N, 3), weights (N, S), gw, gb), the weights those the forward
    sweep composited with, at the caller's sample count."""
    _check(rcfg)
    scale = 2.0 / (3.0 * origins.shape[0])
    rgb, _, weights, gw, gb = _reference_pass(
        packed, origins, directions, z_vals, rcfg,
        lambda rgb, r0: (rgb - target[r0:r0 + rgb.shape[0]].to(rgb.dtype)) * scale, chunk,
        tc_order)
    return rgb, weights, gw, gb


def fused_render_train_reference(packed: PackedNeRF, origins, directions, z_vals,
                                 rcfg: RenderConfig, g: Optional[torch.Tensor] = None,
                                 chunk: int = CHUNK, tc_order: bool = False):
    """Plain PyTorch version of the two-kernel route.  Without ``g``: the
    forward kernel's (rgb (N, 3), tb (N, n_chunks)).  With the cotangent
    ``g`` (N, 3): the backward kernel's (gw, gb) in the packed layout.
    ``tc_order`` as for fused_mse_loss_reference."""
    _check(rcfg)
    if g is None:
        rgb, tb, _, _, _ = _reference_pass(packed, origins, directions, z_vals, rcfg, None, chunk,
                                           tc_order)
        return rgb, tb
    _, _, _, gw, gb = _reference_pass(
        packed, origins, directions, z_vals, rcfg,
        lambda rgb, r0: g[r0:r0 + rgb.shape[0]], chunk, tc_order)
    return gw, gb


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C functions declared."""
    from sfm_nerf_tpu_torch.kernels import _build

    lib = _build.load("fused_train")
    lib.sfm_reverse_walk.restype = ctypes.c_int
    lib.sfm_reverse_walk.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.sfm_reduce_add.restype = ctypes.c_int
    lib.sfm_reduce_add.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                                   + [ctypes.c_void_p] * 3)
    lib.sfm_cuda_error_string.restype = ctypes.c_char_p
    lib.sfm_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _gemm_lib() -> ctypes.CDLL:
    from sfm_nerf_tpu_torch.kernels import _build

    lib = _build.load("grad_gemm")
    lib.sfm_grad_gemm.restype = ctypes.c_int
    lib.sfm_grad_gemm.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    lib.sfm_cuda_error_string.restype = ctypes.c_char_p
    lib.sfm_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.sfm_cuda_error_string(err).decode())


def _ptr(x) -> Optional[int]:
    return x.data_ptr() if x is not None else None


def _check_inputs(packed: PackedNeRF, origins, directions, z_vals, **extra) -> None:
    """The kernels' input checks: devices, shapes, the bf16 packing."""
    dev = origins.device
    n, S = z_vals.shape
    tensors = [("directions", directions), ("z_vals", z_vals),
               ("weights", packed.weights), ("biases", packed.biases)]
    for name, t in extra.items():
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
    if sum(s.k_rows * s.n for s in packed.layers) != packed.weights.numel():
        raise ValueError("fused train kernel: the packed weights hold pad elements "
                         "between layers, which the grad reduction would read")


def gemm_tasks(packed: PackedNeRF) -> List[List[int]]:
    """grad_gemm.cu's tasks, each a block's share of one layer's weight
    gradient: up to 256 columns of it and up to two 64-row tiles (one per
    consumer warpgroup), as [w_off, n, n0, ncols, d_block, d_blocks,
    n_tiles, (k0, k_rows, a_block) x 2].  Together they cover every packed
    weight element but rgb1's direction rows once."""
    lay = stash_layout(packed)
    tasks = []
    for li, s in enumerate(packed.layers):
        tiles = [(row0 + r, min(TILE_K, rows - r), block + r // TILE_K)
                 for row0, rows, block in _gemm_inputs(packed, lay, s, li)
                 for r in range(0, rows, TILE_K)]
        for n0 in range(0, s.n, 256):
            ncols = min(256, s.n - n0)
            for i in range(0, len(tiles), 2):
                pair = tiles[i:i + 2]
                flat = [x for t in pair + pair[:1] * (2 - len(pair)) for x in t]
                tasks.append([s.w_off, s.n, n0, ncols, lay.cot_off[li] + n0 // TILE_K,
                              -(-ncols // TILE_K), len(pair), *flat])
    if len(tasks) > _GEMM_MAX_TASKS:
        raise ValueError(f"weight GEMM: {len(tasks)} tasks > {_GEMM_MAX_TASKS}")
    return tasks


@dataclasses.dataclass(frozen=True)
class WalkStage:
    """One ring slot of the reverse walk: columns [k0, k0 + kc) of packed
    layer ``layer``'s weight (kc a multiple of 16, at most TILE_K) for every
    64-row tile of the rows the walk multiplies, read from the render tile
    image as they are.  A tile of the image holds its weight columns as rows
    of 64 weight-row values (render_plan), so piece p, rows [k0 - col0,
    k0 - col0 + kc) of the layer's p-th tile at element ``offs[p]``, is the
    MN-major (desc_sw128_mn) image of W^T rows [k0, k0 + kc) x columns
    [64 p, 64 p + 64)."""
    layer: int
    k0: int
    kc: int
    offs: Tuple[int, ...]


def walk_plan(packed: PackedNeRF) -> Tuple[WalkStage, ...]:
    """The reverse walk's weight stages in the order it multiplies them:
    layers from the last to the second (fc1 passes no cotangent on), each
    as its output columns in steps of WALK_KC, the density/feature head's
    feature columns before its density columns.  The rows are the ones the
    cotangent reaches: the previous layer's output (the skip layer's
    encoding rows and rgb1's direction rows are left out)."""
    plan = render_plan(packed)
    stages = []
    for li in range(len(packed.layers) - 1, 0, -1):
        name = packed.layers[li].name
        passes = sorted((p for p in plan.passes if p.layer == name), key=lambda p: p.tiles[0].col0)
        for p in passes:
            tiles = [t for t in p.tiles if t.src == "act"]
            for c0 in range(0, p.n, WALK_KC):
                stages.append(WalkStage(li, tiles[0].col0 + c0, min(WALK_KC, p.n - c0),
                                        tuple(t.off + c0 * TILE_K for t in tiles)))
    return tuple(stages)


_WALK_INTS: Dict[tuple, ctypes.Array] = {}


def _walk_ints(packed: PackedNeRF) -> ctypes.Array:
    """The reverse walk's layout argument (fused_train.cu parse_walk):
    StashLayout.ints(), the stage count, then (layer, k0, kc, pieces,
    4 piece offsets) per stage; cached per layout."""
    key = (packed.layers, packed.hidden, packed.pos_pad, packed.dir_dim)
    if key not in _WALK_INTS:
        ints = stash_layout(packed).ints()
        stages = walk_plan(packed)
        ints.append(len(stages))
        for s in stages:
            ints += [s.layer, s.k0, s.kc, len(s.offs), *s.offs, *[0] * (4 - len(s.offs))]
        _WALK_INTS[key] = (ctypes.c_int * len(ints))(*ints)
    return _WALK_INTS[key]


def _gemm_partials(packed: PackedNeRF, n_rec: int, dev) -> torch.Tensor:
    """Zeroed float32 partials of the weight GEMM over ``n_rec`` records:
    one row of the packed weights' length per point slice, as many slices
    as fill about two blocks per SM (elements no task writes, rgb1's
    direction rows, stay zero)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = max(1, min(n_rec, 2 * sms // _gemm_tasks(packed)[0]))
    return torch.zeros(n_split, packed.weights.numel(), device=dev, dtype=torch.float32)


def _gemm_tasks(packed: PackedNeRF):
    """(n_tasks, tasks as an int32 array), cached on the packing."""
    if "gemm_tasks" not in packed.tile_cache:
        flat = np.asarray(gemm_tasks(packed), np.int32)
        packed.tile_cache["gemm_tasks"] = (flat.shape[0], flat)
    return packed.tile_cache["gemm_tasks"]


def _gemm_launch(packed: PackedNeRF, act, cot, n_rec: int, partials) -> None:
    """grad_gemm.cu over ``n_rec`` records into ``partials`` (one row per
    point slice, _gemm_partials)."""
    n_tasks, flat = _gemm_tasks(packed)
    lay = stash_layout(packed)
    lib = _gemm_lib()
    with torch.cuda.device(act.device):
        stream = torch.cuda.current_stream(act.device).cuda_stream
        err = lib.sfm_grad_gemm(act.data_ptr(), cot.data_ptr(),
                                flat.ctypes.data_as(ctypes.c_void_p), n_tasks,
                                partials.shape[0], n_rec, lay.rec_act, lay.rec_cot,
                                packed.weights.numel(), partials.data_ptr(), stream)
    _raise(lib, err, "weight-gradient GEMM")


def _reduce_add(partials, n_rows: int, n_a: int, dst_a, dst_b) -> None:
    lib = _kernel_lib()
    with torch.cuda.device(partials.device):
        stream = torch.cuda.current_stream(partials.device).cuda_stream
        err = lib.sfm_reduce_add(partials.data_ptr(), n_rows, partials.shape[1], n_a,
                                 dst_a.data_ptr(), dst_b.data_ptr(), stream)
    _raise(lib, err, "partials reduction")


def _weight_grad(packed: PackedNeRF, act, cot, n_rec: int, gw) -> None:
    """The weight GEMM (grad_gemm.cu) over ``n_rec`` records of the stashes
    ``act`` and ``cot`` and the fixed-order reduction that adds its partials
    to ``gw`` (float32, the packed weights' layout first; rgb1's direction
    rows get nothing)."""
    with span("k2.gemm"):
        part = _gemm_partials(packed, n_rec, act.device)
        _gemm_launch(packed, act, cot, n_rec, part)
        _reduce_add(part, part.shape[0], part.shape[1], gw, gw)


def _scratch(shape, dtype, device) -> torch.Tensor:
    """Uninitialised device memory for what a launch writes before another
    reads it (the stashes; tb and rgb where the caller does not keep
    them)."""
    return torch.empty(shape, device=device, dtype=dtype)


def _split_forward(packed: PackedNeRF, rcfg: RenderConfig, o, d, z, rgb, w, tb, act, pt) -> None:
    """The forward sweep of one ray group (fused_render.cu STASH, K1's
    arithmetic): writes rgb, the weights ``w`` (or none), tb and the stash
    records ``act`` and ``pt``."""
    n, S = z.shape
    lib = _fr._kernel_lib()
    ip, fp, _fp_keep = _fr._render_kernel_args(packed, rcfg)
    image = _fr.render_tile_image(packed)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    with span("k2.stash"):
        err = lib.sfm_fused_render_stash(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), n, S, image.data_ptr(),
            packed.biases.data_ptr(), ctypes.cast(ip, ctypes.c_void_p), fp, rgb.data_ptr(),
            _ptr(w), int(w is not None), act.data_ptr(), pt.data_ptr(), tb.data_ptr(), stream)
    _raise(lib, err, "split-step forward sweep")


def _split_backward(packed: PackedNeRF, rcfg: RenderConfig, o, d, z, t, rgb, tb, act, pt,
                    gscale: float, grads, g=None) -> None:
    """The reverse walk (fused_train.cu) and the weight GEMM (grad_gemm.cu)
    of one ray group on its forward's tb and stash, under the cotangent
    ``g`` (n, 3) or, without it, (rgb - t) * gscale, and the two
    fixed-order reductions that add the group's partial grads to ``grads``
    (weights then biases, packed layout)."""
    dev = o.device
    n, S = z.shape
    n_rec = n * 2 * -(-S // CHUNK)
    lay = stash_layout(packed)
    n_w, n_b = packed.weights.numel(), packed.biases.numel()
    dir_n = packed.dir_dim * RGB_HIDDEN
    # a block per SM, two rays at a time (one per consumer warpgroup), a
    # partial row per warpgroup
    n_blocks = min(torch.cuda.get_device_properties(dev).multi_processor_count, -(-n // 2))
    cot = _scratch((n_rec, lay.rec_cot), torch.bfloat16, dev)
    rev_part = torch.zeros(2 * n_blocks, dir_n + n_b, device=dev, dtype=torch.float32)
    rgb1 = {s.name: s for s in packed.layers}["rgb1"]
    lib = _kernel_lib()
    ip, fp, _fp_keep = _kernel_args(packed, rcfg)
    walk_ints = _walk_ints(packed)
    image = _fr.render_tile_image(packed)
    mse = g is None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with span("k2.walk"):
        err = lib.sfm_reverse_walk(
            d.data_ptr(), z.data_ptr(), rgb.data_ptr() if mse else None,
            t.data_ptr() if mse else None, None if mse else g.data_ptr(), gscale, n, S,
            image.data_ptr(), ctypes.cast(ip, ctypes.c_void_p), fp, tb.data_ptr(),
            act.data_ptr(), pt.data_ptr(), cot.data_ptr(),
            ctypes.cast(walk_ints, ctypes.c_void_p), rev_part.data_ptr(), n_blocks,
            dir_n + n_b, stream)
    _raise(lib, err, "split-step reverse walk")
    _weight_grad(packed, act, cot, n_rec, grads)
    with span("k2.reduce"):
        _reduce_add(rev_part, rev_part.shape[0], dir_n,
                    grads[rgb1.w_off + packed.hidden * rgb1.n:], grads[n_w:])


def _split_step(packed: PackedNeRF, origins, directions, z_vals, target, rcfg: RenderConfig,
                emit_weights: bool, group: int = RAY_GROUP, g: Optional[torch.Tensor] = None):
    """The split step on the card: per group of ``group`` rays, in ray
    order, _split_forward then _split_backward, each group's partials added
    to the grads in order.  The cotangent is the MSE's against ``target``,
    or ``g`` (N, 3) where given (``target`` None).  Returns (rgb, weights or
    None, tb, grads)."""
    _check_inputs(packed, origins, directions, z_vals, target=target, g=g)
    dev = origins.device
    n, S = z_vals.shape
    f32 = dict(device=dev, dtype=torch.float32)
    o, d, z = (x.float().contiguous() for x in (origins, directions, z_vals))
    cot = (target if g is None else g).float().contiguous()
    nc = -(-S // CHUNK)
    lay = stash_layout(packed)
    n_rec_max = min(group, n) * 2 * nc
    rgb = torch.empty(n, 3, **f32)
    tb = _scratch((n, nc), torch.float32, dev)
    w = torch.empty(n, S, **f32) if emit_weights else None
    grads = torch.zeros(packed.weights.numel() + packed.biases.numel(), **f32)
    act = _scratch((n_rec_max, lay.rec_act), torch.bfloat16, dev)
    pt = _scratch((n_rec_max * IMG_ROWS, 4), torch.float32, dev)
    with torch.cuda.device(dev):
        for r0 in range(0, n, group):
            sl = slice(r0, r0 + group)
            og, dg, zg, rg, tbg = o[sl], d[sl], z[sl], rgb[sl], tb[sl]
            _split_forward(packed, rcfg, og, dg, zg, rg, w[sl] if w is not None else None, tbg,
                           act, pt)
            _split_backward(packed, rcfg, og, dg, zg, cot[sl] if g is None else None, rg, tbg,
                            act, pt, 2.0 / (3.0 * n), grads, g=None if g is None else cot[sl])
    return rgb, w, tb, grads


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused train: no kernel for device {t.device}")
    return t.device.type


def fused_mse_loss_grads(packed: PackedNeRF, origins, directions, z_vals, target,
                         rcfg: RenderConfig):
    """(rgb (N, 3), gw, gb): the step's raw outputs, float32 grads of
    mean((rgb - target)^2) in the packed layout.  CPU tensors run the plain
    version.  CUDA tensors run the split step (per ray group: the wgmma
    forward sweep that stashes every layer input, the reverse walk that
    stashes every output cotangent, the weight GEMM over both; three
    forwards' worth of products)."""
    _check(rcfg)
    if _device_kind(origins) == "cpu":
        return fused_mse_loss_reference(packed, origins, directions, z_vals, target, rcfg)
    rgb, _, _, grads = _split_step(packed, origins, directions, z_vals, target, rcfg, False)
    LAUNCHES["fused_mse_loss"] += 1
    n_w = packed.weights.numel()
    return rgb, grads[:n_w], grads[n_w:]


def fused_mse_loss_weights_grads(packed: PackedNeRF, origins, directions, z_vals, target,
                                 rcfg: RenderConfig):
    """(rgb (N, 3), weights (N, S), gw, gb): fused_mse_loss_grads plus the
    per-sample compositing weights of the forward sweep, from the same split
    step (CUDA tensors) or the plain version (CPU tensors)."""
    _check(rcfg)
    if _device_kind(origins) == "cpu":
        return fused_mse_loss_weights_reference(packed, origins, directions, z_vals, target,
                                                rcfg)
    rgb, w, _, grads = _split_step(packed, origins, directions, z_vals, target, rcfg, True)
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
    the render kernel compiled with TB once over all rays (rgb bit-equal to
    fused_render_rays', tb to the split step's forward sweep's); CPU tensors
    run the plain version."""
    _check(rcfg)
    if _device_kind(origins) == "cpu":
        return fused_render_train_reference(packed, origins, directions, z_vals, rcfg)
    _check_inputs(packed, origins, directions, z_vals)
    dev = origins.device
    n, S = z_vals.shape
    o, d, z = (x.float().contiguous() for x in (origins, directions, z_vals))
    rgb = torch.empty(n, 3, device=dev, dtype=torch.float32)
    tb = torch.empty(n, -(-S // CHUNK), device=dev, dtype=torch.float32)
    lib = _fr._kernel_lib()
    ip, fp, _fp_keep = _fr._render_kernel_args(packed, rcfg)
    image = _fr.render_tile_image(packed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise(lib, lib.sfm_fused_render_tb(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), n, S, image.data_ptr(),
            packed.biases.data_ptr(), ctypes.cast(ip, ctypes.c_void_p), fp, rgb.data_ptr(),
            tb.data_ptr(), stream), "fused_render_train forward")
    LAUNCHES["fused_render_train"] += 1
    return rgb, tb


def fused_render_train_backward(packed: PackedNeRF, origins, directions, z_vals,
                                rcfg: RenderConfig, tb, g):
    """(gw, gb): the backward kernel's raw outputs for the cotangent ``g``
    (N, 3) of rgb, float32 grads in the packed layout.  ``tb`` is the
    forward's residual, as JAX's backward takes it.  CUDA tensors run the
    split step under ``g`` (its forward sweep recomputes tb, into scratch,
    with the stashes); CPU tensors run the plain version (which recomputes
    tb too)."""
    _check(rcfg)
    if _device_kind(origins) == "cpu":
        return fused_render_train_reference(packed, origins, directions, z_vals, rcfg, g=g)
    n, S = z_vals.shape
    if tb is None or tb.shape != (n, -(-S // CHUNK)):
        raise ValueError("fused train backward: tb must be the forward's (N, n_chunks)")
    grads = _split_step(packed, origins, directions, z_vals, None, rcfg, False, g=g)[3]
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
    transmittance entering each chunk, the backward recomputes every
    chunk's activations (the split step's forward sweep) and applies the
    caller's cotangent."""
    if packed.model is None:
        raise ValueError("fused_render_train: pack with pack_nerf_params(model, ...)")
    return _FusedRenderTrain.apply(packed, origins, directions, z_vals, rcfg,
                                   *packed.model.parameters())
