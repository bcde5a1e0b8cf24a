"""Fused NeRF training step: forward and hand-written backward in CUDA.

Counterpart of sfm_nerf_tpu/kernels/fused_train.py.  Two kernel families:

- the MSE step, one body (``_mse_step``) and one ``torch.autograd.Function``
  (``_FusedMSELoss``): mean((render(rays) - target)^2) as a scalar, and
  with ``emit_weights`` the per-sample compositing weights (N, S) of the
  forward sweep, detached (the coarse pass of hierarchical training, whose
  weights feed ``sample_pdf``).  The launches give rgb and the grads of
  every packed weight and bias (the MSE cotangent is made on the card);
  backward only scales them.  Its public entries, named as in the JAX
  package, are its four cases, points or cones by with or without the
  weights, each one call: the ``*_grads`` ones return the raw outputs, the
  others the loss under autograd;
- ``fused_render_train`` (K3): rgb (N, 3), differentiable for any loss on
  it.  Forward launches the render kernel compiled with TB
  (csrc/fused_render.cu, K1's arithmetic: its rgb is K1's) once over all
  rays: rgb and tb, the transmittance entering each 128-sample chunk.
  Backward runs the split step under the caller's cotangent g, its forward
  sweep recomputing what JAX's backward kernel recomputes from tb.

Both run the split step (``_split_step``): per group of RAY_GROUP
rays, in ray order, (1) the render kernel compiled with STASH (K1's
arithmetic: its rgb and weights are K1's and K5's), which also writes every
layer input, the per-point density and colours and tb to a stash
(``stash_layout``); (2) the reverse walk (csrc/fused_train.cu), which
makes the cotangent (the MSE's from rgb and the target, or takes the
caller's g), writes every layer's output cotangent to a second stash and
keeps the bias and direction-row grads in per-warpgroup partials (its
products read the render tile image's weights as W^T, ``walk_plan``); (3) the
weight gradient, sum over points of A^T D per layer, a wgmma GEMM over both
stashes on clusters of two blocks (csrc/grad_gemm.cu, ``gemm_jobs``; each
launch adds the stash bytes it fetches to the counter ``gemm_bytes``);
then two fixed-order reductions add the
group's partials to the grads.  Under g = (rgb - target) * 2 / (3 N) the
backward of ``fused_render_train`` is the MSE step's launches, bit for bit.
The step's launch classes are spans of utils/profiling.py: ``k2.stash``
(1), ``k2.walk`` (2), ``k2.gemm`` (3 and its partials' reduction) and
``k2.reduce`` (the reverse walk's partials' reduction).

Both autograd Functions work over the parameters of the module the
weights were packed from (``PackedNeRF.model``): the packed grads go back to
``nn.Module`` parameter grads through ``unpack_grads``, the exact transpose
of ``pack_nerf_params``, so ``loss.backward()`` fills ``.grad`` and the
optimizer is plain ``torch.optim.Adam``.  No library product and no
autograd graph computes anything on that path.

Beside them, ``fused_mse_loss_weights_reference`` (``fused_mse_loss_reference``
without the weights) and ``fused_render_train_reference``
are the plain PyTorch versions: the chunked
forward of ``fused_render_rays_reference`` and a hand-written reverse walk
with the kernel's rounding points; ``split_forward_reference``,
``split_reverse_reference`` and ``grad_gemm_reference`` are the plain
versions of the split step's three launches on the stash layout
(``split_backward_reference`` chains the last two, ``split_step_reference``
all three), each under the MSE's cotangent or a given g.  The device rule
and the launch checks are kernels/fused_render.py's (``_on_card``,
``_check_launch``).  Each call that launches counts one in ``LAUNCHES``
under its entry's name.

Types.  Master weights stay float32 in the ``nn.Module``.  The kernel takes
them packed in bf16, as the render kernel does; products are bf16 x bf16 ->
f32, cotangents are rounded to bf16 where they enter a product, sums,
biases, heads and compositing are f32, and grads come out f32.  The TPU
kernel does the same at its default compute dtype: Mosaic runs a float32
dot as one bf16 pass.

Only the 'train' compositor trains through these kernels (white background
included); the sample axis is masked in the kernel, so any n_sample runs.

Cones (the mip arch): the MSE step over cones (origins, un-normalised
directions, (radius, |d|)) and S + 1 interval edges a ray is K2 and K4's
same three launches compiled with MIP (fused_render.py's docstring), the
reverse walk's rgb cotangent scaled by the widened sigmoid's 1.002, no
ReLU mask on the linear bottleneck's cotangent, and the compositing
backward over the interval lengths.  Each cone call adds the points it
encodes (rays x intervals) to the counter ``ipe_points``.  The plain
versions take ``cones`` and the edges as ``z_vals``.
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
    CHUNK, REF_RAY_CHUNK, RGB_HIDDEN, TILE_K, PackedNeRF, _check_cones, _chunk_ext, _dir_ext,
    _dists, _heads, _kernel_args, _rgb, _softplus, n_intervals, render_plan,
)
from sfm_nerf_tpu_torch.models.nerf import RGB_PADDING
from sfm_nerf_tpu_torch.utils.profiling import count, span

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
_GEMM_CLUSTER = 2               # grad_gemm.cu: blocks a cluster
_GEMM_MAX_JOBS = 24
_GEMM_WIDTHS = (16, 64, 128, 256)   # the wgmma widths its consumers issue

LAUNCHES: Dict[str, int] = {
    "fused_mse_loss": 0, "fused_mse_loss_weights": 0, "fused_render_train": 0,
    "fused_render_train_backward": 0, "fused_mse_loss_cones": 0,
    "fused_mse_loss_cones_weights": 0}


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
                       chunk: int, keep: bool, tc_order: bool = False, cones=None):
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
    h, S = packed.hidden, n_intervals(packed, z_vals)
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
        cone = cones[r0:r0 + REF_RAY_CHUNK] if cones is not None else None
        n = o.shape[0]
        dists = _dists(packed, z, rcfg, cone)
        extd = rnd(_dir_ext(packed, d, cone))
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
            dc = dists[:, c0:c0 + chunk]
            ch = dc.shape[1]
            ext = rnd(_chunk_ext(packed, o, d, z, c0, ch, cone))
            hs = [rnd(torch.relu(lin(ext, Wf["fc1"], Bf["fc1"])))]
            for s in body:
                inp = torch.cat([hs[-1], ext], -1) if s.kind == "skip" else hs[-1]
                hs.append(rnd(torch.relu(lin(inp, Wf[s.name], Bf[s.name]))))
            feat, dens = _heads(packed, lin(hs[-1], Wf["densfeat"], Bf["densfeat"]), h)
            feat = rnd(feat)
            if tc_order:
                dens = lin(hs[-1], Wf["densfeat"][:, h:h + 1], Bf["densfeat"][h:h + 1], False)[:, 0]
            dens = _softplus(dens) if packed.density_act == "softplus" else torch.relu(dens)
            if tc_order:
                head = (dir_part[:, None, :] + Bf["rgb1"]).expand(n, ch, RGB_HIDDEN)
                pre = lin(feat, Wf["rgb1"][:h], head.reshape(n * ch, -1))
            else:
                pre = (feat @ Wf["rgb1"][:h]).reshape(n, ch, RGB_HIDDEN) + dir_part[:, None, :] \
                    + Bf["rgb1"]
            rgb_h = rnd(torch.relu(pre)).reshape(n * ch, -1)
            rgb = _rgb(packed, lin(rgb_h, Wf["rgb2"], Bf["rgb2"], False)[:, :3]).reshape(n, ch, 3)
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
    if packed.mip:
        # the widened sigmoid c = 1.002 s - 0.001: s from c, dc/dpre = 1.002 s (1 - s)
        s = (rgb + RGB_PADDING) / (1.0 + 2.0 * RGB_PADDING)
        drgb = ((w[..., None] * g[:, None, :]) * (1.0 + 2.0 * RGB_PADDING) * s * (1.0 - s))
    else:
        drgb = (w[..., None] * g[:, None, :]) * rgb * (1.0 - rgb)
    drgb = drgb.reshape(-1, 3)

    def back(name, parts, D, mask=True):
        """Layer ``name``'s grads from D; the input cotangent, masked by
        A > 0 (the input of a ReLU layer) and rounded."""
        on_layer(name, parts, D)
        gB[name] += D.sum(0)
        A = parts[0][1]
        k = A.shape[1]
        W = packed.w(specs[name]).detach().to(ft)
        return rnd((D @ W[:k].t()) * (A > 0) if mask else D @ W[:k].t())

    D = rnd(F.pad(drgb, (0, specs["rgb2"].n - 3)))
    D = back("rgb2", [(0, rgb_h)], D)
    ddir = ddir + D.reshape(n, ch, -1).sum(1)
    D = back("rgb1", [(0, feat)], D, mask=not packed.mip)
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
                    cotangent, chunk: int, tc_order: bool = False, cones=None):
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
            tc_order, cones):
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
    """The packing's StashLayout, made once per layout."""
    return _fr.by_layout("stash", packed, lambda: _build_stash_layout(packed))


def _build_stash_layout(packed: PackedNeRF) -> StashLayout:
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
                            rcfg: RenderConfig, cones=None):
    """Plain version of the split step's forward sweep (fused_render.cu
    STASH) on one ray group: (rgb (n, 3), tb (n, ceil(S / 128)), weights (n,
    S), stash), stash = {"act": (n_rec, rec_act), "pt": (n_rec * 64, 4)}
    in the StashLayout (pad rows zero).  Activations are stored in bf16 for
    a bf16 packing (they are bf16 values: exact in float64 too), the point
    records in the float type."""
    _check(rcfg)
    ft, _ = _rounding(packed, origins)
    lay = stash_layout(packed)
    n, S = z_vals.shape[0], n_intervals(packed, z_vals)
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
            packed, origins, directions, z_vals, rcfg, CHUNK, True, cones=cones):
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
                            g: Optional[torch.Tensor] = None, cones=None):
    """Plain version of the split step's reverse walk (fused_train.cu) on
    one ray group: from the forward's tb and stash and the cotangent, ``g``
    (n, 3) or else (rgb - target) * gscale, (cot (n_rec, rec_cot) with every
    layer's output cotangent, gb (bias grads, packed layout), gdir (rgb1's
    direction-row grads, (dir_dim, 128)))."""
    _check(rcfg)
    ft = stash["pt"].dtype
    lay = stash_layout(packed)
    n, S = z_vals.shape[0], n_intervals(packed, z_vals)
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
    dists_all = _dists(packed, z_vals.to(ft), rcfg, cones)
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
            _dir_ext(packed, directions[r0:r0 + m].to(ft),
                     cones[r0:r0 + m] if cones is not None else None))
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
                             g: Optional[torch.Tensor] = None, cones=None):
    """The plain versions of the reverse walk and the weight GEMM chained on
    one ray group's forward (rgb, tb, stash) under the cotangent of
    split_reverse_reference: (gw, gb), the group's flat grads in the packed
    layout, in the float type of ``stash["pt"]``."""
    ft = stash["pt"].dtype
    cot, gb, gdir = split_reverse_reference(packed, directions, z_vals, rcfg, rgb, target, tb,
                                            stash, gscale, g, cones)
    gw = grad_gemm_reference(packed, stash["act"], cot, ft)
    spec = {s.name: s for s in packed.layers}["rgb1"]
    dir0 = spec.w_off + packed.hidden * spec.n
    gw[dir0:dir0 + gdir.numel()] = gdir.reshape(-1)
    return gw, gb


def split_step_reference(packed: PackedNeRF, origins, directions, z_vals, target,
                         rcfg: RenderConfig, group: int = None,
                         g: Optional[torch.Tensor] = None, cones=None):
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
        cone = cones[sl] if cones is not None else None
        rgb, tb, w, stash = split_forward_reference(
            packed, origins[sl], directions[sl], z_vals[sl], rcfg, cone)
        gw_g, gb_g = split_backward_reference(
            packed, directions[sl], z_vals[sl], rcfg, rgb,
            target[sl] if g is None else None, tb, stash, 2.0 / (3.0 * n),
            g[sl] if g is not None else None, cone)
        gw, gb = gw + gw_g, gb + gb_g
        rgb_p.append(rgb)
        w_p.append(w)
    return torch.cat(rgb_p), torch.cat(w_p), gw, gb


def fused_mse_loss_reference(packed: PackedNeRF, origins, directions, z_vals, target,
                             rcfg: RenderConfig, chunk: int = CHUNK,
                             tc_order: bool = False, cones=None):
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
        packed, origins, directions, z_vals, target, rcfg, chunk, tc_order, cones)
    return rgb, gw, gb


def fused_mse_loss_weights_reference(packed: PackedNeRF, origins, directions, z_vals, target,
                                     rcfg: RenderConfig, chunk: int = CHUNK,
                                     tc_order: bool = False, cones=None):
    """Plain PyTorch version of the step kernel with its weights output:
    (rgb (N, 3), weights (N, S), gw, gb), the weights those the forward
    sweep composited with, at the caller's sample count."""
    _check(rcfg)
    scale = 2.0 / (3.0 * origins.shape[0])
    rgb, _, weights, gw, gb = _reference_pass(
        packed, origins, directions, z_vals, rcfg,
        lambda rgb, r0: (rgb - target[r0:r0 + rgb.shape[0]].to(rgb.dtype)) * scale, chunk,
        tc_order, cones)
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
        [ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
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
    lib.sfm_grad_gemm_clusters.restype = ctypes.c_int
    lib.sfm_grad_gemm_clusters.argtypes = [ctypes.c_void_p]
    lib.sfm_cuda_error_string.restype = ctypes.c_char_p
    lib.sfm_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.sfm_cuda_error_string(err).decode())


def _ptr(x) -> Optional[int]:
    return x.data_ptr() if x is not None else None


def _check_inputs(packed: PackedNeRF, origins, directions, z_vals, cones=None,
                  **extra) -> None:
    """The launch checks of fused_render._check_launch, ``extra`` (the
    target or the cotangent g) among the tensors, then what training alone
    needs: ``extra`` as (N, 3) and no pad elements between the packed
    layers."""
    _fr._check_launch(packed, origins, directions, z_vals, cones, "fused train", **extra)
    n = z_vals.shape[0]
    for name, t in extra.items():
        if t is not None and t.shape != (n, 3):
            raise ValueError(f"fused train: {name} {tuple(t.shape)}, expected {(n, 3)}")
    if sum(s.k_rows * s.n for s in packed.layers) != packed.weights.numel():
        raise ValueError("fused train kernel: the packed weights hold pad elements "
                         "between layers, which the grad reduction would read")


@dataclasses.dataclass(frozen=True)
class GemmUnit:
    """One block's share of a weight-GEMM job (grad_gemm.cu Unit): up to
    two 64-row tiles, (first weight row, real rows, activation block), of
    the layer whose packed weight starts at ``w_off`` with ``n`` columns.
    Its consumers issue wgmma ``width`` columns wide over columns [0,
    ``ncols``) from its cotangent blocks, and n16 over columns [256, 256 +
    ``extra``) from cotangent block 4.  No tiles: the block idles."""
    w_off: int = 0
    n: int = 0
    ncols: int = 0
    width: int = 16
    extra: int = 0
    d_block: int = 0
    d_blocks: int = 0
    tiles: Tuple[Tuple[int, int, int], ...] = ()

    def ints(self) -> List[int]:
        pad = list(self.tiles) + [self.tiles[0] if self.tiles else (0, 1, 0)] * (
            2 - len(self.tiles))
        return [self.w_off, self.n, self.ncols, self.width, self.extra, self.d_block,
                self.d_blocks, len(self.tiles)] + [x for t in pad for x in t]


@dataclasses.dataclass(frozen=True)
class GemmJob:
    """One job of the weight GEMM: a unit for each block of a cluster over
    the same records.  ``multicast``: both units read the same cotangent
    blocks, which the two producers fetch once between them (each
    ``issued`` of them) into both blocks."""
    multicast: bool
    units: Tuple[GemmUnit, GemmUnit]

    def issued(self, c: int) -> int:
        """Cotangent blocks block ``c``'s producer fetches a record."""
        d = self.units[c].d_blocks
        return ((d + 1) // 2 if c == 0 else d // 2) if self.multicast else d

    @property
    def blocks(self) -> int:
        """Stash blocks the job fetches a record, a multicast one once: its
        cost in the schedule and its share of ``gemm_bytes``."""
        return sum(len(u.tiles) + self.issued(c) for c, u in enumerate(self.units))

    def ints(self) -> List[int]:
        return [int(self.multicast), self.blocks] + [x for u in self.units for x in u.ints()]


def gemm_jobs(packed: PackedNeRF) -> Tuple[GemmJob, ...]:
    """grad_gemm.cu's jobs, from the packing's layer shapes.  A layer's
    64-row tiles go four at a time to a multicast job (two a block, the
    cotangents shared); two or three left over make one more (a block
    takes the odd one); a single tile left over (skip's encoding rows, a
    64-row layer) pairs with the next such tile of another layer in a job
    without multicast, each block on its own cotangents.  Columns: up to
    256 at the smallest wgmma width that holds them, and a layer of
    257-272 (the density/feature head) adds its last 16 by n16 in the same
    job.  Together the jobs cover every packed weight element but rgb1's
    direction rows once."""
    lay = stash_layout(packed)
    jobs, singles = [], []
    for li, s in enumerate(packed.layers):
        tiles = [(row0 + r, min(TILE_K, rows - r), block + r // TILE_K)
                 for row0, rows, block in _gemm_inputs(packed, lay, s, li)
                 for r in range(0, rows, TILE_K)]
        ncols = min(s.n, 256)
        extra = s.n - ncols
        if extra > 16:
            raise ValueError(f"weight GEMM: layer {s.name} has {s.n} columns > 272")
        width = next(w for w in _GEMM_WIDTHS if w >= ncols)

        def unit(part):
            return GemmUnit(s.w_off, s.n, ncols, width, extra, lay.cot_off[li],
                            -(-s.n // TILE_K), tuple(part))
        for i in range(0, len(tiles), 2 * _GEMM_CLUSTER):
            quad = tiles[i:i + 2 * _GEMM_CLUSTER]
            if len(quad) == 1:
                singles.append(unit(quad))
            else:
                half = -(-len(quad) // 2) if len(quad) > 2 else 1
                jobs.append(GemmJob(True, (unit(quad[:half]), unit(quad[half:]))))
    for i in range(0, len(singles), _GEMM_CLUSTER):
        pair = singles[i:i + _GEMM_CLUSTER]
        jobs.append(GemmJob(False, tuple(pair + [GemmUnit()] * (_GEMM_CLUSTER - len(pair)))))
    if len(jobs) > _GEMM_MAX_JOBS:
        raise ValueError(f"weight GEMM: {len(jobs)} jobs > {_GEMM_MAX_JOBS}")
    return tuple(jobs)


def gemm_bytes_per_record(packed: PackedNeRF) -> int:
    """Bytes the weight GEMM fetches from the stashes a record, a multicast
    block once (what the ``gemm_bytes`` counter adds a record)."""
    return _fr.by_layout("gemm_bytes", packed, lambda: sum(
        j.blocks for j in gemm_jobs(packed)) * IMG_BLOCK * 2)


def gemm_segments(jobs, n_rec: int, n_clusters: int) -> List[Tuple[int, int, int, int, int]]:
    """grad_gemm.cu's schedule, as its blocks work it out: (cluster, job,
    first record, end record, partial row) of every non-empty share.  The
    jobs' records in order make a stream of ``blocks`` a record; cluster q
    takes the records that start in [q T / Q, (q + 1) T / Q) of its T, and
    writes its share of job j to row q - (the cluster that holds the job's
    first record)."""
    costs = [j.blocks for j in jobs]
    total = sum(costs) * n_rec

    def first(x, c):
        return 0 if x <= 0 else min(n_rec, -(-x // c))
    out = []
    for q in range(n_clusters):
        b0, b1 = total * q // n_clusters, total * (q + 1) // n_clusters
        p = 0
        for j, c in enumerate(costs):
            r0, r1 = first(b0 - p, c), first(b1 - p, c)
            if r1 > r0:
                out.append((q, j, r0, r1, q - ((p + 1) * n_clusters - 1) // total))
            p += c * n_rec
    return out


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


def _walk_ints(packed: PackedNeRF) -> ctypes.Array:
    """The reverse walk's layout argument (fused_train.cu parse_walk):
    StashLayout.ints(), the stage count, then (layer, k0, kc, pieces,
    4 piece offsets) per stage; made once per layout."""
    def build():
        ints = stash_layout(packed).ints()
        stages = walk_plan(packed)
        ints.append(len(stages))
        for s in stages:
            ints += [s.layer, s.k0, s.kc, len(s.offs), *s.offs, *[0] * (4 - len(s.offs))]
        return (ctypes.c_int * len(ints))(*ints)
    return _fr.by_layout("walk", packed, build)


_GEMM_CLUSTERS: Dict[int, int] = {}      # clusters a wave, by device index


def _gemm_clusters(dev) -> int:
    """Clusters of grad_gemm.cu that fit on the card at once (one wave)."""
    index = torch.device(dev).index or 0
    if index not in _GEMM_CLUSTERS:
        lib = _gemm_lib()
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise(lib, lib.sfm_grad_gemm_clusters(ctypes.byref(n)), "weight-GEMM occupancy")
        if n.value < 1:
            raise RuntimeError("weight GEMM: no cluster of two blocks fits on the card")
        _GEMM_CLUSTERS[index] = n.value
    return _GEMM_CLUSTERS[index]


def _gemm_plan(packed: PackedNeRF, n_rec: int, n_clusters: int):
    """(jobs as an int32 array, partial rows), made once per layout,
    record count and cluster count."""
    def build():
        jobs = gemm_jobs(packed)
        rows = 1 + max(s[4] for s in gemm_segments(jobs, n_rec, n_clusters))
        return np.asarray([j.ints() for j in jobs], np.int32), rows
    return _fr.by_layout("gemm", packed, build, n_rec, n_clusters)


def _gemm_partials(packed: PackedNeRF, n_rec: int, dev) -> torch.Tensor:
    """Zeroed float32 partials of the weight GEMM over ``n_rec`` records:
    one row of the packed weights' length per share of a job
    (gemm_segments); elements no share writes, rgb1's direction rows
    among them, stay zero."""
    rows = _gemm_plan(packed, n_rec, _gemm_clusters(dev))[1]
    return torch.zeros(rows, packed.weights.numel(), device=dev, dtype=torch.float32)


def _gemm_launch(packed: PackedNeRF, act, cot, n_rec: int, partials) -> None:
    """grad_gemm.cu over ``n_rec`` records into ``partials``
    (_gemm_partials), one wave of clusters; adds the stash bytes it
    fetches to the counter ``gemm_bytes``."""
    n_clusters = _gemm_clusters(act.device)
    jobs = _gemm_plan(packed, n_rec, n_clusters)[0]
    lay = stash_layout(packed)
    lib = _gemm_lib()
    with torch.cuda.device(act.device):
        stream = torch.cuda.current_stream(act.device).cuda_stream
        err = lib.sfm_grad_gemm(act.data_ptr(), cot.data_ptr(),
                                jobs.ctypes.data_as(ctypes.c_void_p), jobs.shape[0],
                                n_clusters, n_rec, lay.rec_act, lay.rec_cot,
                                packed.weights.numel(), partials.data_ptr(), stream)
    _raise(lib, err, "weight-gradient GEMM")
    count("gemm_bytes", n_rec * gemm_bytes_per_record(packed))


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


def _split_forward(packed: PackedNeRF, rcfg: RenderConfig, o, d, z, rgb, w, tb, act, pt,
                   c=None) -> None:
    """The forward sweep of one ray group (fused_render.cu STASH, K1's
    arithmetic): writes rgb, the weights ``w`` (or none), tb and the stash
    records ``act`` and ``pt``.  ``c``: the cones of a mip packing."""
    n, S = z.shape[0], n_intervals(packed, z)
    lib = _fr._kernel_lib()
    ip, fp, _fp_keep = _fr._render_kernel_args(packed, rcfg)
    image = _fr.render_tile_image(packed)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    with span("k2.stash"):
        err = lib.sfm_fused_render_stash(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), _ptr(c), n, S, image.data_ptr(),
            packed.biases.data_ptr(), ctypes.cast(ip, ctypes.c_void_p), fp, rgb.data_ptr(),
            _ptr(w), int(w is not None), act.data_ptr(), pt.data_ptr(), tb.data_ptr(), stream)
    _raise(lib, err, "split-step forward sweep")


def _split_backward(packed: PackedNeRF, rcfg: RenderConfig, o, d, z, t, rgb, tb, act, pt,
                    gscale: float, grads, g=None, c=None) -> None:
    """The reverse walk (fused_train.cu) and the weight GEMM (grad_gemm.cu)
    of one ray group on its forward's tb and stash, under the cotangent
    ``g`` (n, 3) or, without it, (rgb - t) * gscale, and the two
    fixed-order reductions that add the group's partial grads to ``grads``
    (weights then biases, packed layout)."""
    dev = o.device
    n, S = z.shape[0], n_intervals(packed, z)
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
            d.data_ptr(), z.data_ptr(), _ptr(c), rgb.data_ptr() if mse else None,
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
                emit_weights: bool, group: int = RAY_GROUP, g: Optional[torch.Tensor] = None,
                cones=None):
    """The split step on the card: per group of ``group`` rays, in ray
    order, _split_forward then _split_backward, each group's partials added
    to the grads in order.  The cotangent is the MSE's against ``target``,
    or ``g`` (N, 3) where given (``target`` None).  ``cones``: a mip
    packing's, with the edges as ``z_vals``.  Returns (rgb, weights or
    None, tb, grads)."""
    _check_inputs(packed, origins, directions, z_vals, cones, target=target, g=g)
    dev = origins.device
    n, S = z_vals.shape[0], n_intervals(packed, z_vals)
    f32 = dict(device=dev, dtype=torch.float32)
    o, d, z = (x.float().contiguous() for x in (origins, directions, z_vals))
    c = cones.float().contiguous() if cones is not None else None
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
            cg = c[sl] if c is not None else None
            _split_forward(packed, rcfg, og, dg, zg, rg, w[sl] if w is not None else None, tbg,
                           act, pt, cg)
            _split_backward(packed, rcfg, og, dg, zg, cot[sl] if g is None else None, rg, tbg,
                            act, pt, 2.0 / (3.0 * n), grads, g=None if g is None else cot[sl],
                            c=cg)
    return rgb, w, tb, grads


def _mse_step(packed: PackedNeRF, origins, directions, z_vals, target, rcfg: RenderConfig,
              emit_weights: bool, cones=None):
    """The MSE step entries' one body: (rgb (N, 3), weights (N, S) or None,
    gw, gb), float32 grads of mean((rgb - target)^2) in the packed layout.
    CPU tensors run the plain version.  CUDA tensors run the split step
    (per ray group: the wgmma forward sweep that stashes every layer input,
    the reverse walk that stashes every output cotangent, the weight GEMM
    over both; three forwards' worth of products), one call counted under
    the entry's name.  ``cones``: a mip packing's, with the edges as
    ``z_vals``; a cone call adds N S to the counter ``ipe_points``."""
    _check(rcfg)
    _check_cones(packed, cones, z_vals)
    if cones is not None:
        count("ipe_points", z_vals.shape[0] * (z_vals.shape[1] - 1))
    if not _fr._on_card(origins, "fused train"):
        rgb, w, gw, gb = fused_mse_loss_weights_reference(
            packed, origins, directions, z_vals, target, rcfg, cones=cones)
        return rgb, (w if emit_weights else None), gw, gb
    rgb, w, _, grads = _split_step(packed, origins, directions, z_vals, target, rcfg,
                                   emit_weights, cones=cones)
    LAUNCHES["fused_mse_loss" + "_cones" * (cones is not None) + "_weights" * emit_weights] += 1
    n_w = packed.weights.numel()
    return rgb, w, grads[:n_w], grads[n_w:]


def fused_mse_loss_grads(packed: PackedNeRF, origins, directions, z_vals, target,
                         rcfg: RenderConfig):
    """(rgb (N, 3), gw, gb): the step's raw outputs (``_mse_step``)."""
    rgb, _, gw, gb = _mse_step(packed, origins, directions, z_vals, target, rcfg, False)
    return rgb, gw, gb


def fused_mse_loss_weights_grads(packed: PackedNeRF, origins, directions, z_vals, target,
                                 rcfg: RenderConfig):
    """(rgb (N, 3), weights (N, S), gw, gb): fused_mse_loss_grads plus the
    per-sample compositing weights of the forward sweep, from the same
    step."""
    return _mse_step(packed, origins, directions, z_vals, target, rcfg, True)


def fused_mse_loss_cones_grads(packed: PackedNeRF, origins, directions, cones, edges, target,
                               rcfg: RenderConfig, emit_weights: bool = False):
    """(rgb (N, 3), weights (N, S) or None, gw, gb): the cone step's raw
    outputs over the intervals between ``edges`` (N, S + 1)."""
    return _mse_step(packed, origins, directions, edges, target, rcfg, emit_weights, cones)


def _params(packed: PackedNeRF, entry: str):
    """The parameters of the module ``packed`` was packed from, which the
    differentiable entries' grads go to."""
    if packed.model is None:
        raise ValueError(f"{entry}: pack with pack_nerf_params(model, ...)")
    return packed.model.parameters()


def _param_grads(packed: PackedNeRF, params, gw, gb) -> List[torch.Tensor]:
    named = unpack_grads(packed, gw, gb)
    by_param = {id(p): named[name] for name, p in packed.model.named_parameters()}
    return [by_param[id(p)].to(p.dtype) for p in params]


class _FusedMSELoss(torch.autograd.Function):
    """The MSE step under autograd: forward runs ``_mse_step``, whose grads
    are already exact, and returns the loss, or (loss, weights) with the
    weights non-differentiable; backward scales the stored grads by the
    loss's cotangent."""

    @staticmethod
    def forward(ctx, packed, origins, directions, z_vals, target, rcfg, emit_weights, cones,
                *params):
        rgb, w, gw, gb = _mse_step(packed, origins, directions, z_vals, target, rcfg,
                                   emit_weights, cones)
        ctx.grads = _param_grads(packed, params, gw, gb)
        loss = torch.mean((rgb - target.to(rgb.dtype)) ** 2)
        if not emit_weights:
            return loss
        ctx.mark_non_differentiable(w)
        return loss, w

    @staticmethod
    def backward(ctx, gbar, *_gw):
        return (None,) * 8 + tuple(gbar * g for g in ctx.grads)


def fused_mse_loss(packed: PackedNeRF, origins, directions, z_vals, target,
                   rcfg: RenderConfig) -> torch.Tensor:
    """mean((render(rays) - target)^2), differentiable with respect to the
    parameters of ``packed.model``.  The forward already gives the exact
    parameter grads, so backward is a scalar rescale: value and grads cost
    one kernel launch."""
    return _FusedMSELoss.apply(packed, origins, directions, z_vals, target, rcfg, False, None,
                               *_params(packed, "fused_mse_loss"))


def fused_mse_loss_weights(packed: PackedNeRF, origins, directions, z_vals, target,
                           rcfg: RenderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, weights (N, S)): fused_mse_loss and the per-sample compositing
    weights, the coarse pass of hierarchical training.  The weights carry no
    gradient (sample_pdf reads the histogram without differentiating through
    it), so backward is fused_mse_loss's scalar rescale."""
    return _FusedMSELoss.apply(packed, origins, directions, z_vals, target, rcfg, True, None,
                               *_params(packed, "fused_mse_loss_weights"))


def fused_mse_loss_cones(packed: PackedNeRF, origins, directions, cones, edges, target,
                         rcfg: RenderConfig) -> torch.Tensor:
    """fused_mse_loss over cones (origins, un-normalised directions, cones
    (N, 2): radius and |d|) and the intervals between ``edges`` (N, S + 1):
    the fine level of a mip-NeRF step."""
    return _FusedMSELoss.apply(packed, origins, directions, edges, target, rcfg, False, cones,
                               *_params(packed, "fused_mse_loss_cones"))


def fused_mse_loss_cones_weights(packed: PackedNeRF, origins, directions, cones, edges, target,
                                 rcfg: RenderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, weights (N, S)): fused_mse_loss_cones and each interval's
    compositing weight, detached: the coarse level of a mip-NeRF step, whose
    weights feed the resampler."""
    return _FusedMSELoss.apply(packed, origins, directions, edges, target, rcfg, True, cones,
                               *_params(packed, "fused_mse_loss_cones_weights"))


def fused_render_train_forward(packed: PackedNeRF, origins, directions, z_vals,
                               rcfg: RenderConfig):
    """(rgb (N, 3), tb (N, n_chunks)): the forward kernel's raw outputs, tb
    the transmittance entering each 128-sample chunk.  CUDA tensors launch
    the render kernel compiled with TB once over all rays (rgb bit-equal to
    fused_render_rays', tb to the split step's forward sweep's); CPU tensors
    run the plain version."""
    _check(rcfg)
    _check_cones(packed, None, z_vals)
    if not _fr._on_card(origins, "fused train"):
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
    if not _fr._on_card(origins, "fused train"):
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
    return _FusedRenderTrain.apply(packed, origins, directions, z_vals, rcfg,
                                   *_params(packed, "fused_render_train"))
