"""Fused NeRF render: points -> encoding -> MLP -> alpha compositing.

Counterpart of sfm_nerf_tpu/kernels/fused_render.py.  One CUDA source
(csrc/fused_render.cu) and one body, ``_render``: rgb (N, 3) of rays (N, 3)
x depths (N, S) and, with ``emit_weights`` (the kernel's template flag
EMIT_WEIGHTS), the per-sample compositing weights (N, S).  The public
entries are its four cases, points or cones by with or without the
weights, each one call of it under the JAX package's names.

The body's plain version is ``fused_render_rays_reference``.  Every kernel
entry of this module and of kernels/fused_train.py keeps one device rule
(``_on_card``: CPU tensors run the plain version, CUDA tensors launch the
kernel, any other device raises) and one set of input checks before a
launch (``_check_launch``).  Each call that launches counts one in
``LAUNCHES`` under its entry's name.  kernels/fused_train.py launches the
same source compiled with TB (the forward of ``fused_render_train``) and
with STASH (the split step's forward sweep).

The kernel reads its weights as a tile image: each 64-row tile of each
product laid out once, here, as the swizzled shared-memory image wgmma
reads (``render_plan``, ``render_tile_image``; cached on the PackedNeRF),
so the device moves a tile with one bulk copy.

The kernel masks the ragged end of the sample axis itself (samples past a
ray's last get a zero distance, an exact no-op), so the sample axis is not
padded and any n_sample runs.

Cones (the mip arch, ``PackedNeRF.mip``): the body takes each ray's
un-normalised direction, its cone (radius, |d|) and S + 1 interval edges
in place of the depths, and the kernel is compiled with MIP: the producer
encodes each interval's conical frustum as a Gaussian (nerf_device.cuh
``frustum_gaussian``) into its integrated positional encoding, the view
direction takes mip-NeRF's encoding, the bottleneck is linear (pass kind
'lin'), the rgb head's sigmoid is widened to ``1.002 s - 0.001``, and the
compositing runs over the interval lengths ``(t1 - t0) |d|``.  A mip
packing takes cones and any other none (``_check_cones``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfm_nerf_tpu_torch.config import NeRFModelConfig, RenderConfig
from sfm_nerf_tpu_torch.models.nerf import RGB_PADDING, NeRF, layer_shapes, n_after_skip
from sfm_nerf_tpu_torch.ops.encoding import (
    frustum_gaussian, integrated_pos_enc, octaves, positional_encoding, trig_constants,
    view_encoding,
)
from sfm_nerf_tpu_torch.ops.render import sample_dists
from sfm_nerf_tpu_torch.utils.profiling import count, span

CHUNK = 128          # sample points per chunk of the plain version and the training kernels
REF_RAY_CHUNK = 1024  # rays per step of the plain version (bounds its memory)
MAX_FREQ = 16        # the kernel's frequency table length
RGB_HIDDEN = 128     # rgb1 width, fixed by both archs
_KINDS = {"fc1": 0, "plain": 1, "skip": 2, "densfeat": 3, "rgb1": 4, "rgb2": 5}
HEAD_INTS = 9        # the kernels' iparams before the layer table (nerf_device.cuh)
TILE_K = 64          # weight rows per tile: one 128-byte swizzle atom of bf16
SWIZZLE = 8          # 16-byte chunks per 128-byte row, permuted by the row
_PASS_KINDS = {"relu": 0, "dens": 1, "rgb1": 2, "rgb2": 3, "lin": 4}   # sm90_mlp.cuh PassKind

LAUNCHES: Dict[str, int] = {"fused_render_rays": 0, "fused_render_rays_weights": 0,
                            "fused_render_cones": 0, "fused_render_cones_weights": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _arch_layers(mcfg: NeRFModelConfig):
    """(body, density_act): the hidden-layer program between fc1 and the
    density/feature head, as in the JAX package."""
    if mcfg.arch in ("active", "mip"):
        body = (
            ("plain", "fc_0"), ("plain", "fc_1"), ("plain", "fc_2"),
            ("plain", "fc_3"), ("skip", "skip"),
        ) + tuple(("plain", f"fc2_{i}") for i in range(n_after_skip(mcfg)))
        return body, "softplus"
    if mcfg.arch == "legacy":
        body = tuple(("plain", f"block1_{i}") for i in range(mcfg.n_block1_layers))
        if mcfg.has_skip:
            body += (("skip", "skip"),)
        body += (("plain", "block2_0"), ("plain", "block2_1"))
        return body, "relu"
    raise ValueError(f"fused render: unknown arch {mcfg.arch!r}")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    kind: str
    w_off: int     # element offset of the (k_rows, n) row-major weight
    b_off: int
    k: int         # rows the tensor-core product reads
    n: int         # columns (the weight's row stride)
    k_rows: int    # rows stored (rgb1 also stores its direction rows)


@dataclasses.dataclass(frozen=True)
class PackedNeRF:
    """Weights of one NeRF in the kernel's layout: one flat weight buffer
    (the packing dtype) and one flat float32 bias buffer, each layer a
    row-major (fan_in, fan_out) block at a 64-element-aligned offset.

    - fc1: rows padded from pos_dim to ``pos_pad`` (a multiple of 16) with
      zeros, matching the encoding's zero pad columns;
    - skip: [hidden rows; pos_dim rows; zero rows to pos_pad];
    - densfeat: the density and feature heads merged (active arch) or the
      legacy block2_2, as (hidden, hidden + 16): feature columns first,
      then the density column, then zeros;
    - rgb1: (hidden + dir_dim, 128), feature rows then direction rows;
    - rgb2: (128, 16), three real columns.

    ``mip``: the mip arch's network, read by the cone entry points (fc1 over
    the 6 n_pos_freq columns of the integrated encoding, a linear
    bottleneck, the widened sigmoid).
    """

    weights: torch.Tensor
    biases: torch.Tensor
    layers: Tuple[LayerSpec, ...]
    hidden: int
    pos_dim: int
    pos_pad: int
    dir_dim: int
    n_pos_freq: int
    n_dir_freq: int
    density_act: str
    mip: bool = False
    # the module the weights were packed from: the training wrappers route
    # the packed grads back to its parameters
    model: Optional[NeRF] = None
    # the render kernel's tile image, built on first use (render_tile_image)
    tile_cache: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def w(self, spec: LayerSpec) -> torch.Tensor:
        return self.weights[spec.w_off:spec.w_off + spec.k_rows * spec.n].view(
            spec.k_rows, spec.n)

    def b(self, spec: LayerSpec) -> torch.Tensor:
        return self.biases[spec.b_off:spec.b_off + spec.n]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_nerf_params(model: NeRF, mcfg: NeRFModelConfig,
                     dtype=torch.bfloat16, differentiable: bool = False) -> PackedNeRF:
    """Pack ``model`` into the kernel's layout (see PackedNeRF), on the
    model's device, weights in ``dtype`` and biases in float32.  The
    packing is detached from the parameters unless ``differentiable`` (the
    tests hold kernels/fused_train.py's hand-written unpacking of grads
    against autograd through it)."""
    body, density_act = _arch_layers(mcfg)
    h = mcfg.hidden
    if h % 16 or mcfg.n_pos_freq > MAX_FREQ or mcfg.n_dir_freq > MAX_FREQ:
        raise ValueError(f"fused render: unsupported model config {mcfg}")
    pos_pad = _round_up(mcfg.pos_dim, 16)
    det = (lambda t: t) if differentiable else torch.Tensor.detach
    L = {name: (det(layer.weight).float().t(), det(layer.bias).float())
         for name, layer in model.layers.items()}
    dev = next(model.parameters()).device

    def rows(w, n_rows):   # zero-pad rows to n_rows
        return F.pad(w, (0, 0, 0, n_rows - w.shape[0]))

    blocks = [("fc1", "fc1", rows(L["fc1"][0], pos_pad), L["fc1"][1], pos_pad)]
    for kind, name in body:
        w, b = L[name]
        if kind == "skip":
            w = torch.cat([w[:h], rows(w[h:], pos_pad)])
        blocks.append((name, kind, w, b, w.shape[0]))
    if mcfg.arch in ("active", "mip"):
        feat_w, feat_b = L["feature"]
        dens_w, dens_b = L["density"]
    else:
        w, b = L["block2_2"]
        feat_w, feat_b, dens_w, dens_b = w[:, 1:], b[1:], w[:, :1], b[:1]
    zeros_w = torch.zeros(h, 15, device=dev)
    blocks.append(("densfeat", "densfeat",
                   torch.cat([feat_w, dens_w, zeros_w], 1),
                   torch.cat([feat_b, dens_b, torch.zeros(15, device=dev)]), h))
    blocks.append(("rgb1", "rgb1", L["rgb1"][0], L["rgb1"][1], h))
    w, b = L["rgb2"]
    blocks.append(("rgb2", "rgb2", F.pad(w, (0, 13)), F.pad(b, (0, 13)), w.shape[0]))

    specs, w_parts, b_parts = [], [], []
    w_off = b_off = 0
    for name, kind, w, b, k in blocks:
        specs.append(LayerSpec(name, kind, w_off, b_off, k, w.shape[1], w.shape[0]))
        size = _round_up(w.numel(), 64)
        w_parts.append(F.pad(w.reshape(-1), (0, size - w.numel())))
        b_parts.append(F.pad(b, (0, _round_up(b.numel(), 64) - b.numel())))
        w_off += size
        b_off += b_parts[-1].numel()
    return PackedNeRF(
        weights=torch.cat(w_parts).to(dtype).contiguous(),
        biases=torch.cat(b_parts).contiguous(),
        layers=tuple(specs), hidden=h, pos_dim=mcfg.pos_dim, pos_pad=pos_pad,
        dir_dim=mcfg.dir_dim,
        n_pos_freq=mcfg.n_pos_freq if mcfg.pos_encoding else 0,
        n_dir_freq=mcfg.n_dir_freq if mcfg.pos_encoding else 0,
        density_act=density_act, mip=mcfg.arch == "mip", model=model,
    )


@dataclasses.dataclass(frozen=True)
class WeightTile:
    """One ring slot's worth of a product's weight: rows [row0, row0 + rows)
    x columns [col0, col0 + cols) of the packed layer ``layer``, stored as
    ``cols`` rows of TILE_K k-values (128 bytes, zero past ``rows``) with
    the 128-byte swizzle, at element ``off`` of the tile image.  ``src`` is
    the buffer the rows multiply ('act' or 'enc'), ``kb`` its 64-column
    block."""
    layer: str
    row0: int
    rows: int
    col0: int
    cols: int
    src: str
    kb: int
    off: int


@dataclasses.dataclass(frozen=True)
class RenderPass:
    """One product of the kernel's layer chain and what its epilogue does
    ('relu' into the activations, 'dens', 'rgb1', 'rgb2')."""
    kind: str
    layer: str
    n: int
    b_off: int
    tiles: Tuple[WeightTile, ...]


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    passes: Tuple[RenderPass, ...]
    dir_off: int     # rgb1's direction rows (dir_dim, 128), row-major, after the tiles
    numel: int       # elements of the image
    act_kb: int      # 64-column blocks of an activation buffer
    enc_kb: int      # 64-column blocks of an encoding buffer
    stage_bytes: int

    @property
    def tiles(self) -> Tuple[WeightTile, ...]:
        return tuple(t for p in self.passes for t in p.tiles)


def swizzle128(n: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Element index, inside a tile, of k-value ``k`` of tile row ``n``: the
    16-byte chunk k // 8 of row n sits at chunk (k // 8) ^ (n % 8)."""
    return n * TILE_K + (((k // 8) ^ (n % SWIZZLE)) * 8) + k % 8


_BY_LAYOUT: Dict[tuple, object] = {}


def by_layout(what: str, packed: PackedNeRF, build, *extra):
    """``build()``, made once per packing layout (its layer table, widths,
    frequencies and arch) and ``extra``: a training step packs its weights
    anew each time, and re-deriving its plans and kernel arguments per
    launch would cost the host more than a device step at two levels."""
    if "layout" not in packed.tile_cache:
        packed.tile_cache["layout"] = (
            packed.layers, packed.hidden, packed.pos_dim, packed.pos_pad, packed.dir_dim,
            packed.n_pos_freq, packed.n_dir_freq, packed.density_act, packed.mip)
    key = (what, packed.tile_cache["layout"]) + extra
    if key not in _BY_LAYOUT:
        _BY_LAYOUT[key] = build()
    return _BY_LAYOUT[key]


def render_plan(packed: PackedNeRF) -> RenderPlan:
    """The render kernel's products in order, each as its weight tiles
    (made once per layout, ``by_layout``).
    The density/feature head is two products (the 16-wide density columns
    first, then the features, which overwrite their own input); the skip
    layer's rows split into the activation part and the encoding part.  The
    mip arch's features are linear ('lin')."""
    return by_layout("plan", packed, lambda: _render_plan(packed))


def _render_plan(packed: PackedNeRF) -> RenderPlan:
    h, pad = packed.hidden, packed.pos_pad
    passes, off = [], 0

    def product(kind, spec, col0, cols, b_off, segments):
        nonlocal off
        tiles = []
        for row0, length, src in segments:
            for r in range(0, length, TILE_K):
                rows = min(TILE_K, length - r)
                tiles.append(WeightTile(spec.name, row0 + r, rows, col0, cols, src,
                                        r // TILE_K, off))
                off += cols * TILE_K
        n_act = sum(t.src == "act" for t in tiles)
        if any(t.src == "act" for t in tiles[n_act:]):
            raise ValueError("render plan: activation tiles must come first")
        passes.append(RenderPass(kind, spec.name, cols, b_off, tuple(tiles)))

    for spec in packed.layers:
        if spec.kind == "fc1":
            product("relu", spec, 0, h, spec.b_off, [(0, pad, "enc")])
        elif spec.kind == "skip":
            product("relu", spec, 0, h, spec.b_off, [(0, h, "act"), (h, pad, "enc")])
        elif spec.kind == "densfeat":
            product("dens", spec, h, 16, spec.b_off + h, [(0, h, "act")])
            product("lin" if packed.mip else "relu", spec, 0, h, spec.b_off, [(0, h, "act")])
        elif spec.kind == "rgb1":
            product("rgb1", spec, 0, RGB_HIDDEN, spec.b_off, [(0, h, "act")])
        elif spec.kind == "rgb2":
            product("rgb2", spec, 0, 16, spec.b_off, [(0, RGB_HIDDEN, "act")])
        else:
            product("relu", spec, 0, h, spec.b_off, [(0, h, "act")])
    max_bytes = max(t.cols * 128 for p in passes for t in p.tiles)
    return RenderPlan(tuple(passes), dir_off=off, numel=off + packed.dir_dim * RGB_HIDDEN,
                      act_kb=-(-max(h, RGB_HIDDEN) // TILE_K), enc_kb=-(-pad // TILE_K),
                      stage_bytes=_round_up(max_bytes, 1024))


def _image_index(packed: PackedNeRF, plan: RenderPlan) -> np.ndarray:
    """For each element of the tile image, the index of the packed weight
    it copies, or -1 for a zero; made once per layout."""
    return by_layout("image_index", packed, lambda: _build_image_index(packed, plan))


def _build_image_index(packed: PackedNeRF, plan: RenderPlan) -> np.ndarray:
    specs = {s.name: s for s in packed.layers}
    idx = np.full(plan.numel, -1, np.int64)
    for t in plan.tiles:
        spec = specs[t.layer]
        n, k = np.meshgrid(np.arange(t.cols), np.arange(t.rows), indexing="ij")
        idx[t.off + swizzle128(n, k)] = spec.w_off + (t.row0 + k) * spec.n + t.col0 + n
    rgb1 = specs["rgb1"]
    start = rgb1.w_off + packed.hidden * rgb1.n
    idx[plan.dir_off:] = np.arange(start, start + packed.dir_dim * rgb1.n)
    return idx


def render_tile_image(packed: PackedNeRF) -> torch.Tensor:
    """The render kernel's weights (see WeightTile), in the packing dtype on
    the packing's device; built once per PackedNeRF, by a gather on the
    device (_tile_gather)."""
    if "image" not in packed.tile_cache:
        src = torch.cat([packed.weights, packed.weights.new_zeros(1)])
        packed.tile_cache["image"] = src[_tile_gather(packed)]
    return packed.tile_cache["image"]


def _tile_gather(packed: PackedNeRF) -> torch.Tensor:
    """The tile image's positions in the packed weights with one zero
    appended (a pad element points at the zero), on the packing's device.
    Uploaded once per layout and device: a trainer packs its weights every
    step, and a copy from a host array there would wait for the stream to
    drain, holding the host while the card runs out of work."""
    dev = packed.weights.device

    def build():
        host = _image_index(packed, render_plan(packed))
        count("upload_bytes", host.nbytes)
        with span("upload.tile_index"):
            idx = torch.from_numpy(host).to(dev)
        return torch.where(idx < 0, packed.weights.numel(), idx)
    return by_layout("tile_gather", packed, build, str(dev))


def macs_per_point(mcfg: NeRFModelConfig) -> int:
    """Multiply-adds the MLP needs per sample point (unpadded widths; the
    direction rows of rgb1 run once per ray, see macs_per_ray)."""
    total = 0
    for name, (fan_in, fan_out) in layer_shapes(mcfg).items():
        if name == "density_fc":          # never read by the forward pass
            continue
        if name == "rgb1":
            fan_in = mcfg.hidden
        total += fan_in * fan_out
    return total


def macs_per_ray(mcfg: NeRFModelConfig) -> int:
    """Multiply-adds of the direction head, evaluated once per ray."""
    return mcfg.dir_dim * RGB_HIDDEN


def _check_white(rcfg: RenderConfig) -> None:
    if rcfg.white_background and rcfg.variant != "train":
        raise NotImplementedError(
            "fused render white_background relies on the train variant's "
            "weight telescoping (acc == 1 - T_final); the legacy inclusive "
            "weights don't telescope — use the nn.Module path")


def _ext(x: torch.Tensor, n_freqs: int, width: int) -> torch.Tensor:
    """[x ++ sin/cos(pi 2^l x) ++ 0] (..., width) in float32, the same
    arithmetic as the kernel's encode()."""
    out = positional_encoding(x, n_freqs)
    return F.pad(out, (0, width - out.shape[-1]))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def n_intervals(packed: PackedNeRF, z_vals: torch.Tensor) -> int:
    """Samples a ray: the depths' count, or for cones the edges' less one."""
    return z_vals.shape[1] - int(packed.mip)


def _dists(packed: PackedNeRF, z, rcfg: RenderConfig, cones=None):
    """(n, S) distances: diff(z) with the variant's tail, or for cones the
    interval lengths ``(t1 - t0) |d|``."""
    if packed.mip:
        return (z[:, 1:] - z[:, :-1]) * cones[:, 1:2].to(z.dtype)
    return sample_dists(z, rcfg.variant)


def _dir_ext(packed: PackedNeRF, d, cones=None):
    """The direction head's input (n, dir_dim): PE(d), or for cones
    mip-NeRF's encoding of the unit view direction ``d / |d|``."""
    if packed.mip:
        return view_encoding(d / cones[:, 1:2].to(d.dtype), packed.n_dir_freq)
    return _ext(d, packed.n_dir_freq, packed.dir_dim)


def _chunk_ext(packed: PackedNeRF, o, d, z, c0: int, ch: int, cones=None):
    """fc1's input (n * ch, pos_pad), ray-major, of samples [c0, c0 + ch):
    PE of the points ``o + d z``, or for cones the integrated encoding of
    each interval's Gaussian, zero-padded."""
    if packed.mip:
        mean, cov = frustum_gaussian(o, d, cones[:, 0].to(o.dtype), z[:, c0:c0 + ch],
                                     z[:, c0 + 1:c0 + ch + 1])
        enc = integrated_pos_enc(mean.reshape(-1, 3), cov.reshape(-1, 3), packed.n_pos_freq)
        return F.pad(enc, (0, packed.pos_pad - enc.shape[-1]))
    pts = (o[:, None, :] + d[:, None, :] * z[:, c0:c0 + ch, None]).reshape(-1, 3)
    return _ext(pts, packed.n_pos_freq, packed.pos_pad)


def _heads(packed: PackedNeRF, df, h: int):
    """(features, pre-activation density) from the merged head's output: a
    ReLU feature, or the mip arch's linear bottleneck."""
    return (df[:, :h] if packed.mip else torch.relu(df[:, :h])), df[:, h]


def _rgb(packed: PackedNeRF, pre):
    """The colours from the rgb head: sigmoid, widened for the mip arch."""
    rgb = torch.sigmoid(pre)
    return rgb * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING if packed.mip else rgb


def fused_render_rays_reference(
    packed: PackedNeRF, origins: torch.Tensor, directions: torch.Tensor,
    z_vals: torch.Tensor, rcfg: RenderConfig, emit_weights: bool = False,
    bf16_products: bool = False, cones: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the kernel's function (for the mip arch the
    cone kernel's: ``cones`` (N, 2) and the edges (N, S + 1) as ``z_vals``).

    Products take operands rounded to the packing dtype and sum in float32
    (bf16 x bf16 -> f32, as the tensor cores); hidden activations and the
    encoding are rounded to the packing dtype where the kernel rounds them;
    biases, density and rgb heads are float32; transmittance is carried
    from one 128-sample chunk to the next.  Given float64 rays it does the
    same in float64 (the rounding to the packing dtype included), which
    measures how far the function itself moves with the summation's
    precision.  With ``bf16_products`` every product runs as a bf16 matmul
    (summed on the card's tensor cores and rounded to bf16): a second such
    witness, not the kernel's function.  Returns rgb (N, 3), or (rgb,
    weights (N, S)) with ``emit_weights``."""
    _check_white(rcfg)
    ft = torch.float64 if origins.dtype == torch.float64 else torch.float32
    wdt = packed.weights.dtype
    rnd = (lambda t: t.to(wdt).to(ft)) if wdt != torch.float32 else (lambda t: t)
    body = [s for s in packed.layers if s.kind in ("plain", "skip")]
    Wf = {s.name: packed.w(s).to(ft) for s in packed.layers}
    Bf = {s.name: packed.b(s).to(ft) for s in packed.layers}
    h, S = packed.hidden, n_intervals(packed, z_vals)

    def mm(a, b):
        return (a.bfloat16() @ b.bfloat16()).to(ft) if bf16_products else a @ b

    def lin(name, x):
        return mm(x, Wf[name]) + Bf[name]

    rgb_parts, w_parts = [], []
    for r0 in range(0, origins.shape[0], REF_RAY_CHUNK):
        o = origins[r0:r0 + REF_RAY_CHUNK].to(ft)
        d = directions[r0:r0 + REF_RAY_CHUNK].to(ft)
        z = z_vals[r0:r0 + REF_RAY_CHUNK].to(ft)
        cone = cones[r0:r0 + REF_RAY_CHUNK] if cones is not None else None
        n = o.shape[0]
        dists = _dists(packed, z, rcfg, cone)
        extd = rnd(_dir_ext(packed, d, cone))
        dir_part = mm(extd, Wf["rgb1"][h:])                                # (n, 128)
        T = torch.ones(n, 1, device=o.device, dtype=ft)
        acc = torch.zeros(n, 3, device=o.device, dtype=ft)
        ws = []
        for c0 in range(0, S, CHUNK):
            dc = dists[:, c0:c0 + CHUNK]
            ch = dc.shape[1]
            ext = rnd(_chunk_ext(packed, o, d, z, c0, ch, cone))
            x = rnd(torch.relu(lin("fc1", ext)))
            for s in body:
                inp = torch.cat([x, ext], -1) if s.kind == "skip" else x
                x = rnd(torch.relu(lin(s.name, inp)))
            feat, dens = _heads(packed, lin("densfeat", x), h)
            feat = rnd(feat)
            dens = _softplus(dens) if packed.density_act == "softplus" else torch.relu(dens)
            fp = mm(feat, Wf["rgb1"][:h]).reshape(n, ch, RGB_HIDDEN)
            rgb_h = rnd(torch.relu(fp + dir_part[:, None, :] + Bf["rgb1"]))
            rgb = _rgb(packed, lin("rgb2", rgb_h.reshape(n * ch, -1))[:, :3])
            xs = dens.reshape(n, ch) * dc
            csum = torch.cumsum(-xs, 1)
            trans = torch.exp(csum + xs) if rcfg.variant == "train" else torch.exp(csum)
            w = (1.0 - torch.exp(-xs)) * (T * trans)
            acc = acc + torch.sum(w[..., None] * rgb.reshape(n, ch, 3), 1)
            T = T * torch.exp(csum[:, -1:])
            ws.append(w)
        rgb_parts.append(acc + T if rcfg.white_background else acc)
        if emit_weights:
            w_parts.append(torch.cat(ws, 1))
    rgb = torch.cat(rgb_parts)
    return (rgb, torch.cat(w_parts)) if emit_weights else rgb


def _kernel_args(packed: PackedNeRF, rcfg: RenderConfig):
    """(iparams, fparams pointer, fparams): nerf_device.cuh parse_params,
    made once per layout and compositor.  The frequency tables are pi 2^l,
    or the mip arch's 2^l."""
    return by_layout("args", packed, lambda: _build_kernel_args(packed, rcfg),
                     rcfg.variant, rcfg.white_background)


def _build_kernel_args(packed: PackedNeRF, rcfg: RenderConfig):
    ip = [len(packed.layers), packed.hidden, packed.pos_dim, packed.pos_pad,
          packed.dir_dim, int(packed.density_act == "softplus"),
          int(rcfg.variant == "train"), int(rcfg.white_background), int(packed.mip)]
    for s in packed.layers:
        ip += [_KINDS[s.kind], s.w_off, s.b_off, s.k, s.n]
    freqs = octaves if packed.mip else (lambda n: trig_constants(n)[0])
    pos_f = np.zeros(MAX_FREQ, np.float32)
    dir_f = np.zeros(MAX_FREQ, np.float32)
    pos_f[:packed.n_pos_freq] = freqs(packed.n_pos_freq)
    dir_f[:packed.n_dir_freq] = freqs(packed.n_dir_freq)
    tail = np.float32(1e-3 if rcfg.variant == "train" else 1.0)
    fp = np.concatenate([[tail, trig_constants(0)[1]], pos_f, dir_f]).astype(np.float32)
    return (ctypes.c_int * len(ip))(*ip), fp.ctypes.data_as(ctypes.c_void_p), fp


def _render_kernel_args(packed: PackedNeRF, rcfg: RenderConfig):
    """_kernel_args with the render plan appended (sm90::parse_plan), made
    once per layout and compositor."""
    return by_layout("render_args", packed, lambda: _build_render_kernel_args(packed, rcfg),
                     rcfg.variant, rcfg.white_background)


def _build_render_kernel_args(packed: PackedNeRF, rcfg: RenderConfig):
    plan = render_plan(packed)
    ip, fp_ptr, fp = _kernel_args(packed, rcfg)
    tail = [len(plan.passes), len(plan.tiles), plan.dir_off, plan.act_kb, plan.enc_kb,
            plan.stage_bytes]
    first = 0
    for p in plan.passes:
        n_act = sum(t.src == "act" for t in p.tiles)
        tail += [_PASS_KINDS[p.kind], p.n, p.b_off, first, len(p.tiles), n_act]
        first += len(p.tiles)
    for t in plan.tiles:
        tail += [t.off, t.cols * 128, -(-t.rows // 16), t.kb]
    ip = list(ip) + tail
    return (ctypes.c_int * len(ip))(*ip), fp_ptr, fp


def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C functions declared."""
    from sfm_nerf_tpu_torch.kernels import _build

    lib = _build.load("fused_render")
    lib.sfm_fused_render.restype = ctypes.c_int
    lib.sfm_fused_render.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p])
    lib.sfm_fused_render_stash.restype = ctypes.c_int
    lib.sfm_fused_render_stash.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
        + [ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.sfm_fused_render_tb.restype = ctypes.c_int
    lib.sfm_fused_render_tb.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7)
    lib.sfm_fused_render_layout.restype = ctypes.c_int
    lib.sfm_fused_render_layout.argtypes = [ctypes.c_void_p] * 3
    lib.sfm_cuda_error_string.restype = ctypes.c_char_p
    lib.sfm_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def render_smem_layout(packed: PackedNeRF, rcfg: RenderConfig) -> Dict[str, int]:
    """The kernel's shared-memory use for this packing, as the CUDA side
    lays it out (needs the built library): bytes per block, ring stages,
    bytes per stage."""
    lib = _kernel_lib()
    ip, fp_ptr, _fp_keep = _render_kernel_args(packed, rcfg)
    out = (ctypes.c_int * 3)()
    err = lib.sfm_fused_render_layout(ctypes.cast(ip, ctypes.c_void_p), fp_ptr, out)
    if err != 0:
        raise RuntimeError("fused render plan refused: " + lib.sfm_cuda_error_string(err).decode())
    return {"smem_bytes": out[0], "ring_stages": out[1], "stage_bytes": out[2]}


def _check_cones(packed: PackedNeRF, cones, z_vals) -> None:
    """A mip packing takes cones and edges; any other neither."""
    if packed.mip != (cones is not None):
        given = "given" if cones is not None else "none"
        raise ValueError("the mip arch renders cones (fused_render_cones, fused_mse_loss_cones): "
                         f"packing mip={packed.mip}, cones {given}")
    if cones is not None and (cones.shape != (z_vals.shape[0], 2) or z_vals.shape[1] < 2):
        raise ValueError(f"cones {tuple(cones.shape)} and edges {tuple(z_vals.shape)}: "
                         "expected (N, 2) and (N, S + 1)")


def _on_card(t: torch.Tensor, what: str) -> bool:
    """The device rule of every kernel entry: a CPU tensor runs the plain
    version (False), a CUDA tensor launches the kernel (True), any other
    device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device.type == "cuda"


def _check_launch(packed: PackedNeRF, origins, directions, z_vals, cones, what: str,
                  **extra) -> None:
    """The input checks of every launch of the render and training kernels:
    cones for the mip arch and for no other, every tensor (``extra`` too)
    on the origins' device, the bf16 packing, float32 biases on a 16-byte
    boundary (the block stages them with 16-byte loads), hidden <= 256,
    (N, 3) rays for the N rows of ``z_vals``."""
    _check_cones(packed, cones, z_vals)
    dev = origins.device
    for name, t in (("directions", directions), ("z_vals", z_vals), ("cones", cones),
                    *extra.items(), ("weights", packed.weights), ("biases", packed.biases)):
        if t is not None and t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, origins on {dev}")
    if packed.weights.dtype != torch.bfloat16:
        raise ValueError(f"{what} kernel takes bf16-packed weights, got {packed.weights.dtype}")
    if packed.hidden > 256:
        raise ValueError(f"{what} kernel: hidden {packed.hidden} > 256")
    if packed.biases.dtype != torch.float32 or packed.biases.data_ptr() % 16:
        raise ValueError(f"{what} kernel takes float32 biases on a 16-byte boundary")
    n = z_vals.shape[0]
    if origins.shape != (n, 3) or directions.shape != (n, 3):
        raise ValueError(f"{what}: origins {tuple(origins.shape)}, directions "
                         f"{tuple(directions.shape)}, z_vals {tuple(z_vals.shape)}")


def _launch(packed, origins, directions, z_vals, rcfg, emit_weights, cones=None):
    """Check the inputs, allocate the outputs and launch the CUDA kernel."""
    _check_launch(packed, origins, directions, z_vals, cones, "fused render")
    dev = origins.device
    n, S = z_vals.shape[0], n_intervals(packed, z_vals)
    o = origins.float().contiguous()
    d = directions.float().contiguous()
    z = z_vals.float().contiguous()
    c = cones.float().contiguous() if cones is not None else None
    rgb = torch.empty(n, 3, device=dev, dtype=torch.float32)
    w = torch.empty(n, S, device=dev, dtype=torch.float32) if emit_weights else None
    lib = _kernel_lib()
    ip, fp_ptr, _fp_keep = _render_kernel_args(packed, rcfg)
    image = render_tile_image(packed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sfm_fused_render(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), c.data_ptr() if c is not None else None,
            n, S,
            image.data_ptr(), packed.biases.data_ptr(),
            ctypes.cast(ip, ctypes.c_void_p), fp_ptr,
            rgb.data_ptr(), w.data_ptr() if w is not None else None,
            int(emit_weights), stream)
    if err != 0:
        raise RuntimeError("fused render kernel launch failed: "
                           + lib.sfm_cuda_error_string(err).decode())
    return rgb, w


def _render(packed: PackedNeRF, origins, directions, z_vals, rcfg: RenderConfig,
            emit_weights: bool, cones=None):
    """The render entries' one body: rgb, or (rgb, weights) with
    ``emit_weights``, from the kernel (CUDA tensors, one launch counted
    under the entry's name) or the plain version (CPU tensors).  ``cones``:
    a mip packing's, with the edges as ``z_vals``."""
    _check_white(rcfg)
    _check_cones(packed, cones, z_vals)
    if not _on_card(origins, "fused render"):
        return fused_render_rays_reference(packed, origins, directions, z_vals, rcfg,
                                           emit_weights=emit_weights, cones=cones)
    rgb, w = _launch(packed, origins, directions, z_vals, rcfg, emit_weights, cones)
    LAUNCHES["fused_render_" + ("rays" if cones is None else "cones")
             + "_weights" * emit_weights] += 1
    return (rgb, w) if emit_weights else rgb


def fused_render_rays(
    packed: PackedNeRF, origins: torch.Tensor, directions: torch.Tensor,
    z_vals: torch.Tensor, rcfg: RenderConfig,
) -> torch.Tensor:
    """rgb (N, 3) of rays (N, 3) x depths (N, S) through the fused kernel
    (CUDA tensors) or its plain version (CPU tensors)."""
    return _render(packed, origins, directions, z_vals, rcfg, False)


def fused_render_rays_weights(
    packed: PackedNeRF, origins: torch.Tensor, directions: torch.Tensor,
    z_vals: torch.Tensor, rcfg: RenderConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fused_render_rays that also returns the per-sample compositing
    weights (N, S), the inputs of weight_maps."""
    return _render(packed, origins, directions, z_vals, rcfg, True)


def fused_render_cones(
    packed: PackedNeRF, origins: torch.Tensor, directions: torch.Tensor,
    cones: torch.Tensor, edges: torch.Tensor, rcfg: RenderConfig,
) -> torch.Tensor:
    """rgb (N, 3) of cones (origins (N, 3), un-normalised directions (N, 3),
    cones (N, 2): radius and |d|) over the intervals between edges (N, S +
    1), through the mip arch's packing: the cone kernel (CUDA tensors) or
    its plain version (CPU tensors)."""
    return _render(packed, origins, directions, edges, rcfg, False, cones)


def fused_render_cones_weights(
    packed: PackedNeRF, origins: torch.Tensor, directions: torch.Tensor,
    cones: torch.Tensor, edges: torch.Tensor, rcfg: RenderConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fused_render_cones that also returns each interval's compositing
    weight (N, S): the coarse level of a mip-NeRF frame."""
    return _render(packed, origins, directions, edges, rcfg, True, cones)
