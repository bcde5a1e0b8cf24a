"""NeRF MLPs as ``nn.Module``s, both architectures of
sfm_nerf_tpu/models/nerf.py.

- ``active``: fc1 -> 4 hidden layers -> skip layer over [h ++ PE(pos)] ->
  3 hidden layers -> {softplus density head; ReLU feature layer} -> rgb
  head over [feature ++ PE(dir)] (128 -> 3, sigmoid).
- ``legacy``: fc1 -> ``n_block1_layers`` hidden layers -> optional skip
  layer -> block2 ending in a (hidden+1)-wide ReLU layer whose channel 0 is
  the density -> the same rgb head.  ``density_fc`` exists in every legacy
  state dict but the forward pass never reads it; it is kept for the round
  trip.

Layers are keyed by the JAX parameter names.  ``nn.Linear`` stores its
weight as (out, in); models/convert.py is the one place that transposes.

``NeRFPair`` holds the two networks of hierarchical sampling, ``coarse`` and
``fine``, the JAX package's ``{'coarse': ..., 'fine': ...}`` params tree.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sfm_nerf_tpu_torch.config import NeRFModelConfig
from sfm_nerf_tpu_torch.ops.encoding import positional_encoding


def layer_shapes(cfg: NeRFModelConfig) -> Dict[str, Tuple[int, int]]:
    """{name: (fan_in, fan_out)} in the JAX package's layer order."""
    h = cfg.hidden
    shapes: Dict[str, Tuple[int, int]] = {"fc1": (cfg.pos_dim, h)}
    if cfg.arch == "active":
        shapes.update({f"fc_{i}": (h, h) for i in range(4)})
        shapes["skip"] = (h + cfg.pos_dim, h)
        shapes.update({f"fc2_{i}": (h, h) for i in range(3)})
        shapes["density"] = (h, 1)
        shapes["feature"] = (h, h)
    elif cfg.arch == "legacy":
        shapes.update({f"block1_{i}": (h, h) for i in range(cfg.n_block1_layers)})
        if cfg.has_skip:
            shapes["skip"] = (h + cfg.pos_dim, h)
        shapes["block2_0"] = (h, h)
        shapes["block2_1"] = (h, h)
        shapes["block2_2"] = (h, h + 1)
        shapes["density_fc"] = (h, 1)
    else:
        raise ValueError(f"unknown arch {cfg.arch!r}")
    shapes["rgb1"] = (h + cfg.dir_dim, 128)
    shapes["rgb2"] = (128, 3)
    return shapes


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices with the products summed in float32,
    a float32 result: one tensor-core product on a card; on the CPU the
    same sums through float32 operands (exact: a bf16 value is a float32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class Bf16Linear(torch.autograd.Function):
    """``x @ W.T + b`` for a bf16 ``W`` on the card's tensor cores: ``x``
    rounded to bf16, the bf16 x bf16 products summed in float32, the
    float32 bias added.  The backward is the JAX package's (the cotangents
    of the bf16 operands come out rounded to bf16, the bias's float32),
    with one rounding more: the float32 cotangent of the output enters
    both products rounded to bf16, as a tensor-core product needs."""

    @staticmethod
    def forward(ctx, x, w, b):
        x16 = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
        ctx.save_for_backward(x16, w)
        ctx.x_meta = (x.shape, x.dtype)
        y = _mm_f32(x16, w.t()) + b.float()
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x16, w = ctx.saved_tensors
        shape, dtype = ctx.x_meta
        g = g.reshape(-1, g.shape[-1])
        g16 = g.to(torch.bfloat16)
        gx = _mm_f32(g16, w).to(torch.bfloat16).to(dtype).reshape(shape)
        gw = _mm_f32(g16.t(), x16).to(w.dtype)
        return gx, gw, g.sum(0)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W.T + b with float32 accumulation.  With bf16 weights (the
    serving cast, or ``bf16_compute``'s training cast) the activation is
    rounded to bf16 and the product of the two bf16 operands is summed in
    float32, as the JAX package's mixed precision does; the bias stays
    float32.  On the CPU (and for sharded weights) the product runs on
    float32 copies of the bf16 operands under autograd, the reference; on
    a card through ``Bf16Linear``."""
    w = layer.weight
    if w.dtype == torch.bfloat16:
        if w.is_cuda and not hasattr(w, "device_mesh"):
            return Bf16Linear.apply(x, w, layer.bias)
        return x.to(torch.bfloat16).float() @ w.float().t() + layer.bias.float()
    return F.linear(x, w, layer.bias)


class NeRF(nn.Module):
    """``seed``: initial weights from a generator of their own seeded with
    it (drawn on the CPU, so the same on every device), or from the CPU
    ``generator`` given; without either from torch's global generator.
    Either way weight and bias are U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
    JAX package's init (the values differ: the two frameworks draw other
    numbers from the same seed)."""

    def __init__(self, cfg: NeRFModelConfig, device=None, dtype=torch.float32,
                 seed: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleDict({
            name: nn.Linear(fi, fo, device=device, dtype=dtype)
            for name, (fi, fo) in layer_shapes(cfg).items()
        })
        # without a seed: nn.Linear's default init, the same distribution
        if seed is not None or generator is not None:
            gen = generator if generator is not None else torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for layer in self.layers.values():
                    bound = 1.0 / math.sqrt(layer.in_features)
                    for p in (layer.weight, layer.bias):
                        u = torch.rand(p.shape, generator=gen, dtype=torch.float32)
                        p.copy_((2.0 * u - 1.0) * bound)
        if cfg.density_bias_init:
            with torch.no_grad():
                if cfg.arch == "active":
                    self.layers["density"].bias += cfg.density_bias_init
                else:
                    self.layers["block2_2"].bias[0] += cfg.density_bias_init

    def forward(self, pos: torch.Tensor, direction: torch.Tensor):
        """(density (..., 1), rgb (..., 3)) at ``pos`` seen along
        ``direction``."""
        cfg, L = self.cfg, self.layers
        if cfg.pos_encoding:
            pe = positional_encoding(pos, cfg.n_pos_freq)
            de = positional_encoding(direction, cfg.n_dir_freq)
        else:
            pe, de = pos, direction
        h = F.relu(_linear(L["fc1"], pe))
        if cfg.arch == "active":
            for i in range(4):
                h = F.relu(_linear(L[f"fc_{i}"], h))
            h = F.relu(_linear(L["skip"], torch.cat([h, pe], -1)))
            for i in range(3):
                h = F.relu(_linear(L[f"fc2_{i}"], h))
            density = F.softplus(_linear(L["density"], h))
            feature = F.relu(_linear(L["feature"], h))
        else:
            for i in range(cfg.n_block1_layers):
                h = F.relu(_linear(L[f"block1_{i}"], h))
            if cfg.has_skip:
                h = F.relu(_linear(L["skip"], torch.cat([h, pe], -1)))
            h = F.relu(_linear(L["block2_0"], h))
            h = F.relu(_linear(L["block2_1"], h))
            out = F.relu(_linear(L["block2_2"], h))
            density, feature = out[..., :1], out[..., 1:]
        rgb_h = F.relu(_linear(L["rgb1"], torch.cat([feature, de], -1)))
        return density, torch.sigmoid(_linear(L["rgb2"], rgb_h))


class NeRFPair(nn.Module):
    """The coarse and the fine network of hierarchical sampling, two NeRFs
    of one config.  With a ``seed`` both are drawn from one generator, the
    coarse one first, so they differ."""

    def __init__(self, cfg: NeRFModelConfig, device=None, dtype=torch.float32,
                 seed: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed) if seed is not None else None
        self.coarse = NeRF(cfg, device=device, dtype=dtype, generator=gen)
        self.fine = NeRF(cfg, device=device, dtype=dtype, generator=gen)


def cast_params_bf16(model: NeRF) -> NeRF:
    """Serving cast in place: bf16 weight matrices, float32 biases."""
    for layer in model.layers.values():
        layer.weight.data = layer.weight.data.to(torch.bfloat16)
    return model


def bf16_compute(model: NeRF):
    """``model`` as a ``(pos, direction) -> (density, rgb)`` function that
    runs on a bf16 cast of its weight matrices, biases float32: the JAX
    trainer's ``compute_dtype='bfloat16'`` (``cast_params_bf16`` of the
    float32 masters).  The cast is differentiable: the grads land on the
    float32 parameters, which the optimizer updates."""
    def fn(pos: torch.Tensor, direction: torch.Tensor):
        cast = {name: p.to(torch.bfloat16) if p.ndim == 2 else p
                for name, p in model.named_parameters()}
        return torch.func.functional_call(model, cast, (pos, direction))

    return fn


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
