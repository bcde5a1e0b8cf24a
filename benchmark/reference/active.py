"""The plain reference of the active NeRF MLP (the network of
``Phase2/train.py``), and the frozen count of its operations.

A configuration names the file of its network's plain reference under the
key ``reference``; the harness loads it by that path and hands it to the
shared method (``reference/nerf.py``: rays, sampling, compositing,
training) and to the counts (``counts.py``).  A network file holds:

- ``layer_shapes(m)``: {layer: (fan_in, fan_out)} in forward order, under
  the names of the program's ``NeRF.layers``;
- ``DENSITY_BIAS``: (layer, index) of the bias entry that the model
  group's ``density_bias_init`` raises;
- ``mlp(m, pts, dirs, lin)``: (sigma (P,), rgb (P, 3)) of points seen
  along dirs, where ``lin(name, x)`` applies layer ``name`` of the
  network in the run's precision;
- ``macs_per_point(m)`` and ``macs_per_ray(m)``: the least multiply-adds.

The active MLP: fc1, four layers, a skip layer over ``[h, PE(x)]``, three
layers, softplus density, ReLU feature, rgb head over ``[feature,
PE(d)]``.  Its counts are a frozen copy of the port's
``kernels/fused_render.py:macs_per_point`` / ``macs_per_ray``: the
direction half of rgb1 runs once a ray, so a point counts rgb1's feature
rows only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference.nerf import dir_dim, embed, pos_dim

RGB_HIDDEN = 128        # rgb1's width
DENSITY_BIAS = ("density", 0)


def layer_shapes(m: Dict) -> Dict[str, Tuple[int, int]]:
    h, p = m["hidden"], pos_dim(m)
    shapes = {"fc1": (p, h)}
    shapes.update({f"fc_{i}": (h, h) for i in range(4)})
    shapes["skip"] = (h + p, h)
    shapes.update({f"fc2_{i}": (h, h) for i in range(3)})
    shapes["density"] = (h, 1)
    shapes["feature"] = (h, h)
    shapes["rgb1"] = (h + dir_dim(m), RGB_HIDDEN)
    shapes["rgb2"] = (RGB_HIDDEN, 3)
    return shapes


def mlp(m: Dict, pts: torch.Tensor, dirs: torch.Tensor, lin):
    pe, de = embed(m, pts, dirs)
    h = torch.relu(lin("fc1", pe))
    for i in range(4):
        h = torch.relu(lin(f"fc_{i}", h))
    h = torch.relu(lin("skip", torch.cat([h, pe], -1)))
    for i in range(3):
        h = torch.relu(lin(f"fc2_{i}", h))
    sigma = torch.nn.functional.softplus(lin("density", h))[:, 0]
    feat = torch.relu(lin("feature", h))
    rgb = torch.sigmoid(lin("rgb2", torch.relu(lin("rgb1", torch.cat([feat, de], -1)))))
    return sigma, rgb


def macs_per_point(m: Dict) -> int:
    return sum((m["hidden"] if name == "rgb1" else fi) * fo
               for name, (fi, fo) in layer_shapes(m).items())


def macs_per_ray(m: Dict) -> int:
    return dir_dim(m) * RGB_HIDDEN
