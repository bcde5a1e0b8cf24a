"""Inputs made from the run's seed: one generator per purpose, training
images and camera poses, the pinhole K, and the committed weights' reader.

The same seed gives the same inputs; different purposes draw from
different streams of it, so that the draws of a step never repeat the
pixels of an image.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

PURPOSES = {"data": 0, "weights": 1, "draws": 2, "order": 3, "check": 4}


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from the run's seed (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, PURPOSES[purpose]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g


def focal(camera_angle_x: float, width: int) -> float:
    """The reference's focal formula, ``0.5 * a * W / tan(0.5 * a)``."""
    return 0.5 * camera_angle_x * width / math.tan(0.5 * camera_angle_x)


def camera_matrix(d: Dict, device) -> torch.Tensor:
    f = focal(d["camera_angle_x"], d["width"])
    return torch.tensor([[f, 0.0, d["width"] / 2], [0.0, f, d["height"] / 2], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def sphere_poses(n: int, radius: float, seed: int, device) -> torch.Tensor:
    """``n`` camera-to-world poses at ``radius`` on the upper half sphere,
    each looking at the origin along its +z axis (the rays' convention:
    camera-frame direction [(x-cx)/fx, (y-cy)/fy, 1])."""
    rng = np.random.default_rng(sub_seed(seed, "data"))
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2])
    eye = radius * v / np.linalg.norm(v, axis=1, keepdims=True)
    z = -eye / radius
    up = np.broadcast_to(np.array([0.0, 0.0, 1.0]), z.shape)
    x = np.cross(up, z)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    y = np.cross(z, x)
    poses = np.zeros((n, 4, 4))
    poses[:, :3, 0], poses[:, :3, 1], poses[:, :3, 2], poses[:, :3, 3] = x, y, z, eye
    poses[:, 3, 3] = 1.0
    return torch.tensor(poses, dtype=torch.float32, device=device)


def training_images(d: Dict, seed: int, device) -> torch.Tensor:
    """(n_images, H, W, 3) float32 in [0, 1), drawn in one call on the
    device, as the trainer holds its images."""
    return torch.rand((d["n_images"], d["height"], d["width"], 3),
                      generator=generator(seed, "data", device), device=device)


def read_weights(path: str, layers, device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{layer: (W (in, out), b (out,))} float32 from an npz of
    ``<layer>.w`` / ``<layer>.b`` arrays."""
    with np.load(path) as z:
        return {k: (torch.tensor(z[f"{k}.w"], device=device),
                    torch.tensor(z[f"{k}.b"], device=device)) for k in layers}
