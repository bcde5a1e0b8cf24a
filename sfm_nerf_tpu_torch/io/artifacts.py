"""The reconstruction's point cloud as a PLY file.

Port of ``save_ply`` from sfm_nerf_tpu/io/artifacts.py: the ASCII form is
byte for byte the JAX package's; the binary form (float32 xyz, uchar rgb,
little-endian) is written with numpy.  The matplotlib and cv2 figures of
that module are not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_PROPS = ("property float x\nproperty float y\nproperty float z\n"
          "property uchar red\nproperty uchar green\nproperty uchar blue\n"
          "end_header\n")


def save_ply(
    points: np.ndarray, colors: Optional[np.ndarray] = None,
    out_dir: str = ".", name: str = "reconstruction.ply",
    binary: Optional[bool] = None,
) -> str:
    """Write ``points`` (N, 3) with uint8 RGB ``colors`` (grey 180 when
    None).  ``binary=None`` writes binary from 100,000 points on, ASCII
    below."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if colors is None:
        colors = np.full((len(points), 3), 180, np.uint8)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    path = os.path.join(out_dir, name)
    if binary is None:
        binary = len(points) >= 100_000
    if binary:
        rec = np.empty(len(points), dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
        rec["xyz"] = points
        rec["rgb"] = colors
        with open(path, "wb") as f:
            f.write(("ply\nformat binary_little_endian 1.0\n"
                     f"element vertex {len(points)}\n" + _PROPS).encode())
            f.write(rec.tobytes())
        return path
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(points)}\n" + _PROPS)
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
    return path
