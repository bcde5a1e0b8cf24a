"""Blender-synthetic (nerf_synthetic) dataset loader.

Same behaviour as sfm_nerf_tpu/io/blender.py: ``transforms_{mode}.json``
with ``camera_angle_x`` and per-frame camera-to-world matrices, RGB in
[0, 1] with alpha dropped, the reference focal formula
``0.5 * camera_angle_x * W / tan(0.5 * camera_angle_x)`` by default
(``focal_formula='standard'``: ``0.5 * W / tan(0.5 * camera_angle_x)``), explicit ``fl_x/fl_y/cx/cy``
intrinsics and ``near``/``far`` hints when the file carries them.  PNGs are
decoded by io/png.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np

from sfm_nerf_tpu_torch.io.png import png_size, read_png


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    width: int
    height: int
    camera_matrix: np.ndarray  # (3, 3) float32
    near: "float | None" = None
    far: "float | None" = None


def derive_focal(camera_angle_x: float, width: int, formula: str = "reference") -> float:
    """The focal in pixels: 'reference' keeps the reference's extra
    camera_angle_x factor, 'standard' is the pinhole's."""
    if formula == "reference":
        return 0.5 * camera_angle_x * width / np.tan(0.5 * camera_angle_x)
    if formula == "standard":
        return 0.5 * width / np.tan(0.5 * camera_angle_x)
    raise ValueError(f"unknown focal formula {formula!r}")


def load_blender_dataset(
    data_path: str,
    mode: str,
    downscale: int = 1,
    focal_formula: str = "reference",
) -> Tuple[np.ndarray, np.ndarray, CameraInfo]:
    """Returns (images (N,H,W,3) float32, poses (N,4,4) float32, CameraInfo);
    ``focal_formula`` as ``derive_focal`` takes it."""
    json_file = os.path.join(data_path, f"transforms_{mode}.json")
    with open(json_file) as f:
        meta = json.load(f)
    images = []
    for frame in meta["frames"]:
        img = read_png(os.path.join(data_path, frame["file_path"] + ".png"))
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        img = img[..., :3]
        if downscale > 1:
            img = img[::downscale, ::downscale]
        images.append(img)
    images = np.stack(images).astype(np.float32) / 255.0
    poses = np.stack([
        np.asarray(frame["transform_matrix"], dtype=np.float32)
        for frame in meta["frames"]
    ])
    height, width = images.shape[1], images.shape[2]
    return images, poses, _camera(meta, json_file, width, height, downscale, focal_formula)


def _camera(meta, json_file, width, height, downscale, focal_formula="reference") -> CameraInfo:
    if "fl_x" in meta:
        s = 1.0 / downscale
        K = np.array(
            [[meta["fl_x"] * s, 0, meta["cx"] * s],
             [0, meta["fl_y"] * s, meta["cy"] * s],
             [0, 0, 1]],
            dtype=np.float32,
        )
    else:
        if "camera_angle_x" not in meta:
            raise KeyError(
                f"{json_file} has neither camera_angle_x nor fl_x/fl_y — "
                "cannot derive intrinsics")
        focal = derive_focal(float(meta["camera_angle_x"]), width, focal_formula)
        K = np.array(
            [[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
            dtype=np.float32,
        )
    return CameraInfo(
        width=width,
        height=height,
        camera_matrix=K,
        near=float(meta["near"]) if "near" in meta else None,
        far=float(meta["far"]) if "far" in meta else None,
    )


def load_camera_info(data_path: str, mode: str, downscale: int = 1) -> CameraInfo:
    """The CameraInfo load_blender_dataset would return, reading only the
    transforms file and the first frame's PNG header."""
    json_file = os.path.join(data_path, f"transforms_{mode}.json")
    with open(json_file) as f:
        meta = json.load(f)
    first = os.path.join(data_path, meta["frames"][0]["file_path"] + ".png")
    width, height = png_size(first)
    height, width = -(-height // downscale), -(-width // downscale)
    return _camera(meta, json_file, width, height, downscale)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Turntable camera pose: translate along z, rotate by phi about x,
    theta about y, then the reference's axis swap."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    phi = np.deg2rad(phi_deg)
    rot_phi = np.array(
        [[1, 0, 0, 0],
         [0, np.cos(phi), -np.sin(phi), 0],
         [0, np.sin(phi), np.cos(phi), 0],
         [0, 0, 0, 1]], dtype=np.float32)
    th = np.deg2rad(theta_deg)
    rot_theta = np.array(
        [[np.cos(th), 0, -np.sin(th), 0],
         [0, 1, 0, 0],
         [np.sin(th), 0, np.cos(th), 0],
         [0, 0, 0, 1]], dtype=np.float32)
    swap = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32)
    return swap @ rot_theta @ rot_phi @ c2w


def look_at_pose(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world with +z forward and up = (0, -1, 0), the convention
    of this repo's ray math; a straight-down or straight-up view takes
    world +x as its right vector."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-8:
        right = np.array([1.0, 0.0, 0.0])
        nr = 1.0
    right /= nr
    up2 = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, fwd, eye
    return c2w
