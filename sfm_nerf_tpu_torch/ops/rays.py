"""Ray generation.

Convention of sfm_nerf_tpu/ops/rays.py: the camera-frame direction
``[(x-cx)/fx, (y-cy)/fy, 1]`` (+y down, +z forward, no Blender axis flip)
is rotated by ``pose[:3, :3]`` and L2-normalised; the origin is
``pose[:3, 3]``.  Full float32 throughout.  ``sample_ray_batch`` draws a
training batch on the device: images, poses and K stay there for the whole
run.

Cones (mip-NeRF): the same direction left un-normalised (unit camera z)
and ``cones`` (n, 2) = (radius, |d|) per ray, the radius ``2 / (sqrt(12)
fx)``: mip-NeRF's ``dx 2 / sqrt(12)``, where the spacing of neighbouring
un-normalised directions is ``1 / fx``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pixel_to_ray(
    intrinsics: torch.Tensor,   # (3, 3) K
    pose: torch.Tensor,         # (4, 4) or (3, 4) camera-to-world
    px: torch.Tensor,           # (...,) pixel x
    py: torch.Tensor,           # (...,) pixel y
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for any batch of pixel coordinates: (origin, direction)."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    d_cam = torch.stack([(px - cx) / fx, (py - cy) / fy, torch.ones_like(px)], -1)
    # written out as three products per component: no TF32 or reduced
    # precision product can enter, whatever the device's matmul settings
    rot = pose[:3, :3]
    d_world = (d_cam[..., None, :] * rot).sum(-1)
    d_world = d_world / torch.linalg.vector_norm(d_world, dim=-1, keepdim=True)
    origin = pose[:3, 3].expand_as(d_world)
    return origin, d_world


def image_rays(
    intrinsics: torch.Tensor, pose: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All H*W rays of a frame in y-major raster order, on ``pose``'s
    device and in float32."""
    dev = pose.device
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev)
    pose = pose.to(torch.float32)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    return pixel_to_ray(intrinsics, pose, xs.reshape(-1), ys.reshape(-1))


def sample_ray_batch(
    images: torch.Tensor,       # (N, H, W, 3) float32, on the training device
    poses: torch.Tensor,        # (N, 4, 4)
    intrinsics: torch.Tensor,   # (3, 3)
    n_rays: int,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    cones: bool = False,
):
    """IID-uniform (image, pixel) draws -> (origins, directions, target rgb),
    each (n_rays, 3), gathered on the device the images live on.  With
    ``cones``: (origins, un-normalised directions, cones (n_rays, 2), target
    rgb).

    The draws come from ``generator`` (on that device), or are given as
    ``draws = (img_idx, px, py)`` integer tensors, so that a test feeds both
    packages the same pixels."""
    n_img, height, width = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    if draws is None:
        img_idx = torch.randint(0, n_img, (n_rays,), generator=generator, device=dev)
        px = torch.randint(0, width, (n_rays,), generator=generator, device=dev)
        py = torch.randint(0, height, (n_rays,), generator=generator, device=dev)
    else:
        img_idx, px, py = (t.to(dev, torch.long) for t in draws)
    pose = poses[img_idx]                       # (B, 4, 4)
    rgb = images[img_idx, py, px]               # (B, 3)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    d_cam = torch.stack([(pxf - cx) / fx, (pyf - cy) / fy, torch.ones_like(pxf)], -1)
    # three products per component, as pixel_to_ray: full float32
    d_world = (pose[:, :3, :3] * d_cam[:, None, :]).sum(-1)
    if cones:
        return pose[:, :3, 3], d_world, cone_params(d_world, intrinsics), rgb
    d_world = d_world / torch.linalg.vector_norm(d_world, dim=-1, keepdim=True)
    return pose[:, :3, 3], d_world, rgb


def cone_params(directions: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(n, 2): each cone's radius at unit distance along its un-normalised
    axis, ``2 / (sqrt(12) fx)``, and the axis' length."""
    radius = (2.0 / float(np.sqrt(12.0))) / intrinsics[0, 0]
    norm = torch.linalg.vector_norm(directions, dim=-1)
    return torch.stack([radius.expand_as(norm), norm], -1)


def image_cones(
    intrinsics: torch.Tensor, pose: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All H*W cones of a frame in y-major raster order: (origins,
    un-normalised directions, cones (radius, |d|))."""
    dev = pose.device
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev)
    pose = pose.to(torch.float32)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    d_cam = torch.stack([(px - intrinsics[0, 2]) / intrinsics[0, 0],
                         (py - intrinsics[1, 2]) / intrinsics[1, 1], torch.ones_like(px)], -1)
    d = (d_cam[..., None, :] * pose[:3, :3]).sum(-1)
    return pose[:3, 3].expand_as(d), d, cone_params(d, intrinsics)
