"""SfM -> NeRF dataset bridge (port of sfm_nerf_tpu/sfm/to_nerf.py; frames
are read and written through io/png.py).

The reference keeps its two phases fully disjoint — Phase2 never imports
Phase1, and NeRF always trains on Blender ground-truth poses (SURVEY §1:
"SfM poses could feed NeRF, but the reference trains NeRF on
Blender-synthetic ground-truth poses").  This module ships that coupling:
export a Phase1 reconstruction (``camera_info`` + triangulated points, the
return value of ``sfm.pipeline.SfMPipeline.run()``) as a Blender-transforms
style dataset that ``cli.nerf`` consumes directly — real images,
SfM-estimated poses, scene-derived near/far bounds.

Conventions (each pinned by tests/test_to_nerf.py oracles):

- Phase1's world->camera map is ``x_cam = R (X - C)`` (reference
  Phase1/Utils.py:86-106 builds P = K R [I | -C]), so camera-to-world is
  ``[[R^T, C], [0, 1]]``.  The SfM +z-forward camera axis (cheirality keeps
  ``z > 0``) is exactly Phase2's ray convention (ops/rays.py: ``d_cam =
  [(x-cx)/fx, (y-cy)/fy, 1]`` rotated by ``pose[:3,:3]``) — no axis flip is
  needed or applied.
- Intrinsics are written EXPLICITLY (``fl_x/fl_y/cx/cy``, the instant-ngp
  transforms extension) because real calibrations are not centered and a
  bare ``camera_angle_x`` cannot represent them.  ``io/blender.py`` reads
  them back; a best-effort ``camera_angle_x`` is still written for
  third-party consumers.
- ``near``/``far`` come from the triangulated depth distribution (1st/99th
  percentile with margin) — the scene-scale hint the Blender datasets
  hardcode as 2.0/6.0 (reference Phase2/train.py:808-809).  ``cli.nerf
  --near auto --far auto`` picks them up.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

from sfm_nerf_tpu_torch.io.png import read_png, write_png


def c2w_from_rc(R: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Camera-to-world 4x4 from Phase1's (R, C) world-to-camera pair."""
    R = np.asarray(R, dtype=np.float64).reshape(3, 3)
    C = np.asarray(C, dtype=np.float64).reshape(3)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = C
    return c2w


def near_far_from_points(
    camera_info: Dict[int, dict],
    points: Dict[int, np.ndarray],
    lo_pct: float = 1.0,
    hi_pct: float = 99.0,
    margin: Tuple[float, float] = (0.8, 1.25),
) -> Tuple[float, float]:
    """Scene near/far from the per-camera depth distribution of the
    triangulated cloud: depth of X in camera i is ``(R_i (X - C_i))_z``.
    Percentiles are taken over all (camera, point) pairs with positive
    depth, then widened by ``margin`` so stratified samples bracket the
    geometry."""
    X = np.asarray(list(points.values()), dtype=np.float64).reshape(-1, 3)
    if X.size == 0:
        raise ValueError("near_far_from_points: empty point cloud")
    depths = []
    for info in camera_info.values():
        R = np.asarray(info["R"], dtype=np.float64).reshape(3, 3)
        C = np.asarray(info["C"], dtype=np.float64).reshape(3)
        z = (X - C) @ R[2]
        depths.append(z[z > 0])
    d = np.concatenate(depths)
    if d.size == 0:
        raise ValueError("near_far_from_points: no positive-depth points")
    near = float(max(1e-3, margin[0] * np.percentile(d, lo_pct)))
    far = float(margin[1] * np.percentile(d, hi_pct))
    return near, far


def undistort_maps(
    K: np.ndarray, k1: float, k2: float, height: int, width: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel maps for resampling a radially distorted image onto the ideal
    pinhole model: output pixel (u, v) of the UNDISTORTED image reads the
    source image at (map_x[v,u], map_y[v,u]).

    Model matches ops/ba.py's refinement parameterization (and cv2's
    k1/k2): distorted_normalized = normalized * (1 + k1 r^2 + k2 r^4) —
    the forward distortion applied to the ideal coordinates, which is
    exactly the lookup direction an undistortion REMAP needs (no iterative
    inversion; cv2.initUndistortRectifyMap computes the same thing)."""
    K = np.asarray(K, dtype=np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    vs, us = np.meshgrid(
        np.arange(height, dtype=np.float64),
        np.arange(width, dtype=np.float64),
        indexing="ij",
    )
    x = (us - cx) / fx
    y = (vs - cy) / fy
    r2 = x * x + y * y
    scale = 1.0 + k1 * r2 + k2 * r2 * r2
    return (fx * x * scale + cx).astype(np.float32), \
        (fy * y * scale + cy).astype(np.float32)


def max_distortion_displacement_px(
    K: np.ndarray, k1: float, k2: float, height: int, width: int
) -> float:
    """Largest pixel displacement the radial model (k1, k2) induces inside
    the frame — evaluated at the four corners, where r is maximal for both
    pure-k1 and pure-k2 terms (same-sign) and remains the practical bound
    for mixed signs at SfM-scale magnitudes.  Used to decide whether
    resampling is WORTH the bilinear blur: noise-level refined coefficients
    (sub-0.1 px everywhere) should be ignored, not 'corrected'."""
    K = np.asarray(K, dtype=np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    us = np.array([0.0, width - 1.0, 0.0, width - 1.0])
    vs = np.array([0.0, 0.0, height - 1.0, height - 1.0])
    x = (us - cx) / fx
    y = (vs - cy) / fy
    r2 = x * x + y * y
    delta = k1 * r2 + k2 * r2 * r2
    return float(np.max(np.hypot(fx * x * delta, fy * y * delta)))


def undistort_image(
    img: np.ndarray, K: np.ndarray, k1: float, k2: float
) -> np.ndarray:
    """Resample ``img`` (H, W[, C]) to the ideal pinhole model by bilinear
    lookup through :func:`undistort_maps`.  Out-of-source samples clamp to
    the border (matching cv2.remap's BORDER_REPLICATE choice for
    undistortion, where the affected pixels sit outside the valid FOV
    anyway).  dtype is preserved (uint8 inputs round)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    map_x, map_y = undistort_maps(K, k1, k2, h, w)
    x0 = np.clip(np.floor(map_x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(map_y).astype(np.int64), 0, h - 2)
    tx = np.clip(map_x - x0, 0.0, 1.0)[..., None]
    ty = np.clip(map_y - y0, 0.0, 1.0)[..., None]
    flat = img.reshape(h, w, -1).astype(np.float64)
    out = ((1 - ty) * ((1 - tx) * flat[y0, x0] + tx * flat[y0, x0 + 1])
           + ty * ((1 - tx) * flat[y0 + 1, x0] + tx * flat[y0 + 1, x0 + 1]))
    out = out.reshape(img.shape)
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), np.iinfo(img.dtype).min,
                       np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


def export_nerf_dataset(
    camera_info: Dict[int, dict],
    points: Dict[int, np.ndarray],
    K: np.ndarray,
    image_paths: Dict[int, str],
    out_dir: str,
    width: int,
    height: int,
    holdout_every: int = 0,
    near_far: Optional[Tuple[float, float]] = None,
    distortion: Optional[Tuple[float, float]] = None,
) -> dict:
    """Write a Phase2-trainable dataset directory from an SfM result.

    Layout: ``out_dir/images/img_{i:03d}.png`` (copies of the source
    frames) + ``transforms_train.json`` / ``transforms_test.json``.

    ``distortion=(k1, k2)`` (from --ba_refine_intrinsics) resamples each
    exported frame to the ideal pinhole model (:func:`undistort_image`)
    instead of copying it — transforms.json cannot express radial terms,
    so without this the border rays of a distorted capture would be
    knowingly mis-aimed.  ``K`` must then be the refined pinhole part the
    distortion was estimated against.

    ``holdout_every > 0`` sends every Nth registered camera to the test
    split (kept in train too only if that would leave fewer than 2 train
    views); ``0`` duplicates the train split as the test split — with a
    handful of SfM views every pose constrains the model, matching the
    reference's own gif-mode behavior of rendering against the train split
    (reference Phase2/Wrapper.py:513 hardcodes mode='train').

    Returns the written train-split metadata dict.
    """
    K = np.asarray(K, dtype=np.float64)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)

    cam_ids = sorted(camera_info)
    missing = [i for i in cam_ids if i not in image_paths]
    if missing:
        raise ValueError(f"export_nerf_dataset: no image path for cameras {missing}")

    if near_far is None:
        near_far = near_far_from_points(camera_info, points)
    near, far = near_far

    # resample only when the distortion MOVES pixels perceptibly: bilinear
    # resampling costs real sharpness on every frame, so noise-level
    # refined k1/k2 (max corner displacement under a quarter pixel) export
    # as plain copies of the already-effectively-pinhole capture
    undistort = (
        distortion is not None
        and max_distortion_displacement_px(
            K, distortion[0], distortion[1], height, width) > 0.25
    )
    frames = []
    for i in cam_ids:
        rel = f"images/img_{i:03d}"
        dst = os.path.join(out_dir, rel + ".png")
        src = image_paths[i]
        if undistort:
            write_png(dst, undistort_image(
                read_png(src), K, distortion[0], distortion[1]))
        elif os.path.abspath(src) != os.path.abspath(dst):
            shutil.copyfile(src, dst)
        frames.append({
            "file_path": rel,
            "sfm_camera_id": i,
            "transform_matrix": c2w_from_rc(
                camera_info[i]["R"], camera_info[i]["C"]
            ).tolist(),
        })

    test_idx = set()
    if holdout_every > 0:
        candidate = set(range(holdout_every - 1, len(frames), holdout_every))
        if len(frames) - len(candidate) >= 2:
            test_idx = candidate
    train_frames = [f for k, f in enumerate(frames) if k not in test_idx]
    test_frames = [f for k, f in enumerate(frames) if k in test_idx] or list(frames)

    fl_x, fl_y = float(K[0, 0]), float(K[1, 1])
    base = {
        # best-effort pinhole FOV for third-party consumers; our loader
        # prefers the explicit intrinsics below (see module docstring).
        "camera_angle_x": float(2.0 * np.arctan(0.5 * width / fl_x)),
        "fl_x": fl_x,
        "fl_y": fl_y,
        "cx": float(K[0, 2]),
        "cy": float(K[1, 2]),
        "w": int(width),
        "h": int(height),
        "near": float(near),
        "far": float(far),
        "source": "sfm_nerf_tpu_torch Phase1 reconstruction",
    }
    if undistort:
        # provenance: the written frames were RESAMPLED to the pinhole
        # model above; these are the radial terms that were removed
        base["undistorted_k1_k2"] = [float(distortion[0]),
                                     float(distortion[1])]
    for name, split in (("train", train_frames), ("test", test_frames)):
        meta = dict(base, frames=split)
        with open(os.path.join(out_dir, f"transforms_{name}.json"), "w") as f:
            json.dump(meta, f, indent=1)
    print(
        f"export_nerf_dataset: {len(train_frames)} train / {len(test_frames)} "
        f"test views -> {out_dir} (near {near:.3f}, far {far:.3f})"
    )
    if far / near > 50:
        print(
            f"  note: depth range spans {far / near:.0f}x — train with "
            "--lindisp so stratified samples cover it in inverse depth"
        )
    return dict(base, frames=train_frames)
