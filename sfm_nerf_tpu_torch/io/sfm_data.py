"""Phase 1 data: calibration, images and the matching files.

Same formats and outputs as sfm_nerf_tpu/io/sfm_data.py (the reference's
Phase1/Wrapper.py:14-193):

- ``calibration.txt``: a whitespace 3x3 K;
- images ``1.png .. N.png``, read through io/png.py as RGB;
- ``matching{i}.txt``: a header ``nFeatures: <n>``, then per feature
  ``total_imgs R G B u v [img_id u v]...``, the matches of image i with
  later images.  Parsing gives:
    matches_dict[(i, j)]   -> float array (K, 5) rows (u_i, v_i, u_j, v_j, f_idx)
    all_feature_points[f]  -> {img_id: (u, v)} track dict
    visibility             -> (max_img_id + 1, F) 0/1 (row 0 unused; ids are
                              1-based)

The Python parser only; the JAX package's C++ parser is not used.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from sfm_nerf_tpu_torch.io.png import read_png


def load_calibration(calib_file: str) -> np.ndarray:
    rows = []
    with open(calib_file) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split()])
    K = np.asarray(rows, dtype=np.float64)
    if K.shape != (3, 3):
        raise ValueError(f"calibration must be 3x3, got {K.shape}")
    return K


def load_images(path: str, num_imgs: int) -> List[Optional[np.ndarray]]:
    """``1.png .. {num_imgs}.png`` as (H, W, 3) uint8 RGB.  An unreadable
    frame stays in the list as ``None``, so image i is always entry i - 1."""
    images = []
    for i in range(1, num_imgs + 1):
        try:
            img = read_png(os.path.join(path, f"{i}.png"))
        except (OSError, ValueError):
            images.append(None)
            continue
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        images.append(img[..., :3])
    return images


def parse_matching_files(
    folder_path: str, num_images: int
) -> Tuple[Dict, List[Dict], np.ndarray]:
    """Parse all ``matching{i}.txt`` files (see the module docstring)."""
    matches_dict: Dict[Tuple[int, int], list] = {}
    all_feature_points: List[Dict[int, Tuple[float, float]]] = []
    max_image_id = 0
    f_idx = 0
    for i_ref in range(1, num_images + 1):
        fp = os.path.join(folder_path, f"matching{i_ref}.txt")
        if not os.path.isfile(fp):
            continue
        with open(fp) as f:
            f.readline()  # "nFeatures: <n>" header (count not trusted)
            for line in f:
                tokens = line.split()
                if not tokens:
                    continue
                num_matches = int(tokens[0])
                u_i, v_i = float(tokens[4]), float(tokens[5])
                max_image_id = max(max_image_id, i_ref)
                feature_dict = {i_ref: (u_i, v_i)}
                idx = 6
                for _ in range(num_matches - 1):
                    j = int(tokens[idx])
                    u_j, v_j = float(tokens[idx + 1]), float(tokens[idx + 2])
                    idx += 3
                    max_image_id = max(max_image_id, j)
                    matches_dict.setdefault((i_ref, j), []).append(
                        (u_i, v_i, u_j, v_j, f_idx))
                    feature_dict[j] = (u_j, v_j)
                all_feature_points.append(feature_dict)
                f_idx += 1

    visibility = np.zeros((max_image_id + 1, f_idx))
    for fi, feature_dict in enumerate(all_feature_points):
        for img_id in feature_dict:
            visibility[img_id][fi] = 1
    matches_np = {k: np.asarray(v, dtype=np.float64) for k, v in matches_dict.items()}
    return matches_np, all_feature_points, visibility


def build_visibility_matrix(camera_ids, all_feature_points) -> np.ndarray:
    """V[i, f] = 1 iff feature f is observed by camera_ids[i]
    (Phase1/BundleAdjustment.py:6-26)."""
    cam_index = {cid: i for i, cid in enumerate(camera_ids)}
    V = np.zeros((len(camera_ids), len(all_feature_points)), dtype=np.uint8)
    for f_idx, feature_dict in enumerate(all_feature_points):
        for cam_id in feature_dict:
            if cam_id in cam_index:
                V[cam_index[cam_id], f_idx] = 1
    return V


def parse_matching_table(folder_path: str, num_images: int) -> Tuple[np.ndarray, int]:
    """All matching files as one flat table: ``(rows, n_features)`` with
    rows (N, 8) float64 ``[i_ref, j, u_i, v_i, u_j, v_j, f_idx, rgb_packed]``;
    j == 0 marks a feature's own row (its source observation).  Rows come
    in file order; ``rgb_packed`` is (R << 16) | (G << 8) | B."""
    rows: list = []
    f_idx = 0
    for i_ref in range(1, num_images + 1):
        fp = os.path.join(folder_path, f"matching{i_ref}.txt")
        if not os.path.isfile(fp):
            continue
        with open(fp) as f:
            f.readline()
            for line in f:
                tokens = line.split()
                if not tokens:
                    continue
                num_matches = int(tokens[0])
                rgb = (int(tokens[1]) << 16) | (int(tokens[2]) << 8) | int(tokens[3])
                u_i, v_i = float(tokens[4]), float(tokens[5])
                rows.append((i_ref, 0, u_i, v_i, 0.0, 0.0, f_idx, rgb))
                for m in range(num_matches - 1):
                    t = tokens[6 + 3 * m:9 + 3 * m]
                    rows.append((i_ref, int(t[0]), u_i, v_i, float(t[1]),
                                 float(t[2]), f_idx, rgb))
                f_idx += 1
    return np.asarray(rows, dtype=np.float64).reshape(-1, 8), f_idx


def visibility_from_table(rows: np.ndarray, n_features: int) -> np.ndarray:
    """(max_img + 1, F) 0/1 visibility from a ``parse_matching_table`` table."""
    m = rows[rows[:, 1] != 0]
    max_img = int(max(rows[:, 0].max(initial=0), rows[:, 1].max(initial=0)))
    vis = np.zeros((max_img + 1, n_features))
    vis[rows[:, 0].astype(np.int64), rows[:, 6].astype(np.int64)] = 1
    vis[m[:, 1].astype(np.int64), m[:, 6].astype(np.int64)] = 1
    return vis
