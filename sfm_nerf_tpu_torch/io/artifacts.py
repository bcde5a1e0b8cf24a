"""The SfM artifacts: the reconstruction plots, the feature-match figure,
the reprojection overlays and the PLY point cloud.

Port of sfm_nerf_tpu/io/artifacts.py: the same writers, signatures, file
names and pixel sizes (BASELINE requires "the same reconstruction plots").
The figures are drawn by io/figure.py (numpy; the JAX package draws them
with matplotlib), the overlays written by io/jpeg.py (the JAX package uses
cv2.imwrite), the PNGs by io/png.py.  The port's images are RGB where the
JAX package's are cv2's BGR, so the colours are written so that the
decoded files look the same.  The PLY's ASCII form is byte for byte the
JAX package's; its binary form (float32 xyz, uchar rgb, little-endian) is
written with numpy.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from sfm_nerf_tpu_torch.io.figure import Canvas, Figure
from sfm_nerf_tpu_torch.io.jpeg import write_jpeg
from sfm_nerf_tpu_torch.io.png import write_png

_PROPS = ("property float x\nproperty float y\nproperty float z\n"
          "property uchar red\nproperty uchar green\nproperty uchar blue\n"
          "end_header\n")


def save_x_vs_z_plot(
    triangulated_points: Sequence[np.ndarray], out_dir: str = "."
) -> str:
    """'X vs Z Coordinates for Different Camera Poses': each candidate
    pose's points in the X-Z plane (x_vs_z_triangulation.png, 3000 x 2400)."""
    colors = ["blue", "green", "red", "orange"]
    fig = Figure((10, 8))
    ax = fig.add_subplot()
    for i, points in enumerate(triangulated_points):
        pts = np.asarray(points).reshape(-1, 3)
        if len(pts) == 0:
            continue
        ax.scatter(pts[:, 0], pts[:, 2], color=colors[i % len(colors)], s=10,
                   alpha=0.7, label=f"Camera pose {i + 1}")
    ax.grid(True)
    ax.set_xlabel("X")
    ax.set_ylabel("Z")
    ax.set_title("X vs Z Coordinates for Different Camera Poses")
    ax.legend()
    ax.axis_equal()
    path = os.path.join(out_dir, "x_vs_z_triangulation.png")
    fig.savefig(path, dpi=300)
    return path


def save_3d_points_plot(
    X_final: np.ndarray,
    C_final: np.ndarray,
    X_optimized: Optional[np.ndarray] = None,
    out_dir: str = ".",
    title: str = "3D Points Visualization",
) -> str:
    """The two-view points in 3-D, linear and refined, with both cameras
    (3d_points_visualization.png, 3000 x 2400)."""
    fig = Figure((10, 8))
    ax = fig.add_subplot(projection="3d")
    X = np.asarray(X_final).reshape(-1, 3)
    ax.scatter(X[:, 0], X[:, 1], X[:, 2], color="blue", marker="o",
               label="Linear Triangulation", alpha=0.6)
    if X_optimized is not None:
        Xo = np.asarray(X_optimized).reshape(-1, 3)
        ax.scatter(Xo[:, 0], Xo[:, 1], Xo[:, 2], color="red", marker="^",
                   label="Non-Linear Optimization", alpha=0.6)
    ax.scatter(0, 0, 0, color="green", marker="s", s=100, label="Camera 1")
    C = np.asarray(C_final).reshape(-1)
    ax.scatter(C[0], C[1], C[2], color="purple", marker="s", s=100, label="Camera 2")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.set_title(title)
    ax.legend()
    # a degenerate init pair can leave no points: the JAX writer's guard
    m = max(np.abs(X).max() if len(X) else 1.0, 1e-6)
    ax.set_xlim(-m, m)
    ax.set_ylim(-m, m)
    ax.set_zlim(-m, m)
    fig.tight_layout()
    path = os.path.join(out_dir, "3d_points_visualization.png")
    fig.savefig(path, dpi=300)
    return path


def save_reconstruction_plot(
    X_all: np.ndarray, camera_info: Dict[int, Dict], out_dir: str = "."
) -> str:
    """Every point and camera centre in 3-D, camera i in colour C{i}
    (complete_reconstruction.png, 3000 x 2400)."""
    fig = Figure((10, 8))
    ax = fig.add_subplot(projection="3d")
    X_all = np.asarray(X_all).reshape(-1, 3)
    if len(X_all):
        ax.scatter(X_all[:, 0], X_all[:, 1], X_all[:, 2], color="blue",
                   marker=".", s=2, alpha=0.6)
    for i, info in camera_info.items():
        C = np.asarray(info["C"]).reshape(-1)
        ax.scatter(C[0], C[1], C[2], color=f"C{i}", marker="s", s=100, label=f"Camera {i}")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.set_title("Complete 3D Reconstruction")
    ax.legend()
    if len(X_all):
        m = np.abs(X_all).max() * 1.2
        ax.set_xlim(-m, m)
        ax.set_ylim(-m, m)
        ax.set_zlim(-m, m)
    fig.tight_layout()
    path = os.path.join(out_dir, "complete_reconstruction.png")
    fig.savefig(path, dpi=300)
    return path


def save_topdown_plot(
    X_all: np.ndarray, camera_info: Dict[int, Dict], out_dir: str = "."
) -> str:
    """The points and cameras in the X-Z plane, within ±10
    (topdown_view.png, 1000 x 1000)."""
    fig = Figure((10, 10))
    ax = fig.add_subplot()
    ax.set_xlim(-10, 10)
    ax.set_ylim(-10, 10)
    X_all = np.asarray(X_all).reshape(-1, 3)
    if len(X_all):
        ax.scatter(X_all[:, 0], X_all[:, 2], marker=".", linewidths=0.5, color="blue")
    for i, info in camera_info.items():
        C = np.asarray(info["C"]).reshape(-1)
        ax.plot(C[0], C[2], marker="o", markersize=15, linestyle="None", label=f"Camera {i}")
    ax.grid(True)
    ax.set_xlabel("X")
    ax.set_ylabel("Z")
    ax.set_title("Top-down View (X-Z Plane)")
    ax.legend()
    path = os.path.join(out_dir, "topdown_view.png")
    fig.savefig(path)
    return path


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


def match_visualization(img1: np.ndarray, img2: np.ndarray, matches: np.ndarray) -> np.ndarray:
    """cv2.drawMatches with NOT_DRAW_SINGLE_POINTS, in numpy: the two RGB
    images side by side on a black canvas of (max h, w1 + w2), each match a
    circle of radius 3 around both keypoints and the line between them,
    antialiased, 1 px wide.  cv2 picks each match's colour from its
    process-global RNG, which no other program can reproduce; here the
    colours come from ``np.random.default_rng(0)``."""
    img1, img2 = np.asarray(img1), np.asarray(img2)
    h1, w1 = img1.shape[:2]
    h2, w2 = img2.shape[:2]
    canvas = np.zeros((max(h1, h2), w1 + w2, 3), np.uint8)
    canvas[:h1, :w1] = img1[..., :3]
    canvas[:h2, w1:] = img2[..., :3]
    m = np.asarray(matches, np.float64).reshape(len(matches), -1)
    cv = Canvas(canvas.shape[1], canvas.shape[0])
    cv.rgb[:] = canvas.astype(np.float32) / 255
    if len(m):
        colors = np.random.default_rng(0).integers(0, 256, (len(m), 3)) / 255.0
        # cv2's pixel (x, y) is centred at display (x + .5, h - y - .5)
        p1 = np.column_stack([m[:, 0] + 0.5, cv.h - m[:, 1] - 0.5])
        p2 = np.column_stack([np.minimum(m[:, 2] + w1, cv.w - 1) + 0.5, cv.h - m[:, 3] - 0.5])
        cv.markers(p1, "o", 6.0, colors, 1.0, 1.0, fill=False)
        cv.markers(np.column_stack([m[:, 2] + w1 + 0.5, p2[:, 1]]), "o", 6.0, colors,
                   1.0, 1.0, fill=False, order0=2 * len(m))
        cv.segments(p1, p2, 1.0, colors)
    return cv.to_uint8()


def save_match_visualization(
    img1: np.ndarray, img2: np.ndarray, matches: np.ndarray,
    out_dir: str = ".", name: str = "feature_matches.png",
) -> str:
    """The matches of an image pair drawn over the two images
    (``match_visualization``); the headless version of the reference's
    blocking display_matches (Phase1/Wrapper.py:223-233)."""
    path = os.path.join(out_dir, name)
    write_png(path, match_visualization(img1, img2, matches))
    return path


# cv2.circle(img, c, 2, color, -1): the 13 pixels with |dx| + |dy| <= 2
_DISK2 = np.array([(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
                   if abs(dx) + abs(dy) <= 2])


def draw_overlay(img: np.ndarray, proj: np.ndarray, orig: np.ndarray) -> np.ndarray:
    """Green dots of radius 2 at the finite projections, then red ones at
    the original points (cv2.circle(..., 2, color, -1) with Python's
    rounding, as the JAX writer draws them), on a copy of the RGB image."""
    out = np.array(img[..., :3], np.uint8, copy=True)
    h, w = out.shape[:2]
    proj = np.asarray(proj, np.float64).reshape(-1, 2)
    orig = np.asarray(orig, np.float64).reshape(-1, 2)
    if not np.isfinite(orig).all():
        raise ValueError("save_projection_overlays: a non-finite original point")
    for pts, rgb in ((proj[np.isfinite(proj).all(1)], (0, 255, 0)), (orig, (255, 0, 0))):
        pts = pts[(np.abs(pts) < 2 ** 30).all(1)]
        c = np.round(pts).astype(np.int64)              # round half to even, as round()
        ys = (c[:, 1, None] + _DISK2[None, :, 0]).ravel()
        xs = (c[:, 0, None] + _DISK2[None, :, 1]).ravel()
        inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        out[ys[inside], xs[inside]] = rgb
    return out


def save_projection_overlays(
    img1: np.ndarray, img2: np.ndarray,
    proj1: np.ndarray, proj2: np.ndarray,
    pts1: np.ndarray, pts2: np.ndarray,
    stage: str, out_dir: str = ".",
) -> Sequence[str]:
    """Green projected / red original dots over each frame of the pair,
    written as JPEGs 'Frame{1,2} - *.jpg' (Phase1/Wrapper.py:508-538,
    565-583).  ``stage`` in {'lineartriangulation',
    'nonlineartriangulation'}; the reference's nonlinear frame-2 file name
    keeps its odd spacing."""
    if stage == "lineartriangulation":
        names = ["Frame1 - lineartriangulation.jpg", "Frame2 - lineartriangulation.jpg"]
    else:
        names = ["Frame1 - nonlineartriangulation.jpg", "Frame2 -non lineartriangulation.jpg"]
    paths = []
    for img, proj, orig, name in ((img1, proj1, pts1, names[0]), (img2, proj2, pts2, names[1])):
        p = os.path.join(out_dir, name)
        write_jpeg(p, draw_overlay(img, proj, orig))
        paths.append(p)
    return paths
