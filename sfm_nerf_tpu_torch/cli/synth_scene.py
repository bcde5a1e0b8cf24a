"""Generate a Blender-format dataset by analytic ray tracing, the port of
``Phase2/make_synth_scene.py``.

    python -m sfm_nerf_tpu_torch.cli.synth_scene --out DIR [--size 800] \\
        [--n_train 100] [--n_test 16] [--seed 0] [--scene spheres|chair] \\
        [--background black|white] [--trace_backend torch|numpy] [--device cpu]

The scene (textured spheres, the chair's boxes and cushion, a checkered
ground disk, a directional light with cast shadows, Blinn-Phong highlights)
and the camera rig are copies of the script's (``SPHERES``, the chair's
``BOXES``, ``camera_rig``, ``CAMERA_ANGLE_X``); ``Scene`` holds what the
script's ``set_scene`` / ``set_background`` set as module globals, so a
switch of scene is never served stale.  ``trace`` follows the script's
vectorized tracer (``_trace_jax``): every primitive's hit distance stacked,
the nearest by argmin, normals, albedo and shadows selected per ray.

``--trace_backend torch`` (the default) traces in float32 on ``--device``
(cuda unless ``--device cpu``); ``numpy`` traces in float64 on the CPU,
where the script's bit-stable numpy path ran.  Each view is written with
io/png.py as ``(img * 255 + 0.5)`` truncated to uint8, beside the same
``transforms_{train,test}.json``.  Focal and poses come from the port's
io/blender.py (``derive_focal``, ``look_at_pose``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from sfm_nerf_tpu_torch import DEFAULT_DEVICE
from sfm_nerf_tpu_torch.io.blender import derive_focal, look_at_pose

CAMERA_ANGLE_X = 0.6911112070083618  # blender-synthetic default FoV

# (center, radius, texture, k_spec, spec_exp): the synth800 scene
SPHERES = [
    (np.array([0.00, -0.35, 0.00]), 0.65, "stripes", 0.25, 64.0),
    (np.array([0.95, -0.62, 0.35]), 0.38, "blue", 0.80, 128.0),
    (np.array([-0.85, -0.55, -0.55]), 0.45, "checker_g", 0.15, 32.0),
    (np.array([-0.15, -0.80, 0.95]), 0.20, "purple", 0.40, 96.0),
    (np.array([0.35, 0.45, -0.60]), 0.30, "yellow", 0.55, 48.0),
]
# (center, half_extents, texture, k_spec, spec_exp): the chair, before its
# scale of 1.35
BOXES = [
    (np.array([0.00, -0.20, 0.00]), np.array([0.50, 0.06, 0.48]), "wood", 0.50, 96.0),
    (np.array([0.00, 0.52, -0.42]), np.array([0.44, 0.48, 0.05]), "wood_v", 0.30, 64.0),
    (np.array([-0.47, 0.35, -0.42]), np.array([0.06, 0.70, 0.06]), "wood_dark", 0.20, 48.0),
    (np.array([0.47, 0.35, -0.42]), np.array([0.06, 0.70, 0.06]), "wood_dark", 0.20, 48.0),
    (np.array([-0.42, -0.63, -0.40]), np.array([0.06, 0.37, 0.06]), "wood_dark", 0.20, 48.0),
    (np.array([0.42, -0.63, -0.40]), np.array([0.06, 0.37, 0.06]), "wood_dark", 0.20, 48.0),
    (np.array([-0.42, -0.63, 0.40]), np.array([0.06, 0.37, 0.06]), "wood_dark", 0.20, 48.0),
    (np.array([0.42, -0.63, 0.40]), np.array([0.06, 0.37, 0.06]), "wood_dark", 0.20, 48.0),
]
CHAIR_SPHERES = [(np.array([0.00, -0.02, 0.04]), 0.26, "cushion", 0.10, 24.0)]
CHAIR_SCALE = 1.35
GROUND_Y = -1.0
GROUND_R = 2.2
LIGHT = np.array([0.40, 1.00, 0.25]) / np.linalg.norm([0.40, 1.00, 0.25])
AMBIENT = 0.18
T_MIN = 1e-3

_FLAT = {"blue": [0.15, 0.30, 0.90], "purple": [0.60, 0.20, 0.75],
         "yellow": [0.95, 0.85, 0.15], "cushion": [0.80, 0.15, 0.18],
         "wood_dark": [0.34, 0.20, 0.10]}
# two-tone textures: (axes summed, bands per unit, colour where odd, where even)
_BANDS = {"checker_g": ((0, 1), 8, [0.15, 0.70, 0.25], [0.90, 0.90, 0.85]),
          "wood": ((0,), 14, [0.72, 0.48, 0.22], [0.58, 0.36, 0.15]),
          "wood_v": ((1,), 12, [0.70, 0.45, 0.20], [0.55, 0.33, 0.13])}


@dataclasses.dataclass
class Scene:
    """What the tracer renders: spheres, boxes, the ground disk's radius (0:
    none) and the miss-ray colour."""

    spheres: list = dataclasses.field(default_factory=lambda: list(SPHERES))
    boxes: list = dataclasses.field(default_factory=list)
    ground_r: float = GROUND_R
    background: float = 0.0

    def set_scene(self, name: str) -> None:
        """'spheres': the synth800 scene; 'chair': the chair's boxes and
        cushion scaled by 1.35, no ground disk."""
        if name == "spheres":
            self.spheres, self.boxes, self.ground_r = list(SPHERES), [], GROUND_R
        elif name == "chair":
            s = CHAIR_SCALE
            self.spheres = [(c * s, r * s, t, k, e) for c, r, t, k, e in CHAIR_SPHERES]
            self.boxes = [(c * s, h * s, t, k, e) for c, h, t, k, e in BOXES]
            self.ground_r = 0.0
        else:
            raise ValueError(f"unknown scene {name!r}")

    def set_background(self, name: str) -> None:
        self.background = {"black": 0.0, "white": 1.0}[name]


def _sphere_t(o, d, c, r):
    oc = o - c
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - r * r)
    ok = disc > 0
    sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > T_MIN, t0, t1)
    return t, ok & (t > T_MIN)


def _box_t(o, inv, c, h):
    ta, tb = (c - h - o) * inv, (c + h - o) * inv
    t_near = torch.minimum(ta, tb).amax(-1)
    t_far = torch.maximum(ta, tb).amin(-1)
    t = torch.where(t_near > T_MIN, t_near, t_far)
    return t, (t_near <= t_far) & (t_far > T_MIN) & (t > T_MIN)


def _albedo(tex, q, center):
    """Procedural albedo at hit points ``q`` of the primitive at ``center``."""
    v = lambda rgb: torch.tensor(rgb, dtype=q.dtype, device=q.device)   # noqa: E731
    d = q - center
    if tex == "stripes":
        band = torch.remainder(torch.floor(torch.atan2(d[..., 2], d[..., 0]) / math.pi * 6), 2) >= 1
        return torch.where(band[..., None], v([0.85, 0.20, 0.15]), v([0.95, 0.55, 0.10]))
    if tex in _BANDS:
        axes, per, odd, even = _BANDS[tex]
        u = sum(torch.floor(d[..., a] * per) for a in axes)
        return torch.where((torch.remainder(u, 2) >= 1)[..., None], v(odd), v(even))
    return v(_FLAT[tex]).expand_as(q)


def trace(o: torch.Tensor, d: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Shade rays ``o``, ``d`` (N, 3), ``d`` unit: (N, 3) in [0, 1], in
    ``o``'s dtype on ``o``'s device."""
    kw = dict(dtype=o.dtype, device=o.device)
    big = torch.tensor(1e30, **kw)
    prims = []          # (t or 1e30 where missed, geometry, texture, k_spec, spec_exp)
    for c, r, tex, ks, ex in scene.spheres:
        c = torch.tensor(c, **kw)
        t, ok = _sphere_t(o, d, c, r)
        prims.append((torch.where(ok, t, big), ("sphere", c, r), tex, ks, ex))
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
    for c, h, tex, ks, ex in scene.boxes:
        c, h = torch.tensor(c, **kw), torch.tensor(h, **kw)
        t, ok = _box_t(o, inv, c, h)
        prims.append((torch.where(ok, t, big), ("box", c, h), tex, ks, ex))
    if scene.ground_r > 0:
        dy = d[..., 1]
        t = torch.where(dy.abs() > 1e-9, (GROUND_Y - o[..., 1]) / dy, big)
        pg = o + d * t[..., None]
        ok = (t > T_MIN) & (pg[..., 0] ** 2 + pg[..., 2] ** 2 < scene.ground_r ** 2)
        prims.append((torch.where(ok, t, big), ("ground",), None, 0.05, 32.0))

    t_hit, idx = torch.stack([p[0] for p in prims], -1).min(-1)
    hit = t_hit < 1e29
    p = o + d * torch.where(hit, t_hit, torch.zeros_like(t_hit))[..., None]

    n, albedo = torch.zeros_like(p), torch.zeros_like(p)
    k_spec = torch.zeros_like(t_hit)
    s_exp = torch.full_like(t_hit, 32.0)
    for i, (_, geom, tex, ks, ex) in enumerate(prims):
        m = (idx == i) & hit
        if geom[0] == "sphere":
            ni = (p - geom[1]) / geom[2]
            ai = _albedo(tex, p, geom[1])
        elif geom[0] == "box":
            q = (p - geom[1]) / geom[2]
            ax = q.abs().argmax(-1)
            ni = torch.sign(q) * (torch.arange(3, device=o.device) == ax[..., None])
            ai = _albedo(tex, p, geom[1])
        else:
            ni = torch.tensor([0.0, 1.0, 0.0], **kw).expand_as(p)
            band = torch.remainder(torch.floor(p[..., 0] / 0.4) + torch.floor(p[..., 2] / 0.4),
                                   2) >= 1
            ai = torch.where(band[..., None], torch.tensor([0.72, 0.72, 0.70], **kw),
                             torch.tensor([0.28, 0.28, 0.32], **kw))
        n = torch.where(m[..., None], ni.to(p.dtype), n)
        albedo = torch.where(m[..., None], ai, albedo)
        k_spec = torch.where(m, torch.tensor(ks, **kw), k_spec)
        s_exp = torch.where(m, torch.tensor(ex, **kw), s_exp)

    # shadow: any occluder along the light from p + eps * n
    light = torch.tensor(LIGHT, **kw)
    po = p + 1e-3 * n
    dl = light.expand_as(po)
    occ = torch.zeros_like(hit)
    for c, r, *_ in scene.spheres:
        occ |= _sphere_t(po, dl, torch.tensor(c, **kw), r)[1]
    invl = 1.0 / torch.where(light.abs() > 1e-12, light, torch.full_like(light, 1e-12))
    for c, h, *_ in scene.boxes:
        occ |= _box_t(po, invl, torch.tensor(c, **kw), torch.tensor(h, **kw))[1]
    lit = (hit & ~occ).to(o.dtype)

    lam = (n * light).sum(-1).clamp(0, 1)
    hv = light - d
    hv = hv / torch.linalg.norm(hv, dim=-1, keepdim=True).clamp_min(1e-9)
    spec = (n * hv).sum(-1).clamp(0, 1) ** s_exp
    rgb = albedo * (AMBIENT + 0.85 * lam * lit)[..., None] + (k_spec * spec * lit)[..., None]
    rgb = torch.where(hit[..., None], rgb, torch.tensor(scene.background, **kw))
    return rgb.clamp(0.0, 1.0)


def render_view(c2w: np.ndarray, size: int, scene: Scene, device="cpu",
                dtype=torch.float32) -> np.ndarray:
    """One size x size view from camera-to-world ``c2w``: the script's
    pixel rays (+z forward, the reference focal), traced in ``dtype`` on
    ``device``.  (size, size, 3) float32 numpy."""
    kw = dict(dtype=dtype, device=device)
    focal = derive_focal(CAMERA_ANGLE_X, size)
    ys, xs = torch.meshgrid(torch.arange(size, **kw), torch.arange(size, **kw), indexing="ij")
    c = size / 2
    d = torch.stack([(xs - c) / focal, (ys - c) / focal, torch.ones_like(xs)], -1)
    d = d @ torch.tensor(np.asarray(c2w)[:3, :3].T, **kw)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.tensor(np.asarray(c2w)[:3, 3], **kw).expand_as(d)
    img = trace(o.reshape(-1, 3), d.reshape(-1, 3), scene)
    return img.reshape(size, size, 3).float().cpu().numpy()


def camera_rig(n_train: int, n_test: int, seed: int = 0):
    """Upper-hemisphere orbits: train views azimuth-uniform with jittered
    elevation and radius, test views on two elevation rings offset by half
    a step in azimuth (never on a train view)."""
    rng = np.random.default_rng(seed)
    target = np.array([0.0, -0.2, 0.0])
    views = {"train": [], "test": []}
    for i in range(n_train):
        th = 2 * np.pi * i / n_train + rng.uniform(-0.02, 0.02)
        el = np.deg2rad(rng.uniform(12.0, 48.0))
        r = 4.0 + rng.uniform(-0.15, 0.15)
        eye = np.array([r * np.cos(el) * np.cos(th), r * np.sin(el), r * np.cos(el) * np.sin(th)])
        views["train"].append(look_at_pose(eye, target))
    for i in range(n_test):
        th = 2 * np.pi * (i + 0.5) / n_test
        el = np.deg2rad(25.0 if i % 2 == 0 else 38.0)
        eye = np.array([4.0 * np.cos(el) * np.cos(th), 4.0 * np.sin(el),
                        4.0 * np.cos(el) * np.sin(th)])
        views["test"].append(look_at_pose(eye, target))
    return views


def config_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m sfm_nerf_tpu_torch.cli.synth_scene")
    p.add_argument("--out", default="Phase2/nerf_synthetic/synth800")
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--n_train", type=int, default=100)
    p.add_argument("--n_test", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene", default="spheres", choices=["spheres", "chair"])
    p.add_argument("--background", default="black", choices=["black", "white"])
    p.add_argument("--trace_backend", default="torch", choices=["torch", "numpy"],
                   help="torch: float32 on --device; numpy: float64 on the CPU")
    p.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"])
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    from sfm_nerf_tpu_torch.io.png import write_png

    args = config_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.trace_backend == "numpy":
        device, dtype = torch.device("cpu"), torch.float64
    else:
        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is visible; pass --device cpu")
        device, dtype = torch.device(args.device), torch.float32
    scene = Scene()
    scene.set_scene(args.scene)
    scene.set_background(args.background)
    views = camera_rig(args.n_train, args.n_test, args.seed)
    ms = []
    for mode, poses in views.items():
        frames = []
        os.makedirs(os.path.join(args.out, mode), exist_ok=True)
        for i, c2w in enumerate(poses):
            t0 = time.perf_counter()
            img = render_view(c2w, args.size, scene, device, dtype)   # ends in a host copy
            ms.append((time.perf_counter() - t0) * 1e3)
            rel = f"{mode}/r_{i}"
            write_png(os.path.join(args.out, rel + ".png"), (img * 255 + 0.5).astype(np.uint8))
            frames.append({"file_path": "./" + rel, "transform_matrix": c2w.tolist()})
            print(f"{mode} {i + 1}/{len(poses)}", flush=True)
        with open(os.path.join(args.out, f"transforms_{mode}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    print(f"wrote {args.out}")
    return {"out": args.out, "views": len(ms), "ms_per_view": ms}


if __name__ == "__main__":
    main()
