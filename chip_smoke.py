#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, started
together), then drives the serving and training paths through the entry
points a user calls, at full width on the committed checkpoints and
datasets (800x800 frames, 256 samples per ray; 8,192 rays x 256 samples per
training step; hierarchical: 256 coarse + 128 importance samples):

1. device: the card's name and power limit;
2. serve: ``cli.nerf --mode test`` on synth800 (5 test views through K1,
   fused_render_rays), per-view ms, PSNR/SSIM against the ground truth,
   peak memory; K1 held against its plain version on 16,384 rays of a view,
   the kernel's full frame against the float32 nn.Module path and against
   a second launch on the same frame (bit-equal);
3. aux: one view through make_render_image_aux (K5,
   fused_render_rays_weights), weights held against the plain version,
   beside the plain version's own float32-vs-float64 spread;
4. gif: ``cli.nerf --mode gif`` (2 legacy-compositor frames, then one
   chair800 frame on a white background), each held against the plain
   version;
5. train: ``cli.nerf --mode train`` on synth800 from a seeded init, K2
   (fused_mse_loss) as the step: ms per step, train rays/s, the logged
   losses (the last ten must average below the first ten), peak memory;
   then a second run that resumes from the saved checkpoint for a few steps
   and renders the validation views through K1;
6. train_two_kernel: a few steps through K3 (fused_render_train: the
   render kernel compiled with TB as the forward, the split step under
   autograd's cotangent as the backward): ms per step, train rays/s, peak
   memory;
7. train_kernels: on one real batch, K2 (the split step: per group of
   RAY_GROUP rays the render kernel's STASH sweep, the reverse walk, the
   weight GEMM) and K3 against their plain versions (rgb, loss, every grad
   tensor; K3's backward under a cotangent that is not the MSE's, held in
   either summation order of the plain version), K2's and K3's backward's
   time per launch class, K2's rgb and K3's forward's rgb against K1's
   (bit-equal), K3's tb against the tb its backward's forward sweep
   recomputes (bit-equal), K3's backward under the MSE cotangent against K2
   (bit-equal), K2 and K3's backward twice (bit-equal), peak memory, and the
   eager float32 nn.Module autograd step as the practical yardstick;
8. train_hier: ``cli.nerf --mode train --n_importance 128``: a coarse/fine
   pair from a seeded init, each step one K4 (fused_mse_loss_weights) launch
   on the 256 coarse depths and one K2 launch on the sorted union of 384;
   then a resumed run whose validation views render through the
   hierarchical route (K5 coarse pass, K1 fine pass);
9. serve_hier: ``cli.nerf --mode test --n_importance 128`` on that pair (2
   views), and one view through make_render_image_aux (K5 twice);
10. hier_kernels: on one real batch, K4 against its plain version (rgb,
   loss, weights, every grad tensor), against K2 (bit-equal rgb and grads),
   against itself and against K5 (bit-equal rgb and weights), its time per
   launch class, and K2 at 384 samples against its plain version on the
   shared union; on
   16,384 rays of a view the hierarchical render route stage by stage
   against the plain route; the full kernel frame against the float32
   nn.Module hierarchical frame; the times of the frame's parts;
11. kernels: the render kernel's shared memory, its L2 weight traffic per
   frame by arithmetic and a cuBLAS yardstick for its products; then one
   JSON line with every kernel's launches on its path, its error against
   the plain version, its time at the main-path shape beside the plain
   version's and the card's bound;
12. sfm: ``cli.sfm`` on the card at SfMConfig's defaults (50,000 F and
   10,000 PnP hypotheses, 2 x 50 BA steps) plus track merging, on a
   12-camera ring this script writes (4,000 points, 0.5 px noise, 10% of
   the match rows outliers): stage seconds, registered cameras, BA error,
   pose error against the ground truth, peak memory; then its NeRF export
   read back through io/blender.py;
13. sfm_ops: F-RANSAC, PnP RANSAC and five BA steps on the card against
   the same calls on the CPU, given the same draws;
14. sfm_scale: the same pipeline on 48 cameras x 8,000 points.

Each kernel path runs with the launch counters set to 0 just before it and
read just after; a path that did not launch its kernel fails the run.  Every
phase prints one JSON line; the last line is the result.  Exits non-zero
without a result when no card is visible, when the package is missing, or
when any phase fails.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "chip_smoke")   # artifacts (git-ignored)
SUBSET = 16384           # rays held against the plain version
RGB_TOL = 1e-2           # per-ray max |kernel - plain|: bf16 rounding flips
# per-sample weights: where a ray meets a sharp surface one or two samples
# carry most of its weight, and a bf16 rounding flip of a hidden activation
# (the kernel and cuBLAS sum in other orders) moves some weight to the
# neighbouring sample or past the surface.  The plain version run in float64
# on the same rays flips other roundings and measures how far the function
# itself moves so; the largest single weight error may reach W_TOL or that
# float32-vs-float64 spread, whichever is larger.  The bulk is held too (at
# most W_BULK_FRAC of the weights more than W_TOL_BULK off), and so are the
# maps the weights feed: acc = sum(w) and depth / far, each at PSNR >= 40 dB.
W_TOL, W_TOL_BULK, W_BULK_FRAC = 1e-2, 1e-3, 1e-4
PSNR_PLAIN = 40.0        # dB, kernel vs plain version (rgb, acc, depth)
PSNR_MODULE = 40.0       # dB, kernel frame vs float32 nn.Module frame
PSNR_GT_FLOOR = 25.0     # dB vs ground truth: catches a broken frame only
# training kernels against their plain versions, per grad tensor: relative
# error of the tensor's norm and max abs error over the tensor's max abs.
# bf16 rounding flips of hidden activations and cotangents (the kernel's WMMA
# and cuBLAS sum in other orders) move the grads; the plain version run in
# float64 on the same batch flips other roundings, and its distance from the
# float32 plain version is the second witness: a tensor may be off by the
# limit or by that spread, whichever is larger.
GRAD_REL_TOL, GRAD_MAX_TOL = 2e-2, 5e-2
LOSS_REL_TOL = 1e-3      # kernel loss vs plain version's loss
TRAIN_STEPS, RESUME_STEPS, K3_STEPS = 100, 12, 12
N_IMPORTANCE = 128       # importance samples of the hierarchical phases
PEAK_BF16 = 989e12       # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---- Phase 1 SfM -----------------------------------------------------------
SFM_CAMS, SFM_POINTS, SFM_WINDOW = 12, 4000, 4
SCALE_CAMS, SCALE_POINTS, SCALE_WINDOW, SCALE_F_ITERS = 48, 8000, 8, 4000
SFM_NOISE_PX, SFM_OUTLIER_FRAC = 0.5, 0.10
SFM_MEAN_PX, SFM_ROT_DEG = 1.0, 0.1   # final BA mean error, median rotation error
F_REL_TOL = 1e-8                      # F on the card vs on the CPU, relative
BA_PIXEL_TOL = 1e-6                   # BA on the card vs the CPU: seen pixels


def write_sfm_dataset(out_dir, n_cams, n_points, window, noise_px=SFM_NOISE_PX,
                      outlier_frac=SFM_OUTLIER_FRAC, width=800, height=600, seed=0):
    """A reference-format SfM dataset (calibration.txt, matching{i}.txt,
    {i}.png) in the format of tests/util_synthetic.py's
    write_reference_format_dataset, written without cv2: cameras on a ring
    looking inward, each point seen by a window of consecutive cameras,
    pixel noise, and ``outlier_frac`` of the match rows moved to uniform
    pixels.  Returns the ground truth (K, Rs, Cs, points)."""
    import numpy as np

    from sfm_nerf_tpu_torch.io.png import write_png

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    points = rng.uniform(-1.5, 1.5, (n_points, 3))
    Rs, Cs = [], []
    for i in range(n_cams):
        th = 2 * np.pi * i / n_cams
        C = np.array([6 * np.cos(th), 0.4 * np.sin(3 * th), 6 * np.sin(th)])
        fwd = -C / np.linalg.norm(C)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        Rs.append(np.stack([right, np.cross(fwd, right), fwd]))
        Cs.append(C)
    Rs, Cs = np.stack(Rs), np.stack(Cs)
    Xh = np.hstack([points, np.ones((n_points, 1))])
    obs = np.zeros((n_cams, n_points, 2))
    ok = np.zeros((n_cams, n_points), bool)
    for c in range(n_cams):
        x = Xh @ (K @ Rs[c] @ np.hstack([np.eye(3), -Cs[c][:, None]])).T
        z = x[:, 2]
        x = x[:, :2] / np.maximum(z[:, None], 1e-9) + rng.normal(0, noise_px, (n_points, 2))
        obs[c] = x
        ok[c] = (z > 0.2) & (x[:, 0] >= 0) & (x[:, 0] < width) & (x[:, 1] >= 0) \
            & (x[:, 1] < height)
    start = rng.integers(0, n_cams, n_points)
    for p in range(n_points):
        win = np.zeros(n_cams, bool)
        win[(start[p] + np.arange(window)) % n_cams] = True
        ok[:, p] &= win
    with open(os.path.join(out_dir, "calibration.txt"), "w") as fc:
        for row in K:
            fc.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    yy, xx = np.mgrid[0:height, 0:width]
    img = np.stack([xx * 255 // width, yy * 255 // height,
                    np.full_like(xx, 128)], -1).astype(np.uint8)
    for i in range(1, n_cams + 1):
        write_png(os.path.join(out_dir, f"{i}.png"), img)
    n_rows = n_out = 0
    for i in range(1, n_cams):
        lines = []
        for p in np.flatnonzero(ok[i - 1]):
            js = [j for j in range(i + 1, n_cams + 1) if ok[j - 1, p]]
            if not js:
                continue
            u, v = obs[i - 1, p]
            toks = [str(len(js) + 1), "128", "128", "128", f"{u:.4f}", f"{v:.4f}"]
            for j in js:
                uj, vj = obs[j - 1, p]
                if rng.random() < outlier_frac:
                    uj, vj = rng.uniform(0, width), rng.uniform(0, height)
                    n_out += 1
                toks += [str(j), f"{uj:.4f}", f"{vj:.4f}"]
            lines.append(" ".join(toks))
            n_rows += len(js)
        with open(os.path.join(out_dir, f"matching{i}.txt"), "w") as fm:
            fm.write(f"nFeatures: {len(lines)}\n" + "\n".join(lines) + "\n")
    return {"K": K, "Rs": Rs, "Cs": Cs, "points": points, "obs": obs, "ok": ok,
            "match_rows": n_rows, "outlier_rows": n_out}


def pose_errors(camera_info, gt):
    """Registered poses against the ground truth after a similarity
    alignment of the camera centres (Umeyama): median and max rotation
    error in degrees, median centre error in ground-truth units (the ring's
    radius is 6)."""
    import numpy as np

    ids = sorted(camera_info)
    src = np.stack([np.asarray(camera_info[i]["C"]).reshape(3) for i in ids])
    dst = gt["Cs"][[i - 1 for i in ids]]
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(ids)
    U, S, Vt = np.linalg.svd(cov)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    Rs_ = U @ D @ Vt                          # sfm world -> gt world
    s = np.trace(np.diag(S) @ D) / ((src - mu_s) ** 2).sum(1).mean()
    t = mu_d - s * Rs_ @ mu_s
    rot, cen = [], []
    for i, c in zip(ids, src):
        R_al = np.asarray(camera_info[i]["R"]) @ Rs_.T      # in gt coordinates
        cosang = (np.trace(R_al.T @ gt["Rs"][i - 1]) - 1) / 2
        rot.append(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
        cen.append(np.linalg.norm(s * Rs_ @ c + t - gt["Cs"][i - 1]))
    return {"rot_err_deg_median": float(np.median(rot)), "rot_err_deg_max": float(np.max(rot)),
            "centre_err_median": float(np.median(cen)), "centre_err_max": float(np.max(cen)),
            "scale": float(s)}


def run_sfm_phases(phase, out_root):
    """The Phase 1 phases: sfm (cli.sfm at the SfMConfig defaults on a
    12-camera ring, then its NeRF export read back), sfm_ops (F-RANSAC,
    PnP RANSAC and five BA steps on the card against the same calls on the
    CPU, given the same draws), sfm_scale (48 cameras x 8,000 points)."""
    import numpy as np
    import torch

    from sfm_nerf_tpu_torch.cli import sfm as cli_sfm
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset
    from sfm_nerf_tpu_torch.ops import ba as ba_ops
    from sfm_nerf_tpu_torch.ops import epipolar as ep
    from sfm_nerf_tpu_torch.ops import pnp as pnp_ops

    dev = torch.device("cuda")
    state = {}

    def reconstruct(tag, n_cams, n_points, window, extra):
        data = os.path.join(out_root, f"{tag}_data")
        out = os.path.join(out_root, f"{tag}_out")
        shutil.rmtree(data, ignore_errors=True)
        t0 = time.time()
        gt = write_sfm_dataset(data, n_cams, n_points, window)
        write_s = time.time() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = cli_sfm.main(["--data_path", data, "--num_images", str(n_cams),
                            "--output_dir", out, "--merge_tracks", *extra])
        torch.cuda.synchronize()
        wall = time.time() - t0
        st = res["stats"]
        errs = pose_errors(res["camera_info"], gt)
        rec = {"cams": n_cams, "points": n_points, "window": window,
               "match_rows": gt["match_rows"], "outlier_rows": gt["outlier_rows"],
               "dataset_write_s": round(write_s, 2), "wall_s": round(wall, 2),
               "stage_seconds": st["stage_seconds"], "registered": st["n_registered"],
               "points_3d": st["n_points_total"],
               "ba_mean_px": st["ba"]["final_err_px"]["mean"],
               "ba_median_px": st["ba"]["final_err_px"]["median"],
               "ba_rms_px": [st["ba"]["rms_px_before"], st["ba"]["rms_px_after"]],
               **errs, "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
               "device": st["device"]}
        if st["device"] != "cuda":
            raise AssertionError(f"{tag}: ran on {st['device']}")
        if (rec["registered"] != n_cams or rec["ba_mean_px"] >= SFM_MEAN_PX
                or rec["rot_err_deg_median"] >= SFM_ROT_DEG):
            raise AssertionError(f"{tag}: {rec}")
        return data, gt, res, rec

    def sfm():
        exp = os.path.join(out_root, "sfm_nerf")
        data, gt, res, rec = reconstruct(
            "sfm", SFM_CAMS, SFM_POINTS, SFM_WINDOW, ["--export_nerf", exp])
        images, poses, cam = load_blender_dataset(exp, "train")
        ids = sorted(res["camera_info"])
        c2w_err = max(float(np.abs(poses[k, :3, 3] - res["camera_info"][i]["C"]).max())
                      for k, i in enumerate(ids))
        if len(images) != len(ids) or c2w_err > 1e-5 or not cam.near < cam.far:
            raise AssertionError(f"sfm export: {len(images)} frames, c2w err {c2w_err}")
        state.update(data=data, gt=gt, res=res)
        emit("sfm", **rec, export={"frames": len(images), "near": cam.near, "far": cam.far,
                                   "c2w_centre_max_err": c2w_err})

    def sfm_ops():
        gt = state["gt"] if "gt" in state else write_sfm_dataset(
            os.path.join(out_root, "sfm_data"), SFM_CAMS, SFM_POINTS, SFM_WINDOW)
        data = os.path.join(out_root, "sfm_data")
        from sfm_nerf_tpu_torch.io.sfm_data import parse_matching_files

        matches, _, _ = parse_matching_files(data, SFM_CAMS)
        m = matches[(1, 2)]
        rng = np.random.default_rng(1)
        n_iters, chunk = 8192, 1024
        total = -(-n_iters // chunk) * chunk
        samples = np.stack([rng.permutation(len(m))[:8] for _ in range(total)])
        # a later copy of a row scores the same: the first must win
        samples[total - 1] = samples[7]
        out, times = {}, {}
        sides = (("cuda", dev), ("cpu", torch.device("cpu")))
        for name, d in sides:
            t = lambda a: torch.as_tensor(a, device=d)
            t0 = time.time()
            r = ep.ransac_fundamental(t(m[:, 0:2]), t(m[:, 2:4]), n_iters=n_iters,
                                      samples=t(samples))
            out[name] = [x.cpu().numpy() for x in r]
            times[name] = time.time() - t0
        F_c, F_h = out["cuda"][0], out["cpu"][0]
        f_rel = float(np.abs(F_c - F_h).max() / np.abs(F_h).max())
        same_f = (int(out["cuda"][3]) == int(out["cpu"][3])
                  and np.array_equal(out["cuda"][1], out["cpu"][1]))
        # ties: argmax on the card takes the first of equal scores
        ties = torch.zeros(4, 50176, device=dev, dtype=torch.float64)
        ties[:, [5, 17, 40000]] = 1.0
        first_tie = torch.argmax(ties, dim=1).tolist() == [5, 5, 5, 5]
        dup_ok = int(out["cuda"][3]) != total - 1
        # PnP RANSAC on camera 3's view of the ground-truth points
        cam = 2
        vis = np.flatnonzero(gt["ok"][cam])
        X3 = gt["points"][vis]
        x2 = gt["obs"][cam, vis].copy()
        bad = rng.random(len(vis)) < SFM_OUTLIER_FRAC
        x2[bad] = rng.uniform([0, 0], [800, 600], (int(bad.sum()), 2))
        p_total = 2048
        psamp = np.stack([rng.permutation(len(vis))[:6] for _ in range(p_total)])
        pout = {}
        for name, d in sides:
            t = lambda a: torch.as_tensor(a, device=d)
            t0 = time.time()
            r = pnp_ops.pnp_ransac(t(X3), t(x2), t(gt["K"]), samples=t(psamp))
            pout[name] = [x.cpu().numpy() for x in r]
            times[f"pnp_{name}"] = time.time() - t0
        pnp_same = bool(np.array_equal(pout["cuda"][2], pout["cpu"][2]))
        pnp_rel = float(np.abs(pout["cuda"][1] - pout["cpu"][1]).max()
                        / np.abs(pout["cpu"][1]).max())
        # five BA steps from perturbed ground truth over every camera
        from sfm_nerf_tpu_torch.ops.linalg import rotation_to_rvec

        rv = rotation_to_rvec(torch.as_tensor(gt["Rs"])).numpy()
        cams = np.concatenate([rv, -np.einsum("nij,nj->ni", gt["Rs"], gt["Cs"])], 1)
        cams = cams + rng.normal(0, 1e-3, cams.shape)
        pts = gt["points"] + rng.normal(0, 1e-2, gt["points"].shape)
        bout = {}
        for name, d in sides:
            t = lambda a: torch.as_tensor(a, device=d)
            t0 = time.time()
            r = ba_ops.bundle_adjust(t(gt["K"]), t(cams), t(pts), t(gt["obs"]),
                                     t(gt["ok"].astype(np.float64)), n_iters=5)
            bout[name] = [x.cpu().numpy() for x in r]
            times[f"ba_{name}"] = time.time() - t0
        # the parameters are free up to a similarity, along which rounding
        # moves them; the cost and every seen pixel are not
        par_rel = max(float(np.abs(bout["cuda"][k] - bout["cpu"][k]).max()
                            / np.abs(bout["cpu"][k]).max()) for k in (0, 1))
        cost_rel = abs(float(bout["cuda"][2]) / float(bout["cpu"][2]) - 1)
        proj = {k: ba_ops._lanes(ba_ops._observe, torch.as_tensor(v[0]), torch.as_tensor(v[1]),
                                 torch.as_tensor(gt["K"])).numpy() for k, v in bout.items()}
        pix = float(np.abs(proj["cuda"] - proj["cpu"])[gt["ok"]].max())
        rec = {"ransac": {"matches": len(m), "hypotheses": total,
                          "best_iter": int(out["cuda"][3]), "same_winner_and_inliers": same_f,
                          "n_inliers": int(out["cuda"][2]), "F_rel_err": f_rel,
                          "later_copy_of_row_7_lost": dup_ok, "argmax_first_tie": first_tie,
                          "cuda_s": times["cuda"], "cpu_s": times["cpu"]},
               "pnp": {"points": len(vis), "hypotheses": p_total,
                       "same_inliers": pnp_same, "C_rel_err": pnp_rel,
                       "n_inliers": int(pout["cuda"][3]),
                       "cuda_s": times["pnp_cuda"], "cpu_s": times["pnp_cpu"]},
               "ba": {"cams": SFM_CAMS, "points": SFM_POINTS, "iters": 5,
                      "params_rel_err": par_rel, "cost_rel_err": cost_rel,
                      "seen_pixel_max_err": pix,
                      "cost": [float(bout["cuda"][3]), float(bout["cuda"][2])],
                      "cuda_s": times["ba_cuda"], "cpu_s": times["ba_cpu"]}}
        if not (same_f and f_rel <= F_REL_TOL and dup_ok and first_tie and pnp_same
                and pnp_rel <= F_REL_TOL and cost_rel <= 1e-9 and pix <= BA_PIXEL_TOL):
            raise AssertionError(f"sfm_ops: {rec}")
        emit("sfm_ops", **rec)

    def sfm_scale():
        _, _, _, rec = reconstruct(
            "sfm_scale", SCALE_CAMS, SCALE_POINTS, SCALE_WINDOW,
            ["--ransac_iters", str(SCALE_F_ITERS), "--ba_interval", "12"])
        emit("sfm_scale", **rec)

    phase(sfm)
    phase(sfm_ops)
    phase(sfm_scale)


def main():
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from sfm_nerf_tpu_torch.cli import nerf as cli
    from sfm_nerf_tpu_torch.config import NeRFPipelineConfig, RenderConfig
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset, load_camera_info
    from sfm_nerf_tpu_torch.io.png import read_png
    from sfm_nerf_tpu_torch.kernels import _build
    from sfm_nerf_tpu_torch.kernels import fused_render as fr
    from sfm_nerf_tpu_torch.kernels import fused_train as ft
    from sfm_nerf_tpu_torch.models.convert import params_from_jax
    from sfm_nerf_tpu_torch.ops.rays import image_rays, sample_ray_batch
    from sfm_nerf_tpu_torch.ops.render import (
        composite, merge_sorted, sample_pdf, stratified_samples,
    )
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt
    from sfm_nerf_tpu_torch.train.nerf_trainer import (
        make_render_image, make_render_image_aux,
    )
    from sfm_nerf_tpu_torch.utils.metrics import psnr, ssim

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failed = []

    def phase(fn):
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(fn.__name__)
            emit(fn.__name__, ok=False)

    def event_ms(fn, reps=1):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            out = fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps, out

    def compare(name, got, ref, weights=None, z=None):
        """Kernel output vs plain version: rgb per-ray max error and PSNR,
        and for K5 the weights and the acc and depth maps they give; raises
        past the tolerances.  Returns a dict of the errors."""
        r = {"rgb_max_abs": (got - ref).abs().max().item(), "psnr": psnr(got, ref)}
        ok = r["rgb_max_abs"] <= RGB_TOL and r["psnr"] >= PSNR_PLAIN
        if weights is not None:
            w, wr, w64 = weights
            ew = (w - wr).abs()
            e64 = (wr.double() - w64).abs()
            far = z.max()
            r.update(w_max_abs=ew.max().item(), w_above_1e_3=int((ew > W_TOL_BULK).sum()),
                     w_count=ew.numel(),
                     plain_f32_vs_f64_w_max_abs=e64.max().item(),
                     plain_f32_vs_f64_w_above_1e_3=int((e64 > W_TOL_BULK).sum()),
                     acc_max_abs=(w.sum(-1) - wr.sum(-1)).abs().max().item(),
                     acc_psnr=psnr(w.sum(-1), wr.sum(-1)),
                     depth_psnr=psnr((w * z).sum(-1) / far, (wr * z).sum(-1) / far))
            del e64
            w_tol = max(W_TOL, r["plain_f32_vs_f64_w_max_abs"])
            ok = ok and (r["w_max_abs"] <= w_tol
                         and r["w_above_1e_3"] <= W_BULK_FRAC * ew.numel()
                         and r["acc_psnr"] >= PSNR_PLAIN and r["depth_psnr"] >= PSNR_PLAIN)
        if not ok:
            raise AssertionError(f"{name}: kernel vs plain {r}")
        return r

    def plain_f64_weights(packed, o, d, z, rcfg):
        return fr.fused_render_rays_reference(packed, o.double(), d.double(), z.double(),
                                              rcfg, emit_weights=True)[1]

    def check_plain(name, packed, o, d, z, rcfg, weights=False):
        """Kernel vs plain version on SUBSET rays spread over the frame."""
        i = torch.linspace(0, o.shape[0] - 1, SUBSET, device=dev).long()
        args = (packed, o[i], d[i], z[i], rcfg)
        if weights:
            rgb, w = fr.fused_render_rays_weights(*args)
            rr, wr = fr.fused_render_rays_reference(*args, emit_weights=True)
            return compare(name, rgb, rr, (w, wr, plain_f64_weights(*args)), z[i])
        rgb = fr.fused_render_rays(*args)
        return compare(name, rgb, fr.fused_render_rays_reference(*args))

    def split_times(run):
        """One more call of a split-step wrapper with its launches timed: ms
        per launch class (forward, reverse, gradient, reduction)."""
        ft.time_launches(True)
        run()
        times = ft.launch_times()
        ft.time_launches(False)
        return {k: round(v, 3) for k, v in times.items()}

    def grads_cmp(name, packed_, got, ref, f64, tc=None):
        """A kernel's (gw, gb) against the plain version's, per parameter
        tensor: within GRAD_REL_TOL of the tensor's norm and GRAD_MAX_TOL of
        its largest value, or within the plain version's float32-vs-float64
        spread where that is larger; raises past them.  ``tc``: the plain
        version's grads with its forward summed in the render kernel's
        order (tc_order); a tensor may meet the rule against those in place
        of the default order's.  Returns (the worst of each figure against
        the default order, each tensor's figures, the largest absolute
        error)."""
        got, ref = ft.unpack_grads(packed_, *got), ft.unpack_grads(packed_, *ref)
        f64 = ft.unpack_grads(packed_, *(t.float() for t in f64))
        refs = [ref] + ([ft.unpack_grads(packed_, *tc)] if tc is not None else [])
        worst = {"rel": 0.0, "max": 0.0, "spread_rel": 0.0, "spread_max": 0.0}
        per = {}

        def figures(k, r):
            nr, mr = r[k].norm().item(), r[k].abs().max().item()
            e, e64 = got[k] - r[k], f64[k] - r[k]
            return {"rel": e.norm().item() / nr, "max": e.abs().max().item() / mr,
                    "spread_rel": e64.norm().item() / nr,
                    "spread_max": e64.abs().max().item() / mr}

        def within(row):
            return (row["rel"] <= max(GRAD_REL_TOL, row["spread_rel"])
                    and row["max"] <= max(GRAD_MAX_TOL, row["spread_max"]))

        for k in ref:
            rows = [figures(k, r) for r in refs]
            row = rows[0]
            per[k.replace("layers.", "")] = [float(f"{v:.3e}") for v in row.values()]
            if not any(within(r) for r in rows):
                raise AssertionError(f"{name}: grad {k} vs plain {rows}")
            worst = {m: max(worst[m], row[m]) for m in worst}
        return worst, per, max((got[k] - ref[k]).abs().max().item() for k in ref)

    # ---- 1. device -------------------------------------------------------
    t_start = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    sources = ("fused_render", "fused_train", "grad_gemm")
    _build.build_all(sources)
    build_s = time.time() - t0
    regs = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                   if "registers" in ln or "spill" in ln]
            for name in sources}
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=round(build_s, 3), ptxas=regs)

    data = os.path.join(REPO, "Phase2", "nerf_synthetic", "synth800") + "/"
    ckpt_root = os.path.join(REPO, "Phase2", "checkpoints")
    params, _ = ckpt.load_params_untyped(
        os.path.join(ckpt_root, "synth800", "final_model.ckpt.npz"))
    mcfg = ckpt.infer_model_config(params)
    model = params_from_jax(params, mcfg, dev).eval()
    images, poses, cam = load_blender_dataset(data, "test")
    H, W = images.shape[1:3]
    K = torch.as_tensor(cam.camera_matrix, device=dev)
    rcfg = RenderConfig(n_sample=256, near=2.0, far=6.0, perturb=False,
                        use_fused_kernel=True)
    cfg = NeRFPipelineConfig(model=mcfg, render=rcfg)
    packed = fr.pack_nerf_params(model, mcfg, torch.bfloat16)
    view = int(np.random.default_rng(0).choice(len(images), 5, replace=False)[0])
    pose = torch.as_tensor(poses[view], device=dev)
    o, d = image_rays(K, pose, H, W)
    z = stratified_samples(H * W, rcfg, None, dev)
    state = {}

    # ---- 2. serve: test mode through K1 ----------------------------------
    def serve():
        make_render_image(cfg)(model, K, pose, 64, 64)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fr.reset_launch_counts()
        records = cli.main([
            "--mode", "test", "--data_path", data, "--checkpoint_path", ckpt_root,
            "--images_path", os.path.join(OUT, "test"), "--n_sample", "256"])
        launches = dict(fr.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if launches["fused_render_rays"] < 1:
            raise AssertionError(f"serve path launched no K1: {launches}")
        if len(records) != 5 or min(r["psnr"] for r in records) < PSNR_GT_FLOOR:
            raise AssertionError(f"serve: views {records}")
        state["K1_launches"] = launches["fused_render_rays"]
        k1 = check_plain("K1", packed, o, d, z, rcfg)
        # the kernel's full frame against the float32 nn.Module path
        k_ms, frame = event_ms(lambda: fr.fused_render_rays(packed, o, d, z, rcfg))
        # rays go to warpgroups in a fixed order and nothing sums atomically
        if not torch.equal(frame, fr.fused_render_rays(packed, o, d, z, rcfg)):
            raise AssertionError("K1: two launches on the same frame differ")
        mod_cfg = NeRFPipelineConfig(model=mcfg, render=RenderConfig(
            n_sample=256, near=2.0, far=6.0, perturb=False, use_fused_kernel=False))
        mod_ms, mod = event_ms(lambda: make_render_image(mod_cfg)(model, K, pose, H, W))
        p_mod = psnr(frame.reshape(H, W, 3), mod)
        if p_mod < PSNR_MODULE:
            raise AssertionError(f"kernel vs nn.Module frame PSNR {p_mod:.2f} dB")
        gt = images[view]
        emit("serve", views=[{k: (round(v, 4) if isinstance(v, float) else v)
                              for k, v in r.items()} for r in records],
             launches=launches, peak_mem_gib=round(peak / 2**30, 3),
             kernel_vs_plain={"rays": SUBSET, **k1}, frame_twice_bit_equal=True,
             kernel_vs_module={"psnr": round(p_mod, 2), "module_ms": round(mod_ms, 2),
                               "kernel_ms": round(k_ms, 2)},
             frame_vs_gt={"view": view, "psnr": round(psnr(frame.reshape(H, W, 3), gt), 3),
                          "ssim": round(ssim(frame.reshape(H, W, 3), gt), 4)})

    # ---- 3. aux: --save_depth semantics through K5 -----------------------
    def aux():
        fr.reset_launch_counts()
        rgb, depth, disp, acc = make_render_image_aux(cfg)(model, K, pose, H, W)
        torch.cuda.synchronize()
        launches = dict(fr.LAUNCHES)
        if launches["fused_render_rays_weights"] < 1:
            raise AssertionError(f"aux path launched no K5: {launches}")
        state["K5_launches"] = launches["fused_render_rays_weights"]
        if not (acc.min().item() >= -1e-6 and acc.max().item() <= 1 + 1e-5):
            raise AssertionError(f"acc outside [0, 1]: {acc.min().item()}..{acc.max().item()}")
        if not all(bool(torch.isfinite(t).all()) for t in (rgb, depth, acc)):
            raise AssertionError("aux maps not finite")
        k5 = check_plain("K5", packed, o, d, z, rcfg, weights=True)
        emit("aux", launches=launches, acc=[acc.min().item(), acc.max().item()],
             depth_mean=depth.mean().item(),
             kernel_vs_plain={"rays": SUBSET, **k5})

    # ---- 4. gif: turntable frames through K1 -----------------------------
    def gif():
        out = {}
        for name, extra, variant_kw in (
            ("synth800_legacy", ["--orbit", "lookat", "--orbit_elev", "30",
                                 "--orbit_target", "0,-0.2,0", "--n_frames", "2"],
             dict(near=1.0, far=10.0, variant="legacy")),
            ("chair800_white", ["--orbit", "lookat", "--orbit_elev", "30",
                                "--orbit_target", "0,-0.2,0", "--train_variant",
                                "--white_bkgd", "--near", "2", "--far", "6",
                                "--n_frames", "1"],
             dict(near=2.0, far=6.0, variant="train", white_background=True)),
        ):
            family = name.split("_")[0]
            fr.reset_launch_counts()
            records = cli.main([
                "--mode", "gif", "--data_path",
                os.path.join(REPO, "Phase2", "nerf_synthetic", family) + "/",
                "--checkpoint_path", ckpt_root, "--images_path", os.path.join(OUT, name),
                "--no_perturb", "--n_sample", "256", *extra])
            launches = dict(fr.LAUNCHES)
            if launches["fused_render_rays"] < len(records) or not records:
                raise AssertionError(f"gif {name}: launches {launches}, {len(records)} frames")
            p, _ = ckpt.load_params_untyped(
                os.path.join(ckpt_root, family, "final_model.ckpt.npz"))
            mc = ckpt.infer_model_config(p)
            pk = fr.pack_nerf_params(params_from_jax(p, mc, dev), mc, torch.bfloat16)
            rc = RenderConfig(n_sample=256, perturb=False, **variant_kw)
            cam_g = load_camera_info(os.path.join(REPO, "Phase2", "nerf_synthetic", family),
                                     "train")
            Kg = torch.as_tensor(cam_g.camera_matrix, device=dev)
            errs = []
            for r in records:
                og, dg = image_rays(Kg, torch.as_tensor(r["pose"], dtype=torch.float32,
                                                       device=dev), cam_g.height, cam_g.width)
                zg = stratified_samples(og.shape[0], rc, None, dev)
                errs.append(check_plain(f"gif {name}", pk, og, dg, zg, rc)["rgb_max_abs"])
            first = read_png(records[0]["path"]) / 255.0
            out[name] = {"frames": len(records), "launches": launches,
                         "frame_min": float(first.min()), "frame_std": float(first.std()),
                         "ms": [round(r["ms"], 2) for r in records], "max_abs": max(errs)}
        emit("gif", **out)

    # ---- 5. train: the CLI's train mode through K2 ------------------------
    train_ckpt = os.path.join(OUT, "train_ckpt")
    train_flags = ["--mode", "train", "--data_path", data, "--n_sample", "256",
                   "--n_rays_batch", "8192", "--seed", "0"]

    def train_run(tag, ck, extra, per_step, per_val_view):
        """``--mode train`` for TRAIN_STEPS steps from a seeded init, then a
        second run that resumes from the mid-run checkpoint for RESUME_STEPS
        steps and renders the validation views.  ``per_step`` and
        ``per_val_view``: the launches one step and one validation view
        must make, by counter name.  Returns the phase's record."""
        half = TRAIN_STEPS // 2
        shutil.rmtree(ck, ignore_errors=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ft.reset_launch_counts()
        stats = cli.main([*train_flags, *extra, "--checkpoint_path", ck,
                          "--max_iters", str(TRAIN_STEPS), "--log_every", "5",
                          "--val_every", "0", "--save_ckpt_iter", str(half)])
        launches = dict(ft.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses = [v for _, v in stats["losses"]]
        want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
        if launches != want or stats["steps"] != TRAIN_STEPS:
            raise AssertionError(f"{tag}: launches {launches}, want {want}, "
                                 f"steps {stats['steps']}")
        if len(losses) < 20 or not all(np.isfinite(losses)):
            raise AssertionError(f"{tag}: logged losses {losses}")
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        if not last < first:
            raise AssertionError(f"{tag}: loss did not fall: {first} -> {last}")
        saved = sorted(os.listdir(os.path.join(ck, "synth800")))
        if saved != ["final_model.ckpt.npz", f"model_{half:06d}.ckpt.npz"]:
            raise AssertionError(f"{tag}: checkpoints {saved}")
        # resume from the mid-run checkpoint for a few steps, then validate
        fr.reset_launch_counts()
        ft.reset_launch_counts()
        end = half + 1 + RESUME_STEPS
        resumed = cli.main([*train_flags, *extra, "--checkpoint_path", ck,
                            "--max_iters", str(end), "--log_every", "1",
                            "--val_every", str(end - 2), "--save_ckpt_iter", "0"])
        val = [v for _, _, v in resumed["val"]]
        want = {k: per_step.get(k, 0) * RESUME_STEPS for k in launches}
        if (resumed["start_iter"] != half + 1 or resumed["steps"] != RESUME_STEPS
                or ft.LAUNCHES != want):
            raise AssertionError(f"{tag} resume: {resumed['start_iter']}, "
                                 f"{resumed['steps']} steps, launches {ft.LAUNCHES}")
        want_val = {k: per_val_view.get(k, 0) * len(val) for k in fr.LAUNCHES}
        if not val or fr.LAUNCHES != want_val or not all(np.isfinite(val)):
            raise AssertionError(f"{tag} resume: validation {val}, launches {fr.LAUNCHES}")
        if not resumed["losses"][0][1] < losses[0]:
            raise AssertionError(f"{tag} resume: the first resumed loss is not below the "
                                 f"initial loss: {resumed['losses'][0]} vs {losses[0]}")
        return launches, dict(
            steps=stats["steps"], ms_per_step=stats["ms_per_step"],
            rays_per_s_steady=8192 / stats["ms_per_step"] * 1e3,
            rays_per_s_whole_fit=stats["rays_per_sec"], elapsed_s=stats["elapsed_s"],
            loss_first_log=losses[0], loss_last_log=losses[-1],
            loss_mean_first10=first, loss_mean_last10=last, losses=losses,
            launches=launches, peak_mem_gib=round(peak / 2**30, 3), checkpoints=saved,
            resume={"start_iter": resumed["start_iter"], "steps": resumed["steps"],
                    "ms_per_step": resumed["ms_per_step"],
                    "losses": [v for _, v in resumed["losses"]],
                    "val_views": len(val), "val_mse": val, "launches": dict(fr.LAUNCHES)})

    def train():
        launches, record = train_run("train", train_ckpt, [], {"fused_mse_loss": 1},
                                     {"fused_render_rays": 1})
        state["K2_launches"] = launches["fused_mse_loss"]
        emit("train", **record)

    # ---- 6. train through the two-kernel route (K3) ------------------------
    def train_two_kernel():
        ck = os.path.join(OUT, "train_ckpt_k3")
        shutil.rmtree(ck, ignore_errors=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ft.reset_launch_counts()
        stats = cli.main([*train_flags, "--checkpoint_path", ck, "--two_kernel_step",
                          "--max_iters", str(K3_STEPS), "--log_every", "1",
                          "--val_every", "0", "--save_ckpt_iter", "0"])
        launches = dict(ft.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses = [v for _, v in stats["losses"]]
        if (launches["fused_render_train"] != K3_STEPS
                or launches["fused_render_train_backward"] != K3_STEPS
                or launches["fused_mse_loss"] != 0 or not all(np.isfinite(losses))):
            raise AssertionError(f"two-kernel train: launches {launches}, losses {losses}")
        state["K3_launches"] = launches["fused_render_train"]
        state["K3b_launches"] = launches["fused_render_train_backward"]
        emit("train_two_kernel", steps=stats["steps"], ms_per_step=stats["ms_per_step"],
             rays_per_s_steady=8192 / stats["ms_per_step"] * 1e3,
             rays_per_s_whole_fit=stats["rays_per_sec"], losses=losses, launches=launches,
             peak_mem_gib=round(peak / 2**30, 3))

    # ---- 7. the training kernels on one real batch -------------------------
    def train_kernels():
        tr_images, tr_poses, tr_cam = load_blender_dataset(data, "train")
        f32 = dict(dtype=torch.float32, device=dev)
        imgs, pss = torch.as_tensor(tr_images, **f32), torch.as_tensor(tr_poses, **f32)
        Kt = torch.as_tensor(tr_cam.camera_matrix, **f32)
        gen = torch.Generator(device=dev).manual_seed(7)
        n = 8192
        trcfg = RenderConfig(n_sample=256, near=2.0, far=6.0, perturb=True,
                             use_fused_kernel=True)
        bo, bd, bt = sample_ray_batch(imgs, pss, Kt, n, gen)
        bz = stratified_samples(n, trcfg, gen, dev)
        del imgs
        # the model after the train phase's steps: realistic grads
        tp, _, _ = ckpt.load_checkpoint(
            os.path.join(train_ckpt, "synth800", "final_model.ckpt.npz"))
        tmodel = params_from_jax(tp, mcfg, dev)
        tpacked = fr.pack_nerf_params(tmodel, mcfg, torch.bfloat16)
        batch = (tpacked, bo, bd, bz)

        # K2 against its plain version (float32, and float64 as the witness)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k2_ms, (rgb, gw, gb) = event_ms(
            lambda: ft.fused_mse_loss_grads(*batch, bt, trcfg), reps=3)
        k2_peak = torch.cuda.max_memory_allocated()
        k2_parts = split_times(lambda: ft.fused_mse_loss_grads(*batch, bt, trcfg))
        # the split step's forward sweep is the render kernel's arithmetic
        if not torch.equal(rgb, fr.fused_render_rays(tpacked, bo, bd, bz, trcfg)):
            raise AssertionError("K2's rgb differs from K1's on the same depths")
        rgb_b, gw_b, gb_b = ft.fused_mse_loss_grads(*batch, bt, trcfg)
        bit_equal = torch.equal(gw, gw_b) and torch.equal(gb, gb_b) and torch.equal(rgb, rgb_b)
        if not bit_equal:
            raise AssertionError("K2: two runs on the same input differ")
        k2_plain_ms, (rr, gwr, gbr) = event_ms(
            lambda: ft.fused_mse_loss_reference(*batch, bt, trcfg))
        _, gw64, gb64 = ft.fused_mse_loss_reference(
            tpacked, bo.double(), bd.double(), bz.double(), bt.double(), trcfg)
        loss_k, loss_p = ((rgb - bt) ** 2).mean().item(), ((rr - bt) ** 2).mean().item()
        rgb_err = (rgb - rr).abs().max().item()
        if rgb_err > RGB_TOL or abs(loss_k - loss_p) > LOSS_REL_TOL * loss_p:
            raise AssertionError(f"K2: rgb max abs {rgb_err}, loss {loss_k} vs {loss_p}")
        k2_worst, k2_per, k2_abs = grads_cmp(
            "K2", tpacked, (gw, gb), (gwr, gbr), (gw64, gb64))
        # K3: forward, then backward with an arbitrary cotangent
        k3f_ms, (rgb3, tb) = event_ms(
            lambda: ft.fused_render_train_forward(*batch, trcfg), reps=3)
        # the forward is the render kernel compiled with TB: K1's rgb
        if not torch.equal(rgb3, rgb):
            raise AssertionError("K3's forward rgb differs from K1's on the same depths")
        rgb3_b, tb_b = ft.fused_render_train_forward(*batch, trcfg)
        if not (torch.equal(rgb3, rgb3_b) and torch.equal(tb, tb_b)):
            raise AssertionError("K3 forward: two runs on the same input differ")
        g = torch.randn(n, 3, generator=gen, device=dev) * 1e-4
        k3b_ms, (gw3, gb3) = event_ms(
            lambda: ft.fused_render_train_backward(*batch, trcfg, tb, g), reps=3)
        k3b_parts = split_times(lambda: ft.fused_render_train_backward(*batch, trcfg, tb, g))
        gw3_b, gb3_b = ft.fused_render_train_backward(*batch, trcfg, tb, g)
        if not (torch.equal(gw3, gw3_b) and torch.equal(gb3, gb3_b)):
            raise AssertionError("K3 backward: two runs on the same input differ")
        k3f_plain_ms, (rr3, tbr) = event_ms(
            lambda: ft.fused_render_train_reference(*batch, trcfg))
        k3b_plain_ms, (gwr3, gbr3) = event_ms(
            lambda: ft.fused_render_train_reference(*batch, trcfg, g=g))
        gw64_3, gb64_3 = ft.fused_render_train_reference(
            tpacked, bo.double(), bd.double(), bz.double(), trcfg, g=g.double())
        tc3 = ft.fused_render_train_reference(*batch, trcfg, g=g, tc_order=True)
        k3_rgb_err, tb_err = (rgb3 - rr3).abs().max().item(), (tb - tbr).abs().max().item()
        if k3_rgb_err > RGB_TOL or tb_err > RGB_TOL:
            raise AssertionError(f"K3 forward: rgb {k3_rgb_err}, tb {tb_err}")
        k3_worst, k3_per, k3_abs = grads_cmp(
            "K3", tpacked, (gw3, gb3), (gwr3, gbr3), (gw64_3, gb64_3), tc=tc3)
        del tc3
        # K3's backward is the split step under the caller's cotangent: under
        # the MSE's it is K2, bit for bit, and its forward sweep recomputes
        # the forward's tb, bit for bit
        gm = (rgb3 - bt) * (2.0 / (3.0 * n))
        _, _, tb_s, grads_m = ft._split_step(tpacked, bo, bd, bz, None, trcfg, False, g=gm)
        gw3m, gb3m = ft.fused_render_train_backward(*batch, trcfg, tb, gm)
        n_w = tpacked.weights.numel()
        k2_vs_k3 = {
            "k3_mse_cotangent_bit_equal_to_K2": torch.equal(gw3m, gw) and torch.equal(gb3m, gb)
            and torch.equal(grads_m[:n_w], gw) and torch.equal(grads_m[n_w:], gb),
            "backward_tb_bit_equal_to_forward": torch.equal(tb_s, tb),
        }
        if not all(k2_vs_k3.values()):
            raise AssertionError(f"K3 backward vs K2 and the forward: {k2_vs_k3}")
        del grads_m
        # the practical yardstick: the float32 nn.Module under autograd, with
        # the batch's pixels and depths given
        del gw64, gb64, gw64_3, gb64_3
        tmodel.train()

        def eager_step():
            tmodel.zero_grad(set_to_none=True)
            pts = bo[:, None, :] + bd[:, None, :] * bz[..., None]
            dens, col = tmodel(pts, bd[:, None, :].expand(pts.shape))
            loss = ((composite(dens, col, bz, trcfg)[0] - bt) ** 2).mean()
            loss.backward()
            return loss.detach()

        eager_step()
        torch.cuda.reset_peak_memory_stats()
        eager_ms, eager_loss = event_ms(eager_step, reps=2)
        eager_peak = torch.cuda.max_memory_allocated()
        named = ft.unpack_grads(tpacked, gw, gb)
        eager_rel = max(((named[k] - p.grad).norm() / p.grad.norm()).item()
                        for k, p in tmodel.named_parameters())
        tmodel.zero_grad(set_to_none=True)
        state["train"] = dict(
            K2=(k2_ms, k2_plain_ms, max(rgb_err, k2_abs)),
            K3=(k3f_ms, k3f_plain_ms, max(k3_rgb_err, tb_err)),
            K3b=(k3b_ms, k3b_plain_ms, k3_abs),
            shape=(n, 256), mcfg=mcfg, packed=tpacked, eager_ms=eager_ms)
        emit("train_kernels", rays=n, samples=256, ray_group=ft.RAY_GROUP,
             K2={"ms": k2_ms, "ms_by_launch": k2_parts,
                 "plain_ms": k2_plain_ms, "peak_mem_gib": round(k2_peak / 2**30, 3),
                 "rgb_bit_equal_to_K1": True,
                 "bit_equal_two_runs": bit_equal, "rgb_max_abs": rgb_err,
                 "loss": loss_k, "plain_loss": loss_p, "worst": k2_worst,
                 "grads[rel,max,spread_rel,spread_max]": k2_per},
             K3={"fwd_ms": k3f_ms, "bwd_ms": k3b_ms, "bwd_ms_by_launch": k3b_parts,
                 "fwd_plain_ms": k3f_plain_ms, "bwd_plain_ms": k3b_plain_ms,
                 "fwd_rgb_bit_equal_to_K1": True, "bit_equal_two_runs": True,
                 "rgb_max_abs": k3_rgb_err,
                 "tb_max_abs": tb_err, "worst": k3_worst,
                 "grads[rel,max,spread_rel,spread_max]": k3_per},
             K3_backward_vs_K2_and_forward=k2_vs_k3,
             eager_autograd_f32={"ms": eager_ms, "loss": eager_loss.item(),
                                 "peak_mem_gib": round(eager_peak / 2**30, 3),
                                 "K2_grads_vs_eager_worst_rel": eager_rel})

    # ---- 8. train_hier: the CLI's train mode, coarse/fine, through K4 + K2 --
    hier_ckpt = os.path.join(OUT, "train_hier_ckpt")
    hier_flags = ["--n_importance", str(N_IMPORTANCE)]

    def train_hier():
        launches, record = train_run(
            "train_hier", hier_ckpt, hier_flags,
            {"fused_mse_loss_weights": 1, "fused_mse_loss": 1},
            {"fused_render_rays_weights": 1, "fused_render_rays": 1})
        state["K4_launches"] = launches["fused_mse_loss_weights"]
        emit("train_hier", samples=[256, N_IMPORTANCE], **record)

    hrcfg = RenderConfig(n_sample=256, n_importance=N_IMPORTANCE, near=2.0, far=6.0,
                         perturb=False, use_fused_kernel=True)
    hcfg = NeRFPipelineConfig(model=mcfg, render=hrcfg)

    def load_pair():
        p, _ = ckpt.load_params_untyped(
            os.path.join(hier_ckpt, "synth800", "final_model.ckpt.npz"))
        return params_from_jax(p, mcfg, dev).eval()

    # ---- 9. serve_hier: test mode on the pair, K5 then K1 per frame ---------
    def serve_hier():
        # the CLI renders 5 views of the split it is given: a split of 2
        two = os.path.join(OUT, "two_views", "synth800")
        shutil.rmtree(os.path.dirname(two), ignore_errors=True)
        os.makedirs(two)
        os.symlink(os.path.join(data, "test"), os.path.join(two, "test"))
        with open(os.path.join(data, "transforms_test.json")) as f:
            meta = json.load(f)
        meta["frames"] = meta["frames"][:2]
        with open(os.path.join(two, "transforms_test.json"), "w") as f:
            json.dump(meta, f)
        pair = load_pair()
        make_render_image(hcfg)(pair, K, pose, 64, 64)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fr.reset_launch_counts()
        records = cli.main([
            "--mode", "test", "--data_path", two + "/", "--checkpoint_path", hier_ckpt,
            "--images_path", os.path.join(OUT, "test_hier"), "--n_sample", "256", *hier_flags])
        launches = dict(fr.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if launches != {"fused_render_rays_weights": 2, "fused_render_rays": 2}:
            raise AssertionError(f"serve_hier: launches {launches} for 2 views")
        if len(records) != 2 or not all(np.isfinite(r["psnr"]) for r in records):
            raise AssertionError(f"serve_hier: views {records}")
        fr.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        aux_ms, (rgb, depth, disp, acc) = event_ms(
            lambda: make_render_image_aux(hcfg)(pair, K, pose, H, W))
        aux_launches, aux_peak = dict(fr.LAUNCHES), torch.cuda.max_memory_allocated()
        if aux_launches != {"fused_render_rays_weights": 2, "fused_render_rays": 0}:
            raise AssertionError(f"serve_hier aux: launches {aux_launches}")
        if not all(bool(torch.isfinite(t).all()) for t in (rgb, depth, disp, acc)):
            raise AssertionError("serve_hier aux: maps not finite")
        if not (acc.min().item() >= -1e-6 and acc.max().item() <= 1 + 1e-5):
            raise AssertionError(f"acc outside [0, 1]: {acc.min().item()}..{acc.max().item()}")
        emit("serve_hier", samples=[256, N_IMPORTANCE],
             views=[{k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}
                    for r in records],
             launches=launches, peak_mem_gib=round(peak / 2**30, 3),
             aux={"ms": round(aux_ms, 2), "launches": aux_launches,
                  "peak_mem_gib": round(aux_peak / 2**30, 3),
                  "acc": [acc.min().item(), acc.max().item()],
                  "depth_mean": depth.mean().item()})

    # ---- 10. the hierarchical kernels and routes ------------------------------
    def hier_kernels():
        pair = load_pair()
        pk_c = fr.pack_nerf_params(pair.coarse, mcfg, torch.bfloat16)
        pk_f = fr.pack_nerf_params(pair.fine, mcfg, torch.bfloat16)
        tr_images, tr_poses, tr_cam = load_blender_dataset(data, "train")
        f32 = dict(dtype=torch.float32, device=dev)
        imgs, pss = torch.as_tensor(tr_images, **f32), torch.as_tensor(tr_poses, **f32)
        gen = torch.Generator(device=dev).manual_seed(11)
        n = 8192
        trcfg = RenderConfig(n_sample=256, n_importance=N_IMPORTANCE, near=2.0, far=6.0,
                             perturb=True, use_fused_kernel=True)
        bo, bd, bt = sample_ray_batch(imgs, pss, torch.as_tensor(tr_cam.camera_matrix, **f32),
                                      n, gen)
        bz = stratified_samples(n, trcfg, gen, dev)
        del imgs

        def step_vs_plain(name, packed_, z_, kernel, plain):
            """A step kernel against its plain version on (bo, bd, z_, bt):
            times, rgb and loss errors, the grad rule."""
            ms, out = event_ms(lambda: kernel(packed_, bo, bd, z_, bt, trcfg), reps=3)
            plain_ms, ref = event_ms(lambda: plain(packed_, bo, bd, z_, bt, trcfg))
            f64 = plain(packed_, bo.double(), bd.double(), z_.double(), bt.double(), trcfg)
            loss_k = ((out[0] - bt) ** 2).mean().item()
            loss_p = ((ref[0] - bt) ** 2).mean().item()
            rgb_err = (out[0] - ref[0]).abs().max().item()
            if rgb_err > RGB_TOL or abs(loss_k - loss_p) > LOSS_REL_TOL * loss_p:
                raise AssertionError(f"{name}: rgb max abs {rgb_err}, loss {loss_k} vs {loss_p}")
            worst, _, g_abs = grads_cmp(name, packed_, out[-2:], ref[-2:], f64[-2:])
            return out, ref, f64, dict(ms=ms, plain_ms=plain_ms, rgb_max_abs=rgb_err,
                                       loss=loss_k, plain_loss=loss_p, worst=worst,
                                       grad_max_abs=g_abs)

        # K4 on the coarse depths: against plain, against K2, against itself
        (rgb4, w4, gw4, gb4), (rr4, w4r, _, _), (_, w4_64, _, _), k4 = step_vs_plain(
            "K4", pk_c, bz, ft.fused_mse_loss_weights_grads, ft.fused_mse_loss_weights_reference)
        w_cmp = compare("K4 weights", rgb4, rr4, (w4, w4r, w4_64), bz)
        again = ft.fused_mse_loss_weights_grads(pk_c, bo, bd, bz, bt, trcfg)
        rgb2, gw2, gb2 = ft.fused_mse_loss_grads(pk_c, bo, bd, bz, bt, trcfg)
        k4["bit_equal_two_runs"] = all(
            torch.equal(a, b) for a, b in zip((rgb4, w4, gw4, gb4), again))
        k4["bit_equal_to_K2"] = (torch.equal(rgb4, rgb2) and torch.equal(gw4, gw2)
                                 and torch.equal(gb4, gb2))
        if not (k4["bit_equal_two_runs"] and k4["bit_equal_to_K2"]):
            raise AssertionError(f"K4 bit-equality: {k4}")
        # the split step's forward sweep is the render kernel's arithmetic:
        # K4's rgb and weights are K5's
        rgb5, w5 = fr.fused_render_rays_weights(pk_c, bo, bd, bz, trcfg)
        k4["bit_equal_to_K5"] = torch.equal(rgb4, rgb5) and torch.equal(w4, w5)
        if not k4["bit_equal_to_K5"]:
            raise AssertionError("K4's rgb and weights differ from K5's on the same depths")
        k4["ms_by_launch"] = split_times(
            lambda: ft.fused_mse_loss_weights_grads(pk_c, bo, bd, bz, bt, trcfg))
        del rgb5, w5
        if w4.shape != bz.shape or w4.requires_grad:
            raise AssertionError(f"K4 weights {tuple(w4.shape)}, grad {w4.requires_grad}")
        k4["weights_vs_plain"] = w_cmp
        del again, rr4, w4r, w4_64
        # between the launches: importance sampling and the sorted union
        mids = 0.5 * (bz[..., 1:] + bz[..., :-1])
        mid_ms, z_all = event_ms(lambda: merge_sorted(bz, sample_pdf(
            mids, w4[..., 1:-1], N_IMPORTANCE, gen)), reps=10)
        if z_all.shape != (n, 256 + N_IMPORTANCE) or not bool((z_all.diff(dim=-1) >= 0).all()):
            raise AssertionError("z_all is not the sorted union")
        # the fine K2 at 384 samples on the shared union
        lay = ft.stash_layout(pk_f)
        n_rec = min(ft.RAY_GROUP, n) * 2 * -(-z_all.shape[1] // fr.CHUNK)
        stash_mb = n_rec * ((lay.rec_act + lay.rec_cot) * 2 + ft.IMG_ROWS * 16) / 1e6
        _, _, _, k2f = step_vs_plain("K2 at 384", pk_f, z_all, ft.fused_mse_loss_grads,
                                     ft.fused_mse_loss_reference)
        k2f["ms_by_launch"] = split_times(
            lambda: ft.fused_mse_loss_grads(pk_f, bo, bd, z_all, bt, trcfg))
        state["K4"] = (k4["ms"], k4["plain_ms"],
                       max(k4["rgb_max_abs"], k4["grad_max_abs"], w_cmp["w_max_abs"]))

        # the render route stage by stage on SUBSET rays of one view: each
        # kernel pass against the plain version on the same depths
        i = torch.linspace(0, o.shape[0] - 1, SUBSET, device=dev).long()
        so, sd, sz = o[i], d[i], z[i]
        rgb_c, w_c = fr.fused_render_rays_weights(pk_c, so, sd, sz, hrcfg)
        rr_c, wr_c = fr.fused_render_rays_reference(pk_c, so, sd, sz, hrcfg, emit_weights=True)
        coarse = compare("hier coarse pass", rgb_c, rr_c,
                         (w_c, wr_c, plain_f64_weights(pk_c, so, sd, sz, hrcfg)), sz)
        sz_all = merge_sorted(sz, sample_pdf(0.5 * (sz[..., 1:] + sz[..., :-1]),
                                             w_c[..., 1:-1], N_IMPORTANCE))
        sz_all_plain = merge_sorted(sz, sample_pdf(0.5 * (sz[..., 1:] + sz[..., :-1]),
                                                   wr_c[..., 1:-1], N_IMPORTANCE))
        rgb_f, w_f = fr.fused_render_rays_weights(pk_f, so, sd, sz_all, hrcfg)
        rr_f, wr_f = fr.fused_render_rays_reference(pk_f, so, sd, sz_all, hrcfg,
                                                    emit_weights=True)
        fine = compare("hier fine pass", rgb_f, rr_f,
                       (w_f, wr_f, plain_f64_weights(pk_f, so, sd, sz_all, hrcfg)), sz_all)
        if not torch.equal(rgb_f, fr.fused_render_rays(pk_f, so, sd, sz_all, hrcfg)):
            raise AssertionError("fine pass: K1's rgb differs from K5's")
        # the whole plain route (its own coarse weights pick its depths)
        rr_whole = fr.fused_render_rays_reference(pk_f, so, sd, sz_all_plain, hrcfg)
        route = {"z_fine_moved_max": (sz_all - sz_all_plain).abs().max().item(),
                 "rgb_max_abs": (rgb_f - rr_whole).abs().max().item(),
                 "psnr": psnr(rgb_f, rr_whole)}
        del rgb_c, w_c, rr_c, wr_c, rgb_f, w_f, rr_f, wr_f

        # the frame's parts at 640,000 rays (serve_hier times the whole), and
        # the kernel frame against the float32 nn.Module hierarchical frame
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c_ms, (_, wc) = event_ms(lambda: fr.fused_render_rays_weights(pk_c, o, d, z, hrcfg))
        full_mid_ms, zf = event_ms(lambda: merge_sorted(z, sample_pdf(
            0.5 * (z[..., 1:] + z[..., :-1]), wc[..., 1:-1], N_IMPORTANCE)))
        del wc
        k1_ms, frame = event_ms(lambda: fr.fused_render_rays(pk_f, o, d, zf, hrcfg))
        k5_ms, _ = event_ms(lambda: fr.fused_render_rays_weights(pk_f, o, d, zf, hrcfg))
        k5_plain_ms, ref = event_ms(lambda: fr.fused_render_rays_reference(pk_f, o, d, zf, hrcfg))
        k1_full = compare("K1 at 384", frame, ref)
        del zf, ref
        peak = torch.cuda.max_memory_allocated()
        mod_cfg = NeRFPipelineConfig(model=mcfg, render=RenderConfig(
            n_sample=256, n_importance=N_IMPORTANCE, near=2.0, far=6.0, perturb=False,
            use_fused_kernel=False))
        mod_ms, mod = event_ms(lambda: make_render_image(mod_cfg)(pair, K, pose, H, W))
        p_mod = psnr(frame.reshape(H, W, 3), mod)
        if p_mod < PSNR_MODULE:
            raise AssertionError(f"hierarchical kernel vs nn.Module frame PSNR {p_mod:.2f} dB")
        n_full, S_all = o.shape[0], 256 + N_IMPORTANCE
        fwd = lambda rays, S: 2.0 * (fr.macs_per_point(mcfg) * rays * S
                                     + fr.macs_per_ray(mcfg) * rays)
        emit("hier_kernels", rays=n, samples=[256, N_IMPORTANCE], ray_group=ft.RAY_GROUP,
             K4=k4,
             sample_pdf_merge_ms=mid_ms,
             K2_at_384={**k2f, "stash_mb": round(stash_mb, 1),
                        "bound_ms": 3 * fwd(n, S_all) / PEAK_BF16 * 1e3},
             route_on_subset={"rays": SUBSET, "coarse_pass": coarse, "fine_pass": fine,
                              "kernel_route_vs_plain_route": route},
             frame={"rays": n_full, "coarse_K5_ms": c_ms, "sample_pdf_merge_ms": full_mid_ms,
                    "fine_K1_ms": k1_ms, "fine_K5_ms": k5_ms, "fine_plain_ms": k5_plain_ms,
                    "fine_bound_ms": fwd(n_full, S_all) / PEAK_BF16 * 1e3,
                    "fine_K1_vs_plain": k1_full,
                    "parts_peak_mem_gib": round(peak / 2**30, 3),
                    "kernel_vs_module": {"psnr": round(p_mod, 2), "module_ms": round(mod_ms, 2)}})

    phase(serve)
    phase(aux)
    phase(gif)
    phase(train)
    if not failed:
        phase(train_two_kernel)
        phase(train_kernels)
        phase(train_hier)
    if not failed:
        phase(serve_hier)
        phase(hier_kernels)

    # ---- 8. kernels ------------------------------------------------------
    def kernel_line():
        n, S = o.shape[0], z.shape[1]
        macs = fr.macs_per_point(mcfg) * n * S + fr.macs_per_ray(mcfg) * n
        in_bytes = (o.numel() + d.numel() + z.numel()) * 4 \
            + packed.weights.numel() * 2 + packed.biases.numel() * 4
        rows, full_shape = [], {}
        for name, replaces, weights in (
            ("fused_render_rays", "sfm_nerf_tpu/kernels/fused_render.py:541", False),
            ("fused_render_rays_weights", "sfm_nerf_tpu/kernels/fused_render.py:575", True),
        ):
            key = "K5" if weights else "K1"
            run = (lambda: fr.fused_render_rays_weights(packed, o, d, z, rcfg)) \
                if weights else (lambda: fr.fused_render_rays(packed, o, d, z, rcfg))
            ms, got = event_ms(run)
            plain_ms, ref = event_ms(lambda: fr.fused_render_rays_reference(
                packed, o, d, z, rcfg, emit_weights=weights))
            full_shape[name] = (
                compare(name, got[0], ref[0],
                        (got[1], ref[1], plain_f64_weights(packed, o, d, z, rcfg)), z)
                if weights else compare(name, got, ref))
            out_bytes = n * 3 * 4 + (n * S * 4 if weights else 0)
            t_ops = 2.0 * macs / PEAK_BF16 * 1e3
            t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
            rows.append({
                "name": name, "route": "cuda",
                "source": "sfm_nerf_tpu_torch/kernels/csrc/fused_render.cu",
                "replaces": replaces, "launches": state[f"{key}_launches"],
                "max_abs_err": max(full_shape[name]["rgb_max_abs"],
                                   full_shape[name].get("w_max_abs", 0.0)),
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            })
        emit("kernel_vs_plain_full_shape", rays=n, samples=S, **full_shape)
        # the render kernel: shared memory, L2 weight traffic, a yardstick
        plan = fr.render_plan(packed)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(sms, -(-n // 2))
        rounds = sum(-(-(n - 2 * b) // (2 * grid)) for b in range(grid)) * -(-S // 64)
        l2_bytes = plan.dir_off * 2 * rounds     # each round fetches every tile once
        pts = 40000 * S
        xs = {k: torch.randn(pts, k, device=dev, dtype=torch.bfloat16)
              for k in sorted({s_.k for s_ in packed.layers})}
        outs = {k: torch.empty(pts, k, device=dev, dtype=torch.bfloat16)
                for k in sorted({s_.n for s_ in packed.layers})}
        wts = {s_.name: packed.w(s_)[:s_.k] for s_ in packed.layers}

        def products():
            for s_ in packed.layers:
                torch.matmul(xs[s_.k], wts[s_.name], out=outs[s_.n])

        products()
        mm_ms, _ = event_ms(products, reps=3)
        mm_macs = sum(s_.k * s_.n for s_ in packed.layers) * pts
        del xs, outs
        emit("render_kernel_detail", rays=n, samples=S,
             **fr.render_smem_layout(packed, rcfg), tiles=len(plan.tiles),
             tile_image_bytes=plan.dir_off * 2, l2_weight_bytes_per_frame=l2_bytes,
             l2_rounds=rounds,
             cublas_products_yardstick={
                 "what": f"the MLP's {len(packed.layers)} products alone (every packed "
                         "layer at its packed width), bf16 torch.matmul, on 40,000 "
                         f"rays x {S} samples",
                 "ms": mm_ms, "ms_scaled_x16_to_frame": mm_ms * n / 40000,
                 "tflops": 2.0 * mm_macs / mm_ms / 1e9})
        # the training kernels at the training step's shape.  Operations: K2's
        # and K4's least work is three forwards (forward, d_h W^T, act^T d_h); K3's
        # forward is one; K3's backward, which must recompute, three.  Bytes:
        # rays, depths, packed weights (and targets, cotangent, tb) in; rgb,
        # tb and one float32 grad per packed element out.
        tr = state["train"]
        tn, tS = tr["shape"]
        fwd_flop = 2.0 * (fr.macs_per_point(mcfg) * tn * tS + fr.macs_per_ray(mcfg) * tn)
        w_bytes = tr["packed"].weights.numel() * 2 + tr["packed"].biases.numel() * 4
        g_bytes = (tr["packed"].weights.numel() + tr["packed"].biases.numel()) * 4
        ray_bytes = (tn * 3 * 2 + tn * tS) * 4
        tb_bytes = tn * -(-tS // fr.CHUNK) * 4
        tr["K4"] = state["K4"]     # the same shape, on the pair's coarse network
        csrc = "sfm_nerf_tpu_torch/kernels/csrc/"
        split = " + ".join(csrc + f for f in ("fused_render.cu", "fused_train.cu", "grad_gemm.cu"))
        for key, name, replaces, n_fwd, nbytes, source in (
            ("K2", "fused_mse_loss", "sfm_nerf_tpu/kernels/fused_train.py:887", 3,
             ray_bytes + tn * 12 + w_bytes + tn * 12 + g_bytes, split),
            ("K4", "fused_mse_loss_weights", "sfm_nerf_tpu/kernels/fused_train.py:924", 3,
             ray_bytes + tn * 12 + w_bytes + tn * 12 + tn * tS * 4 + g_bytes, split),
            ("K3", "fused_render_train", "sfm_nerf_tpu/kernels/fused_train.py:653", 1,
             ray_bytes + w_bytes + tn * 12 + tb_bytes, csrc + "fused_render.cu"),
            ("K3b", "fused_render_train_backward", "sfm_nerf_tpu/kernels/fused_train.py:638", 3,
             ray_bytes + tn * 12 + tb_bytes + w_bytes + g_bytes, split),
        ):
            ms, plain_ms, err = tr[key]
            t_ops = n_fwd * fwd_flop / PEAK_BF16 * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": state[f"{key}_launches"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            })
        print(json.dumps({"kernels": rows}), flush=True)

    if not failed:
        phase(kernel_line)
    run_sfm_phases(phase, OUT)
    emit("timing", elapsed_s=round(time.time() - t_start, 1))
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
