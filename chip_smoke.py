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
4b. figures: the serve phase's five figure_{i}.png read back (900 x 1800,
   the right panel against test_{i}_pred.png resampled into its box, each
   figure's host seconds), then ``cli.wrapper --mode gif --plot_rays`` on
   synth800 (the gif phase's legacy turntable cut to one frame): one K1
   launch, the frame held against the plain version, ray_plot_1.png at
   1200 x 1200 and its host seconds;
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
10b. mip: a seeded mip-NeRF network at its published widths (8 x 256, 16 + 4
   octaves) on one real batch of 8,192 cones x 128 intervals: the cone K4
   (fused_mse_loss_cones_grads with the weights) over the coarse edges,
   resample_edges, the cone K2 over the fine edges, each against its plain
   version (rgb, loss, the weights, every grad tensor) under the grad rule,
   which the plain version fed bf16-rounded edges, origins and directions
   (a bf16 encoding's inputs) must fail; K4 against itself, against K2 and
   against the cone K5 (bit-equal); the autograd wrappers
   fused_mse_loss_cones(_weights) against the grads they were held by; one
   make_loss_fn step (one launch of each, ipe_points 2 x rays x
   intervals); then an 800x800 frame through make_render_image (one cone
   K5, the resampler, one cone K1), against the float32 nn.Module frame,
   and the route stage by stage on SUBSET rays against the plain version;
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
14. sfm_scale: the same pipeline on 48 cameras x 8,000 points;
14b. sfm_figures: every figure file the JAX pipeline writes, in sfm's and
   sfm_scale's output (the PNGs at their pixel sizes, the four overlays
   baseline JPEGs of 800 x 600), and each writer's host seconds in
   sfm_scale;
15. dp_train: ``cli.nerf --mode train`` under a one-rank torchrun
   environment (NCCL, started in this process: the code a multi-GPU user
   runs), 20 flat steps and 5 hierarchical ones through the data-parallel
   trainer, against the same runs of the one-device trainer: parameters
   bit for bit, ms per step side by side;
16. dp2_one_card: two spawned ranks over gloo, both on cuda:0 (NCCL refuses
   two ranks on one card): one data-parallel step (K2 on 4,096 rays a
   rank) against K2 on the concatenated 8,192 rays under the grad rule;
   one dp1 x tp2 step (parameters sharded as DTensors, K2 on the gathered
   weights) against its one-process replay; one 800x800 synth800 view
   through the sharded frame renderer (K1 on half the rays a rank) against
   the one-device frame;
17. sfm_sharded: hypothesis-sharded F-RANSAC over [cuda:0] x 2 against the
   one-device call (bit for bit), point-sharded BA over 2 shards against
   the one-device BA (cost within 1e-9), and the pipeline's refusal of
   --ransac_devices / --ba_devices larger than the visible card count;
18. sfm_global: sfm_scale's scene and flags plus ``--global_init
   --essential_method 5pt --ransac_confidence 0.999 --pnp_f64_rescue on``:
   rotation and translation averaging before the global BA, the 5-point
   two-view init, adaptive F- and PnP RANSAC; the hypotheses scored per
   pair, the averaging residuals, pose errors beside sfm_scale's;
19. sfm_global_ops: on the card against the CPU on the same inputs:
   rotation and translation averaging on a 200-camera window-7 ring (the
   200-camera protocol's pose graph), relative_pose_pairs over every pair
   of sfm, the 5-point RANSAC on pair (1, 2) (and torch.linalg.eig's time
   on its action matrices' shape), adaptive F-RANSAC over sfm's pairs
   (timed twice, the second run bit for bit the first, beside the fixed
   run), adaptive PnP (timed the same way) and the rescue on camera 3;
20. profile (after the kernels line, like 21-25): utils/profiling.trace over
   20 steady K2 training steps at 8,192 x 256 (after 5 warm-up steps) and
   over one 800x800x256 synth800 test view through K1: the device's busy
   and idle share of the window, the top kernels by time, host ms per step
   and per view, StepTimer's summary, device_memory_stats; K2's and K1's
   kernels must show device time;
21. async_ckpt: ``cli.nerf --mode train --ckpt_backend orbax`` for 40 steps
   with a save every 10, beside the same run with npz: ms per step of each,
   every file read back through train/checkpoint.py, the last one bit-equal
   to the trained model, a resume at 40;
22. interrupt: a child ``cli.nerf --mode train`` on the card, under each
   backend, gets SIGINT once its step-15 checkpoint exists: the file it
   saves must be stamped Adam's count - 1, and a resume starts one later;
23. wrapper: ``cli.wrapper --mode train`` on synth800 (20 full-width steps of
   the legacy loop: nn.Module, legacy compositor, StepLR(1000, 0.1)), then
   ``--mode test`` on 2 views through K1 with the legacy compositor;
24. gif_writer: ``cli.gif`` stitches the gif phase's frames; read back with
   io/gif.py: frame count, delay, each frame's mean error against its PNG;
25. synth_scene: the port's tracer in float32 on the card regenerates
   synth800 train r_0-r_3 and chair800 r_0 at 800x800 (poses from
   ``camera_rig(100, 16, 0)`` once the json is confirmed to hold them), each
   held against the committed PNG by tests/test_synth_scene.py's rule, ms
   per view; then a 4 + 2 view dataset through ``cli.synth_scene``, read
   back by io/blender.py.
26. pth_interop (after hier_kernels, like 27-28, before the kernels line):
   synth800's checkpoint exported as a reference active-class .pth and read
   back bit-equal; ``cli.wrapper --mode gif --no_perturb`` on a directory
   holding only that file renders the gif phase's 2 frames through K1, bit-
   equal to the npz's; a seeded full-width legacy network exported as
   final_model.pth is fine-tuned by ``cli.nerf --mode train --arch legacy``
   for 20 steps through K2 (from step 0, the exported weights); a seeded
   skip-less no-PE legacy network read from a .pth renders 16,384 rays of
   the serve view through K1, held against the plain version;
27. bf16_module: the legacy-compositor nn.Module route (``cli.wrapper --mode
   train``'s config) at 8,192 x 256 through NeRFTrainer, 20 steps float32 and
   20 bf16 (``compute_dtype``) from one seeded init: ms per step, peak
   memory, losses, a trace of 3 more steps of each (the device's time by
   kernel); on one batch bf16 against float32 (loss, every grad) and
   bf16 on the card against bf16 on the CPU on its first 1,024 rays; the
   product alone at one layer's shape in float32, bf16 with float32 out
   (Bf16Linear's) and bf16 out;
28. tb_events: the train phase's two runs' event files read back: the tags
   and steps the trainer logged, the scalars equal to its logged losses,
   Val_Image_0 decoded against the final model's validation side-by-side,
   the files' bytes and the writer's share of the fit's wall time.

Each kernel path runs with the launch counters set to 0 just before it and
read just after; a path that did not launch its kernel fails the run.  Every
phase prints one JSON line; the last line is the result.  Exits non-zero
without a result when no card is visible, when the package is missing, or
when any phase fails.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

from benchmark.counts import PEAK_BF16, PEAK_BYTES   # H100 SXM bf16 FLOP/s, HBM3 bytes/s

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
# slice 12's phases: the fine-tune of a converted legacy .pth through K2,
# the bf16 nn.Module route beside the float32 one, and the rules for it: bf16
# against float32 compute on one batch (loss, each grad tensor against its
# norm), and bf16 on the card against bf16 on the CPU on the batch's first
# BF16_CPU_RAYS rays (the card's products also round the output cotangent to
# bf16, Bf16Linear); Val_Image_0 against the validation side-by-side
FINETUNE_STEPS, BF16_STEPS, BF16_TRACE_STEPS, BF16_CPU_RAYS = 20, 20, 3, 1024
BF16_LOSS_REL, BF16_GRAD_REL = 2e-2, 5e-2
# card vs CPU, bf16: the card reads a worst grad of 3.28e-3 (fc1.weight) and
# the float32 route, run as a control against the same CPU bf16 reference,
# 1.17e-2 (NVIDIA H100 80GB HBM3, 700 W): the rule sits between, so the
# control must fail it
CARD_LOSS_REL, CARD_GRAD_REL = 1e-3, 6e-3
# Bf16Linear vs _linear's formula on the card: forward to float32 summation
# order; each grad within the cotangent's bf16 rounding
BF16_LINEAR_REL, BF16_LINEAR_GRAD_REL = 1e-5, 1e-2
VAL_IMAGE_LEVELS = 1
LEGACY_DENSITY_BIAS = 0.5  # the fine-tuned legacy net: density > 0 at every point
NOPE_GAIN = 2.0          # the no-PE net's weight scale: plain rgb std 9.1e-2, not 1.4e-3
# the gif phase's legacy turntable (2 frames), rendered again from a .pth
GIF_LEGACY_FLAGS = ["--orbit", "lookat", "--orbit_elev", "30", "--orbit_target", "0,-0.2,0",
                    "--n_frames", "2"]
N_IMPORTANCE = 128       # importance samples of the hierarchical phases
MIP_INTERVALS, MIP_SEED = 128, 19   # the mip phase: intervals a level, network seed
# the mip phase's grad rule (rel, max), tighter than GRAD_REL_TOL /
# GRAD_MAX_TOL, which the plain version fed bf16-rounded edges, origins and
# directions meets over 8,192 rays.  On the card (NVIDIA H100 80GB HBM3,
# 700 W) the cone K4's worst tensor reads 1.17e-4 / 7.2e-5, the plain
# version's float32-vs-float64 spread 4.5e-4 / 3.0e-4, and that control
# 1.83e-2 / 9.2e-3 (fc1.weight): the rule sits near the geometric means
MIP_GRAD_TOL = (1.5e-3, 1e-3)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


@contextlib.contextmanager
def timed_calls(module, names, seconds):
    """While open, each call of ``module.<name>`` appends its host seconds
    to ``seconds[name]`` (the figure writers' time on their real path)."""
    saved = {n: getattr(module, n) for n in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return call

    for n, fn in saved.items():
        setattr(module, n, timed(n, fn))
    try:
        yield seconds
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


# ---- figures (slice 13) ----------------------------------------------------
FIGURE_PSNR = 30.0       # figure_{i}.png's right panel vs its prediction, resampled
SFM_FIGURES = {"x_vs_z_triangulation.png": (2400, 3000), "3d_points_visualization.png":
               (2400, 3000), "complete_reconstruction.png": (2400, 3000),
               "topdown_view.png": (1000, 1000), "feature_matches_1_2.png": (600, 1600)}
SFM_OVERLAYS = ["Frame1 - lineartriangulation.jpg", "Frame2 - lineartriangulation.jpg",
                "Frame1 - nonlineartriangulation.jpg", "Frame2 -non lineartriangulation.jpg"]
FIGURE_WRITERS = ["save_match_visualization", "save_x_vs_z_plot", "save_3d_points_plot",
                  "save_projection_overlays", "save_reconstruction_plot", "save_topdown_plot"]


# ---- Phase 1 SfM -----------------------------------------------------------
SFM_CAMS, SFM_POINTS, SFM_WINDOW = 12, 4000, 4
SCALE_CAMS, SCALE_POINTS, SCALE_WINDOW, SCALE_F_ITERS = 48, 8000, 8, 4000
SFM_NOISE_PX, SFM_OUTLIER_FRAC = 0.5, 0.10
SFM_MEAN_PX, SFM_ROT_DEG = 1.0, 0.1   # final BA mean error, median rotation error
F_REL_TOL = 1e-8                      # F on the card vs on the CPU, relative
BA_PIXEL_TOL = 1e-6                   # BA on the card vs the CPU: seen pixels

# ---- multi-device phases ---------------------------------------------------
DP_STEPS, DP_HIER_STEPS = 20, 5
DP2_RAYS = 8192                       # the dp2_one_card step's batch: 4,096 a rank
DP2_TIMEOUT = 600                     # s for both ranks of dp2_one_card
SPMD_RTOL, SPMD_ATOL = 1e-4, 1e-6     # the dp x tp step vs its replay (tests' rule)
SHARDED_F_ITERS = 16384               # 16 chunks: 8 a shard, one solve block each
SHARDED_BA_ITERS = 20
BA_COST_REL_TOL = 1e-9                # point-sharded BA vs one device

# ---- global initialisation, 5-point, adaptive RANSAC, PnP rescue -----------
GLOBAL_FLAGS = ["--global_init", "--essential_method", "5pt", "--ransac_confidence",
                "0.999", "--pnp_f64_rescue", "on"]
ROT_RES_DEG, TRANS_RES_DEG = 3.0, 5.0 # mean rotation / median direction residual
AVG_TOL = 1e-9                        # averagers and relative poses, card vs CPU
E5_TOL = 1e-8                         # 5-point E, card vs CPU, up to sign
RING_CAMS, RING_WINDOW = 200, 7       # the 200-camera protocol's pose graph
ADAPTIVE_CONF = 0.999


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
    CPU, given the same draws), sfm_scale (48 cameras x 8,000 points),
    sfm_figures (the figures of sfm and sfm_scale), and the phases after."""
    import numpy as np
    import torch

    from sfm_nerf_tpu_torch.cli import sfm as cli_sfm
    from sfm_nerf_tpu_torch.io import artifacts as art
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset
    from sfm_nerf_tpu_torch.io.jpeg import sof0_size
    from sfm_nerf_tpu_torch.io.png import png_size
    from sfm_nerf_tpu_torch.ops import ba as ba_ops
    from sfm_nerf_tpu_torch.ops import epipolar as ep
    from sfm_nerf_tpu_torch.ops import pnp as pnp_ops

    dev = torch.device("cuda")
    state = {}

    def reconstruct(tag, n_cams, n_points, window, extra, data_of=None):
        """cli.sfm on a ring written for ``tag`` (or on ``data_of``'s)."""
        data = os.path.join(out_root, f"{data_of or tag}_data")
        out = os.path.join(out_root, f"{tag}_out")
        t0 = time.time()
        if data_of is None:
            shutil.rmtree(data, ignore_errors=True)
            state[f"{tag}_gt"] = write_sfm_dataset(data, n_cams, n_points, window)
        gt = state[f"{data_of or tag}_gt"]
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
        with timed_calls(art, FIGURE_WRITERS, state.setdefault("writer_s", {})):
            _, _, _, rec = reconstruct(
                "sfm_scale", SCALE_CAMS, SCALE_POINTS, SCALE_WINDOW,
                ["--ransac_iters", str(SCALE_F_ITERS), "--ba_interval", "12"])
        state["sfm_scale_rec"] = rec
        emit("sfm_scale", **rec)

    def sfm_figures():
        """Every figure the JAX pipeline writes, in sfm's and sfm_scale's
        output: the PNGs at their sizes, the overlays baseline JPEGs of the
        frames' 800 x 600; each writer's host seconds at sfm_scale's size."""
        out = {}
        for tag in ("sfm", "sfm_scale"):
            d = os.path.join(out_root, f"{tag}_out")
            names = sorted(n for n in os.listdir(d) if n.endswith((".png", ".jpg")))
            if names != sorted([*SFM_FIGURES, *SFM_OVERLAYS]):
                raise AssertionError(f"{tag}: figures {names}")
            for name, (h, w) in SFM_FIGURES.items():
                got = png_size(os.path.join(d, name))
                if got != (w, h):
                    raise AssertionError(f"{tag}/{name}: {got}, want {(w, h)}")
            for name in SFM_OVERLAYS:
                if sof0_size(os.path.join(d, name)) != (800, 600):
                    raise AssertionError(f"{tag}/{name}: SOF0 {sof0_size(os.path.join(d, name))}")
            out[tag] = {"files": len(names),
                        "bytes": sum(os.path.getsize(os.path.join(d, n)) for n in names)}
        secs = state["writer_s"]
        if sorted(secs) != sorted(FIGURE_WRITERS):
            raise AssertionError(f"sfm_scale's writers timed: {sorted(secs)}")
        emit("sfm_figures", **out, writer_s_sfm_scale=secs,
             figures_s_sfm_scale=sum(map(sum, secs.values())),
             cams=SCALE_CAMS, points=SCALE_POINTS)

    def sfm_global():
        """sfm_scale's scene and flags plus the global initialisation, the
        5-point two-view init, adaptive RANSAC and the PnP rescue."""
        if "sfm_scale_gt" not in state:
            state["sfm_scale_gt"] = write_sfm_dataset(
                os.path.join(out_root, "sfm_scale_data"), SCALE_CAMS, SCALE_POINTS,
                SCALE_WINDOW)
        _, _, res, rec = reconstruct(
            "sfm_global", SCALE_CAMS, SCALE_POINTS, SCALE_WINDOW,
            ["--ransac_iters", str(SCALE_F_ITERS), "--ba_interval", "12", *GLOBAL_FLAGS],
            data_of="sfm_scale")
        st = res["stats"]
        used = np.asarray(st["ransac_iters_scored"])
        rec.update(
            rotation_avg=st.get("rotation_avg"), translation_avg=st.get("translation_avg"),
            hypotheses_per_pair={"pairs": len(used), "cap": -(-SCALE_F_ITERS // 1024) * 1024,
                                 "min": int(used.min()), "median": float(np.median(used)),
                                 "max": int(used.max()), "total": int(used.sum())},
            pnp_rescues=st.get("pnp_rescues", {}), two_view=st.get("two_view"))
        scale = state.get("sfm_scale_rec")
        if scale is not None:
            rec["sfm_scale_beside"] = {k: scale[k] for k in (
                "wall_s", "stage_seconds", "ba_mean_px", "rot_err_deg_median",
                "rot_err_deg_max", "centre_err_median", "centre_err_max")}
        ok = (st.get("rotation_avg") and st.get("translation_avg")
              and st["rotation_avg"]["mean_residual_deg"] < ROT_RES_DEG
              and st["translation_avg"]["median_residual_deg"] < TRANS_RES_DEG
              and "global_init" in st["stage_seconds"])
        if not ok:
            raise AssertionError(f"sfm_global: {rec}")
        emit("sfm_global", **rec)

    def sfm_global_ops():
        """The new Phase 1 ops on the card against the CPU on the same
        inputs."""
        from sfm_nerf_tpu_torch.io.sfm_data import parse_matching_files
        from sfm_nerf_tpu_torch.ops import essential5 as e5
        from sfm_nerf_tpu_torch.ops import rotation_avg as ra
        from sfm_nerf_tpu_torch.ops import translation_avg as ta
        from sfm_nerf_tpu_torch.ops import triangulation as tri

        cpu = torch.device("cpu")
        sides = (("cuda", dev), ("cpu", cpu))

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.time()
            r = fn()
            torch.cuda.synchronize()
            return r, round((time.time() - t0) * 1e3, 3)

        rec = {}
        # rotation + translation averaging on the 200-camera window-7 ring
        rng = np.random.default_rng(11)
        n = RING_CAMS
        th = 2 * np.pi * np.arange(n) / n
        C = np.stack([6 * np.cos(th), 0.4 * np.sin(3 * th), 6 * np.sin(th)], -1)
        C -= C[0]
        Rs = []
        for _ in range(n):
            Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            Rs.append(Q * np.sign(np.linalg.det(Q)))
        Rs = np.stack(Rs)
        Rs = np.einsum("nij,jk->nik", Rs, Rs[0].T)
        pairs = sorted({(min(i, (i + d) % n), max(i, (i + d) % n))
                        for i in range(n) for d in range(1, RING_WINDOW + 1)})

        def small_rotation(v):
            from sfm_nerf_tpu_torch.ops.linalg import rodrigues
            return rodrigues(torch.as_tensor(v)).numpy()

        R_rel = np.stack([small_rotation(rng.normal(0, np.radians(0.3), 3))
                          @ Rs[j] @ Rs[i].T for i, j in pairs])
        c_rel = np.stack([Rs[i] @ (C[j] - C[i]) / np.linalg.norm(C[j] - C[i]) for i, j in pairs])
        c_rel = c_rel + rng.normal(0, 0.005, c_rel.shape)
        avg, ms = {}, {}
        for name, d in sides:
            t = lambda a: torch.as_tensor(a, device=d)
            (R_avg, ms[f"rotation_{name}_ms"]) = timed(
                lambda: ra.rotation_averaging(pairs, t(R_rel), n))
            u = ta.pair_direction_world(R_avg[[i for i, _ in pairs]], t(c_rel))
            (C_avg, ms[f"translation_{name}_ms"]) = timed(
                lambda: ta.translation_averaging(pairs, u, n))
            avg[name] = (R_avg.cpu().numpy(), C_avg.cpu().numpy())
        rot_diff = float(np.abs(avg["cuda"][0] - avg["cpu"][0]).max())
        scale = np.linalg.norm(avg["cpu"][1], axis=-1).max()
        cen_diff = float(np.abs(avg["cuda"][1] - avg["cpu"][1]).max() / scale)
        cos = (np.einsum("nij,nij->n", avg["cuda"][0], Rs) - 1) / 2
        rot_err = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        C_al = avg["cuda"][1] * (np.linalg.norm(C) / np.linalg.norm(avg["cuda"][1]))
        rec["averaging"] = {
            "cams": n, "edges": len(pairs), "rotation_max_diff": rot_diff,
            "centre_max_diff_rel": cen_diff, "rot_err_deg_mean": float(rot_err.mean()),
            "centre_err_mean_rel": float(np.linalg.norm(C_al - C, axis=-1).mean()
                                         / np.linalg.norm(C, axis=-1).max()), **ms}

        # relative_pose_pairs over every pair of sfm
        data = os.path.join(out_root, "sfm_data")
        if "sfm_gt" not in state:
            state["sfm_gt"] = write_sfm_dataset(data, SFM_CAMS, SFM_POINTS, SFM_WINDOW)
        gt = state["sfm_gt"]
        matches, _, _ = parse_matching_files(data, SFM_CAMS)
        keys = sorted(matches)
        items = [(matches[k][:, 0:2], matches[k][:, 2:4]) for k in keys]
        g = torch.Generator(device=dev).manual_seed(5)
        fixed = ep.ransac_fundamental_pairs_bucketed(items, n_iters=1024, generator=g,
                                                     device=dev)
        inl = [matches[k][r.inliers] for k, r in zip(keys, fixed)]
        width = max(len(m) for m in inl)
        p1 = np.zeros((len(keys), width, 2))
        p2 = np.zeros((len(keys), width, 2))
        for r, m in enumerate(inl):
            p1[r, :len(m)], p2[r, :len(m)] = m[:, 0:2], m[:, 2:4]
        poses = {}
        for name, d in sides:
            t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=d)
            (out, ms_) = timed(lambda: tri.relative_pose_pairs(
                t(gt["K"]), t(np.stack([r.F for r in fixed])), t(p1), t(p2),
                torch.as_tensor([len(m) for m in inl], device=d)))
            poses[name] = ([o.cpu().numpy() for o in out], ms_)
        rp_diff = max(float(np.abs(a - b).max())
                      for a, b in zip(poses["cuda"][0], poses["cpu"][0]))
        rec["relative_pose_pairs"] = {"pairs": len(keys), "max_diff": rp_diff,
                                      "cuda_ms": poses["cuda"][1], "cpu_ms": poses["cpu"][1]}

        # the 5-point RANSAC on pair (1, 2); torch.linalg.eig timed inside it
        m12 = inl[keys.index((1, 2))]
        e5out, eig_ms = {}, {}
        eig = torch.linalg.eig

        def timed_eig(A):
            r, ms_ = timed(lambda: eig(A))
            eig_ms[A.device.type] = eig_ms.get(A.device.type, 0.0) + ms_
            return r

        torch.linalg.eig = timed_eig
        try:
            for name, d in sides:
                (out, ms_) = timed(lambda: e5.ransac_essential_5pt(
                    m12[:, 0:2], m12[:, 2:4], gt["K"], n_iters=1000, seed=0, device=d))
                e5out[name] = ([o.cpu().numpy() for o in out], ms_)
        finally:
            torch.linalg.eig = eig
        (Ec, ic), (Eh, ih) = e5out["cuda"][0], e5out["cpu"][0]
        e_diff = min(float(np.abs(Ec - Eh).max()), float(np.abs(Ec + Eh).max()))
        rec["essential_5pt"] = {"matches": len(m12), "samples": 1000,
                                "same_inliers": bool(np.array_equal(ic, ih)),
                                "n_inliers": int(ic.sum()), "E_max_diff": e_diff,
                                "cuda_ms": e5out["cuda"][1], "cpu_ms": e5out["cpu"][1],
                                "eig_cuda_ms": eig_ms.get("cuda"),
                                "eig_cpu_ms": eig_ms.get("cpu")}

        # adaptive F-RANSAC over every pair, against the fixed run
        total = -(-50000 // 1024) * 1024
        g = torch.Generator(device=dev).manual_seed(9)
        samples = [ep.draw_minimal_samples(total, 8, len(a), g, dev) for a, _ in items]
        # the adaptive driver twice, the second run the first's bit for bit
        runs, ms_runs = {}, []
        adaptive = dict(confidence=ADAPTIVE_CONF)
        for tag, kw in (("fixed", {}), ("adaptive", adaptive), ("adaptive", adaptive)):
            iters = []
            (out, ms_) = timed(lambda: ep.ransac_fundamental_pairs_bucketed(
                items, n_iters=50000, samples=samples, device=dev, iters_out=iters, **kw))
            if tag in runs:
                assert all(np.array_equal(a.F, b.F) for a, b in zip(out, runs[tag][0]))
            runs[tag] = (out, iters, ms_)
            if tag == "adaptive":
                ms_runs.append(ms_)
        rec["adaptive_f"] = {"pairs": len(items), "cap": total,
                             "iters_scored": sorted(set(runs["adaptive"][1])),
                             "fixed_ms": runs["fixed"][2],
                             "host_ms": sum(ms_runs) / 2,
                             "host_ms_runs": ms_runs}

        # adaptive PnP, and the rescue card vs CPU, camera 3
        cam = 2
        vis = np.flatnonzero(gt["ok"][cam])
        X3, x2 = gt["points"][vis], gt["obs"][cam, vis].copy()
        bad = rng.random(len(vis)) < 0.3
        x2[bad] = rng.uniform([0, 0], [800, 600], (int(bad.sum()), 2))
        g = torch.Generator(device=dev).manual_seed(4)
        psamp = ep.draw_minimal_samples(-(-10000 // 512) * 512, 6, len(vis), g, dev)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
        pn, pn_ms = None, []
        for _ in range(2):
            (out, ms_) = timed(lambda: pnp_ops.pnp_ransac_adaptive(
                t(X3), t(x2), t(gt["K"]), confidence=ADAPTIVE_CONF, max_iters=10000,
                samples=psamp))
            if pn is not None:
                assert torch.equal(out[0].R, pn[0].R) and out[1] == pn[1]
            pn = out
            pn_ms.append(ms_)
        rs = {}
        rescue_seed = 3 * 31      # the pipeline's seed for camera 3 at --seed 0
        for name, d in sides:
            (out, ms_) = timed(lambda: pnp_ops.pnp_ransac_f64_host(
                rescue_seed, X3, x2, gt["K"], device=d))
            rs[name] = (out, ms_)
        rescue_same = bool(np.array_equal(rs["cuda"][0].inliers, rs["cpu"][0].inliers))
        rescue_diff = max(float(np.abs(rs["cuda"][0].R - rs["cpu"][0].R).max()),
                          float(np.abs(rs["cuda"][0].C - rs["cpu"][0].C).max()))
        rec["pnp"] = {"points": len(vis), "adaptive_iters_scored": pn[1],
                      "adaptive_n_inliers": int(pn[0].n_inliers),
                      "adaptive_host_ms": sum(pn_ms) / 2, "adaptive_host_ms_runs": pn_ms,
                      "rescue_same_inliers": rescue_same, "rescue_max_diff": rescue_diff,
                      "rescue_n_inliers": int(rs["cuda"][0].n_inliers),
                      "rescue_cuda_ms": rs["cuda"][1], "rescue_cpu_ms": rs["cpu"][1]}
        ok = (rot_diff <= AVG_TOL and cen_diff <= AVG_TOL and rp_diff <= AVG_TOL
              and rec["essential_5pt"]["same_inliers"] and e_diff <= E5_TOL
              and rescue_same and rescue_diff <= AVG_TOL)
        if not ok:
            raise AssertionError(f"sfm_global_ops: {rec}")
        emit("sfm_global_ops", **rec)

    def sfm_sharded():
        """Hypothesis-sharded F-RANSAC and point-sharded BA over two shards
        of the one card, each against its one-device call; the pipeline
        refuses more shards than cards."""
        from sfm_nerf_tpu_torch.config import SfMConfig
        from sfm_nerf_tpu_torch.io.sfm_data import parse_matching_files
        from sfm_nerf_tpu_torch.parallel.ba import bundle_adjust_sharded
        from sfm_nerf_tpu_torch.parallel.ransac import ransac_fundamental_sharded
        from sfm_nerf_tpu_torch.sfm.pipeline import SfMPipeline

        gt = state["gt"] if "gt" in state else write_sfm_dataset(
            os.path.join(out_root, "sfm_data"), SFM_CAMS, SFM_POINTS, SFM_WINDOW)
        matches, _, _ = parse_matching_files(os.path.join(out_root, "sfm_data"), SFM_CAMS)
        m = torch.as_tensor(matches[(1, 2)], device=dev)
        shards = [dev, dev]

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.time()
            r = fn()
            torch.cuda.synchronize()
            return r, time.time() - t0

        one, one_s = timed(lambda: ep.ransac_fundamental(
            m[:, 0:2], m[:, 2:4], n_iters=SHARDED_F_ITERS,
            generator=torch.Generator(device=dev).manual_seed(3)))
        two, two_s = timed(lambda: ransac_fundamental_sharded(
            m[:, 0:2], m[:, 2:4], shards, n_iters=SHARDED_F_ITERS,
            generator=torch.Generator(device=dev).manual_seed(3)))
        f_equal = bool(torch.equal(one.F, two.F))
        same = (int(one.best_iter) == int(two.best_iter) and torch.equal(one.inliers, two.inliers)
                and f_equal)
        rng = np.random.default_rng(2)
        from sfm_nerf_tpu_torch.ops.linalg import rotation_to_rvec

        rv = rotation_to_rvec(torch.as_tensor(gt["Rs"])).numpy()
        cams = np.concatenate([rv, -np.einsum("nij,nj->ni", gt["Rs"], gt["Cs"])], 1)
        cams = cams + rng.normal(0, 1e-3, cams.shape)
        pts = gt["points"] + rng.normal(0, 1e-2, gt["points"].shape)
        t = lambda a: torch.as_tensor(a, device=dev)
        args = (t(gt["K"]), t(cams), t(pts), t(gt["obs"]), t(gt["ok"].astype(np.float64)))
        b1, b1_s = timed(lambda: ba_ops.bundle_adjust(*args, n_iters=SHARDED_BA_ITERS))
        b2, b2_s = timed(lambda: bundle_adjust_sharded(*args, shards, n_iters=SHARDED_BA_ITERS))
        cost_rel = abs(float(b2.cost) / float(b1.cost) - 1)
        geom = max(float((b2.camera_params - b1.camera_params).abs().max()),
                   float((b2.points - b1.points).abs().max()))
        refused = []
        for kw in (dict(ransac_devices=torch.cuda.device_count() + 1),
                   dict(ba_devices=torch.cuda.device_count() + 1)):
            try:
                SfMPipeline(SfMConfig(**kw), device="cuda")
            except ValueError as e:
                refused.append(str(e))
        rec = {"ransac": {"matches": int(m.shape[0]), "hypotheses": SHARDED_F_ITERS,
                          "shards": len(shards), "bit_equal": same,
                          "best_iter": int(two.best_iter), "n_inliers": int(two.n_inliers),
                          "one_device_s": one_s, "sharded_s": two_s},
               "ba": {"cams": SFM_CAMS, "points": SFM_POINTS, "iters": SHARDED_BA_ITERS,
                      "shards": len(shards), "cost_rel_err": cost_rel,
                      "geometry_max_abs_diff": geom,
                      "cost": [float(b1.initial_cost), float(b2.cost)],
                      "one_device_s": b1_s, "sharded_s": b2_s},
               "refused": refused}
        if not same or cost_rel > BA_COST_REL_TOL or len(refused) != 2:
            raise AssertionError(f"sfm_sharded: {rec}")
        emit("sfm_sharded", **rec)

    phase(sfm)
    phase(sfm_ops)
    phase(sfm_sharded)
    phase(sfm_scale)
    phase(sfm_figures)
    phase(sfm_global)
    phase(sfm_global_ops)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _grad_rule(got, ref):
    """Per tensor: relative error of the norm and max error over the max,
    the worst of each; raises past GRAD_REL_TOL / GRAD_MAX_TOL."""
    worst = {"rel": 0.0, "max": 0.0}
    for k in ref:
        e = got[k] - ref[k]
        row = {"rel": e.norm().item() / ref[k].norm().item(),
               "max": e.abs().max().item() / ref[k].abs().max().item()}
        if row["rel"] > GRAD_REL_TOL or row["max"] > GRAD_MAX_TOL:
            raise AssertionError(f"grad {k}: {row}")
        worst = {m: max(worst[m], row[m]) for m in worst}
    return worst


def _dp2_rank(rank, port, out_dir, data):
    """One of dp2_one_card's two ranks: gloo, cuda:0.  Writes its record to
    ``out_dir/rank{rank}.json``; rank 0 also replays each step in one
    process and renders the one-device frame."""
    import faulthandler

    faulthandler.enable()     # a crash in a rank prints where it happened
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    from sfm_nerf_tpu_torch.config import NeRFModelConfig, NeRFPipelineConfig, RenderConfig
    from sfm_nerf_tpu_torch.config import TrainConfig
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset
    from sfm_nerf_tpu_torch.kernels import fused_render as fr
    from sfm_nerf_tpu_torch.kernels import fused_train as ft
    from sfm_nerf_tpu_torch.models.convert import params_from_jax, params_to_jax
    from sfm_nerf_tpu_torch.models.nerf import NeRF
    from sfm_nerf_tpu_torch.ops.rays import sample_ray_batch
    from sfm_nerf_tpu_torch.ops.render import stratified_samples
    from sfm_nerf_tpu_torch.parallel import mesh as pmesh
    from sfm_nerf_tpu_torch.parallel import train_step as pstep
    from sfm_nerf_tpu_torch.parallel.render import make_sharded_render_image
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt
    from sfm_nerf_tpu_torch.train.nerf_trainer import (
        make_loss_fn, make_optimizer, make_render_image,
    )
    from sfm_nerf_tpu_torch.utils.metrics import psnr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    pmesh.init_local("gloo", rank, 2, port, dev)
    rec = {"rank": rank, "backend": dist.get_backend()}
    try:
        f32 = dict(dtype=torch.float32, device=dev)
        images, poses, cam = load_blender_dataset(data, "train")
        scene = (torch.as_tensor(images, **f32), torch.as_tensor(poses, **f32),
                 torch.as_tensor(cam.camera_matrix, **f32))
        cfg = NeRFPipelineConfig(model=NeRFModelConfig(),
                                 render=RenderConfig(n_sample=256, use_fused_kernel=True),
                                 train=TrainConfig(n_rays_batch=DP2_RAYS))
        n_local = DP2_RAYS // 2

        def gen(i):
            return torch.Generator(device=dev).manual_seed(pstep.draw_seed(0, i))

        # 1. one data-parallel step: K2 on this rank's 4,096 rays
        mesh = pmesh.make_mesh(dp=2, tp=1, device_type="cuda")
        model = NeRF(cfg.model, device=dev, seed=0)
        opt, sched = make_optimizer(cfg, model)
        step = pstep.make_dp_train_step(cfg, opt, sched, mesh)
        ft.reset_launch_counts()
        loss = float(step(model, gen(step.draw_index), *scene))
        rec["dp"] = {"launches": dict(ft.LAUNCHES), "loss": loss,
                     "draw_index": step.draw_index}
        if rank == 0:
            # the replay: both ranks' draws concatenated, K2 on 8,192 rays
            parts = []
            for r in range(2):
                g = gen(r)
                o_, d_, t_ = sample_ray_batch(*scene, n_local, g)
                parts.append((o_, d_, stratified_samples(n_local, cfg.render, g, dev), t_))
            o, d, z, t = (torch.cat(x) for x in zip(*parts))
            packed = fr.pack_nerf_params(NeRF(cfg.model, device=dev, seed=0), cfg.model,
                                         torch.bfloat16)
            rgb, gw, gb = ft.fused_mse_loss_grads(packed, o, d, z, t, cfg.render)
            ref = ft.unpack_grads(packed, gw, gb)
            got = {n: p.grad for n, p in model.named_parameters()}
            ref_loss = torch.mean((rgb - t) ** 2).item()
            rec["dp"].update(replay_loss=ref_loss, loss_rel_err=abs(loss / ref_loss - 1),
                             grads_vs_replay=_grad_rule(got, ref),
                             grads_bit_equal=all(torch.equal(got[k], ref[k]) for k in ref))
            if rec["dp"]["loss_rel_err"] > LOSS_REL_TOL:
                raise AssertionError(f"dp step loss vs replay: {rec['dp']}")

        # 2. one dp1 x tp2 step: parameters sharded over 'model', K2 on the
        # gathered weights, 4,096 rays a rank
        grid = pmesh.make_mesh(dp=1, tp=2, device_type="cuda")
        model = NeRF(cfg.model, device=dev, seed=0)
        pstep.distribute_params(model, grid, pstep.mlp_param_placements(model, grid))
        opt, sched = make_optimizer(cfg, model)
        step = pstep.make_spmd_train_step(cfg, opt, sched, grid, model)
        ft.reset_launch_counts()
        loss = float(step(model, gen(step.draw_index), *scene))
        rec["spmd"] = {"launches": dict(ft.LAUNCHES), "loss": loss,
                       "draw_index": step.draw_index,
                       "local_fc2_0_weight": list(model.layers["fc2_0"].weight.to_local().shape)}
        after = params_to_jax(model)
        if rank == 0:
            fresh = NeRF(cfg.model, device=dev, seed=0)
            fopt, fsched = make_optimizer(cfg, fresh)
            loss_fn = make_loss_fn(cfg, n_rays=n_local)
            ref_loss = torch.stack([loss_fn(fresh, gen(r), *scene) for r in range(2)]).mean()
            ref_loss.backward()
            fopt.step()
            fsched.step()
            want = params_to_jax(fresh)
            diffs = [np.abs(after[k][kk] - want[k][kk]).max() for k in want for kk in ("w", "b")]
            close = all(np.allclose(after[k][kk], want[k][kk], rtol=SPMD_RTOL, atol=SPMD_ATOL)
                        for k in want for kk in ("w", "b"))
            rec["spmd"].update(replay_loss=float(ref_loss), params_max_abs_diff=float(max(diffs)),
                               params_bit_equal=all(np.array_equal(after[k][kk], want[k][kk])
                                                    for k in want for kk in ("w", "b")))
            if not close or abs(loss - float(ref_loss)) > 1e-5 * abs(float(ref_loss)):
                raise AssertionError(f"spmd step vs replay: {rec['spmd']}")

        # 3. an 800x800 view through the sharded frame renderer, K1 on half
        # of the rays a rank
        params, _ = ckpt.load_params_untyped(
            os.path.join(REPO, "Phase2", "checkpoints", "synth800", "final_model.ckpt.npz"))
        mcfg = ckpt.infer_model_config(params)
        net = params_from_jax(params, mcfg, dev).eval()
        timgs, tposes, tcam = load_blender_dataset(data, "test")
        H, W = timgs.shape[1:3]
        K = torch.as_tensor(tcam.camera_matrix, device=dev)
        pose = torch.as_tensor(tposes[0], device=dev)
        pcfg = NeRFPipelineConfig(model=mcfg, render=RenderConfig(
            n_sample=256, near=2.0, far=6.0, perturb=False, use_fused_kernel=True))
        fr.reset_launch_counts()
        img = make_sharded_render_image(pcfg, mesh)(net, K, pose, H, W)
        torch.cuda.synchronize()
        rec["frame"] = {"launches": dict(fr.LAUNCHES), "shape": list(img.shape)}
        if rank == 0:
            one = make_render_image(pcfg)(net, K, pose, H, W)
            gt = torch.as_tensor(timgs[0], device=dev)
            rec["frame"].update(max_abs=(img - one).abs().max().item(), psnr_vs_one_device=psnr(img, one),
                                bit_equal=bool(torch.equal(img, one)),
                                psnr_vs_ground_truth=psnr(img, gt))
            if rec["frame"]["max_abs"] > RGB_TOL or rec["frame"]["psnr_vs_one_device"] < PSNR_PLAIN:
                raise AssertionError(f"sharded frame: {rec['frame']}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def run_parallel_phases(phase, data, train_flags, state):
    """dp_train and dp2_one_card (see the module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from sfm_nerf_tpu_torch.cli import nerf as cli
    from sfm_nerf_tpu_torch.kernels import fused_train as ft
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tree[k]

    def dp_train():
        out = {}
        for tag, extra, steps, per_step in (
                ("flat", [], DP_STEPS, {"fused_mse_loss": 1}),
                ("hier", ["--n_importance", str(N_IMPORTANCE)], DP_HIER_STEPS,
                 {"fused_mse_loss_weights": 1, "fused_mse_loss": 1})):
            runs = {}
            for side in ("one_device", "dp"):
                ck = os.path.join(OUT, f"dp_train_{tag}_{side}")
                shutil.rmtree(ck, ignore_errors=True)
                env = {} if side == "one_device" else {
                    "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                    "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
                os.environ.update(env)
                try:
                    ft.reset_launch_counts()
                    stats = cli.main([*train_flags, *extra, "--checkpoint_path", ck,
                                      "--max_iters", str(steps), "--log_every", "1",
                                      "--val_every", "0", "--save_ckpt_iter", "0"])
                    launches = dict(ft.LAUNCHES)
                    backend = dist.get_backend() if dist.is_initialized() else None
                finally:
                    if dist.is_initialized():
                        dist.destroy_process_group()
                    for k in env:
                        os.environ.pop(k)
                want = {k: per_step.get(k, 0) * steps for k in launches}
                mesh_want = None if side == "one_device" else {"data": 1, "model": 1}
                if (launches != want or stats["steps"] != steps or stats["mesh"] != mesh_want
                        or backend != (None if side == "one_device" else "nccl")):
                    raise AssertionError(f"dp_train {tag} {side}: launches {launches}, "
                                         f"mesh {stats['mesh']}, backend {backend}")
                params, _ = ckpt.load_params_untyped(
                    os.path.join(ck, "synth800", "final_model.ckpt.npz"))
                runs[side] = dict(leaves(params))
                out[f"{tag}_{side}"] = {"ms_per_step": stats["ms_per_step"],
                                        "final_loss": stats["final_loss"],
                                        "launches": launches, "backend": backend}
            diff = max(float(np.abs(runs["dp"][k] - runs["one_device"][k]).max())
                       for k in runs["dp"])
            equal = all(np.array_equal(runs["dp"][k], runs["one_device"][k])
                        for k in runs["one_device"])
            out[f"{tag}_params_bit_equal"] = equal
            out[f"{tag}_params_max_abs_diff"] = diff
            if not equal or set(runs["dp"]) != set(runs["one_device"]):
                raise AssertionError(f"dp_train {tag}: parameters differ by {diff}")
        flat_dp, flat_one = out["flat_dp"]["ms_per_step"], out["flat_one_device"]["ms_per_step"]
        emit("dp_train", steps=[DP_STEPS, DP_HIER_STEPS], **out,
             dp_over_one_device_ms=flat_dp / flat_one,
             train_phase_ms_per_step=state.get("train_ms_per_step"))

    def dp2_one_card():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out_dir = os.path.join(OUT, "dp2_one_card")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        t0 = time.time()
        ctx = mp.start_processes(_dp2_rank, args=(_free_port(), out_dir, data), nprocs=2,
                                 join=False, start_method="spawn")
        while not ctx.join(timeout=5):
            if time.time() - t0 > DP2_TIMEOUT:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"dp2_one_card: a rank outlived {DP2_TIMEOUT} s")
        recs = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        for r, rec in enumerate(recs):
            if (rec["backend"] != "gloo" or rec["dp"]["launches"]["fused_mse_loss"] != 1
                    or rec["spmd"]["launches"]["fused_mse_loss"] != 1
                    or rec["frame"]["launches"]["fused_render_rays"] != 1
                    or rec["dp"]["draw_index"] != r or rec["spmd"]["draw_index"] != r):
                raise AssertionError(f"dp2_one_card rank {r}: {rec}")
        if recs[0]["dp"]["loss"] != recs[1]["dp"]["loss"]:
            raise AssertionError("dp2_one_card: the ranks' averaged losses differ")
        emit("dp2_one_card", wall_s=round(time.time() - t0, 1), rank0=recs[0],
             rank1_launches={k: recs[1][k]["launches"] for k in ("dp", "spmd", "frame")})

    phase(dp_train)
    phase(dp2_one_card)


# ---- profiling, async checkpoints, interrupts, Wrapper, gif, scene ---------
PROFILE_WARMUP, PROFILE_STEPS = 5, 20
ASYNC_STEPS, ASYNC_EVERY = 40, 10
INTERRUPT_AFTER = 15                  # SIGINT once this step's checkpoint exists
INTERRUPT_TIMEOUT = 300               # s for a child to reach it
WRAPPER_STEPS, WRAPPER_VIEWS = 20, 2
# depth cut for time: these phases train on the first TOOL_VIEWS of
# synth800's 100 training views (a full split takes ~25 s to decode, and
# they load it seven times); rays, samples and the model are full width
TOOL_VIEWS = 10
GIF_MEAN_ERR = 2.0                    # mean abs levels of 255, GIF frame vs its PNG
SYNTH_OFF, SYNTH_FRAC = 0.05, 0.01    # tests/test_synth_scene.py's rule: under 1% of
SYNTH_MEDIAN = 1 / 255 + 1e-3         # pixels more than 0.05 off, the median at most this
# the kernels' names in a trace: K1 is the render kernel; a K2 step the
# render kernel's STASH sweep, the reverse walk, the weight GEMM, the sums
K1_KERNELS = ("fused_render_kernel",)
K2_KERNELS = ("fused_render_kernel", "reverse_walk_kernel", "grad_gemm_kernel",
              "reduce_add_kernel")


def _views(data, split, n):
    """A dataset of ``data``'s first ``n`` frames of ``split``: a directory
    named as ``data`` (checkpoints go under the same scene name) holding
    the cut json and a link to the images.  Returns its path with a
    trailing slash."""
    scene = os.path.basename(data.rstrip("/"))
    root = os.path.join(OUT, f"views_{split}{n}", scene)
    shutil.rmtree(os.path.dirname(root), ignore_errors=True)
    os.makedirs(root)
    os.symlink(os.path.join(data, split), os.path.join(root, split))
    with open(os.path.join(data, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    meta["frames"] = meta["frames"][:n]
    with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
        json.dump(meta, f)
    return root + "/"


def _named_ms(summary, names):
    """Device ms of the summary's kernels whose names hold one of ``names``
    (top_kernels holds every name when ``top`` is large)."""
    return sum(k["ms"] for k in summary["top_kernels"] if any(n in k["name"] for n in names))


def run_tool_phases(phase, data, train_flags, state):
    """profile, async_ckpt, interrupt, wrapper, gif_writer and synth_scene
    (see the module docstring)."""
    import signal

    import numpy as np
    import torch

    from sfm_nerf_tpu_torch.cli import gif as cli_gif
    from sfm_nerf_tpu_torch.cli import nerf as cli
    from sfm_nerf_tpu_torch.cli import synth_scene as ss
    from sfm_nerf_tpu_torch.cli import wrapper as cli_wrapper
    from sfm_nerf_tpu_torch.config import (
        NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig,
    )
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset, load_camera_info
    from sfm_nerf_tpu_torch.io.gif import read_gif
    from sfm_nerf_tpu_torch.io.png import read_png
    from sfm_nerf_tpu_torch.kernels import fused_render as fr
    from sfm_nerf_tpu_torch.kernels import fused_train as ft
    from sfm_nerf_tpu_torch.models.convert import params_from_jax, params_to_jax
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt
    from sfm_nerf_tpu_torch.train.nerf_trainer import (
        NeRFTrainer, make_render_image, make_schedule,
    )
    from sfm_nerf_tpu_torch.utils import profiling as prof

    dev = torch.device("cuda")
    full_data = data
    data = _views(full_data, "train", TOOL_VIEWS)
    train_flags = [data if f == full_data else f for f in train_flags]

    def profile():
        images, poses, cam = load_blender_dataset(data, "train")
        cfg = NeRFPipelineConfig(
            model=NeRFModelConfig(),
            render=RenderConfig(n_sample=256, near=2.0, far=6.0, use_fused_kernel=True),
            train=TrainConfig(n_rays_batch=8192, log_every=0, val_every=0, save_ckpt_iter=0),
            checkpoint_path=os.path.join(OUT, "profile_ckpt"), load_checkpoint=False)
        tr = NeRFTrainer(cfg, images, poses, cam.camera_matrix, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        timer = prof.StepTimer("cuda")

        def step():
            with timer:
                tr.train_step(tr.model, gen, tr.images, tr.poses, tr.K)

        for _ in range(PROFILE_WARMUP):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ft.reset_launch_counts()
        with prof.trace(os.path.join(OUT, "profile_train")) as p:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                step()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
        launches = dict(ft.LAUNCHES)
        if launches != {k: (PROFILE_STEPS if k == "fused_mse_loss" else 0) for k in launches}:
            raise AssertionError(f"profile: train launches {launches}")
        train = prof.profile_summary(p, top=50)
        k2_ms = _named_ms(train, K2_KERNELS)
        if k2_ms <= 0:
            raise AssertionError(f"profile: no device time for K2's kernels: {train}")
        memory = prof.device_memory_stats()
        # one 800x800x256 synth800 test view through K1
        params, _ = ckpt.load_params_untyped(
            os.path.join(REPO, "Phase2", "checkpoints", "synth800", "final_model.ckpt.npz"))
        mcfg = ckpt.infer_model_config(params)
        model = params_from_jax(params, mcfg, dev).eval()
        vcfg = NeRFPipelineConfig(model=mcfg, render=RenderConfig(
            n_sample=256, near=2.0, far=6.0, perturb=False, use_fused_kernel=True))
        t_cam = load_camera_info(full_data, "test")
        with open(os.path.join(full_data, "transforms_test.json")) as f:
            c2w = json.load(f)["frames"][0]["transform_matrix"]
        H, W = t_cam.height, t_cam.width
        K = torch.as_tensor(t_cam.camera_matrix, device=dev)
        pose = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
        render = make_render_image(vcfg)
        render(model, K, pose, 64, 64)                 # packs the weights, warms up
        torch.cuda.synchronize()
        fr.reset_launch_counts()
        with prof.trace(os.path.join(OUT, "profile_view")) as p:
            t0 = time.perf_counter()
            frame = render(model, K, pose, H, W).cpu()
            view_host_ms = (time.perf_counter() - t0) * 1e3
        if dict(fr.LAUNCHES) != {k: int(k == "fused_render_rays") for k in fr.LAUNCHES}:
            raise AssertionError(f"profile: view launches {fr.LAUNCHES}")
        view = prof.profile_summary(p, top=20)
        k1_ms = _named_ms(view, K1_KERNELS)
        if k1_ms <= 0 or not bool(torch.isfinite(frame).all()):
            raise AssertionError(f"profile: no device time for K1: {view}")
        steady = timer.summary()
        state["profile"] = dict(idle=train["idle_share"], host_ms=host_ms,
                                view_host_ms=view_host_ms, k1_ms=k1_ms)
        emit("profile",
             train={"steps": PROFILE_STEPS, "warmup": PROFILE_WARMUP, "launches": launches,
                    "train_views": TOOL_VIEWS,
                    "host_ms_per_step": host_ms, "K2_kernels_ms_per_step": k2_ms / PROFILE_STEPS,
                    **{k: v for k, v in train.items() if k != "top_kernels"},
                    "top_kernels": train["top_kernels"][:10], "step_timer": steady,
                    "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
                    "device_memory": memory},
             view={"rays": H * W, "samples": 256, "launches": dict(fr.LAUNCHES),
                   "host_ms": view_host_ms, "K1_kernel_ms": k1_ms,
                   **{k: v for k, v in view.items() if k != "top_kernels"},
                   "top_kernels": view["top_kernels"][:10]})

    def async_ckpt():
        out, final = {}, {}
        for backend in ("npz", "orbax"):
            ck = os.path.join(OUT, f"async_{backend}")
            shutil.rmtree(ck, ignore_errors=True)
            ft.reset_launch_counts()
            stats = cli.main([*train_flags, "--checkpoint_path", ck, "--ckpt_backend", backend,
                              "--max_iters", str(ASYNC_STEPS), "--save_ckpt_iter",
                              str(ASYNC_EVERY), "--log_every", "5", "--val_every", "0"])
            d = os.path.join(ck, "synth800")
            files = sorted(os.listdir(d))
            want = [f"model_{s:06d}.ckpt.npz" for s in range(ASYNC_EVERY, ASYNC_STEPS, ASYNC_EVERY)]
            want += ["final_model.ckpt.npz"] if backend == "npz" else \
                [f"model_{ASYNC_STEPS - 1:06d}.ckpt.npz"]
            if files != sorted(want) or ft.LAUNCHES["fused_mse_loss"] != ASYNC_STEPS:
                raise AssertionError(f"async_ckpt {backend}: files {files}, launches {ft.LAUNCHES}")
            steps = []
            for name in files:
                _, opt_state, step = ckpt.load_checkpoint(os.path.join(d, name))
                if opt_state["count"] != step + 1:
                    raise AssertionError(f"async_ckpt {backend}: {name} count "
                                         f"{opt_state['count']}, step {step}")
                steps.append(step)
            last = files[int(np.argmax(steps))]
            params, _ = ckpt.load_params_untyped(os.path.join(d, last))
            held = params_to_jax(stats["model"])
            equal = all(np.array_equal(params[k][w], held[k][w]) for k in held for w in ("w", "b"))
            if not equal:
                raise AssertionError(f"async_ckpt {backend}: {last} differs from the trainer's")
            final[backend] = params
            out[backend] = {"ms_per_step": stats["ms_per_step"], "files": files,
                            "last_file_bit_equal_to_trainer": equal,
                            "elapsed_s": stats["elapsed_s"], "final_loss": stats["final_loss"]}
        resumed = cli.main([*train_flags, "--checkpoint_path", os.path.join(OUT, "async_orbax"),
                            "--ckpt_backend", "orbax", "--max_iters", str(ASYNC_STEPS + 2),
                            "--save_ckpt_iter", "0", "--log_every", "1", "--val_every", "0"])
        if resumed["start_iter"] != ASYNC_STEPS or resumed["steps"] != 2:
            raise AssertionError(f"async_ckpt resume: {resumed['start_iter']}, "
                                 f"{resumed['steps']} steps")
        same_run = all(np.array_equal(final["npz"][k][w], final["orbax"][k][w])
                       for k in final["npz"] for w in ("w", "b"))
        emit("async_ckpt", steps=ASYNC_STEPS, save_every=ASYNC_EVERY, train_views=TOOL_VIEWS,
             **out,
             orbax_over_npz_ms=out["orbax"]["ms_per_step"] / out["npz"]["ms_per_step"],
             npz_and_orbax_runs_bit_equal=same_run,
             resume={"start_iter": resumed["start_iter"], "steps": resumed["steps"]})

    def interrupt():
        out = {}
        for backend in ("npz", "orbax"):
            ck = os.path.join(OUT, f"interrupt_{backend}")
            shutil.rmtree(ck, ignore_errors=True)
            d = os.path.join(ck, "synth800")
            log_path = os.path.join(OUT, f"interrupt_{backend}.log")
            t0 = time.time()
            with open(log_path, "w") as log:
                # a SIGINT ignored by this process's starter must reach the child
                child = subprocess.Popen(
                    [sys.executable, "-m", "sfm_nerf_tpu_torch.cli.nerf", *train_flags,
                     "--checkpoint_path", ck, "--ckpt_backend", backend, "--max_iters", "100000",
                     "--save_ckpt_iter", str(INTERRUPT_AFTER), "--log_every", "100000",
                     "--val_every", "0"], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                    preexec_fn=lambda: signal.signal(signal.SIGINT, signal.SIG_DFL))
                try:
                    mark = os.path.join(d, f"model_{INTERRUPT_AFTER:06d}.ckpt.npz")
                    while not os.path.exists(mark):
                        if child.poll() is not None or time.time() - t0 > INTERRUPT_TIMEOUT:
                            raise AssertionError(f"interrupt {backend}: no step "
                                                 f"{INTERRUPT_AFTER} checkpoint")
                        time.sleep(0.05)
                    child.send_signal(signal.SIGINT)
                    rc = child.wait(timeout=120)
                finally:
                    if child.poll() is None:
                        child.kill()
                        child.wait()
            with open(log_path) as f:
                text = f.read()
            path = ckpt.latest_checkpoint(d)
            _, opt_state, stamp = ckpt.load_checkpoint(path)
            if ("KeyboardInterrupt: saving checkpoint" not in text or rc == 0
                    or stamp != opt_state["count"] - 1 or stamp < INTERRUPT_AFTER):
                raise AssertionError(f"interrupt {backend}: rc {rc}, {path} stamp {stamp}, "
                                     f"count {opt_state['count']}:\n{text[-2000:]}")
            files, child_s = sorted(os.listdir(d)), round(time.time() - t0, 1)
            resumed = cli.main([*train_flags, "--checkpoint_path", ck, "--ckpt_backend", backend,
                                "--max_iters", str(stamp + 3), "--save_ckpt_iter", "0",
                                "--log_every", "1", "--val_every", "0"])
            if resumed["start_iter"] != stamp + 1 or resumed["steps"] != 2:
                raise AssertionError(f"interrupt {backend} resume: {resumed['start_iter']}")
            out[backend] = {"returncode": rc, "stamp": stamp, "adam_count": opt_state["count"],
                            "files_at_exit": files, "child_s": child_s,
                            "resume_start_iter": resumed["start_iter"]}
        emit("interrupt", after_step=INTERRUPT_AFTER, train_views=TOOL_VIEWS, **out)

    def wrapper():
        ck = os.path.join(OUT, "wrapper_ckpt")
        shutil.rmtree(ck, ignore_errors=True)
        argv = ["--data_path", data, "--checkpoint_path", ck]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ft.reset_launch_counts()
        stats = cli_wrapper.main(["--mode", "train", *argv, "--max_iters", str(WRAPPER_STEPS),
                              "--save_ckpt_iter", "0"])
        peak = torch.cuda.max_memory_allocated()
        if any(ft.LAUNCHES.values()) or stats["steps"] != WRAPPER_STEPS \
                or not np.isfinite(stats["final_loss"]):
            raise AssertionError(f"wrapper train: launches {ft.LAUNCHES}, {stats['steps']} steps")
        cfg = cli.build_config(cli_wrapper.delegated_args(
            cli_wrapper.config_parser().parse_args(["--mode", "train", *argv])))
        schedule = make_schedule(cfg)
        # test mode renders the train split (the reference's quirk), here of
        # WRAPPER_VIEWS views; the checkpoint is found under the same scene
        fr.reset_launch_counts()
        records = cli_wrapper.main(["--mode", "test", "--data_path",
                                    _views(full_data, "train", WRAPPER_VIEWS),
                                "--checkpoint_path", ck, "--images_path",
                                os.path.join(OUT, "wrapper_test")])
        launches = dict(fr.LAUNCHES)
        if launches != {k: WRAPPER_VIEWS * (k == "fused_render_rays") for k in launches} \
                or len(records) != WRAPPER_VIEWS or not all(np.isfinite(r["mse"]) for r in records):
            raise AssertionError(f"wrapper test: launches {launches}, views {records}")
        emit("wrapper", train={
                 "steps": stats["steps"], "route": "nn.Module (legacy compositor)",
                 "train_views": TOOL_VIEWS,
                 "ms_per_step_whole_fit": stats["elapsed_s"] * 1e3 / stats["steps"],
                 "final_loss": stats["final_loss"], "peak_mem_gib": round(peak / 2**30, 3),
                 "near_far_variant": [cfg.render.near, cfg.render.far, cfg.render.variant],
                 "lr_at_step": {"0": schedule(0), "1000": schedule(1000)}},
             test={"views": [{k: round(v, 4) if isinstance(v, float) else v
                              for k, v in r.items()} for r in records], "launches": launches})

    def gif_writer():
        frames_dir = os.path.join(OUT, "synth800_legacy")
        out = os.path.join(OUT, "turntable.gif")
        t0 = time.perf_counter()
        res = cli_gif.main(["--images_path", frames_dir, "--out", out])
        write_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got, delays = read_gif(out)
        read_ms = (time.perf_counter() - t0) * 1e3
        errs = []
        for p, frame, held in zip(res["frames"], got, res["written"]):
            src = read_png(p)[..., :3][..., ::-1].astype(int)
            errs.append(float(np.abs(frame.astype(int) - src).mean()))
            if not np.array_equal(frame, held):
                raise AssertionError(f"gif_writer: {p} does not decode to what was written")
        if len(got) != len(res["frames"]) or len(got) < 2 or delays != [50] * len(got) \
                or max(errs) > GIF_MEAN_ERR:
            raise AssertionError(f"gif_writer: {len(got)} frames, delays {delays}, errors {errs}")
        emit("gif_writer", frames=len(got), shape=list(got.shape[1:]), delays_cs=delays,
             mean_abs_err_per_frame=errs, bytes=os.path.getsize(out), write_ms=write_ms,
             read_ms=read_ms)

    def synth_scene():
        out = {}
        rig = ss.camera_rig(100, 16, 0)
        for family, scene_name, background, views in (("synth800", "spheres", "black", 4),
                                                      ("chair800", "chair", "white", 1)):
            root = os.path.join(REPO, "Phase2", "nerf_synthetic", family)
            with open(os.path.join(root, "transforms_train.json")) as f:
                frames = json.load(f)["frames"]
            from_json = [np.asarray(fm["transform_matrix"]) for fm in frames]
            rig_poses = all(np.allclose(a, b, rtol=0, atol=1e-12)
                            for a, b in zip(from_json, rig["train"]))
            poses = rig["train"] if rig_poses else from_json
            scene = ss.Scene()
            scene.set_scene(scene_name)
            scene.set_background(background)
            ss.render_view(poses[0], 64, scene, dev)     # warm-up
            rows = []
            for i in range(views):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = ss.render_view(poses[i], 800, scene, dev)       # ends in a host copy
                ms = (time.perf_counter() - t0) * 1e3
                ours = (img * 255 + 0.5).astype(np.uint8).astype(np.float64) / 255
                ref = read_png(os.path.join(root, "train", f"r_{i}.png"))[..., :3] / 255.0
                diff = np.abs(ours - ref)
                row = {"view": i, "ms": ms, "frac_over_0.05": float((diff > SYNTH_OFF).mean()),
                       "median": float(np.median(diff)), "max": float(diff.max())}
                if row["frac_over_0.05"] >= SYNTH_FRAC or row["median"] > SYNTH_MEDIAN:
                    raise AssertionError(f"synth_scene {family} r_{i}: {row}")
                rows.append(row)
            out[family] = {"poses_from": "camera_rig(100, 16, 0)" if rig_poses else "json",
                           "views": rows}
        small = os.path.join(OUT, "synth_small")
        shutil.rmtree(small, ignore_errors=True)
        res = ss.main(["--out", small, "--size", "800", "--n_train", "4", "--n_test", "2"])
        tr_images, _, tr_cam = load_blender_dataset(small, "train")
        te_images, _, _ = load_blender_dataset(small, "test")
        if tr_images.shape != (4, 800, 800, 3) or te_images.shape != (2, 800, 800, 3) \
                or tr_cam.width != 800 or not 0.02 < float((tr_images.sum(-1) > 0).mean()) < 0.9:
            raise AssertionError(f"synth_scene dataset: {tr_images.shape}, {te_images.shape}")
        emit("synth_scene", **out, dataset={"views": [4, 2], "size": 800,
                                            "ms_per_view": res["ms_per_view"]})

    phase(profile)
    phase(async_ckpt)
    phase(interrupt)
    phase(wrapper)
    phase(gif_writer)
    phase(synth_scene)


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
    from sfm_nerf_tpu_torch.models.convert import params_from_jax, params_to_jax
    from sfm_nerf_tpu_torch.ops.rays import image_rays, sample_ray_batch
    from sfm_nerf_tpu_torch.ops.render import (
        composite, merge_sorted, sample_pdf, stratified_samples,
    )
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt
    from sfm_nerf_tpu_torch.train.nerf_trainer import (
        make_render_image, make_render_image_aux,
    )
    from sfm_nerf_tpu_torch.utils import profiling
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
        """One more call of a split-step wrapper with its spans recorded:
        device ms per launch class (k2.stash, k2.walk, k2.gemm, k2.reduce)."""
        with profiling.recording():
            run()
        torch.cuda.synchronize()
        spans = profiling.summary()["spans"]
        return {k: round(v["device_ms"], 3) for k, v in spans.items() if k.startswith("k2.")}

    def grads_cmp(name, packed_, got, ref, f64, tc=None, tol=(GRAD_REL_TOL, GRAD_MAX_TOL)):
        """A kernel's (gw, gb) against the plain version's, per parameter
        tensor: within tol[0] (GRAD_REL_TOL) of the tensor's norm and tol[1]
        (GRAD_MAX_TOL) of its largest value, or within the plain version's float32-vs-float64
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
            return (row["rel"] <= max(tol[0], row["spread_rel"])
                    and row["max"] <= max(tol[1], row["spread_max"]))

        for k in ref:
            if not ref[k].any():        # a layer the forward never reads (density_fc)
                if got[k].any():
                    raise AssertionError(f"{name}: grad {k} of an unread layer is not 0")
                continue
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
    # each path's kernel launches, read just after its counts were set to 0
    paths = state["launch_paths"] = {}

    # ---- 2. serve: test mode through K1 ----------------------------------
    def serve():
        make_render_image(cfg)(model, K, pose, 64, 64)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fr.reset_launch_counts()
        with timed_calls(cli, ["save_test_figure"], state.setdefault("figure_s", {})):
            records = cli.main([
                "--mode", "test", "--data_path", data, "--checkpoint_path", ckpt_root,
                "--images_path", os.path.join(OUT, "test"), "--n_sample", "256"])
        launches = dict(fr.LAUNCHES)
        state["serve_records"] = records
        peak = torch.cuda.max_memory_allocated()
        if launches["fused_render_rays"] < 1:
            raise AssertionError(f"serve path launched no K1: {launches}")
        if len(records) != 5 or min(r["psnr"] for r in records) < PSNR_GT_FLOOR:
            raise AssertionError(f"serve: views {records}")
        paths["serve"] = {"fused_render_rays": launches["fused_render_rays"]}
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
        paths["aux"] = {"fused_render_rays_weights": launches["fused_render_rays_weights"]}
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
            ("synth800_legacy", GIF_LEGACY_FLAGS, dict(near=1.0, far=10.0, variant="legacy")),
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

    # ---- 4b. figures: figure_{i}.png of the serve phase, --plot_rays -----
    def figures():
        from sfm_nerf_tpu_torch.cli import wrapper as cli_wrapper
        from sfm_nerf_tpu_torch.io.figure import Canvas

        test_dir = os.path.join(OUT, "test", "synth800")
        panels = []
        for i, rec in enumerate(state["serve_records"]):
            fig = read_png(os.path.join(test_dir, f"figure_{i}.png"))
            gt8 = read_png(os.path.join(test_dir, f"test_{i}_gt.png"))
            pred8 = read_png(os.path.join(test_dir, f"test_{i}_pred.png"))
            if fig.shape != (900, 1800, 3):
                raise AssertionError(f"figure_{i}.png: shape {fig.shape}")
            # the right panel against test_{i}_pred.png resampled into its box
            box = cli.build_test_figure(gt8, pred8, rec["mse"]).axes[1].active_box(1800, 900)
            cv = Canvas(1800, 900)
            cv.image(pred8 / 255.0, box)
            want = cv.to_uint8()
            c0, c1 = int(np.ceil(box[0])) + 1, int(np.floor(box[2])) - 1
            r0, r1 = 900 - int(np.floor(box[3])) + 1, 900 - int(np.ceil(box[1])) - 1
            p = psnr(fig[r0:r1, c0:c1] / 255.0, want[r0:r1, c0:c1] / 255.0)
            if p < FIGURE_PSNR:
                raise AssertionError(f"figure_{i}.png: right panel at {p:.2f} dB")
            panels.append({"view": rec["view"], "panel_box": [round(v, 2) for v in box],
                           "psnr": round(p, 2)})
        # --plot_rays: one synth800 frame through K1 and its ray fan
        out_dir = os.path.join(OUT, "plot_rays")
        shutil.rmtree(out_dir, ignore_errors=True)
        secs = {}
        fr.reset_launch_counts()
        with timed_calls(cli, ["save_ray_plot"], secs):
            # the gif phase's turntable, which faces the scene, cut to one frame
            records = cli_wrapper.main([
                "--mode", "gif", "--plot_rays", *GIF_LEGACY_FLAGS, "--n_frames", "1",
                "--data_path", data, "--checkpoint_path", ckpt_root, "--images_path", out_dir,
                "--no_perturb", "--n_sample", "256"])
        launches = dict(fr.LAUNCHES)
        if launches != {k: int(k == "fused_render_rays") for k in launches} \
                or len(records) != 1:
            raise AssertionError(f"plot_rays: launches {launches}, {len(records)} frames")
        paths["plot_rays"] = {"fused_render_rays": launches["fused_render_rays"]}
        plot = read_png(os.path.join(out_dir, "ray_plot_1.png"))
        fan = plot.astype(float).std(-1) > 30          # the coloured segments
        if plot.shape != (1200, 1200, 3) or fan.mean() < 0.01:
            raise AssertionError(f"ray_plot_1.png: {plot.shape}, fan share {fan.mean()}")
        cam_g = load_camera_info(data, "train")
        og, dg = image_rays(torch.as_tensor(cam_g.camera_matrix, device=dev),
                            torch.as_tensor(records[0]["pose"], dtype=torch.float32,
                                            device=dev), cam_g.height, cam_g.width)
        rc = RenderConfig(n_sample=256, perturb=False, near=1.0, far=10.0, variant="legacy")
        zg = stratified_samples(og.shape[0], rc, None, dev)
        k1 = check_plain("plot_rays frame", packed, og, dg, zg, rc)
        frame = read_png(records[0]["path"]) / 255.0
        if frame.std() < 0.02:
            raise AssertionError(f"plot_rays: a blank frame (std {frame.std()})")
        ys, xs = np.nonzero(fan)
        emit("figures", figure_i=panels, figure_s=state["figure_s"]["save_test_figure"],
             plot_rays={"launches": launches, "kernel_vs_plain": {"rays": SUBSET, **k1},
                        "frame_ms": records[0]["ms"], "frame_std": float(frame.std()),
                        "ray_plot_s": secs["save_ray_plot"],
                        "rays_drawn": -(-cam_g.height * cam_g.width // 50),
                        "fan_bbox": [int(xs.min()), int(ys.min()), int(xs.max()),
                                     int(ys.max())]})

    # ---- 5. train: the CLI's train mode through K2 ------------------------
    train_ckpt = os.path.join(OUT, "train_ckpt")
    train_flags = ["--mode", "train", "--data_path", data, "--n_sample", "256",
                   "--n_rays_batch", "8192", "--seed", "0",
                   "--logs_path", os.path.join(OUT, "logs")]

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
        stats = cli.main([*train_flags, *extra, "--checkpoint_path", ck, "--exp_name", tag,
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
        # resume from the mid-run checkpoint for a few steps, validating
        # after the last one (the model the final checkpoint holds)
        fr.reset_launch_counts()
        ft.reset_launch_counts()
        end = half + 1 + RESUME_STEPS
        resumed = cli.main([*train_flags, *extra, "--checkpoint_path", ck, "--exp_name", tag,
                            "--max_iters", str(end), "--log_every", "1",
                            "--val_every", str(end - 1), "--save_ckpt_iter", "0"])
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
                    "val_views": len(val), "val_mse": val, "launches": dict(fr.LAUNCHES)},
            events=[{k: r[k] for k in ("events", "writer_s", "elapsed_s", "losses", "val")}
                    for r in (stats, resumed)])

    def train():
        launches, record = train_run("train", train_ckpt, [], {"fused_mse_loss": 1},
                                     {"fused_render_rays": 1})
        paths["train"] = {"fused_mse_loss": launches["fused_mse_loss"]}
        state["train_ms_per_step"] = record["ms_per_step"]
        state["train_events"] = record.pop("events")
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
        paths["train_two_kernel"] = {
            k: launches[k] for k in ("fused_render_train", "fused_render_train_backward")}
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
        paths["train_hier"] = {"fused_mse_loss_weights": launches["fused_mse_loss_weights"]}
        record.pop("events")
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
        if launches != {k: 2 * (k in ("fused_render_rays", "fused_render_rays_weights"))
                        for k in launches}:
            raise AssertionError(f"serve_hier: launches {launches} for 2 views")
        if len(records) != 2 or not all(np.isfinite(r["psnr"]) for r in records):
            raise AssertionError(f"serve_hier: views {records}")
        fr.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        aux_ms, (rgb, depth, disp, acc) = event_ms(
            lambda: make_render_image_aux(hcfg)(pair, K, pose, H, W))
        aux_launches, aux_peak = dict(fr.LAUNCHES), torch.cuda.max_memory_allocated()
        if aux_launches != {k: 2 * (k == "fused_render_rays_weights") for k in aux_launches}:
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


    # ---- 10b. mip: the cone kernels, the mip step and a mip frame -----------
    def mip():
        from sfm_nerf_tpu_torch.config import NeRFModelConfig
        from sfm_nerf_tpu_torch.models.nerf import NeRF
        from sfm_nerf_tpu_torch.ops.rays import image_cones
        from sfm_nerf_tpu_torch.ops.render import cone_edges, resample_edges
        from sfm_nerf_tpu_torch.train.nerf_trainer import make_loss_fn

        m_cfg = NeRFModelConfig(arch="mip", n_pos_freq=16, n_dir_freq=4,
                                density_bias_init=-1.0)
        net = NeRF(m_cfg, device=dev, seed=MIP_SEED)
        m_rcfg = RenderConfig(n_sample=MIP_INTERVALS, near=2.0, far=6.0, perturb=True,
                              use_fused_kernel=True, white_background=True)
        m_pipe = NeRFPipelineConfig(model=m_cfg, render=m_rcfg)
        pk = fr.pack_nerf_params(net, m_cfg, torch.bfloat16)
        tr_images, tr_poses, tr_cam = load_blender_dataset(data, "train")
        f32 = dict(dtype=torch.float32, device=dev)
        imgs, pss = torch.as_tensor(tr_images, **f32), torch.as_tensor(tr_poses, **f32)
        Kt = torch.as_tensor(tr_cam.camera_matrix, **f32)
        gen = torch.Generator(device=dev).manual_seed(MIP_SEED)
        n = 8192
        bo, bd, bc, bt = sample_ray_batch(imgs, pss, Kt, n, gen, cones=True)
        t_c = cone_edges(n, m_rcfg, gen, dev)

        def mids(t):
            return 0.5 * (t[:, 1:] + t[:, :-1])

        inf = float("inf")

        def vs_plain(name, t, weights):
            """The cone step kernel on the edges t against its plain version:
            times, rgb, loss and weight errors, the grad rule."""
            ms, out = event_ms(lambda: ft.fused_mse_loss_cones_grads(
                pk, bo, bd, bc, t, bt, m_rcfg, emit_weights=weights), reps=3)
            plain_ms, ref = event_ms(lambda: ft.fused_mse_loss_weights_reference(
                pk, bo, bd, t, bt, m_rcfg, cones=bc))
            f64 = ft.fused_mse_loss_weights_reference(
                pk, bo.double(), bd.double(), t.double(), bt.double(), m_rcfg, cones=bc.double())
            loss_k = ((out[0] - bt) ** 2).mean().item()
            loss_p = ((ref[0] - bt) ** 2).mean().item()
            r = dict(ms=ms, plain_ms=plain_ms, loss=loss_k, plain_loss=loss_p)
            if weights:
                r["vs_plain"] = compare(name, out[0], ref[0], (out[1], ref[1], f64[1]), mids(t))
            else:
                r["vs_plain"] = compare(name, out[0], ref[0])
            if abs(loss_k - loss_p) > LOSS_REL_TOL * loss_p:
                raise AssertionError(f"{name}: loss {loss_k} vs {loss_p}")
            r["worst"], r["grads[rel,max,spread_rel,spread_max]"], r["grad_max_abs"] = grads_cmp(
                name, pk, out[-2:], ref[-2:], f64[-2:], tol=(inf, inf))
            emit("mip_grads", of=name, worst=r["worst"],
                 per=r["grads[rel,max,spread_rel,spread_max]"])
            grads_cmp(name, pk, out[-2:], ref[-2:], f64[-2:], tol=MIP_GRAD_TOL)
            r["ms_by_launch"] = split_times(lambda: ft.fused_mse_loss_cones_grads(
                pk, bo, bd, bc, t, bt, m_rcfg, emit_weights=weights))
            return out, ref, f64, r

        # the coarse level: the cone K4 against plain, itself, K2 and K5
        k4_out, k4_ref, k4_64, k4 = vs_plain("cone K4", t_c, True)
        rgb4, w4, gw4, gb4 = k4_out
        again = ft.fused_mse_loss_cones_grads(pk, bo, bd, bc, t_c, bt, m_rcfg, emit_weights=True)
        rgb2, _, gw2, gb2 = ft.fused_mse_loss_cones_grads(pk, bo, bd, bc, t_c, bt, m_rcfg)
        rgb5, w5 = fr.fused_render_cones_weights(pk, bo, bd, bc, t_c, m_rcfg)
        k4["bit_equal_two_runs"] = all(torch.equal(a, b) for a, b in zip(k4_out, again))
        k4["bit_equal_to_K2"] = (torch.equal(rgb4, rgb2) and torch.equal(gw4, gw2)
                                 and torch.equal(gb4, gb2))
        k4["bit_equal_to_K5"] = torch.equal(rgb4, rgb5) and torch.equal(w4, w5)
        if not (k4["bit_equal_two_runs"] and k4["bit_equal_to_K2"] and k4["bit_equal_to_K5"]):
            raise AssertionError(f"cone K4 bit-equality: {k4}")
        del again, rgb2, gw2, gb2, rgb5, w5
        # the control: the plain version on a bf16 encoding's inputs fails the
        # grad rule the kernel meets
        ctl = ft.fused_mse_loss_weights_reference(
            pk, *(x.bfloat16().float() for x in (bo, bd, t_c)), bt, m_rcfg, cones=bc)
        k4["bf16_encoding_control"] = dict(zip(
            ("worst", "grads[rel,max,spread_rel,spread_max]"),
            grads_cmp("control", pk, ctl[-2:], k4_ref[-2:], k4_64[-2:], tol=(inf, inf))[:2]))
        emit("mip_grads", of="bf16 encoding control", **k4["bf16_encoding_control"])
        try:
            grads_cmp("bf16 encoding control", pk, ctl[-2:], k4_ref[-2:], k4_64[-2:],
                      tol=MIP_GRAD_TOL)
            control_fails = False
        except AssertionError:
            control_fails = True
        if not control_fails:
            raise AssertionError("the bf16 encoding control meets the grad rule")
        del ctl, k4_ref, k4_64
        # the resampler, then the fine level: the cone K2 against plain
        resample_ms, t_f = event_ms(lambda: resample_edges(t_c, w4, m_rcfg, gen), reps=10)
        if t_f.shape != t_c.shape or not bool((t_f.diff(dim=-1) >= 0).all()):
            raise AssertionError("resample_edges: the fine edges are not sorted")
        k2_out, _, _, k2 = vs_plain("cone K2", t_f, False)
        # the autograd wrappers carry the grads held above
        ft.reset_launch_counts()
        loss_c, w_c = ft.fused_mse_loss_cones_weights(pk, bo, bd, bc, t_c, bt, m_rcfg)
        loss_f = ft.fused_mse_loss_cones(pk, bo, bd, bc, t_f, bt, m_rcfg)
        wrap_launches = dict(ft.LAUNCHES)
        if wrap_launches != {k: int(k in ("fused_mse_loss_cones", "fused_mse_loss_cones_weights"))
                             for k in ft.LAUNCHES}:
            raise AssertionError(f"mip wrappers: launches {wrap_launches}")
        net.zero_grad(set_to_none=True)
        (0.1 * loss_c + loss_f).backward()
        g_c, g_f = ft.unpack_grads(pk, gw4, gb4), ft.unpack_grads(pk, *k2_out[-2:])
        wrap_ok = (torch.equal(loss_c, ((rgb4 - bt) ** 2).mean()) and torch.equal(w_c, w4)
                   and torch.equal(loss_f, ((k2_out[0] - bt) ** 2).mean())
                   and all(torch.allclose(p.grad, 0.1 * g_c[k] + g_f[k], rtol=1e-6, atol=0)
                           for k, p in net.named_parameters()))
        if not wrap_ok:
            raise AssertionError("mip wrappers: loss, weights or grads differ from the held ones")
        net.zero_grad(set_to_none=True)
        del k4_out, k2_out, w4, gw4, gb4, w_c, g_c, g_f
        # one step as make_loss_fn runs it: a launch of each, the counter
        loss_fn = make_loss_fn(m_pipe)
        loss_fn(net, gen, imgs, pss, Kt).backward()
        ft.reset_launch_counts()
        with profiling.recording():
            step_ms, loss = event_ms(lambda: loss_fn(net, gen, imgs, pss, Kt))
            torch.cuda.synchronize()
            ipe = profiling.summary()["counters"].get("ipe_points")
        step_launches = dict(ft.LAUNCHES)
        paths["mip_train"] = step_launches
        if step_launches != wrap_launches or ipe != 2 * n * MIP_INTERVALS \
                or not bool(torch.isfinite(loss)):
            raise AssertionError(f"mip step: launches {step_launches}, ipe_points {ipe}, "
                                 f"loss {loss}")
        net.zero_grad(set_to_none=True)
        del imgs

        # a frame: one cone K5, the resampler, one cone K1; against the
        # float32 nn.Module frame, and stage by stage on SUBSET rays
        f_pipe = NeRFPipelineConfig(model=m_cfg, render=dataclasses.replace(m_rcfg,
                                                                            perturb=False))
        net.eval()
        fr.reset_launch_counts()
        frame_ms, frame = event_ms(lambda: make_render_image(f_pipe)(net, K, pose, H, W))
        frame_launches = dict(fr.LAUNCHES)
        paths["mip_frame"] = frame_launches
        if frame_launches != {k: int(k in ("fused_render_cones", "fused_render_cones_weights"))
                              for k in fr.LAUNCHES}:
            raise AssertionError(f"mip frame: launches {frame_launches}")
        mod_pipe = dataclasses.replace(f_pipe, render=dataclasses.replace(
            f_pipe.render, use_fused_kernel=False))
        mod_ms, mod = event_ms(lambda: make_render_image(mod_pipe)(net, K, pose, H, W))
        p_mod = psnr(frame, mod)
        if p_mod < PSNR_MODULE:
            raise AssertionError(f"mip kernel vs nn.Module frame PSNR {p_mod:.2f} dB")
        fo, fd, fc = image_cones(K, pose, H, W)
        i = torch.linspace(0, fo.shape[0] - 1, SUBSET, device=dev).long()
        so, sd, sc = fo[i], fd[i], fc[i]
        st = cone_edges(SUBSET, f_pipe.render, None, dev)
        rgb_c, w_c = fr.fused_render_cones_weights(pk, so, sd, sc, st, f_pipe.render)
        rr_c, wr_c = fr.fused_render_rays_reference(pk, so, sd, st, f_pipe.render,
                                                    emit_weights=True, cones=sc)
        w64_c = fr.fused_render_rays_reference(pk, so.double(), sd.double(), st.double(),
                                               f_pipe.render, emit_weights=True,
                                               cones=sc.double())[1]
        coarse = compare("mip coarse pass", rgb_c, rr_c, (w_c, wr_c, w64_c), mids(st))
        sf = resample_edges(st, w_c, f_pipe.render)
        rgb_f = fr.fused_render_cones(pk, so, sd, sc, sf, f_pipe.render)
        fine = compare("mip fine pass", rgb_f, fr.fused_render_rays_reference(
            pk, so, sd, sf, f_pipe.render, cones=sc))
        if not torch.equal(rgb_f, fr.fused_render_cones_weights(pk, so, sd, sc, sf,
                                                                f_pipe.render)[0]):
            raise AssertionError("mip fine pass: the cone K1's rgb differs from the cone K5's")
        emit("mip", rays=n, intervals=[MIP_INTERVALS, MIP_INTERVALS], seed=MIP_SEED,
             K4=k4, resample_ms=resample_ms, K2=k2,
             wrappers={"launches": wrap_launches, "loss_weights_grads_held": wrap_ok},
             step={"ms": step_ms, "launches": step_launches, "ipe_points": ipe},
             frame={"rays": H * W, "ms": frame_ms, "launches": frame_launches,
                    "kernel_vs_module": {"psnr": round(p_mod, 2), "module_ms": round(mod_ms, 2)},
                    "route_on_subset": {"rays": SUBSET, "coarse_pass": coarse,
                                        "fine_pass": fine}})

    # ---- slice 12: reference .pth files, bf16 nn.Module compute, the log ----
    def pth_interop():
        from sfm_nerf_tpu_torch.cli import wrapper as cli_wrapper
        from sfm_nerf_tpu_torch.config import NeRFModelConfig
        from sfm_nerf_tpu_torch.models import convert as cv
        from sfm_nerf_tpu_torch.models.nerf import NeRF
        from sfm_nerf_tpu_torch.train.nerf_trainer import NeRFTrainer, make_render_rays

        def same_tree(a, b):
            return set(a) == set(b) and all(np.array_equal(a[k][f], b[k][f])
                                            for k in a for f in ("w", "b"))

        if "gif" in failed:
            raise AssertionError("the gif phase's npz frames are missing")
        # 1. the committed checkpoint as a reference active-class file
        root = os.path.join(OUT, "pth_ckpt")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(os.path.join(root, "synth800"))
        pth = os.path.join(root, "synth800", "final_model.pth")
        cv.export_active_to_pth(params, pth)
        back, back_cfg = cv.convert_pth(pth)
        if back_cfg != mcfg or not same_tree(back, params):
            raise AssertionError(f"active .pth read back: {back_cfg} vs {mcfg}")
        # 2. gif mode on the directory that holds only the .pth
        fr.reset_launch_counts()
        records = cli_wrapper.main([
            "--mode", "gif", "--data_path", data, "--checkpoint_path", root,
            "--images_path", os.path.join(OUT, "pth_gif"), "--no_perturb",
            "--n_sample", "256", *GIF_LEGACY_FLAGS])
        gif_launches = dict(fr.LAUNCHES)
        if gif_launches["fused_render_rays"] != len(records) or len(records) != 2:
            raise AssertionError(f"pth gif: launches {gif_launches}, {len(records)} frames")
        for r in records:
            npz_frame = read_png(os.path.join(OUT, "synth800_legacy", os.path.basename(r["path"])))
            if not np.array_equal(read_png(r["path"]), npz_frame):
                raise AssertionError(f"pth gif frame {r['frame']} differs from the npz frame")
        # 3. fine-tune a seeded full-width legacy network from its .pth through K2
        # at the seeded init block2_2's density channel is below 0 at every
        # point, so the ReLU density and every grad would be 0: the density
        # bias is raised as --density_bias_init does
        lcfg = NeRFModelConfig(arch="legacy")
        src = params_to_jax(NeRF(dataclasses.replace(
            lcfg, density_bias_init=LEGACY_DENSITY_BIAS), seed=12))
        ft_root = os.path.join(OUT, "finetune_ckpt")
        shutil.rmtree(ft_root, ignore_errors=True)
        os.makedirs(os.path.join(ft_root, "synth800"))
        cv.export_legacy_to_pth(src, lcfg, os.path.join(ft_root, "synth800", "final_model.pth"))
        small = _views(data, "train", TOOL_VIEWS)
        flags = [small if f == data else f for f in train_flags] + [
            "--arch", "legacy", "--checkpoint_path", ft_root, "--exp_name", "finetune",
            "--max_iters", str(FINETUNE_STEPS), "--log_every", "5", "--val_every", "0",
            "--save_ckpt_iter", "0"]
        ft_cfg = cli.build_config(cli.config_parser("train").parse_args(flags))
        s_images, s_poses, s_cam = load_blender_dataset(small, "train")
        probe = NeRFTrainer(ft_cfg, s_images, s_poses, s_cam.camera_matrix, device=dev)
        if not probe.try_resume() or probe.start_iter != 0 \
                or not same_tree(params_to_jax(probe.model), src):
            raise AssertionError("the .pth fine-tune did not resume the exported weights")
        lmodel = probe.model
        del probe
        ft.reset_launch_counts()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            stats = cli.main(flags)
        told = [ln for ln in log.getvalue().splitlines() if "Fine-tuning from converted" in ln]
        losses = [v for _, v in stats["losses"]]
        k2 = ft.LAUNCHES["fused_mse_loss"]
        if (not told or stats["start_iter"] != 0 or stats["steps"] != FINETUNE_STEPS
                or k2 != FINETUNE_STEPS or not all(np.isfinite(losses))):
            raise AssertionError(f"fine-tune: {told}, start {stats['start_iter']}, steps "
                                 f"{stats['steps']}, K2 {k2}, losses {losses}")
        # K2 on the converted legacy network (ReLU density, six body layers,
        # block2_2 packed as densfeat) at the fine-tune's shape, against its
        # plain version under train_kernels' rule
        f32 = dict(dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(12)
        n = ft_cfg.train.n_rays_batch
        bo, bd, bt = sample_ray_batch(torch.as_tensor(s_images, **f32),
                                      torch.as_tensor(s_poses, **f32),
                                      torch.as_tensor(s_cam.camera_matrix, **f32), n, gen)
        bz = stratified_samples(n, ft_cfg.render, gen, dev)
        lpacked = fr.pack_nerf_params(lmodel, lcfg, torch.bfloat16)
        batch = (lpacked, bo, bd, bz)
        lk_ms, (rgb, gw, gb) = event_ms(lambda: ft.fused_mse_loss_grads(
            *batch, bt, ft_cfg.render))
        lp_ms, (rr, gwr, gbr) = event_ms(lambda: ft.fused_mse_loss_reference(
            *batch, bt, ft_cfg.render))
        _, gw64, gb64 = ft.fused_mse_loss_reference(
            lpacked, bo.double(), bd.double(), bz.double(), bt.double(), ft_cfg.render)
        loss_k, loss_p = ((rgb - bt) ** 2).mean().item(), ((rr - bt) ** 2).mean().item()
        rgb_err = (rgb - rr).abs().max().item()
        if rgb_err > RGB_TOL or abs(loss_k - loss_p) > LOSS_REL_TOL * loss_p:
            raise AssertionError(f"K2 legacy: rgb max abs {rgb_err}, loss {loss_k} vs {loss_p}")
        l_worst, l_per, l_abs = grads_cmp("K2 legacy", lpacked, (gw, gb), (gwr, gbr),
                                          (gw64, gb64))
        del gw64, gb64, lmodel
        # 4. a skip-less no-PE legacy network through a .pth, 16,384 rays
        # through K1.  The seeded init's colours barely vary (plain rgb std
        # ~1.4e-3), so a constant colour would pass the rule: NOPE_GAIN scales
        # every weight matrix until the rgb's spread is well above RGB_TOL
        ncfg = NeRFModelConfig(arch="legacy", pos_encoding=False, has_skip=False,
                               n_block1_layers=4)
        nnet = NeRF(ncfg, seed=13)
        with torch.no_grad():
            for layer in nnet.layers.values():
                layer.weight.mul_(NOPE_GAIN)
        nsrc = params_to_jax(nnet)
        npth = os.path.join(OUT, "nope_final_model.pth")
        cv.export_legacy_to_pth(nsrc, ncfg, npth)
        nparams, nback = cv.convert_pth(npth)
        if nback != ncfg or not same_tree(nparams, nsrc):
            raise AssertionError(f"no-PE .pth read back: {nback} vs {ncfg}")
        nmodel = params_from_jax(nparams, nback, dev).eval()
        i = torch.linspace(0, o.shape[0] - 1, SUBSET, device=dev).long()
        fr.reset_launch_counts()
        rgb = make_render_rays(NeRFPipelineConfig(model=nback, render=rcfg))(nmodel, o[i], d[i])
        torch.cuda.synchronize()
        nope_launches = dict(fr.LAUNCHES)
        ref = fr.fused_render_rays_reference(
            fr.pack_nerf_params(nmodel, nback, torch.bfloat16), o[i], d[i], z[i], rcfg)
        # a kernel giving every ray the mean colour would be off by the std
        # in RMSE: below 40 dB once the std exceeds RGB_TOL
        if nope_launches["fused_render_rays"] != 1 or not ref.std().item() > RGB_TOL:
            raise AssertionError(f"no-PE render: launches {nope_launches}, "
                                 f"plain rgb std {ref.std().item()} (must exceed {RGB_TOL})")
        nope_cmp = compare("K1 no-PE", rgb, ref)
        paths["pth_interop"] = {
            "fused_render_rays": gif_launches["fused_render_rays"]
            + nope_launches["fused_render_rays"], "fused_mse_loss": k2}
        emit("pth_interop",
             export={"file": pth, "bytes": os.path.getsize(pth), "bit_equal": True},
             gif={"frames": len(records), "launches": gif_launches, "bit_equal_to_npz": True,
                  "ms": [round(r["ms"], 2) for r in records]},
             finetune={"told": told[0], "start_iter": stats["start_iter"],
                       "steps": stats["steps"], "K2_launches": k2, "losses": losses,
                       "ms_per_step": stats["ms_per_step"],
                       "active_ms_per_step": state.get("train_ms_per_step")},
             legacy_K2_vs_plain={"rays": n, "samples": ft_cfg.render.n_sample, "ms": lk_ms,
                                 "plain_ms": lp_ms, "rgb_max_abs": rgb_err, "loss": loss_k,
                                 "plain_loss": loss_p, "worst": l_worst, "grad_max_abs": l_abs,
                                 "grads[rel,max,spread_rel,spread_max]": l_per},
             nope={"config": dataclasses.asdict(nback), "gain": NOPE_GAIN, "rays": SUBSET,
                   "launches": nope_launches, "plain_rgb_std": ref.std().item(), **nope_cmp})

    def bf16_module():
        from sfm_nerf_tpu_torch.cli import wrapper as cli_wrapper
        from sfm_nerf_tpu_torch.models.nerf import Bf16Linear, NeRF
        from sfm_nerf_tpu_torch.train.nerf_trainer import (
            NeRFTrainer, fused_train_supported, make_loss_fn,
        )
        from sfm_nerf_tpu_torch.utils import profiling as prof

        small = _views(data, "train", TOOL_VIEWS)
        # cli.wrapper --mode train's config: 8,192 x 256, the legacy compositor
        base = cli.build_config(cli_wrapper.delegated_args(
            cli_wrapper.config_parser().parse_args(["--mode", "train", "--data_path", small])))
        s_images, s_poses, s_cam = load_blender_dataset(small, "train")

        def config(dtype, **train):
            return dataclasses.replace(
                base, train=dataclasses.replace(base.train, compute_dtype=dtype, **train),
                checkpoint_path=os.path.join(OUT, f"bf16_ckpt_{dtype}"), load_checkpoint=False)

        runs = {}
        for dtype in ("float32", "bfloat16"):
            cfg_b = config(dtype, log_every=1, val_every=0, save_ckpt_iter=0)
            if fused_train_supported(cfg_b):
                raise AssertionError("bf16_module: the config takes a kernel route")
            shutil.rmtree(cfg_b.checkpoint_path, ignore_errors=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer = NeRFTrainer(cfg_b, s_images, s_poses, s_cam.camera_matrix, device=dev)
            st = trainer.fit(max_iters=BF16_STEPS, progress=False)
            peak = torch.cuda.max_memory_allocated()
            losses = [v for _, v in trainer.loss_log]
            if len(losses) != BF16_STEPS or not all(np.isfinite(losses)) \
                    or not losses[-1] < losses[0]:
                raise AssertionError(f"bf16_module {dtype}: losses {losses}")
            # where a step's device time goes: a trace of BF16_TRACE_STEPS more
            gen = torch.Generator(device=dev).manual_seed(3)
            with prof.trace(os.path.join(OUT, f"bf16_trace_{dtype}")) as p:
                for _ in range(BF16_TRACE_STEPS):
                    trainer.train_step(trainer.model, gen, trainer.images, trainer.poses,
                                       trainer.K)
                torch.cuda.synchronize()
            summary = prof.profile_summary(p, top=12)
            per = {k: summary[k] / BF16_TRACE_STEPS for k in ("device_busy_ms", "window_ms")}
            runs[dtype] = {"ms_per_step": st["ms_per_step"], "peak_mem_gib": round(peak / 2**30, 3),
                           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
                           "trace_per_step": {**per, "idle_share": summary["idle_share"],
                                              "top_kernels": [
                                                  {**k_, "ms": k_["ms"] / BF16_TRACE_STEPS}
                                                  for k_ in summary["top_kernels"]]}}
            del trainer
            torch.cuda.empty_cache()
        # one real batch, the same seeded init and draws: bf16 against float32
        # on the card, then bf16 on the card against bf16 on the CPU
        n, S = base.train.n_rays_batch, base.render.n_sample
        gen = torch.Generator(device=dev).manual_seed(21)
        hw = s_images.shape[1:3]
        draws = tuple(torch.randint(0, hi, (n,), generator=gen, device=dev)
                      for hi in (len(s_images), hw[1], hw[0]))
        u = torch.rand((n, S), generator=gen, device=dev)

        def loss_grads(dtype, device, rows):
            batch = [torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in (s_images, s_poses, s_cam.camera_matrix)]
            model = NeRF(base.model, device=device, seed=base.train.seed)
            loss = make_loss_fn(config(dtype), n_rays=rows)(
                model, None, *batch, draws=tuple(t[:rows].to(device) for t in draws),
                u=u[:rows].to(device))
            loss.backward()
            return loss.item(), {k: p.grad.detach().double().cpu()
                                 for k, p in model.named_parameters()}

        def held(name, got, want, loss_rel, grad_rel, must_fail=False):
            rel = {k: (got[1][k] - want[1][k]).norm().item() / want[1][k].norm().item()
                   for k in want[1]}
            out = {"loss": got[0], "against": want[0],
                   "loss_rel": abs(got[0] - want[0]) / abs(want[0]),
                   "worst_grad_rel": max(rel.values()),
                   "worst_grad": max(rel, key=rel.get).replace("layers.", "")}
            if (out["loss_rel"] <= loss_rel and out["worst_grad_rel"] <= grad_rel) == must_fail:
                raise AssertionError(f"{name}: {out}"
                                     + (": a control that passes the rule" if must_fail else ""))
            return out

        f32 = loss_grads("float32", dev, n)
        b16 = loss_grads("bfloat16", dev, n)
        b16_card = loss_grads("bfloat16", dev, BF16_CPU_RAYS)
        f32_card = loss_grads("float32", dev, BF16_CPU_RAYS)
        t0 = time.time()
        b16_cpu = loss_grads("bfloat16", torch.device("cpu"), BF16_CPU_RAYS)
        cpu_s = time.time() - t0
        vs_f32 = held("bf16 vs float32", b16, f32, BF16_LOSS_REL, BF16_GRAD_REL)
        vs_cpu = held("bf16 card vs CPU", b16_card, b16_cpu, CARD_LOSS_REL, CARD_GRAD_REL)
        # the control: a card route that skipped the cast must fail that rule
        f32_vs_cpu = held("float32 card vs bf16 CPU", f32_card, b16_cpu, CARD_LOSS_REL,
                          CARD_GRAD_REL, must_fail=True)
        # Bf16Linear alone at one layer's shape of a step, against _linear's
        # formula for bf16 weights (the CPU reference, held against JAX by
        # the tests) run here in float32 with TF32 off: both sum exact bf16
        # products in float32, so the forward agrees to summation order,
        # which neither a float32 product (no cast) nor a bf16-output product
        # can; the backward adds the cotangent's bf16 rounding
        xa = torch.randn(n * S, 256, device=dev, requires_grad=True)
        wb = (torch.rand(256, 256, device=dev) * 2 - 1).div(16).to(torch.bfloat16)
        wb.requires_grad_(True)
        bb = torch.rand(256, device=dev, requires_grad=True)
        ga = torch.randn(n * S, 256, device=dev)
        want = xa.to(torch.bfloat16).float() @ wb.float().t() + bb
        want_g = torch.autograd.grad(want, (xa, wb, bb), ga)
        got = Bf16Linear.apply(xa, wb, bb)
        got_g = torch.autograd.grad(got, (xa, wb, bb), ga)

        def rel(y, ref):
            return ((y.float() - ref.float()).norm() / ref.float().norm()).item()

        with torch.no_grad():
            linear = {"forward_rel": rel(got, want),
                      "control_float32_product_rel": rel(
                          torch.nn.functional.linear(xa, wb.float(), bb), want),
                      "control_bf16_output_rel": rel(torch.nn.functional.linear(
                          xa.to(torch.bfloat16), wb, bb.to(torch.bfloat16)), want),
                      "grad_rel": {k: rel(a, b) for k, a, b in zip(("x", "w", "b"), got_g,
                                                                   want_g)}}
        del xa, wb, bb, ga, want, want_g, got, got_g
        if not (linear["forward_rel"] <= BF16_LINEAR_REL
                < min(linear["control_float32_product_rel"],
                      linear["control_bf16_output_rel"])
                and max(linear["grad_rel"].values()) <= BF16_LINEAR_GRAD_REL):
            raise AssertionError(f"Bf16Linear vs _linear's formula: {linear}")
        # the products alone, at one layer's shape of a step: 2,097,152 x 256 x
        # 256, each warmed up once (cuBLAS picks its kernel at the first call)
        x = torch.randn(n * S, 256, device=dev, dtype=torch.bfloat16)
        w = torch.randn(256, 256, device=dev, dtype=torch.bfloat16)
        xf, wf = x.float(), w.float()
        products = {}
        for name, fn in (
                ("float32", lambda: xf @ wf.t()),
                ("bf16_in_f32_out (Bf16Linear)", lambda: torch.mm(x, w.t(),
                                                                  out_dtype=torch.float32)),
                ("bf16_in_bf16_out (F.linear)", lambda: x @ w.t())):
            fn()
            products[name] = event_ms(fn, reps=5)[0]
        del x, w, xf, wf
        emit("bf16_module", shape=[n, S], route="nn.Module, legacy compositor, near 1 far 10",
             train_views=TOOL_VIEWS, steps=BF16_STEPS, runs=runs,
             bf16_over_f32_ms=runs["bfloat16"]["ms_per_step"] / runs["float32"]["ms_per_step"],
             one_batch={"bf16_vs_float32": vs_f32, "card_vs_cpu": {**vs_cpu,
                        "rays": BF16_CPU_RAYS, "cpu_s": cpu_s},
                        "control_float32_card_vs_bf16_cpu": f32_vs_cpu},
             bf16_linear_vs_reference={"shape": [n * S, 256, 256], **linear},
             product_ms_2097152x256x256=products)

    def tb_events():
        from sfm_nerf_tpu_torch.io.png import decode_png
        from sfm_nerf_tpu_torch.utils import tb_events as tbe

        runs = state["train_events"]
        files = []
        for run in runs:
            events = tbe._read_events(run["events"])
            if events[0].get("file_version") != "brain.Event:2":
                raise AssertionError(f"{run['events']}: no file_version event first")
            scalars, images = {}, {}
            for e in events[1:]:
                for v in e["values"]:
                    if "simple_value" in v:
                        scalars.setdefault(v["tag"], []).append((e["step"], v["simple_value"]))
                    else:
                        images[v["tag"]] = (e["step"], v["image"])
            steps = [it for it, _ in run["losses"]]
            n_val = len(run["val"])
            want_tags = {"Loss/train", "Learning_Rate", "Loss/train_avg",
                         *[f"Loss/val_{i}" for i in range(n_val)]}
            ok = (set(scalars) == want_tags
                  and scalars["Loss/train"] == [(it, float(np.float32(v)))
                                                for it, v in run["losses"]]
                  and [s_ for s_, _ in scalars["Learning_Rate"]] == steps
                  and [s_ for s_, _ in scalars["Loss/train_avg"]] == steps
                  and all(scalars[f"Loss/val_{i}"] == [(it, float(np.float32(m)))]
                          for i, (it, _, m) in enumerate(run["val"]))
                  and set(images) == {f"Val_Image_{i}" for i in range(n_val)})
            if not ok:
                raise AssertionError(f"{run['events']}: tags {sorted(scalars)} "
                                     f"{sorted(images)}, {len(run['losses'])} losses")
            reader = None
            try:
                from tensorboard.backend.event_processing.event_file_loader import (
                    EventFileLoader,
                )
            except ImportError:
                pass
            else:
                reader = sum(1 for _ in EventFileLoader(run["events"]).Load())
                if reader != len(events):
                    raise AssertionError(f"tensorboard reads {reader} of {len(events)} events")
            files.append({"file": os.path.basename(run["events"]),
                          "bytes": os.path.getsize(run["events"]), "events": len(events),
                          "steps_logged": len(steps), "images": len(images),
                          "writer_s": run["writer_s"], "fit_s": run["elapsed_s"],
                          "writer_share": run["writer_s"] / run["elapsed_s"],
                          "tensorboard_reader_events": reader})
        # Val_Image_0 of the resume: ground truth beside the final model's view
        it, idx, _ = runs[1]["val"][0]
        step, img = images["Val_Image_0"]
        got = decode_png(img["png"])
        with open(os.path.join(data, "transforms_train.json")) as f:
            frame = json.load(f)["frames"][idx]
        gt = read_png(os.path.join(data, frame["file_path"] + ".png"))[..., :3].astype(
            np.float32) / 255.0
        tcfg = cli.build_config(cli.config_parser("train").parse_args(
            [*train_flags, "--checkpoint_path", train_ckpt]))
        tp, _ = ckpt.load_params_untyped(os.path.join(train_ckpt, "synth800",
                                                      "final_model.ckpt.npz"))
        tcam = load_camera_info(data, "train")
        pred = make_render_image(tcfg)(
            params_from_jax(tp, tcfg.model, dev).eval(),
            torch.as_tensor(tcam.camera_matrix, device=dev),
            torch.as_tensor(np.asarray(frame["transform_matrix"], np.float32), device=dev),
            tcam.height, tcam.width)
        side = torch.cat([torch.as_tensor(gt, dtype=torch.float32, device=dev), pred], 1)
        want = (side.clamp(0, 1).cpu().numpy() * 255.0).astype(np.uint8)
        diff = int(np.abs(got.astype(int) - want.astype(int)).max())
        if step != it or got.shape != want.shape or diff > VAL_IMAGE_LEVELS:
            raise AssertionError(f"Val_Image_0 at {step} (val at {it}): {got.shape} vs "
                                 f"{want.shape}, max diff {diff} levels")
        emit("tb_events", files=files, val_image={
            "view": idx, "step": step, "shape": list(got.shape),
            "png_bytes": len(img["png"]), "max_abs_levels": diff})

    phase(serve)
    phase(aux)
    phase(gif)
    if "serve" not in failed:
        phase(figures)
    phase(train)
    if not failed:
        phase(train_two_kernel)
        phase(train_kernels)
        phase(train_hier)
    if not failed:
        phase(serve_hier)
        phase(hier_kernels)
    phase(mip)
    if not failed:
        phase(pth_interop)
    phase(bf16_module)
    if "train" not in failed:
        phase(tb_events)

    # ---- 8. kernels ------------------------------------------------------
    def kernel_line():
        def launched(name):
            return sum(counts.get(name, 0) for counts in paths.values())

        n, S = o.shape[0], z.shape[1]
        macs = fr.macs_per_point(mcfg) * n * S + fr.macs_per_ray(mcfg) * n
        in_bytes = (o.numel() + d.numel() + z.numel()) * 4 \
            + packed.weights.numel() * 2 + packed.biases.numel() * 4
        rows, full_shape = [], {}
        for name, replaces, weights in (
            ("fused_render_rays", "sfm_nerf_tpu/kernels/fused_render.py:541", False),
            ("fused_render_rays_weights", "sfm_nerf_tpu/kernels/fused_render.py:575", True),
        ):
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
                "replaces": replaces, "launches": launched(name),
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
                "replaces": replaces, "launches": launched(name),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            })
        emit("kernel_launches_by_path", **paths)
        print(json.dumps({"kernels": rows}), flush=True)

    if not failed:
        phase(kernel_line)
    run_tool_phases(phase, data, train_flags, state)
    run_parallel_phases(phase, data, train_flags, state)
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
