"""Phase 1 entry point of the port: incremental SfM on the card.

    python -m sfm_nerf_tpu_torch.cli.sfm --data_path D --output_dir O \\
        [--num_images N] [--export_nerf E] [--device cpu] ...

``Phase1/Wrapper.py`` in the port: reads a reference-format dataset
(``calibration.txt``, ``matching{i}.txt``, ``{i}.png``), refines every pair
by F-RANSAC, initialises from two views, registers the other cameras by PnP
RANSAC + LM, re-triangulates and runs the pruned global BA, all in float64
on ``--device`` (default cuda).  Writes ``reconstruction.ply``,
``sfm_stats.json`` and the JAX pipeline's figures (the init pair's
``feature_matches_{a}_{b}.png``, ``x_vs_z_triangulation.png``,
``3d_points_visualization.png``, the four ``Frame*.jpg`` overlays,
``complete_reconstruction.png`` and ``topdown_view.png``) to
``--output_dir``; with ``--export_nerf E`` also a NeRF dataset that
``cli.nerf --data_path E/ --near auto --far auto`` trains on.  The flags
keep Wrapper.py's names, defaults and choices; ``--platform``, ``--runs``,
``--bucket_floor`` (XLA compile reuse) and ``--float64`` (the port is
always float64) are not here.

``--ransac_devices N`` shards each pair's F-RANSAC hypotheses, and
``--ba_devices N`` the global BA's points, over N devices: N distinct
visible cards on ``cuda`` (fewer raise before any data is read), the CPU N
times with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from sfm_nerf_tpu_torch import DEFAULT_DEVICE


def config_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_path", default="Phase1/Data",
                   help="folder with 1..N.png, calibration.txt, matching*.txt")
    p.add_argument("--num_images", type=int, default=5)
    p.add_argument("--output_dir", default=".")
    p.add_argument("--ransac_iters", type=int, default=50000)
    p.add_argument("--ransac_threshold", type=float, default=5e-4)
    p.add_argument("--ransac_scoring", default="msac", choices=["msac", "count"])
    p.add_argument("--no_ransac_batch_pairs", dest="ransac_batch_pairs",
                   action="store_false", default=True,
                   help="F-RANSAC one pair at a time instead of every pair "
                        "in batched launches")
    p.add_argument("--ransac_devices", type=int, default=1,
                   help="shard RANSAC hypotheses over this many devices "
                        "(the single-device draws when it divides the chunk "
                        "count ceil(ransac_iters / 1024))")
    p.add_argument("--ransac_confidence", type=float, default=0.0,
                   help="> 0 (e.g. 0.999): adaptive early exit of F- and PnP "
                        "RANSAC at this confidence, the iteration flags as "
                        "caps; 0 keeps the fixed counts")
    p.add_argument("--ransac_adaptive_device", default="auto",
                   choices=["auto", "host", "device"],
                   help="accepted for Phase1/Wrapper.py's command lines: every "
                        "value runs the one host-driven adaptive loop")
    p.add_argument("--pnp_iters", type=int, default=10000)
    p.add_argument("--pnp_threshold", type=float, default=10.0)
    p.add_argument("--pnp_f64_rescue", default="auto", choices=["auto", "on", "off"],
                   help="'on': re-run a camera whose PnP RANSAC fails its "
                        "inlier gate on numpy draws of its own seed "
                        "('auto' is off: the port is float64)")
    p.add_argument("--essential_method", default="from_f", choices=["from_f", "5pt"],
                   help="two-view E: conjugate the 8-point F or the 5-point "
                        "minimal solver's RANSAC")
    p.add_argument("--global_init", action="store_true",
                   help="rotation + translation averaging of the registered "
                        "cameras -> re-triangulation -> BA")
    p.add_argument("--global_rotation_init", action="store_true",
                   help="rotation averaging of the registered cameras before BA")
    p.add_argument("--global_init_batch_pairs", type=int, default=256,
                   help="pairs per batched relative-pose launch of the pose "
                        "graph (0 = one pair at a time)")
    p.add_argument("--ba_max_iters", type=int, default=50)
    p.add_argument("--ba_interval", type=int, default=0,
                   help="a light global BA after every this many "
                        "registrations (0 = off)")
    p.add_argument("--ba_interval_iters", type=int, default=10)
    p.add_argument("--registration_retries", type=int, default=2)
    p.add_argument("--tri_reproj_gate_px", type=float, default=10.0)
    p.add_argument("--ba_devices", type=int, default=1,
                   help="shard global BA's point axis over this many devices "
                        "(the single-device result up to reduction-order "
                        "rounding)")
    p.add_argument("--ba_refine_intrinsics", default="",
                   help="comma-set of {f,fx,fy,pp,cx,cy,k1,k2} freed in the "
                        "global BA ('' keeps K fixed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_pair", default="fixed", choices=["fixed", "auto"])
    p.add_argument("--view_order", default="index", choices=["index", "greedy"])
    p.add_argument("--merge_tracks", action="store_true",
                   help="merge re-detected features across matching files "
                        "into one track")
    p.add_argument("--export_nerf", default="",
                   help="after reconstruction, write a NeRF dataset (images, "
                        "transforms_*.json with the SfM poses, intrinsics and "
                        "near/far) to this directory")
    p.add_argument("--export_holdout_every", type=int, default=0,
                   help="every Nth registered view to the export's test "
                        "split (0 = the test split mirrors train)")
    p.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"],
                   help="device of the SfM computation")
    return p


def export(result, data_path: str, out_dir: str, holdout_every: int = 0) -> dict:
    """The reconstruction as a NeRF dataset (Phase1/Wrapper.py
    --export_nerf): the refined pinhole K when BA freed the intrinsics,
    frames resampled when its radial terms move pixels."""
    from sfm_nerf_tpu_torch.io.png import png_size
    from sfm_nerf_tpu_torch.io.sfm_data import load_calibration
    from sfm_nerf_tpu_torch.sfm.to_nerf import export_nerf_dataset

    image_paths = {i: os.path.join(data_path, f"{i}.png")
                   for i in sorted(result["camera_info"])}
    w, h = png_size(next(iter(image_paths.values())))
    K = load_calibration(os.path.join(data_path, "calibration.txt"))
    refined = result["stats"].get("ba", {}).get("intrinsics")
    distortion = None
    if refined is not None:
        K = np.array([[refined[0], 0.0, refined[2]],
                      [0.0, refined[1], refined[3]],
                      [0.0, 0.0, 1.0]])
        distortion = (float(refined[4]), float(refined[5]))
    return export_nerf_dataset(result["camera_info"], result["points"], K,
                               image_paths, out_dir, width=w, height=h,
                               holdout_every=holdout_every, distortion=distortion)


def main(argv: Optional[List[str]] = None):
    args = config_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; pass --device cpu")

    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.sfm.pipeline import SfMPipeline

    cfg = SfMConfig(
        data_path=args.data_path, num_images=args.num_images,
        ransac_iters=args.ransac_iters, ransac_threshold=args.ransac_threshold,
        ransac_scoring=args.ransac_scoring,
        ransac_batch_pairs=args.ransac_batch_pairs, ransac_devices=args.ransac_devices,
        ransac_confidence=args.ransac_confidence,
        ransac_adaptive_device={"auto": None, "host": False,
                                "device": True}[args.ransac_adaptive_device],
        pnp_f64_rescue=args.pnp_f64_rescue, essential_method=args.essential_method,
        global_init=args.global_init, global_rotation_init=args.global_rotation_init,
        global_init_batch_pairs=args.global_init_batch_pairs,
        ba_devices=args.ba_devices,
        pnp_iters=args.pnp_iters, pnp_threshold=args.pnp_threshold,
        ba_max_iters=args.ba_max_iters, ba_interval=args.ba_interval,
        ba_interval_iters=args.ba_interval_iters,
        registration_retries=args.registration_retries,
        tri_reproj_gate_px=args.tri_reproj_gate_px,
        ba_refine_intrinsics=args.ba_refine_intrinsics,
        init_pair=args.init_pair, view_order=args.view_order,
        merge_tracks=args.merge_tracks, seed=args.seed,
        output_dir=args.output_dir,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    result = SfMPipeline(cfg, device=args.device).run()
    if args.export_nerf:
        export(result, args.data_path, args.export_nerf, args.export_holdout_every)
    return result


if __name__ == "__main__":
    main()
