"""Phase 1 entry point of the port: incremental SfM on the card.

    python -m sfm_nerf_tpu_torch.cli.sfm --data_path D --output_dir O \\
        [--num_images N] [--export_nerf E] [--device cpu] ...

``Phase1/Wrapper.py`` in the port: reads a reference-format dataset
(``calibration.txt``, ``matching{i}.txt``, ``{i}.png``), refines every pair
by F-RANSAC, initialises from two views, registers the other cameras by PnP
RANSAC + LM, re-triangulates and runs the pruned global BA, all in float64
on ``--device`` (default cuda).  Writes ``reconstruction.ply`` and
``sfm_stats.json`` to ``--output_dir``; with ``--export_nerf E`` also a
NeRF dataset that ``cli.nerf --data_path E/ --near auto --far auto`` trains
on.  The flags keep Wrapper.py's names and defaults for what is ported; the
figures, ``--platform``, ``--runs``, ``--bucket_floor``, ``--float64`` (the
port is always float64) and the options of the unported modules
(``--global_init``, ``--global_rotation_init``, ``--essential_method 5pt``,
``--ransac_confidence``, ``--ransac_devices``, ``--ba_devices``,
``--pnp_f64_rescue on``) are not here.
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
    p.add_argument("--pnp_iters", type=int, default=10000)
    p.add_argument("--pnp_threshold", type=float, default=10.0)
    p.add_argument("--ba_max_iters", type=int, default=50)
    p.add_argument("--ba_interval", type=int, default=0,
                   help="a light global BA after every this many "
                        "registrations (0 = off)")
    p.add_argument("--ba_interval_iters", type=int, default=10)
    p.add_argument("--registration_retries", type=int, default=2)
    p.add_argument("--tri_reproj_gate_px", type=float, default=10.0)
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
        ransac_batch_pairs=args.ransac_batch_pairs,
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
