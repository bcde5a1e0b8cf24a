"""Stitch turntable frames into a looping GIF, the counterpart of
``Phase2/get_gif.py``.

    python -m sfm_nerf_tpu_torch.cli.gif [--images_path image] [--out F] \\
        [--fps 2] [--rgb]

Reads every ``image_{n}.png`` in ``--images_path`` (``cli.nerf --mode gif``
writes them), in the order of n, and writes ``--out`` (default
``<images_path>/output.gif``) through io/gif.py at ``--fps`` frames a
second.  The reference read the frames with cv2, which swaps red and blue,
and wrote them as read: so by default the channels are swapped here too,
which turns frames written channel-swapped (``cli.nerf --mode gif``
without ``--rgb_frames``) back into true colour.  ``--rgb`` writes the
frames as they are.  Runs on the host alone: no card is involved.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

import numpy as np


def config_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m sfm_nerf_tpu_torch.cli.gif")
    p.add_argument("--images_path", default="image")
    p.add_argument("--out", default=None, help="default: <images_path>/output.gif")
    p.add_argument("--fps", type=float, default=2)
    p.add_argument("--rgb", action="store_true",
                   help="frames are true-colour PNGs (cli.nerf --rgb_frames): write them as "
                        "they are instead of swapping red and blue as the reference's read did")
    return p


def frame_paths(images_path: str) -> List[str]:
    """``image_{n}.png`` under ``images_path``, sorted by n."""
    paths = [p for p in glob.glob(os.path.join(images_path, "*.png"))
             if os.path.basename(p).startswith("image_")]
    return sorted(paths, key=lambda p: int(os.path.basename(p).split("_")[1].split(".")[0]))


def main(argv: Optional[List[str]] = None) -> dict:
    from sfm_nerf_tpu_torch.io.gif import write_gif
    from sfm_nerf_tpu_torch.io.png import read_png

    args = config_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    paths = frame_paths(args.images_path)
    print(paths)
    if not paths:
        raise SystemExit(f"no image_*.png frames in {args.images_path}")
    frames = []
    for p in paths:
        img = read_png(p)
        img = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img[..., :3]
        frames.append(img if args.rgb else img[..., ::-1])
    out = args.out or os.path.join(args.images_path, "output.gif")
    written = write_gif(out, frames, fps=args.fps)
    print(f"wrote {out}")
    return {"out": out, "frames": paths, "written": written}


if __name__ == "__main__":
    main()
