"""Phase 2 legacy entry point of the port, the counterpart of
``Phase2/Wrapper.py``: train, test and the turntable gif.

    python -m sfm_nerf_tpu_torch.cli.wrapper --mode train|test|gif \\
        --data_path ... --checkpoint_path ... [--device cpu]

The flags and defaults are ``Phase2/Wrapper.py``'s (``configParser``),
less ``--platform`` (a JAX backend switch), plus ``--device`` (default
cuda).

``--mode gif`` is ``cli.nerf``'s gif mode; ``--plot_rays`` adds each
frame's ray fan, ``ray_plot_{count}.png`` (drawn by io/figure.py).  ``--mode train|test`` hands
the run to ``cli.nerf``'s train or test mode as the JAX Wrapper hands it to
``Phase2/train.py``: that parser's defaults, overwritten by every flag of
this one that it also has and that is not None, then the legacy loop's
settings:

- the learning rate under StepLR(1000, 0.1) (the reference Wrapper's
  schedule) unless ``--modern_schedule``;
- near 1, far 10 and the legacy compositor unless ``--modern_render``;
- ``--eval_split`` (default: the train split, as the reference's test
  scored) forwarded.

Training with the legacy compositor runs the ``nn.Module`` route in both
packages (``fused_train_supported``); test mode renders through the fused
render kernel K1, which takes the legacy compositor.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from sfm_nerf_tpu_torch import DEFAULT_DEVICE
from sfm_nerf_tpu_torch.cli import nerf


def config_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m sfm_nerf_tpu_torch.cli.wrapper")
    p.add_argument('--data_path', default="./Phase2/nerf_synthetic/lego/", help="dataset path")
    p.add_argument('--mode', default='train', help="train/test/gif")
    p.add_argument('--lrate', default=5e-4, help="training learning rate")
    p.add_argument('--n_pos_freq', default=10, help="position encoding frequencies")
    p.add_argument('--n_dirc_freq', default=4, help="direction encoding frequencies")
    p.add_argument('--n_rays_batch', default=32 * 32 * 8, help="number of rays per batch")
    p.add_argument('--n_sample', default=256, help="number of sample per ray")
    p.add_argument('--max_iters', default=100001, help="number of max iterations for training")
    p.add_argument('--logs_path', default="./logs/",
                   help="logs path: train mode's TensorBoard event file goes to "
                        "<logs_path>/<exp_name> (cli.nerf's --exp_name default)")
    p.add_argument('--log_id', default="", help="log id (unused, as in Phase2/Wrapper.py)")
    p.add_argument('--checkpoint_path', default="./Phase2/checkpoints/", help="checkpoints path")
    p.add_argument('--load_checkpoint', default=True, help="whether to load checkpoint or not")
    p.add_argument('--save_ckpt_iter', default=1000, help="num of iteration to save checkpoint")
    p.add_argument('--images_path', default="./image/", help="folder to store images")
    p.add_argument('--n_frames', default=10, type=int, help="gif turntable frames")
    p.add_argument('--rgb_frames', action='store_true',
                   help="write frames in RGB (the reference swapped to BGR)")
    p.add_argument('--downscale', default=1, type=int)
    p.add_argument('--fused', action='store_true', default=True,
                   help="the fused CUDA kernels (their plain versions on --device cpu)")
    p.add_argument('--no_fused', dest='fused', action='store_false',
                   help="the float32 nn.Module path everywhere")
    p.add_argument('--orbit', default='spherical', choices=['spherical', 'lookat'],
                   help="gif turntable convention")
    p.add_argument('--orbit_radius', default=4.0, type=float)
    p.add_argument('--orbit_elev', default=-30.0, type=float)
    p.add_argument('--orbit_target', default='0,0,0')
    p.add_argument('--near', default=None, type=float,
                   help="gif near bound (default: the legacy renderer's 1.0)")
    p.add_argument('--far', default=None, type=float,
                   help="gif far bound (default: the legacy renderer's 10.0)")
    p.add_argument('--train_variant', action='store_true',
                   help="exclusive-transmittance 'train' compositor for gif frames")
    p.add_argument('--no_perturb', action='store_true', help="deterministic mid-bin samples")
    p.add_argument('--white_bkgd', action='store_true',
                   help="composite onto a white background")
    p.add_argument('--plot_rays', action='store_true',
                   help="write a 3-D ray-fan debug plot per gif frame "
                        "(ray_plot_{count}.png; the reference's "
                        "plot_rays, Wrapper.py:428-442,494, calls "
                        "plt.show() which blocks headless runs — same "
                        "fix as display_matches: save, don't show)")
    p.add_argument('--modern_schedule', action='store_true',
                   help="train.py's StepLR(50000, 0.1) instead of the legacy StepLR(1000, 0.1)")
    p.add_argument('--modern_render', action='store_true',
                   help="train.py's near 2 / far 6 'train' compositor instead of the legacy "
                        "near 1 / far 10 legacy compositor")
    p.add_argument('--eval_split', default='train', choices=['train', 'test'],
                   help="split --mode test evaluates (the reference scored the train split)")
    p.add_argument('--device', default=DEFAULT_DEVICE, choices=['cuda', 'cpu'])
    return p


def delegated_args(args) -> argparse.Namespace:
    """``cli.nerf``'s namespace for ``args.mode`` (train or test): its
    defaults, this run's flags that it has and that are not None, then the
    legacy loop's schedule and render settings."""
    t_args = nerf.config_parser(args.mode).parse_args([])
    for k, v in vars(args).items():
        # --near/--far are None here (gif-mode overrides): keep 2/6
        if hasattr(t_args, k) and v is not None:
            setattr(t_args, k, v)
    if not args.modern_schedule and hasattr(t_args, "lrate_decay_steps"):
        t_args.lrate_decay_steps = 1000
        t_args.lrate_decay = 0.1
    if not args.modern_render:
        t_args.near, t_args.far = 1.0, 10.0
        t_args.render_variant = "legacy"
    return t_args


def main(argv: Optional[List[str]] = None):
    args = config_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.mode == "gif":
        print("Start gif")
        return nerf.run_gif(args)
    if args.mode not in ("train", "test"):
        raise SystemExit(f"--mode {args.mode!r} is not implemented (use train, test or gif)")
    t_args = delegated_args(args)
    return (nerf.run_train if args.mode == "train" else nerf.run_test)(t_args)


if __name__ == "__main__":
    main()
