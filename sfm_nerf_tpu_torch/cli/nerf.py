"""NeRF entry point of the port: training, test renders, gif frames.

    python -m sfm_nerf_tpu_torch.cli.nerf --mode train --data_path ... \\
        --checkpoint_path ... [--max_iters N] [--no_fused] [--device cpu]
    python -m sfm_nerf_tpu_torch.cli.nerf --mode test --data_path ... \\
        --checkpoint_path ... [--save_depth] [--device cpu]
    python -m sfm_nerf_tpu_torch.cli.nerf --mode gif --data_path ... \\
        --checkpoint_path ... [--no_perturb] [--n_frames N] [--device cpu]

``--mode train`` is ``Phase2/train.py`` (its default mode): the same
training flags and defaults (8,192 rays x 256 samples per step, Adam 5e-4
under a staircase decay, ``--fused`` on: the step is one launch of the fused
CUDA step kernel, its plain PyTorch version on ``--device cpu``), the same
checkpoint names and cadence, resume from the newest checkpoint under
``--checkpoint_path/<scene>``.  The port adds ``--log_every``,
``--val_every`` and ``--two_kernel_step`` (the forward and backward kernels
of ``fused_render_train`` instead of the merged step).  The TensorBoard
log goes where ``Phase2/train.py`` puts it, an event file under
``{--logs_path}/{--exp_name}`` (utils/tb_events.py; rank 0 writes it under
``--dp``): ``Loss/train``, ``Learning Rate`` and ``Loss/train_avg`` every
``--log_every`` steps, ``Loss/val_{i}`` and ``Val_Image_{i}`` (ground truth
beside prediction) every ``--val_every``.  With no npz checkpoint there, a
reference ``final_model.pth`` (else the newest ``model_*.pth``) under
``--checkpoint_path/<scene>`` is fine-tuned from step 0; its architecture
must match ``--arch``, ``--hidden_size`` and the frequency flags.

``--mode test`` is ``Phase2/train.py --mode test``: the same flags (those
that act on rendering) and defaults, the same choice of 5 views from
``--seed``, the same ``test_{i}_{gt,pred,comparison}.png`` artifacts (and
``test_{i}_{depth,disp,acc}.png`` with ``--save_depth``) and the same
printed MSE / PSNR / SSIM lines.  ``--mode gif`` is ``Phase2/Wrapper.py
--mode gif``: ``n_frames`` turntable frames ``image_{count}.png`` through
the legacy compositor (near 1, far 10 by default), written channel-swapped
as the reference's cv2.imwrite did unless ``--rgb_frames``; it renders the
npz checkpoint, else a reference ``.pth`` (``load_any_checkpoint``), whose
architecture it reads from the file.  The flags of
each mode keep the names and defaults of the matching JAX parser; the port
adds ``--device`` (default cuda).

``--n_importance N`` (train and test) turns hierarchical sampling on: train
mode trains a coarse/fine pair (one checkpoint holds both), test mode
renders it coarse pass -> N importance samples -> fine pass over the union;
the checkpoint and the flag must agree.  Gif mode has no such flag, as in
the JAX package: given a pair checkpoint it renders the fine network flat.

Several GPUs: ``torchrun --nproc_per_node N -m sfm_nerf_tpu_torch.cli.nerf
--mode train --dp N ...`` trains data parallel, one rank per card (NCCL;
gloo with ``--device cpu``), each rank drawing n_rays_batch / N rays; rank
0 logs, validates and writes the checkpoints.  ``--dp`` (Phase2/train.py's
flag, default 0 = every rank) larger than the launched world exits
non-zero, as does a world whose process group cannot start.  Tensor
parallelism is reached through ``ParallelConfig.tp`` only, as in the JAX
package.

``--ckpt_backend orbax`` writes the same npz files from a background thread
(train/async_ckpt.py), not orbax's step directories.

Not ported: ``figure_{i}.png`` and ``--plot_rays`` (matplotlib),
``--steps_per_call`` (an XLA dispatch amortisation).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from sfm_nerf_tpu_torch import DEFAULT_DEVICE


def _bound(v):
    """--near/--far value: a float, or 'auto' = the dataset's hint."""
    return v if v == "auto" else float(v)


def config_parser(mode: str = "test") -> argparse.ArgumentParser:
    """The flags of ``mode``: Phase2/train.py's for train and test,
    Phase2/Wrapper.py's for gif."""
    p = argparse.ArgumentParser(prog="python -m sfm_nerf_tpu_torch.cli.nerf")
    p.add_argument('--data_path', default="./Phase2/nerf_synthetic/lego/", help="dataset path")
    p.add_argument('--mode', default='train', help="train/test/gif")
    p.add_argument('--n_sample', default=256, help="number of sample per ray")
    p.add_argument('--images_path', default="./image/", help="folder to store images")
    p.add_argument('--downscale', default=1, type=int, help="integer image downscale")
    p.add_argument('--fused', action='store_true', default=True,
                   help="render through the fused CUDA kernel (its plain "
                        "PyTorch version on --device cpu)")
    p.add_argument('--no_fused', dest='fused', action='store_false',
                   help="render through the float32 nn.Module path")
    p.add_argument('--white_bkgd', action='store_true',
                   help="composite onto a white background")
    p.add_argument('--device', default=DEFAULT_DEVICE, choices=['cuda', 'cpu'],
                   help="device to render on")
    if mode == "gif":
        p.add_argument('--checkpoint_path', default="./Phase2/checkpoints/", help="checkpoints path")
        p.add_argument('--n_frames', default=10, type=int, help="gif turntable frames")
        p.add_argument('--rgb_frames', action='store_true',
                       help="write frames in RGB (the reference swapped to BGR)")
        p.add_argument('--orbit', default='spherical', choices=['spherical', 'lookat'],
                       help="turntable convention")
        p.add_argument('--orbit_radius', default=4.0, type=float)
        p.add_argument('--orbit_elev', default=-30.0, type=float)
        p.add_argument('--orbit_target', default='0,0,0')
        p.add_argument('--near', default=None, type=float,
                       help="near bound (default: the legacy renderer's 1.0)")
        p.add_argument('--far', default=None, type=float,
                       help="far bound (default: the legacy renderer's 10.0)")
        p.add_argument('--train_variant', action='store_true',
                       help="exclusive-transmittance 'train' compositor")
        p.add_argument('--no_perturb', action='store_true',
                       help="deterministic mid-bin samples")
    else:
        p.add_argument('--checkpoint_path', default="./Phase2/checkpoints_new_2/", help="checkpoints path")
        p.add_argument('--n_pos_freq', default=10, help="position encoding frequencies")
        p.add_argument('--n_dirc_freq', default=4, help="direction encoding frequencies")
        p.add_argument('--hidden_size', default=256, type=int, help="hidden layer width")
        p.add_argument('--perturb', default=True, type=bool, help="use stratified sampling")
        p.add_argument('--near', default=2.0, type=_bound, help="near bound, or 'auto'")
        p.add_argument('--far', default=6.0, type=_bound, help="far bound, or 'auto'")
        p.add_argument('--chunk_size', default=1024 * 32, type=int)
        p.add_argument('--render_variant', default='train', help="train|legacy compositor")
        p.add_argument('--arch', default='active', help="active|legacy MLP architecture")
        p.add_argument('--no_pos_encoding', action='store_true')
        p.add_argument('--lindisp', action='store_true')
        p.add_argument('--n_importance', default=0, type=int,
                       help="importance samples per ray (0: off; a coarse/fine "
                            "model pair when on)")
        p.add_argument('--eval_split', default='test', choices=['test', 'train'])
        p.add_argument('--save_depth', action='store_true',
                       help="also save depth / disparity / acc maps per view")
        p.add_argument('--seed', default=0, type=int)
    if mode == "train":
        p.add_argument('--lrate', default=5e-4, help="training learning rate")
        p.add_argument('--n_rays_batch', default=32 * 32 * 8, help="number of rays per batch")
        p.add_argument('--max_iters', default=200001, help="number of max iterations for training")
        p.add_argument('--logs_path', default="./logs/",
                       help="logs path: the TensorBoard event file goes to "
                            "<logs_path>/<exp_name>")
        p.add_argument('--log_id', default="",
                       help="log id (accepted as Phase2/train.py accepts it; unused there too)")
        p.add_argument('--exp_name', default="lego_experiment",
                       help="experiment name: the TensorBoard run's directory")
        p.add_argument('--load_checkpoint', default=True, help="whether to load checkpoint or not")
        p.add_argument('--save_ckpt_iter', default=1000, help="num of iteration to save checkpoint")
        p.add_argument('--ckpt_backend', default="npz", choices=["npz", "orbax"],
                       help="checkpoint writer: npz (written by the training loop) or "
                            "orbax (the same npz files, written from a background thread)")
        p.add_argument('--lrate_decay', default=0.1, type=float, help="learning rate decay factor")
        p.add_argument('--lrate_decay_steps', default=50000, type=int, help="learning rate decay steps")
        p.add_argument('--density_bias_init', default=0.0, type=float,
                       help="initial density-head bias")
        p.add_argument('--dp', default=0, type=int,
                       help="data-parallel ranks (0 = every rank torchrun started)")
        # additions of the port
        p.add_argument('--log_every', default=100, type=int,
                       help="read the loss back every this many steps")
        p.add_argument('--val_every', default=1000, type=int,
                       help="render the validation views every this many steps (0: never)")
        p.add_argument('--two_kernel_step', action='store_true',
                       help="train through fused_render_train's forward and "
                            "backward kernels instead of the merged step kernel")
    return p


def _model_name(data_path: str) -> str:
    name = (data_path.split("/")[-2] if data_path.count("/")
            else data_path.rstrip("/"))
    return name or data_path.rstrip("/").split("/")[-1]


def build_config(args):
    from sfm_nerf_tpu_torch.config import (
        NeRFModelConfig, NeRFPipelineConfig, ParallelConfig, RenderConfig,
    )

    return NeRFPipelineConfig(
        model=NeRFModelConfig(
            n_pos_freq=int(args.n_pos_freq), n_dir_freq=int(args.n_dirc_freq),
            hidden=int(args.hidden_size), pos_encoding=not args.no_pos_encoding,
            arch=args.arch,
            density_bias_init=float(getattr(args, "density_bias_init", 0.0)),
        ),
        render=RenderConfig(
            n_sample=int(args.n_sample), n_importance=int(args.n_importance),
            near=float(args.near), far=float(args.far), perturb=bool(args.perturb),
            lindisp=bool(args.lindisp), chunk_size=int(args.chunk_size),
            variant=args.render_variant, use_fused_kernel=bool(args.fused),
            white_background=bool(args.white_bkgd),
            fused_merged_step=not getattr(args, "two_kernel_step", False),
        ),
        train=_train_config(args),
        parallel=ParallelConfig(dp=int(getattr(args, "dp", 0))),
        data_path=args.data_path, mode=args.mode,
        logs_path=getattr(args, "logs_path", "./logs/"),
        log_id=getattr(args, "log_id", ""),
        exp_name=getattr(args, "exp_name", "lego_experiment"),
        checkpoint_path=os.path.join(args.checkpoint_path, _model_name(args.data_path)),
        load_checkpoint=bool(getattr(args, "load_checkpoint", True)),
        images_path=args.images_path,
    )


def _train_config(args):
    from sfm_nerf_tpu_torch.config import TrainConfig

    if args.mode != "train":
        return TrainConfig(seed=int(args.seed))
    return TrainConfig(
        lrate=float(args.lrate), lrate_decay=float(args.lrate_decay),
        lrate_decay_steps=int(args.lrate_decay_steps),
        n_rays_batch=int(args.n_rays_batch), max_iters=int(args.max_iters),
        save_ckpt_iter=int(args.save_ckpt_iter), log_every=int(args.log_every),
        val_every=int(args.val_every), seed=int(args.seed), ckpt_backend=args.ckpt_backend,
    )


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; pass --device cpu")
    return torch.device(name)


class _Timer:
    """Milliseconds of the work between start() and stop(): CUDA events on
    a card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.e1.record()
            torch.cuda.synchronize()
            return float(self.e0.elapsed_time(self.e1))
        return (time.perf_counter() - self.t0) * 1e3


def _u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def _resolve_bounds(args, cam, split: str) -> None:
    """--near/--far auto -> the dataset's hint."""
    for name in ("near", "far"):
        if getattr(args, name) == "auto":
            hint = getattr(cam, name)
            if hint is None:
                raise SystemExit(
                    f"--{name} auto: transforms_{split}.json carries "
                    f"no '{name}' hint")
            print(f"--{name} auto -> {hint:.3f} (dataset hint)")
            setattr(args, name, hint)


def run_train(args) -> dict:
    """Train mode.  Returns the trainer's stats with the logged losses,
    validation errors and the trained model."""
    import torch.distributed as dist

    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset
    from sfm_nerf_tpu_torch.parallel.mesh import init_from_env
    from sfm_nerf_tpu_torch.train.nerf_trainer import NeRFTrainer
    from sfm_nerf_tpu_torch.utils.tb_events import SummaryWriter

    device = init_from_env(_device(args.device).type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.dp > world:
        raise SystemExit(f"--dp {args.dp} but {world} rank(s) started: launch with "
                         f"torchrun --nproc_per_node {args.dp}")
    print("Loading data...")
    images, poses, cam = load_blender_dataset(
        args.data_path, "train", downscale=int(args.downscale))
    _resolve_bounds(args, cam, "train")
    cfg = build_config(args)
    print("Start training")
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    writer = SummaryWriter(os.path.join(cfg.logs_path, cfg.exp_name)) if rank0 else None
    trainer = NeRFTrainer(cfg, images, poses, cam.camera_matrix, device=device,
                          writer=writer)
    try:
        stats = trainer.fit()
    finally:
        if writer is not None:
            writer.close()
    print(f"Training done: {stats}")
    mesh = None if trainer.mesh is None else dict(zip(trainer.mesh.mesh_dim_names,
                                                       trainer.mesh.shape))
    return {**stats, "start_iter": trainer.start_iter, "losses": trainer.loss_log,
            "val": trainer.val_log, "mesh": mesh, "model": trainer.model,
            "events": writer.path if writer else None,
            "writer_s": writer.seconds if writer else None}


def run_test(args) -> List[dict]:
    """Test mode.  Returns one record per rendered view."""
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset
    from sfm_nerf_tpu_torch.io.png import write_png
    from sfm_nerf_tpu_torch.models.convert import params_from_jax
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt_lib
    from sfm_nerf_tpu_torch.train.nerf_trainer import (
        make_render_image, make_render_image_aux,
    )
    from sfm_nerf_tpu_torch.utils.metrics import psnr_from_mse, ssim

    device = _device(args.device)
    print("Loading data...")
    images, poses, cam = load_blender_dataset(
        args.data_path, args.eval_split, downscale=int(args.downscale))
    _resolve_bounds(args, cam, args.eval_split)
    cfg = build_config(args)
    print("Start testing")
    render = (make_render_image_aux if args.save_depth else make_render_image)(cfg)
    path = ckpt_lib.latest_checkpoint(cfg.checkpoint_path, prefer_final=True)
    if path is None:
        print("No checkpoint found. Exiting.")
        return []
    print(f"Loading final model from {path}")
    params, _ = ckpt_lib.load_params_untyped(path)
    model = params_from_jax(params, cfg.model, device).eval()

    out_dir = os.path.join(cfg.images_path, os.path.basename(cfg.checkpoint_path))
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(cfg.train.seed)
    n_test = min(5, len(images))
    idxs = rng.choice(len(images), n_test, replace=False)
    height, width = images.shape[1], images.shape[2]
    K = torch.as_tensor(cam.camera_matrix, device=device)
    timer = _Timer(device)
    total = 0.0
    records = []
    for i, idx in enumerate(idxs):
        print(f"Rendering test image {i + 1}/{n_test}...")
        pose = torch.as_tensor(poses[int(idx)], device=device)
        timer.start()
        out = render(model, K, pose, height, width)
        ms = timer.stop()
        if args.save_depth:
            rgb, depth, disp, acc = (t.cpu().numpy() for t in out)
            dn = np.clip((depth - cfg.render.near)
                         / max(cfg.render.far - cfg.render.near, 1e-9), 0, 1)
            disp = np.where(acc > 1e-6, disp, 0.0)
            disp = np.clip(disp / max(disp.max(), 1e-9), 0, 1)
            write_png(os.path.join(out_dir, f"test_{i}_depth.png"), (dn * 255).astype(np.uint8))
            write_png(os.path.join(out_dir, f"test_{i}_disp.png"), (disp * 255).astype(np.uint8))
            write_png(os.path.join(out_dir, f"test_{i}_acc.png"), _u8(acc))
            pred = rgb
        else:
            pred = out.cpu().numpy()
        gt = images[int(idx)]
        mse_val = float(((pred - gt) ** 2).mean())
        total += mse_val
        pred8, gt8 = _u8(pred), (gt * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f"test_{i}_gt.png"), gt8)
        write_png(os.path.join(out_dir, f"test_{i}_pred.png"), pred8)
        write_png(os.path.join(out_dir, f"test_{i}_comparison.png"),
                  np.concatenate([gt8, pred8], axis=1))
        psnr = psnr_from_mse(mse_val)
        ssim_val = ssim(pred, gt)
        print(f"  MSE {mse_val:.6f}  PSNR {psnr:.2f} dB  SSIM {ssim_val:.4f}")
        records.append({"view": int(idx), "mse": mse_val, "psnr": psnr,
                        "ssim": ssim_val, "ms": ms})
    print(f"Testing complete. Average loss: {total / n_test:.6f}")
    print(f"Results saved to {out_dir}")
    return records


def load_any_checkpoint(ckpt_dir: str):
    """The checkpoint gif mode renders from ``ckpt_dir``: ``(path, kind)``,
    kind None for an npz (``final_model.ckpt.npz``, else the newest
    ``model_*.ckpt.npz``) and 'pth' for a reference file
    (``final_model.pth``, else the numerically newest ``model_*.pth``);
    ``(None, None)`` when there is neither."""
    from sfm_nerf_tpu_torch.models.convert import latest_pth
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt_lib

    npz = ckpt_lib.latest_checkpoint(ckpt_dir, prefer_final=True)
    if npz is not None:
        return npz, None
    pth = latest_pth(ckpt_dir)
    return (pth, "pth") if pth is not None else (None, None)


def run_gif(args) -> List[dict]:
    """Gif mode: turntable frames.  Returns one record per frame."""
    from sfm_nerf_tpu_torch.config import NeRFPipelineConfig, RenderConfig
    from sfm_nerf_tpu_torch.io.blender import load_camera_info, look_at_pose, pose_spherical
    from sfm_nerf_tpu_torch.io.png import write_png
    from sfm_nerf_tpu_torch.models.convert import convert_pth, params_from_jax
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt_lib
    from sfm_nerf_tpu_torch.train.nerf_trainer import make_render_image

    device = _device(args.device)
    print("Loading data...")
    # the reference's gif mode reads the TRAIN split's camera
    cam = load_camera_info(args.data_path, "train", downscale=int(args.downscale))
    height, width = cam.height, cam.width
    names = [args.data_path.split("/")[-2] if args.data_path.count("/") else "",
             args.data_path.rstrip("/").split("/")[-1]]
    path = kind = None
    for model_name in dict.fromkeys(n for n in names if n):
        path, kind = load_any_checkpoint(os.path.join(args.checkpoint_path, model_name))
        if path is not None:
            break
    if path is None:
        path, kind = load_any_checkpoint(args.checkpoint_path)
    if path is None:
        print("No checkpoint found")
        return []
    print(f"Loading checkpoint... {path}")
    if kind == "pth":
        params, mcfg = convert_pth(path)
    else:
        params, _ = ckpt_lib.load_params_untyped(path)
        if set(params) == {"coarse", "fine"}:
            params = params["fine"]
        mcfg = ckpt_lib.infer_model_config(params)
    model = params_from_jax(params, mcfg, device).eval()
    print(f"Checkpoint {path} loaded")
    cfg = NeRFPipelineConfig(
        model=mcfg,
        render=RenderConfig(
            n_sample=int(args.n_sample),
            near=1.0 if args.near is None else float(args.near),
            far=10.0 if args.far is None else float(args.far),
            perturb=not args.no_perturb,
            variant="train" if args.train_variant else "legacy",
            use_fused_kernel=bool(args.fused),
            white_background=bool(args.white_bkgd),
        ),
    )
    render = make_render_image(cfg)
    K = torch.as_tensor(cam.camera_matrix, device=device)
    generator = None
    if not args.no_perturb:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    os.makedirs(args.images_path, exist_ok=True)
    timer = _Timer(device)
    records = []
    t0 = time.time()
    for count, th in enumerate(
            np.linspace(0.0, 360.0, int(args.n_frames), endpoint=False), start=1):
        if args.orbit == "lookat":
            el = np.deg2rad(float(args.orbit_elev))
            r = float(args.orbit_radius)
            thr = np.deg2rad(float(th))
            eye = np.array([r * np.cos(el) * np.cos(thr), r * np.sin(el),
                            r * np.cos(el) * np.sin(thr)])
            target = np.array([float(v) for v in args.orbit_target.split(",")])
            c2w = look_at_pose(eye, target)
        else:
            c2w = pose_spherical(float(th), float(args.orbit_elev), float(args.orbit_radius))
        pose = torch.as_tensor(c2w, dtype=torch.float32, device=device)
        timer.start()
        img = render(model, K, pose, height, width, generator)
        ms = timer.stop()
        img = np.clip(img.cpu().numpy() * 255.0, 0, 255)
        # the reference's cv2.imwrite read the RGB render as BGR: the file
        # holds the channels swapped unless --rgb_frames
        frame = img if args.rgb_frames else img[..., ::-1]
        out = os.path.join(args.images_path, f"image_{count}.png")
        write_png(out, np.ascontiguousarray(frame.astype(np.uint8)))
        print(f"wrote {out}")
        records.append({"frame": count, "path": out, "ms": ms, "pose": c2w.tolist()})
    print(f"gif frames rendered in {time.time() - t0:.1f}s")
    return records


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--mode', default='train')
    mode = pre.parse_known_args(argv)[0].mode
    if mode not in ("train", "test", "gif"):
        raise SystemExit(f"--mode {mode!r} is not implemented (use train, test or gif)")
    args = config_parser(mode).parse_args(argv)
    return {"train": run_train, "test": run_test, "gif": run_gif}[mode](args)


if __name__ == "__main__":
    main()
