"""The port's NeRF CLI (train, test and gif modes) on a 16^2 synthetic dataset
and a JAX-written checkpoint, held against the JAX renderer; its flags
against the JAX parsers; its PNG codec against imageio."""

import glob
import importlib.util
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.config import NeRFModelConfig as JaxModelConfig
from sfm_nerf_tpu.config import NeRFPipelineConfig as JaxPipelineConfig
from sfm_nerf_tpu.config import RenderConfig as JaxRenderConfig
from sfm_nerf_tpu.io.blender import pose_spherical
from sfm_nerf_tpu.models import init_nerf_params
from sfm_nerf_tpu.train.checkpoint import save_checkpoint
from sfm_nerf_tpu.train.nerf_trainer import make_render_image
from sfm_nerf_tpu_torch.cli.nerf import config_parser, main
from sfm_nerf_tpu_torch.io.png import read_png, write_png
from sfm_nerf_tpu_torch.utils.metrics import psnr
from util_synthetic import make_blender_dataset

HERE = os.path.dirname(__file__)
REPO = os.path.join(HERE, "..")
H = W = 16
MODEL = dict(hidden=32, n_pos_freq=4, n_dir_freq=2)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = make_blender_dataset(str(root / "data" / "scene"), n_frames=6, height=H, width=W)
    jcfg = JaxModelConfig(density_bias_init=0.5, **MODEL)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    init_nerf_params(jax.random.key(0), jcfg))
    save_checkpoint(str(root / "ckpt" / "scene"), 10, params, final=True)
    return root, data + "/", params, jcfg


def _model_flags():
    return ["--hidden_size", str(MODEL["hidden"]), "--n_pos_freq", str(MODEL["n_pos_freq"]),
            "--n_dirc_freq", str(MODEL["n_dir_freq"])]


def _jax_render(params, jcfg, rcfg, K, pose):
    cfg = JaxPipelineConfig(model=jcfg, render=rcfg)
    img = make_render_image(cfg)(jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.asarray(K), jnp.asarray(pose, jnp.float32), H, W)
    return np.asarray(img)


def _u8(x):
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("route", [[], ["--no_fused"]])
def test_cli_test_mode(setup, route, capsys):
    from sfm_nerf_tpu.io.blender import load_blender_dataset

    root, data, params, jcfg = setup
    images_path = root / f"images{len(route)}"
    records = main(["--mode", "test", "--device", "cpu", "--data_path", data,
                    "--checkpoint_path", str(root / "ckpt"),
                    "--images_path", str(images_path), "--save_depth",
                    *_model_flags(), *route])
    out = capsys.readouterr().out
    assert len(records) == 5 and out.count("  MSE ") == 5 and "PSNR" in out
    names = sorted(os.path.basename(p) for p in glob.glob(str(images_path / "scene" / "*.png")))
    assert names == sorted([f"test_{i}_{k}.png" for i in range(5)
                            for k in ("gt", "pred", "comparison", "depth", "disp", "acc")]
                           + [f"figure_{i}.png" for i in range(5)])
    images, poses, cam = load_blender_dataset(data, "test", use_native=False)
    idxs = np.random.default_rng(0).choice(len(images), 5, replace=False)
    assert [r["view"] for r in records] == [int(i) for i in idxs]
    rcfg = JaxRenderConfig(n_sample=256, near=2.0, far=6.0, perturb=True)
    for i, idx in enumerate(idxs):
        expected = _jax_render(params, jcfg, rcfg, cam.camera_matrix, poses[idx])
        pred = read_png(str(images_path / "scene" / f"test_{i}_pred.png")) / 255.0
        p = psnr(pred, _u8(expected) / 255.0)
        assert p >= 45.0, f"view {idx}: port vs JAX PSNR {p:.1f} dB"
        gt = read_png(str(images_path / "scene" / f"test_{i}_gt.png"))
        np.testing.assert_array_equal(gt, (images[idx] * 255).astype(np.uint8))


def test_cli_gif_mode(setup):
    root, data, params, jcfg = setup
    images_path = root / "gif"
    records = main(["--mode", "gif", "--device", "cpu", "--data_path", data,
                    "--checkpoint_path", str(root / "ckpt"), "--images_path", str(images_path),
                    "--no_perturb", "--n_frames", "2", "--n_sample", "64"])
    assert [os.path.basename(r["path"]) for r in records] == ["image_1.png", "image_2.png"]
    focal = 0.5 * 0.6911112070083618 * W / np.tan(0.5 * 0.6911112070083618)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    rcfg = JaxRenderConfig(n_sample=64, near=1.0, far=10.0, perturb=False, variant="legacy")
    for count, th in ((1, 0.0), (2, 180.0)):
        expected = _jax_render(params, jcfg, rcfg, K, pose_spherical(th, -30.0, 4.0))
        frame = read_png(str(images_path / f"image_{count}.png"))
        # the reference's cv2.imwrite stored the channels swapped
        exp8 = np.clip(expected * 255.0, 0, 255).astype(np.uint8)[..., ::-1]
        assert np.abs(frame.astype(int) - exp8.astype(int)).max() <= 2
        assert psnr(frame / 255.0, exp8 / 255.0) >= 45.0


@pytest.mark.parametrize("route", [[], ["--two_kernel_step"], ["--no_fused"]])
def test_cli_train_mode_then_test_mode(setup, route, capsys):
    """--mode train on the CPU for 12 steps (the fused routes run their plain
    versions), then a second call resumes from the newest checkpoint, then
    --mode test renders from the final_model.ckpt.npz it saved."""
    root, data, _, _ = setup
    ck = root / ("train_ckpt" + "".join(route).replace("-", ""))
    flags = ["--device", "cpu", "--data_path", data, "--checkpoint_path", str(ck),
             "--n_sample", "16", "--n_rays_batch", "64", "--lrate", "5e-3",
             "--log_every", "1", "--val_every", "10", "--save_ckpt_iter", "5",
             "--logs_path", str(root / "logs"), *_model_flags(), *route]
    stats = main(["--mode", "train", "--max_iters", "12", *flags])
    losses = [v for _, v in stats["losses"]]
    assert stats["steps"] == 12 and stats["start_iter"] == 0 and len(losses) == 12
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])
    assert len(stats["val"]) == 5                       # n_val_images views at step 10
    assert sorted(os.listdir(ck / "scene")) == [
        "final_model.ckpt.npz", "model_000005.ckpt.npz", "model_000010.ckpt.npz"]
    resumed = main(["--mode", "train", "--max_iters", "13", *flags])
    assert resumed["start_iter"] == 11 and resumed["steps"] == 2
    assert "Training done" in capsys.readouterr().out
    records = main(["--mode", "test", "--device", "cpu", "--data_path", data,
                    "--checkpoint_path", str(ck), "--images_path", str(root / "train_img"),
                    "--n_sample", "16", *_model_flags(),
                    *[f for f in route if f == "--no_fused"]])
    assert len(records) == 5 and all(np.isfinite(r["mse"]) for r in records)
    # the JAX package reads the checkpoint the port's CLI wrote
    from sfm_nerf_tpu.train.checkpoint import load_params_untyped

    params, step = load_params_untyped(str(ck / "scene" / "final_model.ckpt.npz"))
    assert step == 12 and params["fc1"]["w"].shape == (27, MODEL["hidden"])


def _jax_parser(script):
    spec = importlib.util.spec_from_file_location(
        f"_jax_cli_{script}", os.path.join(REPO, "Phase2", f"{script}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.configParser()


# flags the port adds to a mode's JAX parser
MIP = ["mipnerf"]
ADDED = {"test": ["device"] + MIP, "gif": ["device"],
         "train": ["device", "log_every", "val_every", "two_kernel_step", "lr_schedule",
                   "lrate_final", "lr_anneal_steps"] + MIP}


@pytest.mark.parametrize("mode,script", [("test", "train"), ("gif", "Wrapper"),
                                         ("train", "train")])
def test_flag_names_and_defaults_match_jax(mode, script):
    ours = {a.dest: a.default for a in config_parser(mode)._actions if a.dest != "help"}
    theirs = {a.dest: a.default for a in _jax_parser(script)._actions if a.dest != "help"}
    for added in ADDED[mode]:
        ours.pop(added)
    missing = sorted(set(ours) - set(theirs))
    assert not missing, f"flags the JAX {script}.py parser lacks: {missing}"
    for k, v in ours.items():
        assert v == theirs[k], f"--{k}: {v!r} vs JAX {theirs[k]!r}"


@pytest.mark.parametrize("family", ["synth800", "chair800"])
def test_png_round_trip_against_imageio(family, tmp_path):
    path = os.path.join(REPO, "Phase2", "nerf_synthetic", family, "test", "r_0.png")
    ours = read_png(path)
    ref = imageio.imread(path)
    assert ours.shape == (800, 800, 3)
    np.testing.assert_array_equal(ours, ref)
    out = str(tmp_path / "x.png")
    write_png(out, ours)
    np.testing.assert_array_equal(imageio.imread(out), ref)
    grey = ref[..., 1]
    write_png(out, grey)
    np.testing.assert_array_equal(read_png(out), imageio.imread(out))
    np.testing.assert_array_equal(read_png(out), grey)
