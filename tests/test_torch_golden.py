"""Golden gate for the port: its make_render_image renders the three
committed checkpoints from the cameras of tests/test_golden.py (200^2
frames, 128 samples) and is held against the committed golden PNGs, read
through the port's own PNG reader.  To keep the suite's time down only
every 4th row and column is rendered (2,500 rays): intrinsics divided by 4
put pixel (x, y) of a 50^2 frame on pixel (4x, 4y) of the 200^2 one."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu_torch.config import NeRFPipelineConfig, RenderConfig
from sfm_nerf_tpu_torch.io.blender import derive_focal, look_at_pose
from sfm_nerf_tpu_torch.io.png import read_png
from sfm_nerf_tpu_torch.models.convert import params_from_jax
from sfm_nerf_tpu_torch.train import checkpoint as ckpt
from sfm_nerf_tpu_torch.train.nerf_trainer import make_render_image
from sfm_nerf_tpu_torch.utils.metrics import psnr

HERE = os.path.dirname(__file__)
GOLDEN_DIR = os.path.join(HERE, "goldens")
CKPT_ROOT = os.path.join(HERE, "..", "Phase2", "checkpoints")
CAMERA_ANGLE_X = 0.6911112070083618
SIZE, STRIDE, N_SAMPLE = 200, 4, 128


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _camera(family):
    """(K of the 200^2 frame, pose, white background) as test_golden.py."""
    if family == "chair800":
        with open(os.path.join(HERE, "..", "Phase2", "nerf_synthetic", "chair800",
                               "transforms_test.json")) as fh:
            tj = json.load(fh)
        f = derive_focal(tj["camera_angle_x"], SIZE)
        pose = np.asarray(tj["frames"][0]["transform_matrix"], np.float32)
        white = True
    else:
        f = derive_focal(CAMERA_ANGLE_X, SIZE)
        el = np.deg2rad(30.0)
        eye = np.array([4.0 * np.cos(el), 4.0 * np.sin(el), 0.0])
        pose = look_at_pose(eye, np.array([0.0, -0.2, 0.0])).astype(np.float32)
        white = False
    K = np.array([[f, 0, SIZE / 2], [0, f, SIZE / 2], [0, 0, 1]], np.float32)
    return K, pose, white


def _render_port(family, fused=False):
    params, _ = ckpt.load_params_untyped(
        os.path.join(CKPT_ROOT, family, "final_model.ckpt.npz"))
    mcfg = ckpt.infer_model_config(params)
    K, pose, white = _camera(family)
    cfg = NeRFPipelineConfig(model=mcfg, render=RenderConfig(
        n_sample=N_SAMPLE, near=2.0, far=6.0, perturb=False, variant="train",
        white_background=white, use_fused_kernel=fused))
    Ks = K.copy()
    Ks[:2] /= STRIDE
    n = SIZE // STRIDE
    img = make_render_image(cfg)(params_from_jax(params, mcfg), torch.from_numpy(Ks),
                                 torch.from_numpy(pose), n, n)
    return img.numpy(), params, mcfg, Ks, pose


@pytest.mark.parametrize("family", ["synth800", "chair800", "synth800_nope"])
def test_port_golden_subset_psnr(family):
    img, params, mcfg, Ks, pose = _render_port(family)
    golden = read_png(os.path.join(GOLDEN_DIR, f"{family}_200_train.png"))
    golden = golden[::STRIDE, ::STRIDE] / 255.0
    p = psnr(np.clip(img, 0, 1), golden)
    assert p >= 40.0, f"{family}: PSNR vs committed golden = {p:.1f} dB"
    # content checks of tests/test_golden.py
    assert img.std() > 0.02
    if family == "synth800":
        assert img.max() > 0.3
    if family == "chair800":
        assert img.min() < 0.45, "white-bkgd frame lost its dark object"
    if family == "synth800":
        # the same 2,500 rays through the JAX package's renderer
        from sfm_nerf_tpu.config import RenderConfig as JaxRenderConfig
        from sfm_nerf_tpu.models import nerf_apply
        from sfm_nerf_tpu.ops.rays import image_rays
        from sfm_nerf_tpu.ops.render import render_rays_chunked
        from sfm_nerf_tpu.train.checkpoint import infer_model_config

        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
        jcfg = infer_model_config(params)
        o, d = image_rays(jnp.asarray(Ks), jnp.asarray(pose), img.shape[0], img.shape[1])
        rj = render_rays_chunked(
            lambda p_, d_: nerf_apply(jp, p_, d_, jcfg), o, d,
            JaxRenderConfig(n_sample=N_SAMPLE, near=2.0, far=6.0, perturb=False))
        pj = psnr(img, np.asarray(rj).reshape(img.shape))
        assert pj >= 50.0, f"port vs JAX PSNR = {pj:.1f} dB"


@pytest.mark.parametrize("family", ["synth800", "chair800"])
def test_port_fused_route_golden_subset_psnr(family):
    """The serving route: bf16-packed weights through the fused render's
    plain version (what the CUDA kernel computes on a card)."""
    img = _render_port(family, fused=True)[0]
    golden = read_png(os.path.join(GOLDEN_DIR, f"{family}_200_train.png"))
    p = psnr(np.clip(img, 0, 1), golden[::STRIDE, ::STRIDE] / 255.0)
    assert p >= 40.0, f"{family} fused route: PSNR vs committed golden = {p:.1f} dB"


def test_ssim_matches_jax_on_a_golden():
    """The port's SSIM (float64 numpy) against the JAX package's (float32)
    on the committed synth800 golden and a seeded perturbation of it, each
    way round and against itself: to 1e-6."""
    from sfm_nerf_tpu.utils.metrics import ssim as jax_ssim
    from sfm_nerf_tpu_torch.utils.metrics import ssim

    gold = read_png(os.path.join(GOLDEN_DIR, "synth800_200_train.png")).astype(np.float64) / 255.0
    noisy = np.clip(gold + np.random.default_rng(0).normal(0.0, 0.05, gold.shape), 0.0, 1.0)
    values = []
    for a, b in ((gold, gold), (noisy, gold), (gold, noisy), (noisy[..., 0], gold[..., 0])):
        got, want = ssim(a, b), float(jax_ssim(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - want) <= 1e-6, (got, want)
        values.append(got)
    assert values[0] == pytest.approx(1.0, abs=1e-12) and values[1] < 0.99
