"""The render route's envelope gate: a network outside the fused kernels'
envelope (hidden not a multiple of 16 or above 256, more than MAX_FREQ
encoding frequencies) renders through the nn.Module path, as the JAX
package sends such a config to XLA (`_fused_render_env_ok`), and the CLI
trains, validates and tests it; inside the envelope the route stays fused."""

import dataclasses

import numpy as np
import pytest
import torch

from sfm_nerf_tpu_torch.cli.nerf import main
from sfm_nerf_tpu_torch.config import NeRFModelConfig, NeRFPipelineConfig, RenderConfig
from sfm_nerf_tpu_torch.models.nerf import NeRF, NeRFPair
from sfm_nerf_tpu_torch.train import nerf_trainer as nt
from util_synthetic import make_blender_dataset

BASE = dict(hidden=32, n_pos_freq=4, n_dir_freq=2)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _refuse(*args, **kwargs):
    raise AssertionError("a fused render wrapper was called outside the envelope")


@pytest.mark.parametrize("change,n_importance", [
    (dict(hidden=40), 0), (dict(n_pos_freq=17), 0), (dict(hidden=272), 0),
    (dict(hidden=40), 8)])
def test_out_of_envelope_network_renders_through_the_module_path(change, n_importance,
                                                                 monkeypatch):
    mcfg = NeRFModelConfig(**{**BASE, **change})
    rcfg = RenderConfig(n_sample=16, n_importance=n_importance, use_fused_kernel=True)
    cfg = NeRFPipelineConfig(model=mcfg, render=rcfg)
    assert not nt.use_fused_route(cfg) and not nt.fused_network_supported(mcfg)
    assert not nt.fused_train_supported(cfg)
    inside = NeRFPipelineConfig(model=NeRFModelConfig(**BASE), render=rcfg)
    assert nt.use_fused_route(inside) and nt.fused_network_supported(inside.model)
    model = (NeRFPair if n_importance else NeRF)(mcfg, seed=0)
    K = torch.tensor([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]])
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    module = NeRFPipelineConfig(model=mcfg, render=dataclasses.replace(
        rcfg, use_fused_kernel=False))
    ref = nt.make_render_image(module)(model, K, pose, 8, 8)
    for name in ("fused_render_rays", "fused_render_rays_weights"):
        monkeypatch.setattr(nt, name, _refuse)
    img = nt.make_render_image(cfg)(model, K, pose, 8, 8)
    rgb, depth, disp, acc = nt.make_render_image_aux(cfg)(model, K, pose, 8, 8)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert torch.equal(img, ref) and torch.equal(rgb, ref)
    assert all(bool(torch.isfinite(t).all()) for t in (depth, acc))


def test_cli_trains_validates_and_tests_an_out_of_envelope_network(tmp_path):
    """--hidden_size 40: train mode (the nn.Module route) renders its
    validation view, and test mode renders the checkpoint, on the CPU."""
    data = make_blender_dataset(str(tmp_path / "data" / "scene"), n_frames=6,
                                height=16, width=16) + "/"
    flags = ["--device", "cpu", "--data_path", data,
             "--checkpoint_path", str(tmp_path / "ckpt"), "--hidden_size", "40",
             "--n_pos_freq", "4", "--n_dirc_freq", "2", "--n_sample", "16"]
    stats = main(["--mode", "train", *flags, "--n_rays_batch", "64", "--max_iters", "3",
                  "--log_every", "1", "--val_every", "1"])
    assert stats["val"] and all(np.isfinite(v) for _, _, v in stats["val"])
    records = main(["--mode", "test", *flags, "--images_path", str(tmp_path / "images")])
    assert len(records) == 5 and all(np.isfinite(r["psnr"]) for r in records)
