"""The plain reference agrees with the port's plain versions at a small
size on the CPU (a test may import both; the reference itself imports
nothing of the program)."""

import pytest
import torch

from benchmark import compare, inputs, program
from benchmark.reference import active
from benchmark.reference import nerf as ref
from benchmark.tests import tiny

M = {"arch": "active", "hidden": 32, "n_pos_freq": 10, "n_dir_freq": 4}
TRAIN_R = {"n_sample": 16, "n_importance": 0, "near": 2.0, "far": 6.0, "variant": "train",
           "white_background": False, "perturb": True}
T = {"n_rays_batch": 64, "lrate": 5e-4, "lrate_decay": 0.1, "lrate_decay_steps": 2,
     "log_every": 100}


def _nets(n=1, seed=3, m=M):
    return ref.init_params(active, m, n, torch.Generator().manual_seed(seed), "cpu")


def test_encoding_matches_the_port():
    from sfm_nerf_tpu_torch.ops.encoding import positional_encoding

    x = torch.randn(50, 3) * 2
    assert torch.equal(ref.encode(x, 10), positional_encoding(x, 10))


@pytest.mark.parametrize("extra", [{}, {"pos_encoding": False}], ids=["encoded", "no-encoding"])
def test_mlp_matches_the_port_module(extra):
    m = {**M, **extra}
    cfg = program.pipeline_config(m, dict(TRAIN_R), T)
    nets = _nets(m=m)
    model = program.build_model(cfg, nets, "cpu")
    pts, dirs = torch.randn(200, 3), torch.nn.functional.normalize(torch.randn(200, 3), dim=-1)
    sigma, rgb = ref.mlp(active, nets[0], m, pts, dirs)
    d_p, rgb_p = model(pts, dirs)
    torch.testing.assert_close(sigma, d_p[:, 0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rgb, rgb_p, rtol=1e-5, atol=1e-6)


OPTIONS = [(v, lindisp, white) for v in ("train", "legacy") for lindisp in (False, True)
           for white in (False, True)]


def test_density_bias_init_raises_the_ports_density_bias():
    """The model group's ``density_bias_init`` moves the bias entry that
    the port's init moves, and no other parameter."""
    from sfm_nerf_tpu_torch.models.nerf import NeRF

    m = {**M, "density_bias_init": 0.5}
    base, raised = _nets()[0], _nets(m=m)[0]
    moved = {(k, i) for k in base
             for i in torch.nonzero(raised[k][1] != base[k][1]).flatten().tolist()}
    cfg0, cfg1 = (program.pipeline_config(mm, dict(TRAIN_R), T).model for mm in (M, m))
    n0, n1 = NeRF(cfg0, seed=4), NeRF(cfg1, seed=4)
    moved_port = {(k, i) for k in n0.layers
                  for i in torch.nonzero(n1.layers[k].bias != n0.layers[k].bias).flatten().tolist()}
    assert moved == moved_port == {active.DENSITY_BIAS}


@pytest.mark.parametrize("variant, lindisp, white", OPTIONS,
                         ids=[f"{v}-lindisp{int(ld)}-white{int(w)}" for v, ld, w in OPTIONS])
def test_sampling_and_compositing_match_the_port(variant, lindisp, white):
    from sfm_nerf_tpu_torch.config import RenderConfig
    from sfm_nerf_tpu_torch.ops.render import composite, stratified_samples

    r = {**TRAIN_R, "variant": variant, "lindisp": lindisp, "white_background": white}
    rcfg = RenderConfig(n_sample=16, near=2.0, far=6.0, variant=variant, lindisp=lindisp,
                        white_background=white)
    u = torch.rand(30, 16)
    z = ref.stratified(30, r, u, "cpu")
    torch.testing.assert_close(z, stratified_samples(30, rcfg, None, "cpu", u))
    torch.testing.assert_close(ref.stratified(30, r, None, "cpu"),
                               stratified_samples(30, rcfg, None, "cpu"))
    sigma, rgb = torch.rand(30, 16) * 3, torch.rand(30, 16, 3)
    out, w = ref.composite(sigma, rgb, z, r)
    out_p, w_p, _ = composite(sigma[..., None], rgb, z, rcfg)
    torch.testing.assert_close(out, out_p)
    torch.testing.assert_close(w, w_p)


def test_importance_sampling_matches_the_port():
    from sfm_nerf_tpu_torch.ops.render import merge_sorted, sample_pdf

    z = torch.sort(torch.rand(40, 16) * 4 + 2, -1).values
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    w = torch.rand(40, 14)
    u = torch.rand(40, 8)
    got = ref.sample_pdf(mids, w, 8, u)
    torch.testing.assert_close(got, sample_pdf(mids, w, 8, None, u))
    torch.testing.assert_close(torch.sort(torch.cat([z, got], -1), -1).values,
                               merge_sorted(z, got))


def test_rays_match_the_port():
    from sfm_nerf_tpu_torch.ops.rays import image_rays, sample_ray_batch

    d = {"n_images": 3, "height": 12, "width": 10, "camera_angle_x": 0.69, "radius": 4.0}
    K = inputs.camera_matrix(d, "cpu")
    poses = inputs.sphere_poses(3, 4.0, 5, "cpu")
    images = torch.rand(3, 12, 10, 3)
    draws = (torch.randint(0, 3, (20,)), torch.randint(0, 10, (20,)), torch.randint(0, 12, (20,)))
    o, dd, t = sample_ray_batch(images, poses, K, 20, None, draws)
    o_r, d_r = ref.pixel_rays(K, poses, *draws)
    torch.testing.assert_close(o_r, o)
    torch.testing.assert_close(d_r, dd)
    o, dd = image_rays(K, poses[1], 12, 10)
    o_r, d_r = ref.image_rays(K, poses[1], 12, 10)
    torch.testing.assert_close(o_r, o)
    torch.testing.assert_close(d_r, dd)


@pytest.mark.parametrize("cell", ["flat-train", "hier-train", "flat-train-wrapper"])
def test_training_steps_match_the_port(cell):
    """The set-up's three steps of the port (its CPU route: the kernels'
    plain versions in float32, or the nn.Module route) against the
    reference's, by the run's own numbers, far inside any limit."""
    spec, lp = tiny.loop(cell)
    numbers = compare.train_numbers(lp.readings, lp.reference_readings())
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4
    assert numbers["update_gap"] < 1e-3


def test_frame_matches_the_port_module_route():
    from sfm_nerf_tpu_torch.train.nerf_trainer import make_render_image

    r = {**TRAIN_R, "perturb": False}
    cfg = program.pipeline_config(M, r, T)
    cfg = cfg.__class__(model=cfg.model, render=cfg.render.__class__(
        **{**cfg.render.__dict__, "use_fused_kernel": False}), train=cfg.train)
    nets = _nets()
    model = program.build_model(cfg, nets, "cpu")
    d = {"height": 9, "width": 8, "camera_angle_x": 0.69}
    K = inputs.camera_matrix(d, "cpu")
    pose = inputs.sphere_poses(1, 4.0, 2, "cpu")[0]
    got = ref.render_frame(active, nets[0], M, r, K, pose, 9, 8)
    torch.testing.assert_close(got, make_render_image(cfg)(model, K, pose, 9, 8),
                               rtol=1e-5, atol=1e-6)
