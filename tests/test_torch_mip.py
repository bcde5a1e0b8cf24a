"""mip-NeRF on the port (the mip arch, cone casting) held against the plain
reference of ``tests/mipnerf_reference.py`` on the CPU: the frustum
Gaussian and both encodings, the resampler, the nn.Module forward, the
cone kernels' plain versions (rgb, weights, the two-level loss and every
parameter gradient through one network), ``make_loss_fn`` and one
``make_train_step`` Adam update under the log-linear schedule, and a
16 x 16 ``--mode test`` frame.  Small sizes: hidden 32, 16 rays x 8
intervals; seeded random weights.

Tolerances: both sides compute in float32 with other operation orders, so
they agree to float32 rounding amplified by what follows it; each test says
how far.  A float32 packing of the kernels' plain versions is compared (the
CUDA kernels take bf16; their rounding is the card tests' business), and
the grads' tolerance is tight enough that the same plain version with a
bf16 packing fails it (``test_cone_twins_two_level_loss_and_grads``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import mipnerf_reference as ref
from sfm_nerf_tpu_torch.config import (
    NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig,
)
from sfm_nerf_tpu_torch.kernels import fused_render as fr
from sfm_nerf_tpu_torch.kernels import fused_train as ft
from sfm_nerf_tpu_torch.models.nerf import NeRF
from sfm_nerf_tpu_torch.ops.encoding import frustum_gaussian, integrated_pos_enc, view_encoding
from sfm_nerf_tpu_torch.ops.rays import sample_ray_batch
from sfm_nerf_tpu_torch.ops.render import cone_edges, render_cones, resample_edges
from sfm_nerf_tpu_torch.train.nerf_trainer import (
    make_loss_fn, make_optimizer, make_render_image, make_train_step,
)

HIDDEN, N_RAYS, S = 32, 16, 8
NEAR, FAR = 2.0, 6.0
MCFG = NeRFModelConfig(arch="mip", hidden=HIDDEN, n_pos_freq=16, n_dir_freq=4,
                       density_bias_init=-1.0)
RCFG = RenderConfig(n_sample=S, near=NEAR, far=FAR, white_background=True,
                    use_fused_kernel=True)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _scene(seed=0, n_img=3, hw=16):
    """Seeded images, poses looking at the origin from radius 4, K of an
    800-pixel-wide camera's angle at ``hw`` pixels."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0, 1, (n_img, hw, hw, 3)).astype(np.float32))
    poses = []
    for i in range(n_img):
        th = 2 * np.pi * i / n_img
        eye = np.array([4 * np.cos(th), 4 * np.sin(th), 1.0])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        pose = np.eye(4)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, eye
        poses.append(pose)
    f = 0.5 * 0.6911112070083618 * hw / math.tan(0.5 * 0.6911112070083618)
    K = torch.tensor([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]], dtype=torch.float32)
    return images, torch.tensor(np.stack(poses), dtype=torch.float32), K


def _params(seed=1):
    return ref.init_params(torch.Generator().manual_seed(seed), HIDDEN)


def _model(params):
    model = NeRF(MCFG)
    with torch.no_grad():
        for name, (w, b) in params.items():
            model.layers[name].weight.copy_(w.t())
            model.layers[name].bias.copy_(b)
    return model


def _draws(images, seed=2):
    g = torch.Generator().manual_seed(seed)
    n_img, hw = images.shape[0], images.shape[1]
    img = torch.randint(0, n_img, (N_RAYS,), generator=g)
    px = torch.randint(0, hw, (N_RAYS,), generator=g)
    py = torch.randint(0, hw, (N_RAYS,), generator=g)
    u = torch.rand(N_RAYS, S + 1, generator=g)
    r = torch.rand(N_RAYS, S + 1, generator=g)
    return (img, px, py), u, r


def _batch(seed=0):
    images, poses, K = _scene(seed)
    (img, px, py), u, r = _draws(images)
    o, d, viewdirs, radii = ref.cone_rays(K, poses, img, px, py)
    return images, poses, K, (img, px, py), u, r, (o, d, viewdirs, radii), images[img, py, px]


def test_cone_rays_match_reference():
    """The port's cones: the same un-normalised directions, |d| and the
    radius 2 / (sqrt(12) fx) to float32 rounding."""
    images, poses, K, draws, _, _, (o, d, viewdirs, radii), target = _batch()
    o2, d2, cones, t2 = sample_ray_batch(images, poses, K, N_RAYS, draws=draws, cones=True)
    assert torch.equal(o2, o) and torch.equal(d2, d) and torch.equal(t2, target)
    torch.testing.assert_close(cones[:, 0], radii, rtol=1e-6, atol=0)
    torch.testing.assert_close(d2 / cones[:, 1:2], viewdirs, rtol=1e-6, atol=1e-7)


def test_frustum_gaussian_and_encodings_match_reference():
    """The frustum Gaussian within float32 rounding of its inputs (1e-6
    relative); the integrated encoding within 1e-5: its sines amplify the
    mean's last bit by 2^l, but exp(-cov 4^l / 2) has taken those octaves
    to ~0 where the amplification passes 1e-6.  A bf16 rounding of the
    encoding moves it by ~4e-3 and would fail."""
    *_, u, _, (o, d, viewdirs, radii), _ = _batch()
    t = ref.sample_along_rays(N_RAYS, S, NEAR, FAR, u)
    mean_r, cov_r = ref.cast_rays(t, o, d, radii)
    mean, cov = frustum_gaussian(o, d, radii, t[:, :-1], t[:, 1:])
    torch.testing.assert_close(mean, mean_r, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(cov, cov_r, rtol=1e-5, atol=1e-12)
    enc, enc_r = integrated_pos_enc(mean, cov, 16), ref.integrated_pos_enc(mean_r, cov_r)
    assert enc.shape == (N_RAYS, S, 96)
    assert (enc - enc_r).abs().max().item() <= 1e-5
    assert (enc.bfloat16().float() - enc_r).abs().max().item() > 1e-5
    venc, venc_r = view_encoding(viewdirs, 4), ref.pos_enc(viewdirs)
    assert venc.shape == (N_RAYS, 27)
    assert (venc - venc_r).abs().max().item() <= 1e-6


@pytest.mark.parametrize("jitter", [True, False])
def test_resampler_matches_reference(jitter):
    """The blurred resampler on the same coarse edges, weights and draws:
    the same edges to float32 rounding (the reference finds each draw's bin
    by a mask, the port by searchsorted)."""
    *_, u, r, _, _ = _batch()
    t = ref.sample_along_rays(N_RAYS, S, NEAR, FAR, u)
    w = torch.rand(N_RAYS, S, generator=torch.Generator().manual_seed(7)) ** 4
    got = resample_edges(t, w, RCFG, u=r if jitter else None)
    want = ref.resample_along_rays(t, w, r if jitter else None)
    assert got.shape == (N_RAYS, S + 1)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def test_module_forward_matches_reference():
    """One level through the nn.Module (render_cones) against the
    reference's render_level: rgb and weights within 1e-5 (float32, other
    summation orders through ten layers)."""
    *_, u, _, (o, d, viewdirs, radii), _ = _batch()
    params = _params()
    model = _model(params)
    t = ref.sample_along_rays(N_RAYS, S, NEAR, FAR, u)
    cones = torch.stack([radii, torch.linalg.vector_norm(d, dim=-1)], -1)
    with torch.no_grad():
        rgb, w, _ = render_cones(model, o, d, cones, t, RCFG)
        rgb_r, w_r = ref.render_level(params, t, o, d, viewdirs, radii, True)
    torch.testing.assert_close(rgb, rgb_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(w, w_r, rtol=0, atol=1e-5)


def _leaf_gaps(got, want):
    """Each parameter's gap of grads over the larger of its reference norm
    and the median leaf's."""
    norms = {k: want[k].norm().item() for k in want}
    med = float(np.median(list(norms.values())))
    return {k: (got[k] - want[k]).norm().item() / max(norms[k], med) for k in want}


def _ref_grads(params, target, rays, u, r):
    g, loss = ref.grads(params, target, *rays, NEAR, FAR, S, True, u_edges=u, r_resample=r)
    out = {}
    for name, (gw, gb) in g.items():
        out[f"layers.{name}.weight"], out[f"layers.{name}.bias"] = gw.t(), gb
    return out, loss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cone_twins_two_level_loss_and_grads(dtype):
    """The cone kernels' plain versions (K4 over the coarse edges, the
    resampler, K2 over the fine edges, one packing) against the reference's
    two-level loss through one network: each level's rgb and weights within
    1e-5, the loss within 1e-5 relative, every parameter's gradient within
    1e-4 of the larger of its norm and the median leaf's (float32 sums in
    other orders, through the resampled edges).  A bf16 packing breaks the
    gradient rule (~1e-2)."""
    images, poses, K, draws, u, r, rays, target = _batch()
    params = _params()
    model = _model(params)
    o, d, viewdirs, radii = rays
    cones = torch.stack([radii, torch.linalg.vector_norm(d, dim=-1)], -1)
    packed = fr.pack_nerf_params(model, MCFG, dtype)
    t_c = cone_edges(N_RAYS, RCFG, u=u)
    loss_c, w_c = ft.fused_mse_loss_cones_weights(packed, o, d, cones, t_c, target, RCFG)
    t_f = resample_edges(t_c, w_c, RCFG, u=r)
    loss_f = ft.fused_mse_loss_cones(packed, o, d, cones, t_f, target, RCFG)
    loss = 0.1 * loss_c + loss_f
    loss.backward()
    want, loss_r = _ref_grads(params, target, rays, u, r)
    gaps = _leaf_gaps({n: p.grad for n, p in model.named_parameters()}, want)
    if dtype == torch.bfloat16:
        assert max(gaps.values()) > 1e-4, gaps
        return
    rgb_c, rgb_f, t_cr, w_cr, t_fr = ref.two_level(params, *rays, NEAR, FAR, S, True,
                                                   u_edges=u, r_resample=r)
    rgb_ct = fr.fused_render_cones(packed, o, d, cones, t_c, RCFG)
    rgb_ft, w_ft = fr.fused_render_cones_weights(packed, o, d, cones, t_f, RCFG)
    torch.testing.assert_close(t_c, t_cr, rtol=0, atol=1e-6)
    torch.testing.assert_close(rgb_ct, rgb_c, rtol=0, atol=1e-5)
    torch.testing.assert_close(w_c, w_cr, rtol=0, atol=1e-5)
    torch.testing.assert_close(t_f, t_fr, rtol=0, atol=1e-5)
    torch.testing.assert_close(rgb_ft, rgb_f.detach(), rtol=0, atol=1e-5)
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * loss_r.item()
    assert max(gaps.values()) <= 1e-4, gaps
    assert w_ft.shape == (N_RAYS, S)


def _cfg(fused=True, **train):
    return NeRFPipelineConfig(
        model=MCFG, render=dataclasses.replace(RCFG, use_fused_kernel=fused),
        train=TrainConfig(n_rays_batch=N_RAYS, lr_schedule="loglinear", **train))


@pytest.mark.parametrize("fused", [True, False])
def test_make_loss_fn_and_one_adam_update(fused):
    """make_loss_fn (the cone kernels' plain versions, or the nn.Module
    route) on the reference's draws: the loss within 1e-5 relative.  One
    make_train_step update under the log-linear schedule, the step drawing
    from its generator what the reference draws from the same seed: each
    parameter's change within 1e-3 of the learning rate of the reference's
    Adam step (a first Adam step moves each entry by about the learning
    rate, its sign and size set by the gradient's, which agree to 1e-4),
    and the schedule's next rate the reference's."""
    images, poses, K, draws, u, r, rays, target = _batch()
    params = _params()
    cfg = _cfg(fused)
    model = _model(params)
    loss = make_loss_fn(cfg)(model, None, images, poses, K, draws=draws, u=u, u_pdf=r)
    _, loss_r = _ref_grads(params, target, rays, u, r)
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * loss_r.item()
    opt, sched = make_optimizer(cfg, model)
    make_train_step(cfg, opt, sched)(model, torch.Generator().manual_seed(2), images, poses, K)

    def grad_fn(cur, _):
        return ref.grads(cur, target, *rays, NEAR, FAR, S, True, u_edges=u, r_resample=r)[0]

    after = ref.adam_steps(params, grad_fn, 1)
    lr = ref.learning_rate(0)
    for name, (w, b) in after.items():
        dw = model.layers[name].weight.detach().t() - params[name][0]
        db = model.layers[name].bias.detach() - params[name][1]
        assert (dw - (w - params[name][0])).abs().max().item() <= 1e-3 * lr, name
        assert (db - (b - params[name][1])).abs().max().item() <= 1e-3 * lr, name
    assert opt.param_groups[0]["lr"] == pytest.approx(ref.learning_rate(1), rel=1e-12)


def test_train_step_runs_on_its_own_draws():
    """make_train_step over both routes from one seed: the same loss to
    float32 rounding (the kernels' plain versions in float32 and the
    nn.Module draw the same rays, edges and resampling draws)."""
    images, poses, K = _scene()
    losses = []
    for fused in (True, False):
        cfg = _cfg(fused)
        model = _model(_params())
        opt, sched = make_optimizer(cfg, model)
        step = make_train_step(cfg, opt, sched)
        losses.append(step(model, torch.Generator().manual_seed(3), images, poses, K).item())
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)


def test_frame_matches_reference():
    """A 16 x 16 frame of make_render_image (the cone kernels' plain
    versions, bf16-packed as a renderer packs, and the nn.Module route)
    against the reference's two levels at the even draws: the nn.Module
    route within 1e-5, the bf16 route within 1e-2 (bf16 weights and
    activations)."""
    images, poses, K = _scene()
    params = _params()
    model = _model(params)
    from sfm_nerf_tpu_torch.ops.rays import image_cones

    o, d, cones = image_cones(K, poses[1], 16, 16)
    viewdirs = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    with torch.no_grad():
        want = ref.two_level(params, o, d, viewdirs, cones[:, 0], NEAR, FAR, S, True)[1]
    plain = make_render_image(_cfg(False))(model, K, poses[1], 16, 16)
    fused = make_render_image(_cfg(True))(model, K, poses[1], 16, 16)
    assert plain.shape == (16, 16, 3)
    assert (plain.reshape(-1, 3) - want).abs().max().item() <= 1e-5
    assert (fused.reshape(-1, 3) - want).abs().max().item() <= 1e-2


@pytest.mark.parametrize("route", [[], ["--no_fused"]])
def test_cli_test_mode_frame(tmp_path, route):
    """``cli.nerf --mode test --mipnerf`` on a 16 x 16 Blender scene from a
    mip checkpoint: each view's MSE that of the reference's frame (the
    nn.Module route within 1e-6 absolute; the kernels' plain version packs
    bf16, within 1e-3)."""
    from util_synthetic import make_blender_dataset

    from sfm_nerf_tpu_torch.cli.nerf import main
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset
    from sfm_nerf_tpu_torch.models.convert import params_to_jax
    from sfm_nerf_tpu_torch.train import checkpoint as ckpt_lib

    data = make_blender_dataset(str(tmp_path / "data" / "scene"), n_frames=4, height=16,
                                width=16) + "/"
    params = _params()
    ckpt_lib.save_checkpoint(str(tmp_path / "ckpt" / "scene"), 5,
                             params_to_jax(_model(params)), final=True)
    records = main(["--mode", "test", "--device", "cpu", "--data_path", data, "--mipnerf",
                    "--n_sample", str(S), "--hidden_size", str(HIDDEN), "--white_bkgd",
                    "--checkpoint_path", str(tmp_path / "ckpt"),
                    "--images_path", str(tmp_path / "img")] + route)
    assert len(records) == 4
    images, poses, cam = load_blender_dataset(data, "test")
    K = torch.as_tensor(cam.camera_matrix, dtype=torch.float32)
    for rec in records:
        pose = torch.as_tensor(poses[rec["view"]], dtype=torch.float32)
        from sfm_nerf_tpu_torch.ops.rays import image_cones

        o, d, cones = image_cones(K, pose, 16, 16)
        viewdirs = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        with torch.no_grad():
            frame = ref.two_level(params, o, d, viewdirs, cones[:, 0], NEAR, FAR, S, True)[1]
        mse = float(((frame.reshape(16, 16, 3).numpy() - images[rec["view"]]) ** 2).mean())
        assert rec["mse"] == pytest.approx(mse, abs=1e-3 if not route else 1e-6)


def test_reference_imports_nothing_of_the_port_or_jax():
    """The plain reference stands alone: importing it loads torch and
    nothing of JAX, of the JAX package or of the port."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(__file__)
    probe = ("import sys; sys.path.insert(0, %r); import mipnerf_reference; "
             "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'sfm_nerf_tpu', 'sfm_nerf_tpu_torch')); "
             "assert not bad, bad" % here)
    subprocess.run([sys.executable, "-c", probe], check=True, cwd=here)
