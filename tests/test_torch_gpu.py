"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports torch and the port only (no jax), so it runs on a machine without
JAX.  There, run it without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Without a card every test here skips.
"""

import os

import numpy as np
import pytest
import torch

from sfm_nerf_tpu_torch.config import RenderConfig
from sfm_nerf_tpu_torch.kernels import fused_render as fr
from sfm_nerf_tpu_torch.kernels import fused_train as ft
from sfm_nerf_tpu_torch.models.convert import params_from_jax
from sfm_nerf_tpu_torch.train import checkpoint as ckpt

CKPTS = os.path.join(os.path.dirname(__file__), "..", "Phase2", "checkpoints")
SYNTH800 = os.path.join(CKPTS, "synth800", "final_model.ckpt.npz")


def _packed_model(name):
    """bf16 packing on the card of a committed checkpoint ('synth800',
    'synth800_nope') or of a seeded model ('legacy', 'hidden64')."""
    from sfm_nerf_tpu_torch.config import NeRFModelConfig
    from sfm_nerf_tpu_torch.models.nerf import NeRF

    if name.startswith("synth800"):
        params, _ = ckpt.load_params_untyped(os.path.join(CKPTS, name, "final_model.ckpt.npz"))
        mcfg = ckpt.infer_model_config(params)
        return fr.pack_nerf_params(params_from_jax(params, mcfg, "cuda"), mcfg, torch.bfloat16)
    mcfg = {"legacy": NeRFModelConfig(arch="legacy"),
            "hidden64": NeRFModelConfig(hidden=64, n_pos_freq=6, n_dir_freq=2)}[name]
    return fr.pack_nerf_params(NeRF(mcfg, device="cuda", seed=1), mcfg, torch.bfloat16)


def _rays(n, s, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] -= 4.0
    d = (rng.normal(size=(n, 3)) * 0.3 + [0, 0, 1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), -1).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (o, d, z))


@pytest.mark.gpu
@pytest.mark.parametrize("model,variant,white,n_sample,n_rays", [
    ("synth800", "train", False, 256, 2048), ("synth800", "legacy", False, 200, 2048),
    ("synth800", "train", True, 64, 2048), ("legacy", "train", False, 128, 1024),
    ("synth800_nope", "train", False, 128, 1024), ("hidden64", "legacy", False, 96, 1024),
    ("synth800", "train", False, 384, 50)])       # fewer rays than the card has SMs
def test_fused_render_kernel_matches_plain_version(model, variant, white, n_sample, n_rays):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    packed = _packed_model(model)
    o, d, z = _rays(n_rays, n_sample, seed=n_sample)
    rcfg = RenderConfig(n_sample=n_sample, variant=variant, white_background=white)
    before = dict(fr.LAUNCHES)
    rgb, w = fr.fused_render_rays_weights(packed, o, d, z, rcfg)
    rgb1 = fr.fused_render_rays(packed, o, d, z, rcfg)
    torch.cuda.synchronize()
    assert fr.LAUNCHES["fused_render_rays"] == before["fused_render_rays"] + 1
    assert fr.LAUNCHES["fused_render_rays_weights"] == before["fused_render_rays_weights"] + 1
    rr, wr = fr.fused_render_rays_reference(packed, o, d, z, rcfg, emit_weights=True)
    # bf16 rounding points flip where the two sum in other orders; at a
    # sharp surface a flip moves weight between neighbouring samples.  The
    # plain version in float64 flips other roundings: a weight may be off by
    # 1e-2 or by that float32-vs-float64 spread, whichever is larger.
    w64 = fr.fused_render_rays_reference(packed, o.double(), d.double(), z.double(), rcfg,
                                         emit_weights=True)[1]
    w_tol = max(1e-2, (wr.double() - w64).abs().max().item())
    if model == "synth800_nope":
        # raw coordinates into a steep MLP: a few weights move by up to 5e-2
        # between the tensor cores' sums (the WMMA and the wgmma kernel
        # alike) and IEEE float32 sums, where float64 moves them by 2e-8.
        # The plain version with its products summed on the tensor cores
        # is the witness of that sensitivity.
        wtc = fr.fused_render_rays_reference(packed, o, d, z, rcfg, emit_weights=True,
                                             bf16_products=True)[1]
        w_tol = max(w_tol, (wr - wtc).abs().max().item())
    assert (rgb - rr).abs().max().item() <= 1e-2
    assert (w - wr).abs().max().item() <= w_tol
    assert ((w - wr).abs() > 1e-3).float().mean().item() <= 1e-4
    assert (w.sum(-1) - wr.sum(-1)).abs().max().item() <= 1e-2
    assert torch.equal(rgb, rgb1)
    # deterministic: rays go to warpgroups in a fixed order, no atomics
    assert torch.equal(rgb1, fr.fused_render_rays(packed, o, d, z, rcfg))


@pytest.mark.gpu
def test_fused_render_kernel_rejects_f32_packing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, _ = ckpt.load_params_untyped(SYNTH800)
    mcfg = ckpt.infer_model_config(params)
    packed = fr.pack_nerf_params(params_from_jax(params, mcfg, "cuda"), mcfg, torch.float32)
    o, d, z = _rays(64, 32, seed=0)
    with pytest.raises(ValueError):
        fr.fused_render_rays(packed, o, d, z, RenderConfig(n_sample=32))


def _train_batch(n, s, seed):
    o, d, z = _rays(n, s, seed)
    target = torch.from_numpy(
        np.random.default_rng(seed + 1).uniform(0, 1, (n, 3)).astype(np.float32)).cuda()
    return o, d, z, target


def _assert_grads_close(packed, got, ref, f64):
    """Per parameter: the kernel's grad within 2e-2 of the plain version's
    norm and 5e-2 of its largest value, or within the plain version's own
    float32-vs-float64 spread where that is larger (bf16 rounding flips of
    activations and cotangents move both the same way)."""
    got, ref = ft.unpack_grads(packed, *got), ft.unpack_grads(packed, *ref)
    f64 = ft.unpack_grads(packed, *(t.float() for t in f64))
    for k in ref:
        nr, mr = ref[k].norm().item(), ref[k].abs().max().item()
        if nr == 0.0:
            assert got[k].abs().max().item() == 0.0, k
            continue
        e, e64 = got[k] - ref[k], f64[k] - ref[k]
        assert e.norm().item() / nr <= max(2e-2, e64.norm().item() / nr), k
        assert e.abs().max().item() / mr <= max(5e-2, e64.abs().max().item() / mr), k


@pytest.mark.gpu
@pytest.mark.parametrize("white,n_rays,n_sample", [
    (False, 1024, 256), (True, 777, 200), (False, 100, 64)])
def test_fused_train_kernels_match_plain_versions(white, n_rays, n_sample):
    """K2 (fused_mse_loss) and K3 (fused_render_train forward and backward)
    at hidden 256 against their plain versions on the same inputs; ragged
    sample counts and ray counts that fill no block included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, _ = ckpt.load_params_untyped(SYNTH800)
    mcfg = ckpt.infer_model_config(params)
    model = params_from_jax(params, mcfg, "cuda")
    packed = fr.pack_nerf_params(model, mcfg, torch.bfloat16)
    o, d, z, target = _train_batch(n_rays, n_sample, seed=n_sample)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    before = dict(ft.LAUNCHES)
    # K2, both ways of holding activations, and twice: bit-equal
    rgb, gw, gb = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    rgb_b, gw_b, gb_b = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    _, gw_r, gb_r = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg,
                                            keep_activations=False)
    assert ft.LAUNCHES["fused_mse_loss"] == before["fused_mse_loss"] + 3
    assert torch.equal(gw, gw_b) and torch.equal(gb, gb_b) and torch.equal(rgb, rgb_b)
    rr, gwr, gbr = ft.fused_mse_loss_reference(packed, o, d, z, target, rcfg)
    _, gw64, gb64 = ft.fused_mse_loss_reference(packed, o.double(), d.double(), z.double(),
                                                target.double(), rcfg)
    assert (rgb - rr).abs().max().item() <= 1e-2
    assert bool(torch.isfinite(gw).all()) and bool(torch.isfinite(gb).all())
    _assert_grads_close(packed, (gw, gb), (gwr, gbr), (gw64, gb64))
    _assert_grads_close(packed, (gw_r, gb_r), (gwr, gbr), (gw64, gb64))
    # K3 with a cotangent that is not the MSE's
    rgb3, tb = ft.fused_render_train_forward(packed, o, d, z, rcfg)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(n_rays, 3))
                         .astype(np.float32)).cuda() * 1e-3
    gw3, gb3 = ft.fused_render_train_backward(packed, o, d, z, rcfg, tb, g)
    assert ft.LAUNCHES["fused_render_train"] == before["fused_render_train"] + 1
    assert ft.LAUNCHES["fused_render_train_backward"] == \
        before["fused_render_train_backward"] + 1
    rr3, tbr = ft.fused_render_train_reference(packed, o, d, z, rcfg)
    assert torch.equal(rgb3, rgb)
    assert (tb - tbr).abs().max().item() <= 1e-2
    ref3 = ft.fused_render_train_reference(packed, o, d, z, rcfg, g=g)
    ref3_64 = ft.fused_render_train_reference(packed, o.double(), d.double(), z.double(),
                                              rcfg, g=g.double())
    _assert_grads_close(packed, (gw3, gb3), ref3, ref3_64)
    # the recomputing step kernel is the backward kernel with the MSE cotangent
    gm = (rgb3 - target) * (2.0 / (3.0 * n_rays))
    gw3m, gb3m = ft.fused_render_train_backward(packed, o, d, z, rcfg, tb, gm)
    assert torch.equal(gw_r, gw3m) and torch.equal(gb_r, gb3m)


@pytest.mark.gpu
@pytest.mark.parametrize("white,n_rays,n_sample", [
    (False, 1024, 256), (True, 777, 200), (False, 300, 384)])
def test_fused_mse_loss_weights_kernel_matches_plain_version(white, n_rays, n_sample):
    """K4 (fused_mse_loss_weights): rgb and grads bit-equal to K2's on the
    same inputs, bit-equal across two runs, and the weights within the
    weight rule of the plain version's and of the render kernel's (K5, a
    kernel of its own since the wgmma redesign); a ragged last chunk writes
    the caller's S columns only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    params, _ = ckpt.load_params_untyped(SYNTH800)
    mcfg = ckpt.infer_model_config(params)
    model = params_from_jax(params, mcfg, "cuda")
    packed = fr.pack_nerf_params(model, mcfg, torch.bfloat16)
    o, d, z, target = _train_batch(n_rays, n_sample, seed=n_sample + 1)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    before = dict(ft.LAUNCHES)
    rgb, w, gw, gb = ft.fused_mse_loss_weights_grads(packed, o, d, z, target, rcfg)
    rgb_b, w_b, gw_b, gb_b = ft.fused_mse_loss_weights_grads(packed, o, d, z, target, rcfg)
    assert ft.LAUNCHES["fused_mse_loss_weights"] == before["fused_mse_loss_weights"] + 2
    assert ft.LAUNCHES["fused_mse_loss"] == before["fused_mse_loss"]
    assert all(torch.equal(a, b) for a, b in ((rgb, rgb_b), (w, w_b), (gw, gw_b), (gb, gb_b)))
    rgb2, gw2, gb2 = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    assert torch.equal(rgb, rgb2) and torch.equal(gw, gw2) and torch.equal(gb, gb2)
    assert w.shape == (n_rays, n_sample) and w.dtype == torch.float32
    rr, wr, gwr, gbr = ft.fused_mse_loss_weights_reference(packed, o, d, z, target, rcfg)
    _, w64, gw64, gb64 = ft.fused_mse_loss_weights_reference(
        packed, o.double(), d.double(), z.double(), target.double(), rcfg)
    w_tol = max(1e-2, (wr.double() - w64).abs().max().item())
    rgb5, w5 = fr.fused_render_rays_weights(packed, o, d, z, rcfg)
    for ref_rgb, ref_w in ((rr, wr), (rgb5, w5)):
        assert (rgb - ref_rgb).abs().max().item() <= 1e-2
        assert (w - ref_w).abs().max().item() <= w_tol
        assert ((w - ref_w).abs() > 1e-3).float().mean().item() <= 1e-4
        assert (w.sum(-1) - ref_w.sum(-1)).abs().max().item() <= 1e-2
    _assert_grads_close(packed, (gw, gb), (gwr, gbr), (gw64, gb64))


@pytest.mark.gpu
def test_hierarchical_step_and_frame_launch_counts():
    """One hierarchical loss on the card is one K4 and one K2 launch and
    fills both networks' grads; one hierarchical frame is one K5 and one K1
    launch, with the maps two K5 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sfm_nerf_tpu_torch.config import NeRFModelConfig, NeRFPipelineConfig, TrainConfig
    from sfm_nerf_tpu_torch.models.nerf import NeRFPair
    from sfm_nerf_tpu_torch.train.nerf_trainer import (
        make_loss_fn, make_render_image, make_render_image_aux,
    )

    cfg = NeRFPipelineConfig(
        model=NeRFModelConfig(hidden=64, n_pos_freq=6, n_dir_freq=2),
        render=RenderConfig(n_sample=96, n_importance=64, use_fused_kernel=True),
        train=TrainConfig(n_rays_batch=512))
    pair = NeRFPair(cfg.model, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (3, 24, 24, 3)).astype(np.float32)).cuda()
    poses = torch.eye(4).repeat(3, 1, 1).cuda()
    poses[:, 2, 3] = 4.0
    K = torch.tensor([[30.0, 0, 12], [0, 30.0, 12], [0, 0, 1]]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ft.reset_launch_counts()
    loss = make_loss_fn(cfg)(pair, gen, images, poses, K)
    loss.backward()
    assert ft.LAUNCHES["fused_mse_loss_weights"] == 1 and ft.LAUNCHES["fused_mse_loss"] == 1
    assert bool(torch.isfinite(loss))
    for name, p in pair.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert p.grad.abs().max().item() > 0 or "density_fc" in name, name
    fr.reset_launch_counts()
    img = make_render_image(cfg)(pair, K, poses[0], 24, 24)
    assert fr.LAUNCHES == {"fused_render_rays": 1, "fused_render_rays_weights": 1}
    rgb, depth, disp, acc = make_render_image_aux(cfg)(pair, K, poses[0], 24, 24)
    assert fr.LAUNCHES == {"fused_render_rays": 1, "fused_render_rays_weights": 3}
    assert torch.equal(rgb, img) and bool(torch.isfinite(depth).all())
    assert acc.min().item() >= -1e-6 and acc.max().item() <= 1 + 1e-5


@pytest.mark.gpu
def test_fused_train_wrappers_fill_parameter_grads():
    """loss.backward() through either wrapper fills every parameter's .grad
    on the card, and the two routes agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, _ = ckpt.load_params_untyped(SYNTH800)
    mcfg = ckpt.infer_model_config(params)
    model = params_from_jax(params, mcfg, "cuda")
    packed = fr.pack_nerf_params(model, mcfg, torch.bfloat16)
    o, d, z, target = _train_batch(512, 128, seed=3)
    rcfg = RenderConfig(n_sample=128)
    loss = ft.fused_mse_loss(packed, o, d, z, target, rcfg)
    loss.backward()
    g2 = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    rgb = ft.fused_render_train(packed, o, d, z, rcfg)
    loss3 = torch.mean((rgb - target) ** 2)
    loss3.backward()
    assert loss.item() == pytest.approx(loss3.item(), rel=1e-6)
    for n, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
        assert (p.grad - g2[n]).norm().item() <= 1e-5 * g2[n].norm().item() + 1e-12, n


@pytest.mark.gpu
def test_fused_train_kernel_rejects_f32_packing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, _ = ckpt.load_params_untyped(SYNTH800)
    mcfg = ckpt.infer_model_config(params)
    packed = fr.pack_nerf_params(params_from_jax(params, mcfg, "cuda"), mcfg, torch.float32)
    o, d, z, target = _train_batch(64, 32, seed=0)
    with pytest.raises(ValueError):
        ft.fused_mse_loss_grads(packed, o, d, z, target, RenderConfig(n_sample=32))
