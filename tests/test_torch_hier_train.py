"""Hierarchical (coarse/fine) training and rendering in the port against the
JAX package on the CPU: the step kernel with its weights output (its plain
version against the Pallas kernel in interpret mode), the whole
hierarchical loss with the grads of both networks, the full-frame
renderers, pair checkpoints carried both ways, the trainer and the CLI.

Sizes: hidden 32, 16-32 rays, 16-32 samples, 8-16 importance samples.  All
inputs are numpy arrays made from a seed and fed to both packages; the JAX
kernels run as their own tests run them (interpret, ray_tile 16,
sample_chunk 16, one tile per program)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.config import NeRFModelConfig as JaxModelConfig
from sfm_nerf_tpu.config import NeRFPipelineConfig as JaxPipelineConfig
from sfm_nerf_tpu.config import RenderConfig as JaxRenderConfig
from sfm_nerf_tpu.config import TrainConfig as JaxTrainConfig
from sfm_nerf_tpu.kernels import fused_render as jfr
from sfm_nerf_tpu.kernels import fused_train as jft
from sfm_nerf_tpu.models import init_nerf_params, nerf_apply
from sfm_nerf_tpu.ops import render as jrender
from sfm_nerf_tpu.train import checkpoint as jckpt
from sfm_nerf_tpu.train import nerf_trainer as jtrainer
from sfm_nerf_tpu_torch.cli.nerf import main
from sfm_nerf_tpu_torch.config import (
    NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig,
)
from sfm_nerf_tpu_torch.kernels import fused_render as tfr
from sfm_nerf_tpu_torch.kernels import fused_train as tft
from sfm_nerf_tpu_torch.models.convert import (
    optimizer_state_to_jax, params_from_jax, params_to_jax,
)
from sfm_nerf_tpu_torch.models.nerf import NeRF, NeRFPair
from sfm_nerf_tpu_torch.train import checkpoint as tckpt
from sfm_nerf_tpu_torch.train.nerf_trainer import (
    NeRFTrainer, fused_train_supported, make_loss_fn, make_render_image,
    make_render_image_aux, use_fused_route,
)
from util_synthetic import make_blender_dataset

INTERP = dict(ray_tile=16, sample_chunk=16, tiles_per_program=1, interpret=True)
MODEL = dict(hidden=32, n_pos_freq=4, n_dir_freq=2)
# tests/test_fused_train.py:_assert_grads_close
GRAD_RTOL, GRAD_ATOL_SCALE, LOSS_RTOL = 5e-3, 5e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _setup(n_rays=16, n_sample=32, seed=0):
    """tests/test_fused_train.py:setup with a second network for the fine
    pass (key 9, as :245)."""
    jcfg = JaxModelConfig(arch="active", **MODEL)
    params = {"coarse": _np_tree(init_nerf_params(jax.random.key(seed), jcfg)),
              "fine": _np_tree(init_nerf_params(jax.random.key(9), jcfg))}
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.tile(np.linspace(2.0, 6.0, n_sample, dtype=np.float32), (n_rays, 1))
    target = rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)
    return jcfg, params, o, d, z, target


def _mcfg(jcfg):
    return NeRFModelConfig(**dataclasses.asdict(jcfg))


def _grads_jax_layout(model):
    if isinstance(model, NeRFPair):
        return {side: _grads_jax_layout(getattr(model, side)) for side in ("coarse", "fine")}
    return {name: {"w": layer.weight.grad.numpy().T, "b": layer.bias.grad.numpy()}
            for name, layer in model.layers.items()}


def _assert_grads_close(g_jax, g_port, where=""):
    assert set(g_jax) == set(g_port)
    for name in g_jax:
        if "w" not in g_jax[name]:
            _assert_grads_close(g_jax[name], g_port[name], f"{name}/")
            continue
        for k in ("w", "b"):
            a, b = np.asarray(g_jax[name][k]), g_port[name][k]
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale,
                                       err_msg=f"grad mismatch at {where}{name}/{k}")


# ---------------------------------------------------------------------------
# K4: the step kernel with its weights output
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sample,white", [(32, False), (24, False), (24, True)])
def test_plain_step_with_weights_matches_jax_fused_mse_loss_weights(n_sample, white):
    """The plain version of fused_mse_loss_weights against the Pallas kernel
    in interpret mode, float32 packing: loss 1e-4 relative, weights 1e-5 at
    the caller's sample count (24 fills no 16-sample chunk:
    tests/test_fused_train.py:419), grads under the fused-train rule."""
    jcfg, params, o, d, z, target = _setup(n_sample=n_sample)
    jr = JaxRenderConfig(n_sample=n_sample, near=2.0, far=6.0, perturb=False,
                         white_background=white)

    def jax_loss(p):
        packed = jfr.pack_nerf_params(p, jcfg, jnp.float32)
        return jft.fused_mse_loss_weights(packed, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
                                          jnp.asarray(target), jcfg, jr, **INTERP)

    (lj, wj), gj = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params["coarse"]))
    model = params_from_jax(params["coarse"], _mcfg(jcfg))
    packed = tfr.pack_nerf_params(model, model.cfg, torch.float32)
    launches = dict(tft.LAUNCHES)
    loss, w = tft.fused_mse_loss_weights(
        packed, _t(o), _t(d), _t(z), _t(target), RenderConfig(n_sample=n_sample,
                                                              white_background=white))
    assert w.shape == (16, n_sample) and not w.requires_grad and loss.requires_grad
    loss.backward()
    assert tft.LAUNCHES == launches              # CPU tensors never launch
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=LOSS_RTOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0, atol=1e-5)
    _assert_grads_close(gj, _grads_jax_layout(model))
    assert w.numpy().max() > 1e-3


def test_weights_output_changes_nothing_else():
    """fused_mse_loss_weights gives fused_mse_loss's loss and grads exactly,
    its weights are the render's (fused_render_rays_weights) exactly, and
    backward scales by the loss's cotangent alone."""
    jcfg, params, o, d, z, target = _setup()
    rcfg = RenderConfig(n_sample=32)
    args = tuple(_t(a) for a in (o, d, z, target))

    def run(fn, scale=1.0):
        model = params_from_jax(params["coarse"], _mcfg(jcfg))
        out = fn(tfr.pack_nerf_params(model, model.cfg, torch.float32), *args, rcfg)
        loss, w = out if isinstance(out, tuple) else (out, None)
        (scale * loss).backward()
        return float(loss.detach()), w, model

    l2, _, m2 = run(tft.fused_mse_loss)
    l4, w4, m4 = run(tft.fused_mse_loss_weights)
    _, _, m4x3 = run(tft.fused_mse_loss_weights, 3.0)
    assert l2 == l4
    for (name, p), q, r in zip(m2.named_parameters(), m4.parameters(), m4x3.parameters()):
        assert torch.equal(p.grad, q.grad), name
        np.testing.assert_allclose(r.grad.numpy(), 3.0 * q.grad.numpy(), rtol=1e-6, atol=0)
    packed = tfr.pack_nerf_params(m2, m2.cfg, torch.float32)
    _, w5 = tfr.fused_render_rays_weights(packed, *args[:3], rcfg)
    assert torch.equal(w4, w5)
    rgb, w_raw, gw, gb = tft.fused_mse_loss_weights_grads(packed, *args, rcfg)
    rgb2, gw2, gb2 = tft.fused_mse_loss_grads(packed, *args, rcfg)
    assert torch.equal(w_raw, w4) and torch.equal(rgb, rgb2)
    assert torch.equal(gw, gw2) and torch.equal(gb, gb2)
    with pytest.raises(NotImplementedError):
        tft.fused_mse_loss_weights(packed, *args, RenderConfig(n_sample=32, variant="legacy"))


# ---------------------------------------------------------------------------
# the whole hierarchical loss
# ---------------------------------------------------------------------------


def _hier_case():
    """One batch for make_loss_fn: images, poses, K, the pixel draws, the
    depth jitter and the importance jitter (the numbers the JAX sample_pdf
    draws from its key)."""
    jcfg, params, *_ = _setup()
    rng = np.random.default_rng(3)
    n_img, hw, n_rays = 3, 12, 16
    images = rng.uniform(0, 1, (n_img, hw, hw, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_img, 1, 1))
    poses[:, 2, 3] = 4.0
    focal = 0.5 * 0.6911 * hw / np.tan(0.5 * 0.6911)
    K = np.array([[focal, 0, hw / 2], [0, focal, hw / 2], [0, 0, 1]], np.float32)
    draws = tuple(rng.integers(0, hi, n_rays) for hi in (n_img, hw, hw))
    u = rng.uniform(size=(n_rays, 32)).astype(np.float32)
    kpdf = jax.random.key(21)
    u_pdf = np.asarray(jax.random.uniform(kpdf, (n_rays, 16), dtype=jnp.float32))
    return jcfg, params, images, poses, K, draws, u, kpdf, u_pdf


def _port_hier_loss(route, case, compute_dtype="float32"):
    from sfm_nerf_tpu_torch.ops.rays import sample_ray_batch
    from sfm_nerf_tpu_torch.ops.render import stratified_samples

    jcfg, params, images, poses, K, draws, u, _, u_pdf = case
    cfg = NeRFPipelineConfig(
        model=_mcfg(jcfg),
        render=RenderConfig(n_sample=32, n_importance=16, **route),
        train=TrainConfig(n_rays_batch=16, compute_dtype=compute_dtype))
    pair = params_from_jax(params, cfg.model)
    assert isinstance(pair, NeRFPair)
    launches = dict(tft.LAUNCHES)
    tdraws = tuple(_t(a) for a in draws)
    loss = make_loss_fn(cfg)(pair, None, _t(images), _t(poses), _t(K), draws=tdraws,
                             u=_t(u), u_pdf=_t(u_pdf))
    loss.backward()
    assert tft.LAUNCHES == launches
    o, d, target = sample_ray_batch(_t(images), _t(poses), _t(K), 16, draws=tdraws)
    z = stratified_samples(16, cfg.render, u=_t(u))
    batch = tuple(jnp.asarray(t.numpy()) for t in (o, d, z, target))
    return float(loss.detach()), _grads_jax_layout(pair), batch, cfg


def test_hierarchical_loss_and_grads_match_jax_fused_and_xla():
    """tests/test_fused_train.py:235: the port's merged hierarchical loss
    (coarse step with weights -> sample_pdf -> sorted union -> fine step)
    and the grads of both networks against the JAX fused pipeline in
    interpret mode and against the JAX XLA path, on the same rays, depths
    and importance jitter; the port's nn.Module route against the same."""
    case = _hier_case()
    jcfg, params, *_, kpdf, _ = case
    lt, gt, (o, d, z, target), cfg = _port_hier_loss(
        dict(use_fused_kernel=True, fused_merged_step=True), case)
    assert fused_train_supported(cfg)
    jr = JaxRenderConfig(n_sample=32, near=2.0, far=6.0)
    mids = 0.5 * (z[..., 1:] + z[..., :-1])

    def fused_loss(p):
        packed_c = jfr.pack_nerf_params(p["coarse"], jcfg, jnp.float32)
        packed_f = jfr.pack_nerf_params(p["fine"], jcfg, jnp.float32)
        loss_c, weights = jft.fused_mse_loss_weights(packed_c, o, d, z, target, jcfg, jr, **INTERP)
        z_fine = jrender.sample_pdf(kpdf, mids, weights[..., 1:-1], 16)
        z_all = jrender.merge_sorted(z, z_fine)
        return jft.fused_mse_loss(packed_f, o, d, z_all, target, jcfg, jr, **INTERP) + loss_c

    def xla_loss(p):
        def run(net, zz):
            pts = o[:, None, :] + d[:, None, :] * zz[..., None]
            dens, rgb = nerf_apply(p[net], pts, jnp.broadcast_to(d[:, None, :], pts.shape), jcfg)
            return jrender.composite(dens, rgb, zz, jr)

        out_c, w, _ = run("coarse", z)
        z_fine = jrender.sample_pdf(kpdf, mids, jax.lax.stop_gradient(w[..., 1:-1]), 16)
        out_f = run("fine", jrender.merge_sorted(z, z_fine))[0]
        return jnp.mean((out_f - target) ** 2) + jnp.mean((out_c - target) ** 2)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    lk, gk = jax.jit(jax.value_and_grad(fused_loss))(jparams)
    lx, gx = jax.jit(jax.value_and_grad(xla_loss))(jparams)
    np.testing.assert_allclose(lt, float(lk), rtol=LOSS_RTOL)
    np.testing.assert_allclose(lt, float(lx), rtol=LOSS_RTOL)
    _assert_grads_close(gk, gt)
    _assert_grads_close(gx, gt)
    # the nn.Module route (autograd through render_rays_hierarchical)
    lm, gm, _, cfg_m = _port_hier_loss(dict(use_fused_kernel=False), case)
    assert not fused_train_supported(cfg_m)
    np.testing.assert_allclose(lm, float(lx), rtol=LOSS_RTOL)
    _assert_grads_close(gx, gm)


def test_coarse_grads_are_those_of_the_coarse_mse_alone():
    """The weights reach sample_pdf detached on the merged route: the coarse
    network's grads under the summed loss equal fused_mse_loss's on the
    coarse depths, exactly."""
    case = _hier_case()
    jcfg, params, *_ = case
    _, gt, (o, d, z, target), cfg = _port_hier_loss(
        dict(use_fused_kernel=True, fused_merged_step=True), case)
    coarse = params_from_jax(params["coarse"], cfg.model)
    tft.fused_mse_loss(tfr.pack_nerf_params(coarse, cfg.model, torch.float32),
                       *(_t(np.asarray(a)) for a in (o, d, z, target)), cfg.render).backward()
    alone = _grads_jax_layout(coarse)
    for name in alone:
        for k in ("w", "b"):
            np.testing.assert_array_equal(gt["coarse"][name][k], alone[name][k])
    assert max(np.abs(g["w"]).max() for g in gt["fine"].values()) > 1e-6


@pytest.mark.parametrize("route,supported", [
    (dict(use_fused_kernel=True, fused_merged_step=True), True),
    (dict(use_fused_kernel=True, fused_merged_step=False), False),   # no weights output there
    (dict(use_fused_kernel=True, variant="legacy"), False),
    (dict(use_fused_kernel=False), False),
])
def test_hierarchical_routes(route, supported):
    """The JAX gate's clause: hierarchical sampling trains through the fused
    kernels on the merged step only; every other route takes
    render_rays_hierarchical under autograd and gives a loss close to the
    merged route's (the legacy compositor apart, which is another function)."""
    case = _hier_case()
    loss, grads, _, cfg = _port_hier_loss(route, case)
    assert fused_train_supported(cfg) is supported
    assert np.isfinite(loss)
    assert all(np.isfinite(g[k]).all() for side in grads.values() for g in side.values()
               for k in ("w", "b"))
    if route.get("variant") != "legacy":
        merged, *_ = _port_hier_loss(dict(use_fused_kernel=True), case)
        np.testing.assert_allclose(loss, merged, rtol=LOSS_RTOL)
    jcfg = JaxPipelineConfig(
        model=case[0],
        render=JaxRenderConfig(n_sample=32, n_importance=16, fused_interpret=True,
                               fused_sample_chunk=16, **route))
    assert jtrainer.fused_train_supported(jcfg) is supported


def test_bf16_compute_dtype_needs_the_fused_route():
    """bf16 compute, hierarchical: the fused route packs bf16 weights (its
    loss within 5e-2 of the float32 one); the nn.Module route, once refused,
    casts the weight matrices as JAX's make_loss_fn does and matches its
    bf16 XLA loss and grads (tests/test_torch_interop.py's rule)."""
    from test_torch_interop import _bf16_case, assert_bf16_matches_jax

    case = _hier_case()
    loss, *_ = _port_hier_loss(dict(use_fused_kernel=True), case, compute_dtype="bfloat16")
    merged, *_ = _port_hier_loss(dict(use_fused_kernel=True), case)
    np.testing.assert_allclose(loss, merged, rtol=5e-2)
    module, grads, _, cfg = _port_hier_loss(dict(use_fused_kernel=False), case,
                                            compute_dtype="bfloat16")
    assert not fused_train_supported(cfg) and np.isfinite(module)
    np.testing.assert_allclose(module, merged, rtol=5e-2)
    assert_bf16_matches_jax(_bf16_case(hier=True))


# ---------------------------------------------------------------------------
# full-frame renderers
# ---------------------------------------------------------------------------


HW = 12


def _frame_case():
    jcfg = JaxModelConfig(density_bias_init=0.5, **MODEL)
    params = {"coarse": _np_tree(init_nerf_params(jax.random.key(1), jcfg)),
              "fine": _np_tree(init_nerf_params(jax.random.key(2), jcfg))}
    focal = 0.5 * 0.6911 * HW / np.tan(0.5 * 0.6911)
    K = np.array([[focal, 0, HW / 2], [0, focal, HW / 2], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    return jcfg, params, K, pose


@pytest.mark.parametrize("fused", [True, False])
def test_make_render_image_hierarchical_matches_jax(fused):
    """make_render_image and make_render_image_aux with n_importance > 0:
    the fused route (the kernels' plain versions on CPU tensors, bf16
    packing) against the JAX fused route in interpret mode, and the
    nn.Module route against the JAX XLA route.  Fused: rgb 5e-3 (bf16
    rounding flips, as tests/test_torch_fused_render.py), maps 2e-2;
    nn.Module: rgb 1e-5, maps 1e-4."""
    jcfg, params, K, pose = _frame_case()
    kw = dict(n_sample=16, n_importance=8, near=2.0, far=6.0, use_fused_kernel=fused)
    jpipe = JaxPipelineConfig(model=jcfg, render=JaxRenderConfig(
        fused_interpret=fused, fused_sample_chunk=16, **kw))
    assert jtrainer._fused_render_routes(jpipe) == (False, fused)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jtrainer.make_render_image_aux(jpipe)(jparams, jnp.asarray(K), jnp.asarray(pose), HW, HW)
    want_rgb = jtrainer.make_render_image(jpipe)(jparams, jnp.asarray(K), jnp.asarray(pose), HW, HW)
    cfg = NeRFPipelineConfig(model=_mcfg(jcfg), render=RenderConfig(**kw))
    assert use_fused_route(cfg) is fused
    pair = params_from_jax(params, cfg.model)
    launches = dict(tfr.LAUNCHES)
    got = make_render_image_aux(cfg)(pair, _t(K), _t(pose), HW, HW)
    got_rgb = make_render_image(cfg)(pair, _t(K), _t(pose), HW, HW)
    assert tfr.LAUNCHES == launches
    assert [tuple(t.shape) for t in got] == [(HW, HW, 3), (HW, HW), (HW, HW), (HW, HW)]
    rgb_tol, map_tol = (5e-3, 2e-2) if fused else (1e-5, 1e-4)
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb), rtol=0, atol=rgb_tol)
    # rgb alone drops the fine weights; the image is the same
    np.testing.assert_array_equal(got_rgb.numpy(), got[0].numpy())
    for name, a, b in zip(("rgb", "depth", "disp", "acc"), got, want):
        tol = rgb_tol if name == "rgb" else map_tol
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol, err_msg=name)
    assert got[3].max().item() > 0.05                 # the frame is not empty


def test_renderers_refuse_a_model_of_the_other_kind():
    jcfg, params, K, pose = _frame_case()
    mcfg = _mcfg(jcfg)
    flat = NeRFPipelineConfig(model=mcfg, render=RenderConfig(n_sample=16))
    hier = NeRFPipelineConfig(model=mcfg, render=RenderConfig(n_sample=16, n_importance=8))
    pair, one = params_from_jax(params, mcfg), params_from_jax(params["fine"], mcfg)
    for cfg, model in ((flat, pair), (hier, one)):
        for make in (make_render_image, make_render_image_aux):
            with pytest.raises(ValueError, match="n_importance"):
                make(cfg)(model, _t(K), _t(pose), HW, HW)
        with pytest.raises(ValueError, match="n_importance"):
            make_loss_fn(cfg, 4)(model, None, torch.zeros(1, HW, HW, 3), _t(pose)[None], _t(K),
                                 draws=tuple(torch.zeros(4, dtype=torch.long) for _ in range(3)))


# ---------------------------------------------------------------------------
# the pair: init, conversion, checkpoints both ways
# ---------------------------------------------------------------------------


def test_pair_init_is_seeded_and_its_networks_differ():
    mcfg = NeRFModelConfig(**MODEL)
    a, b, c = NeRFPair(mcfg, seed=3), NeRFPair(mcfg, seed=3), NeRFPair(mcfg, seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb) and not torch.equal(pa, pc), name
    for (name, pc_), pf in zip(a.coarse.named_parameters(), a.fine.parameters()):
        assert not torch.equal(pc_, pf), name
    assert {n.split(".")[0] for n, _ in a.named_parameters()} == {"coarse", "fine"}
    # the coarse network of a pair is the flat network of the same seed
    for p, q in zip(a.coarse.parameters(), NeRF(mcfg, seed=3).parameters()):
        assert torch.equal(p, q)
    tree = params_to_jax(a)
    assert set(tree) == {"coarse", "fine"} and tree["fine"]["fc1"]["w"].shape == (27, 32)
    back = params_from_jax(tree, mcfg)
    for p, q in zip(a.parameters(), back.parameters()):
        assert torch.equal(p, q)
    assert tckpt.infer_model_config(tree) == tckpt.infer_model_config(tree["coarse"]) == mcfg


def _hier_cfgs(tmp_path, **train):
    jcfg = JaxPipelineConfig(
        model=JaxModelConfig(**MODEL),
        render=JaxRenderConfig(n_sample=16, n_importance=8),
        train=JaxTrainConfig(n_rays_batch=32, lrate=5e-3, val_every=0),
        checkpoint_path=str(tmp_path))
    cfg = NeRFPipelineConfig(
        model=NeRFModelConfig(**MODEL),
        render=RenderConfig(n_sample=16, n_importance=8, use_fused_kernel=True),
        train=TrainConfig(n_rays_batch=32, lrate=5e-3, val_every=0, **train),
        checkpoint_path=str(tmp_path))
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (3, 12, 12, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 4.0
    K = _frame_case()[2]
    return jcfg, cfg, images, poses, K


def test_jax_resumes_a_port_pair_checkpoint(tmp_path):
    """The port trains a pair for three steps and saves; the file holds the
    JAX key layout, and the JAX trainer resumes params, Adam state and
    step from it."""
    jcfg, cfg, images, poses, K = _hier_cfgs(tmp_path, log_every=1, save_ckpt_iter=0)
    trainer = NeRFTrainer(cfg, images, poses, K, device="cpu")
    assert isinstance(trainer.model, NeRFPair)
    trainer.fit(max_iters=3, progress=False)
    path = str(tmp_path / "final_model.ckpt.npz")
    with np.load(path) as z:
        keys = set(z.files)
    assert {"params//d:coarse//d:fc1//d:w", "params//d:fine//d:rgb2//d:b",
            "opt//s:0//a:mu//d:coarse//d:fc1//d:w", "opt//s:0//a:nu//d:fine//d:skip//d:b",
            "opt//s:0//a:count", "opt//s:1//a:count", "step"} <= keys
    jt = jtrainer.NeRFTrainer(jcfg, images, poses, K)
    assert jt.try_resume() and jt.start_iter == 3
    want = params_to_jax(trainer.model)
    state = optimizer_state_to_jax(trainer.model, trainer.optimizer)
    assert state["count"] == 3 == int(jt.opt_state[0].count)
    for side in ("coarse", "fine"):
        for name in want[side]:
            for k in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(jt.params[side][name][k]),
                                              want[side][name][k])
                np.testing.assert_array_equal(np.asarray(jt.opt_state[0].mu[side][name][k]),
                                              state["mu"][side][name][k])
                np.testing.assert_array_equal(np.asarray(jt.opt_state[0].nu[side][name][k]),
                                              state["nu"][side][name][k])
    assert np.abs(state["nu"]["fine"]["fc1"]["w"]).max() > 0
    assert np.abs(state["nu"]["coarse"]["fc1"]["w"]).max() > 0


def test_port_resumes_a_jax_pair_checkpoint(tmp_path):
    """The JAX package saves a pair with its Adam state after updates; the
    port's trainer resumes all of it, and a flat trainer refuses the file
    with a message that names both kinds."""
    import optax

    jcfg, cfg, images, poses, K = _hier_cfgs(tmp_path)
    jt = jtrainer.NeRFTrainer(jcfg, images, poses, K)
    rng = np.random.default_rng(1)
    params, opt_state = jt.params, jt.opt_state
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 1e-2), params)
        updates, opt_state = jt.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    jckpt.save_checkpoint(str(tmp_path), 1, params, opt_state, extra={"loss": 0.5})
    trainer = NeRFTrainer(cfg, images, poses, K, device="cpu")
    assert trainer.try_resume() and trainer.start_iter == 2
    back = params_to_jax(trainer.model)
    state = optimizer_state_to_jax(trainer.model, trainer.optimizer)
    assert state["count"] == 2
    for side in ("coarse", "fine"):
        for name in back[side]:
            for k in ("w", "b"):
                np.testing.assert_array_equal(back[side][name][k],
                                              np.asarray(params[side][name][k]))
                np.testing.assert_array_equal(state["mu"][side][name][k],
                                              np.asarray(opt_state[0].mu[side][name][k]))
                np.testing.assert_array_equal(state["nu"][side][name][k],
                                              np.asarray(opt_state[0].nu[side][name][k]))
    flat = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, n_importance=0))
    with pytest.raises(ValueError, match="coarse/fine pair.*one network"):
        NeRFTrainer(flat, images, poses, K, device="cpu").try_resume()


def test_a_flat_checkpoint_under_a_hierarchical_run_raises(tmp_path):
    jcfg, cfg, images, poses, K = _hier_cfgs(tmp_path)
    flat = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, n_importance=0))
    NeRFTrainer(flat, images, poses, K, device="cpu").save(4, 0.0)
    with pytest.raises(ValueError, match="one network.*coarse/fine pair"):
        NeRFTrainer(cfg, images, poses, K, device="cpu").try_resume()
    with pytest.raises(ValueError, match="one network"):
        NeRFTrainer(cfg, images, poses, K, device="cpu").fit(max_iters=6, progress=False)


# ---------------------------------------------------------------------------
# the trainer and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", [dict(use_fused_kernel=True), dict(use_fused_kernel=False)])
def test_hierarchical_fit_lowers_the_loss(tmp_path, route):
    """tests/test_hierarchical.py:63 on both routes: the pair trains, the
    logged loss falls, validation renders through the hierarchical
    renderer, and a second trainer resumes the nested tree."""
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset

    root = make_blender_dataset(str(tmp_path / "d"), n_frames=3, height=16, width=16)
    images, poses, cam = load_blender_dataset(root, "train")
    cfg = NeRFPipelineConfig(
        model=NeRFModelConfig(hidden=32, n_pos_freq=3, n_dir_freq=1),
        render=RenderConfig(n_sample=16, n_importance=16, **route),
        train=TrainConfig(n_rays_batch=128, lrate=5e-3, log_every=5, val_every=50,
                          save_ckpt_iter=0, n_val_images=1),
        checkpoint_path=os.path.join(str(tmp_path), "ck"), load_checkpoint=False)
    trainer = NeRFTrainer(cfg, images, poses, cam.camera_matrix, device="cpu")
    stats = trainer.fit(max_iters=61, progress=False)
    losses = [v for _, v in trainer.loss_log]
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < 0.8 * losses[0], losses
    assert stats["steps"] == 61 and [it for it, _, _ in trainer.val_log] == [50]
    img = make_render_image(cfg)(trainer.model, trainer.K, trainer.poses[0], 16, 16)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    again = NeRFTrainer(cfg, images, poses, cam.camera_matrix, device="cpu")
    assert again.try_resume() and again.start_iter == 61
    for p, q in zip(trainer.model.parameters(), again.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("route", [[], ["--no_fused"]])
def test_cli_hierarchical_train_then_test_then_gif(tmp_path, route, capsys):
    """--n_importance through train (12 steps, a resume), test (with the
    maps) and gif (the pair's fine network, flat) on a 16x16 dataset; the
    JAX package reads the pair the CLI saved; test mode without the flag
    refuses the pair."""
    data = make_blender_dataset(str(tmp_path / "data" / "scene"), n_frames=6,
                                height=16, width=16) + "/"
    ck = str(tmp_path / "ckpt")
    model_flags = ["--hidden_size", "32", "--n_pos_freq", "4", "--n_dirc_freq", "2"]
    flags = ["--device", "cpu", "--data_path", data, "--checkpoint_path", ck,
             "--n_sample", "16", "--n_importance", "8", *model_flags, *route]
    train = [*flags, "--n_rays_batch", "64", "--lrate", "5e-3", "--log_every", "1",
             "--val_every", "10", "--save_ckpt_iter", "5", "--logs_path", str(tmp_path / "logs")]
    stats = main(["--mode", "train", "--max_iters", "12", *train])
    losses = [v for _, v in stats["losses"]]
    assert stats["steps"] == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert len(stats["val"]) == 5
    resumed = main(["--mode", "train", "--max_iters", "13", *train])
    assert resumed["start_iter"] == 11 and resumed["steps"] == 2
    params, step = jckpt.load_params_untyped(os.path.join(ck, "scene", "final_model.ckpt.npz"))
    assert step == 12 and set(params) == {"coarse", "fine"}
    assert params["fine"]["fc1"]["w"].shape == (27, 32)
    images_path = str(tmp_path / "img")
    records = main(["--mode", "test", *flags, "--images_path", images_path, "--save_depth"])
    assert len(records) == 5 and all(np.isfinite(r["mse"]) for r in records)
    assert len(os.listdir(os.path.join(images_path, "scene"))) == 30
    assert "PSNR" in capsys.readouterr().out
    with pytest.raises(ValueError, match="n_importance"):
        main(["--mode", "test", *[f for f in flags if f not in ("--n_importance", "8")],
              "--images_path", images_path])
    frames = main(["--mode", "gif", "--device", "cpu", "--data_path", data,
                   "--checkpoint_path", ck, "--images_path", str(tmp_path / "gif"),
                   "--n_frames", "2", "--n_sample", "16", "--no_perturb", *route])
    assert [os.path.basename(r["path"]) for r in frames] == ["image_1.png", "image_2.png"]
