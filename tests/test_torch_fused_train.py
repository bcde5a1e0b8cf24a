"""The fused training step's plain versions (what the CUDA kernels compute)
against the JAX package's fused training kernels in Pallas interpret mode,
on the same numpy inputs; the hand-written reverse walk against autograd;
the packed-grad unpacking against autograd through a differentiable
packing.  tests/test_torch_gpu.py holds the CUDA kernels against the plain
versions on a card.

Sizes as tests/test_fused_train.py: hidden 32, 32 rays x 32 samples; the JAX
kernels run as their own tests run them (interpret, ray_tile 16,
sample_chunk 16, one tile per program)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.config import NeRFModelConfig as JaxModelConfig
from sfm_nerf_tpu.config import RenderConfig as JaxRenderConfig
from sfm_nerf_tpu.kernels import fused_render as jfr
from sfm_nerf_tpu.kernels import fused_train as jft
from sfm_nerf_tpu.models import init_nerf_params
from sfm_nerf_tpu_torch.config import NeRFModelConfig, RenderConfig
from sfm_nerf_tpu_torch.kernels import fused_render as tfr
from sfm_nerf_tpu_torch.kernels import fused_train as tft
from sfm_nerf_tpu_torch.models.convert import params_from_jax, params_to_jax
from sfm_nerf_tpu_torch.models.nerf import NeRF

INTERP = dict(ray_tile=16, sample_chunk=16, tiles_per_program=1, interpret=True)
# the tolerance of tests/test_fused_train.py:_assert_grads_close, which holds
# the JAX kernels to jax.grad of the XLA path: rtol 5e-3, atol 5e-4 of the
# tensor's largest value.  The plain version differs from the interpret
# kernel by sin vs fast_sin and by summation order only.
GRAD_RTOL, GRAD_ATOL_SCALE = 5e-3, 5e-4
LOSS_RTOL = 1e-4

ARCHS = {
    "active": dict(arch="active", hidden=32, n_pos_freq=4, n_dir_freq=2),
    "legacy": dict(arch="legacy", hidden=32, n_pos_freq=4, n_dir_freq=2),
    "nope": dict(arch="legacy", hidden=32, pos_encoding=False, has_skip=False,
                 n_block1_layers=4),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _setup(arch="active", n_rays=32, n_sample=32, seed=0):
    jcfg = JaxModelConfig(**ARCHS[arch])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    init_nerf_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # the deterministic 'train' depths: linspace(near, far, S)
    z = np.tile(np.linspace(2.0, 6.0, n_sample, dtype=np.float32), (n_rays, 1))
    target = rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)
    return jcfg, params, o, d, z, target


def _jax_merged(params, jcfg, white, o, d, z, target):
    rcfg = JaxRenderConfig(n_sample=z.shape[1], near=2.0, far=6.0, perturb=False,
                           white_background=white)

    def loss(p):
        packed = jfr.pack_nerf_params(p, jcfg, jnp.float32)
        return jft.fused_mse_loss(packed, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
                                  jnp.asarray(target), jcfg, rcfg, **INTERP)

    return jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))


def _port_model(params, jcfg):
    return params_from_jax(params, NeRFModelConfig(**dataclasses.asdict(jcfg)))


def _port_merged(params, jcfg, white, o, d, z, target, dtype=torch.float32):
    model = _port_model(params, jcfg)
    packed = tfr.pack_nerf_params(model, model.cfg, dtype)
    rcfg = RenderConfig(n_sample=z.shape[1], white_background=white)
    launches = dict(tft.LAUNCHES)
    loss = tft.fused_mse_loss(packed, *(torch.from_numpy(a) for a in (o, d, z, target)), rcfg)
    loss.backward()
    assert tft.LAUNCHES == launches          # CPU tensors never launch
    return float(loss.detach()), _grads_jax_layout(model)


def _grads_jax_layout(model):
    """The module's .grad in the JAX layout: w (fan_in, fan_out), b."""
    return {name: {"w": layer.weight.grad.numpy().T, "b": layer.bias.grad.numpy()}
            for name, layer in model.layers.items()}


def _assert_grads_close(g_jax, g_port, rtol=GRAD_RTOL, atol_scale=GRAD_ATOL_SCALE):
    assert set(g_jax) == set(g_port)
    for name in g_jax:
        for k in ("w", "b"):
            a, b = np.asarray(g_jax[name][k]), g_port[name][k]
            assert a.shape == b.shape, (name, k)
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol_scale * scale,
                                       err_msg=f"grad mismatch at {name}/{k}")


@pytest.mark.parametrize("arch,white,n_rays,n_sample,seed", [
    ("active", False, 32, 32, 0),     # test_fused_train.py:137, :144
    ("active", True, 32, 32, 0),      # :196 white background
    ("legacy", False, 32, 32, 0),     # :348 legacy arch
    ("nope", False, 32, 32, 1),       # :362 no positional encoding
    ("active", False, 24, 32, 0),     # :164 a ray count that fills no tile
    ("active", False, 32, 24, 0),     # :402 a sample count that fills no chunk
])
def test_plain_step_matches_jax_fused_mse_loss(arch, white, n_rays, n_sample, seed):
    jcfg, params, o, d, z, target = _setup(arch, n_rays, n_sample, seed)
    lj, gj = _jax_merged(params, jcfg, white, o, d, z, target)
    lt, gt = _port_merged(params, jcfg, white, o, d, z, target)
    np.testing.assert_allclose(lt, float(lj), rtol=LOSS_RTOL)
    _assert_grads_close(gj, gt)
    assert max(np.abs(g["w"]).max() for g in gt.values()) > 1e-6   # not all zero


def test_saturated_density_gives_finite_matching_grads():
    """test_fused_train.py:287: x = sigma * delta far past 23 must keep the
    sample's weight and give finite grads (one_m = exp(-x) + 1e-10, the
    exclusive transmittance as exp(csum + x))."""
    jcfg, params, o, d, z, target = _setup()
    params = dict(params)
    params["density"] = {"w": params["density"]["w"] * 0.0,
                         "b": params["density"]["b"] + 500.0}
    lj, gj = _jax_merged(params, jcfg, False, o, d, z, target)
    lt, gt = _port_merged(params, jcfg, False, o, d, z, target)
    np.testing.assert_allclose(lt, float(lj), rtol=LOSS_RTOL)
    assert all(np.isfinite(g[k]).all() for g in gt.values() for k in ("w", "b"))
    _assert_grads_close(gj, gt)


@pytest.mark.parametrize("arch,white", [("legacy", False), ("active", True)])
def test_plain_two_kernel_route_matches_jax_fused_render_train(arch, white):
    """test_fused_train.py:376, with a cotangent that is not the MSE's."""
    jcfg, params, o, d, z, target = _setup(arch, seed=2)
    jr = JaxRenderConfig(n_sample=32, near=2.0, far=6.0, perturb=False, white_background=white)

    def jax_loss(p):
        packed = jfr.pack_nerf_params(p, jcfg, jnp.float32)
        rgb = jft.fused_render_train(packed, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
                                     jcfg, jr, **INTERP)
        return jnp.sum(jnp.abs(rgb - target) ** 1.5)

    lj, gj = jax.value_and_grad(jax_loss)(jax.tree_util.tree_map(jnp.asarray, params))
    model = _port_model(params, jcfg)
    packed = tfr.pack_nerf_params(model, model.cfg, torch.float32)
    rgb = tft.fused_render_train(packed, torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(z), RenderConfig(n_sample=32,
                                                                   white_background=white))
    loss = torch.sum(torch.abs(rgb - torch.from_numpy(target)) ** 1.5)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(lj), rtol=LOSS_RTOL)
    _assert_grads_close(gj, _grads_jax_layout(model))


def _f64(packed):
    return dataclasses.replace(packed, weights=packed.weights.double().requires_grad_(),
                               biases=packed.biases.double().requires_grad_())


@pytest.mark.parametrize("arch,white,chunk", [
    ("active", False, 16), ("active", True, 128), ("legacy", True, 16), ("nope", False, 16)])
def test_reverse_walk_matches_autograd_in_float64(arch, white, chunk):
    """The hand-written reverse walk (40 samples in chunks of 16: the
    carries cross chunks) against torch.autograd through the plain forward,
    both in float64: 1e-9 of each grad buffer's norm."""
    jcfg, params, o, d, _, target = _setup(arch, n_rays=20, seed=3)
    z = np.sort(np.random.default_rng(3).uniform(2, 6, (20, 40)), -1)
    model = _port_model(params, jcfg)
    p64 = _f64(tfr.pack_nerf_params(model, model.cfg, torch.float32))
    rcfg = RenderConfig(n_sample=40, white_background=white)
    o, d, z, target = (torch.from_numpy(a).double() for a in (o, d, z, target))
    rgb = tfr.fused_render_rays_reference(p64, o, d, z, rcfg)
    torch.mean((rgb - target) ** 2).backward()
    rgb_w, gw, gb = tft.fused_mse_loss_reference(p64, o, d, z, target, rcfg, chunk=chunk)
    assert gw.dtype == torch.float64
    np.testing.assert_allclose(rgb_w.numpy(), rgb.detach().numpy(), rtol=0, atol=1e-12)
    for got, want in ((gw, p64.weights.grad), (gb, p64.biases.grad)):
        assert (got - want).norm().item() <= 1e-9 * want.norm().item()
    # the two-kernel route with an arbitrary cotangent
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(20, 3)))
    p64.weights.grad = p64.biases.grad = None
    rgb = tfr.fused_render_rays_reference(p64, o, d, z, rcfg)
    torch.sum(rgb * g).backward()
    gw3, gb3 = tft.fused_render_train_reference(p64, o, d, z, rcfg, g=g, chunk=chunk)
    for got, want in ((gw3, p64.weights.grad), (gb3, p64.biases.grad)):
        assert (got - want).norm().item() <= 1e-9 * want.norm().item()
    # the forward kernel's residual: the transmittance entering each chunk
    _, tb = tft.fused_render_train_reference(p64, o, d, z, rcfg, chunk=chunk)
    assert tb.shape == (20, -(-40 // chunk)) and bool((tb[:, 0] == 1).all())
    assert bool((tb[:, 1:] <= tb[:, :-1]).all())


@pytest.mark.parametrize("arch", ["active", "legacy", "nope"])
def test_unpack_grads_is_the_transpose_of_the_packing(arch):
    """Random cotangents on the packed buffers: autograd through the
    differentiable packing gives the parameters' grads; unpack_grads must
    give the same, exactly (both only move and add zeros)."""
    mcfg = NeRFModelConfig(**ARCHS[arch])
    model = NeRF(mcfg, seed=1)
    packed = tfr.pack_nerf_params(model, mcfg, torch.float32, differentiable=True)
    gen = torch.Generator().manual_seed(0)
    cw = torch.randn(packed.weights.shape, generator=gen)
    cb = torch.randn(packed.biases.shape, generator=gen)
    (torch.sum(packed.weights * cw) + torch.sum(packed.biases * cb)).backward()
    named = tft.unpack_grads(packed, cw, cb)
    assert set(named) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        want = p.grad if p.grad is not None else torch.zeros_like(p)   # legacy density_fc
        assert named[name].shape == p.shape, name
        assert torch.equal(named[name], want), name


def test_bf16_packing_keeps_the_grads_close():
    """The kernel's working type on the CPU: bf16-packed weights, rounded
    activations and cotangents.  Against the float32 packing each grad
    tensor moves by a few percent of its norm at most."""
    jcfg, params, o, d, z, target = _setup()
    l32, g32 = _port_merged(params, jcfg, False, o, d, z, target)
    l16, g16 = _port_merged(params, jcfg, False, o, d, z, target, torch.bfloat16)
    np.testing.assert_allclose(l16, l32, rtol=2e-2)
    for name in g32:
        for k in ("w", "b"):
            err = np.linalg.norm(g16[name][k] - g32[name][k])
            assert err <= 0.1 * np.linalg.norm(g32[name][k]) + 1e-9, (name, k)


# a mip packing as tests/test_torch_mip.py builds one: hidden 32, cones over
# S + 1 interval edges
MIP = dict(arch="mip", hidden=32, n_pos_freq=16, n_dir_freq=4, density_bias_init=-1.0)


def _cone_inputs(n_rays=16, n_sample=8, seed=0):
    """(origins, un-normalised directions, cones (radius, |d|), edges (N, S +
    1), target) of seeded rays at an 800-pixel camera's cone radius."""
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32))
    cones = torch.stack([torch.full((n_rays,), 1.2e-3),
                         torch.linalg.vector_norm(d, dim=-1)], -1)
    edges = torch.linspace(2.0, 6.0, n_sample + 1).expand(n_rays, -1).contiguous()
    target = torch.from_numpy(rng.uniform(0, 1, (n_rays, 3)).astype(np.float32))
    return o, d, cones, edges, target


def _step_grads(packed, o, d, cones, z, target, rcfg, weights):
    """(weights or None, gw, gb) of the ``*_grads`` entry that matches."""
    if cones is not None:
        _, w, gw, gb = tft.fused_mse_loss_cones_grads(packed, o, d, cones, z, target, rcfg,
                                                      emit_weights=weights)
    elif weights:
        _, w, gw, gb = tft.fused_mse_loss_weights_grads(packed, o, d, z, target, rcfg)
    else:
        (_, gw, gb), w = tft.fused_mse_loss_grads(packed, o, d, z, target, rcfg), None
    return w, gw, gb


@pytest.mark.parametrize("weights", [False, True], ids=["loss", "weights"])
@pytest.mark.parametrize("cones", [False, True], ids=["points", "cones"])
def test_backward_scales_by_the_incoming_cotangent(cones, weights):
    """Each of the four step entries on the CPU: 3 * loss backpropagates 3
    times the matching ``*_grads`` result into every parameter, the weights
    output is the plain version's and carries no grad, and the entry
    refuses the other kind of packing (_check_cones)."""
    jcfg, params, o, d, z, target = _setup()
    points_model = _port_model(params, jcfg)
    mip_model = NeRF(NeRFModelConfig(**MIP), seed=4)
    if cones:
        o, d, cone, z, target = _cone_inputs()
        rays = (o, d, cone, z)
    else:
        o, d, z, target = (torch.from_numpy(a) for a in (o, d, z, target))
        cone, rays = None, (o, d, z)
    model, other = (mip_model, points_model) if cones else (points_model, mip_model)
    packed = tfr.pack_nerf_params(model, model.cfg, torch.float32)
    rcfg = RenderConfig(n_sample=z.shape[1] - int(cones))
    entry = getattr(tft, "fused_mse_loss" + "_cones" * cones + "_weights" * weights)
    out = entry(packed, *rays, target, rcfg)
    loss, w = out if weights else (out, None)
    (3.0 * loss).backward()
    w_want, gw, gb = _step_grads(packed, o, d, cone, z, target, rcfg, weights)
    want = tft.unpack_grads(packed, gw, gb)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, 3.0 * want[name], rtol=1e-6, atol=0)
    assert max(float(g.abs().max()) for g in want.values()) > 1e-6   # not all zero
    if weights:
        _, w_ref, _, _ = tft.fused_mse_loss_weights_reference(packed, o, d, z, target, rcfg,
                                                              cones=cone)
        assert torch.equal(w, w_ref) and torch.equal(w_want, w_ref)
        assert w.shape == (o.shape[0], rcfg.n_sample) and not w.requires_grad
    else:
        assert w_want is None
    with pytest.raises(ValueError, match="the mip arch renders cones"):
        entry(tfr.pack_nerf_params(other, other.cfg, torch.float32), *rays, target, rcfg)


def test_legacy_compositor_raises():
    jcfg, params, o, d, z, target = _setup()
    model = _port_model(params, jcfg)
    packed = tfr.pack_nerf_params(model, model.cfg, torch.float32)
    args = [torch.from_numpy(a) for a in (o, d, z)]
    rcfg = RenderConfig(n_sample=32, variant="legacy")
    with pytest.raises(NotImplementedError):
        tft.fused_mse_loss(packed, *args, torch.from_numpy(target), rcfg)
    with pytest.raises(NotImplementedError):
        tft.fused_render_train(packed, *args, rcfg)


def test_params_round_trip_after_a_step_keeps_layout():
    """params_to_jax of a stepped model has the JAX package's shapes."""
    jcfg, params, *_ = _setup("legacy")
    back = params_to_jax(_port_model(params, jcfg))
    for name in params:
        assert back[name]["w"].shape == params[name]["w"].shape
