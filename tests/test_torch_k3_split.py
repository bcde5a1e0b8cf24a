"""K3's backward (fused_render_train under a caller's cotangent g) as the
split step: the plain versions of the forward sweep, the reverse walk under
g and the weight GEMM, chained over ray groups, against the single-pass
plain version of the two-kernel route and against the JAX package's
fused_render_train in Pallas interpret mode; the reverse walk under the
MSE's cotangent given as g against the same walk making that cotangent
itself.  tests/test_torch_gpu.py holds the CUDA launches against these
plain versions on a card.

Sizes: a few rays in 2-3 ray groups, sample counts that are not multiples
of 128, hidden 32-64, both archs."""

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
from sfm_nerf_tpu_torch.models.convert import params_from_jax

INTERP = dict(ray_tile=16, sample_chunk=16, tiles_per_program=1, interpret=True)
# the JAX comparison's tolerance, as tests/test_torch_split_step.py:
# tests/test_fused_train.py:_assert_grads_close's rtol and atol of scale
GRAD_RTOL, GRAD_ATOL_SCALE = 5e-3, 5e-4
RGB_ATOL = 1e-5
# float64 plain versions that sum in other groupings: each grad tensor
# within this fraction of its norm
F64_REL = 1e-9

ARCHS = {
    "active": dict(arch="active", hidden=32, n_pos_freq=4, n_dir_freq=2),
    "legacy": dict(arch="legacy", hidden=48, n_pos_freq=4, n_dir_freq=2),
    "active64": dict(arch="active", hidden=64, n_pos_freq=5, n_dir_freq=3),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _setup(arch, n_rays, n_sample, seed, dtype=torch.float32, pack=torch.bfloat16):
    """JAX-initialised params, the port's packing of them, and seeded numpy
    rays, sorted depths, targets and a cotangent that is not the MSE's."""
    jcfg = JaxModelConfig(**ARCHS[arch])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    init_nerf_params(jax.random.key(seed), jcfg))
    model = params_from_jax(params, NeRFModelConfig(**dataclasses.asdict(jcfg)))
    packed = tfr.pack_nerf_params(model, model.cfg, pack)
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (n_rays, n_sample)), -1)
    target = rng.uniform(0, 1, (n_rays, 3))
    g = rng.normal(size=(n_rays, 3)) * 1e-2
    arrays = [a.astype(np.float32) for a in (o, d, z, target, g)]
    return jcfg, params, packed, arrays, [torch.from_numpy(a).to(dtype) for a in arrays]


def _rel(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


@pytest.mark.parametrize("arch,white,n_rays,n_sample,group", [
    ("active", False, 5, 150, 2), ("legacy", True, 4, 100, 2), ("active64", False, 6, 200, 3),
    ("active", True, 3, 64, 1)])
def test_split_chain_under_g_matches_two_kernel_plain_version(arch, white, n_rays, n_sample,
                                                              group):
    """split_step_reference under the caller's g, in ray groups, against
    fused_render_train_reference (forward: rgb and tb; backward: the grads
    under g) in float64: rgb to 1e-12, every grad tensor to F64_REL of its
    norm (the GEMM sums each layer's products over a group in one order,
    the single pass chunk by chunk); the split forward's tb is the forward
    kernel's."""
    _, _, packed, _, (o, d, z, _, g) = _setup(arch, n_rays, n_sample, seed=11,
                                              dtype=torch.float64)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    rr, tbr = tft.fused_render_train_reference(packed, o, d, z, rcfg)
    gwr, gbr = tft.fused_render_train_reference(packed, o, d, z, rcfg, g=g)
    rgb, w, gw, gb = tft.split_step_reference(packed, o, d, z, None, rcfg, group=group, g=g)
    assert gw.dtype == torch.float64 and w.shape == (n_rays, n_sample)
    assert (rgb - rr).abs().max().item() <= 1e-12
    _, tb, _, _ = tft.split_forward_reference(packed, o, d, z, rcfg)
    assert tb.shape == tbr.shape and (tb - tbr).abs().max().item() <= 1e-12
    got, want = tft.unpack_grads(packed, gw, gb), tft.unpack_grads(packed, gwr, gbr)
    for name in want:
        assert (got[name] - want[name]).norm().item() <= F64_REL * want[name].norm().item(), name


@pytest.mark.parametrize("arch,white,n_sample", [
    ("active", False, 64), ("legacy", True, 100), ("active64", False, 48)])
def test_split_chain_under_g_matches_jax_fused_render_train_vjp(arch, white, n_sample):
    """The chain under g against jax.vjp of JAX's fused_render_train (the
    forward and the recomputing backward kernel in interpret mode) with the
    same numpy g, in 2 ray groups: rgb to RGB_ATOL, every grad to the
    tolerance of tests/test_torch_split_step.py (the plain version differs
    from the interpret kernel by sin vs fast_sin and summation order; both
    pack float32).  The port runs in float64 on the float32 inputs: in
    float32 the plain version, single pass and split chain alike, lands one
    of the legacy case's 48 block2_1 bias grads 2.6% (1.2e-6) from the
    interpret kernel, which agrees with the float64 plain version to 3.3e-10
    on every element of that tensor.  The interpret kernel unrolls at most
    8 of its 16-sample chunks: 128 samples at most."""
    jcfg, params, _, (o, d, z, _, g), _ = _setup(arch, 4, n_sample, seed=12)
    jr = JaxRenderConfig(n_sample=n_sample, near=2.0, far=6.0, perturb=False,
                         white_background=white)
    args = [jnp.asarray(a) for a in (o, d, z)]

    def render(p):
        packed = jfr.pack_nerf_params(p, jcfg, jnp.float32)
        return jft.fused_render_train(packed, *args, jcfg, jr, **INTERP)

    rgb_j, vjp = jax.vjp(render, jax.tree_util.tree_map(jnp.asarray, params))
    (gj,) = vjp(jnp.asarray(g))
    model = params_from_jax(params, NeRFModelConfig(**dataclasses.asdict(jcfg)))
    packed = tfr.pack_nerf_params(model, model.cfg, torch.float32)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    tt = [torch.from_numpy(a).double() for a in (o, d, z, g)]
    rgb, _, gw, gb = tft.split_step_reference(packed, *tt[:3], None, rcfg, group=2, g=tt[3])
    assert gw.dtype == torch.float64
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=0, atol=RGB_ATOL)
    named = tft.unpack_grads(packed, gw, gb)
    for name, gl in gj.items():
        for k, suffix in (("w", "weight"), ("b", "bias")):
            a = np.asarray(gl[k])
            b = named[f"layers.{name}.{suffix}"].numpy()
            b = b.T if k == "w" else b
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("arch,white,n_rays,n_sample", [
    ("active", False, 5, 150), ("legacy", True, 4, 100), ("active64", True, 3, 130)])
def test_reverse_walk_under_mse_g_is_the_mse_walk(arch, white, n_rays, n_sample):
    """The plain reverse walk under g = (rgb - t) * gscale, g made outside
    it, equals the walk that makes that cotangent from (target, gscale),
    bit for bit (cotangent stash, bias and direction-row grads), and so do
    the chained backward and the whole split step: float32 and the bf16
    packing, as the card runs them."""
    _, _, packed, _, (o, d, z, t, _) = _setup(arch, n_rays, n_sample, seed=13)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    gscale = 2.0 / (3.0 * n_rays)
    rgb, tb, _, stash = tft.split_forward_reference(packed, o, d, z, rcfg)
    g = (rgb - t) * gscale
    mse = tft.split_reverse_reference(packed, d, z, rcfg, rgb, t, tb, stash, gscale)
    given = tft.split_reverse_reference(packed, d, z, rcfg, None, None, tb, stash, 0.0, g=g)
    assert all(torch.equal(a, b) for a, b in zip(mse, given))
    back = tft.split_backward_reference(packed, d, z, rcfg, rgb, t, tb, stash, gscale)
    back_g = tft.split_backward_reference(packed, d, z, rcfg, None, None, tb, stash, 0.0, g=g)
    assert all(torch.equal(a, b) for a, b in zip(back, back_g))
    step = tft.split_step_reference(packed, o, d, z, t, rcfg, group=2)
    step_g = tft.split_step_reference(packed, o, d, z, None, rcfg, group=2,
                                      g=(step[0] - t) * gscale)
    assert all(torch.equal(a, b) for a, b in zip(step, step_g))


@pytest.mark.parametrize("arch,white", [("active", True), ("legacy", False)])
def test_two_kernel_plain_version_tc_order_is_the_same_function(arch, white):
    """fused_render_train_reference with tc_order (products summed in the
    render kernel's order) computes the same function: in float64, rgb and
    tb to 1e-12 and every grad under g to F64_REL of its norm."""
    _, _, packed, _, (o, d, z, _, g) = _setup(arch, 3, 140, seed=14, dtype=torch.float64)
    rcfg = RenderConfig(n_sample=140, white_background=white)
    fwd = tft.fused_render_train_reference(packed, o, d, z, rcfg)
    fwd_t = tft.fused_render_train_reference(packed, o, d, z, rcfg, tc_order=True)
    for a, b in zip(fwd, fwd_t):
        assert (a - b).abs().max().item() <= 1e-12
    gw, gb = tft.fused_render_train_reference(packed, o, d, z, rcfg, g=g)
    gw_t, gb_t = tft.fused_render_train_reference(packed, o, d, z, rcfg, g=g, tc_order=True)
    assert _rel(gw_t, gw) <= F64_REL and _rel(gb_t, gb) <= F64_REL
