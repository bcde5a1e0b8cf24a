"""The fused render's plain version (what the CUDA kernel computes) against
the JAX package's fused render kernels in Pallas interpret mode, on the
same numpy inputs.  tests/test_torch_gpu.py holds the CUDA kernel against
the plain version on a card."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.config import NeRFModelConfig as JaxModelConfig
from sfm_nerf_tpu.config import RenderConfig as JaxRenderConfig
from sfm_nerf_tpu.kernels import fused_render as jfr
from sfm_nerf_tpu.models import init_nerf_params
from sfm_nerf_tpu_torch.config import NeRFModelConfig, RenderConfig
from sfm_nerf_tpu_torch.kernels import fused_render as tfr
from sfm_nerf_tpu_torch.models.convert import params_from_jax
from sfm_nerf_tpu_torch.models.nerf import NeRF
from sfm_nerf_tpu_torch.train import checkpoint as ckpt

SYNTH800 = os.path.join(os.path.dirname(__file__), "..", "Phase2", "checkpoints",
                        "synth800", "final_model.ckpt.npz")
# measured: JAX interpret-f32 vs its XLA composite is 5.6e-6 ('train') and
# 7.9e-6 ('legacy') on synth800; the plain version differs from the
# interpret kernel by fast_sin vs sin and by summation order
ATOL_F32 = 5e-5
# bf16 packing: the same rounding points, but a sum that lands near a bf16
# rounding boundary may round the other way on one side
ATOL_BF16 = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _case(name):
    if name == "synth800":
        params = _f32(ckpt.load_params_untyped(SYNTH800)[0])
        return params, ckpt.infer_model_config(params)
    kw = {"active": dict(arch="active", hidden=64, n_pos_freq=6, n_dir_freq=3),
          "legacy": dict(arch="legacy", hidden=48, n_block1_layers=2),
          "nope": dict(arch="legacy", hidden=32, pos_encoding=False,
                       has_skip=False, n_block1_layers=5)}[name]
    jcfg = JaxModelConfig(density_bias_init=0.5, **kw)
    params = _f32(init_nerf_params(jax.random.key(len(name)), jcfg))
    return params, NeRFModelConfig(**dataclasses.asdict(jcfg))


def _rays(n, s, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] -= 4.0
    d = (rng.normal(size=(n, 3)) * 0.3 + [0, 0, 1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), -1).astype(np.float32)
    return o, d, z


def _jax_fused(params, mcfg, o, d, z, rcfg_kw, jdtype):
    jcfg = JaxModelConfig(**dataclasses.asdict(mcfg))
    packed = jfr.pack_nerf_params(jax.tree_util.tree_map(jnp.asarray, params), jcfg, jdtype)
    return jfr.fused_render_rays_weights(
        packed, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z), jcfg,
        JaxRenderConfig(n_sample=z.shape[1], **rcfg_kw),
        ray_tile=32, sample_chunk=16, tiles_per_program=1, interpret=True)


def _port(params, mcfg, o, d, z, rcfg_kw, dtype):
    packed = tfr.pack_nerf_params(params_from_jax(params, mcfg), mcfg, dtype)
    rcfg = RenderConfig(n_sample=z.shape[1], **rcfg_kw)
    args = (packed, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(z), rcfg)
    rgb = tfr.fused_render_rays(*args)
    rgb_w, w = tfr.fused_render_rays_weights(*args)
    np.testing.assert_array_equal(rgb.numpy(), rgb_w.numpy())
    return rgb.numpy(), w.numpy()


@pytest.mark.parametrize("name,variant,white,n,s", [
    ("synth800", "train", False, 37, 40),     # ragged rays, S not a chunk multiple
    ("synth800", "legacy", False, 32, 48),
    ("synth800", "train", True, 33, 24),
    ("active", "legacy", False, 40, 40),
    ("legacy", "train", False, 32, 40),
    ("legacy", "legacy", False, 35, 32),
    ("nope", "legacy", False, 32, 40),
    ("nope", "train", True, 32, 40),
])
def test_plain_version_matches_jax_interpret(name, variant, white, n, s):
    params, mcfg = _case(name)
    o, d, z = _rays(n, s, seed=n)
    kw = dict(variant=variant, white_background=white, perturb=False)
    rj, wj = _jax_fused(params, mcfg, o, d, z, kw, jnp.float32)
    launches = dict(tfr.LAUNCHES)
    rt, wt = _port(params, mcfg, o, d, z, kw, torch.float32)
    assert tfr.LAUNCHES == launches        # CPU tensors never launch
    assert rt.shape == (n, 3) and wt.shape == (n, s)
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(wt, np.asarray(wj), rtol=0, atol=ATOL_F32)
    assert np.abs(wt).max() > 1e-3         # the scene is not empty


def test_plain_version_bf16_matches_jax_bf16():
    params, mcfg = _case("synth800")
    o, d, z = _rays(32, 40, seed=5)
    kw = dict(variant="train", perturb=False)
    rj, wj = _jax_fused(params, mcfg, o, d, z, kw, jnp.bfloat16)
    rt, wt = _port(params, mcfg, o, d, z, kw, torch.bfloat16)
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=0, atol=ATOL_BF16)
    np.testing.assert_allclose(wt, np.asarray(wj), rtol=0, atol=ATOL_BF16)


def test_chunk_carry_spans_chunks():
    """300 samples run as 128 + 128 + 44: the carried transmittance gives
    the one-pass composite."""
    from sfm_nerf_tpu_torch.ops.render import composite

    params, mcfg = _case("active")
    model = params_from_jax(params, mcfg)
    o, d, z = _rays(8, 300, seed=3)
    rcfg = RenderConfig(n_sample=300, perturb=False)
    packed = tfr.pack_nerf_params(model, mcfg, torch.float32)
    rgb, w = tfr.fused_render_rays_weights(packed, torch.from_numpy(o), torch.from_numpy(d),
                                           torch.from_numpy(z), rcfg)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    pts = ot[:, None] + dt[:, None] * torch.from_numpy(z)[..., None]
    with torch.no_grad():
        dens, col = model(pts, dt[:, None].expand(pts.shape))
    expected, w_exp, _ = composite(dens, col, torch.from_numpy(z), rcfg)
    np.testing.assert_allclose(rgb.numpy(), expected.numpy(), rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(w.numpy(), w_exp.numpy(), rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("weights", [False, True], ids=["rgb", "weights"])
@pytest.mark.parametrize("cones", [False, True], ids=["points", "cones"])
def test_render_entries_are_the_plain_version(cones, weights):
    """Each of the four render entries on CPU tensors is the plain version
    with the matching flags (rgb, or rgb and weights; cones and edges for a
    mip packing) and launches nothing; given the other kind of packing it
    refuses (_check_cones)."""
    params, mcfg = _case("active")
    points = tfr.pack_nerf_params(params_from_jax(params, mcfg), mcfg, torch.float32)
    mip_cfg = NeRFModelConfig(arch="mip", hidden=32, n_pos_freq=16, n_dir_freq=4,
                              density_bias_init=0.5)
    mip = tfr.pack_nerf_params(NeRF(mip_cfg, seed=3), mip_cfg, torch.float32)
    o, d, z = (torch.from_numpy(a) for a in _rays(12, 24, seed=11))
    if cones:
        d = d * torch.linspace(0.5, 2.0, 12)[:, None]       # un-normalised
        cone = torch.stack([torch.full((12,), 1.2e-3), torch.linalg.vector_norm(d, dim=-1)], -1)
        packed, other, rays = mip, points, (o, d, cone, z)
    else:
        cone, packed, other, rays = None, points, mip, (o, d, z)
    rcfg = RenderConfig(n_sample=z.shape[1] - int(cones), perturb=False)
    entry = getattr(tfr, "fused_render_" + ("cones" if cones else "rays") + "_weights" * weights)
    launches = dict(tfr.LAUNCHES)
    got = entry(packed, *rays, rcfg)
    want = tfr.fused_render_rays_reference(packed, o, d, z, rcfg, emit_weights=weights,
                                           cones=cone)
    assert tfr.LAUNCHES == launches
    got, want = (got, want) if weights else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape == (12, 3) and float(got[0].std()) > 0
    with pytest.raises(ValueError, match="the mip arch renders cones"):
        entry(other, *rays, rcfg)


def test_legacy_white_background_raises():
    params, mcfg = _case("legacy")
    packed = tfr.pack_nerf_params(params_from_jax(params, mcfg), mcfg)
    o, d, z = _rays(4, 8)
    with pytest.raises(NotImplementedError):
        tfr.fused_render_rays(packed, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(z),
                              RenderConfig(n_sample=8, variant="legacy",
                                           white_background=True))


def test_plain_version_runs_in_float64_on_float64_rays():
    """Float64 rays give a float64 plain version (chip_smoke.py measures the
    function's own float32-vs-float64 spread with it); the two agree."""
    params, mcfg = _case("active")
    packed = tfr.pack_nerf_params(params_from_jax(params, mcfg), mcfg, torch.float32)
    o, d, z = (torch.from_numpy(a) for a in _rays(16, 150, seed=7))
    rcfg = RenderConfig(n_sample=150, perturb=False)
    rgb, w = tfr.fused_render_rays_reference(packed, o, d, z, rcfg, emit_weights=True)
    rgb64, w64 = tfr.fused_render_rays_reference(packed, o.double(), d.double(), z.double(),
                                                 rcfg, emit_weights=True)
    assert rgb64.dtype == w64.dtype == torch.float64
    np.testing.assert_allclose(rgb64.numpy(), rgb.numpy(), rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(w64.numpy(), w.numpy(), rtol=0, atol=ATOL_F32)
