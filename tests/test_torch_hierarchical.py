"""Hierarchical sampling in the port against the JAX package on the CPU:
``sample_pdf``, ``merge_sorted`` and the four ``render_rays_hierarchical``
renderers over ``nn.Module``s, on numpy inputs made from a seed and fed to
both packages.

Sizes: hidden 32, 16-32 rays, 16-64 samples, 8-48 importance samples.  The
JAX ``sample_pdf`` draws its jitter from a key; the same key gives the test
the same uniform numbers, which go to the port as ``u``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.config import NeRFModelConfig as JaxModelConfig
from sfm_nerf_tpu.config import RenderConfig as JaxRenderConfig
from sfm_nerf_tpu.models import init_nerf_params, nerf_apply
from sfm_nerf_tpu.ops import render as jrender
from sfm_nerf_tpu_torch.config import NeRFModelConfig, RenderConfig
from sfm_nerf_tpu_torch.models.convert import params_from_jax
from sfm_nerf_tpu_torch.ops.render import (
    merge_sorted, render_rays_hierarchical, render_rays_hierarchical_aux,
    render_rays_hierarchical_chunked, render_rays_hierarchical_chunked_aux, sample_pdf,
)

MODEL = dict(hidden=32, n_pos_freq=4, n_dir_freq=2)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _histogram(n, s, seed, lo, hi, floor):
    """Sorted depths in [lo, hi], their midpoints, and weights over the
    interior bins in [floor, 1] with a fifth of the bins exactly empty."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(lo, hi, (n, s)), -1).astype(np.float32)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = rng.uniform(floor, 1, (n, s - 2)) * (rng.random((n, s - 2)) > 0.2)
    return bins, w.astype(np.float32)


def _jax_u(key, n, ni):
    """The uniform numbers sample_pdf draws from ``key``."""
    return np.asarray(jax.random.uniform(key, (n, ni), dtype=jnp.float32))


# The two packages sum the cdf in other orders (XLA's cumsum is not torch's),
# which moves it by 1-3e-7; the inverse-CDF step divides that by the bin's
# pdf and multiplies by its width.  On unit-range bins with weights of one
# order of magnitude that stays under 1e-6 (measured: 1.2e-7 to 5.7e-7); at
# scene depths (2..6) and weights down to 1e-3 of the largest it reaches 1e-5,
# in either package against a float64 oracle just as between the two.
@pytest.mark.parametrize("n,s,ni,keyed,lo,hi,floor,atol", [
    (32, 64, 48, True, 0.0, 1.0, 0.25, 1e-6),
    (16, 32, 16, True, 0.0, 1.0, 0.25, 1e-6),
    (8, 16, 32, False, 0.0, 1.0, 0.25, 1e-6),      # deterministic mode
    (16, 16, 8, False, 0.0, 1.0, 0.25, 1e-6),
    (16, 128, 128, True, 2.0, 6.0, 1e-3, 5e-5),    # the full-size histogram
    (8, 32, 16, False, 2.0, 6.0, 1e-3, 5e-5),
])
def test_sample_pdf_matches_jax(n, s, ni, keyed, lo, hi, floor, atol):
    bins, w = _histogram(n, s, seed=s + ni, lo=lo, hi=hi, floor=floor)
    key = jax.random.key(3) if keyed else None
    want = np.asarray(jrender.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), ni))
    u = _t(_jax_u(key, n, ni)) if keyed else None
    got = sample_pdf(_t(bins), _t(w), ni, u=u).numpy()
    assert got.shape == (n, ni) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert (np.diff(got, axis=-1) >= 0).all()


def test_sample_pdf_matches_a_float64_oracle():
    """searchsorted(side='right') + gather in numpy float64 from the same u:
    the port's float32 result lies as close to it as float32 allows."""
    n, s, ni = 16, 64, 48
    bins, w = _histogram(n, s, seed=1, lo=2.0, hi=6.0, floor=0.25)
    r = np.random.default_rng(2).uniform(size=(n, ni)).astype(np.float32)
    got = sample_pdf(_t(bins), _t(w), ni, u=_t(r)).numpy()
    w64 = w.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((n, 1)), np.cumsum(w64 / w64.sum(-1, keepdims=True), -1)], -1)
    u = (np.arange(ni) + r.astype(np.float64)) / ni
    want = np.empty((n, ni))
    for i in range(n):
        idx = np.searchsorted(cdf[i], u[i], side="right")
        below, above = np.clip(idx - 1, 0, s - 2), np.clip(idx, 0, s - 2)
        denom = cdf[i, above] - cdf[i, below]
        denom = np.where(denom < 1e-5, 1.0, denom)
        t = (u[i] - cdf[i, below]) / denom
        want[i] = bins[i, below] + t * (bins[i, above] - bins[i, below])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_sample_pdf_concentrates_on_peak():
    """tests/test_hierarchical.py:15."""
    n, s = 8, 64
    bins = np.tile(np.linspace(2.0, 6.0, s - 1, dtype=np.float32), (n, 1))
    w = np.full((n, s - 2), 1e-4, np.float32)
    w[:, 30:34] = 10.0                       # sharp peak near z ~ 4
    z = sample_pdf(_t(bins), _t(w), 128, torch.Generator().manual_seed(0)).numpy()
    assert z.shape == (n, 128)
    assert ((z > 3.7) & (z < 4.4)).mean() > 0.9
    want = np.asarray(jrender.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 128))
    got = sample_pdf(_t(bins), _t(w), 128).numpy()
    assert abs(((got > 3.7) & (got < 4.4)).mean() - ((want > 3.7) & (want < 4.4)).mean()) < 0.01


def test_sample_pdf_deterministic_mode():
    """tests/test_hierarchical.py:26: linspace(0, 1 - 1e-5) draws, monotone,
    inside the bins; the same call twice gives the same numbers."""
    bins = np.linspace(0.0, 1.0, 9, dtype=np.float32)[None]
    w = np.ones((1, 7), np.float32)
    z = sample_pdf(_t(bins), _t(w), 16).numpy()
    assert (np.diff(z[0]) >= -1e-6).all()
    assert z.min() >= 0.0 and z.max() <= 1.0
    np.testing.assert_array_equal(z, sample_pdf(_t(bins), _t(w), 16).numpy())
    want = np.asarray(jrender.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 16))
    np.testing.assert_allclose(z, want, rtol=0, atol=1e-6)
    # one importance sample: u = 0
    one = sample_pdf(_t(bins), _t(w), 1).numpy()
    want1 = np.asarray(jrender.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 1))
    np.testing.assert_allclose(one, want1, rtol=0, atol=1e-6)


def test_sample_pdf_output_sorted():
    """tests/test_hierarchical.py:98: the stratified draw makes the output
    non-decreasing per ray, which merge_sorted's callers rely on."""
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(2, 6, (16, 64)), axis=-1).astype(np.float32)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = (rng.uniform(0, 1, (16, 62)) * (rng.random((16, 62)) > 0.3)).astype(np.float32)
    for seed in range(3):
        out = sample_pdf(_t(bins), _t(w), 96, torch.Generator().manual_seed(seed)).numpy()
        assert (np.diff(out, axis=-1) >= 0).all()
        assert out.min() >= bins.min() and out.max() <= bins.max()


def test_sample_pdf_draw_past_the_cdf_clamps_to_the_last_bin():
    """A float32 cumsum may end a hair under 1 and a jitter near 1 then lies
    past it: ``above`` is the last bin, never an index past it, and the
    depth stays inside the bins.  Bins one longer or shorter than the cdf
    are aligned to it (cut, or the last edge repeated)."""
    n, s, ni = 4, 16, 8
    bins, w = _histogram(n, s, seed=0, lo=2.0, hi=6.0, floor=0.25)
    u = np.full((n, ni), np.nextafter(np.float32(1), np.float32(0)), np.float32)
    for b in (bins, bins[:, :-1], np.concatenate([bins, bins[:, -1:] + 1], -1)):
        out = sample_pdf(_t(b), _t(w), ni, u=_t(u)).numpy()
        assert np.isfinite(out).all()
        assert (out >= bins[:, :1]).all() and (out <= bins[:, -1:] + 1e-6).all()
        # the last slot's draw is (ni - 1 + u) / ni, next to 1: the top bin
        assert (out[:, -1] >= bins[:, -2]).all()
        want = np.asarray(jrender.sample_pdf(None, jnp.asarray(b), jnp.asarray(w), ni))
        got = sample_pdf(_t(b), _t(w), ni).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_sample_pdf_draws_from_its_generator_after_the_depths():
    """One generator: the same seed gives the same depths, another seed
    others; ``u`` given, the generator is not touched."""
    bins, w = _histogram(8, 32, seed=4, lo=2.0, hi=6.0, floor=0.25)
    a = sample_pdf(_t(bins), _t(w), 16, torch.Generator().manual_seed(5))
    b = sample_pdf(_t(bins), _t(w), 16, torch.Generator().manual_seed(5))
    c = sample_pdf(_t(bins), _t(w), 16, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    sample_pdf(_t(bins), _t(w), 16, gen, u=torch.rand(8, 16))
    assert torch.equal(gen.get_state(), before)


@pytest.mark.parametrize("n,a_w,b_w", [(8, 256, 128), (4, 64, 64), (3, 16, 5), (2, 1, 1),
                                       (5, 31, 97)])
def test_merge_sorted_matches_sort(n, a_w, b_w):
    """tests/test_hierarchical.py:110: equal to np.sort of the concatenation
    and to the JAX bitonic merge, exactly; unions that are no power of two
    and values that tie included.  Ties are kept, not merged."""
    rng = np.random.default_rng(11 + a_w)
    a = np.sort(rng.uniform(0, 10, (n, a_w)), -1).astype(np.float32)
    b = np.sort(np.round(rng.uniform(0, 10, (n, b_w)), 1), -1).astype(np.float32)
    b[:, 0] = a[:, 0]                        # a value present in both
    b = np.sort(b, -1)
    got = merge_sorted(_t(a), _t(b)).numpy()
    assert got.shape == (n, a_w + b_w)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b], -1), -1))
    np.testing.assert_array_equal(
        got, np.asarray(jrender.merge_sorted(jnp.asarray(a), jnp.asarray(b))))
    assert ((got == a[:, :1]).sum(-1) >= 2).all()


# ---------------------------------------------------------------------------
# the nn.Module renderers
# ---------------------------------------------------------------------------


def _scene(n_rays, seed):
    jcfg = JaxModelConfig(density_bias_init=0.5, **MODEL)
    pc, pf = (jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                     init_nerf_params(jax.random.key(seed + i), jcfg))
              for i in range(2))
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n_rays, 3)).astype(np.float32)
    o[:, 2] -= 4.0
    d = (rng.normal(size=(n_rays, 3)) * 0.3 + [0, 0, 1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jcfg, pc, pf, o, d


def _jax_fns(jcfg, pc, pf):
    pc, pf = (jax.tree_util.tree_map(jnp.asarray, p) for p in (pc, pf))
    return (lambda p, dd: nerf_apply(pc, p, dd, jcfg)), (lambda p, dd: nerf_apply(pf, p, dd, jcfg))


def _port_models(jcfg, pc, pf):
    mcfg = NeRFModelConfig(**dataclasses.asdict(jcfg))
    return params_from_jax(pc, mcfg), params_from_jax(pf, mcfg)


@pytest.mark.parametrize("variant,white,n_sample,n_imp", [
    ("train", False, 32, 16), ("train", True, 16, 8), ("legacy", False, 24, 12)])
def test_render_rays_hierarchical_matches_jax(variant, white, n_sample, n_imp):
    """No jitter (no key, no generator), converted params: the fine and the
    coarse rgb agree to 1e-5."""
    jcfg, pc, pf, o, d = _scene(24, seed=n_sample)
    kw = dict(n_sample=n_sample, near=2.0, far=6.0, variant=variant, white_background=white)
    jf, jc = jax.jit(lambda oo, dd: jrender.render_rays_hierarchical(
        *_jax_fns(jcfg, pc, pf), oo, dd, JaxRenderConfig(**kw), n_imp))(
            jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        tf, tc = render_rays_hierarchical(*_port_models(jcfg, pc, pf), _t(o), _t(d),
                                          RenderConfig(**kw), n_imp)
    assert tf.shape == tc.shape == (24, 3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    assert np.abs(tf.numpy() - tc.numpy()).max() > 1e-4      # two different networks


@pytest.mark.parametrize("chunked", [False, True])
def test_render_rays_hierarchical_aux_matches_jax(chunked):
    """(rgb, depth, disp, acc) of the fine pass, whole and in ray chunks (50
    rays in chunks of 16: a ragged last chunk): rgb 1e-5, maps 1e-4."""
    jcfg, pc, pf, o, d = _scene(50, seed=7)
    kw = dict(n_sample=16, near=2.0, far=6.0)
    jargs = (*_jax_fns(jcfg, pc, pf), jnp.asarray(o), jnp.asarray(d), JaxRenderConfig(**kw), 8)
    jit = lambda fn, *rest: jax.jit(lambda: fn(*jargs, *rest))()
    targs = (*_port_models(jcfg, pc, pf), _t(o), _t(d), RenderConfig(**kw), 8)
    with torch.no_grad():
        if chunked:
            want = jit(jrender.render_rays_hierarchical_chunked_aux, None, 16)
            got = render_rays_hierarchical_chunked_aux(*targs, None, 16)
            rgb_only = render_rays_hierarchical_chunked(*targs, None, 16)
            want_rgb = jit(jrender.render_rays_hierarchical_chunked, None, 16)
            np.testing.assert_allclose(rgb_only.numpy(), np.asarray(want_rgb), rtol=0, atol=1e-5)
            # chunking changes nothing: every ray is rendered on its own
            whole = render_rays_hierarchical_aux(*targs)
            for a, b in zip(got, whole):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
        else:
            want = jit(jrender.render_rays_hierarchical_aux)
            got = render_rays_hierarchical_aux(*targs)
    assert [tuple(t.shape) for t in got] == [(50, 3), (50,), (50,), (50,)]
    for name, a, b, atol in zip(("rgb", "depth", "disp", "acc"), got, want,
                                (1e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol, err_msg=name)
    assert got[3].min().item() >= 0 and got[3].max().item() <= 1 + 1e-5


def test_given_jitter_matches_jax_stage_by_stage():
    """With the depth jitter ``u`` and the importance jitter ``u_pdf`` given,
    the port's two-pass render equals the JAX functions composed on the same
    numbers (stratified_samples takes no given jitter there, so its depths
    come from the port): 1e-5."""
    from sfm_nerf_tpu_torch.ops.render import stratified_samples

    jcfg, pc, pf, o, d = _scene(16, seed=9)
    kw = dict(n_sample=16, near=2.0, far=6.0)
    rcfg, jr = RenderConfig(**kw), JaxRenderConfig(**kw)
    key = jax.random.key(4)
    rng = np.random.default_rng(9)
    u = rng.uniform(size=(16, 16)).astype(np.float32)
    u_pdf = _jax_u(key, 16, 8)
    with torch.no_grad():
        tf, tc = render_rays_hierarchical(*_port_models(jcfg, pc, pf), _t(o), _t(d), rcfg, 8,
                                          u=_t(u), u_pdf=_t(u_pdf))
    z = jnp.asarray(stratified_samples(16, rcfg, u=_t(u)).numpy())
    cf, ff = _jax_fns(jcfg, pc, pf)
    oj, dj = jnp.asarray(o), jnp.asarray(d)

    def run(fn, zz):
        pts = oj[:, None, :] + dj[:, None, :] * zz[..., None]
        return jrender.composite(*fn(pts, jnp.broadcast_to(dj[:, None, :], pts.shape)), zz, jr)

    @jax.jit
    def two_pass(z):
        out_c, w, _ = run(cf, z)
        z_fine = jrender.sample_pdf(key, 0.5 * (z[..., 1:] + z[..., :-1]), w[..., 1:-1], 8)
        return out_c, run(ff, jrender.merge_sorted(z, z_fine))[0]

    out_c, out_f = two_pass(z)
    np.testing.assert_allclose(tc.numpy(), np.asarray(out_c), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(out_f), rtol=0, atol=1e-5)


def test_coarse_weights_are_detached():
    """The coarse network learns from its own MSE only: under the summed
    loss its grads equal those of the coarse MSE alone, and the fine
    network's those of the fine MSE alone."""
    jcfg, pc, pf, o, d = _scene(16, seed=5)
    rcfg = RenderConfig(n_sample=16, near=2.0, far=6.0)
    target = _t(np.random.default_rng(5).uniform(0, 1, (16, 3)).astype(np.float32))

    def grads(which):
        coarse, fine = _port_models(jcfg, pc, pf)
        rgb_f, rgb_c = render_rays_hierarchical(coarse, fine, _t(o), _t(d), rcfg, 8)
        mse_f, mse_c = ((rgb_f - target) ** 2).mean(), ((rgb_c - target) ** 2).mean()
        {"sum": mse_f + mse_c, "coarse": mse_c, "fine": mse_f}[which].backward()
        return coarse, fine

    both_c, both_f = grads("sum")
    only_c, untouched_f = grads("coarse")
    untouched_c, only_f = grads("fine")
    for (name, p), q in zip(both_c.named_parameters(), only_c.parameters()):
        if p.grad is None:                    # legacy density_fc only
            continue
        assert torch.equal(p.grad, q.grad), name
    for (name, p), q in zip(both_f.named_parameters(), only_f.parameters()):
        assert torch.equal(p.grad, q.grad), name
    assert all(p.grad is None for p in untouched_f.parameters())
    assert all(p.grad is None for p in untouched_c.parameters())
    assert max(p.grad.abs().max().item() for p in both_c.parameters()) > 0


def test_fine_pass_sees_a_thin_shell():
    """tests/test_hierarchical.py:34: a density shell thinner than the coarse
    spacing gets many more fine samples than coarse ones."""
    rcfg = RenderConfig(n_sample=32, near=2.0, far=6.0, perturb=False)
    hits = {}

    def model(tag):
        def fn(pts, dirs):
            r = torch.linalg.norm(pts, dim=-1)
            hits[tag] = int((torch.abs(r - 4.0) < 0.03).sum())
            return 50.0 * torch.exp(-((r - 4.0) / 0.02) ** 2)[..., None], torch.full_like(pts, 0.5)
        return fn

    o = torch.zeros(16, 3)
    d = torch.zeros(16, 3)
    d[:, 2] = 1.0
    out_f, _ = render_rays_hierarchical(model("coarse"), model("fine"), o, d, rcfg, 64,
                                        torch.Generator().manual_seed(1))
    assert out_f.shape == (16, 3) and bool(torch.isfinite(out_f).all())
    assert hits["fine"] > hits["coarse"] * 2, hits
