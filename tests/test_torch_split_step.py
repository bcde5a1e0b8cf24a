"""The split training step's plain versions (what the forward sweep with
its stash, the reverse walk to the cotangent stash and the weight GEMM
compute) chained over ray groups, against the single-pass plain version and
against the JAX package's fused training kernels in Pallas interpret mode;
the stash layout against the activations it holds.  tests/test_torch_gpu.py
holds the CUDA launches against these plain versions on a card.

Sizes: a few rays, 64-200 samples, hidden 32-64, both archs."""

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
# the JAX comparison's tolerance, as tests/test_torch_fused_train.py:
# tests/test_fused_train.py:_assert_grads_close's rtol and atol of scale
GRAD_RTOL, GRAD_ATOL_SCALE = 5e-3, 5e-4
LOSS_RTOL = 1e-4

ARCHS = {
    "active": dict(arch="active", hidden=32, n_pos_freq=4, n_dir_freq=2),
    "legacy": dict(arch="legacy", hidden=48, n_pos_freq=4, n_dir_freq=2),
    "active64": dict(arch="active", hidden=64, n_pos_freq=5, n_dir_freq=3),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _setup(arch, n_rays, n_sample, seed, dtype=torch.float32):
    """JAX-initialised params, the port's bf16 packing of them, and seeded
    numpy rays, sorted depths and targets."""
    jcfg = JaxModelConfig(**ARCHS[arch])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    init_nerf_params(jax.random.key(seed), jcfg))
    model = params_from_jax(params, NeRFModelConfig(**dataclasses.asdict(jcfg)))
    packed = tfr.pack_nerf_params(model, model.cfg, torch.bfloat16)
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (n_rays, n_sample)), -1)
    target = rng.uniform(0, 1, (n_rays, 3))
    arrays = [a.astype(np.float32) for a in (o, d, z, target)]
    return jcfg, params, packed, arrays, [torch.from_numpy(a).to(dtype) for a in arrays]


def _rel(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


@pytest.mark.parametrize("arch,white,n_rays,n_sample", [
    ("active", False, 4, 150), ("legacy", True, 3, 100), ("active64", False, 3, 64)])
def test_tc_order_plain_version_is_the_same_function(arch, white, n_rays, n_sample):
    """The plain version with tc_order (products summed as the render
    kernel's wgmma chain sums them: from the bias, 16 rows of K at a time;
    the density and rgb heads' bias last; the direction head one row at a
    time) computes the plain version's function: in float64, where the two
    orders round alike, rgb and weights to 1e-12 and every grad to 1e-10
    of its norm."""
    _, _, packed, _, (o, d, z, t) = _setup(arch, n_rays, n_sample, seed=7,
                                           dtype=torch.float64)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    rgb, w, gw, gb = tft.fused_mse_loss_weights_reference(packed, o, d, z, t, rcfg)
    rgb_t, w_t, gw_t, gb_t = tft.fused_mse_loss_weights_reference(packed, o, d, z, t, rcfg,
                                                                  tc_order=True)
    assert (rgb_t - rgb).abs().max().item() <= 1e-12
    assert (w_t - w).abs().max().item() <= 1e-12
    got, want = tft.unpack_grads(packed, gw_t, gb_t), tft.unpack_grads(packed, gw, gb)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-10, k


@pytest.mark.parametrize("arch,white,n_rays,n_sample,dtype,tol", [
    ("active", False, 5, 200, torch.float32, 1e-5),
    ("active", True, 3, 64, torch.float32, 1e-5),
    ("legacy", False, 4, 130, torch.float32, 1e-5),
    ("legacy", True, 3, 100, torch.float64, 1e-10),
    ("active64", False, 3, 128, torch.float64, 1e-10),
])
def test_split_chain_matches_single_pass_plain_version(arch, white, n_rays, n_sample, dtype, tol):
    """Forward-with-stash -> reverse walk to the cotangent stash -> weight
    GEMM, chained, against fused_mse_loss_weights_reference and
    fused_mse_loss_reference on the same inputs: rgb, loss and weights to
    1e-6; every parameter's grad to ``tol`` of its norm (the GEMM sums each
    layer's products in one order, the single pass chunk by chunk)."""
    _, _, packed, _, (o, d, z, t) = _setup(arch, n_rays, n_sample, seed=1, dtype=dtype)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    rr, wr, gwr, gbr = tft.fused_mse_loss_weights_reference(packed, o, d, z, t, rcfg)
    rgb, w, gw, gb = tft.split_step_reference(packed, o, d, z, t, rcfg)
    assert gw.dtype == dtype
    assert (rgb - rr).abs().max().item() <= 1e-6
    assert (w - wr).abs().max().item() <= 1e-6
    loss, loss_r = torch.mean((rgb - t) ** 2).item(), torch.mean((rr - t) ** 2).item()
    assert abs(loss - loss_r) <= 1e-6 * loss_r
    got, want = tft.unpack_grads(packed, gw, gb), tft.unpack_grads(packed, gwr, gbr)
    for name in want:
        assert (got[name] - want[name]).norm().item() <= tol * want[name].norm().item(), name
    r2, gw2, gb2 = tft.fused_mse_loss_reference(packed, o, d, z, t, rcfg)
    assert torch.equal(r2, rr) and torch.equal(gw2, gwr) and torch.equal(gb2, gbr)


@pytest.mark.parametrize("arch,white,n_sample", [
    ("active", False, 64), ("active", True, 100), ("legacy", False, 128)])
def test_split_chain_matches_jax_fused_step(arch, white, n_sample):
    """The chain against JAX's fused_mse_loss_weights (loss, weights,
    grads) and fused_mse_loss (loss) in interpret mode: the tolerance of
    tests/test_torch_fused_train.py (the plain version differs from the
    interpret kernel by sin vs fast_sin, bf16 vs f32 packing of the port's
    kernel dtype aside, and summation order).  The interpret kernel unrolls
    at most 8 of its 16-sample chunks: 128 samples at most."""
    jcfg, params, _, (o, d, z, t), _ = _setup(arch, 4, n_sample, seed=2)
    jr = JaxRenderConfig(n_sample=n_sample, near=2.0, far=6.0, perturb=False,
                         white_background=white)
    args = [jnp.asarray(a) for a in (o, d, z, t)]

    def loss_w(p):
        packed = jfr.pack_nerf_params(p, jcfg, jnp.float32)
        return jft.fused_mse_loss_weights(packed, *args, jcfg, jr, **INTERP)

    def loss(p):
        packed = jfr.pack_nerf_params(p, jcfg, jnp.float32)
        return jft.fused_mse_loss(packed, *args, jcfg, jr, **INTERP)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (lj, wj), gj = jax.value_and_grad(loss_w, has_aux=True)(jp)
    lj2 = loss(jp)
    model = params_from_jax(params, NeRFModelConfig(**dataclasses.asdict(jcfg)))
    packed = tfr.pack_nerf_params(model, model.cfg, torch.float32)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    tt = [torch.from_numpy(a) for a in (o, d, z, t)]
    rgb, w, gw, gb = tft.split_step_reference(packed, *tt, rcfg, group=3)
    lt = torch.mean((rgb - tt[3]) ** 2).item()
    np.testing.assert_allclose(lt, float(lj), rtol=LOSS_RTOL)
    np.testing.assert_allclose(lt, float(lj2), rtol=LOSS_RTOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj)[:, :n_sample], rtol=0, atol=1e-4)
    named = tft.unpack_grads(packed, gw, gb)
    for name, g in gj.items():
        for k, suffix in (("w", "weight"), ("b", "bias")):
            a = np.asarray(g[k])
            b = named[f"layers.{name}.{suffix}"].numpy()
            b = b.T if k == "w" else b
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("arch,n_sample", [("active", 200), ("legacy", 64), ("active64", 130)])
def test_stash_layout_round_trips_to_every_layer_activation(arch, n_sample):
    """The forward stash, read back through the layout (from_image), holds
    every layer input of every sample: the encoding and each layer's
    output, recomputed here from the packed weights with the kernels'
    rounding, and the per-point density and colours; rows past S are zero;
    to_image o from_image is the identity on any rows."""
    n_rays = 3
    _, _, packed, _, (o, d, z, t) = _setup(arch, n_rays, n_sample, seed=3)
    rcfg = RenderConfig(n_sample=n_sample)
    lay = tft.stash_layout(packed)
    _, tb, _, stash = tft.split_forward_reference(packed, o, d, z, rcfg)
    per_ray = 2 * -(-n_sample // 128)
    assert stash["act"].shape == (n_rays * per_ray, lay.rec_act)
    assert tb.shape == (n_rays, per_ray // 2) and bool((tb[:, 0] == 1).all())
    assert lay.rec_act == (lay.enc_kb + (len(packed.layers) - 1) * lay.act_kb) * tft.IMG_BLOCK
    # recompute the chain for every point: rows ray-major, sample within
    rnd = lambda x: x.bfloat16().float()
    W = {s.name: packed.w(s).float() for s in packed.layers}
    B = {s.name: packed.b(s).float() for s in packed.layers}
    h = packed.hidden
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    ext = rnd(tfr._ext(pts, packed.n_pos_freq, packed.pos_pad))
    outs = [rnd(torch.relu(ext @ W["fc1"] + B["fc1"]))]
    for s in packed.layers[1:-3]:
        inp = torch.cat([outs[-1], ext], -1) if s.kind == "skip" else outs[-1]
        outs.append(rnd(torch.relu(inp @ W[s.name] + B[s.name])))
    df = outs[-1] @ W["densfeat"] + B["densfeat"]
    outs.append(rnd(torch.relu(df[:, :h])))
    extd = rnd(tfr._ext(d, packed.n_dir_freq, packed.dir_dim))
    dirp = (extd @ W["rgb1"][h:]).repeat_interleave(n_sample, 0)
    outs.append(rnd(torch.relu(outs[-1] @ W["rgb1"][:h] + dirp + B["rgb1"])))
    rows = torch.arange(n_rays)[:, None] * per_ray * 64 + torch.arange(n_sample)[None, :]
    rows = rows.reshape(-1)
    pad = torch.ones(n_rays * per_ray * 64, dtype=torch.bool)
    pad[rows] = False
    for block, want in [(0, ext)] + [(lay.slot_block(j), x) for j, x in enumerate(outs)]:
        got = tft.from_image(stash["act"], block, want.shape[1]).float()
        torch.testing.assert_close(got[rows], want, rtol=0, atol=2 ** -7 * want.abs().max())
        assert bool((got[pad] == 0).all())
    assert len(outs) == len(packed.layers) - 1
    dens = stash["pt"][rows, 0]
    assert bool(torch.isfinite(stash["pt"]).all()) and bool((stash["pt"][pad] == 0).all())
    assert dens.shape == (n_rays * n_sample,)
    # the swizzle: a bijection onto each block, the render kernel's pattern
    idx = tft.image_index(3 * 64)
    assert sorted(idx.reshape(-1).tolist()) == list(range(3 * tft.IMG_BLOCK))
    r, c = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    assert torch.equal(idx[:, :64], torch.from_numpy(tfr.swizzle128(r.numpy(), c.numpy())))
    x = torch.randn(5 * 64, 100).bfloat16()
    recs = torch.zeros(5, 2 * tft.IMG_BLOCK, dtype=torch.bfloat16)
    tft.to_image(recs, 0, x)
    assert torch.equal(tft.from_image(recs, 0, 100), x)


@pytest.mark.parametrize("white", [False, True])
def test_ray_groups_give_the_same_grads(white):
    """Groups of 1, 2, 3 and all 5 rays: rgb and weights identical, grads
    within float32 rounding of one another (each group's sums are added in
    group order)."""
    _, _, packed, _, (o, d, z, t) = _setup("active", 5, 96, seed=4)
    rcfg = RenderConfig(n_sample=96, white_background=white)
    base = tft.split_step_reference(packed, o, d, z, t, rcfg, group=5)
    for group in (1, 2, 3):
        rgb, w, gw, gb = tft.split_step_reference(packed, o, d, z, t, rcfg, group=group)
        assert torch.equal(rgb, base[0]) and torch.equal(w, base[1])
        assert _rel(gw, base[2]) <= 1e-6 and _rel(gb, base[3]) <= 1e-6


def test_weight_gemm_plain_version_is_each_layers_product():
    """grad_gemm_reference on random stashes: layer l's rows are A_l^T D_l
    with A_l read from the right slots (the skip layer's and fc1's
    encoding rows included), rgb1's direction rows zero; gemm_tasks covers
    every other weight element exactly once."""
    _, _, packed, _, _ = _setup("active", 1, 64, seed=5)
    lay = tft.stash_layout(packed)
    gen = torch.Generator().manual_seed(0)
    n_rec = 3
    act = torch.randn(n_rec, lay.rec_act, generator=gen).bfloat16()
    cot = torch.randn(n_rec, lay.rec_cot, generator=gen).bfloat16()
    gw = tft.grad_gemm_reference(packed, act, cot)
    h = packed.hidden
    enc = tft.from_image(act, 0, packed.pos_pad).float()
    for li, s in enumerate(packed.layers):
        D = tft.from_image(cot, lay.cot_off[li], s.n).float()
        if s.kind == "fc1":
            A = enc
        else:
            k = packed.hidden if s.kind == "skip" else s.k
            prev = tft.from_image(act, lay.slot_block(li - 1), k).float()
            A = torch.cat([prev, enc], 1) if s.kind == "skip" else prev
        got = gw[s.w_off:s.w_off + s.k_rows * s.n].view(s.k_rows, s.n)
        torch.testing.assert_close(got[:A.shape[1]], A.t() @ D, rtol=1e-5, atol=1e-4)
        if s.kind == "rgb1":
            assert bool((got[h:] == 0).all())
    cover = torch.zeros(packed.weights.numel(), dtype=torch.int64)
    for w_off, n, n0, ncols, _, _, n_tiles, *tiles in tft.gemm_tasks(packed):
        for k0, k_rows, _ in (tiles[:3], tiles[3:])[:n_tiles]:
            for k in range(k0, k0 + k_rows):
                cover[w_off + k * n + n0:w_off + k * n + n0 + ncols] += 1
    rgb1 = {s.name: s for s in packed.layers}["rgb1"]
    dir_rows = slice(rgb1.w_off + h * rgb1.n, rgb1.w_off + rgb1.k_rows * rgb1.n)
    assert bool((cover[dir_rows] == 0).all())
    cover[dir_rows] = 1
    assert bool((cover == 1).all())


@pytest.mark.parametrize("mcfg", [
    dict(arch="active"), dict(arch="legacy", hidden=48, n_pos_freq=5, n_dir_freq=3),
    dict(arch="active", hidden=32, n_pos_freq=4, n_dir_freq=2),
    dict(arch="active", hidden=192, pos_encoding=False)], ids=["active", "legacy48", "active32",
                                                                "active192_nope"])
def test_walk_plan_reads_back_every_transposed_weight_once(mcfg):
    """The reverse walk's ring slots (walk_plan), read MN-major from the
    render tile image as the kernel's wgmma reads them (row kk of a piece:
    weight column k0 + kk, its 16-byte chunk c at c ^ (kk % 8)), give W^T of
    every layer but fc1 over the rows the cotangent reaches (the previous
    output: the skip layer's encoding rows and rgb1's direction rows left
    out), each element exactly once, zeros past the real rows; the slots run
    from the last layer to the second, each layer's columns in order;
    _walk_ints is the stash layout then the slots."""
    from sfm_nerf_tpu_torch.models.nerf import NeRF

    cfg = NeRFModelConfig(**mcfg)
    packed = tfr.pack_nerf_params(NeRF(cfg, device="cpu", seed=2), cfg, torch.bfloat16)
    plan = tfr.render_plan(packed)
    index = tfr._image_index(packed, plan)
    image = tfr.render_tile_image(packed)
    stages = tft.walk_plan(packed)
    h, nl = packed.hidden, len(packed.layers)
    assert [s.layer for s in stages] == sorted((s.layer for s in stages), reverse=True)
    assert {s.layer for s in stages} == set(range(1, nl))
    cover = np.zeros(packed.weights.numel(), np.int64)
    for li in range(1, nl):
        spec = packed.layers[li]
        rows = tfr.RGB_HIDDEN if spec.kind == "rgb2" else h
        mine = [s for s in stages if s.layer == li]
        assert [s.k0 for s in mine] == list(np.cumsum([0] + [s.kc for s in mine[:-1]]))
        assert sum(s.kc for s in mine) == spec.n
        wt = torch.zeros(spec.n, 64 * len(mine[0].offs), dtype=packed.weights.dtype)
        for s in mine:
            assert s.k0 % 16 == 0 and s.kc % 16 == 0 and s.kc <= tfr.TILE_K
            assert len(s.offs) == -(-rows // tfr.TILE_K)
            # the pass's tiles side by side: the kernel takes the first offset and a stride
            assert s.offs == tuple(s.offs[0] + p * (s.offs[-1] - s.offs[0]) // max(1, len(s.offs) - 1)
                                   for p in range(len(s.offs)))
            kk, mm = np.meshgrid(np.arange(s.kc), np.arange(64), indexing="ij")
            for p, off in enumerate(s.offs):
                el = off + tfr.swizzle128(kk, mm)
                want = np.where(64 * p + mm < rows,
                                spec.w_off + (64 * p + mm) * spec.n + s.k0 + kk, -1)
                assert np.array_equal(index[el], want), (spec.name, s.k0, p)
                np.add.at(cover, index[el][index[el] >= 0], 1)
                wt[s.k0:s.k0 + s.kc, 64 * p:64 * p + 64] = image[torch.from_numpy(el)]
        assert torch.equal(wt[:, :rows], packed.w(spec)[:rows].t())
        assert bool((wt[:, rows:] == 0).all())
    for spec in packed.layers:
        rows = (0 if spec.kind == "fc1" else tfr.RGB_HIDDEN if spec.kind == "rgb2" else h)
        block = cover[spec.w_off:spec.w_off + spec.k_rows * spec.n].reshape(spec.k_rows, spec.n)
        assert (block[:rows] == 1).all() and (block[rows:] == 0).all(), spec.name
    ints = list(tft._walk_ints(packed))
    lay = tft.stash_layout(packed).ints()
    assert ints[:len(lay)] == lay and ints[len(lay)] == len(stages)
    assert len(ints) == len(lay) + 1 + 8 * len(stages) and len(stages) <= 160
