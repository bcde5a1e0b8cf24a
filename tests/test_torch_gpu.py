"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports torch and the port only (no jax), so it runs on a machine without
JAX.  There, run it without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Without a card every test here skips.
"""

import json
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
    'synth800_nope') or of a seeded model ('legacy', 'hidden64',
    'hidden48', 'legacy48')."""
    from sfm_nerf_tpu_torch.config import NeRFModelConfig
    from sfm_nerf_tpu_torch.models.nerf import NeRF

    if name.startswith("synth800"):
        params, _ = ckpt.load_params_untyped(os.path.join(CKPTS, name, "final_model.ckpt.npz"))
        mcfg = ckpt.infer_model_config(params)
        return fr.pack_nerf_params(params_from_jax(params, mcfg, "cuda"), mcfg, torch.bfloat16)
    mcfg = {"legacy": NeRFModelConfig(arch="legacy"),
            "hidden64": NeRFModelConfig(hidden=64, n_pos_freq=6, n_dir_freq=2),
            "hidden48": NeRFModelConfig(hidden=48, n_pos_freq=5, n_dir_freq=3),
            "legacy48": NeRFModelConfig(arch="legacy", hidden=48, n_pos_freq=5,
                                        n_dir_freq=3)}[name]
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


def _assert_grads_close(packed, got, ref, f64, tc=None):
    """Per parameter: the kernel's grad within 2e-2 of the plain version's
    norm and 5e-2 of its largest value, or within the plain version's own
    float32-vs-float64 spread where that is larger (bf16 rounding flips of
    activations and cotangents move both the same way).

    ``tc``: the plain version's grads with its forward summed in the split
    step's order (tc_order).  A grad may meet the rule against those in
    place of the default order's: on a badly conditioned batch the
    rounding flips between the two summation orders move the lowest
    layers' grads by as much as float64 does, and the split step lands
    with the order it sums in.  Returns the worst parameter's name and its
    distances, as fractions of the norm: the kernel's from the default
    order's grads and from tc's, tc's from the default order's, float64's
    from the default order's."""
    got = ft.unpack_grads(packed, *got)
    f64 = ft.unpack_grads(packed, *(t.float() for t in f64))
    refs = [ft.unpack_grads(packed, *r) for r in ((ref,) if tc is None else (ref, tc))]

    def within(k, r):
        nr, mr = r[k].norm().item(), r[k].abs().max().item()
        if nr == 0.0:
            return got[k].abs().max().item() == 0.0
        e, e64 = got[k] - r[k], f64[k] - r[k]
        return (e.norm().item() / nr <= max(2e-2, e64.norm().item() / nr)
                and e.abs().max().item() / mr <= max(5e-2, e64.abs().max().item() / mr))

    def figures(k):
        def rel(a, b):
            return (a[k] - b[k]).norm().item() / max(b[k].norm().item(), 1e-30)
        out = {"vs_plain": rel(got, refs[0]), "f64_spread": rel(f64, refs[0])}
        if tc is not None:
            out.update(vs_tc=rel(got, refs[1]), tc_vs_plain=rel(refs[1], refs[0]))
        return out

    for k in refs[0]:
        assert any(within(k, r) for r in refs), (k, figures(k))
    worst = max(refs[0], key=lambda k: figures(k)["vs_plain"] / max(2e-2, figures(k)["f64_spread"]))
    return worst, figures(worst)


@pytest.mark.gpu
@pytest.mark.parametrize("white,n_rays,n_sample", [
    (False, 1024, 256), (True, 777, 200), (False, 100, 64), (False, 300, 384)])
def test_fused_train_kernels_match_plain_versions(white, n_rays, n_sample):
    """K2 (fused_mse_loss: the split step) and K3 (fused_render_train
    forward and backward) at hidden 256 against their plain versions on the
    same inputs; ragged sample counts and ray counts that fill no block
    included.  The split step's forward sweep and K3's forward are the
    render kernel's arithmetic: their rgb is K1's and K3's tb the sweep's,
    bit for bit; K3's backward is the split step under the caller's
    cotangent, so under the MSE's it gives K2's grads bit for bit."""
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
    # K2 twice: bit-equal
    rgb, gw, gb = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    rgb_b, gw_b, gb_b = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    assert ft.LAUNCHES["fused_mse_loss"] == before["fused_mse_loss"] + 2
    assert torch.equal(gw, gw_b) and torch.equal(gb, gb_b) and torch.equal(rgb, rgb_b)
    rr, gwr, gbr = ft.fused_mse_loss_reference(packed, o, d, z, target, rcfg)
    _, gw64, gb64 = ft.fused_mse_loss_reference(packed, o.double(), d.double(), z.double(),
                                                target.double(), rcfg)
    _, gwt, gbt = ft.fused_mse_loss_reference(packed, o, d, z, target, rcfg, tc_order=True)
    assert (rgb - rr).abs().max().item() <= 1e-2
    assert bool(torch.isfinite(gw).all()) and bool(torch.isfinite(gb).all())
    worst = _assert_grads_close(packed, (gw, gb), (gwr, gbr), (gw64, gb64), tc=(gwt, gbt))
    print(json.dumps({"k2_grads": [white, n_rays, n_sample], "worst": worst}))
    # K3's forward: rgb K1's, tb the split step's forward sweep's
    rgb3, tb = ft.fused_render_train_forward(packed, o, d, z, rcfg)
    k1 = fr.fused_render_rays(packed, o, d, z, rcfg)
    assert torch.equal(rgb, k1) and torch.equal(rgb3, k1)
    nc = -(-n_sample // fr.CHUNK)
    lay = ft.stash_layout(packed)
    act = torch.empty(n_rays * 2 * nc, lay.rec_act, device="cuda", dtype=torch.bfloat16)
    pt = torch.empty(n_rays * 2 * nc * ft.IMG_ROWS, 4, device="cuda")
    srgb, stb = torch.empty_like(rgb3), torch.empty_like(tb)
    ft._split_forward(packed, rcfg, o, d, z, srgb, None, stb, act, pt)
    assert torch.equal(tb, stb) and torch.equal(rgb3, srgb)
    del act, pt
    rr3, tbr = ft.fused_render_train_reference(packed, o, d, z, rcfg)
    assert (rgb3 - rr3).abs().max().item() <= 1e-2
    assert (tb - tbr).abs().max().item() <= 1e-2
    # K3's backward under the MSE's cotangent is K2, bit for bit
    gm = (rgb3 - target) * (2.0 / (3.0 * n_rays))
    gw3m, gb3m = ft.fused_render_train_backward(packed, o, d, z, rcfg, tb, gm)
    assert torch.equal(gw, gw3m) and torch.equal(gb, gb3m)
    # K3's backward with a cotangent that is not the MSE's: twice bit-equal,
    # under the grads rule of the plain version in either summation order
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(n_rays, 3))
                         .astype(np.float32)).cuda() * 1e-3
    gw3, gb3 = ft.fused_render_train_backward(packed, o, d, z, rcfg, tb, g)
    gw3b, gb3b = ft.fused_render_train_backward(packed, o, d, z, rcfg, tb, g)
    assert torch.equal(gw3, gw3b) and torch.equal(gb3, gb3b)
    assert ft.LAUNCHES["fused_render_train"] == before["fused_render_train"] + 1
    assert ft.LAUNCHES["fused_render_train_backward"] == \
        before["fused_render_train_backward"] + 3
    assert ft.LAUNCHES["fused_mse_loss"] == before["fused_mse_loss"] + 2
    ref3 = ft.fused_render_train_reference(packed, o, d, z, rcfg, g=g)
    ref3_64 = ft.fused_render_train_reference(packed, o.double(), d.double(), z.double(),
                                              rcfg, g=g.double())
    ref3_tc = ft.fused_render_train_reference(packed, o, d, z, rcfg, g=g, tc_order=True)
    worst = _assert_grads_close(packed, (gw3, gb3), ref3, ref3_64, tc=ref3_tc)
    print(json.dumps({"k3_grads": [white, n_rays, n_sample], "worst": worst}))


@pytest.mark.gpu
@pytest.mark.parametrize("white,n_rays,n_sample", [
    (False, 1024, 256), (True, 777, 200), (False, 300, 384)])
def test_fused_mse_loss_weights_kernel_matches_plain_version(white, n_rays, n_sample):
    """K4 (fused_mse_loss_weights): rgb and grads bit-equal to K2's on the
    same inputs, bit-equal across two runs, the weights within the weight
    rule of the plain version's and bit-equal to the render kernel's (K5:
    the split step's forward sweep is its arithmetic); a ragged last chunk
    writes the caller's S columns only."""
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
    assert torch.equal(rgb, rgb5) and torch.equal(w, w5)
    assert (rgb - rr).abs().max().item() <= 1e-2
    assert (w - wr).abs().max().item() <= w_tol
    assert ((w - wr).abs() > 1e-3).float().mean().item() <= 1e-4
    assert (w.sum(-1) - wr.sum(-1)).abs().max().item() <= 1e-2
    _, _, gwt, gbt = ft.fused_mse_loss_weights_reference(packed, o, d, z, target, rcfg,
                                                         tc_order=True)
    worst = _assert_grads_close(packed, (gw, gb), (gwr, gbr), (gw64, gb64), tc=(gwt, gbt))
    print(json.dumps({"k4_grads": [white, n_rays, n_sample], "worst": worst}))


@pytest.mark.gpu
@pytest.mark.parametrize("model,n_rec", [
    ("synth800", 1000), ("synth800", 3), ("hidden64", 257), ("legacy", 130)])
def test_weight_grad_gemm_matches_plain_version(model, n_rec):
    """The weight-gradient GEMM alone (grad_gemm.cu) on random stashes
    against its plain version: the f32 sums of A^T D over every record,
    within 1e-5 of each layer's norm (the two sum in other orders), twice
    bit-equal.  Everything outside the images' real rows and columns is
    NaN, so a value the GEMM must discard that reached a grad would show;
    3 records give fewer points than one block takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    packed = _packed_model(model)
    lay = ft.stash_layout(packed)
    gen = torch.Generator(device="cuda").manual_seed(n_rec)
    act = torch.full((n_rec, lay.rec_act), float("nan"), device="cuda", dtype=torch.bfloat16)
    cot = torch.full((n_rec, lay.rec_cot), float("nan"), device="cuda", dtype=torch.bfloat16)
    rows = n_rec * ft.IMG_ROWS
    widths = [(0, packed.pos_pad)] + [
        (lay.slot_block(j), ft.RGB_HIDDEN if s.kind == "rgb1" else packed.hidden)
        for j, s in enumerate(packed.layers[:-1])]
    for block, width in widths:
        ft.to_image(act, block, torch.randn(rows, width, device="cuda", generator=gen).relu())
    for i, s in enumerate(packed.layers):
        ft.to_image(cot, lay.cot_off[i], torch.randn(rows, s.n, device="cuda", generator=gen))
    gw, again = (torch.zeros(packed.weights.numel(), device="cuda") for _ in range(2))
    ft._weight_grad(packed, act, cot, n_rec, gw)
    ft._weight_grad(packed, act, cot, n_rec, again)
    ref = ft.grad_gemm_reference(packed, act, cot)
    assert torch.equal(gw, again)
    assert bool(torch.isfinite(gw).all())
    for s in packed.layers:
        sl = slice(s.w_off, s.w_off + s.k_rows * s.n)
        err = (gw[sl] - ref[sl]).norm().item()
        assert err <= 1e-5 * ref[sl].norm().item(), s.name


@pytest.mark.gpu
@pytest.mark.parametrize("model,n_rays,n_sample", [
    pytest.param("synth800", 300, 384, id="300-384"),
    pytest.param("synth800", 1024, 256, id="1024-256"),
    pytest.param("hidden48", 300, 384, id="hidden48-300-384")])
def test_split_backward_on_the_plain_forward_stash(model, n_rays, n_sample):
    """The split step's two halves apart, on the batches of the K4 test
    and on a hidden-48 net (the walk's narrowest slices, a ragged last ray
    pair).

    Backward: the reverse walk and the weight GEMM on the card, fed the
    plain version's forward (split_forward_reference: its rgb, tb and stash
    in the kernels' layout), give the plain version's grads, and fed the
    card's own forward sweep they give split_backward_reference's float64
    grads on that same stash: every parameter's grad within 1e-3 of the
    reference's norm both ways; a second run is bit-equal.

    Forward: the card's stash against the plain one, layer input by layer
    input: the encoding bit-equal; each layer's outputs within 1e-3 of
    their norm, at most 6e-3 of them unequal and 5e-5 of them zero in one
    and not the other (bf16 rounding flips where the wgmma chain sums in
    another order, carried down the layers); the density within 1e-3 of
    its norm.  The figures are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    packed = _packed_model(model)
    o, d, z, target = _train_batch(n_rays, n_sample, seed=n_sample + 1)
    rcfg = RenderConfig(n_sample=n_sample)
    gscale = 2.0 / (3.0 * n_rays)
    n_w = packed.weights.numel()

    def close(grads, ref):
        got, want = ft.unpack_grads(packed, grads[:n_w], grads[n_w:]), ft.unpack_grads(packed, *ref)
        errs = {k: (got[k] - want[k]).norm().item() / want[k].norm().item()
                for k in want if want[k].norm().item() > 0}
        assert max(errs.values()) <= 1e-3, errs
        return max(errs.values())

    rr, gwr, gbr = ft.fused_mse_loss_reference(packed, o, d, z, target, rcfg)
    rgb, tb, _, stash = ft.split_forward_reference(packed, o, d, z, rcfg)
    assert torch.equal(rgb, rr)
    grads = torch.zeros(n_w + packed.biases.numel(), device="cuda")
    ft._split_backward(packed, rcfg, o, d, z, target, rgb, tb, stash["act"], stash["pt"],
                       gscale, grads)
    figures = {"on_plain_stash": close(grads, (gwr, gbr))}
    # the card's forward sweep, its backward, and the float64 plain backward on its stash
    act, pt = torch.empty_like(stash["act"]), torch.empty_like(stash["pt"])
    krgb, ktb = torch.empty_like(rgb), torch.empty_like(tb)
    ft._split_forward(packed, rcfg, o, d, z, krgb, None, ktb, act, pt)
    assert torch.equal(krgb, fr.fused_render_rays(packed, o, d, z, rcfg))
    grads.zero_()
    ft._split_backward(packed, rcfg, o, d, z, target, krgb, ktb, act, pt, gscale, grads)
    ref64 = ft.split_backward_reference(packed, d, z, rcfg, krgb.double(), target, ktb.double(),
                                        {"act": act, "pt": pt.double()}, gscale)
    figures["on_own_stash_vs_f64"] = close(grads, [t.float() for t in ref64])
    again = torch.zeros_like(grads)
    ft._split_backward(packed, rcfg, o, d, z, target, krgb, ktb, act, pt, gscale, again)
    assert torch.equal(grads, again)
    lay = ft.stash_layout(packed)
    rows = ft._points(n_rays, n_sample, 0, 0, n_sample, "cuda")
    widths = [("encoding", 0, packed.pos_pad)] + [
        (s.name, lay.slot_block(j), ft.RGB_HIDDEN if s.kind == "rgb1" else packed.hidden)
        for j, s in enumerate(packed.layers[:-1])]
    for name, block, width in widths:
        a = ft.from_image(act, block, width)[rows].float()
        b = ft.from_image(stash["act"], block, width)[rows].float()
        ne = a != b
        figures[name] = {"rel_norm": (a - b).norm().item() / b.norm().item(),
                         "unequal": ne.float().mean().item(),
                         "zero_flips": (ne & ((a == 0) | (b == 0))).float().mean().item()}
        if name == "encoding":
            assert torch.equal(a, b)
        assert figures[name]["rel_norm"] <= 1e-3, (name, figures[name])
        assert figures[name]["unequal"] <= 6e-3, (name, figures[name])
        assert figures[name]["zero_flips"] <= 5e-5, (name, figures[name])
    dens_k, dens_p = pt[rows, 0], stash["pt"][rows, 0]
    figures["density_rel_norm"] = (dens_k - dens_p).norm().item() / dens_p.norm().item()
    assert figures["density_rel_norm"] <= 1e-3
    print(json.dumps({"split_stash_figures": [model, n_rays, n_sample], **figures}))


@pytest.mark.gpu
@pytest.mark.parametrize("model,white,n_rays,n_sample", [
    ("legacy", False, 500, 192), ("hidden64", True, 300, 100),
    ("legacy48", False, 400, 130), ("synth800_nope", False, 300, 128)])
def test_split_step_other_networks_match_plain_version(model, white, n_rays, n_sample):
    """The split step (K2 and K4) beyond the 256-wide active arch: the
    legacy arch, widths under 256 (the render kernel's narrow path, weight
    tiles that a width of 48 fills in part), no PE.  rgb and weights
    bit-equal to K1's and K5's, grads under the grads rule of the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    packed = _packed_model(model)
    o, d, z, target = _train_batch(n_rays, n_sample, seed=n_sample + 2)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    rgb, w, gw, gb = ft.fused_mse_loss_weights_grads(packed, o, d, z, target, rcfg)
    rgb2, gw2, gb2 = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    rgb5, w5 = fr.fused_render_rays_weights(packed, o, d, z, rcfg)
    assert torch.equal(rgb, rgb5) and torch.equal(w, w5) and torch.equal(rgb2, rgb5)
    assert torch.equal(gw, gw2) and torch.equal(gb, gb2)
    rr, gwr, gbr = ft.fused_mse_loss_reference(packed, o, d, z, target, rcfg)
    _, gw64, gb64 = ft.fused_mse_loss_reference(packed, o.double(), d.double(), z.double(),
                                                target.double(), rcfg)
    assert (rgb - rr).abs().max().item() <= 1e-2
    assert bool(torch.isfinite(gw).all()) and bool(torch.isfinite(gb).all())
    _assert_grads_close(packed, (gw, gb), (gwr, gbr), (gw64, gb64))


@pytest.mark.gpu
@pytest.mark.parametrize("model,white,n_rays,n_sample", [
    ("synth800", False, 1100, 200), ("legacy48", True, 300, 130), ("hidden64", False, 200, 64)])
def test_k3_backward_reads_no_unwritten_scratch(monkeypatch, model, white, n_rays, n_sample):
    """K3's backward (and K2 with it: the same launches) with every scratch
    buffer of the split step filled with NaN (the stashes, the cotangent
    stash, tb): the grads are finite and bit-equal to a run on uninitialised
    scratch, so no launch reads what no launch wrote; 1,100 rays leave the
    last ray group short."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    packed = _packed_model(model)
    o, d, z, target = _train_batch(n_rays, n_sample, seed=n_sample + 3)
    rcfg = RenderConfig(n_sample=n_sample, white_background=white)
    _, tb = ft.fused_render_train_forward(packed, o, d, z, rcfg)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(n_rays, 3))
                         .astype(np.float32)).cuda() * 1e-3
    want = ft.fused_render_train_backward(packed, o, d, z, rcfg, tb, g)
    want2 = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    monkeypatch.setattr(ft, "_scratch", lambda shape, dtype, device: torch.full(
        shape, float("nan"), device=device, dtype=dtype))
    got = ft.fused_render_train_backward(packed, o, d, z, rcfg, tb, g)
    got2 = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    assert all(bool(torch.isfinite(t).all()) for t in got + got2)
    assert all(torch.equal(a, b) for a, b in zip(got + got2, want + want2))


@pytest.mark.gpu
def test_split_step_ray_groups():
    """The split step in ray groups of 300 and of 1,024 on the same batch:
    rgb and weights bit-equal (each ray's forward does not depend on its
    group), grads within float32 rounding (the groups' partials are summed
    in another grouping)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    packed = _packed_model("synth800")
    o, d, z, target = _train_batch(1000, 128, seed=5)
    rcfg = RenderConfig(n_sample=128)
    rgb, w, _, g = ft._split_step(packed, o, d, z, target, rcfg, True)
    rgb3, w3, _, g3 = ft._split_step(packed, o, d, z, target, rcfg, True, group=300)
    assert torch.equal(rgb, rgb3) and torch.equal(w, w3)
    assert (g - g3).norm().item() <= 1e-5 * g.norm().item()


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
    on the card with its route's raw grads, unpacked and scaled: bit for bit
    those of fused_mse_loss_grads (the split step) and of
    fused_render_train_backward under the MSE's cotangent (K3); the loss is
    the mean of the route's own rgb.  Both routes' grads agree with the
    plain version under the grads rule (both run the split step; autograd's
    MSE cotangent rounds otherwise than the one K2 makes on the card)."""
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
    g3 = {n: p.grad for n, p in model.named_parameters()}
    # each route's raw outputs on the same inputs
    rgb2, gw2, gb2 = ft.fused_mse_loss_grads(packed, o, d, z, target, rcfg)
    rgb3, tb = ft.fused_render_train_forward(packed, o, d, z, rcfg)
    r = rgb3.clone().requires_grad_()
    g = torch.autograd.grad(torch.mean((r - target) ** 2), r)[0]
    gw3, gb3 = ft.fused_render_train_backward(packed, o, d, z, rcfg, tb, g)
    assert torch.equal(rgb, rgb3)
    assert loss.item() == torch.mean((rgb2 - target) ** 2).item()
    for grads, raw in ((g2, (gw2, gb2)), (g3, (gw3, gb3))):
        want = ft.unpack_grads(packed, *raw)
        for n, _ in model.named_parameters():
            assert grads[n] is not None and torch.equal(grads[n], want[n]), n
    rr, gwr, gbr = ft.fused_mse_loss_reference(packed, o, d, z, target, rcfg)
    _, gw64, gb64 = ft.fused_mse_loss_reference(packed, o.double(), d.double(), z.double(),
                                                target.double(), rcfg)
    plain = torch.mean((rr - target) ** 2).item()
    assert loss.item() == pytest.approx(plain, rel=1e-3)
    assert loss3.item() == pytest.approx(plain, rel=1e-3)
    for raw in ((gw2, gb2), (gw3, gb3)):
        assert all(bool(torch.isfinite(t).all()) for t in raw)
        _assert_grads_close(packed, raw, (gwr, gbr), (gw64, gb64))


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


@pytest.mark.gpu
def test_async_checkpoint_snapshot_is_the_state_at_save(tmp_path):
    """train/async_ckpt.py on the card: the file written from the pinned
    snapshot equals a synchronous ``.cpu()`` copy taken at ``save`` (params
    and Adam moments, bit for bit), although three more in-place Adam steps
    were enqueued on the same stream before the writer ran, and differs
    from the parameters after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the snapshot is a device-to-pinned copy")
    from sfm_nerf_tpu_torch.config import NeRFModelConfig
    from sfm_nerf_tpu_torch.models.convert import optimizer_state_to_jax, params_to_jax
    from sfm_nerf_tpu_torch.models.nerf import NeRF
    from sfm_nerf_tpu_torch.train.async_ckpt import AsyncCheckpointer

    model = NeRF(NeRFModelConfig(), device="cuda", seed=0)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    pts = torch.randn(8192, 3, device="cuda")

    def step():
        opt.zero_grad(set_to_none=True)
        density, rgb = model(pts, pts)
        (density.square().mean() + rgb.square().mean()).backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    want_p, want_o = params_to_jax(model), optimizer_state_to_jax(model, opt)
    ck = AsyncCheckpointer(str(tmp_path))
    path = ck.save(1, params_to_jax(model, how="device"),
                   optimizer_state_to_jax(model, opt, how="device"))
    for _ in range(3):
        step()
    ck.wait()
    params, state, s = ckpt.load_checkpoint(path)
    after = params_to_jax(model)
    assert s == 1 and state["count"] == want_o["count"] == 1
    for name in want_p:
        for k in ("w", "b"):
            np.testing.assert_array_equal(params[name][k], want_p[name][k])
            np.testing.assert_array_equal(state["mu"][name][k], want_o["mu"][name][k])
            np.testing.assert_array_equal(state["nu"][name][k], want_o["nu"][name][k])
    assert not np.array_equal(after["fc1"]["w"], want_p["fc1"]["w"])
