"""The render kernel's weight tiles, built on the host (CPU).

kernels/fused_render.py lays each 64-row tile of each product out once as
the swizzled shared-memory image the kernel's wgmma reads.  Un-swizzling
the image here, with code of its own, must give back every packed layer
exactly, and the plan handed to the kernel must say what the image holds.
"""

import numpy as np
import pytest
import torch

from sfm_nerf_tpu_torch.config import NeRFModelConfig, RenderConfig
from sfm_nerf_tpu_torch.kernels import fused_render as fr
from sfm_nerf_tpu_torch.models.nerf import NeRF

CONFIGS = {
    "active": NeRFModelConfig(),
    "legacy_skip": NeRFModelConfig(arch="legacy", n_pos_freq=6, n_dir_freq=2),
    "legacy_no_skip": NeRFModelConfig(arch="legacy", n_block1_layers=2, has_skip=False,
                                      hidden=128),
    "no_pe": NeRFModelConfig(pos_encoding=False),
    "hidden64": NeRFModelConfig(hidden=64, n_pos_freq=6, n_dir_freq=2),
    "hidden48_freq16": NeRFModelConfig(hidden=48, n_pos_freq=16, n_dir_freq=16),
}


def _packed(name):
    mcfg = CONFIGS[name]
    return fr.pack_nerf_params(NeRF(mcfg, seed=3), mcfg, torch.bfloat16)


def _unswizzle(block: torch.Tensor) -> torch.Tensor:
    """(cols, 64) image of one tile -> (cols, 64) k-values in order: the
    16-byte chunk c of row n was stored at chunk c ^ (n % 8)."""
    cols = block.shape[0]
    n = torch.arange(cols)[:, None]
    c = torch.arange(8)[None, :]
    return block.reshape(cols, 8, 8)[n, c ^ (n % 8)].reshape(cols, 64)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unswizzled_image_gives_back_every_layer(name):
    packed = _packed(name)
    plan = fr.render_plan(packed)
    image = fr.render_tile_image(packed)
    assert image.dtype == packed.weights.dtype and image.numel() == plan.numel
    specs = {s.name: s for s in packed.layers}
    rebuilt = {s.name: torch.full((s.k_rows, s.n), float("nan"), dtype=torch.float32)
               for s in packed.layers}
    for t in plan.tiles:
        tile = _unswizzle(image[t.off:t.off + t.cols * 64].reshape(t.cols, 64)).float()
        # the atom past the tile's rows is zero
        assert torch.equal(tile[:, t.rows:], torch.zeros(t.cols, 64 - t.rows))
        rebuilt[t.layer][t.row0:t.row0 + t.rows, t.col0:t.col0 + t.cols] = tile[:, :t.rows].t()
    h = packed.hidden
    rgb1 = specs["rgb1"]
    rebuilt["rgb1"][h:] = image[plan.dir_off:].reshape(packed.dir_dim, rgb1.n).float()
    for spec in packed.layers:
        assert torch.equal(rebuilt[spec.name], packed.w(spec).float()), spec.name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tile_offsets_and_plan_shape(name):
    packed = _packed(name)
    plan = fr.render_plan(packed)
    h, pad = packed.hidden, packed.pos_pad
    tiles = plan.tiles
    # every tile starts on a 128-byte boundary, in consumption order, and
    # fits one ring slot
    assert [t.off for t in tiles] == sorted(t.off for t in tiles)
    for a, b in zip(tiles, tiles[1:] + (None,)):
        assert (a.off * 2) % 128 == 0
        assert (b.off if b else plan.dir_off) == a.off + a.cols * 64
        assert a.cols * 128 <= plan.stage_bytes <= 256 * 128
        assert a.rows % 16 == 0 and 0 < a.rows <= 64 and a.cols % 16 == 0
    assert (plan.dir_off * 2) % 128 == 0
    kinds = [p.kind for p in plan.passes]
    n_body = sum(s.kind in ("plain", "skip") for s in packed.layers)
    assert kinds == ["relu"] * (1 + n_body) + ["dens", "relu", "rgb1", "rgb2"]
    assert [p.n for p in plan.passes] == [h] * (1 + n_body) + [16, h, 128, 16]
    for p in plan.passes:
        srcs = [t.src for t in p.tiles]
        assert srcs == sorted(srcs)             # 'act' tiles before 'enc' tiles
        for src, width, blocks in (("act", h if p.layer != "rgb2" else 128, plan.act_kb),
                                   ("enc", pad, plan.enc_kb)):
            mine = [t for t in p.tiles if t.src == src]
            assert [t.kb for t in mine] == list(range(len(mine)))
            assert all(t.kb < blocks for t in mine)
            if mine:
                assert sum(t.rows for t in mine) == width
    assert plan.act_kb == -(-max(h, 128) // 64) and plan.enc_kb == -(-pad // 64)


@pytest.mark.parametrize("name", ["active", "hidden48_freq16"])
def test_kernel_args_carry_the_plan(name):
    """The ints after the layer table (sm90::parse_plan's input) say what
    render_plan says; the image is built once per PackedNeRF."""
    packed = _packed(name)
    plan = fr.render_plan(packed)
    ip, _, _ = fr._render_kernel_args(packed, RenderConfig())
    ip = list(ip)
    tail = ip[fr.HEAD_INTS + 5 * len(packed.layers):]
    n_p, n_t = len(plan.passes), len(plan.tiles)
    assert tail[:6] == [n_p, n_t, plan.dir_off, plan.act_kb, plan.enc_kb, plan.stage_bytes]
    passes = np.array(tail[6:6 + 6 * n_p]).reshape(n_p, 6)
    tiles = np.array(tail[6 + 6 * n_p:]).reshape(n_t, 4)
    assert list(passes[:, 3]) == list(np.cumsum([0] + [len(p.tiles) for p in plan.passes])[:-1])
    for row, p in zip(passes, plan.passes):
        assert row[1] == p.n and row[2] == p.b_off and row[4] == len(p.tiles)
        assert row[5] == sum(t.src == "act" for t in p.tiles)
    assert list(tiles[:, 0]) == [t.off for t in plan.tiles]
    assert list(tiles[:, 1]) == [t.cols * 128 for t in plan.tiles]
    assert list(tiles[:, 2]) == [t.rows // 16 for t in plan.tiles]
    assert fr.render_tile_image(packed) is fr.render_tile_image(packed)


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["mip"])
def test_staged_biases_lie_inside_the_packing(name):
    """The kernel's block copies [0, max(b_off + n)) of the biases, rounded
    up to whole float4 (sm90_mlp.cuh bias_floats), to shared memory: every
    pass's bias, the padded density and rgb heads included, lies in the
    packed buffer, and so does the copy's rounded end; each pass's bias
    starts on an even float, for the 8-byte reads of init_bias."""
    mcfg = NeRFModelConfig(arch="mip", n_pos_freq=16, n_dir_freq=4) if name == "mip" \
        else CONFIGS[name]
    packed = fr.pack_nerf_params(NeRF(mcfg, seed=3), mcfg, torch.bfloat16)
    plan = fr.render_plan(packed)
    end = max(p.b_off + p.n for p in plan.passes)
    assert -(-end // 4) * 4 <= packed.biases.numel()
    assert packed.biases.dtype == torch.float32 and packed.biases.is_contiguous()
    for p in plan.passes:
        assert p.b_off % 2 == 0, (p.kind, p.b_off)
