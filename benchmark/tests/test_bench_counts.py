"""The frozen counts give the numbers the kernel table was read against."""

import json
import os

import pytest

from benchmark import counts, harness
from benchmark.reference import active


def _model(config):
    with open(os.path.join(harness.ROOT, "benchmark", "configs", config + ".json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("config", ["nerf-active-flat", "nerf-active-hier"])
def test_macs_and_parameters(config):
    m = _model(config)
    assert active.macs_per_point(m) == 655_488
    assert active.macs_per_ray(m) == 27 * 128
    assert counts.param_count(active, m) == m["parameters"] == 661_636


@pytest.mark.parametrize("rays, samples, passes, ms", [
    (8192, 256, 3, 8.34),          # a flat training step (K2)
    (640_000, 256, 1, 217.2),      # an 800x800 frame (K1)
    (640_000, 384, 1, 325.8),      # the fine pass of a hierarchical frame
])
def test_bounds(rays, samples, passes, ms):
    m = _model("nerf-active-flat")
    flops = passes * counts.forward_flops(active, m, rays, samples)
    assert round(flops / counts.PEAK_BF16 * 1e3, 2 if ms < 100 else 1) == ms
    # operations bound every call of these shapes, not bytes
    nbytes = (counts.train_bytes if passes == 3 else counts.render_bytes)(active, m, rays,
                                                                          samples)
    assert counts.least_s(flops, nbytes) == flops / counts.PEAK_BF16


def test_hierarchical_step_bound():
    m = _model("nerf-active-hier")
    s = counts.train_flops(active, m, 8192, 256) + counts.train_flops(active, m, 8192, 384)
    assert round(s / counts.PEAK_BF16 * 1e3, 2) == 20.85


@pytest.mark.parametrize("pos_encoding", [True, False])
def test_counts_agree_with_the_port(pos_encoding):
    """The copy starts equal to the program's own count (which later
    changes may move; the copy stays), with and without the encoding."""
    from sfm_nerf_tpu_torch.config import NeRFModelConfig
    from sfm_nerf_tpu_torch.kernels.fused_render import macs_per_point, macs_per_ray
    from sfm_nerf_tpu_torch.models.nerf import NeRF, layer_shapes, param_count

    mcfg = NeRFModelConfig(pos_encoding=pos_encoding)
    m = {**_model("nerf-active-flat"), "pos_encoding": pos_encoding}
    assert active.layer_shapes(m) == layer_shapes(mcfg)
    assert active.macs_per_point(m) == macs_per_point(mcfg)
    assert active.macs_per_ray(m) == macs_per_ray(mcfg)
    assert counts.param_count(active, m) == param_count(NeRF(mcfg))
