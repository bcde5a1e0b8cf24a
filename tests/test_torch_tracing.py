"""The port's spans and counters (utils/profiling.py: span, count,
recording, records, summary) on the CPU: what a training step and a view
record, and what they leave when recording is off.

Sizes: hidden 32, 8x8 images, 16 samples per ray, 32 rays a step; the
tile-image upload at the default widths (hidden 256, PE 10/4)."""

import time

import pytest
import torch
from torch.profiler import profile

from sfm_nerf_tpu_torch.config import (
    NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig,
)
from sfm_nerf_tpu_torch.kernels.fused_render import pack_nerf_params, render_tile_image
from sfm_nerf_tpu_torch.models.nerf import NeRF, NeRFPair
from sfm_nerf_tpu_torch.ops.render import sample_pdf
from sfm_nerf_tpu_torch.train.nerf_trainer import (
    make_optimizer, make_render_image, make_train_step,
)
from sfm_nerf_tpu_torch.utils import profiling

# route -> (n_importance, use_fused_kernel, fused_merged_step)
ROUTES = {"flat": (0, True, True), "hier": (8, True, True), "module": (0, False, True),
          "hier_module": (8, False, True), "two_kernel": (0, True, False)}
# the children of one train.step, in order, on each route (parent: train.step)
TREES = {
    "flat": ["train.sample", "train.pack", "train.loss", "train.backward", "train.optimizer"],
    "hier": ["train.sample", "train.pack", "train.loss", "train.sample", "train.pack",
             "train.loss", "train.backward", "train.optimizer"],
    "module": ["train.sample", "train.loss", "train.backward", "train.optimizer"],
    "hier_module": ["train.sample", "train.loss", "train.backward", "train.optimizer"],
    "two_kernel": ["train.sample", "train.pack", "train.loss", "train.backward",
                   "train.optimizer"],
}
# the tile image of the default network: 664,960 int64 indices
TILE_INDEX_BYTES = 5_319_680


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _cfg(route):
    imp, fused, merged = ROUTES[route]
    return NeRFPipelineConfig(
        model=NeRFModelConfig(hidden=32, n_pos_freq=4, n_dir_freq=2),
        render=RenderConfig(n_sample=16, n_importance=imp, use_fused_kernel=fused,
                            fused_merged_step=merged),
        train=TrainConfig(n_rays_batch=32))


def _camera():
    poses = torch.eye(4).repeat(3, 1, 1)
    poses[:, 2, 3] = 4.0
    K = torch.tensor([[8.0, 0.0, 4.0], [0.0, 8.0, 4.0], [0.0, 0.0, 1.0]])
    return poses, K


def _stepper(route):
    """() -> one CPU training step on ``route``."""
    cfg = _cfg(route)
    torch.manual_seed(0)
    model = (NeRFPair if cfg.render.n_importance else NeRF)(cfg.model, device="cpu")
    opt, sched = make_optimizer(cfg, model)
    step = make_train_step(cfg, opt, sched)
    gen = torch.Generator().manual_seed(1)
    images = torch.rand(3, 8, 8, 3, generator=torch.Generator().manual_seed(2))
    poses, K = _camera()
    return lambda: step(model, gen, images, poses, K)


def _empty_record():
    with profiling.recording():
        pass
    assert profiling.records() == []


def _tree(recs):
    """[(name, parent's name, root)] of the records."""
    return [(r.name, None if r.parent is None else recs[r.parent].name, r.root) for r in recs]


@pytest.mark.parametrize("route", ["flat", "hier", "module"])
def test_recording_off_leaves_the_record_empty(route, monkeypatch):
    """Off, a step records nothing and touches no range, no CUDA event and
    no synchronize."""
    run = _stepper(route)
    _empty_record()

    def refuse(*a, **k):
        raise AssertionError("the off path reached a profiler range, an event or a sync")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    run()
    run()
    assert profiling.records() == []
    assert profiling.summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_recording_records_the_span_tree(route):
    run = _stepper(route)
    run()
    with profiling.recording():
        run()
        run()
    want = []
    for i in range(2):
        root = ("train.step", i)
        want += [("train.step", None, root)] + [(n, "train.step", root) for n in TREES[route]]
    assert _tree(profiling.records()) == want
    spans = profiling.summary()["spans"]
    assert spans["train.step"]["calls"] == spans["train.step"]["roots"] == 2
    assert all(row["roots"] == 2 for row in spans.values())


def test_profiler_ranges_nest_as_the_record():
    """Under a torch.profiler profile recording is on: each span is an
    ``sfm:`` range, inside its parent's range, as many as the record holds."""
    run = _stepper("hier")
    run()
    with profile() as prof:
        run()
        run()
    recs = profiling.records()
    events = [e for e in prof.events() if e.name.startswith("sfm:")]
    assert sorted(e.name for e in events) == sorted("sfm:" + r.name for r in recs)
    steps = [e for e in events if e.name == "sfm:train.step"]
    assert len(steps) == 2
    for e in events:
        if e.name != "sfm:train.step":
            assert any(s.time_range.start <= e.time_range.start
                       and e.time_range.end <= s.time_range.end for s in steps), e.name
    assert _tree(recs)[1:1 + len(TREES["hier"])] == [
        (n, "train.step", ("train.step", 0)) for n in TREES["hier"]]


def test_a_new_window_holds_none_of_the_last():
    run = _stepper("flat")
    with profiling.recording():
        run()
        run()
    assert len([r for r in profiling.records() if r.name == "train.step"]) == 2
    with profile():
        run()
    assert [r.root for r in profiling.records() if r.name == "train.step"] == [
        ("train.step", 0)]
    run()                           # recording off: the record stays as it was
    with profile():
        run()
    steps = [r for r in profiling.records() if r.name == "train.step"]
    assert len(steps) == 1 and profiling.summary()["spans"]["train.step"]["calls"] == 1


def test_the_record_outlives_its_window():
    run = _stepper("module")
    with profiling.recording():
        run()
    run()
    assert profiling.summary()["spans"]["train.step"]["calls"] == 1


def test_render_tile_image_counts_its_upload(monkeypatch):
    """The tile image's index at the default widths: 5,319,680 bytes,
    counted once per layout and device, in one ``upload.tile_index`` span;
    a later packing of the same layout (a training step's) uploads nothing,
    a packing of another layout uploads its own index."""
    from sfm_nerf_tpu_torch.kernels import fused_render

    monkeypatch.setattr(fused_render, "_BY_LAYOUT", {})
    mcfg = NeRFModelConfig()
    model = NeRF(mcfg, device="cpu")
    with profiling.recording():
        packed = pack_nerf_params(model, mcfg, torch.bfloat16)
        render_tile_image(packed)
        render_tile_image(packed)
    assert profiling.summary()["counters"] == {"upload_bytes": TILE_INDEX_BYTES}
    assert [r.name for r in profiling.records()] == ["upload.tile_index"]
    with profiling.recording():
        again = render_tile_image(pack_nerf_params(model, mcfg, torch.bfloat16))
        render_tile_image(pack_nerf_params(model, mcfg, torch.bfloat16))
    assert profiling.summary()["counters"] == {}
    assert torch.equal(again, render_tile_image(packed))
    small = NeRFModelConfig(hidden=32, n_pos_freq=4, n_dir_freq=2)
    with profiling.recording():
        render_tile_image(pack_nerf_params(NeRF(small, device="cpu"), small, torch.bfloat16))
    assert 0 < profiling.summary()["counters"]["upload_bytes"] < TILE_INDEX_BYTES
    _empty_record()                 # recording off: an upload is not counted
    other = NeRFModelConfig(hidden=48, n_pos_freq=5, n_dir_freq=3)
    render_tile_image(pack_nerf_params(NeRF(other, device="cpu"), other, torch.bfloat16))
    assert profiling.summary()["counters"] == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sample_pdf_counts_its_scalar_upload(dtype):
    """The deterministic draw's top value, one element of the cdf's type;
    a draw with a generator uploads nothing."""
    bins = torch.linspace(2.0, 6.0, 15, dtype=dtype).repeat(4, 1)
    weights = torch.rand(4, 14, dtype=dtype, generator=torch.Generator().manual_seed(0))
    with profiling.recording():
        sample_pdf(bins, weights, 8)
        sample_pdf(bins, weights, 8, torch.Generator().manual_seed(1))
    size = torch.tensor(0, dtype=dtype).element_size()
    assert profiling.summary()["counters"] == {"upload_bytes": size}
    assert [r.name for r in profiling.records()] == ["upload.pdf_top"]


def test_a_view_records_its_rays_under_render_view():
    cfg = NeRFPipelineConfig(
        model=NeRFModelConfig(hidden=32, n_pos_freq=4, n_dir_freq=2),
        render=RenderConfig(n_sample=16, use_fused_kernel=True, perturb=False))
    model = NeRF(cfg.model, device="cpu")
    render = make_render_image(cfg)
    poses, K = _camera()
    with profiling.recording():
        for _ in range(2):
            render(model, K, poses[0], 8, 8)
    want = []
    for i in range(2):
        root = ("render.view", i)
        want += [("render.view", None, root), ("render.rays", "render.view", root),
                 ("render.rays", "render.view", root)]
    assert _tree(profiling.records()) == want


def test_summary_self_time_is_the_span_less_its_children():
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    time.sleep(0.002)
                time.sleep(0.001)
            with profiling.span("b"):
                time.sleep(0.001)
            profiling.count("n", 3)
        with profiling.span("a"):
            profiling.count("n", 4)
    recs = profiling.records()
    host = [(r.end_ns - r.start_ns) / 1e6 for r in recs]
    children = [sum(h for r, h in zip(recs, host) if r.parent == i) for i in range(len(recs))]
    s = profiling.summary()
    for name in ("a", "b", "c"):
        mine = [i for i, r in enumerate(recs) if r.name == name]
        row = s["spans"][name]
        assert row["calls"] == len(mine)
        assert row["host_ms"] == pytest.approx(sum(host[i] for i in mine), rel=1e-12)
        assert row["self_host_ms"] == pytest.approx(
            sum(host[i] - children[i] for i in mine), rel=1e-12)
        assert row["device_ms"] == pytest.approx(row["host_ms"], rel=1e-12)   # no card
    assert s["spans"]["a"]["roots"] == 2 and s["spans"]["c"]["roots"] == 1
    assert s["spans"]["b"]["self_host_ms"] < s["spans"]["b"]["host_ms"]
    assert s["counters"] == {"n": 7}
