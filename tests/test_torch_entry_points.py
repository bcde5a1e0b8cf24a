"""The port's last entry points against the JAX side's, on the CPU:
``cli.wrapper`` against ``Phase2/Wrapper.py`` (flags, defaults, what its
train/test delegation sets; a tiny legacy-compositor train and test run),
``io/gif.py`` + ``cli.gif`` against ``Phase2/get_gif.py`` (run as a
subprocess; imageio reads both files here), and ``cli.synth_scene``'s
tracer against ``Phase2/make_synth_scene.py``'s numpy tracer.

Tolerances, stated where used: the port's GIF decodes to its own quantized
frames exactly, and its mean error per frame against the source PNG is at
most the JAX-side GIF's plus GIF_MARGIN levels of 255; the tracer in
float32 follows tests/test_synth_scene.py's rule (under 1% of pixels more
than 0.05 off, median at most 1e-3), in float64 within 1e-6.
"""

import importlib.util
import json
import os
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from sfm_nerf_tpu_torch.cli import gif as cli_gif
from sfm_nerf_tpu_torch.cli import nerf as cli_nerf
from sfm_nerf_tpu_torch.cli import synth_scene as ss
from sfm_nerf_tpu_torch.cli import wrapper
from sfm_nerf_tpu_torch.io.blender import load_blender_dataset, look_at_pose
from sfm_nerf_tpu_torch.io.gif import quantize, read_gif, write_gif
from sfm_nerf_tpu_torch.io.png import read_png, write_png
from util_synthetic import make_blender_dataset

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GIF_MARGIN = 0.5            # mean abs levels of 255 the port's GIF may lose to imageio's
F32_OFF, F32_FRAC, F32_MEDIAN = 0.05, 0.01, 1e-3
F64_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _load_script(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    saved = sys.argv
    sys.argv = [rel]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


# ---------------------------------------------------------------------------
# cli.wrapper
# ---------------------------------------------------------------------------


def test_wrapper_flags_and_defaults_match_jax():
    """Every flag of Phase2/Wrapper.py but --platform, with its default, and
    --device besides."""
    ours = {a.dest: a.default for a in wrapper.config_parser()._actions if a.dest != "help"}
    theirs = {a.dest: a.default
              for a in _load_script("Phase2/Wrapper.py", "_jw").configParser()._actions
              if a.dest != "help"}
    assert ours.pop("device") == "cuda"
    assert set(ours) == set(theirs) - {"platform"}
    for k, v in ours.items():
        assert v == theirs[k], f"--{k}: {v!r} vs JAX {theirs[k]!r}"


def _jax_delegation(monkeypatch, argv):
    """The namespace Phase2/Wrapper.py hands to train.py's main."""
    import sfm_nerf_tpu.utils.compilation_cache as cc

    mod = _load_script("Phase2/Wrapper.py", "_jw_delegate")
    captured = {}
    real = importlib.util.spec_from_file_location

    def fake_spec(name, path):
        spec = real(name, path)
        run = spec.loader.exec_module

        def exec_and_patch(m):
            run(m)
            m.main = lambda t_args: captured.update(vars(t_args))
        spec.loader.exec_module = exec_and_patch
        return spec

    monkeypatch.setattr(importlib.util, "spec_from_file_location", fake_spec)
    monkeypatch.setattr(cc, "enable_compilation_cache", lambda: None)
    mod.main(mod.configParser().parse_args(argv))
    monkeypatch.setattr(importlib.util, "spec_from_file_location", real)
    return captured


@pytest.mark.parametrize("argv", [
    ["--mode", "train"],
    ["--mode", "train", "--modern_schedule"],
    ["--mode", "train", "--modern_render", "--max_iters", "7", "--n_sample", "64"],
    ["--mode", "test"],
    ["--mode", "test", "--modern_render", "--eval_split", "test"],
])
def test_wrapper_delegation_sets_what_jax_sets(monkeypatch, argv):
    """The namespace handed to cli.nerf equals, on every key the two share,
    the one Phase2/Wrapper.py hands to train.py; in particular what
    tests/test_cli.py:200,234 pin: StepLR(1000, 0.1) unless
    --modern_schedule, near 1 / far 10 / legacy unless --modern_render, the
    eval split forwarded, None never overwriting a default."""
    theirs = _jax_delegation(monkeypatch, argv)
    got = {}
    monkeypatch.setattr(cli_nerf, "run_train", lambda a: got.update(vars(a)))
    monkeypatch.setattr(cli_nerf, "run_test", lambda a: got.update(vars(a)))
    wrapper.main(argv)
    shared = set(got) & set(theirs)
    assert {"near", "far", "render_variant", "eval_split", "checkpoint_path"} <= shared
    for k in shared:
        assert got[k] == theirs[k], f"{k}: {got[k]!r} vs JAX {theirs[k]!r}"
    modern_render = "--modern_render" in argv
    assert (got["near"], got["far"]) == ((2.0, 6.0) if modern_render else (1.0, 10.0))
    assert got["render_variant"] == ("train" if modern_render else "legacy")
    if argv[1] == "train":
        want = 50000 if "--modern_schedule" in argv else 1000
        assert (got["lrate_decay_steps"], got["lrate_decay"]) == (want, 0.1)
    else:
        assert got["eval_split"] == ("test" if "--eval_split" in argv else "train")


def test_wrapper_gif_mode_is_cli_nerf_gif(monkeypatch):
    seen = {}
    monkeypatch.setattr(cli_nerf, "run_gif", lambda a: seen.update(vars(a)))
    wrapper.main(["--mode", "gif", "--n_frames", "3", "--device", "cpu"])
    assert seen["n_frames"] == 3 and seen["near"] is None and seen["device"] == "cpu"
    with pytest.raises(SystemExit, match="not implemented"):
        wrapper.main(["--mode", "val"])


def test_wrapper_trains_and_tests_tiny_on_the_cpu(tmp_path):
    """A tiny legacy-loop run: train takes the nn.Module route (the legacy
    compositor is outside the training kernels' envelope) under
    StepLR(1000, 0.1); test renders the train split through the fused
    render route (its plain version on the CPU) with the legacy
    compositor, from the checkpoint train wrote."""
    from sfm_nerf_tpu_torch.train.nerf_trainer import fused_train_supported, use_fused_route

    data = make_blender_dataset(str(tmp_path / "scene"), n_frames=2, height=16, width=16)
    common = ["--data_path", data + "/", "--checkpoint_path", str(tmp_path / "ck") + "/",
              "--n_sample", "16", "--n_pos_freq", "4", "--n_dirc_freq", "2", "--device", "cpu"]
    stats = wrapper.main(["--mode", "train", *common, "--n_rays_batch", "64",
                          "--max_iters", "12", "--save_ckpt_iter", "0",
                          "--logs_path", str(tmp_path / "logs")])
    assert stats["steps"] == 12 and np.isfinite(stats["final_loss"])
    cfg = cli_nerf.build_config(wrapper.delegated_args(
        wrapper.config_parser().parse_args(["--mode", "train", *common])))
    assert not fused_train_supported(cfg) and cfg.train.lrate_decay_steps == 1000
    assert (cfg.render.near, cfg.render.far, cfg.render.variant) == (1.0, 10.0, "legacy")
    assert os.path.exists(tmp_path / "ck" / "scene" / "final_model.ckpt.npz")
    records = wrapper.main(["--mode", "test", *common, "--images_path", str(tmp_path / "img")])
    assert len(records) == 2 and all(np.isfinite(r["mse"]) for r in records)
    tcfg = cli_nerf.build_config(wrapper.delegated_args(
        wrapper.config_parser().parse_args(["--mode", "test", *common])))
    assert use_fused_route(tcfg) and tcfg.render.variant == "legacy"


# ---------------------------------------------------------------------------
# io/gif.py, cli.gif
# ---------------------------------------------------------------------------


def _frames(n=3, step=4):
    """Real renders: synth800 test views, every ``step``-th pixel."""
    return [read_png(os.path.join(REPO, "Phase2", "nerf_synthetic", "synth800", "test",
                                  f"r_{i}.png"))[::step, ::step, :3] for i in range(n)]


def test_gif_round_trip_is_lossless_and_imageio_reads_it(tmp_path):
    """The file decodes, by the port's reader and by imageio, to exactly
    the quantized frames the writer returns; one global palette, a delay of
    100 / fps centiseconds a frame (imageio: 500 ms at 2 fps), 3 frames."""
    frames = _frames()
    path = str(tmp_path / "a.gif")
    held = write_gif(path, frames, fps=2)
    palette, idx = quantize(frames)
    np.testing.assert_array_equal(held, np.stack([palette[i] for i in idx]))
    got, delays = read_gif(path)
    np.testing.assert_array_equal(got, held)
    assert delays == [50, 50, 50]
    theirs = imageio.mimread(path)
    assert len(theirs) == 3
    for a, b in zip(theirs, held):
        np.testing.assert_array_equal(np.asarray(a)[..., :3], b)
    assert imageio.get_reader(path).get_meta_data()["duration"] == 500


def test_gif_of_few_colours_is_exact(tmp_path):
    """256 colours or fewer: the palette holds them all, nothing moves;
    LZW runs past its 4,096-code table (a clear code) on a noisy frame."""
    rng = np.random.default_rng(0)
    colours = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    frames = [colours[rng.integers(0, 200, (97, 131))] for _ in range(2)]
    held = write_gif(str(tmp_path / "b.gif"), frames, fps=4)
    for a, b in zip(held, frames):
        np.testing.assert_array_equal(a, b)
    got, delays = read_gif(str(tmp_path / "b.gif"))
    np.testing.assert_array_equal(got, np.stack(frames))
    assert delays == [25, 25]


@pytest.mark.parametrize("rgb", [False, True])
def test_cli_gif_against_get_gif(tmp_path, rgb):
    """The same image_{1,2,10}.png frames stitched by Phase2/get_gif.py (a
    subprocess: cv2 and imageio) and by cli.gif: both files hold the frames
    in numeric order with the same channel order (swapped by default, as
    the reference's cv2 read did; as they are under --rgb), and the port's
    mean error against each source frame is at most the JAX-side GIF's plus
    GIF_MARGIN."""
    src = _frames()
    d = tmp_path / "frames"
    d.mkdir()
    for n, f in zip((1, 2, 10), src):
        write_png(str(d / f"image_{n}.png"), np.ascontiguousarray(f))
    theirs_path, ours_path = str(tmp_path / "jax.gif"), str(tmp_path / "port.gif")
    cmd = [sys.executable, os.path.join(REPO, "Phase2", "get_gif.py"), "--images_path", str(d),
           "--out", theirs_path] + (["--rgb"] if rgb else [])
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    res = cli_gif.main(["--images_path", str(d), "--out", ours_path] + (["--rgb"] if rgb else []))
    assert [os.path.basename(p) for p in res["frames"]] == ["image_1.png", "image_2.png",
                                                             "image_10.png"]
    theirs = [np.asarray(f)[..., :3].astype(int) for f in imageio.mimread(theirs_path)]
    ours, _ = read_gif(ours_path)
    assert len(theirs) == len(ours) == 3
    for a, b, s in zip(ours.astype(int), theirs, src):
        want = s if rgb else s[..., ::-1]
        err_ours, err_theirs = np.abs(a - want).mean(), np.abs(b - want).mean()
        assert err_ours <= err_theirs + GIF_MARGIN, (err_ours, err_theirs)
        assert err_ours < np.abs(a - want[..., ::-1]).mean()


# ---------------------------------------------------------------------------
# cli.synth_scene
# ---------------------------------------------------------------------------


@pytest.fixture()
def gen():
    return _load_script("Phase2/make_synth_scene.py", "_mss_port_test")


def _c2w():
    eye = np.array([4 * np.cos(np.deg2rad(25.0)), 4 * np.sin(np.deg2rad(25.0)), 1.0])
    return look_at_pose(eye, np.array([0.0, -0.2, 0.0]))


@pytest.mark.parametrize("scene", ["spheres", "chair"])
def test_tracer_matches_the_numpy_tracer(gen, scene):
    """64x64 views of both scenes: the torch tracer in float32 under
    tests/test_synth_scene.py's rule against the script's numpy
    render_view, in float64 within F64_TOL; both render a hit region and a
    black background."""
    gen.set_scene(scene)
    ref = gen.render_view(_c2w(), 64)
    sc = ss.Scene()
    sc.set_scene(scene)
    f32 = ss.render_view(_c2w(), 64, sc, "cpu", torch.float32)
    f64 = ss.render_view(_c2w(), 64, sc, "cpu", torch.float64)
    diff = np.abs(f32 - ref)
    assert (diff > F32_OFF).mean() < F32_FRAC and np.median(diff) <= F32_MEDIAN
    assert np.abs(f64 - ref).max() <= F64_TOL
    assert 0.02 < (ref.sum(-1) > 0).mean() < 0.9
    assert f32[0, 0].tolist() == [0.0, 0.0, 0.0]


def test_white_background_and_scene_switch(gen):
    """Miss rays are exactly 1.0 on a white background in both dtypes; a
    scene switched back and forth renders each scene anew (the script's jax
    tracer once replayed a stale scene)."""
    gen.set_scene("chair")
    gen.set_background("white")
    ref = gen.render_view(_c2w(), 64)
    sc = ss.Scene()
    sc.set_scene("chair")
    sc.set_background("white")
    for dtype in (torch.float32, torch.float64):
        img = ss.render_view(_c2w(), 64, sc, "cpu", dtype)
        assert img[0, 0].tolist() == [1.0, 1.0, 1.0]
        assert (img.min(-1) < 0.9).mean() > 0.02
        assert (np.abs(img - ref) > F32_OFF).mean() < F32_FRAC
    sc.set_background("black")
    chair = ss.render_view(_c2w(), 64, sc)
    sc.set_scene("spheres")
    spheres = ss.render_view(_c2w(), 64, sc)
    sc.set_scene("chair")
    assert np.abs(spheres - chair).max() > 0.1
    np.testing.assert_array_equal(ss.render_view(_c2w(), 64, sc), chair)


def test_scene_tables_and_rig_are_the_scripts(gen):
    """The port's copies: the same constants, the same chair scene after
    set_scene, the same camera rig pose for pose."""
    assert ss.CAMERA_ANGLE_X == gen.CAMERA_ANGLE_X
    for a, b in zip(ss.SPHERES, gen.SPHERES):
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    gen.set_scene("chair")
    sc = ss.Scene()
    sc.set_scene("chair")
    for ours, theirs in ((sc.spheres, gen.SPHERES), (sc.boxes, gen.BOXES)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2:] == b[2:]
    rig, ref = ss.camera_rig(12, 4, 3), gen.camera_rig(12, 4, 3)
    for mode in ("train", "test"):
        np.testing.assert_array_equal(np.stack(rig[mode]), np.stack(ref[mode]))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_synth_scene_cli_writes_a_loadable_dataset(tmp_path, backend):
    """A 2 + 1 view dataset at 24x24 on the CPU loads through io/blender.py:
    the PNGs are the tracer's views rounded as the script rounds them, the
    poses the rig's."""
    out = str(tmp_path / "ds")
    res = ss.main(["--out", out, "--size", "24", "--n_train", "2", "--n_test", "1",
                   "--scene", "chair", "--background", "white", "--trace_backend", backend,
                   "--device", "cpu"])
    assert res["views"] == 3
    images, poses, cam = load_blender_dataset(out, "train")
    assert images.shape == (2, 24, 24, 3) and cam.width == 24
    rig = ss.camera_rig(2, 1, 0)
    np.testing.assert_allclose(poses, np.stack(rig["train"]).astype(np.float32))
    sc = ss.Scene()
    sc.set_scene("chair")
    sc.set_background("white")
    dtype = torch.float64 if backend == "numpy" else torch.float32
    want = (ss.render_view(rig["train"][1], 24, sc, "cpu", dtype) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(read_png(os.path.join(out, "train", "r_1.png")), want)
    with open(os.path.join(out, "transforms_test.json")) as f:
        assert json.load(f)["camera_angle_x"] == ss.CAMERA_ANGLE_X
