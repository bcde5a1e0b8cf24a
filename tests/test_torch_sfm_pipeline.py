"""The port's Phase 1 pipeline against the JAX package's on one small ring
(6 cameras x 400 points, 0.5 px noise, 1,024 F and 1,024 PnP hypotheses,
20 BA steps, track merging on), run once each per module: the JAX
``SfMPipeline`` under the tests' x64 conftest, the port through its entry
point ``cli.sfm --device cpu --export_nerf``.

The two draw their RANSAC samples from different generators, so they are
held to the same outcome, not the same draws: the same registered cameras,
the point count within 2%, the final BA mean error within 5% of JAX's and
below 1 px, every camera rotation within 0.05 degrees of JAX's once both
are expressed relative to camera 1.
"""

import json
import os

import numpy as np
import pytest
import torch

from util_synthetic import write_reference_format_dataset

N_CAMS = 6
FLAGS = dict(ransac_iters=1024, pnp_iters=1024, ba_max_iters=20, merge_tracks=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The SfM ops are thousands of tiny tensor ops: one intra-op thread
    each, so that the suite's parallel workers do not oversubscribe the
    machine's cores (measured: ten times slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    root = tmp_path_factory.mktemp("sfm_ring")
    data, gt = write_reference_format_dataset(
        str(root / "data"), n_cams=N_CAMS, n_points=400, noise_px=0.5, seed=0,
        visibility_window=4)
    # textured frames, so that the point colours say which pixel was read
    import cv2

    yy, xx = np.mgrid[0:600, 0:800]
    for i in range(1, N_CAMS + 1):
        rgb = np.stack([xx % 256, yy % 256, (xx + 7 * i) % 256], -1).astype(np.uint8)
        cv2.imwrite(os.path.join(data, f"{i}.png"), rgb[..., ::-1])
    return root, data, gt


@pytest.fixture(scope="module")
def jax_run(ring):
    from sfm_nerf_tpu.config import SfMConfig
    from sfm_nerf_tpu.sfm import SfMPipeline

    root, data, _ = ring
    out = str(root / "jax_out")
    os.makedirs(out, exist_ok=True)
    cfg = SfMConfig(data_path=data, num_images=N_CAMS, output_dir=out, **FLAGS)
    return SfMPipeline(cfg).run()


@pytest.fixture(scope="module")
def torch_run(ring):
    from sfm_nerf_tpu_torch.cli import sfm as cli

    root, data, _ = ring
    argv = ["--data_path", data, "--num_images", str(N_CAMS),
            "--output_dir", str(root / "torch_out"), "--device", "cpu",
            "--export_nerf", str(root / "nerf"), "--merge_tracks",
            "--ransac_iters", "1024", "--pnp_iters", "1024", "--ba_max_iters", "20"]
    return cli.main(argv)


def _relative_rotations(camera_info):
    R1 = np.asarray(camera_info[1]["R"])
    return {c: np.asarray(v["R"]) @ R1.T for c, v in camera_info.items()}


def test_same_registered_cameras(jax_run, torch_run):
    assert sorted(torch_run["camera_info"]) == sorted(jax_run["camera_info"])
    assert len(torch_run["camera_info"]) == N_CAMS


def test_point_count_within_2_percent(jax_run, torch_run):
    nj = jax_run["stats"]["n_points_total"]
    nt = torch_run["stats"]["n_points_total"]
    assert abs(nt - nj) <= 0.02 * nj, (nt, nj)


def test_final_ba_error(jax_run, torch_run):
    ej = jax_run["stats"]["ba"]["final_err_px"]["mean"]
    et = torch_run["stats"]["ba"]["final_err_px"]["mean"]
    assert et < 1.0
    assert abs(et - ej) <= 0.05 * ej, (et, ej)


def test_rotations_match_jax(jax_run, torch_run):
    rj = _relative_rotations(jax_run["camera_info"])
    rt = _relative_rotations(torch_run["camera_info"])
    for c in rj:
        cosang = (np.trace(rt[c].T @ rj[c]) - 1) / 2
        deg = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
        assert deg < 0.05, (c, deg)


def test_rotations_match_ground_truth(ring, torch_run):
    _, _, gt = ring
    R1 = gt["Rs"][0]
    for c, v in torch_run["camera_info"].items():
        R_gt = gt["Rs"][c - 1] @ R1.T
        R = np.asarray(v["R"]) @ np.asarray(torch_run["camera_info"][1]["R"]).T
        deg = np.degrees(np.arccos(np.clip((np.trace(R.T @ R_gt) - 1) / 2, -1, 1)))
        assert deg < 0.1, (c, deg)


def test_artifacts_written(ring, torch_run):
    root, _, _ = ring
    out = root / "torch_out"
    with open(out / "sfm_stats.json") as f:
        stats = json.load(f)
    assert stats["n_registered"] == N_CAMS and stats["device"] == "cpu"
    assert set(stats["stage_seconds"]) == {
        "load+parse", "ransac_refine", "two_view_init", "registration", "global_init",
        "ba+artifacts"}
    head = open(out / "reconstruction.ply", "rb").read(200).decode(errors="replace")
    assert f"element vertex {stats['n_points_total']}" in head


def test_figures_match_jax(ring, jax_run, torch_run):
    """The port writes every figure the JAX pipeline writes (the init pair's
    matches, the two-view plots and overlays, the reconstruction and
    top-down plots), under the same names and at the same pixel sizes."""
    import cv2

    root, _, _ = ring
    figures = {}
    for tag in ("jax_out", "torch_out"):
        names = sorted(n for n in os.listdir(root / tag) if n.endswith((".png", ".jpg")))
        figures[tag] = {n: cv2.imread(str(root / tag / n)).shape for n in names}
    assert figures["torch_out"] == figures["jax_out"]
    assert len(figures["jax_out"]) == 9, sorted(figures["jax_out"])


def test_point_colours_match_jax(ring, jax_run, torch_run):
    """Both clouds colour each point by its feature's pixel in its first
    view: the port reads RGB, the JAX package swaps cv2's BGR, so the two
    clouds carry the same colours.  (Feature ids are not compared: one
    RANSAC verdict apart, track merging numbers the features differently.)
    The frames are textured, so a colour names its pixel."""
    from collections import Counter

    root, _, _ = ring

    def colours(path):
        lines = open(path).read().split("end_header\n")[1].splitlines()
        return Counter(tuple(int(v) for v in ln.split()[3:]) for ln in lines)

    cj = colours(root / "jax_out" / "reconstruction.ply")
    ct = colours(root / "torch_out" / "reconstruction.ply")
    assert sum((ct & cj).values()) >= 0.95 * sum(cj.values())
    assert len(ct) > 0.5 * sum(ct.values())                  # not one grey


def test_export_trains_with_auto_bounds(ring, torch_run):
    """The export reads back through the port's blender loader: one frame
    per registered camera at the SfM pose, the calibrated intrinsics, the
    near/far hints that ``cli.nerf --near auto --far auto`` takes."""
    from sfm_nerf_tpu_torch.cli.nerf import _resolve_bounds, config_parser
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset
    from sfm_nerf_tpu_torch.sfm.to_nerf import c2w_from_rc

    root, data, gt = ring
    nerf = str(root / "nerf")
    images, poses, cam = load_blender_dataset(nerf, "train")
    ids = sorted(torch_run["camera_info"])
    assert len(images) == len(ids) and images.shape[1:] == (600, 800, 3)
    for k, c in enumerate(ids):
        info = torch_run["camera_info"][c]
        np.testing.assert_allclose(poses[k], c2w_from_rc(info["R"], info["C"]), atol=1e-5)
    np.testing.assert_allclose(cam.camera_matrix, gt["K"], rtol=1e-6)
    args = config_parser("train").parse_args(
        ["--data_path", nerf + "/", "--near", "auto", "--far", "auto"])
    _resolve_bounds(args, cam, "train")
    assert 0 < args.near < args.far
    assert (args.near, args.far) == (cam.near, cam.far)


def test_sharded_options_and_config_validation():
    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.sfm.pipeline import SfMPipeline

    # the sharded stages are ported (parallel/): accepted on the CPU
    SfMPipeline(SfMConfig(ransac_devices=2, ba_devices=2), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        SfMConfig(ransac_confidence=0.99, ransac_devices=2)
    with pytest.raises(ValueError, match="unknown intrinsics token"):
        SfMConfig(ba_refine_intrinsics="f,zz")


# ---- each Phase 1 option reaches its code ----------------------------------

ADAPTIVE_CAP = 3072        # three chunks; the ring's bound stops at the floor, two


@pytest.fixture(scope="module")
def refined_adaptive(ring):
    """The ring's refine stage under ``ransac_confidence`` 0.99, its stats
    and printed lines."""
    import contextlib
    import io

    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.io.sfm_data import parse_matching_files
    from sfm_nerf_tpu_torch.sfm.pipeline import SfMPipeline

    _, data, _ = ring
    pipe = SfMPipeline(SfMConfig(data_path=data, num_images=N_CAMS,
                                 ransac_iters=ADAPTIVE_CAP, ransac_confidence=0.99),
                       device="cpu")
    m, t, v = parse_matching_files(data, N_CAMS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        refined, tracks, _ = pipe.refine_all_matches(m, t, v)
    return refined, tracks, pipe.stats, out.getvalue()


def test_ransac_confidence_reaches_the_adaptive_driver(refined_adaptive):
    refined, _, stats, printed = refined_adaptive
    used = stats["ransac_iters_scored"]
    assert len(used) == len(refined) == 15 and set(used) == {2048}
    assert printed.count(f"(2048/{ADAPTIVE_CAP} iters)") == 15


def _global_init(ring, refined_adaptive, **kw):
    """``_global_init`` on the ring's refined pairs, the cameras at the
    ground truth (in camera 1's frame, at its scale), no points."""
    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.sfm.pipeline import SfMPipeline

    _, data, gt = ring
    refined, tracks, _, _ = refined_adaptive
    R1, C1 = gt["Rs"][0], gt["Cs"][0]
    cams = {c: {"R": gt["Rs"][c - 1] @ R1.T, "C": R1 @ (gt["Cs"][c - 1] - C1)}
            for c in range(1, N_CAMS + 1)}
    pipe = SfMPipeline(SfMConfig(data_path=data, num_images=N_CAMS, **kw), device="cpu")
    pipe._global_init(gt["K"], refined, tracks, cams, {})
    for c, v in cams.items():
        R_gt = gt["Rs"][c - 1] @ R1.T
        deg = np.degrees(np.arccos(np.clip((np.trace(v["R"].T @ R_gt) - 1) / 2, -1, 1)))
        assert deg < 0.5, (c, deg)          # pairwise F at 0.5 px noise
    return pipe.stats, cams


def test_global_rotation_init_reaches_rotation_averaging(ring, refined_adaptive):
    stats, _ = _global_init(ring, refined_adaptive, global_rotation_init=True)
    assert stats["rotation_avg"]["n_pairs"] == 15
    assert stats["rotation_avg"]["mean_residual_deg"] < 0.5
    assert "translation_avg" not in stats


def test_global_init_reaches_translation_averaging(ring, refined_adaptive):
    _check_global_init(ring, refined_adaptive, batch_pairs=4)


def test_global_init_one_pair_a_launch(ring, refined_adaptive):
    """``global_init_batch_pairs=0``: the relative poses one pair a launch."""
    _check_global_init(ring, refined_adaptive, batch_pairs=0)


def _check_global_init(ring, refined_adaptive, batch_pairs):
    _, _, gt = ring
    stats, cams = _global_init(ring, refined_adaptive, global_init=True,
                               global_init_batch_pairs=batch_pairs)
    assert stats["translation_avg"]["n_pairs"] == 15
    assert stats["translation_avg"]["median_residual_deg"] < 1.0
    # the first camera's centre kept, the scale of its baseline to camera 2
    R1, C1 = gt["Rs"][0], gt["Cs"][0]
    for c, v in cams.items():
        assert np.linalg.norm(v["C"] - R1 @ (gt["Cs"][c - 1] - C1)) < 0.05 * 6


def test_essential_method_5pt_reaches_the_five_point_ransac(ring, refined_adaptive,
                                                            monkeypatch):
    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.sfm import pipeline as pl

    _, data, gt = ring
    refined, _, _, _ = refined_adaptive
    calls = []

    def spy(*a, **kw):
        calls.append(kw)
        return pl.ransac_essential_5pt.__wrapped__(*a, **kw)

    spy.__wrapped__ = pl.ransac_essential_5pt
    monkeypatch.setattr(pl, "ransac_essential_5pt", spy)
    pipe = pl.SfMPipeline(SfMConfig(data_path=data, num_images=N_CAMS,
                                    essential_method="5pt", e5_ransac_iters=200),
                          device="cpu")
    F12, m12 = refined[(1, 2)]
    tv = pipe.two_view_reconstruct(gt["K"], F12, np.eye(3), np.zeros(3),
                                   m12[:, 0:2], m12[:, 2:4])
    assert len(calls) == 1 and calls[0]["n_iters"] == 200 and calls[0]["seed"] == 0
    assert tv.mean_error_nonlinear < 1.0


@pytest.mark.parametrize("rescue", ["on", "off"])
def test_pnp_f64_rescue_reaches_the_rescue(rescue, monkeypatch):
    """A forced PnP RANSAC failure: rescued under 'on' (the pose at the
    truth, ``stats['pnp_rescues']``), a failure under 'off'."""
    from util_synthetic import make_sfm_scene

    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.ops.pnp import PnPRansacResult
    from sfm_nerf_tpu_torch.sfm import pipeline as pl

    sc = make_sfm_scene(n_cams=3, n_points=80, noise_px=0.3, seed=3)
    n = len(sc["points"])
    monkeypatch.setattr(pl, "pnp_ransac_bucketed", lambda *a, **kw: PnPRansacResult(
        np.eye(3), np.zeros(3), np.zeros(n, bool), np.int64(0)))
    pipe = pl.SfMPipeline(SfMConfig(pnp_iters=1024, pnp_f64_rescue=rescue), device="cpu")
    C, R = pipe.register_camera(3, sc["points"], sc["obs"][2], sc["K"])
    if rescue == "off":
        assert C is None and pipe.stats["pnp_failures"] == {3: 1}
        return
    assert pipe.stats["pnp_rescues"][3] >= 75 and "pnp_failures" not in pipe.stats
    assert np.abs(R - sc["Rs"][2]).max() < 1e-2
    assert np.abs(C - sc["Cs"][2]).max() < 5e-2


def test_per_pair_ransac_matches_batched(ring):
    """--no_ransac_batch_pairs runs the pairs one at a time from the same
    draw stream: the same refined matches and F."""
    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.io.sfm_data import parse_matching_files
    from sfm_nerf_tpu_torch.sfm.pipeline import SfMPipeline

    _, data, _ = ring
    out = {}
    for batched in (True, False):
        m, t, v = parse_matching_files(data, N_CAMS)
        cfg = SfMConfig(data_path=data, num_images=N_CAMS, ransac_iters=256,
                        ransac_batch_pairs=batched)
        out[batched] = SfMPipeline(cfg, device="cpu").refine_all_matches(m, t, v)[0]
    assert sorted(out[True]) == sorted(out[False])
    for pair in out[True]:
        np.testing.assert_array_equal(out[True][pair][1], out[False][pair][1])
        np.testing.assert_allclose(out[True][pair][0], out[False][pair][0], rtol=1e-9,
                                   atol=1e-12)


def test_cli_nerf_trains_on_the_export(ring, torch_run):
    """``cli.nerf --mode train --near auto --far auto`` on the exported
    dataset: a few steps of a narrow network on the CPU, finite losses."""
    from sfm_nerf_tpu_torch.cli.nerf import main

    root, _, _ = ring
    stats = main(["--mode", "train", "--device", "cpu", "--data_path",
                  str(root / "nerf") + "/", "--checkpoint_path", str(root / "ckpt"),
                  "--near", "auto", "--far", "auto", "--hidden_size", "32",
                  "--n_pos_freq", "4", "--n_dirc_freq", "2", "--n_sample", "16",
                  "--n_rays_batch", "64", "--max_iters", "4", "--log_every", "1",
                  "--val_every", "0", "--logs_path", str(root / "logs")])
    losses = [v for _, v in stats["losses"]]
    assert stats["steps"] == 4 and np.isfinite(losses).all()
