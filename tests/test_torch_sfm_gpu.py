"""The port's Phase 1 on a card against the same calls on the CPU.

Imports torch and the port only (no jax), so it runs on a machine without
JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sfm_gpu.py -m gpu

Without a card every test here skips.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.join(os.path.dirname(__file__), "..")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _two_view(n=400, outlier_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[800.0, 0, 400], [0, 800.0, 300], [0, 0, 1]])
    X = rng.uniform([-1.5, -1.5, 4.0], [1.5, 1.5, 8.0], (n, 3))
    c, s = np.cos(0.2), np.sin(0.2)
    R2 = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    C2 = np.array([1.0, 0.1, -0.2])
    x1 = X @ K.T
    x1 = x1[:, :2] / x1[:, 2:]
    x2 = (X - C2) @ R2.T @ K.T
    x2 = x2[:, :2] / x2[:, 2:]
    x1 += rng.normal(0, 0.5, x1.shape)
    x2 += rng.normal(0, 0.5, x2.shape)
    bad = rng.random(n) < outlier_frac
    x2[bad] = rng.uniform([0, 0], [800, 600], (int(bad.sum()), 2))
    return K, X, x1, x2, R2, C2


@pytest.mark.gpu
def test_ransac_and_pnp_on_the_card_match_the_cpu():
    """The same sample indices on both devices: the same winner, inlier set
    and F to 1e-8 (F-RANSAC); the same inliers and pose (PnP RANSAC); and
    a later copy of a winning sample never wins (first-index ties)."""
    _need_card()
    from sfm_nerf_tpu_torch.ops import epipolar as ep
    from sfm_nerf_tpu_torch.ops import pnp

    K, X, x1, x2, R2, C2 = _two_view()
    rng = np.random.default_rng(1)
    samples = np.stack([rng.choice(len(x1), 8, replace=False) for _ in range(4096)])
    out = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(a, device=dev)
        r = ep.ransac_fundamental(t(x1), t(x2), n_iters=4096, samples=t(samples))
        out[dev] = [v.cpu().numpy() for v in r]
    assert int(out["cuda"][3]) == int(out["cpu"][3])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= 1e-8 * np.abs(out["cpu"][0]).max()
    dup = samples.copy()
    dup[-1] = dup[int(out["cpu"][3])]
    r = ep.ransac_fundamental(torch.as_tensor(x1, device="cuda"),
                              torch.as_tensor(x2, device="cuda"), n_iters=4096,
                              samples=torch.as_tensor(dup, device="cuda"))
    assert int(r.best_iter) == int(out["cpu"][3])

    psamp = np.stack([rng.choice(len(X), 6, replace=False) for _ in range(2048)])
    pout = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(a, device=dev)
        r = pnp.pnp_ransac(t(X), t(x2), t(K), samples=t(psamp))
        pout[dev] = [v.cpu().numpy() for v in r]
    np.testing.assert_array_equal(pout["cuda"][2], pout["cpu"][2])
    np.testing.assert_allclose(pout["cuda"][0], pout["cpu"][0], atol=1e-9)
    np.testing.assert_allclose(pout["cuda"][1], pout["cpu"][1], atol=1e-8)
    np.testing.assert_allclose(pout["cuda"][0], R2, atol=1e-2)


@pytest.mark.gpu
def test_cli_sfm_on_the_card(tmp_path):
    """cli.sfm on cuda (its default) on a small ring written without cv2:
    every camera registers, sub-pixel BA, the NeRF export reads back."""
    _need_card()
    sys.path.insert(0, os.path.abspath(REPO))
    from chip_smoke import pose_errors, write_sfm_dataset

    from sfm_nerf_tpu_torch.cli import sfm as cli
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset

    data = str(tmp_path / "data")
    gt = write_sfm_dataset(data, 8, 1200, 4)
    res = cli.main(["--data_path", data, "--num_images", "8", "--output_dir",
                    str(tmp_path / "out"), "--merge_tracks", "--ransac_iters", "4096",
                    "--pnp_iters", "2048", "--export_nerf", str(tmp_path / "nerf")])
    st = res["stats"]
    assert st["device"] == "cuda" and st["n_registered"] == 8
    assert st["ba"]["final_err_px"]["mean"] < 1.0
    assert pose_errors(res["camera_info"], gt)["rot_err_deg_median"] < 0.1
    images, _, _ = load_blender_dataset(str(tmp_path / "nerf"), "train")
    assert len(images) == 8
