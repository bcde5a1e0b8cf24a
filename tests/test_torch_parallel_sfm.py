"""The port's sharded SfM (parallel/ransac.py, parallel/ba.py) against the
JAX package's (tests/test_parallel.py:303, :343) and against its own one
device, on the CPU.

Like the JAX package, one process drives every shard; here the shards are
the CPU repeated (the JAX side: conftest's virtual CPU devices).
RANSAC is fed JAX's own draws (one ``draw_minimal_samples`` per chunk key
of its sharded call) and must give JAX's winner and inliers, with F to
1e-9 at unit norm; over a device count that divides the chunk count it is
bit-equal to the port's one-device call.  BA is held to JAX's sharded BA at
cost rtol 1e-9 and geometry atol 1e-5 (parallel/ba.py:19-27), intrinsics
rtol 1e-7 (:393).  The CLI reconstructs a 6-camera ring (200 points, each
seen by 3 cameras) with 2 shards of each as it does with one device.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_nerf_tpu.ops import epipolar as jep
from sfm_nerf_tpu.parallel import make_mesh as jmake_mesh
from sfm_nerf_tpu.parallel.ba import bundle_adjust_sharded as jba_sharded
from sfm_nerf_tpu.parallel.ransac import ransac_fundamental_sharded as jransac_sharded
from sfm_nerf_tpu_torch.ops import epipolar as tep
from sfm_nerf_tpu_torch.ops.ba import bundle_adjust
from sfm_nerf_tpu_torch.parallel.ba import bundle_adjust_sharded
from sfm_nerf_tpu_torch.parallel.ransac import ransac_fundamental_sharded, sharded_iters
from util_synthetic import make_sfm_scene, write_reference_format_dataset

F_TOL = 1e-9
BA_COST_RTOL, BA_GEOM_ATOL, BA_INTR_RTOL = 1e-9, 1e-5, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor ops: one intra-op thread, as
    tests/test_torch_sfm_pipeline.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_F(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


def _matches(n=256, seed=11):
    """tests/test_parallel.py:313's two views: points on the epipolar lines
    of a known F, 0.3 px noise, 30% outliers."""
    rng = np.random.default_rng(seed)
    F_true = np.array([[0, -1e-4, 2e-2], [1e-4, 0, -3e-2], [-2e-2, 3e-2, 1.0]])
    p1 = rng.uniform(50, 750, (n, 2))
    lines = (F_true @ np.c_[p1, np.ones(n)].T).T
    x2 = rng.uniform(100, 700, n)
    y2 = -(lines[:, 0] * x2 + lines[:, 2]) / np.where(np.abs(lines[:, 1]) < 1e-12, 1e-12,
                                                       lines[:, 1])
    p2 = np.c_[x2, y2] + rng.normal(0, 0.3, (n, 2))
    out = rng.random(n) < 0.3
    p2[out] = rng.uniform(50, 750, (out.sum(), 2))
    return p1, p2


def _jax_sharded_draws(key, n_hyp, chunk, n_pts):
    keys = jax.random.split(key, n_hyp // chunk)
    return np.concatenate([np.asarray(jep.draw_minimal_samples(ck, chunk, 8, n_pts))
                           for ck in keys])


@pytest.mark.parametrize("n_iters", [4096, 3328])
def test_sharded_ransac_matches_jax_on_its_draws(n_iters):
    """4 shards, chunks of 256: 16 chunks (4 divides them) and 13 (rounded
    up to 16 on both sides).  JAX's winner index, inlier set and count; F
    to 1e-9.  Where 4 divides the chunk count the port's one-device call on
    the same samples is bit-equal to the sharded one."""
    p1, p2 = _matches()
    key = jax.random.key(5)
    kw = dict(n_iters=n_iters, threshold=5e-4, chunk=256)
    mesh = jmake_mesh(dp=4, tp=1, devices=jax.devices()[:4])
    rj = jransac_sharded(key, jnp.asarray(p1), jnp.asarray(p2), mesh=mesh, **kw)
    n_hyp = sharded_iters(n_iters, 256, 4)
    assert n_hyp == 4096
    samples = torch.as_tensor(_jax_sharded_draws(key, n_hyp, 256, len(p1)))
    rt = ransac_fundamental_sharded(torch.as_tensor(p1), torch.as_tensor(p2), ["cpu"] * 4,
                                    samples=samples, **kw)
    assert int(rt.best_iter) == int(rj.best_iter)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    assert np.abs(_unit_F(rt.F) - _unit_F(rj.F)).max() < F_TOL
    if n_iters == n_hyp:
        one = tep.ransac_fundamental(torch.as_tensor(p1), torch.as_tensor(p2),
                                     samples=samples, **kw)
        assert int(one.best_iter) == int(rt.best_iter)
        assert torch.equal(one.inliers, rt.inliers) and torch.equal(one.F, rt.F)


def test_sharded_ransac_draws_the_single_device_samples():
    """From a generator: over 2 shards with 4 chunks (a multiple of 2) the
    sharded call draws what the one-device call draws and returns its
    result bit for bit; padded rows (past n_valid) never count."""
    p1, p2 = _matches(n=300, seed=3)
    args = (torch.as_tensor(p1), torch.as_tensor(p2))
    kw = dict(n_iters=4096, chunk=1024, n_valid=256, scoring="count")
    one = tep.ransac_fundamental(*args, generator=torch.Generator().manual_seed(4), **kw)
    two = ransac_fundamental_sharded(*args, ["cpu", "cpu"],
                                     generator=torch.Generator().manual_seed(4), **kw)
    assert int(one.best_iter) == int(two.best_iter)
    assert torch.equal(one.inliers, two.inliers) and torch.equal(one.F, two.F)
    assert not two.inliers[256:].any() and int(two.n_inliers) == int(one.n_inliers)
    with pytest.raises(ValueError, match="hypotheses"):
        ransac_fundamental_sharded(*args, ["cpu"] * 3, samples=torch.zeros(4096, 8).long(),
                                   **kw)


def _ba_problem():
    """tests/test_parallel.py:343's problem with 124 points: 3 shards of
    42 after 2 padded points."""
    scene = make_sfm_scene(n_cams=4, n_points=124, noise_px=0.5, seed=0)
    from sfm_nerf_tpu.ops.ba import camera_params_from_RC

    cams = np.asarray(camera_params_from_RC(jnp.asarray(scene["Rs"]), jnp.asarray(scene["Cs"])))
    rng = np.random.default_rng(1)
    cams_n = cams + rng.normal(scale=0.01, size=cams.shape)
    pts_n = scene["points"] + rng.normal(scale=0.05, size=scene["points"].shape)
    return scene["K"], cams_n, pts_n, scene["obs"], scene["vis"]


@pytest.mark.parametrize("kw", [dict(loss="linear"), dict(loss="huber"),
                                dict(refine_intrinsics="f,k1")])
def test_sharded_ba_matches_jax_and_one_device(kw):
    """Point-sharded BA over 3 shards (124 points: 2 padded), 15 LM steps:
    JAX's sharded BA on a 3-device mesh and the port's one-device BA give
    the same cost (rtol 1e-9), cameras and points (atol 1e-5), residual
    count and intrinsics (rtol 1e-7); the padding is trimmed."""
    K, cams, pts, obs, vis = _ba_problem()
    mesh = jmake_mesh(dp=3, tp=1, devices=jax.devices()[:3])
    rj = jba_sharded(*(jnp.asarray(a) for a in (K, cams, pts, obs, vis)), mesh=mesh,
                     n_iters=15, **kw)
    targs = [torch.as_tensor(np.asarray(a, np.float64)) for a in (K, cams, pts, obs, vis)]
    rt = bundle_adjust_sharded(*targs, ["cpu"] * 3, n_iters=15, **kw)
    r1 = bundle_adjust(*targs, n_iters=15, **kw)
    assert rt.points.shape == (124, 3)
    for ref in (rj, r1):
        assert int(rt.n_residuals) == int(ref.n_residuals)
        np.testing.assert_allclose(float(rt.cost), float(ref.cost), rtol=BA_COST_RTOL)
        np.testing.assert_allclose(rt.camera_params.numpy(), np.asarray(ref.camera_params),
                                   rtol=0, atol=BA_GEOM_ATOL)
        np.testing.assert_allclose(rt.points.numpy(), np.asarray(ref.points), rtol=0,
                                   atol=BA_GEOM_ATOL)
        np.testing.assert_allclose(rt.intrinsics.numpy(), np.asarray(ref.intrinsics),
                                   rtol=BA_INTR_RTOL)
    assert float(rt.cost) < float(rt.initial_cost)


def test_one_block_is_bundle_adjust_bit_for_bit():
    """bundle_adjust_sharded over one device runs the one-device arithmetic:
    every output bit-equal."""
    K, cams, pts, obs, vis = _ba_problem()
    targs = [torch.as_tensor(np.asarray(a, np.float64)) for a in (K, cams, pts, obs, vis)]
    a = bundle_adjust(*targs, n_iters=5, loss="huber")
    b = bundle_adjust_sharded(*targs, ["cpu"], n_iters=5, loss="huber")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_shard_devices_need_distinct_cards():
    """On a card n shards need n visible cards (none here: refused, naming
    the flag); on the CPU the CPU is repeated."""
    from sfm_nerf_tpu_torch.config import SfMConfig
    from sfm_nerf_tpu_torch.sfm.pipeline import SfMPipeline, shard_devices

    assert shard_devices("cpu", 3, "--ba_devices") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="--ransac_devices 2 but only 0 CUDA"):
        shard_devices("cuda", 2, "--ransac_devices")
    with pytest.raises(ValueError, match="--ba_devices 2"):
        SfMPipeline(SfMConfig(ba_devices=2), device="cuda")
    pipe = SfMPipeline(SfMConfig(ransac_devices=2, ba_devices=3), device="cpu")
    assert pipe.ransac_devices == [torch.device("cpu")] * 2
    assert pipe.ba_devices == [torch.device("cpu")] * 3


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_ring")
    data, _ = write_reference_format_dataset(
        str(root / "data"), n_cams=6, n_points=200, noise_px=0.5, seed=0,
        visibility_window=3)
    return root, data


def _cli(root, data, tag, *extra):
    from sfm_nerf_tpu_torch.cli import sfm as cli

    return cli.main(["--data_path", data, "--num_images", "6", "--output_dir",
                     str(root / tag), "--device", "cpu", "--ransac_iters", "2048",
                     "--pnp_iters", "512", "--ba_max_iters", "10", *extra])


def test_cli_with_sharded_ransac_and_ba_reconstructs_as_one_device(ring, capsys):
    """cli.sfm --ransac_devices 2 --ba_devices 2: 2,048 hypotheses are 2
    chunks, so the sharded RANSAC draws the one-device samples, and every
    pair keeps the same inliers; the reconstruction registers the same
    cameras, with the final BA cost within 1e-9 and the poses within 1e-6
    of the one-device run."""
    root, data = ring
    one = _cli(root, data, "one")
    log_one = capsys.readouterr().out
    two = _cli(root, data, "two", "--ransac_devices", "2", "--ba_devices", "2")
    log_two = capsys.readouterr().out
    ransac = [ln for ln in log_one.splitlines() if ln.startswith("RANSAC:")]
    assert ransac and ransac == [ln for ln in log_two.splitlines() if ln.startswith("RANSAC:")]
    assert sorted(two["camera_info"]) == sorted(one["camera_info"]) == list(range(1, 7))
    b1, b2 = one["stats"]["ba"], two["stats"]["ba"]
    np.testing.assert_allclose(b2["final_err_px"]["mean"], b1["final_err_px"]["mean"],
                               rtol=1e-9)
    for c in one["camera_info"]:
        for k in ("R", "C"):
            np.testing.assert_allclose(two["camera_info"][c][k], one["camera_info"][c][k],
                                       rtol=0, atol=1e-6)
    assert os.path.exists(root / "two" / "reconstruction.ply")
