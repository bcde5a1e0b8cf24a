"""The port's five-point solver, adaptive RANSAC drivers and PnP rescue
against the JAX package's, on the same float64 inputs (JAX on the CPU
under the tests' x64 conftest).

Draws are never compared by seed across libraries: the adaptive drivers
are fed the index arrays that JAX's drivers draw under their chunk keys
and must stop at the same count with the same winner, inliers and F (or R
and C) to 1e-10; the 5-point RANSAC and the rescue draw from numpy seed
streams, as JAX's do, so they take the seed.  An adaptive run must be
the fixed run cut at its count.  Last, ``cli.sfm --essential_method 5pt
--ransac_confidence 0.999 --pnp_f64_rescue on`` against the JAX pipeline
on a 6-camera ring, held to tests/test_torch_sfm_pipeline.py's outcome.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_synthetic import make_sfm_scene, write_reference_format_dataset

from sfm_nerf_tpu.ops import epipolar as jep
from sfm_nerf_tpu.ops import essential5 as je5
from sfm_nerf_tpu.ops import pnp as jpnp
from sfm_nerf_tpu_torch.ops import epipolar as tep
from sfm_nerf_tpu_torch.ops import essential5 as te5
from sfm_nerf_tpu_torch.ops import pnp as tpnp

E_TOL = 1e-8           # five-point candidates and the RANSAC's E, up to sign
DRIVER_TOL = 1e-10     # adaptive winners: F (unit norm), R and C
RESCUE_TOL = 1e-9      # the rescue's R and C
CONF = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny tensor ops: one intra-op thread each, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.tensor(np.asarray(a, np.float64))


def J(a):
    return jnp.asarray(np.asarray(a, np.float64))


def unit(F):
    """F at unit Frobenius norm with its largest entry positive."""
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


def jax_draws(key, n_iters, chunk, k, n_pts):
    """The samples JAX's RANSAC drivers score: one draw per chunk key."""
    keys = jax.random.split(key, -(-n_iters // chunk))
    return np.concatenate([np.asarray(jep.draw_minimal_samples(ck, chunk, k, n_pts))
                           for ck in keys])


# ---- five-point ------------------------------------------------------------

def _calibrated_pair(rng, n, noise=0.0, n_out=0, K=None):
    """tests/test_essential5.py's scene: a random relative pose, points 4-8
    in front; pixels through K when given, else normalized coordinates."""
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    Xc2 = X @ R.T + t
    M = np.eye(3) if K is None else K
    p1, p2 = X @ M.T, Xc2 @ M.T
    p1 = p1[:, :2] / p1[:, 2:] + noise * rng.normal(size=(n, 2))
    p2 = p2[:, :2] / p2[:, 2:] + noise * rng.normal(size=(n, 2))
    if n_out:
        p2[:n_out] = rng.uniform(p2.min(), p2.max(), (n_out, 2))
    return p1, p2


def _sign_free(A, B):
    return min(np.abs(A - B).max(), np.abs(A + B).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_five_point_candidates_match_jax(seed):
    """The same finite candidates, up to order and sign."""
    rng = np.random.default_rng(seed)
    p1, p2 = _calibrated_pair(rng, 40, noise=1e-3)
    idx = np.stack([rng.choice(40, 5, replace=False) for _ in range(64)])
    cj = je5.five_point_essential(p1[idx], p2[idx])
    ct = te5.five_point_essential(T(p1[idx]), T(p2[idx])).numpy()
    assert ct.shape == (64, 10, 3, 3)
    fj, ft = np.isfinite(cj[..., 0, 0]), np.isfinite(ct[..., 0, 0])
    np.testing.assert_array_equal(ft.sum(1), fj.sum(1))
    for b in range(64):
        for E in cj[b][fj[b]]:
            assert min(_sign_free(E, Et) for Et in ct[b][ft[b]]) < E_TOL


def _constraint_residual(C):
    """max |det E| and max |2 E Eᵀ E - tr(E Eᵀ) E| over the finite
    candidates (B, 10, 3, 3)."""
    Es = C[np.isfinite(C[..., 0, 0])]
    EEt = Es @ np.swapaxes(Es, -1, -2)
    tr = np.trace(EEt, axis1=-2, axis2=-1)[:, None, None]
    return np.abs(np.linalg.det(Es)).max(), np.abs(2 * EEt @ Es - tr * Es).max()


def _max_gap(cj, ct):
    fj, ft = np.isfinite(cj[..., 0, 0]), np.isfinite(ct[..., 0, 0])
    return max(min(_sign_free(E, Et) for Et in ct[b][ft[b]])
               for b in range(len(cj)) for E in cj[b][fj[b]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_five_point_polish_puts_roots_at_rounding(seed, monkeypatch):
    """Why the port polishes its roots and JAX does not: the null space's
    basis is the LAPACK build's choice, and the action matrix's roots on
    it miss the ten cubics by up to ~5e-9 (seed 1: 6.4e-8 from JAX's
    candidates, above E_TOL).  Two Gauss-Newton steps put the port's
    candidates on the constraints at rounding, tighter than JAX's own, so
    the gap left to JAX is JAX's error.  Prints both gaps (pytest -s)."""
    rng = np.random.default_rng(seed)
    p1, p2 = _calibrated_pair(rng, 40, noise=1e-3)
    idx = np.stack([rng.choice(40, 5, replace=False) for _ in range(64)])
    cj = np.asarray(je5.five_point_essential(p1[idx], p2[idx]))
    polished = te5.five_point_essential(T(p1[idx]), T(p2[idx])).numpy()
    monkeypatch.setattr(te5, "_polish", lambda M, xyz: xyz)
    raw = te5.five_point_essential(T(p1[idx]), T(p2[idx])).numpy()
    det_p, cub_p = _constraint_residual(polished)
    det_r, cub_r = _constraint_residual(raw)
    det_j, cub_j = _constraint_residual(cj)
    print(f"seed {seed}: gap to JAX polished {_max_gap(cj, polished):.3e}, "
          f"unpolished {_max_gap(cj, raw):.3e}; cubic residual polished "
          f"{cub_p:.3e}, unpolished {cub_r:.3e}, JAX {cub_j:.3e}")
    assert det_p < 1e-15 and cub_p < 1e-14
    assert det_p <= det_j and cub_p <= cub_j
    assert det_p < det_r and cub_p < cub_r


def test_five_point_degenerate_sample_gives_nans():
    ct = te5.five_point_essential(torch.zeros(1, 5, 2, dtype=torch.float64),
                                  torch.zeros(1, 5, 2, dtype=torch.float64))
    assert ct.shape == (1, 10, 3, 3) and torch.isnan(ct).all()
    cj = je5.five_point_essential(np.zeros((1, 5, 2)), np.zeros((1, 5, 2)))
    assert np.isnan(cj).all()


def test_ransac_essential_5pt_matches_jax():
    """tests/test_essential5.py's noisy scene with 40% outliers, the same
    seed: the same inliers, E up to sign."""
    rng = np.random.default_rng(1)
    K = np.array([[530.0, 0, 320], [0, 530.0, 240], [0, 0, 1]])
    p1, p2 = _calibrated_pair(rng, 500, noise=0.5, n_out=200, K=K)
    Ej, inl_j = je5.ransac_essential_5pt(p1, p2, K, n_iters=300, threshold_px=2.0, seed=3)
    Et, inl_t = te5.ransac_essential_5pt(p1, p2, K, n_iters=300, threshold_px=2.0, seed=3)
    np.testing.assert_array_equal(inl_t.numpy(), inl_j)
    assert _sign_free(Et.numpy(), Ej) < E_TOL
    assert inl_t[200:].numpy().mean() > 0.97 and inl_t[:200].numpy().mean() < 0.05


# ---- adaptive drivers ------------------------------------------------------

def _two_view(n, outlier_frac, seed):
    sc = make_sfm_scene(n_cams=2, n_points=n, noise_px=0.5, seed=seed)
    p1, p2 = sc["obs"][0].copy(), sc["obs"][1].copy()
    rng = np.random.default_rng(seed + 100)
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    p2[out] = rng.uniform([0, 0], [800, 600], (len(out), 2))
    return p1, p2


def _f_bound(p1, p2, sample, n, chunk=1024):
    """The confidence bound of one F hypothesis, as adaptive_drive computes it:
    the inlier count of its Jacobi-solved F on the normalized rows."""
    T1, T2, q1, q2, h1, h2 = tep._ransac_prep(T(p1)[None], T(p2)[None], True, None)
    idx = torch.as_tensor(sample)[None, None]
    F = tep.eight_point_fast(tep._take_rows(q1, idx), tep._take_rows(q2, idx))
    _, _, cnt = tep._chunk_best(*tep._score_F(F, h1, h2, None, 5e-4, "msac"), 5e-4)
    return jep.adaptive_trials_needed(int(cnt[0]), n, 8, CONF)


def _same_count(used_t, used_j, bound, chunk):
    """The same count, or one chunk apart where JAX's bound lies within
    1e-9 relative of a chunk boundary (libm may round it either side)."""
    if used_t == used_j:
        return True
    k = round(bound / chunk)
    return abs(used_t - used_j) == chunk and abs(bound - k * chunk) <= 1e-9 * bound


@pytest.mark.parametrize("outlier_frac", [0.2, 0.5])
def test_adaptive_f_ransac_matches_jax(outlier_frac):
    p1, p2 = _two_view(300, outlier_frac, seed=1)
    key = jax.random.key(7)
    cap, chunk = 16384, 1024
    rj, used_j = jep.ransac_fundamental_adaptive(key, J(p1), J(p2), confidence=CONF,
                                                 max_iters=cap, chunk=chunk)
    samples = torch.as_tensor(jax_draws(key, cap, chunk, 8, 300))
    rh, used_h = tep.ransac_fundamental_adaptive(
        T(p1), T(p2), confidence=CONF, max_iters=cap, chunk=chunk, samples=samples)
    # against JAX on its own draws
    bound = _f_bound(p1, p2, samples[int(rj.best_iter)].numpy(), 300)
    assert _same_count(used_h, int(used_j), bound, chunk), (used_h, used_j, bound)
    assert int(rh.best_iter) == int(rj.best_iter)
    np.testing.assert_array_equal(rh.inliers.numpy(), np.asarray(rj.inliers))
    assert np.abs(unit(rh.F) - unit(rj.F)).max() < DRIVER_TOL
    assert 2 * chunk <= used_h < cap
    # the prefix property: the fixed run on the same draws cut at the count
    rf = tep.ransac_fundamental(T(p1), T(p2), n_iters=used_h, chunk=chunk,
                                samples=samples[:used_h])
    assert int(rf.best_iter) == int(rh.best_iter)
    np.testing.assert_array_equal(rf.inliers.numpy(), rh.inliers.numpy())
    assert np.abs(unit(rf.F) - unit(rh.F)).max() < DRIVER_TOL


def test_adaptive_pairs_driver_matches_jax():
    """Three pairs of different sizes and outlier shares, padded to 256 rows:
    the stage stops on the slowest pair, each pair's winner is JAX's."""
    cap, chunk, B = 16384, 1024, 256
    items = [_two_view(n, f, seed) for n, f, seed in ((200, 0.2, 2), (256, 0.5, 3),
                                                      (120, 0.35, 4))]
    nv = [len(a) for a, _ in items]
    keys = jax.random.split(jax.random.key(5), 3)
    p1 = np.zeros((3, B, 2))
    p2 = np.zeros((3, B, 2))
    for m, (a, b) in enumerate(items):
        p1[m, :len(a)], p2[m, :len(b)] = a, b
    rj, used_j = jep.ransac_fundamental_pairs_adaptive(
        keys, J(p1), J(p2), np.asarray(nv), confidence=CONF, max_iters=cap, chunk=chunk)
    samples = torch.stack([torch.as_tensor(jax_draws(keys[m], cap, chunk, 8, nv[m]))
                           for m in range(3)])
    rh, used_h = tep.ransac_fundamental_pairs_adaptive(
        T(p1), T(p2), samples, torch.as_tensor(nv), confidence=CONF, max_iters=cap,
        chunk=chunk)
    bound = max(_f_bound(a, b, samples[m, int(rj.best_iter[m])].numpy(), nv[m])
                for m, (a, b) in enumerate(items))
    assert _same_count(used_h, int(used_j), bound, chunk), (used_h, used_j, bound)
    np.testing.assert_array_equal(rh.best_iter.numpy(), np.asarray(rj.best_iter))
    np.testing.assert_array_equal(rh.inliers.numpy(), np.asarray(rj.inliers))
    for m in range(3):
        assert np.abs(unit(rh.F[m]) - unit(rj.F[m])).max() < DRIVER_TOL
    # the bucketed wrapper: one count per item, in input order
    iters = []
    res = tep.ransac_fundamental_pairs_bucketed(
        items, n_iters=cap, chunk=chunk, samples=list(samples), confidence=CONF,
        iters_out=iters)
    assert iters == [used_h] * 3
    for m, r in enumerate(res):
        np.testing.assert_array_equal(r.inliers, rh.inliers[m, :nv[m]].numpy())


def test_adaptive_pnp_matches_jax():
    sc = make_sfm_scene(n_cams=3, n_points=150, noise_px=0.5, seed=2)
    X, x = sc["points"], sc["obs"][2].copy()
    rng = np.random.default_rng(2)
    out_idx = rng.choice(150, 60, replace=False)
    x[out_idx] = rng.uniform([0, 0], [800, 600], (60, 2))
    K = sc["K"]
    key = jax.random.key(11)
    cap, chunk = 8192, 512
    rj, used_j = jpnp.pnp_ransac_adaptive(key, J(X), J(x), J(K), confidence=CONF,
                                          max_iters=cap, chunk=chunk)
    samples = torch.as_tensor(jax_draws(key, cap, chunk, 6, 150))
    rh, used_h = tpnp.pnp_ransac_adaptive(T(X), T(x), T(K), confidence=CONF, max_iters=cap,
                                          chunk=chunk, samples=samples)
    assert used_h == int(used_j), (used_h, used_j)
    np.testing.assert_array_equal(rh.inliers.numpy(), np.asarray(rj.inliers))
    assert np.abs(rh.R.numpy() - np.asarray(rj.R)).max() < DRIVER_TOL
    assert np.abs(rh.C.numpy() - np.asarray(rj.C)).max() < DRIVER_TOL
    assert 2 * chunk <= used_h < cap
    rf = tpnp.pnp_ransac(T(X), T(x), T(K), n_iters=used_h, chunk=chunk,
                         samples=samples[:used_h])
    np.testing.assert_array_equal(rf.inliers.numpy(), rh.inliers.numpy())
    assert np.abs(rf.C.numpy() - rh.C.numpy()).max() < DRIVER_TOL


@pytest.mark.parametrize("device,solves", [("cuda", [8192, 2048]), ("cpu", [1024] * 10)])
def test_block_solver_solves_whole_blocks_on_a_card(device, solves):
    """On a card the adaptive drivers solve a block of SOLVE_BLOCK rows at
    a time (one launch sequence, as the fixed drivers), on the CPU one
    chunk; each chunk's hypotheses are the same either way.  The device
    is only named: the rows stay on the CPU."""
    samples = torch.arange(10240 * 2, dtype=torch.float64).reshape(10240, 2)
    calls = []

    def solve(rows):
        calls.append(rows.shape[0])
        return rows * 2.0, rows + 1.0

    chunk_hyps = tep.block_solver(solve, samples, 1024, device)
    for c in range(10):
        a, b = chunk_hyps(c)
        assert torch.equal(a, samples[c * 1024:(c + 1) * 1024] * 2.0)
        assert torch.equal(b, samples[c * 1024:(c + 1) * 1024] + 1.0)
    assert calls == solves


def test_adaptive_trials_needed_matches_jax():
    for cnt, n, k in ((0, 100, 8), (50, 100, 8), (99, 100, 6), (100, 100, 8), (7, 300, 6)):
        hj = jep.adaptive_trials_needed(cnt, n, k, CONF)
        assert tep.adaptive_trials_needed(cnt, n, k, CONF) == hj
        dj = float(jep._adaptive_trials_needed_device(
            jnp.asarray(cnt), jnp.asarray(n), CONF, jnp.float64, sample_size=k))
        dt = float(tep._adaptive_trials_needed_device(
            torch.tensor([cnt]), torch.tensor([n]), CONF, k)[0])
        assert dt == dj or abs(dt - dj) <= 1e-15 * abs(dj), (dt, dj)


# ---- the PnP rescue --------------------------------------------------------

def _rescue_problem():
    sc = make_sfm_scene(n_cams=3, n_points=120, noise_px=0.5, seed=8)
    X, x = sc["points"], sc["obs"][1].copy()
    rng = np.random.default_rng(8)
    bad = rng.choice(120, 30, replace=False)
    x[bad] = rng.uniform([0, 0], [800, 600], (30, 2))
    return sc["K"], X, x


def test_pnp_rescue_matches_jax():
    """The same seed: the same samples chunk by chunk (the rows of JAX's
    one draw), the same inliers, R and C."""
    K, X, x = _rescue_problem()
    for scoring in ("msac", "count"):
        rj = jpnp.pnp_ransac_f64_host(1234, X, x, K, n_iters=3000, scoring=scoring)
        rt = tpnp.pnp_ransac_f64_host(1234, X, x, K, n_iters=3000, scoring=scoring,
                                      chunk=1024)
        np.testing.assert_array_equal(rt.inliers, np.asarray(rj.inliers))
        assert int(rt.n_inliers) == int(rj.n_inliers) >= 85
        assert np.abs(rt.R - np.asarray(rj.R)).max() < RESCUE_TOL
        assert np.abs(rt.C - np.asarray(rj.C)).max() < RESCUE_TOL
    rt = tpnp.pnp_ransac_f64_host(0, X[:5], x[:5], K)
    assert int(rt.n_inliers) == 0 and rt.inliers.shape == (5,)


def test_pnp_rescue_zero_depth_point_is_an_outlier():
    """The departure from JAX: a point at the winner's centre (zero depth)
    observed near pixel (0, 0) projects, in JAX, to (0, 0) at a finite
    error and counts as an inlier; in the port it scores +inf.  Each side's
    point sits at its own winner's centre, found by a first run on the same
    draws (the placeholder is a gross outlier either way)."""
    K, X, x = _rescue_problem()
    X = np.concatenate([X, [[9.0, 9.0, 30.0]]])
    x = np.concatenate([x, [[0.5, 0.5]]])
    for lib, fn in (("jax", jpnp.pnp_ransac_f64_host), ("port", tpnp.pnp_ransac_f64_host)):
        first = fn(77, X, x, K, n_iters=2000)
        X2 = X.copy()
        X2[-1] = np.asarray(first.C)
        again = fn(77, X2, x, K, n_iters=2000)
        np.testing.assert_array_equal(np.asarray(again.C), np.asarray(first.C))
        assert bool(np.asarray(again.inliers)[-1]) == (lib == "jax"), lib
        np.testing.assert_array_equal(np.asarray(again.inliers)[:-1],
                                      np.asarray(first.inliers)[:-1])


# ---- the pipeline ----------------------------------------------------------

N_CAMS = 6
RANSAC_CAP = 1024


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX SfMPipeline and ``cli.sfm --device cpu`` with the 5-point
    two-view init, adaptive RANSAC (1,024 F and PnP hypotheses as caps: one
    chunk, so the route runs and stops at the cap; the early stop is held
    above and in tests/test_torch_sfm_pipeline.py) and the rescue on, on
    one 6-camera ring."""
    from sfm_nerf_tpu.config import SfMConfig
    from sfm_nerf_tpu.sfm import SfMPipeline
    from sfm_nerf_tpu_torch.cli import sfm as cli

    root = tmp_path_factory.mktemp("sfm_adaptive")
    data, _ = write_reference_format_dataset(
        str(root / "data"), n_cams=N_CAMS, n_points=400, noise_px=0.5, seed=0,
        visibility_window=4)
    os.makedirs(root / "jax", exist_ok=True)
    jax_res = SfMPipeline(SfMConfig(
        data_path=data, num_images=N_CAMS, output_dir=str(root / "jax"),
        ransac_iters=RANSAC_CAP, pnp_iters=1024, ba_max_iters=20, merge_tracks=True,
        essential_method="5pt", ransac_confidence=0.999, pnp_f64_rescue="on")).run()
    torch_res = cli.main([
        "--data_path", data, "--num_images", str(N_CAMS), "--output_dir",
        str(root / "torch"), "--device", "cpu", "--ransac_iters", str(RANSAC_CAP),
        "--pnp_iters", "1024", "--ba_max_iters", "20", "--merge_tracks",
        "--essential_method", "5pt", "--ransac_confidence", "0.999",
        "--pnp_f64_rescue", "on"])
    return jax_res, torch_res


def test_5pt_adaptive_rescue_pipeline_matches_jax(runs):
    jr, tr = runs
    sj, st = jr["stats"], tr["stats"]
    assert sorted(tr["camera_info"]) == sorted(jr["camera_info"])
    assert st["n_registered"] == N_CAMS and st["device"] == "cpu"
    ej, et = sj["ba"]["final_err_px"]["mean"], st["ba"]["final_err_px"]["mean"]
    assert et < 1.0 and abs(et - ej) <= 0.05 * ej, (et, ej)
    R1j = np.asarray(jr["camera_info"][1]["R"])
    R1t = np.asarray(tr["camera_info"][1]["R"])
    for c in jr["camera_info"]:
        A = np.asarray(tr["camera_info"][c]["R"]) @ R1t.T
        B = np.asarray(jr["camera_info"][c]["R"]) @ R1j.T
        deg = np.degrees(np.arccos(np.clip((np.trace(A.T @ B) - 1) / 2, -1, 1)))
        assert deg < 0.05, (c, deg)
    # every pair went through the adaptive driver
    assert st["ransac_iters_scored"] == [RANSAC_CAP] * 15
