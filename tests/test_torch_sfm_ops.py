"""The port's Phase 1 ops against the JAX package's, on the same float64
inputs (the conftest runs JAX on the CPU with x64 on).

Random draws are never compared by seed: the RANSAC tests feed the port
the very index arrays that JAX's ``draw_minimal_samples`` gives under the
chunk keys its RANSAC splits, and then require the same winner, the same
inlier set and F to 1e-9.  Everything else is held to 1e-9 (closed forms)
or 1e-7 relative (iterative solvers after the same trip count).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_synthetic import make_sfm_scene, write_reference_format_dataset

from sfm_nerf_tpu.ops import ba as jba
from sfm_nerf_tpu.ops import epipolar as jep
from sfm_nerf_tpu.ops import linalg as jla
from sfm_nerf_tpu.ops import lm as jlm
from sfm_nerf_tpu.ops import pnp as jpnp
from sfm_nerf_tpu.ops import triangulation as jtri
from sfm_nerf_tpu_torch.ops import ba as tba
from sfm_nerf_tpu_torch.ops import epipolar as tep
from sfm_nerf_tpu_torch.ops import linalg as tla
from sfm_nerf_tpu_torch.ops import lm as tlm
from sfm_nerf_tpu_torch.ops import pnp as tpnp
from sfm_nerf_tpu_torch.ops import triangulation as ttri

CLOSED_TOL = 1e-9      # closed forms and the RANSAC winner's F
SOLVER_TOL = 1e-7      # LM / BA parameters and costs, relative


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The SfM ops are thousands of tiny tensor ops: one intra-op thread
    each, so that the suite's parallel workers do not oversubscribe the
    machine's cores (measured: ten times slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.tensor(np.asarray(a, np.float64))


def J(a):
    return jnp.asarray(np.asarray(a, np.float64))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def unit_F(F):
    """F at unit Frobenius norm with its largest entry positive."""
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


def two_view(n=300, outlier_frac=0.2, noise=0.5, seed=1):
    sc = make_sfm_scene(n_cams=2, n_points=n, noise_px=noise, seed=seed)
    p1, p2 = sc["obs"][0].copy(), sc["obs"][1].copy()
    rng = np.random.default_rng(seed + 100)
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    p2[out] = rng.uniform([0, 0], [800, 600], (len(out), 2))
    return sc, p1, p2


def jax_draws(key, n_iters, chunk, k, n_pts):
    """The samples JAX's fixed RANSAC scores: one draw per chunk key."""
    keys = jax.random.split(key, -(-n_iters // chunk))
    return np.concatenate([np.asarray(jep.draw_minimal_samples(ck, chunk, k, n_pts))
                           for ck in keys])


# ---- the minimal-sample draw -----------------------------------------------

def test_draw_minimal_samples_duplicate_free_and_valid_only():
    g = torch.Generator().manual_seed(0)
    n_valid, k = 11, 8
    idx = tep.draw_minimal_samples(4096, k, n_valid, g).numpy()
    assert idx.shape == (4096, k)
    assert (idx >= 0).all() and (idx < n_valid).all()
    assert all(len(set(row.tolist())) == k for row in idx)
    counts = np.bincount(idx.reshape(-1), minlength=n_valid)
    expected = idx.size / n_valid
    assert (np.abs(counts - expected) < 0.1 * expected).all(), counts


def test_draw_minimal_samples_permutation_uniform():
    """Uniform over ordered 3-of-8 tuples: chi-square over 336 cells
    (dof 335, sd ~26; 500 is ~6 sigma)."""
    from collections import Counter

    g = torch.Generator().manual_seed(42)
    n_draws, n = 120000, 8
    idx = tep.draw_minimal_samples(n_draws, 3, n, g).numpy()
    tuples = Counter(map(tuple, idx.tolist()))
    n_cells = n * (n - 1) * (n - 2)
    assert len(tuples) == n_cells
    expected = n_draws / n_cells
    chi2 = sum((c - expected) ** 2 / expected for c in tuples.values())
    assert chi2 < 500, chi2


# ---- linear algebra --------------------------------------------------------

@pytest.mark.parametrize("n,sweeps", [(3, 6), (4, 10), (9, 10), (12, 10)])
def test_jacobi_eigh_small_matches_jax(n, sweeps):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(64, n, n))
    M = M @ M.transpose(0, 2, 1)
    ej, Vj = jla.jacobi_eigh_small(J(M), sweeps=sweeps)
    et, Vt = tla.jacobi_eigh_small(T(M), sweeps=sweeps)
    assert rel(et, ej) < CLOSED_TOL
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=CLOSED_TOL)
    # and it is an eigendecomposition
    recon = Vt @ torch.diag_embed(et) @ Vt.transpose(-1, -2)
    assert rel(recon, M) < 1e-7


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(0)
    rv = rng.normal(size=(32, 3))
    rv[0] = [np.pi - 1e-8, 0.0, 0.0]          # the near-pi branch
    rv[1] = [1e-9, 0.0, 0.0]                  # the small-angle branch
    Rj = jla.rodrigues(J(rv))
    Rt = tla.rodrigues(T(rv))
    assert rel(Rt, Rj) < CLOSED_TOL
    assert rel(tla.rotation_to_rvec(Rt), jla.rotation_to_rvec(Rj)) < 1e-7
    for R in np.asarray(Rj)[:8]:
        qj = jla.matrix_to_quat(J(R))
        qt = tla.matrix_to_quat(T(R))
        assert rel(qt, qj) < CLOSED_TOL
        assert rel(tla.quat_to_matrix(qt), jla.quat_to_matrix(qj)) < CLOSED_TOL


# ---- epipolar --------------------------------------------------------------

def test_eight_point_and_sampson_match_jax():
    _, p1, p2 = two_view(outlier_frac=0.0)
    rng = np.random.default_rng(3)
    sets = np.stack([rng.choice(300, 8, replace=False) for _ in range(16)])
    Fj = jep.eight_point_fast(J(p1[sets]), J(p2[sets]))
    Ft = tep.eight_point_fast(T(p1[sets]), T(p2[sets]))
    assert rel(Ft, Fj) < 1e-8
    Fj1 = jep.eight_point(J(p1), J(p2))
    Ft1 = tep.eight_point(T(p1), T(p2))
    assert np.abs(unit_F(Ft1) - unit_F(Fj1)).max() < CLOSED_TOL
    h1 = np.concatenate([p1, np.ones((300, 1))], 1)
    h2 = np.concatenate([p2, np.ones((300, 1))], 1)
    dj = jep.sampson_distance(Fj, J(h1), J(h2))
    dt = tep.sampson_distance(Ft, T(h1), T(h2))
    assert rel(dt, dj) < 1e-8


def test_ransac_fundamental_same_winner_as_jax():
    _, p1, p2 = two_view(n=300, outlier_frac=0.2)
    key = jax.random.key(7)
    n_iters, chunk = 2048, 1024
    rj = jep.ransac_fundamental(key, J(p1), J(p2), n_iters=n_iters, chunk=chunk)
    samples = jax_draws(key, n_iters, chunk, 8, 300)
    rt = tep.ransac_fundamental(T(p1), T(p2), n_iters=n_iters, chunk=chunk,
                                samples=torch.as_tensor(samples))
    assert int(rt.best_iter) == int(rj.best_iter)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    assert np.abs(unit_F(rt.F) - unit_F(rj.F)).max() < CLOSED_TOL
    assert 220 <= int(rt.n_inliers) <= 260          # the 240 true inliers


@pytest.mark.parametrize("scoring", ["msac", "count"])
def test_ransac_pairs_equal_single_pair(scoring):
    """Three pairs of different sizes in one batched launch: each is its own
    single-pair result (same winner, inliers, F)."""
    rng = np.random.default_rng(5)
    items, samples = [], []
    for n, seed in ((300, 1), (120, 2), (210, 3)):
        _, p1, p2 = two_view(n=n, outlier_frac=0.25, seed=seed)
        items.append((p1, p2))
        samples.append(torch.as_tensor(
            np.stack([rng.choice(n, 8, replace=False) for _ in range(512)])))
    batched = tep.ransac_fundamental_pairs_bucketed(
        items, n_iters=512, chunk=256, scoring=scoring, samples=samples)
    for (p1, p2), s, res in zip(items, samples, batched):
        ref = tep.ransac_fundamental(T(p1), T(p2), n_iters=512, chunk=256,
                                     scoring=scoring, samples=s)
        assert int(res.best_iter) == int(ref.best_iter)
        np.testing.assert_array_equal(res.inliers, ref.inliers.numpy())
        assert np.abs(unit_F(res.F) - unit_F(ref.F)).max() < CLOSED_TOL


def test_launch_groups_hold_the_memory_cap():
    sizes = [100, 5000, 800, 1024, 3000, 70] + [900] * 70
    groups = tep.launch_groups(sizes, max_pairs_per_launch=64)
    assert sorted(m for g in groups for m in g) == list(range(len(sizes)))
    for g in groups:
        width = max(max(sizes[m] for m in g), 1024)
        assert len(g) * width <= 64 * 1024 or len(g) == 1


def _pose_pair():
    sc = make_sfm_scene(n_cams=2, n_points=120, noise_px=0.3, seed=4)
    K = sc["K"]
    # camera 1 at the identity: express the scene in its frame
    R0, C0 = sc["Rs"][0], sc["Cs"][0]
    R2 = sc["Rs"][1] @ R0.T
    C2 = R0 @ (sc["Cs"][1] - C0)
    return sc, K, R2, C2


def test_decompose_essential_and_disambiguate_match_jax():
    sc, K, R2, C2 = _pose_pair()
    p1, p2 = sc["obs"][0], sc["obs"][1]
    F = jep.eight_point(J(p1), J(p2))
    for convention in ("hz", "reference"):
        Ej = jep.cleanup_essential(jep.essential_from_fundamental(J(K), F))
        Et = tep.cleanup_essential(tep.essential_from_fundamental(T(K), T(F)))
        assert rel(Et, Ej) < 1e-8
        Csj, Rsj = jep.decompose_essential(Ej, convention)
        Cst, Rst = tep.decompose_essential(Et, convention)
        # the four candidates as a set (SVD signs are the library's choice)
        for c, r in zip(np.asarray(Csj), np.asarray(Rsj)):
            d = [np.abs(Cst[k].numpy() - c).max() + np.abs(Rst[k].numpy() - r).max()
                 for k in range(4)]
            assert min(d) < 1e-8, d
        Xj, Cj, Rj, _, _ = jtri.disambiguate_pose(J(K), Csj, Rsj, J(p1), J(p2))
        Xt, Ct, Rt, _, _ = ttri.disambiguate_pose(T(K), Cst, Rst, T(p1), T(p2))
        assert np.abs(Rt.numpy() - np.asarray(Rj)).max() < 1e-8
        assert np.abs(Ct.numpy() - np.asarray(Cj)).max() < 1e-8
        assert rel(Xt, Xj) < 1e-7
    # near the true relative rotation (an 8-point F on noisy matches)
    assert np.abs(Rt.numpy() - R2).max() < 5e-2


# ---- triangulation ---------------------------------------------------------

def test_triangulation_matches_jax():
    sc, K, R2, C2 = _pose_pair()
    p1, p2 = sc["obs"][0], sc["obs"][1]
    R1, C1 = np.eye(3), np.zeros(3)
    T2 = -R2 @ C2
    Xj = jtri.triangulate_linear(J(K), J(R1), J(C1), J(R2), J(T2), J(p1), J(p2))
    Xt = ttri.triangulate_linear(T(K), T(R1), T(C1), T(R2), T(T2), T(p1), T(p2))
    assert rel(Xt, Xj) < 1e-8
    Mj = jtri.triangulate_midpoint(J(K), J(R1), J(C1), J(R2), J(C2), J(p1), J(p2))
    Mt = ttri.triangulate_midpoint(T(K), T(R1), T(C1), T(R2), T(C2), T(p1), T(p2))
    assert rel(Mt, Mj) < CLOSED_TOL
    lin_j, opt_j = jtri.triangulate_pair_bucketed(K, R1, C1, R2, C2, p1, p2, n_iters=20)
    lin_t, opt_t = ttri.triangulate_pair_bucketed(K, R1, C1, R2, C2, p1, p2, n_iters=20)
    assert rel(lin_t, lin_j) < 1e-8
    assert rel(opt_t, opt_j) < SOLVER_TOL
    e = jtri.reprojection_errors(J(K), J(R2), J(C2), J(opt_j), J(p2))
    et = ttri.reprojection_errors(T(K), T(R2), T(C2), T(opt_t), T(p2))
    assert rel(et, e) < 1e-6


def test_levenberg_marquardt_matches_jax():
    """A batch of independent curve fits: y = a exp(b t) + c."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 12)
    truth = rng.uniform([0.5, -1.0, -0.2], [2.0, 1.0, 0.2], (8, 3))
    y = truth[:, :1] * np.exp(truth[:, 1:2] * t) + truth[:, 2:3] \
        + rng.normal(0, 1e-3, (8, 12))
    x0 = truth + rng.normal(0, 0.2, truth.shape)

    def jfit(x, yy):
        return jlm.levenberg_marquardt(
            lambda p: p[0] * jnp.exp(p[1] * J(t)) + p[2] - yy, x, n_iters=15)
    xj, c0j, cj = jax.vmap(jfit)(J(x0), J(y))
    tt = T(t)
    xt, c0t, ct = tlm.levenberg_marquardt(
        lambda p, yy: p[0] * torch.exp(p[1] * tt) + p[2] - yy, T(x0), T(y), n_iters=15)
    assert rel(xt, xj) < SOLVER_TOL
    assert rel(c0t, c0j) < SOLVER_TOL
    assert rel(ct, cj) < SOLVER_TOL


# ---- PnP -------------------------------------------------------------------

def _pnp_problem(n=150, outlier_frac=0.2, seed=2):
    sc = make_sfm_scene(n_cams=3, n_points=n, noise_px=0.5, seed=seed)
    x2 = sc["obs"][2].copy()
    rng = np.random.default_rng(seed)
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    x2[out] = rng.uniform([0, 0], [800, 600], (len(out), 2))
    return sc, sc["points"], x2


def test_linear_pnp_matches_jax():
    sc, X, x = _pnp_problem(outlier_frac=0.0)
    rng = np.random.default_rng(1)
    sets = np.stack([rng.choice(150, 6, replace=False) for _ in range(16)])
    Cj, Rj = jpnp.linear_pnp_fast(J(X[sets]), J(x[sets]), J(sc["K"]))
    Ct, Rt = tpnp.linear_pnp_fast(T(X[sets]), T(x[sets]), T(sc["K"]))
    assert rel(Ct, Cj) < 1e-7 and rel(Rt, Rj) < 1e-7
    Cj, Rj = jpnp.linear_pnp(J(X), J(x), J(sc["K"]))
    Ct, Rt = tpnp.linear_pnp(T(X), T(x), T(sc["K"]))
    assert rel(Ct, Cj) < CLOSED_TOL and rel(Rt, Rj) < CLOSED_TOL


def test_pnp_ransac_same_winner_as_jax_and_nonlinear_pnp():
    sc, X, x = _pnp_problem()
    K = sc["K"]
    key = jax.random.key(11)
    rj = jpnp.pnp_ransac(key, J(X), J(x), J(K), n_iters=1024, chunk=512)
    samples = jax_draws(key, 1024, 512, 6, len(X))
    rt = tpnp.pnp_ransac(T(X), T(x), T(K), n_iters=1024, chunk=512,
                         samples=torch.as_tensor(samples))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert rel(rt.R, rj.R) < CLOSED_TOL and rel(rt.C, rj.C) < CLOSED_TOL
    w = np.asarray(rj.inliers, np.float64)
    Cj, Rj, rms_j = jpnp.nonlinear_pnp(J(K), rj.R, rj.C, J(X), J(x), weights=J(w),
                                       n_iters=50)
    Ct, Rt, rms_t = tpnp.nonlinear_pnp(T(K), rt.R, rt.C, T(X), T(x), weights=T(w),
                                       n_iters=50)
    assert rel(Ct, Cj) < SOLVER_TOL and rel(Rt, Rj) < SOLVER_TOL
    assert abs(float(rms_t) - float(rms_j)) <= SOLVER_TOL * float(rms_j)
    assert np.abs(Rt.numpy() - sc["Rs"][2]).max() < 1e-2
    mj = jpnp.reprojection_error_mean_px(J(K), Rj, Cj, J(X), J(x), J(w))
    mt = tpnp.reprojection_error_mean_px(T(K), Rt, Ct, T(X), T(x), T(w))
    assert abs(float(mt) - float(mj)) < 1e-6


# ---- bundle adjustment -----------------------------------------------------

def _ba_problem(seed=0):
    sc = make_sfm_scene(n_cams=5, n_points=200, noise_px=0.5, seed=seed)
    rng = np.random.default_rng(seed)
    cams = np.asarray(jba.camera_params_from_RC(J(sc["Rs"]), J(sc["Cs"])))
    cams0 = cams + rng.normal(0, [2e-3] * 3 + [2e-2] * 3, cams.shape)
    pts0 = sc["points"] + rng.normal(0, 0.03, sc["points"].shape)
    vis = (rng.random((5, 200)) < 0.8).astype(np.float64)
    vis[:, :20] = 1.0
    obs = sc["obs"].copy()
    obs[1, 30:36] += 40.0                     # a few gross outliers (Huber)
    return sc, cams0, pts0, obs, vis


# BA's parameters are free up to a similarity (7 degrees of freedom), and
# LM's small damping leaves that gauge nearly singular: rounding moves the
# parameters along it.  The test measures how far: the JAX package against
# itself with its initial cameras moved by one ulp (the witness; on this
# problem up to 6.9e-5 for the cameras, 7.7e-6 for the points after 15
# steps, where the port lands 1.3e-4 and 1.2e-5 from the JAX package).  The port's parameters are held to ten times the witness's
# spread (or 1e-7, where larger), and what the gauge does not move to
# 1e-7: the costs, the intrinsics, and every visible observation's
# reprojected pixel (1e-6 px on ~800 px coordinates).
BA_PIXEL_TOL = 1e-6


@pytest.mark.parametrize("loss,refine", [("linear", ""), ("huber", ""),
                                         ("linear", "f,pp,k1")])
def test_bundle_adjust_matches_jax(loss, refine):
    sc, cams0, pts0, obs, vis = _ba_problem()
    kw = dict(n_iters=15, loss=loss, refine_intrinsics=refine)
    rj = jba.bundle_adjust(J(sc["K"]), J(cams0), J(pts0), J(obs), J(vis), **kw)
    witness = jba.bundle_adjust(J(sc["K"]), J(np.nextafter(cams0, np.inf)), J(pts0),
                                J(obs), J(vis), **kw)
    rt = tba.bundle_adjust(T(sc["K"]), T(cams0), T(pts0), T(obs), T(vis), **kw)
    for name in ("cost", "initial_cost", "intrinsics"):
        assert rel(getattr(rt, name), getattr(rj, name)) < SOLVER_TOL, name
    for name in ("camera_params", "points"):
        spread = rel(getattr(witness, name), getattr(rj, name))
        assert rel(getattr(rt, name), getattr(rj, name)) <= max(SOLVER_TOL, 10 * spread), \
            (name, spread)
    assert int(rt.n_residuals) == int(rj.n_residuals)
    proj_t = tba._lanes(tba._observe_theta, rt.camera_params, rt.points, rt.intrinsics)
    proj_j = tba._lanes(tba._observe_theta, T(rj.camera_params), T(rj.points),
                        T(rj.intrinsics))
    seen = T(vis)[..., None] > 0
    assert float(((proj_t - proj_j).abs() * seen).max()) < BA_PIXEL_TOL
    assert float(rt.cost) < 0.5 * float(rt.initial_cost)


def test_ba_helpers_match_jax():
    sc, cams0, pts0, _, _ = _ba_problem(1)
    cj, pj = jba.fix_gauge_to_first_camera(J(cams0), J(pts0))
    ct, pt = tba.fix_gauge_to_first_camera(T(cams0), T(pts0))
    assert rel(ct, cj) < CLOSED_TOL and rel(pt, pj) < CLOSED_TOL
    Rj, Cj = jba.RC_from_camera_params(J(cams0))
    Rt, Ct = tba.RC_from_camera_params(T(cams0))
    assert rel(Rt, Rj) < CLOSED_TOL and rel(Ct, Cj) < CLOSED_TOL
    assert rel(tba.camera_params_from_RC(Rt, Ct), jba.camera_params_from_RC(Rj, Cj)) < 1e-8
    W = np.random.default_rng(0).normal(size=(3, 3, 40))
    W = np.einsum("ijm,kjm->ikm", W, W)
    assert rel(tba._inv3x3_lanes(T(W), 0.1), jba._inv3x3_lanes(J(W), 0.1)) < CLOSED_TOL
    assert tba.intrinsics_free_mask("f,k2") == jba.intrinsics_free_mask("f,k2")
    with pytest.raises(ValueError, match="unknown intrinsics token"):
        tba.intrinsics_free_mask("f,zz")


# ---- tracks, I/O, export ---------------------------------------------------

@pytest.fixture(scope="module")
def ring_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ring"))
    data, gt = write_reference_format_dataset(
        os.path.join(root, "data"), n_cams=6, n_points=300, noise_px=0.5,
        seed=2, visibility_window=4)
    return data, gt


def test_parse_matching_files_matches_jax(ring_dataset):
    from sfm_nerf_tpu.io import sfm_data as jsd
    from sfm_nerf_tpu_torch.io import sfm_data as tsd

    data, _ = ring_dataset
    mj, tj, vj = jsd.parse_matching_files(data, 6, use_native=False)
    mt, tt, vt = tsd.parse_matching_files(data, 6)
    assert sorted(mt) == sorted(mj)
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k])
    assert tt == tj
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tsd.build_visibility_matrix([1, 3, 5], tt),
                                  jsd.build_visibility_matrix([1, 3, 5], tj))
    rows, nf = tsd.parse_matching_table(data, 6)
    assert nf == len(tt)
    np.testing.assert_array_equal(tsd.visibility_from_table(rows, nf), vt)
    np.testing.assert_array_equal(tsd.load_calibration(data + "/calibration.txt"),
                                  jsd.load_calibration(data + "/calibration.txt"))


def test_load_images_are_rgb(ring_dataset, tmp_path):
    import cv2

    from sfm_nerf_tpu_torch.io.png import write_png
    from sfm_nerf_tpu_torch.io.sfm_data import load_images

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    write_png(str(tmp_path / "1.png"), img)
    imgs = load_images(str(tmp_path), 2)
    assert imgs[1] is None                      # missing frame kept in place
    np.testing.assert_array_equal(imgs[0], img)
    np.testing.assert_array_equal(imgs[0], cv2.imread(str(tmp_path / "1.png"))[..., ::-1])


def test_merge_tracks_matches_jax(ring_dataset):
    from sfm_nerf_tpu.sfm.tracks import merge_tracks as jmerge
    from sfm_nerf_tpu_torch.io.sfm_data import parse_matching_files
    from sfm_nerf_tpu_torch.sfm.tracks import merge_tracks as tmerge

    data, _ = ring_dataset
    m, t, _ = parse_matching_files(data, 6)
    rj = jmerge(m, [dict(x) for x in t])
    rt = tmerge(m, [dict(x) for x in t])
    assert rt[1] == rj[1] and len(rt[1]) < len(t)
    for k in rj[0]:
        np.testing.assert_array_equal(rt[0][k], rj[0][k])
    np.testing.assert_array_equal(rt[2], rj[2])
    np.testing.assert_array_equal(rt[3], rj[3])


@pytest.mark.parametrize("n", [0, 1, 57])
def test_save_ply_ascii_byte_equal_to_jax(tmp_path, n):
    from sfm_nerf_tpu.io.artifacts import save_ply as jsave
    from sfm_nerf_tpu_torch.io.artifacts import save_ply as tsave

    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3)) * 10
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    a = jsave(pts, cols, str(tmp_path), name="j.ply", binary=False)
    b = tsave(pts, cols, str(tmp_path), name="t.ply", binary=False)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_save_ply_binary_layout(tmp_path):
    from sfm_nerf_tpu_torch.io.artifacts import save_ply

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(9, 3))
    cols = rng.integers(0, 256, (9, 3)).astype(np.uint8)
    path = save_ply(pts, cols, str(tmp_path), binary=True)
    blob = open(path, "rb").read()
    head, body = blob.split(b"end_header\n")
    assert b"binary_little_endian" in head and b"element vertex 9" in head
    rec = np.frombuffer(body, dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
    np.testing.assert_array_equal(rec["xyz"], pts.astype(np.float32))
    np.testing.assert_array_equal(rec["rgb"], cols)


def test_export_nerf_dataset_round_trip(ring_dataset, tmp_path):
    from sfm_nerf_tpu.sfm import to_nerf as jtn
    from sfm_nerf_tpu_torch.io.blender import load_blender_dataset
    from sfm_nerf_tpu_torch.sfm import to_nerf as ttn

    data, gt = ring_dataset
    cams = {i + 1: {"R": gt["Rs"][i], "C": gt["Cs"][i]} for i in range(6)}
    points = {f: p for f, p in enumerate(gt["points"])}
    paths = {i: os.path.join(data, f"{i}.png") for i in cams}
    out = str(tmp_path / "nerf")
    meta = ttn.export_nerf_dataset(cams, points, gt["K"], paths, out, width=800,
                                   height=600, holdout_every=3)
    assert (meta["near"], meta["far"]) == jtn.near_far_from_points(cams, points)
    images, poses, cam = load_blender_dataset(out, "train")
    assert len(images) == 4 and images.shape[1:] == (600, 800, 3)
    np.testing.assert_allclose(cam.camera_matrix, gt["K"], rtol=1e-6)
    train_ids = [1, 2, 4, 5]
    for k, i in enumerate(train_ids):
        np.testing.assert_allclose(poses[k], jtn.c2w_from_rc(gt["Rs"][i - 1], gt["Cs"][i - 1]),
                                   atol=1e-5)
    assert cam.near == pytest.approx(meta["near"]) and cam.far == pytest.approx(meta["far"])
    test_images, _, _ = load_blender_dataset(out, "test")
    assert len(test_images) == 2
    # the undistortion path resamples through io/png.py like the JAX one
    img = (np.arange(60 * 80 * 3) % 251).astype(np.uint8).reshape(60, 80, 3)
    K = np.array([[70.0, 0, 40], [0, 70.0, 30], [0, 0, 1]])
    np.testing.assert_array_equal(ttn.undistort_image(img, K, 0.1, -0.02),
                                  jtn.undistort_image(img, K, 0.1, -0.02))
    assert ttn.max_distortion_displacement_px(K, 0.1, 0.0, 60, 80) == \
        jtn.max_distortion_displacement_px(K, 0.1, 0.0, 60, 80)


def test_ransac_with_fewer_rows_than_a_sample():
    """Fewer matches than a minimal sample: the draws reach rows [0, k), so
    the rows are padded and masked, nothing is read out of range, and no
    row counts as an inlier of an underdetermined fit."""
    g = torch.Generator().manual_seed(0)
    _, p1, p2 = two_view(n=300, outlier_frac=0.0)
    r = tep.ransac_fundamental(T(p1[:5]), T(p2[:5]), n_iters=256, chunk=128, generator=g)
    assert r.inliers.shape == (5,) and r.F.shape == (3, 3)
    batched = tep.ransac_fundamental_pairs_bucketed(
        [(p1[:5], p2[:5]), (p1[:7], p2[:7])], n_iters=256, chunk=128, generator=g)
    assert [len(b.inliers) for b in batched] == [5, 7]
    sc, X, x = _pnp_problem(outlier_frac=0.0)
    rp = tpnp.pnp_ransac(T(X[:4]), T(x[:4]), T(sc["K"]), n_iters=512, generator=g)
    assert rp.inliers.shape == (4,)
