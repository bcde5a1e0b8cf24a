"""The port's global initialisation against the JAX package's, on the same
float64 inputs (JAX on the CPU under the tests' x64 conftest):
``relative_pose_pairs`` (R and C within 1e-9, also against the port's own
per-pair loop, padded pairs included), rotation averaging on the graphs of
tests/test_rotation_avg.py (rotations within 1e-8: the basis of the triple
top eigenspace is the library's choice, the anchor-fixed product is not),
translation averaging (the same kept edges, centres within 1e-8 of the
scene scale), and ``cli.sfm --global_init`` against the JAX pipeline on a
6-camera ring, held to the same outcome as tests/test_torch_sfm_pipeline.py
holds the incremental run.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_synthetic import make_sfm_scene, write_reference_format_dataset

from sfm_nerf_tpu.ops import epipolar as jep
from sfm_nerf_tpu.ops import rotation_avg as jra
from sfm_nerf_tpu.ops import translation_avg as jta
from sfm_nerf_tpu.ops import triangulation as jtri
from sfm_nerf_tpu_torch.ops import epipolar as tep
from sfm_nerf_tpu_torch.ops import rotation_avg as tra
from sfm_nerf_tpu_torch.ops import translation_avg as tta
from sfm_nerf_tpu_torch.ops import triangulation as ttri

POSE_TOL = 1e-9        # relative pose R, C
ROT_TOL = 1e-8         # averaged rotations
CENTRE_TOL = 1e-8      # averaged centres, relative to the scene scale


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


def rotations(rng, n):
    out = []
    for _ in range(n):
        Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        out.append(Q)
    return np.stack(out)


def rodrigues(v):
    th = np.linalg.norm(v)
    if th < 1e-15:
        return np.eye(3)
    k = v / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


# ---- relative_pose_pairs ---------------------------------------------------

def test_relative_pose_pairs_match_jax_and_the_per_pair_loop():
    """Four pairs of 45-120 matches (20% outliers) padded to 128 rows: the
    port's batch against JAX's vmapped batch on the same padded arrays and
    against its own disambiguate_pose pair by pair, unpadded."""
    sc = make_sfm_scene(n_cams=5, n_points=150, noise_px=0.4, seed=6)
    K = sc["K"]
    rng = np.random.default_rng(6)
    B = 128
    Fs, p1s, p2s, nvs, loop = [], [], [], [], []
    for (a, b), n in (((0, 1), 60), ((0, 2), 90), ((1, 3), 45), ((2, 4), 120)):
        sel = rng.choice(150, n, replace=False)
        p1, p2 = sc["obs"][a][sel].copy(), sc["obs"][b][sel].copy()
        bad = rng.random(n) < 0.2
        p2[bad] = rng.uniform([0, 0], [800, 600], (int(bad.sum()), 2))
        F = np.asarray(jep.eight_point(J(p1[~bad]), J(p2[~bad])))
        Fs.append(F)
        p1s.append(np.resize(p1, (B, 2)))
        p2s.append(np.resize(p2, (B, 2)))
        nvs.append(n)
        Et = tep.cleanup_essential(tep.essential_from_fundamental(T(K), T(F)))
        Cs, Rs = tep.decompose_essential(Et, "hz")
        _, C, R, _, _ = ttri.disambiguate_pose(T(K), Cs, Rs, T(p1), T(p2))
        loop.append((C.numpy(), R.numpy()))
    Cj, Rj = jtri.relative_pose_pairs(J(K), J(np.stack(Fs)), J(np.stack(p1s)),
                                      J(np.stack(p2s)), jnp.asarray(nvs))
    Ct, Rt = ttri.relative_pose_pairs(T(K), T(np.stack(Fs)), T(np.stack(p1s)),
                                      T(np.stack(p2s)), torch.as_tensor(nvs))
    assert np.abs(Ct.numpy() - np.asarray(Cj)).max() < POSE_TOL
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() < POSE_TOL
    for m, (C, R) in enumerate(loop):
        assert np.abs(Ct[m].numpy() - C).max() < POSE_TOL
        assert np.abs(Rt[m].numpy() - R).max() < POSE_TOL
    # the vote masks the padding: zeros there give the same poses
    z1, z2 = np.zeros((4, B, 2)), np.zeros((4, B, 2))
    for m, n in enumerate(nvs):
        z1[m, :n], z2[m, :n] = p1s[m][:n], p2s[m][:n]
    Cz, Rz = ttri.relative_pose_pairs(T(K), T(np.stack(Fs)), T(z1), T(z2),
                                      torch.as_tensor(nvs))
    assert np.abs(Cz.numpy() - Ct.numpy()).max() < POSE_TOL
    assert np.abs(Rz.numpy() - Rt.numpy()).max() < POSE_TOL


# ---- rotation averaging ----------------------------------------------------

def _edges(name):
    """(n, anchor, edges, noise rad, seed) of tests/test_rotation_avg.py's
    graphs."""
    full = lambda n: [(i, j) for i in range(n) for j in range(i + 1, n)]
    if name == "full":
        return 6, 0, full(6), 0.0, 0
    if name == "noisy":
        return 10, 0, full(10), np.radians(2.0), 1
    if name == "chain_loop":
        return 8, 0, [(i, i + 1) for i in range(7)] + [(0, 7), (0, 4)], 0.0, 2
    if name == "anchor2":
        return 5, 2, full(5), 0.05, 3
    if name == "isolated":       # camera 4 has no edge
        return 5, 0, [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)], np.radians(0.5), 0
    if name == "duplicate":
        return 3, 0, [(0, 1), (1, 2), (0, 2), (0, 1)], np.radians(0.5), 1
    n = 200                      # the 200-camera protocol's window-7 ring
    edges = sorted({(min(i, (i + d) % n), max(i, (i + d) % n))
                    for i in range(n) for d in range(1, 8)})
    return n, 0, edges, np.radians(0.5), 3


def _rotation_problem(name):
    n, anchor, edges, noise, seed = _edges(name)
    rng = np.random.default_rng(seed)
    R_true = rotations(rng, n)
    rels = []
    for i, j in edges:
        v = rng.normal(size=3)
        R_ij = R_true[j] @ R_true[i].T
        rels.append(rodrigues(v / np.linalg.norm(v) * noise) @ R_ij if noise else R_ij)
    return n, anchor, edges, np.stack(rels), R_true


@pytest.mark.parametrize("name", ["full", "noisy", "chain_loop", "anchor2", "isolated",
                                  "duplicate", "ring200"])
def test_rotation_averaging_matches_jax(name):
    n, anchor, pairs, rels, R_true = _rotation_problem(name)
    Rj = np.asarray(jra.rotation_averaging(pairs, J(rels), n, anchor=anchor))
    Rt = tra.rotation_averaging(pairs, T(rels), n, anchor=anchor)
    assert Rt.dtype == torch.float64 and Rt.shape == (n, 3, 3)
    assert np.abs(Rt.numpy() - Rj).max() < ROT_TOL
    np.testing.assert_allclose(Rt[anchor].numpy(), np.eye(3), atol=1e-12)
    rj = np.asarray(jra.relative_rotation_residuals(pairs, J(rels), J(Rj)))
    rt = tra.relative_rotation_residuals(pairs, T(rels), Rt).numpy()
    # arccos near 1 turns one ulp of the cosine into ~1.5e-8 rad: compare
    # the cosines
    assert np.abs(np.cos(rt) - np.cos(rj)).max() < 1e-13
    if name == "isolated":
        np.testing.assert_array_equal(Rt[4].numpy(), np.eye(3))
    if name == "ring200":
        # against the truth in the anchor's gauge: near the 0.5 deg noise
        cos = (np.einsum("nij,nij->n", Rt.numpy(), R_true @ R_true[0].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))).mean() < 0.5


def test_project_to_so3_matches_jax():
    M = np.random.default_rng(4).normal(size=(7, 3, 3))
    Rj = np.asarray(jra.project_to_so3(J(M)))
    Rt = tra.project_to_so3(T(M)).numpy()
    assert np.abs(Rt - Rj).max() < 1e-12
    assert (np.linalg.det(Rt) > 0).all()


# ---- translation averaging -------------------------------------------------

def _translation_problem(name):
    """(pairs, u_world, n, C_true, outlier edges) of
    tests/test_translation_avg.py's graphs."""
    if name == "ring200":
        rng = np.random.default_rng(11)
        n = 200
        th = 2 * np.pi * np.arange(n) / n
        C = np.stack([6 * np.cos(th), 0.4 * np.sin(3 * th), 6 * np.sin(th)], -1)
        C -= C[0]
        pairs = np.asarray(sorted({(min(i, (i + d) % n), max(i, (i + d) % n))
                                   for i in range(n) for d in range(1, 8)}))
        u = C[pairs[:, 1]] - C[pairs[:, 0]]
        u = u / np.linalg.norm(u, axis=-1, keepdims=True) + rng.normal(0, 0.005, u.shape)
        return pairs, u, n, C, np.zeros(0, int)
    rng = np.random.default_rng(0 if name == "clean" else 1)
    n = 12 if name == "clean" else 20
    extra = 2.0 if name == "clean" else 3.0
    C = rng.uniform(-5, 5, (n, 3))
    C -= C[0]
    pairs = [(i, i + 1) for i in range(n - 1)]
    while len(pairs) < n - 1 + int(extra * n):
        i, j = rng.integers(0, n, 2)
        if i != j:
            pairs.append((min(i, j), max(i, j)))
    pairs = np.asarray(sorted(set(pairs)))
    u = C[pairs[:, 1]] - C[pairs[:, 0]]
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    out = np.zeros(0, int)
    if name == "outliers":
        u = u + rng.normal(0, 0.01, u.shape)
        out = rng.choice(len(pairs), 4, replace=False)
        u[out] = rng.normal(size=(4, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
    return pairs, u, n, C, out


def _kept(pairs, u, res):
    thresh = max(10.0, 5.0 * float(np.median(res)))
    return res <= thresh


@pytest.mark.parametrize("name", ["clean", "outliers", "ring200"])
def test_translation_averaging_matches_jax(name):
    pairs, u, n, C_true, out = _translation_problem(name)
    w = np.random.default_rng(5).integers(20, 200, len(pairs)).astype(np.float64)
    scene = np.linalg.norm(C_true, axis=-1).max()
    # the first solve and its edge gate: the same edges kept
    uj = u / np.linalg.norm(u, axis=-1, keepdims=True)
    C1j = jta._solve(pairs, uj, w, n, 0, 5)
    C1t = tta._solve(pairs, T(uj), T(w), n, 0, 5)
    assert np.abs(C1t.numpy() - C1j).max() < CENTRE_TOL * scene
    kj = _kept(pairs, u, jta.direction_residuals_deg(pairs, u, C1j))
    kt = _kept(pairs, u, tta.direction_residuals_deg(pairs, T(u), C1t).numpy())
    np.testing.assert_array_equal(kt, kj)
    if name == "outliers":
        assert not kt[out].any()              # every gross outlier dropped
    Cj = jta.translation_averaging(pairs, u, n, weights=w)
    Ct = tta.translation_averaging(pairs, T(u), n, weights=T(w))
    assert Ct.dtype == torch.float64
    assert np.abs(Ct.numpy() - Cj).max() < CENTRE_TOL * scene
    rj = jta.direction_residuals_deg(pairs, u, Cj)
    rt = tta.direction_residuals_deg(pairs, T(u), Ct).numpy()
    assert np.abs(np.cos(np.radians(rt)) - np.cos(np.radians(rj))).max() < 1e-12
    # the world direction of a relative centre
    rng = np.random.default_rng(2)
    Ri, c = rotations(rng, 6), rng.normal(size=(6, 3))
    dj = np.stack([jta.pair_direction_world(Ri[k], c[k]) for k in range(6)])
    assert np.abs(tta.pair_direction_world(T(Ri), T(c)).numpy() - dj).max() < 1e-15


def test_translation_averaging_is_stable_to_rounding():
    """On the 200-camera ring a rounding-sized change of the directions
    (1e-15 relative) moves the port's centres by less than 1e-11 of the
    scene: the QR solve keeps the KKT matrix's squared condition number
    out of the result, so the card and the CPU can agree within 1e-9.
    Prints the JAX package's move under the same change (pytest -s)."""
    pairs, u, n, C_true, _ = _translation_problem("ring200")
    scene = np.linalg.norm(C_true, axis=-1).max()
    rng = np.random.default_rng(7)
    moves_t, moves_j = [], []
    Ct, Cj = tta.translation_averaging(pairs, T(u), n).numpy(), \
        jta.translation_averaging(pairs, u, n)
    for _ in range(3):
        up = u * (1 + 1e-15 * rng.normal(size=u.shape))
        moves_t.append(np.abs(tta.translation_averaging(pairs, T(up), n).numpy() - Ct).max())
        moves_j.append(np.abs(jta.translation_averaging(pairs, up, n) - Cj).max())
    print(f"centre move / scene under 1e-15 direction noise: port "
          f"{max(moves_t) / scene:.2e}, JAX {max(moves_j) / scene:.2e}")
    assert max(moves_t) < 1e-11 * scene


def test_translation_averaging_underconstrained_raises():
    with pytest.raises(ValueError, match="cannot constrain"):
        jta.translation_averaging([(0, 1)], np.ones((1, 3)), 5)
    with pytest.raises(ValueError, match="cannot constrain"):
        tta.translation_averaging([(0, 1)], torch.ones(1, 3, dtype=torch.float64), 5)


# ---- the pipeline ----------------------------------------------------------

N_CAMS = 6
FLAGS = ["--ransac_iters", "1024", "--pnp_iters", "1024", "--ba_max_iters", "20",
         "--merge_tracks", "--global_init"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX SfMPipeline and ``cli.sfm --device cpu`` with --global_init
    on one 6-camera ring (400 points, 0.5 px noise)."""
    from sfm_nerf_tpu.config import SfMConfig
    from sfm_nerf_tpu.sfm import SfMPipeline
    from sfm_nerf_tpu_torch.cli import sfm as cli

    root = tmp_path_factory.mktemp("sfm_global")
    data, gt = write_reference_format_dataset(
        str(root / "data"), n_cams=N_CAMS, n_points=400, noise_px=0.5, seed=0,
        visibility_window=4)
    os.makedirs(root / "jax", exist_ok=True)
    jax_res = SfMPipeline(SfMConfig(
        data_path=data, num_images=N_CAMS, output_dir=str(root / "jax"),
        ransac_iters=1024, pnp_iters=1024, ba_max_iters=20, merge_tracks=True,
        global_init=True)).run()
    torch_res = cli.main(["--data_path", data, "--num_images", str(N_CAMS),
                          "--output_dir", str(root / "torch"), "--device", "cpu",
                          *FLAGS])
    return jax_res, torch_res


def _angle_deg(A, B):
    return float(np.degrees(np.arccos(np.clip((np.trace(A.T @ B) - 1) / 2, -1, 1))))


def test_global_init_pipeline_matches_jax(runs):
    jr, tr = runs
    sj, st = jr["stats"], tr["stats"]
    assert sorted(tr["camera_info"]) == sorted(jr["camera_info"])
    assert st["n_registered"] == N_CAMS and st["device"] == "cpu"
    ej, et = sj["ba"]["final_err_px"]["mean"], st["ba"]["final_err_px"]["mean"]
    assert et < 1.0 and abs(et - ej) <= 0.05 * ej, (et, ej)
    R1j = np.asarray(jr["camera_info"][1]["R"])
    R1t = np.asarray(tr["camera_info"][1]["R"])
    for c in jr["camera_info"]:
        deg = _angle_deg(np.asarray(tr["camera_info"][c]["R"]) @ R1t.T,
                         np.asarray(jr["camera_info"][c]["R"]) @ R1j.T)
        assert deg < 0.05, (c, deg)
    assert st["rotation_avg"]["n_pairs"] == sj["rotation_avg"]["n_pairs"]
    assert st["rotation_avg"]["mean_residual_deg"] < 3.0
    assert st["translation_avg"]["n_pairs"] == sj["translation_avg"]["n_pairs"]
    assert st["translation_avg"]["median_residual_deg"] < 5.0
    assert "global_init" in st["stage_seconds"]
